"""The vlm family's train step partitioned on a mesh of more than one
rank (`tests/_torch_train_mesh.py` runs each case).

(a) 4 gloo ranks run the reduced llava-next-mistral-7b for 3 float32
steps on a (data, model) = (2, 2) mesh in 2 microbatches, each batch's
``patches`` (B, T_img, F) from NumPy with a seed, placed by
`batch_shardings` and split into microbatches by `batch_rows`.  Held
against the reference's jitted step on a JAX mesh of the same shape
(Auto axes) and against the port's one-rank step: loss and `grad_norm`
within 1e-5 relative at every step, the final master and parameters
within 1e-5 x the leaf's max, every leaf's local shape and placements as
its spec says (the projector's ``proj_w1`` and ``proj_w2``
column-parallel over ``model``), and the [image ; text] sequence's
attention on each rank's local rows and heads.  (b) under ``-m slow``:
the same at (4, 1).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_train_mesh import S, local_heads, mesh_case  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

ARCH = "llava-next-mistral-7b"
MESH_CASES = [
    pytest.param(2, 2, id="llava-2x2-micro2"),
    pytest.param(1, 2, id="llava-4x1-micro2", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("model_axis,micro", MESH_CASES)
def test_partitioned_vlm_step_matches_reference_and_one_rank(tmp_path, model_axis, micro):
    """(a), (b): three partitioned steps against the reference's jitted
    step and the one-rank step."""
    cfg = get_arch(ARCH, reduced=True)
    got = mesh_case(tmp_path, ARCH, False, model_axis, micro)
    seq = cfg.frontend_tokens + S
    local_heads(got, seq, seq, model_axis, cfg)
    for rank in got:
        for leaf in ("proj_w1", "proj_w2"):
            assert rank["local"][leaf][1] == cfg.d_model // model_axis, rank["local"][leaf]
