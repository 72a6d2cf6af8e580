"""The audio family's train step partitioned on a mesh of more than one
rank (`tests/_torch_train_mesh.py` runs each case).

(a) 4 gloo ranks run the reduced seamless-m4t-large-v2 for 3 float32
steps on a (data, model) = (2, 2) mesh in 2 microbatches, each batch's
``frames`` (B, S_SRC, F) and tokens (B, S) from NumPy with a seed, S_SRC
!= S.  Held against the reference's jitted step on a JAX mesh of the
same shape (Auto axes) and against the port's one-rank step: loss and
`grad_norm` within 1e-5 relative at every step, the final master and
parameters within 1e-5 x the leaf's max, every leaf's local shape and
placements as its spec says.  The encoder's attention over the frames,
the decoder's over its tokens and its cross-attention (S queries over
S_SRC keys) each ran on every rank's local rows and heads.  (b) under
``-m slow``: the same at (4, 1).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_train_mesh import S, S_SRC, local_heads, mesh_case  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

ARCH = "seamless-m4t-large-v2"
MESH_CASES = [
    pytest.param(2, 2, id="seamless-2x2-micro2"),
    pytest.param(1, 2, id="seamless-4x1-micro2", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("model_axis,micro", MESH_CASES)
def test_partitioned_audio_step_matches_reference_and_one_rank(tmp_path, model_axis, micro):
    """(a), (b): three partitioned steps against the reference's jitted
    step and the one-rank step, the cross-attention at S != S_SRC."""
    cfg = get_arch(ARCH, reduced=True)
    got = mesh_case(tmp_path, ARCH, False, model_axis, micro)
    for q_seq, k_seq in ((S_SRC, S_SRC), (S, S), (S, S_SRC)):
        local_heads(got, q_seq, k_seq, model_axis, cfg)
