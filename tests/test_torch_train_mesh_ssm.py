"""The ssm family's train step partitioned on a mesh of more than one
rank, the recurrent scans on each rank's local blocks
(`tests/_torch_train_mesh.py` runs each case).

(a) 4 gloo ranks run the reduced xlstm-1.3b (2 superblocks of an mLSTM
and an sLSTM) for 3 float32 steps on a (data, model) = (2, 2) mesh in 2
microbatches, held against the reference's jitted step on a JAX mesh of
the same shape (Auto axes) and against the port's one-rank step: loss
and `grad_norm` within 1e-5 relative at every step, the final master and
parameters within 1e-5 x the leaf's max, every leaf's local shape and
placements as its spec says (``out_ln`` over ``model``).  Every rank
ran each mLSTM's chunk loop on its own rows and heads and each sLSTM's
loop on its own rows with every channel and the four recurrent weights
whole (`sharding.on_local_blocks`).  (b) under ``-m slow``: the same at
(1, 4), where the reduced model's 2 heads do not divide ``model``: the
heads are replicated there, ``out_ln`` still sharded.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_train_mesh import B, S, WORLD, mesh_case  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

ARCH = "xlstm-1.3b"
MESH_CASES = [
    pytest.param(2, 2, id="xlstm-2x2-micro2"),
    pytest.param(4, 2, id="xlstm-1x4-micro2", marks=pytest.mark.slow),
]


def _calls(rank, name):
    calls = [(g, l) for n, g, l in rank["blocks"] if n == name]
    assert calls, (name, rank["blocks"])
    return calls


@pytest.mark.parametrize("model_axis,micro", MESH_CASES)
def test_partitioned_ssm_step_matches_reference_and_one_rank(tmp_path, model_axis, micro):
    """(a), (b): three partitioned steps against the reference's jitted
    step and the one-rank step, the scans on local blocks."""
    cfg = get_arch(ARCH, reduced=True)
    got = mesh_case(tmp_path, ARCH, False, model_axis, micro, recurrent=True)
    data = WORLD // model_axis
    rows = B // micro // data
    h = cfg.num_heads
    local_h = h // model_axis if h % model_axis == 0 else h
    dv = cfg.xlstm_proj_factor * cfg.d_model // h
    d = cfg.d_model
    for rank in got:
        for path, shape in rank["local"].items():
            if path.endswith("/out_ln"):
                assert shape == [h * dv // model_axis], (path, shape)
        for glob, local in _calls(rank, "_mlstm_chunks"):
            assert glob[0] == [S, B // micro, h, dv // 2], glob
            assert local[0] == [S, rows, local_h, dv // 2], local
            assert local[3] == [S, rows, local_h], local
        for glob, local in _calls(rank, "_slstm_loop"):
            assert local == [[rows, S, 4 * d], [d, 4 * d]], local
