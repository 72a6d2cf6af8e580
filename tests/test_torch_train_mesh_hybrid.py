"""The hybrid family's train step partitioned on a mesh of more than one
rank, the Mamba scans on each rank's local blocks
(`tests/_torch_train_mesh.py` runs each case).

(a) 4 gloo ranks run the reduced jamba-1.5-large-398b (2 superblocks of
a Mamba mixer and an attention mixer, MoE and dense FFNs) for 3 float32
steps on a (data, model) = (2, 2) mesh in 2 microbatches, held against
the reference's jitted step on a JAX mesh of the same shape (Auto axes)
and against the port's one-rank step: loss and `grad_norm` within 1e-5
relative at every step, every leaf's first-step gradient within 1e-5 x
its max, the final master and parameters within 1e-5 x the leaf's max
(`mesh_case(recurrent=True)`), every leaf's local shape and placements
as its spec says (``a_log``, ``conv_w`` and ``d_skip`` on local
channels).  Every rank ran each Mamba mixer's conv and its whole
selective scan on its own rows and channels (`sharding.on_local_blocks`),
the attention on its own rows and heads, and the MoE FFN on its own token
group with its own experts.  (b) under ``-m slow``: the same at (1, 4),
where the reduced model's 2 KV heads do not divide ``model`` and are
repeated for their query heads.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_train_mesh import B, S, WORLD, expert_parallel, local_heads, mesh_case  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402

ARCH = "jamba-1.5-large-398b"
MESH_CASES = [
    pytest.param(2, 2, id="jamba-2x2-micro2"),
    pytest.param(4, 2, id="jamba-1x4-micro2", marks=pytest.mark.slow),
]


def _calls(rank, name):
    calls = [local for n, _, local in rank["blocks"] if n == name]
    assert calls, (name, rank["blocks"])
    return calls


@pytest.mark.parametrize("model_axis,micro", MESH_CASES)
def test_partitioned_hybrid_step_matches_reference_and_one_rank(tmp_path, model_axis, micro):
    """(a), (b): three partitioned steps against the reference's jitted
    step and the one-rank step, the Mamba scans on local blocks."""
    cfg = get_arch(ARCH, reduced=True)
    got = mesh_case(tmp_path, ARCH, False, model_axis, micro, recurrent=True)
    local_heads(got, S, S, model_axis, cfg)
    expert_parallel(got, cfg, model_axis)
    rows = B // micro // (WORLD // model_axis)
    di, ds, conv = 2 * cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv
    chans = di // model_axis
    want = {"a_log": [chans, ds], "conv_w": [conv, chans], "d_skip": [chans]}
    for rank in got:
        mixers = {p: s for p, s in rank["local"].items() if p.rsplit("/", 1)[-1] in want}
        assert len(mixers) == 3 * cfg.num_layers // cfg.attn_period, mixers
        for path, shape in mixers.items():
            assert shape == want[path.rsplit("/", 1)[-1]], (path, shape)
        for local in _calls(rank, "_causal_conv"):
            assert local == [[rows, S, chans], [conv, chans], [chans]], local
        for local in _calls(rank, "_selective_scan"):
            assert local == [[chans, ds], [rows, S, chans], [rows, S, chans], [rows, S, ds],
                             [rows, S, ds]], local
