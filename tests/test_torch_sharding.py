"""The port's sharding rules (`repro_torch.distributed.sharding`) and
meshes (`repro_torch.launch.mesh`) against the reference's.

The rule tables are the reference's pattern for pattern.  For every leaf
of every full arch's parameters (fake tensors on the port's side,
`jax.eval_shape` on the reference's), on both production meshes as the
reference's duck-typed `FakeMesh` and with ``dp_over_model`` both ways,
the port's spec is the reference's with the stacking dims dropped (the
port holds one dict a layer; the reference stacks layers on leading
axes).  The same holds for the cache leaves of each family at
``decode_32k`` and ``long_500k`` (where ``sp_if_b1`` applies), for
`batch_shardings`, and for `opt_state_shardings` (whose ZeRO-1 rule
shards dim 0 of the port's own leaf).  The reference's public sharding
functions run with its ``NamedSharding`` stood in by the bare spec, so a
FakeMesh drives them.  On a real mesh of one device in both packages
(gloo on the CPU, jax's host mesh) the specs are equal leaf for leaf
for a reduced model of each family, and `device_put` keeps every leaf a
plain tensor with its bits.  `maybe_constrain` returns a plain tensor
unchanged, with or without an active mesh; `launch.train` builds its
mesh (``--model-axis 2`` fails the reference's assertion on one
device); `restore_checkpoint(shardings=...)` gives the saved bits on the
mesh's device; under a fake group of 4 the local shapes follow the
specs, and `on_local_blocks` hands a function each rank's blocks by
logical spec, with partial gradients where declared;
`ShardedIndexService._shard_mesh` is None on one device in both
packages.  Every process group a test starts is destroyed before it
ends; `set_dp_over_model` is reset in both packages after every test.
"""

import functools
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.mesh import make_host_mesh as jax_host_mesh  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.train.optimizer import adamw_init as jax_adamw_init  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_supported  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: only .shape is consulted by the rules engine."""

    def __init__(self, **axes):
        self.shape = dict(axes)


PROD = FakeMesh(data=16, model=16)
PROD3 = FakeMesh(pod=2, data=16, model=16)
MESHES = [pytest.param(PROD, id="16x16"), pytest.param(PROD3, id="2x16x16")]
FAMILY_ARCHS = ("yi-6b", "olmoe-1b-7b", "jamba-1.5-large-398b", "xlstm-1.3b",
                "llava-next-mistral-7b", "seamless-m4t-large-v2")


@pytest.fixture(autouse=True)
def _reset_global_state():
    """`set_dp_over_model` is global state in both packages, and a
    process group must not outlive the test that started it."""
    yield
    jsh.set_dp_over_model(False)
    tsh.set_dp_over_model(False)
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding functions with ``NamedSharding`` stood in
    by its spec, so that a FakeMesh drives them."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    return jsh


_MODES = {}


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, reduced: bool = False):
    """The full arch's parameters as fake tensors (their mode in `_MODES`)."""
    mode = _MODES[arch, reduced] = FakeTensorMode()
    with mode:
        return get_model(get_arch(arch, reduced), "cpu").init(torch.Generator().manual_seed(0))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, reduced: bool = False):
    return jax.eval_shape(jax_get_model(jax_get_arch(arch, reduced)).init,
                          jax.random.PRNGKey(0))


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jsh._path_str(path): leaf for path, leaf in flat}


def _ref_path(path: str):
    """The port's path as the reference's (layer indices dropped) and the
    number of stacking dims the reference's leaf carries."""
    parts = path.split("/")
    kept = [p for p in parts if not p.isdigit()]
    return "/".join(kept), len(parts) - len(kept)


def _pairs(port_tree, ref_tree):
    """[(port path, port shape, reference path, reference shape, k)] for
    every port leaf, k the reference's stacking dims; every reference
    leaf is met."""
    ref = _ref_leaves(ref_tree)
    out, met = [], set()
    for path, leaf in tsh.tree_leaves_with_path(port_tree):
        rpath, k = _ref_path(path)
        assert rpath in ref, (path, rpath)
        rshape = tuple(ref[rpath].shape)
        shape = tuple(getattr(leaf, "shape", ()))
        assert rshape[k:] == shape, (path, rshape, shape)
        out.append((path, shape, rpath, rshape, k))
        met.add(rpath)
    assert met == set(ref), sorted(set(ref) - met)
    return out


def test_rule_tables_equal_the_reference_pattern_for_pattern():
    assert tsh._PARAM_RULES == jsh._PARAM_RULES
    assert tsh._CACHE_RULES == jsh._CACHE_RULES
    for a, b in zip(tsh._PARAM_RULES + tsh._CACHE_RULES, jsh._PARAM_RULES + jsh._CACHE_RULES):
        assert re.compile(a[0]).pattern == re.compile(b[0]).pattern and a[1] == b[1]


@pytest.mark.parametrize("dp_over_model", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference_for_every_leaf(arch, mesh, dp_over_model):
    """`param_shardings` on the port's fake parameters: each leaf's spec
    is the reference's `_spec_for_leaf` with the stacking dims dropped."""
    jsh.set_dp_over_model(dp_over_model)
    tsh.set_dp_over_model(dp_over_model)
    cfg = ARCHS[arch]
    params = _port_params(arch)
    got = dict(tsh.tree_leaves_with_path(tsh.param_shardings(params, cfg, mesh)))
    for path, shape, rpath, rshape, k in _pairs(params, _ref_params(arch)):
        want = jsh._spec_for_leaf(rpath, rshape, mesh, jsh._PARAM_RULES, fsdp=cfg.fsdp_params)
        assert tuple(got[path].spec) == tuple(want)[k:], (path, got[path].spec, want)
        assert tsh._spec_for_leaf(path, shape, mesh, tsh._PARAM_RULES,
                                  fsdp=cfg.fsdp_params) == got[path].spec


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_rules_always_divisible(arch, mesh):
    """Every sharded dim divides its mesh axes, for every full arch (the
    reference's test, on the port's leaves)."""
    cfg = ARCHS[arch]
    for path, leaf in tsh.tree_leaves_with_path(_port_params(arch)):
        spec = tsh._spec_for_leaf(path, tuple(leaf.shape), mesh, tsh._PARAM_RULES,
                                  fsdp=cfg.fsdp_params)
        for dim, part in zip(leaf.shape, tuple(spec)):
            if part is None:
                continue
            names = part if isinstance(part, tuple) else (part,)
            total = int(np.prod([mesh.shape[n] for n in names]))
            assert dim % total == 0, (arch, path, leaf.shape, spec)


def _cache_cases():
    out = []
    for arch in FAMILY_ARCHS:
        for shape in ("decode_32k", "long_500k"):
            if shape_supported(ARCHS[arch], SHAPES[shape])[0]:
                out.append(pytest.param(arch, shape, id=f"{arch}-{shape}"))
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape_name", _cache_cases())
def test_cache_specs_equal_the_reference(arch, shape_name, mesh, ref_specs):
    """`cache_shardings` on the port's fake cache against the reference's
    on its abstract cache, leaf for leaf (``sp_if_b1`` at long_500k's
    batch of one); the cache paths match rules in both (no leaf of a
    recurrent cache falls through to replication)."""
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        cache = get_model(ARCHS[arch], "cpu").init_cache(b, s)
    jcache = jax.eval_shape(lambda: jax_get_model(JAX_ARCHS[arch]).init_cache(b, s))
    want = _ref_leaves(ref_specs.cache_shardings(jcache, JAX_ARCHS[arch], mesh, batch_size=b))
    got = dict(tsh.tree_leaves_with_path(
        tsh.cache_shardings(cache, ARCHS[arch], mesh, batch_size=b)))
    for path, _, rpath, _, k in _pairs(cache, jcache):
        assert tuple(got[path].spec) == tuple(want[rpath])[k:], (path, got[path].spec)
        if not path.endswith("len"):
            assert tsh._match(tsh._CACHE_RULES, path) is not None, path
    if shape_name == "long_500k" and "k" in got:
        assert got["k"].spec[3] == "data"   # sequence parallel at a batch of one


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_specs_equal_the_reference(arch, mesh, ref_specs):
    for shape_name, shape in SHAPES.items():
        spec = get_model(ARCHS[arch], "cpu").batch_spec(shape)
        with FakeTensorMode():
            batch = {k: torch.empty(s, dtype=dt) for k, (s, dt) in spec.items()}
        jspec = jax_get_model(JAX_ARCHS[arch]).batch_spec(JAX_SHAPES[shape_name])
        jbatch = {k: jax.ShapeDtypeStruct(s, dt) for k, (s, dt) in jspec.items()}
        want = ref_specs.batch_shardings(jbatch, mesh)
        got = tsh.batch_shardings(batch, mesh)
        assert set(got) == set(want)
        for k in got:
            assert tuple(got[k].spec) == tuple(want[k]), (shape_name, k)


def _zero1(parts, shape, dsize):
    """The reference's ZeRO-1 rule on a leaf of ``shape``."""
    parts = list(parts) + [None] * (len(shape) - len(parts))
    used = {n for p in parts if p is not None for n in (p if isinstance(p, tuple) else (p,))}
    if (shape and parts[0] is None and "data" not in used and shape[0] % dsize == 0
            and math.prod(shape) > 1024):
        parts[0] = "data"
    return tuple(parts)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_specs_follow_the_reference(arch, mesh, ref_specs):
    """ZeRO-1: a leaf the reference does not stack has the reference's
    spec; a stacked one has the reference's parameter spec with the
    stacking dims dropped and ZeRO-1 applied to the port's dim 0."""
    cfg = ARCHS[arch]
    params = _port_params(arch)
    with _MODES[arch, False]:
        opt = adamw_init(params)
    jopt = jax.eval_shape(jax_adamw_init, _ref_params(arch))
    want = _ref_leaves(ref_specs.opt_state_shardings(jopt, JAX_ARCHS[arch], mesh))
    got = dict(tsh.tree_leaves_with_path(tsh.opt_state_shardings(opt, cfg, mesh)))
    dsize = mesh.shape["data"]
    for path, shape, rpath, rshape, k in _pairs(opt, jopt):
        if k == 0:
            assert tuple(got[path].spec) == tuple(want[rpath]), path
        else:
            base = jsh._spec_for_leaf(rpath, rshape, mesh, jsh._PARAM_RULES,
                                      fsdp=cfg.fsdp_params)
            assert tuple(got[path].spec) == _zero1(tuple(base)[k:], shape, dsize), path


def _gloo_world():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_specs_on_a_real_one_device_mesh_equal_the_reference(arch):
    """A reduced model of each family on a gloo mesh of one rank and on
    jax's host mesh: the same spec leaf for leaf (both meshes size 1,
    so every rule's axis divides); `device_put` keeps each leaf a plain
    CPU tensor with its bits, the same object."""
    _gloo_world()
    mesh = make_host_mesh(1, "cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
    cfg = get_arch(arch, reduced=True)
    jcfg = jax_get_arch(arch, reduced=True)
    jmesh = jax_host_mesh(1)
    want = _ref_leaves(jax.tree.map(lambda s: s.spec, jsh.param_shardings(
        _ref_params(arch, True), jcfg, jmesh)))
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    psh = tsh.param_shardings(params, cfg, mesh)
    got = dict(tsh.tree_leaves_with_path(psh))
    for path, _, rpath, _, k in _pairs(params, _ref_params(arch, True)):
        assert tuple(got[path].spec) == tuple(want[rpath])[k:], path
    placed = tsh.device_put(params, psh)
    for (_, a), (_, b) in zip(tsh.tree_leaves_with_path(params),
                              tsh.tree_leaves_with_path(placed)):
        assert type(b) is torch.Tensor and b is a


def test_maybe_constrain_returns_a_plain_tensor_unchanged():
    x = torch.randn(8, 4)
    assert tsh.maybe_constrain(x, "dp", None) is x
    _gloo_world()
    with tsh.use_mesh(make_host_mesh(1, "cpu")) as mesh:
        assert tsh.active_mesh() is mesh
        assert tsh.maybe_constrain(x, "dp", "tp") is x
    assert tsh.active_mesh() is None
    # the spec it would constrain a DTensor to: 'dp' to the data axes,
    # 'tp' to model, undivided dims replicated
    axes = PROD3.shape
    assert tsh._constrain_spec((64, 8, 3), axes, ("dp", "tp", None)) == (("pod", "data"),
                                                                         None, None)
    assert tsh._constrain_spec((32, 16), axes, ("dp", "tp")) == (("pod", "data"), "model")


def test_production_mesh_needs_its_world_and_the_host_mesh_asserts():
    """`make_production_mesh` raises, naming the world it found, without
    256 or 512 ranks; `make_host_mesh` starts a one-process gloo group and
    asserts the reference's divisibility."""
    with pytest.raises(RuntimeError, match="needs a process group of 256 ranks; found none"):
        make_production_mesh(device_type="cpu")
    mesh = make_host_mesh(1, "cpu")
    assert dist.get_world_size() == 1 and mesh.size() == 1
    with pytest.raises(RuntimeError, match="512 ranks; found 1"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(AssertionError):
        make_host_mesh(2, "cpu")


def test_local_shapes_under_a_fake_group_of_four_follow_the_specs():
    """A fake group of 4 as a (2, 2) mesh: `device_put` makes each leaf
    a DTensor whose local shape is `NamedSharding.local_shape` of its
    spec (yi-6b reduced, fake parameters), and `maybe_constrain`
    redistributes a DTensor under the active mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_arch("yi-6b", reduced=True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        psh = tsh.param_shardings(params, cfg, mesh)
        placed = tsh.device_put(params, psh, src_data_rank=None)
    sharded = 0
    for (path, x), (_, sh) in zip(tsh.tree_leaves_with_path(placed),
                                  tsh.tree_leaves_with_path(psh)):
        assert isinstance(x, DTensor), path
        assert tuple(x.to_local().shape) == sh.local_shape(x.shape), (path, sh.spec)
        sharded += sh.local_shape(x.shape) != tuple(x.shape)
    assert sharded > 0
    # under the active mesh `maybe_constrain` redistributes a DTensor to
    # the divisibility-pruned spec: (8, 6) over data and model, (3, 6)
    # over model only (3 rows do not divide the data axis)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with FakeTensorMode(allow_non_fake_inputs=True), tsh.use_mesh(mesh):
        for rows, want in ((8, (Shard(0), Shard(1))), (3, (Replicate(), Shard(1)))):
            x = distribute_tensor(torch.empty(rows, 6), mesh, (Replicate(), Replicate()),
                                  src_data_rank=None)
            y = tsh.maybe_constrain(x, "dp", "tp")
            assert tuple(y.placements) == want, rows
            assert tuple(y.to_local().shape) == tsh.NamedSharding(
                mesh, tsh._constrain_spec((rows, 6), {"data": 2, "model": 2},
                                          ("dp", "tp"))).local_shape((rows, 6))


def test_on_local_blocks_places_blocks_by_logical_spec():
    """`sharding.on_local_blocks` on a (2, 2) mesh of a fake group of 4:
    plain tensors go to the function as they are; DTensors reach it as
    the blocks their logical specs give (rows over ``data``, channels over
    ``model``, a name dropped where its dim does not divide the axis),
    each output comes back placed by its spec with the names' resolved
    axes, and a gradient declared partial over ``dp`` reaches a
    parameter replicated there as a partial sum over ``data`` (over
    nothing where the rows did not divide it).  A name resolved two
    ways, a plain tensor beside a DTensor, or a partial gradient of an
    input sharded on that axis raise before the function runs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    seen = []

    def fn(x, w):
        seen.append([tuple(x.shape), tuple(w.shape)])
        return x * w, x.sum(dim=1)

    x, w = torch.ones(4, 3, 6), torch.ones(6)
    specs = (("dp", None, "tp"), ("tp",))
    outs = (("dp", None, "tp"), ("dp", "tp"))
    assert all(torch.equal(a, b) for a, b in zip(tsh.on_local_blocks(fn, (x, w), specs, outs),
                                                 fn(x, w)))
    for rows, row_axis in ((4, Shard(0)), (3, Replicate())):
        xd = distribute_tensor(torch.ones(rows, 3, 6), mesh, (Replicate(), Replicate()),
                               src_data_rank=None)
        # placed as its spec places it, so the gradient arrives as declared
        wd = distribute_tensor(w, mesh, (Replicate(), Shard(0)),
                               src_data_rank=None).requires_grad_(True)
        y, z = tsh.on_local_blocks(fn, (xd, wd), specs, outs,
                                   grad_specs=(None, ("dp",)))
        assert seen[-1] == [(rows // 2 if rows == 4 else rows, 3, 3), (3,)], seen[-1]
        assert tuple(y.placements) == (row_axis, Shard(2)) and y.shape == (rows, 3, 6)
        assert tuple(z.placements) == (row_axis, Shard(1)) and z.shape == (rows, 6)
        (g,) = torch.autograd.grad(y.sum(), wd)
        partial = Partial() if rows == 4 else Replicate()
        assert tuple(g.placements) == (partial, Shard(0)), (rows, g.placements)
    calls = len(seen)
    xd = distribute_tensor(x, mesh, (Replicate(), Replicate()), src_data_rank=None)
    wd = distribute_tensor(torch.ones(3), mesh, (Replicate(), Replicate()),
                           src_data_rank=None)
    with pytest.raises(ValueError, match="resolves"):
        tsh.on_local_blocks(fn, (xd, wd), specs, outs)        # 6 and 3 channels
    with pytest.raises(ValueError, match="one mesh"):
        tsh.on_local_blocks(fn, (xd, w), specs, outs)
    with pytest.raises(ValueError, match="sharded there"):
        tsh.on_local_blocks(fn, (xd, distribute_tensor(w, mesh, (Replicate(), Replicate()),
                                                       src_data_rank=None)),
                            specs, outs, grad_specs=(("tp",), None))
    assert len(seen) == calls


def test_index_shard_mesh_is_none_on_one_device_in_both_packages():
    """`_shard_mesh` of a plain and of a kernel strategy: None in both
    packages on one device; `index_shard_mesh` is None without a group
    and in a world of one."""
    from repro.index_service import ServiceConfig as JaxConfig
    from repro.index_service import ShardedIndexService as JaxSharded
    from repro_torch.index_service import ServiceConfig, ShardedIndexService
    from repro_torch.index_service.snapshot import REFERENCE_STRATEGY
    keys = np.sort(np.random.default_rng(0).uniform(0, 1e6, 4000))
    for strategy in ("binary", "cuda_fused"):
        svc = ShardedIndexService(keys, ServiceConfig(strategy=strategy, num_shards=4),
                                  device="cpu")
        jsvc = JaxSharded(keys, JaxConfig(strategy=REFERENCE_STRATEGY[strategy],
                                          num_shards=4))
        assert svc._shard_mesh() is None and jsvc._shard_mesh() is None
        np.testing.assert_array_equal(np.asarray(svc.lookup_batch(keys[:64])),
                                      np.asarray(jsvc.lookup_batch(keys[:64])))
    assert tsh.index_shard_mesh(4) is None
    _gloo_world()
    assert tsh.index_shard_mesh(4, "cpu") is None      # a world of one


def test_launch_train_builds_its_mesh_and_asserts_the_model_axis():
    """`launch.train` on the CPU goes through `make_host_mesh` (its own
    one-process group, destroyed when it returns); ``--model-axis 2`` on
    one device fails the reference's assertion before any step."""
    from repro_torch.launch import train as train_mod
    argv = ["--arch", "yi-6b", "--reduced", "--device", "cpu", "--steps", "2",
            "--global-batch", "2", "--seq", "16"]
    out = train_mod.main(argv)
    assert out["first_loss"] is not None and np.isfinite(out["last_loss"])
    assert not dist.is_initialized()
    with pytest.raises(AssertionError):
        train_mod.main(argv + ["--model-axis", "2"])
    assert not dist.is_initialized()


def test_restore_checkpoint_with_shardings_gives_the_saved_bits(tmp_path):
    """`restore_checkpoint(shardings=...)` on a gloo mesh of one: every
    leaf a plain tensor on the mesh's device with the saved bits and
    dtype (the elastic-restart path); ``device=`` stays for callers
    without a mesh."""
    from repro_torch.distributed import restore_checkpoint, save_checkpoint
    _gloo_world()
    mesh = make_host_mesh(1, "cpu")
    cfg = get_arch("olmoe-1b-7b", reduced=True)
    params = get_model(cfg, "cpu").init(torch.Generator().manual_seed(3))
    save_checkpoint(str(tmp_path), 5, params)
    like = get_model(cfg, "cpu").init(torch.Generator().manual_seed(4))
    got, step = restore_checkpoint(str(tmp_path), like,
                                   shardings=tsh.param_shardings(like, cfg, mesh))
    plain, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 5
    got, plain = dict(tsh.tree_leaves_with_path(got)), dict(tsh.tree_leaves_with_path(plain))
    for path, a in tsh.tree_leaves_with_path(params):
        b, c = got[path], plain[path]
        assert type(b) is torch.Tensor and b.device.type == "cpu" and b.dtype == a.dtype
        assert torch.equal(b.view(torch.int16) if b.dtype == torch.bfloat16 else b,
                           a.view(torch.int16) if a.dtype == torch.bfloat16 else a), path
        assert torch.equal(b, c), path
