"""The port's sharding rules against the JAX package's, case by case:
``param_specs``, ``cache_specs``, ``batch_spec`` and ``cache_struct`` equal
JAX's on abstract production meshes (no devices), and ``to_placements``
gives each rank of a fake 2 x 4 mesh the slice the spec names."""
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import runtime_flags as jflags  # noqa: E402
from repro.configs import INPUT_SHAPES, list_architectures  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models.transformer import param_shapes as jparam_shapes  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch import runtime_flags as flags  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

ROOT = __file__.rsplit("/tests", 1)[0]
MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(sizes, names):
    try:
        return AbstractMesh(tuple(zip(names, sizes)))
    except (TypeError, ValueError):
        return AbstractMesh(sizes, names)


def _meshes(kind):
    sizes, names = MESHES[kind]
    return _jmesh(sizes, names), Mesh(names, sizes)


def _set(variant, jm, tm):
    jflags.set_variant(variant, jm)
    flags.set_variant(variant, tm)


@pytest.fixture(autouse=True)
def _reset_variant():
    yield
    jflags.set_variant("baseline")
    flags.set_variant("baseline")


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _tleaves(tree):
    if isinstance(tree, shd.P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _tleaves(tree[k])]
    return [s for v in tree for s in _tleaves(v)]


def _same(jtree, ttree):
    js, ts = _jleaves(jtree), _tleaves(ttree)
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        assert tuple(j) == tuple(t), (j, t)


@pytest.mark.parametrize("variant", ["baseline", "attn_repl", "fsdp",
                                     "attn_repl+fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_architectures())
def test_param_specs_equal_jax(arch, mesh, variant):
    jm, tm = _meshes(mesh)
    _set(variant, jm, tm)
    jcfg, cfg = jget_config(arch), get_config(arch)
    _same(jshd.param_specs(jcfg, jparam_shapes(jcfg), jm),
          shd.param_specs(cfg, param_shapes(cfg), tm))


@pytest.mark.parametrize("variant", ["baseline", "cache_seqshard",
                                     "attn_repl", "kv_int8"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", list_architectures())
def test_cache_specs_equal_jax(arch, shape, variant):
    jm, tm = _meshes("1pod")
    _set(variant, jm, tm)
    sh = INPUT_SHAPES[shape]
    b, s = sh["global_batch"], sh["seq_len"]
    _same(jshd.cache_specs(jget_config(arch), jm, b, s),
          shd.cache_specs(get_config(arch), tm, b, s))


@pytest.mark.parametrize("case", [("1pod", 1, 524288), ("1pod", 256, 0),
                                  ("2pod", 256, 0)])
def test_batch_spec_equal_jax(case):
    """The three cases of test_batch_spec_long_context_falls_back_to_seq."""
    mesh, batch, seq = case
    jm, tm = _meshes(mesh)
    kw = dict(seq_dim=1, seq_len=seq) if seq else {}
    j = jshd.batch_spec(jm, batch, 2, **kw)
    t = shd.batch_spec(tm, batch, 2, **kw)
    assert tuple(j) == tuple(t)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", list_architectures())
def test_cache_struct_equal_jax(arch, quantized):
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    j = jcache.cache_struct(jcfg, 4, 64, quantized=quantized)
    t = tcache.cache_struct(cfg, 4, 64, quantized=quantized)
    assert len(j["layers"]) == len(t["layers"])
    for je, te in zip(j["layers"], t["layers"]):
        assert sorted(je) == sorted(te)
        for name in je:
            assert tuple(je[name].shape) == tuple(te[name].shape)
            assert te[name].dtype == _DTYPES[str(je[name].dtype)]
            assert te[name].device.type == "meta"


# spec -> on a (2, 4) ("data", "model") mesh, each rank's local shard of a
# (4, 8, 12) tensor must be the slice the spec names, axes major to minor
SPECS = [(None, None, None), ("data", None, None), (None, "model", None),
         ("data", "model", None), (None, ("data", "model"), None),
         ("model", None, "data")]


def _expected_slice(spec, coords, sizes, shape):
    out = []
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n, idx = 1, 0
        for a in axes:
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        step = shape[dim] // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


@pytest.fixture(scope="module")
def fake_mesh_shards():
    """Each rank's local shard under every spec, from a fake process group
    re-joined as each of the 8 ranks in one subprocess."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, "src")
        import torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel.sharding import to_placements
        x = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
        out = {{}}
        for rank in range(8):
            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=8)
            mesh = make_host_mesh(2, 4)
            for i, spec in enumerate({SPECS!r}):
                loc = distribute_tensor(x, mesh, to_placements(spec, mesh),
                                        src_data_rank=None).to_local()
                out[f"{{rank}}/{{i}}"] = loc.tolist()
            dist.destroy_process_group()
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_to_placements_local_shards_match_slices(fake_mesh_shards, i):
    x = np.arange(4 * 8 * 12, dtype=np.float32).reshape(4, 8, 12)
    sizes = {"data": 2, "model": 4}
    for rank in range(8):
        coords = {"data": rank // 4, "model": rank % 4}
        want = x[_expected_slice(SPECS[i], coords, sizes, x.shape)]
        got = np.asarray(fake_mesh_shards[f"{rank}/{i}"], np.float32)
        np.testing.assert_array_equal(got, want)


def test_to_placements_refuses_axes_out_of_mesh_order():
    with pytest.raises(ValueError):
        shd.to_placements(shd.P(("model", "data"), None),
                          Mesh(("data", "model"), (2, 4)))
