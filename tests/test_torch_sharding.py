"""``repro_torch.launch.sharding`` against ``repro.launch.sharding``, leaf by
leaf, with no world: the rules read only a mesh's axis sizes, so a
``FakeMesh`` drives them (the reference's ``NamedSharding`` patched to pass
the spec through, as ``tests/test_sharding.py`` does).

The reference stacks a model's layers on a leading axis; the port keeps one
dict per layer.  A reference spec maps onto the port's leaf by dropping its
stack entry.  Where the reference's rule reads that stack dim as a weight
dim the port does not copy it (ROADMAP §3): a dense FFN's stacked ``(L, D,
F)`` leaf takes the expert rule (``model`` on the layers), and Jamba's
stacked ``(G, d_inner)`` per-channel vectors shard the stack where the rule
means d_inner.  There the port holds the reference's own rule applied to the
per-layer leaf.  Also: ``shard_params`` on fake ranks, the head and slot
layouts, a mesh of one bit-identical to no mesh, and the refusals."""
import functools
from dataclasses import dataclass, replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_config
from repro.launch import sharding as RS
from repro.models import model as RM
from repro_torch.configs import get_config as p_config
from repro_torch.launch import sharding as PS
from repro_torch.launch.mesh import current_mesh, make_mesh, set_mesh
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine

torch.set_num_threads(1)


@dataclass
class FakeMesh:
    shape: dict
    axis_names: tuple


MESHES = {
    "1x2": FakeMesh({"data": 1, "model": 2}, ("data", "model")),
    "4x4": FakeMesh({"data": 4, "model": 4}, ("data", "model")),
    "2x4": FakeMesh({"data": 2, "model": 4}, ("data", "model")),
    "1x3": FakeMesh({"data": 1, "model": 3}, ("data", "model")),
    "pod2x4x4": FakeMesh({"pod": 2, "data": 4, "model": 4}, ("pod", "data", "model")),
    "data4": FakeMesh({"data": 4}, ("data",)),
}
STACKS = ("layers", "encoder", "decoder")


class Leaf:
    def __init__(self, *shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


@pytest.fixture(autouse=True)
def spec_passthrough(monkeypatch):
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: spec)


def _flat(tree, path=()):
    """path -> leaf; a spec (a tuple) is a leaf."""
    if isinstance(tree, (PS.PartitionSpec, RS.P)):
        return {path: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, path + (str(i),)).items()}
    return {path: tree}


def _norm(spec) -> tuple:
    """A spec's entries, an axis tuple of one as its name (as jax's
    ``PartitionSpec`` reads it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _per_layer(rcfg, tree) -> dict:
    """The reference's flat tree keyed by the port's paths: a stacked leaf
    once per layer (``periods[pos]`` at index g is layer g * period + pos)."""
    out = {}
    for path, v in _flat(tree).items():
        top = path[0]
        if top in STACKS:
            n = rcfg.enc_layers if top == "encoder" else rcfg.n_layers
            for l in range(n):
                out[(top, str(l)) + path[1:]] = v
        elif top == "periods":
            period = len(tree["periods"])
            for g in range(rcfg.n_layers // period):
                out[("layers", str(g * period + int(path[1]))) + path[2:]] = v
        else:
            out[path] = v
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    rcfg = r_config(arch).reduced()
    return rcfg, jax.eval_shape(lambda: RM.init_params(rcfg, jax.random.PRNGKey(0)))


def _port_tree(rcfg, shapes):
    """The port's parameter tree of ``Leaf``s, built from the reference's
    shapes as ``models.convert`` builds the port's parameters."""
    tree: dict = {}
    for path, v in _per_layer(rcfg, shapes).items():
        stacked = path[0] in STACKS
        t = tree
        for k in path[:-1]:
            t = t.setdefault(k, {})
        t[path[-1]] = Leaf(*(v.shape[1:] if stacked else v.shape))

    def lists(t):
        if isinstance(t, dict):
            if t and all(k.isdigit() for k in t):
                return [lists(t[str(i)]) for i in range(len(t))]
            return {k: lists(v) for k, v in t.items()}
        return t

    return lists(tree)


def _pinned(path) -> bool:
    """The leaves where the reference's rule reads the stack dim."""
    leaf = path[-1]
    return (path[-2] == "ffn" and leaf in ("wg", "wu", "wd")) or leaf in ("Dskip", "conv_b",
                                                                           "dt_bias")


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_param_specs_match_reference(arch, mesh, fsdp):
    rcfg, shapes = _shapes(arch)
    pcfg, m = p_config(arch).reduced(), MESHES[mesh]
    want = _per_layer(rcfg, RS.param_specs(shapes, m, fsdp=fsdp, cfg=rcfg))
    got = _flat(PS.param_specs(_port_tree(rcfg, shapes), m, fsdp=fsdp, cfg=pcfg))
    assert set(got) == set(want)
    shape_of = _per_layer(rcfg, shapes)
    differ = set()
    for path, spec in want.items():
        stacked = path[0] in STACKS
        ref = _norm(spec)[1:] if stacked else _norm(spec)
        if _norm(got[path]) == ref:
            continue
        differ.add(path)
        assert stacked and _pinned(path), (path, ref, _norm(got[path]))
        # the port holds the reference's rule on the per-layer leaf
        shape = tuple(shape_of[path].shape[1:])
        per_layer = RS._param_rule("/".join(path), shape, m, rcfg)
        if fsdp:
            per_layer = RS._add_fsdp(type(per_layer)(None, *per_layer), (1,) + shape, m,
                                     exclude_last=path[-1] in ("wq", "wk", "wv"))[1:]
        assert _norm(got[path]) == _norm(per_layer), path
    if arch == "h2o-danube-3-4b" and mesh == "1x2" and not fsdp:  # the pinned difference
        wd = ("layers", "0", "ffn", "wd")
        assert wd in differ and tuple(want[wd]) == ("model", None, None)
        assert tuple(got[wd]) == ("model", None)


def _port_state_specs(pcfg, m, b):
    state = PM.init_decode_state(pcfg, b, 128, ring=False, device="meta")
    return _flat(PS.state_specs(pcfg, m, state))


@pytest.mark.parametrize("b", [8, 1, 6])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_state_specs_match_reference(arch, mesh, b):
    """The reference's (L, B, S, KV, dh) caches onto the port's (L, B, KV,
    S, Dh), and its stacked period states onto one state per layer."""
    rcfg, pcfg, m = r_config(arch).reduced(), p_config(arch).reduced(), MESHES[mesh]
    shapes = jax.eval_shape(lambda: RM.init_decode_state(rcfg, b, 128, ring=False))
    want = _flat(RS.state_specs(rcfg, m, shapes))
    got = _port_state_specs(pcfg, m, b)
    swap = lambda s: (s[0], s[2], s[1]) + tuple(s[3:])  # noqa: E731 — (B, S, KV) <-> (B, KV, S)
    if pcfg.family in ("hybrid", "ssm"):
        period = len(shapes["periods"])
        mapped = {}
        for path, spec in want.items():
            if path[0] != "periods":
                mapped[path] = _norm(spec)
                continue
            pos = int(path[1])
            for g in range(rcfg.n_layers // period):
                l = g * period + pos
                s = _norm(spec)[1:]
                mapped[("layers", str(l), path[2])] = (
                    swap(s) if pcfg.layer_kind(l) == "attn" else s)
    else:
        mapped = {p: (tuple(_norm(s)[i] for i in (0, 1, 3, 2, 4)) if p[0] == "layers"
                      else _norm(s))
                  for p, s in want.items()}
    assert {p: _norm(s) for p, s in got.items()} == mapped


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_replicated_and_fsdp_match_reference(mesh):
    m = MESHES[mesh]
    batch = {"tokens": Leaf(8, 128), "odd": Leaf(6, 128), "embeds": Leaf(16, 4, 32), "one": Leaf(1)}
    want = RS.batch_specs(None, None, m, batch)
    assert {k: _norm(v) for k, v in PS.batch_specs(None, None, m, batch).items()} == \
        {k: _norm(v) for k, v in want.items()}
    assert {k: _norm(v) for k, v in PS.replicated(m, batch).items()} == \
        {k: _norm(v) for k, v in RS.replicated(m, batch).items()}
    for spec, shape in [((None, "model"), (256, 512)), ((None, "model"), (253, 512)),
                        ((None, None, "model"), (4, 256, 512)), ((None, None), (6, 10)),
                        (("model", None, None), (8, 64, 64))]:
        for last in (False, True):
            assert _norm(PS._add_fsdp(PS.P(*spec), shape, m, exclude_last=last)) == \
                _norm(RS._add_fsdp(RS.P(*spec), shape, m, exclude_last=last))


class FakeRank(FakeMesh):
    """A rank of a mesh with no world: its coordinates along each axis."""

    def __init__(self, shape, axes, coords):
        super().__init__(dict(zip(axes, shape)), tuple(axes))
        self.coords, self.device = dict(zip(axes, coords)), torch.device("cpu")

    def local_rank(self, axis):
        return self.coords[axis]

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
                                        ((2, 1, 2), ("pod", "data", "model"))])
def test_shard_params_cuts_every_rank_its_part(shape, axes):
    """Every rank's shards of a Mixtral tree, put back together, are the
    tree: each leaf's part of rank ``coords`` along each sharded dim."""
    pcfg = p_config("mixtral-8x7b").reduced()
    rcfg, shapes = _shapes("mixtral-8x7b")
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    full = params_from_numpy(pcfg, tree, "cpu")
    specs = PS.param_specs(full, FakeMesh(dict(zip(axes, shape)), axes), fsdp=True, cfg=pcfg)
    flat_full, flat_spec = _flat(full), _flat(specs)
    parts = {}
    for coords in np.ndindex(*shape):
        rank = FakeRank(shape, axes, coords)
        local = _flat(PS.shard_params(PS.copy_tree(full), specs, rank))
        for path, t in local.items():
            idx = []
            for d, e in enumerate(flat_spec[path]):
                n, i = PS.shard_index(rank, e)
                k = flat_full[path].shape[d] // n
                assert t.shape[d] == k
                idx.append(slice(i * k, (i + 1) * k))
            parts.setdefault(path, []).append((tuple(idx), t))
    for path, pieces in parts.items():
        out = torch.full_like(flat_full[path], float("nan"))
        for idx, t in pieces:
            out[idx] = t
        assert torch.equal(out, flat_full[path]), path
    assert any(any(e is not None for e in s) for s in flat_spec.values())


def test_shard_params_frees_each_full_leaf():
    """The tree is cut in place: the full leaves it held go."""
    pcfg = p_config("h2o-danube-3-4b").reduced()
    gen = torch.Generator().manual_seed(0)
    tree = PM.init_params(pcfg, gen)
    wq = tree["layers"][0]["mixer"]["wq"]
    rank = FakeRank((1, 2), ("data", "model"), (0, 1))
    out = PS.shard_params(tree, PS.param_specs(tree, rank, cfg=pcfg), rank)
    assert out is tree and tree["layers"][0]["mixer"]["wq"].shape == (128, 64)
    assert torch.equal(tree["layers"][0]["mixer"]["wq"], wq[:, 64:])
    assert tree["layers"][0]["mixer"]["wq"].untyped_storage().data_ptr() != \
        wq.untyped_storage().data_ptr()


@pytest.mark.parametrize("h,kv,m,r,want", [
    (4, 2, 2, 1, ([2, 3], [1])),          # heads and KV heads over model
    (4, 2, 4, 3, ([3], [1])),             # KV heads whole: the rank's group
    (32, 8, 16, 5, ([10, 11], [2])),      # two q heads of one group
    (12, 4, 3, 1, ([4, 5, 6, 7], [1, 2])),        # two q heads of each of two groups
    (12, 4, 3, 0, ([0, 1, 2, 3], [0, 0, 0, 1])),  # groups of 3 cut unevenly: one per q head
    (6, 2, 4, 0, (list(range(6)), [0, 1])),       # neither divides: whole on every rank
])
def test_attention_heads(h, kv, m, r, want):
    cfg = replace(p_config("h2o-danube-3-4b").reduced(), n_heads=h, n_kv_heads=kv, d_head=8,
                  d_model=96)
    rank = FakeRank((1, m), ("data", "model"), (0, r))
    q, kvs = PS.attention_heads(cfg, rank)
    assert (list(q), kvs) == want


@pytest.mark.parametrize("shape,axes,coords,want", [
    ((2, 2), ("data", "model"), (1, 0), (4, 4)),
    ((3, 2), ("data", "model"), (2, 1), (8, 0)),   # 8 slots do not divide 3: every slot
    ((2, 2, 2), ("pod", "data", "model"), (1, 0, 1), (2, 4)),
    ((4,), ("data",), (3,), (2, 6)),
])
def test_slot_layout(shape, axes, coords, want):
    assert PS.slot_layout(8, FakeRank(shape, axes, coords)) == want


def test_set_mesh_context_manager():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert current_mesh() is None
    with set_mesh(mesh):
        assert current_mesh() is mesh
        with set_mesh(None):
            assert current_mesh() is None
        assert current_mesh() is mesh
    assert current_mesh() is None


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x7b"])
def test_mesh_of_one_is_bit_identical_to_no_mesh(arch):
    """A (1, 1) mesh needs no process group and changes nothing: the same
    parameter tensors, greedy tokens and sampled logits."""
    pcfg = p_config(arch).reduced()
    rcfg = r_config(arch).reduced()
    tree = jax.tree_util.tree_map(np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(0)))
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (5, 12, 30)]
    out = []
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        params = params_from_numpy(pcfg, tree, "cpu")
        eng = ServingEngine(pcfg, params, ServeConfig(batch_slots=2, max_len=64,
                                                      max_new_tokens=5), mesh=mesh)
        assert all(a is b for a, b in zip(_flat(eng.params).values(), _flat(params).values()))
        logits = []
        real = PM.decode_slots

        def record(*args):
            lg, st = real(*args)
            logits.append(lg.clone())
            return lg, st

        PM.decode_slots = record
        try:
            hs = [eng.submit(p) for p in prompts]
            eng.drain()
        finally:
            PM.decode_slots = real
        out.append(([h.tokens for h in hs], logits))
    assert out[0][0] == out[1][0]
    assert len(out[0][1]) == len(out[1][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


WORLD2 = FakeMesh({"data": 1, "model": 2}, ("data", "model"))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m", "seamless-m4t-large-v2"])
def test_recurrent_and_audio_families_refuse_a_model_axis(arch):
    pcfg = p_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="3a-iii"):
        ServingEngine(pcfg, {"embed": torch.zeros(2, 2)}, ServeConfig(), mesh=WORLD2)


def test_tuner_under_a_mesh_of_ranks_is_refused():
    pcfg = p_config("h2o-danube-3-4b").reduced()
    with pytest.raises(NotImplementedError, match="3a-iii"):
        ServingEngine(pcfg, {"embed": torch.zeros(2, 2)}, ServeConfig(), mesh=WORLD2,
                      tuner=object())


def test_trainer_refuses_a_mesh(tmp_path):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    pcfg = p_config("minicpm-2b").reduced()
    with pytest.raises(NotImplementedError, match="3a-ii"):
        Trainer(pcfg, AdamWConfig(), DataConfig(seq_len=8, global_batch=2, vocab=pcfg.vocab),
                TrainerConfig(ckpt_dir=str(tmp_path)), mesh=WORLD2, device="cpu")


NARROW = {  # leaf -> (path, dim cut in half)
    "embed rows": ("h2o-danube-3-4b", ("embed",), 0),
    "embed features": ("h2o-danube-3-4b", ("embed",), 1),
    "lm_head columns": ("h2o-danube-3-4b", ("lm_head",), 1),
    "wo rows": ("h2o-danube-3-4b", ("layers", 0, "mixer", "wo"), 0),
    "wq columns": ("h2o-danube-3-4b", ("layers", 0, "mixer", "wq"), 1),
    "dense wd rows": ("h2o-danube-3-4b", ("layers", 0, "ffn", "wd"), 0),
    "experts": ("mixtral-8x7b", ("layers", 0, "ffn", "wg"), 0),
    "expert wd rows": ("mixtral-8x7b", ("layers", 0, "ffn", "wd"), 1),
}


@pytest.mark.parametrize("leaf", list(NARROW))
def test_a_narrow_leaf_without_a_model_axis_raises(leaf):
    """Without a mesh (or on a mesh of one) a leaf narrower than the config
    is not taken for a shard: the forward raises instead of running on it."""
    arch, path, dim = NARROW[leaf]
    pcfg = p_config(arch).reduced()
    params = PM.init_params(pcfg, torch.Generator().manual_seed(0))
    parent = functools.reduce(lambda t, k: t[k], path[:-1], params)
    w = parent[path[-1]]
    parent[path[-1]] = w.narrow(dim, 0, w.shape[dim] // 2).contiguous()
    tokens = torch.arange(1, 9, dtype=torch.int64)[None]
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        with set_mesh(mesh):
            state = PM.init_decode_state(pcfg, 1, 16, ring=False, device="cpu")
            with pytest.raises((ValueError, RuntimeError)):
                PM.decode_step(pcfg, params, state, tokens)
