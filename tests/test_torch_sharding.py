"""The port's logical-axis sharding against the reference's, in one
process (no process group: the mesh here is any object with
``mesh_dim_names``, which is all that specs and placements read).

* ``spec_for`` under each of the three rules tables gives the reference's
  ``PartitionSpec`` entries;
* ``param_shardings`` of every arch's reduced config gives, leaf by leaf,
  the reference's specs on the reference's ``init`` tree (and with the
  MoE experts padded for tensor parallelism);
* ``placements_for`` maps a spec onto DTensor placements, mesh dim by
  mesh dim; ``state_shardings`` places moments like their parameters;
* ``shard`` is the identity outside a mesh and on a plain tensor.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import padded_for_tp as ref_padded  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import sharding as RS  # noqa: E402
from repro_torch.configs import ARCHS, padded_for_tp  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding as S  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

RULES = {"default": (RS.DEFAULT_RULES, S.DEFAULT_RULES),
         "sp": (RS.SP_RULES, S.SP_RULES),
         "inference": (RS.INFERENCE_RULES, S.INFERENCE_RULES)}

#: every logical name once, the MoE and Mamba layouts, names that repeat an
#: axis (the second use drops it), and unknown names
NAME_SETS = [
    *[(n,) for n in sorted(RS.DEFAULT_RULES)],
    ("act_batch", "act_seq", "act_embed"),
    ("act_batch", "act_heads", "act_seq", None),
    ("experts", "expert_in", "expert_out"),
    (None, "experts", "expert_in", "expert_out"),
    ("vocab", "embed"),
    ("embed", "qkv_fsdp", "heads"),
    ("act_batch", "act_seq", "act_vocab", "act_exp"),
    ("ssm_fsdp", "ssm_inner", "ssm_state"),
    (None, None),
    ("no_such_name", "heads"),
    (),
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite's workers share the cores, and beside
    them torch's pool of a thread a core made this file's CPU work up to
    30 times slower (contention, not work)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(*names):
    return types.SimpleNamespace(mesh_dim_names=tuple(names))


def test_rules_tables_are_the_reference_s():
    for name, (ref, port) in RULES.items():
        assert port == ref, name


@pytest.mark.parametrize("rules", sorted(RULES))
def test_spec_for_matches_the_reference(rules):
    ref, port = RULES[rules]
    for names in NAME_SETS:
        with RS.axis_rules(None, ref):
            want = tuple(RS.spec_for(*names))
        with S.axis_rules(None, port):
            got = S.spec_for(*names)
        assert got == want, (rules, names)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shardings_match_the_reference(arch, tp):
    rcfg = ref_padded(REF_ARCHS[arch].reduced(), tp)
    pcfg = padded_for_tp(ARCHS[arch].reduced(), tp)
    shapes = jax.eval_shape(lambda: RM.init(rcfg, jax.random.PRNGKey(0), tp=tp))
    with RS.axis_rules(None, RS.DEFAULT_RULES):
        want = RM.param_shardings(rcfg, shapes)
    want_by_path = {
        "/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
        for path, spec in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}
    params = M.init(pcfg, torch.Generator().manual_seed(0), device="cpu", tp=tp)
    with S.axis_rules(None, S.DEFAULT_RULES):
        got = M.param_shardings(pcfg, params)
    got_by_path = {}
    M._tree_map(lambda path, spec: got_by_path.__setitem__("/".join(path),
                                                           spec), got)
    assert got_by_path == want_by_path
    shapes_by_path = {
        "/".join(str(getattr(k, "key", k)) for k in path): tuple(a.shape)
        for path, a in jax.tree_util.tree_leaves_with_path(shapes)}
    M._tree_map(lambda path, a: np.testing.assert_equal(
        tuple(a.shape), shapes_by_path["/".join(path)]), params)


def test_placements_follow_the_spec():
    """A spec maps tensor dims to mesh axes, placements mesh dims to tensor
    dims: a dim over ('pod', 'data') is Shard on both; axes the mesh lacks
    are dropped."""
    mesh = _mesh("pod", "data", "model")
    assert S.placements_for(mesh, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert S.placements_for(mesh, (None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert S.placements_for(_mesh("data", "model"), (("pod", "data"),)) == (
        Shard(0), Replicate())
    assert S.placements_for(mesh, ()) == (Replicate(),) * 3
    sh = S.NamedSharding.of(_mesh("data", "model"), ("data", "model"))
    assert sh.placements == (Shard(0), Shard(1))


def test_state_shardings_place_moments_like_their_parameters():
    from repro_torch.train.train_step import init_state, state_shardings

    cfg = padded_for_tp(ARCHS["granite-moe-3b-a800m"].reduced(), 2)
    state = init_state(cfg, M.init(cfg, torch.Generator().manual_seed(0),
                                   device="cpu", tp=2))
    mesh = _mesh("data", "model")
    with S.axis_rules(mesh, S.DEFAULT_RULES):
        sh = state_shardings(cfg, state, mesh)
    wg = sh.params["groups"]["blk0"]["ffn"]["w_gate"]
    # (stack, experts, d_model, d_ff): experts over model, d_model over data
    assert wg.placements == (Shard(2), Shard(1))
    assert sh.opt.m["groups"]["blk0"]["ffn"]["w_gate"] == wg
    assert sh.opt.v["embed"] == sh.params["embed"]
    assert sh.opt.step.placements == sh.step.placements == (Replicate(),) * 2
    # no compression: each residual leaf is a scalar placeholder
    assert sh.residual["embed"].placements == (Replicate(),) * 2
    assert sh.rng is None


def test_shard_is_the_identity_outside_a_mesh_and_on_plain_tensors():
    x = torch.randn(2, 3, 4)
    assert S.shard(x, "act_batch", "act_seq", "act_embed") is x
    with S.axis_rules(_mesh("data", "model")):
        assert S.shard(x, "act_batch", "act_seq", "act_embed") is x


def test_production_mesh_asks_for_the_reference_shapes(monkeypatch):
    """``make_production_mesh`` builds no mesh here (it needs 256 or 512
    ranks): it asks ``init_device_mesh`` for the reference's shapes."""
    import torch.distributed.device_mesh as DM

    from repro.launch import mesh as RMESH
    from repro_torch.launch import mesh as PM

    asked = []
    monkeypatch.setattr(DM, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: asked.append(
                            (dev, shape, mesh_dim_names)) or
                        _mesh(*mesh_dim_names))
    m1 = PM.make_production_mesh()
    m2 = PM.make_production_mesh(multi_pod=True, device_type="cpu")
    assert asked == [("cuda", (16, 16), ("data", "model")),
                     ("cpu", (2, 16, 16), ("pod", "data", "model"))]
    assert PM.batch_axes(m1) == ("data",)
    assert PM.batch_axes(m2) == ("pod", "data")
    assert RMESH.batch_axes(types.SimpleNamespace(
        axis_names=("pod", "data", "model"))) == PM.batch_axes(m2)
