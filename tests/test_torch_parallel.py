"""The port's backend, mesh and partition rules against the JAX package's.

``spec_for`` on every parameter of a small DALL·E and dVAE (named through
``convert.flax_path``) equals the JAX ``spec_for`` on the 8-device mesh of
the conftest; the torch-layout mapping puts fsdp on the right torch
dimension; ``build_mesh`` and ``local_batch_size`` behave as JAX's;
``shard_batch`` gives each rank the rows that the JAX ``shard_batch`` puts
on the device at the same (dp, fsdp) coordinate; the registry, the command
line and the Dummy contract mirror ``tests/test_parallel.py``.
"""

import argparse

import jax
import numpy as np
import pytest
import torch

from dalle_tpu import parallel as jpar
from dalle_tpu.config import MeshConfig as JMeshConfig
from dalle_tpu_torch import parallel as par
from dalle_tpu_torch.config import DalleConfig, DVAEConfig, MeshConfig
from dalle_tpu_torch.convert import _port_axis, flax_path
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.models.dvae import DiscreteVAE
from dalle_tpu_torch.parallel.partition import _flax_leaf, torch_fsdp_dim

TINY = dict(num_text_tokens=60, text_seq_len=6, dim=64, depth=2, heads=4, dim_head=16,
            image_size=16, image_vocab_size=48, image_fmap_size=4)
MESH8 = {"dp": 2, "fsdp": 2, "sp": 1, "tp": 2}


def _models():
    return {"dalle": DALLE(DalleConfig(**TINY)),
            "dvae": DiscreteVAE(DVAEConfig(image_size=16, num_layers=2, num_tokens=32,
                                           codebook_dim=16, hidden_dim=8))}


def test_default_rules_are_the_jax_rules():
    assert [(p, tuple(s)) for p, s in par.DEFAULT_RULES] == \
        [(p, tuple(s)) for p, s in jpar.DEFAULT_RULES]


@pytest.mark.parametrize("kind", ["dalle", "dvae"])
def test_spec_for_matches_jax_on_every_parameter(kind, mesh8):
    model = _models()[kind]
    port_mesh = par.ProcessMesh(MESH8)
    seen = set()
    for name, p in model.named_parameters():
        path, shape = _flax_leaf(model, name, tuple(p.shape))
        path = "/".join(path)
        for mesh, pmesh in ((None, None), (mesh8, port_mesh)):
            want = jpar.spec_for(path, shape, mesh=mesh)
            got = par.spec_for(path, shape, mesh=pmesh)
            assert tuple(got) == tuple(want), (path, shape, got, want)
        seen.add(tuple(want))
    # the mesh specs of the rule kinds each model has showed up
    assert len(seen) >= {"dalle": 3, "dvae": 2}[kind]


def test_flax_paths_are_the_jax_trees():
    """The paths named above are the JAX DALL·E's parameter tree, leaf for
    leaf, with its shapes."""
    import jax.numpy as jnp
    from dalle_tpu.config import DalleConfig as JDalleConfig
    from dalle_tpu.models.dalle import DALLE as JDALLE
    jm = JDALLE(JDalleConfig(**TINY))
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, TINY["text_seq_len"]), jnp.int32),
                                          jnp.zeros((1, 16), jnp.int32)))["params"]
    want = {"/".join(str(k.key) for k in kp): tuple(x.shape)
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    model = _models()["dalle"]
    got = {}
    for name, p in model.named_parameters():
        path, shape = _flax_leaf(model, name, tuple(p.shape))
        got["/".join(path)] = shape
    assert got == want


def test_torch_layout_puts_fsdp_on_the_right_dimension():
    mesh = par.ProcessMesh({"dp": 1, "fsdp": 2, "sp": 1, "tp": 1})
    m = _models()
    dalle, dvae = m["dalle"], m["dvae"]
    dims = par.make_param_shardings(mesh, dalle)
    # Dense (in, out) → Linear.weight (out, in): P("fsdp", "tp") splits dim 1
    assert dims["transformer.attn_0.to_qkv.weight"] == 1
    assert dims["transformer.ff_0.w1.weight"] == 1
    # P("tp", "fsdp") on (in, out): the torch weight's dim 0
    assert dims["transformer.attn_0.to_out.weight"] == 0
    assert dims["transformer.ff_0.w2.weight"] == 0
    # embeddings keep (vocabulary, feature): the vocabulary splits
    assert dims["text_emb.weight"] == 0 and dims["image_emb.weight"] == 0
    assert dims["final_norm.weight"] is None and dims["to_logits.bias"] is None
    vdims = par.make_param_shardings(mesh, dvae)
    conv = [n for n, p in dvae.named_parameters() if p.dim() == 4]
    assert conv
    for n in conv:
        path = flax_path(dvae, n)
        # a conv rule's HWIO output channels land where the converter puts
        # axis 3 (OIHW: 0, a transposed conv's IOHW: 1); a 1×1 projection
        # outside the rule ("proj_in") stays whole, as in the JAX package
        want = _port_axis(path, 4, 3) if "conv" in "/".join(path) else None
        assert vdims[n] == want, n
    assert {vdims[n] for n in conv} >= {0, None}


def test_fsdp_dim_replicates_what_does_not_divide():
    mesh = par.ProcessMesh({"dp": 1, "fsdp": 3, "sp": 1, "tp": 1})
    model = DALLE(DalleConfig(**TINY))
    # dim 64 does not split in 3; the 3h·d = 192 axis is not the fsdp one
    assert torch_fsdp_dim(model, "transformer.attn_0.to_qkv.weight", (192, 64), mesh) is None


def test_build_mesh_shapes_and_errors():
    m = par.build_mesh(MeshConfig(dp=2, fsdp=2, tp=2, sp=1), world=8)
    assert m.shape == {"dp": 2, "fsdp": 2, "sp": 1, "tp": 2}
    assert par.build_mesh(MeshConfig(tp=2), world=8).shape["dp"] == 4
    assert par.build_mesh(MeshConfig(dp=3), world=2).shape["dp"] == 2
    with pytest.raises(ValueError, match="do not divide device count 8"):
        par.build_mesh(MeshConfig(fsdp=3), world=8)
    with pytest.raises(ValueError, match="do not divide device count 8"):
        jpar.build_mesh(JMeshConfig(fsdp=3))
    assert par.local_batch_size(par.build_mesh(MeshConfig(dp=2, fsdp=2, tp=2), world=8),
                                16) == 4
    with pytest.raises(ValueError, match="not divisible by data-parallel size 4"):
        par.local_batch_size(par.build_mesh(MeshConfig(dp=2, fsdp=2, tp=2), world=8), 6)
    # the ranks' coordinates are the JAX devices' places in the mesh array
    m = par.ProcessMesh(MESH8, rank=5)
    assert m.coords == dict(zip(("dp", "fsdp", "sp", "tp"),
                                np.argwhere(m.devices == 5)[0].tolist()))
    assert m.ranks_along(("tp",)) == [4, 5] and m.ranks_along(("dp", "fsdp")) == [1, 3, 5, 7]


def test_shard_batch_rows_match_jax_shards(mesh8):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    stack = np.arange(2 * 16, dtype=np.float32).reshape(2, 16)
    jx = jpar.shard_batch(mesh8, x)
    jstack = jpar.shard_stacked_batch(mesh8, stack)
    devices = list(np.asarray(mesh8.devices).reshape(-1))
    for pos, dev in enumerate(devices):
        pm = par.ProcessMesh(MESH8, rank=pos)
        want = next(np.asarray(s.data) for s in jx.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(par.shard_batch(pm, x), want)
        want = next(np.asarray(s.data) for s in jstack.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(par.shard_stacked_batch(pm, stack), want)
        # a tensor batch and a leaf without a batch axis
        got = par.shard_batch(pm, (torch.from_numpy(x), None))
        np.testing.assert_array_equal(got[0].numpy(), par.shard_batch(pm, x))
        assert got[1] is None
    assert tuple(par.batch_spec(par.ProcessMesh(MESH8))) == tuple(jpar.batch_spec(mesh8))


def test_backend_registry_and_cli(capsys):
    parser = argparse.ArgumentParser()
    par.wrap_arg_parser(parser)
    args = parser.parse_args(["--distributed_backend", "torch", "--num_processes", "1"])
    b = par.set_backend_from_args(args)
    assert isinstance(b, par.TorchBackend)
    assert par.using_backend("torch") and par.using_backend(par.TorchBackend)
    b.initialize(MeshConfig())
    assert b.get_world_size() == 1 and b.get_rank() == 0
    assert b.is_root_worker() and b.wire == "gloo"
    b.local_barrier()
    assert abs(b.average_all(np.array([2.0, 4.0])) - 3.0) < 1e-6
    # the JAX CLI's names and the GPU engines' run on the torch backend
    for name in ("jax", "deepspeed", "horovod"):
        b = par.set_backend_from_args(argparse.Namespace(distributed_backend=name))
        assert isinstance(b, par.TorchBackend)
        assert f"backend {name!r} runs on the torch.distributed backend" in \
            capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown distributed backend"):
        par.set_backend_from_args(argparse.Namespace(distributed_backend="mpi"))
    # the command line wins over torch's launcher env
    args = parser.parse_args(["--distributed_backend", "torch", "--coordinator_address",
                              "h:1", "--num_processes", "4", "--process_id", "2"])
    env = {"MASTER_ADDR": "x", "MASTER_PORT": "9", "WORLD_SIZE": "8", "RANK": "7"}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        assert par.set_backend_from_args(args)._topology()[:3] == ("h:1", 4, 2)
        b = par.set_backend_from_args(argparse.Namespace(distributed_backend="torch"))
        assert b._topology()[:3] == ("x:9", 8, 7)


def test_wire_choice():
    """The wire from every rank's (host, card UUID): NCCL only when no two
    ranks share a card; a rank's card is its local rank modulo the cards
    it sees."""
    from dalle_tpu_torch.parallel.backend import choose_wire, local_device
    assert choose_wire([None, None]) == "gloo"                      # the CPU
    assert choose_wire([("h", "GPU-a"), ("h", "GPU-a")]) == "gloo"  # two ranks, one card
    assert choose_wire([("h", "GPU-a"), None]) == "gloo"
    # torchrun on 2 hosts × 8 cards: 16 ranks, world > each host's 8 cards
    hosts = [(f"h{r // 8}", f"GPU-{r // 8}-{local_device(r % 8, 8)}") for r in range(16)]
    assert choose_wire(hosts) == "nccl"
    # the elastic agent gives each worker one visible card: each sees one
    # device (index 0), but the cards differ
    assert [local_device(r, 1) for r in range(4)] == [0, 0, 0, 0]
    assert choose_wire([("h", f"GPU-{r}") for r in range(4)]) == "nccl"
    # the JAX flags with no LOCAL_RANK: the global rank past this host's cards
    assert [local_device(r, 8) for r in (0, 7, 8, 13)] == [0, 7, 0, 5]


def test_dummy_backend_contract():
    b = par.set_backend_from_args(argparse.Namespace(distributed_backend="dummy"))
    assert isinstance(b, par.DummyBackend)
    b.initialize()
    assert b.get_world_size() == 1
    assert b.is_root_worker() and b.is_local_root_worker()
    b.check_batch_size(1)
    p = b.distribute(params={"w": torch.ones(2)})
    assert p["w"].shape == (2,)
    assert b.mesh.size == 1 and par.replicated(b.mesh) == par.P()


def test_distribute_cuts_fsdp_slices():
    mesh = par.ProcessMesh({"dp": 1, "fsdp": 2, "sp": 1, "tp": 1}, rank=1)
    model = DALLE(DalleConfig(**TINY))
    sd = model.state_dict()
    out = par.shard_params(mesh, model, {k: sd[k] for k, _ in model.named_parameters()})
    w = sd["transformer.attn_0.to_qkv.weight"]
    assert torch.equal(out["transformer.attn_0.to_qkv.weight"], w[:, w.shape[1] // 2:])
    assert out["final_norm.weight"] is sd["final_norm.weight"]
    assert par.constrain(mesh, w) is w and par.commit_to_mesh(mesh, sd) is sd
