"""PyTorch port: the mesh's shape and placement rules against the JAX
package (``parallel/mesh.py``), pure Python, one process.

* ``mesh_dims`` (the axis sizes ``build_mesh`` lays the ranks out by) gives
  the JAX ``build_mesh``'s shape and raises its ``ValueError``.
* ``param_shardings`` over the port's parameter tree, read through the
  name map (``jax_leaf``), gives every JAX leaf the spec the JAX rule gives
  it on the JAX tree of the same model, at ``{"fsdp": 4}``,
  ``{"data": 2, "fsdp": 2, "tensor": 2}``, ``{"pipe": 2, "data": 4}``,
  ``{"tensor": 2}`` and ``{"pipe": 2, "fsdp": 2, "tensor": 2}``
  and at ``min_size`` 2**16 and 1; two models: the published half_audio one
  (linear-silu) and one with the q-former projector, an int8 LLM and LoRA.
* ``torch_placements`` puts each spec on the port's own dimensions; the
  vocabulary's and the encoder's leaves, which the port now shards over
  ``tensor``, each where the JAX spec of its leaf puts it.
* ``pad_batch_to_multiple`` equals JAX's.
* ``gathered`` makes whole, for its duration, only the submodules an
  export writes (the finetune CLI's ``exclude``) and puts every leaf back.

Exact equality throughout.  CPU time alone: ~10 s.
"""

import jax
import numpy as np
import pytest
import torch

from ps_slm_tpu.config import ModelConfig as JaxModelConfig
from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
from ps_slm_tpu.models import tasu as jtasu
from ps_slm_tpu.parallel import mesh as jmesh
from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.parallel import mesh

MESHES = [{"fsdp": 4}, {"data": 2, "fsdp": 2, "tensor": 2}, {"pipe": 2, "data": 4},
          {"tensor": 2}, {"pipe": 2, "fsdp": 2, "tensor": 2}]
HALF_AUDIO = dict(ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True)
MODELS = {
    "half_audio": (HALF_AUDIO, dict(encoder_projector="linear-silu", encoder_dim=11, llm_dim=64)),
    "qformer_qlora": (dict(HALF_AUDIO, use_peft=True, quantization=True),
                      dict(encoder_projector="q-former", encoder_dim=11, llm_dim=64, query_len=4)),
}


@pytest.mark.parametrize("shape,n", [(None, 8), ({"data": 2, "fsdp": 4}, 8), ({"tensor": 8}, 8),
                                     ({"pipe": 2, "data": 2, "tensor": 2}, 8), ({"fsdp": 4}, 4),
                                     (None, 1)])
def test_mesh_shape_equals_jax(shape, n):
    want = jmesh.build_mesh(shape, jax.devices()[:n]).shape
    assert mesh.mesh_dims(shape, n) == dict(want)
    assert tuple(mesh.mesh_dims(shape, n)) == mesh.AXES == tuple(want)


@pytest.mark.parametrize("shape,n", [({"data": 3}, 8), ({"data": 2, "fsdp": 2}, 8),
                                     ({"pipe": 4, "tensor": 4}, 8)])
def test_mesh_shape_errors_equal_jax(shape, n):
    with pytest.raises(ValueError) as jerr:
        jmesh.build_mesh(shape, jax.devices()[:n])
    with pytest.raises(ValueError) as err:
        mesh.mesh_dims(shape, n)
    assert str(err.value) == str(jerr.value)


@pytest.fixture(scope="module", params=sorted(MODELS))
def trees(request):
    flags, mc = MODELS[request.param]
    jm = jtasu.model_factory(JaxTrainConfig(**flags), JaxModelConfig(llm_path="", **mc),
                             rng=jax.random.PRNGKey(0))
    pm = tasu.model_factory(TrainConfig(**flags), ModelConfig(**mc), device="cpu")
    return jm.params, pm


def _jax_specs(params, shape, min_size):
    n = int(np.prod(list(shape.values())))
    shardings = jmesh.param_shardings(params, jmesh.build_mesh(shape, jax.devices()[:n]),
                                      min_size)
    out = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(shardings):
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        leaf = params
        for k in key:
            leaf = leaf[k]
        spec = tuple(sh.spec) + (None,) * (np.ndim(leaf) - len(sh.spec))
        out[key] = spec
    return out


@pytest.mark.parametrize("shape", MESHES, ids=[str(m) for m in MESHES])
@pytest.mark.parametrize("min_size", [2 ** 16, 1])
def test_param_shardings_equal_jax(trees, shape, min_size):
    params, pm = trees
    want = _jax_specs(params, shape, min_size)
    got = mesh.param_shardings(mesh._named_shapes(pm), shape, min_size)
    assert set(got) == set(want)
    for path in want:
        assert got[path] == want[path], path
    if min_size == 1:
        axes = {a for spec in got.values() for a in spec if a}
        assert axes == set(shape) - {"data"}      # every model axis places something


def test_torch_placements_follow_the_name_map():
    flags, mc = MODELS["half_audio"]
    pm = tasu.model_factory(TrainConfig(**flags), ModelConfig(**mc), device="cpu")
    named = mesh._named_shapes(pm)
    place = mesh.torch_placements(named, {"data": 2, "fsdp": 2, "tensor": 2}, 1)
    # JAX kernels are [in, out]: column-parallel shards out = nn.Linear dim 0
    assert place["llm.layers.0.q_proj.weight"] == ("tensor", "fsdp")
    assert place["llm.layers.1.o_proj.weight"] == ("fsdp", "tensor")
    assert place["projector.ffn1.weight"] == ("tensor", None)
    assert place["projector.ffn2.weight"] == ("fsdp", "tensor")
    # the FSMN kernels stay replicated; the encoder's qkv [in, 3d] shards
    assert place["encoder.encoders.0.fsmn.weight"] == (None, None, None)
    assert place["encoder.encoders0.qkv.weight"] == ("tensor", "fsdp")
    assert place["llm.embed_tokens.weight"] == ("tensor", "fsdp")
    pipe = mesh.torch_placements(named, {"pipe": 2, "data": 4}, 1)
    assert pipe["llm.layers.0.q_proj.weight"] == (None, None)   # the stage holds the layer
    assert mesh.jax_leaf("llm.layers.3.q_proj.weight", (64, 64)).layer == 3
    assert mesh.jax_leaf("cmvn_neg_mean", (560,)) is None


@pytest.mark.parametrize("shape", [{"tensor": 2}, {"pipe": 2, "fsdp": 2, "tensor": 2}],
                         ids=["tensor2", "pipe2+fsdp2+tensor2"])
def test_torch_placements_of_the_vocabulary_and_encoder_equal_jax(trees, shape):
    params, pm = trees
    want = _jax_specs(params, shape, 1)
    named = mesh._named_shapes(pm)
    place = mesh.torch_placements(named, shape, 1)
    seen = 0
    for name, shp in named:
        if not name.startswith(("llm.embed_tokens", "llm.lm_head", "encoder.")):
            continue
        leaf = mesh.jax_leaf(name, shp)
        if leaf is None:
            continue
        spec = want[leaf.path][1:] if leaf.layer is not None else want[leaf.path]
        mine = [None] * len(shp)
        for j, axis in enumerate(spec):
            mine[leaf.dims[j]] = axis
        assert place[name] == tuple(mine), name
        seen += "tensor" in place[name]
    assert place["llm.embed_tokens.weight"][0] == "tensor"
    assert place["encoder.encoders0.qkv.weight"][0] == "tensor"     # JAX's [in, 3d] columns
    assert place["encoder.encoders.0.out.weight"][1] == "tensor"
    assert seen >= 1 + 4 * 4                    # the table and 4 x 4 encoder projections


def test_pad_batch_to_multiple_equals_jax():
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 9, (5, 3)), "x": rng.normal(size=(5, 2, 2))}
    for mult in (1, 2, 4, 8):
        want = jmesh.pad_batch_to_multiple(batch, mult)
        got = mesh.pad_batch_to_multiple(batch, mult)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("exclude", [(), ("llm", "encoder"), ("llm", "encoder", "projector")])
def test_gathered_makes_whole_only_what_the_export_writes(exclude):
    """Every parameter cut over ``tensor`` (a stand-in context whose
    ``whole`` doubles a shard): inside ``gathered`` the submodules outside
    ``exclude`` read whole and those inside keep their shards, none of them
    gathered; afterwards every parameter is the one it was."""
    tc, mc = TrainConfig(**HALF_AUDIO), ModelConfig(**MODELS["half_audio"][1])
    model = tasu.model_factory(tc, mc, device="cpu")
    before = dict(model.named_parameters())
    asked = []

    class Cut:
        tp, freed = set(before), {}

        def whole(self, name, p):
            asked.append(name)
            return torch.cat([p, p])

    model.mesh = Cut()
    with mesh.gathered(model, exclude) as m:
        state = m.state_dict()
    kept = {n for n in before if n.split(".")[0] in exclude}
    assert sorted(asked) == sorted(set(before) - kept)
    for n, p in before.items():
        assert state[n].shape[0] == p.shape[0] * (1 if n in kept else 2), n
    assert all(p is before[n] for n, p in model.named_parameters())
