"""PyTorch port: the mesh compositions over several processes (gloo, CPU)
against one process and against the JAX step on the same mesh.

Two launches run at once, each process running its runs one after
another in one process group (``parallel/launch.py``, a time limit each),
while this process computes the JAX steps on the same meshes over its 8
virtual CPU devices:

* 4 processes: ``{"pipe": 2, "fsdp": 2}`` and ``{"pipe": 2, "tensor": 2}``
  with the encoder, the projector and the LLM trained (FSDP2 inside each
  pipeline stage, tensor parallelism inside each stage);
* 2 processes: ``{"tensor": 2}`` with everything trained (the
  vocabulary-parallel table and CE, the encoder's tensor-parallel
  backward), with LoRA (dropout 0.1, the JAX step's masks fed) and with
  QLoRA over int8 (its quantized projections replicated, the table
  sharded).

Each trains tests/test_torch_multiprocess.py's tiny fp32 model (the
half_audio flags otherwise, ``fsdp_min_size`` 1) for two steps on its
ragged batch and then its padded one.  The first step's learning rate is
the warm-up's 0, so both gradients are taken at the initial weights and
the checks see no rounding amplified by an update.  Every process reports
the same global metrics bit for bit and keeps its frozen tensors' bits;
the losses and accuracies are within 1e-5 of the port's one-process run
and of the JAX step, and AdamW's first moments of every trained tensor
(gathered whole) within 1e-5 of each tensor's largest.  One fault of the
JAX step shows here (``JAX_FAULTS``): on ``{"pipe": 2, "fsdp": 2}`` it
doubles the FSMN kernels' gradients against its own one-device step; the
port's equal the one-device values, and JAX's halved.

Then the finetune CLI (tests/test_torch_finetune.py's manifest and
recipe): ``{"pipe": 2, "fsdp": 2}`` and ``{"pipe": 2, "tensor": 2}`` in
one 4-process launch write the one-process CLI's losses and export,
resume their sharded train state bit for bit, and their four rank files'
tensors hold exactly the one-process state's bytes; alongside,
``{"pipe": 2, "data": 2, "fsdp": 2}`` in 8 processes runs, checkpoints and
exports from rank 0, as tests/test_cli.py runs it for JAX.

CPU time alone: ~120 s (the JAX steps' compiles overlap the launches).
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if __name__ != "__main__":
    from test_torch_finetune import _args, _metrics, _steps, fixtures  # noqa: F401
    from test_torch_multiprocess import (  # noqa: F401
        TOL, _close, _launch, _moments_close, _state_bytes, cli_one, make_inputs,
    )

# tests/test_torch_multiprocess.py's model and schedule (its ranks import
# nothing of the JAX side, so neither do these)
SPEECH = 250
ENC_VOCAB, LLM_DIM, INPUT = 11, 64, 560
MIN_SIZE = 1
PP_MICRO = 2
SEED = 0
TRAIN = dict(lr=1e-3, warmup_steps=1, total_steps=10)

BASE = dict(ctc_posterior=True, do_psd=True)
PEFT = dict(r=4, lora_alpha=8, target_modules=["q_proj", "k_proj", "v_proj", "o_proj",
                                                "gate_proj", "up_proj", "down_proj"])
DROPOUT = 0.1
KINDS = {
    "trained": dict(BASE, freeze_llm=False, freeze_encoder=False),
    "lora": dict(BASE, freeze_llm=True, freeze_encoder=True, use_peft=True),
    "qlora8": dict(BASE, freeze_llm=True, freeze_encoder=True, use_peft=True,
                   quantization=True, quant_bits=8),
}
GROUPS = {4: [({"pipe": 2, "fsdp": 2}, "trained"), ({"pipe": 2, "tensor": 2}, "trained")],
          2: [({"tensor": 2}, "trained"), ({"tensor": 2}, "lora"), ({"tensor": 2}, "qlora8")]}
CASES = [(m, k) for runs in GROUPS.values() for m, k in runs]
CLI_MESHES = [{"pipe": 2, "fsdp": 2}, {"pipe": 2, "tensor": 2}]
CLI_EIGHT = {"pipe": 2, "data": 2, "fsdp": 2}
# the JAX step's faults on a mesh, against its own one-device step (the
# port is held to the one-device values there, and to the mesh's scaled):
# on pipe x fsdp every FSMN kernel's gradient comes out doubled (its
# moments 2x; the losses and every other tensor's moments agree)
JAX_FAULTS = {"pipe2+fsdp2/trained": (".fsmn.weight", 2.0)}


def _tag(mesh_shape, kind=None):
    return "+".join(f"{k}{v}" for k, v in mesh_shape.items()) + (f"/{kind}" if kind else "")


def _configs(kind):
    from ps_slm_tpu_torch.config import ModelConfig, PeftConfig, TrainConfig

    peft = PeftConfig(**PEFT, lora_dropout=DROPOUT) if "lora" in kind else PeftConfig()
    tc = TrainConfig(**KINDS[kind], **TRAIN, fsdp_min_size=MIN_SIZE, pp_microbatches=PP_MICRO,
                     peft_config=peft)
    mc = ModelConfig(encoder_projector="linear-silu", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM,
                     encoder_config_overrides={"input_size": INPUT})
    return tc, mc


# ----------------------------------------------------------------------------
# the port's runs (any process count)
# ----------------------------------------------------------------------------

def run_port(spec, runs):
    """Each run (mesh shape or None, kind) on this process's block of the
    global batches: the metrics of each step, AdamW's first moment of each
    trained tensor this process holds (whole) and whether the frozen
    tensors kept their bits."""
    from ps_slm_tpu_torch.models import tasu
    from ps_slm_tpu_torch.parallel import mesh as meshlib
    from ps_slm_tpu_torch.training.step import make_train_step

    out = {}
    for mesh_shape, kind in runs:
        tc, mc = _configs(kind)
        model = tasu.model_factory(tc, mc, device="cpu")
        model.load_state_dict(spec["state"][kind])
        model.speech_token_id = SPEECH
        trainable = set(tasu.trainable_mask(model, tc))
        if mesh_shape:
            mesh = meshlib.build_mesh(mesh_shape, "cpu")
            meshlib.shard_params(model, mesh, mesh_shape, tc.fsdp_min_size, tc.pp_microbatches)
        frozen = {n: (p.to_local() if hasattr(p, "to_local") else p).detach().clone()
                  for n, p in model.named_parameters() if n not in trainable}
        step = make_train_step(model, tc, device="cpu")
        ctx = model.mesh
        block = None if ctx is None else ctx.row_block
        metrics = []
        for i, b in enumerate(spec["inputs"]):
            b = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            if block is not None:
                n = b["input_ids"].shape[0] // block.count
                b = {k: v[block.index * n:(block.index + 1) * n] for k, v in b.items()}
            m = step(b, lora_masks=spec["masks"][kind][i])
            metrics.append([float(m["loss"]), float(m["acc"]), int(m["ntokens"])])
        params = dict(model.named_parameters())
        moments = {}
        for n in step.trainable:
            m = step.optimizer.state[params[n]]["exp_avg"]
            moments[n] = m.detach().clone() if ctx is None else ctx.whole(n, m).clone()
        out[_tag(mesh_shape or {"one": 1}, kind)] = {
            "metrics": metrics, "moments": moments,
            "frozen_equal": all(torch.equal((params[n].to_local() if hasattr(params[n], "to_local")
                                             else params[n]).detach(), v)
                                for n, v in frozen.items()),
            "sharded": sorted(ctx.tp) if ctx is not None else [],
        }
    return out


def _worker(mode, spec_path, out_dir):
    """One process of a launch: its mesh runs, or its CLI runs (each on a
    port of its own)."""
    sys.path.insert(0, ROOT)
    rank = int(os.environ["PS_HOST_ID"])
    with open(spec_path, "rb") as f:
        spec = torch.load(f, weights_only=False)
    if mode == "cli":
        from ps_slm_tpu_torch.cli import finetune

        for run in spec["runs"]:
            os.environ["PS_COORDINATOR"] = f"localhost:{run['port']}"
            if finetune.main(run["args"], device="cpu") != 0:
                raise SystemExit(f"rank {rank}: {run['tag']} failed")
        return
    import torch.distributed as dist

    from ps_slm_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu")
    try:
        torch.save(run_port(spec, spec["runs"]), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _launch_all(launches):
    """Each (argv, n) launched at once; re-raises the first failure."""
    failed = []

    def run(argv, n):
        try:
            _launch(argv, n)
        except BaseException as e:          # noqa: BLE001 - re-raised below
            failed.append(e)

    threads = [threading.Thread(target=run, args=a) for a in launches]
    for th in threads:
        th.start()
    return threads, failed


def _join(threads, failed):
    for th in threads:
        th.join()
    if failed:
        raise failed[0]


# ----------------------------------------------------------------------------
# the JAX side (the parent process only)
# ----------------------------------------------------------------------------

def _jax_model(kind):
    import jax

    from ps_slm_tpu.config import ModelConfig as JaxModelConfig
    from ps_slm_tpu.config import PeftConfig as JaxPeftConfig
    from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
    from ps_slm_tpu.models import tasu as jtasu
    from test_torch_peft import _perturb

    peft = JaxPeftConfig(**PEFT, lora_dropout=DROPOUT) if "lora" in kind else JaxPeftConfig()
    jtc = JaxTrainConfig(**KINDS[kind], **TRAIN, peft_config=peft)
    jm = jtasu.model_factory(jtc, JaxModelConfig(
        llm_path="", encoder_projector="linear-silu", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM,
        encoder_config_overrides={"input_size": INPUT}), rng=jax.random.PRNGKey(SEED))
    if "lora" in kind:
        jm.params = _perturb(jm.params)      # LoRA's B nonzero: every adapter acts
    jm.speech_token_id = SPEECH
    return jtc, jm


def run_jax(inputs, mesh_shape, kind):
    """The JAX step on ``mesh_shape``: each step's metrics and AdamW's first
    moments of the trained tensors, by the port's names."""
    import jax
    import jax.numpy as jnp

    from ps_slm_tpu.models import tasu as jtasu
    from ps_slm_tpu.parallel import mesh as jmesh
    from ps_slm_tpu.training import step as jstep
    from ps_slm_tpu.training import train_state as jts
    from ps_slm_tpu_torch import convert

    n = int(np.prod(list(mesh_shape.values())))
    mesh = jmesh.build_mesh(mesh_shape, jax.devices()[:n])
    jtc, jm = _jax_model(kind)
    jm.mesh = mesh
    jm.pp_microbatches = PP_MICRO
    jm.params = jmesh.shard_params(jm.params, mesh, MIN_SIZE)
    trainable = jtasu.trainable_mask(jm, jtc)
    tx, _ = jts.build_optimizer(jtc, trainable)
    state = jts.create_train_state(jm.params, tx, trainable)
    step = jstep.make_train_step(jm, tx, trainable)
    metrics = []
    for b in inputs:
        jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in b.items()}
        state, m = step(state, jmesh.shard_batch(jb, mesh), jax.random.PRNGKey(SEED))
        metrics.append([float(m["loss"]), float(m["acc"]), int(m["ntokens"])])
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    mu = jts.combine(jax.tree_util.tree_map(np.asarray, adam.mu),
                     jax.tree_util.tree_map(np.zeros_like, params))
    return {"metrics": metrics, "moments": convert.from_jax_params(mu)}


def _jax_masks(inputs, kind, merged_shapes):
    """The JAX step's LoRA dropout masks at each step (its key folded with
    the step), for the global batch."""
    if "lora" not in kind:
        return [None] * len(inputs)
    import jax

    from test_torch_peft_train import _jax_masks as masks

    _, jm = _jax_model(kind)
    return [masks(jax.random.fold_in(jax.random.PRNGKey(SEED), i), jm, shape, DROPOUT)
            for i, shape in enumerate(merged_shapes)]


# ----------------------------------------------------------------------------
# the mesh cases
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import jax

    from ps_slm_tpu_torch import convert
    from ps_slm_tpu_torch.models import tasu

    d = tmp_path_factory.mktemp("mesh")
    inputs = make_inputs()["features"][1:]          # the ragged batch, then the padded one
    state, masks = {}, {}
    for kind in KINDS:
        _, jm = _jax_model(kind)
        state[kind] = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
        tc, mc = _configs(kind)
        pm = tasu.model_factory(tc, mc, device="cpu")
        pm.load_state_dict(state[kind])
        pm.speech_token_id = SPEECH
        with torch.no_grad():
            shapes = [tuple(tasu.prepare_merged(pm, {k: torch.from_numpy(v) for k, v in b.items()}
                                                ).embeds.shape) for b in inputs]
        masks[kind] = _jax_masks(inputs, kind, shapes)
    launches = []
    for n, runs in GROUPS.items():
        path = str(d / f"spec{n}.pt")
        torch.save({"state": state, "inputs": inputs, "masks": masks, "runs": runs}, path)
        (d / f"out{n}").mkdir()
        launches.append(([sys.executable, __file__, "mesh", path, str(d / f"out{n}")], n))
    threads, failed = _launch_all(launches)
    try:
        jax_out = {_tag(m, k): run_jax(inputs, m, k) for m, k in CASES}
        one = run_port({"state": state, "inputs": inputs, "masks": masks},
                       [(None, k) for k in KINDS])
    finally:
        _join(threads, failed)
    ranks = {n: [torch.load(d / f"out{n}" / f"rank{r}.pt", weights_only=False)
                 for r in range(n)] for n in GROUPS}
    return {"ranks": ranks, "jax": jax_out, "one": one}


@pytest.mark.parametrize("mesh_shape,kind", CASES, ids=[_tag(m, k) for m, k in CASES])
def test_mesh_composition_matches_one_process_and_jax(mesh_runs, mesh_shape, kind):
    tag = _tag(mesh_shape, kind)
    n = int(np.prod(list(mesh_shape.values())))
    recs = [r[tag] for r in mesh_runs["ranks"][n]]
    got = recs[0]
    for r in recs[1:]:                    # every process: the same global metrics, bit for bit
        assert r["metrics"] == got["metrics"], tag
    assert all(r["frozen_equal"] for r in recs), tag
    moments = {}
    for r in recs:                        # a pipeline stage holds its own layers' state
        for k, v in r["moments"].items():
            if k in moments:
                assert torch.equal(moments[k], v), f"{tag} {k}: ranks differ"
            moments[k] = v
    one = mesh_runs["one"][_tag({"one": 1}, kind)]
    j = mesh_runs["jax"][tag]
    for what, want in (("one process", one), ("JAX", j)):
        _close([m[:2] for m in got["metrics"]], [m[:2] for m in want["metrics"]], TOL,
               f"{tag} vs {what}")
        assert [m[2] for m in got["metrics"]] == [m[2] for m in want["metrics"]], tag
    _moments_close(moments, one["moments"], f"{tag} moments vs one process")
    suffix, factor = JAX_FAULTS.get(tag, (None, 1.0))
    faulty = {k for k in one["moments"] if suffix and k.endswith(suffix)}
    _moments_close(moments, {k: j["moments"][k] * (1.0 / factor if k in faulty else 1.0)
                             for k in one["moments"]}, f"{tag} moments vs JAX")
    if faulty:                            # the JAX step's own fault, not the port's
        _moments_close({k: moments[k] for k in faulty}, {k: one["moments"][k] for k in faulty},
                       f"{tag} {suffix} vs one process")
    sharded = set(recs[0]["sharded"])
    if "tensor" in mesh_shape:            # the JAX rule's tensor leaves, cut here
        assert "llm.embed_tokens.weight" in sharded, tag
        assert {"encoder.encoders0.qkv.weight", "encoder.encoders0.out.weight",
                "encoder.encoders0.w1.weight", "encoder.encoders0.w2.weight"} <= sharded, tag
        quantized = kind == "qlora8"
        assert ("llm.layers.0.q_proj.weight" in sharded) != quantized, tag   # stage 0's
    # the ragged batch: the blocks hold different label counts
    labels = make_inputs()["features"][1]["labels"]
    assert (labels[:2, 1:] != -100).sum() != (labels[2:, 1:] != -100).sum()


# ----------------------------------------------------------------------------
# the finetune CLI
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(cli_one, tmp_path_factory):
    from ps_slm_tpu_torch.parallel.launch import coordinator_port

    data, one = cli_one
    d = tmp_path_factory.mktemp("cli_mesh")
    ports: set = set()

    def args(out, mesh_shape, resume=None):
        a = _args(data, out) + ["++train_config.mesh_shape=" + json.dumps(mesh_shape),
                                "++train_config.fsdp_min_size=1",
                                f"++train_config.pp_microbatches={PP_MICRO}",
                                "++train_config.save_last=true"]
        return a + ([f"++train_config.resume_from={resume}"] if resume else [])

    runs = []
    for mesh_shape in CLI_MESHES:
        out = str(d / _tag(mesh_shape))
        runs.append(dict(tag=_tag(mesh_shape), port=coordinator_port(ports),
                         args=args(out, mesh_shape)))
        runs.append(dict(tag=_tag(mesh_shape) + " resumed", port=coordinator_port(ports),
                         args=args(out + "_resumed", mesh_shape, f"{out}/step_2/state")))
    eight = [dict(tag=_tag(CLI_EIGHT), port=coordinator_port(ports),
                  args=args(str(d / _tag(CLI_EIGHT)), CLI_EIGHT))]
    launches = []
    for name, n, rs in (("four", 4, runs), ("eight", 8, eight)):
        path = str(d / f"{name}.pt")
        torch.save({"runs": rs}, path)
        launches.append(([sys.executable, __file__, "cli", path, str(d)], n))
    _join(*_launch_all(launches))
    return {"one": one, "dir": d}


@pytest.mark.parametrize("mesh_shape", CLI_MESHES, ids=[_tag(m) for m in CLI_MESHES])
def test_finetune_cli_pipe_compositions_resume_bit_for_bit(cli_runs, mesh_shape):
    one, out = cli_runs["one"], str(cli_runs["dir"] / _tag(mesh_shape))
    want, want_eval = _metrics(one)
    got, got_eval = _metrics(out)
    assert sorted(got) == sorted(want)
    for s in want:
        _close(got[s], want[s], TOL, f"step {s}")
    _close([got_eval[s] for s in sorted(got_eval)], [want_eval[s] for s in sorted(want_eval)],
           TOL, "eval")
    assert _steps(out) == _steps(one)
    for tag in _steps(one) + ["last"]:
        a = torch.load(f"{one}/{tag}/pytorch_model.bin", weights_only=True)
        b = torch.load(f"{out}/{tag}/pytorch_model.bin", weights_only=True)
        assert sorted(a) == sorted(b)
        for k in a:
            _close(b[k].numpy(), a[k].numpy(), TOL, f"{tag} {k}")
        files = sorted(os.listdir(f"{out}/{tag}/state"))
        assert files == [f"train_state.rank{r}.pt" for r in range(4)]
        # each shard and each replicated tensor in one rank's file
        assert sum(_state_bytes(f"{out}/{tag}/state/{f}") for f in files) == _state_bytes(
            f"{one}/{tag}/state/train_state.pt"), tag
    with open(f"{out}/log.txt") as f:
        assert "exported the reference checkpoint" in f.read()
    for r in range(1, 4):
        with open(f"{out}/log.txt.rank{r}") as f:
            assert "exported the reference checkpoint" not in f.read()
    again, _ = _metrics(out + "_resumed")
    first = int(_steps(out)[0][len("step_"):])
    assert sorted(again) == [s for s in sorted(got) if s > first]
    assert all(again[s] == got[s] for s in again)
    a = torch.load(f"{out}/last/pytorch_model.bin", weights_only=True)
    b = torch.load(f"{out}_resumed/last/pytorch_model.bin", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_finetune_cli_pipe_data_fsdp_in_eight_processes(cli_runs):
    one, out = cli_runs["one"], str(cli_runs["dir"] / _tag(CLI_EIGHT))
    want, _ = _metrics(one)
    got, _ = _metrics(out)
    assert sorted(got) == sorted(want)
    for s in want:
        _close(got[s], want[s], TOL, f"step {s}")
    assert _steps(out) == _steps(one)
    assert sorted(os.listdir(f"{out}/last/state")) == sorted(
        f"train_state.rank{r}.pt" for r in range(8))
    a = torch.load(f"{one}/last/pytorch_model.bin", weights_only=True)
    b = torch.load(f"{out}/last/pytorch_model.bin", weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        _close(b[k].numpy(), a[k].numpy(), TOL, f"last {k}")


if __name__ == "__main__":
    _worker(*sys.argv[1:4])
