"""PyTorch port: training over several processes (gloo, CPU) against one
process and against the JAX step on the same mesh.

Each case launches 2 or 4 processes of this file (``parallel/launch.py``,
a time limit each) that join one gloo group, lay a tiny fp32 TASU model
(the published half_audio flags, linear-silu, encoder input 560) out on
the mesh with ``fsdp_min_size`` 1 (so that every axis shards something
at these widths) and train on their blocks of the same global batches:

* ``features``: 3 steps on LFR features, the second batch ragged (its
  two halves hold different label counts: a mean of the processes' means
  would differ), the third padded (a ``batch_valid`` row);
* ``dither``: two steps on int16 waveforms through the training front
  end (dither + SpecAugment);
* ``text_only``: two text-only TASU steps with the CPS noise.

(The first step's learning rate is the warm-up's 0, so the second is the
one that moves the projector.)

The last two run twice: with the processes' own generator draws (made at
the global batch's shape and cut to each block), held to one process's
run, and with the JAX step's draws for the global batch fed in, held to
the JAX step on the same mesh over the 8 virtual CPU devices.

Every process must report the same global loss bit for bit; the frozen
weights must stay bit-identical.  Tolerances: losses, accuracies and
trained weights within 1e-5 (absolute and relative) of the port's
one-process run and of the JAX step on the same mesh (measured on
``{"data": 2}``: 1.4e-6 on the losses, 1.6e-7 on the weights against
JAX).  AdamW's first moments of the trained tensors (the JAX state's
``mu``), the gradients' running mean, within 1e-5 of each tensor's
largest: the weights alone would not see a gradient scaled by a constant
(AdamW's m / (sqrt(v) + eps) does not change), such as a sum divided
twice or once too often.

The finetune CLI in 2 processes (``{"data": 2}``, ``{"fsdp": 2}`` and
``{"pipe": 2}``) writes the losses and the export of the one-process
CLI, resumes its sharded train state bit for bit, and only rank 0 writes
the export.  Its rank files hold each tensor once: their tensors' bytes
add up to the one-process train state's.

CPU time alone: ~155 s (10 launches of 2-4 processes, the mesh cases each alongside the
JAX steps on its mesh, which compile once a mesh and case).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    from test_torch_finetune import _args, _metrics, _steps, fixtures  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEECH = 250
ENC_VOCAB, LLM_DIM, INPUT = 11, 64, 560
MIN_SIZE = 1
PP_MICRO = 2
SEED = 0
TRAIN = dict(lr=1e-3, warmup_steps=1, total_steps=10)
FLAGS = {
    "features": dict(ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True),
    "dither": dict(ctc_posterior=True, do_psd=True, freeze_llm=True, freeze_encoder=True),
    "text_only": dict(ctc_posterior=True, gt_emb=True, gt_emb_noise=True, do_psd=True,
                      freeze_llm=True, freeze_encoder=True, insert_prob=0.1),
}
FBANK = dict(dither=1.0, specaug=True, specaug_t_masks=2, specaug_t_width=5, specaug_f_masks=2,
             specaug_f_width=10)
MESHES = [({"data": 2}, 2), ({"fsdp": 2}, 2), ({"tensor": 2}, 2), ({"pipe": 2, "data": 2}, 4)]
TOL = dict(atol=1e-5, rtol=1e-5)
MOMENT_TOL = 1e-5       # AdamW's first moments: of each tensor's largest magnitude
CASE_TIMEOUT = 240


# ----------------------------------------------------------------------------
# the inputs (numpy, seeded) and the port's run of a case (any process count)
# ----------------------------------------------------------------------------

def _text(rng, b=4, s=6):
    ids = rng.integers(1, 200, size=(b, s)).astype(np.int64)
    ids[:, 3] = SPEECH
    mask = np.ones((b, s), bool)
    mask[-1, -1] = False
    labels = np.where(mask, ids, -100)
    labels[:, :2] = -100
    return ids, mask, labels


def make_inputs():
    """The global batches of the three cases (4 rows each)."""
    out = {"features": []}
    for k in range(3):
        rng = np.random.default_rng(10 + k)
        ids, mask, labels = _text(rng)
        if k == 1:
            labels[2:, 2:] = -100          # the second block holds fewer labels
        b = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "input_features": rng.normal(size=(4, 16, INPUT)).astype(np.float32),
             "input_feature_length": np.array([16, 11, 14, 6], np.int64)}
        # every batch carries batch_valid (one program a mesh on the JAX side)
        b["batch_valid"] = np.array([True, True, True, k != 2])
        out["features"].append(b)
    rng = np.random.default_rng(20)
    ids, mask, labels = _text(rng)
    lens = np.array([4000, 3100, 3600, 2200], np.int64)
    w = (rng.normal(size=(4, 4000)) * 0.1).astype(np.float32)
    w[np.arange(4000)[None] >= lens[:, None]] = 0.0
    w16 = np.clip(np.rint(w * 32768.0), -32768, 32767).astype(np.int16)
    out["dither"] = [{"input_ids": ids, "attention_mask": mask, "labels": labels,
                      "waveform": w16, "waveform_length": lens}] * 2
    rng = np.random.default_rng(30)
    ids, mask, labels = _text(rng)
    out["text_only"] = [{"input_ids": ids, "attention_mask": mask, "labels": labels,
                         "gt_ids": rng.integers(1, ENC_VOCAB, size=(4, 16)).astype(np.int64),
                         "gt_lens": np.array([16, 11, 4, 13], np.int64)}] * 2
    rng = np.random.default_rng(1)
    out["cmvn"] = ((-(12.0 + rng.normal(size=INPUT))).astype(np.float32),
                   (0.25 + 0.05 * rng.random(size=INPUT)).astype(np.float32))
    return out


def _port_configs(kind):
    from ps_slm_tpu_torch.config import FbankConfig, ModelConfig, TrainConfig

    tc = TrainConfig(**FLAGS[kind], **TRAIN, fsdp_min_size=MIN_SIZE, pp_microbatches=PP_MICRO)
    mc = ModelConfig(encoder_projector="linear-silu", encoder_dim=ENC_VOCAB, llm_dim=LLM_DIM,
                     encoder_config_overrides={"input_size": INPUT})
    return tc, mc, FbankConfig(**FBANK)


def run_port(spec, mesh_shape=None):
    """The port's run of every case on this process's block of the global
    batches: per case the metrics of each step, the trained projector
    (gathered) and whether the frozen weights stayed as they were."""
    from ps_slm_tpu_torch.models import tasu
    from ps_slm_tpu_torch.parallel import mesh as meshlib
    from ps_slm_tpu_torch.training.step import make_train_step

    results = {}
    for kind, source in (("features", None), ("dither", "generator"), ("dither", "fed"),
                         ("text_only", "generator"), ("text_only", "fed")):
        tc, mc, fb = _port_configs(kind)
        model = tasu.model_factory(tc, mc, device="cpu")
        model.load_state_dict(spec["state"])
        model.speech_token_id = SPEECH
        model.fbank_cfg = fb
        model.cmvn = spec["inputs"]["cmvn"]
        frozen = {k: v.clone() for k, v in model.state_dict().items()
                  if not k.startswith("projector.")}
        if mesh_shape:
            tasu.trainable_mask(model, tc)
            mesh = meshlib.build_mesh(mesh_shape, "cpu")
            meshlib.shard_params(model, mesh, mesh_shape, tc.fsdp_min_size, tc.pp_microbatches)
        step = make_train_step(model, tc, device="cpu")
        block = None if model.mesh is None else model.mesh.row_block
        metrics = []
        for i, b in enumerate(spec["inputs"][kind]):
            b = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
            if block is not None:
                n = b["input_ids"].shape[0] // block.count
                b = {k: v[block.index * n:(block.index + 1) * n] for k, v in b.items()}
            draws = spec["draws"][kind][i] if source == "fed" else None
            m = step(b, draws=draws)
            metrics.append([float(m["loss"]), float(m["acc"]), int(m["ntokens"])])
        with meshlib.gathered(model) if model.mesh is not None else _null():
            sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        params = dict(model.named_parameters())
        moments = {}
        for n in step.trainable:
            m = step.optimizer.state[params[n]]["exp_avg"]
            moments[n] = model.mesh.whole(n, m) if model.mesh is not None else m.detach().clone()
        results[f"{kind}/{source}"] = {
            "metrics": metrics,
            "projector": {k: v for k, v in sd.items() if k.startswith("projector.")},
            "moments": moments,
            "frozen_equal": all(torch.equal(sd[k], v) for k, v in frozen.items()),
        }
    return results


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _worker(spec_path, out_dir, mesh_json):
    """One process of a launched case."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from ps_slm_tpu_torch.parallel.mesh import init_distributed

    world, rank = init_distributed("cpu")
    try:
        spec = torch.load(spec_path, weights_only=False)
        out = run_port(spec, json.loads(mesh_json))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _launch(argv, n):
    sys.path.insert(0, ROOT)
    from ps_slm_tpu_torch.parallel.launch import launch

    # two threads a rank: the ranks share the machine with the other test workers
    done = launch(argv, n, env={"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"},
                  timeout=CASE_TIMEOUT, cwd=ROOT)
    for f in done:
        assert f.returncode == 0, f"rank {f.rank} rc {f.returncode}\n{f.stdout[-3000:]}\n" \
                                  f"{f.stderr[-6000:]}"
    return done


# ----------------------------------------------------------------------------
# the JAX side (the parent process only)
# ----------------------------------------------------------------------------

def _jax_models():
    import jax

    from ps_slm_tpu.config import FbankConfig as JaxFbank
    from ps_slm_tpu.config import ModelConfig as JaxModelConfig
    from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
    from ps_slm_tpu.models import tasu as jtasu

    def build(kind):
        jtc = JaxTrainConfig(**FLAGS[kind], **TRAIN)
        jm = jtasu.model_factory(jtc, JaxModelConfig(
            llm_path="", encoder_projector="linear-silu", encoder_dim=ENC_VOCAB,
            llm_dim=LLM_DIM, encoder_config_overrides={"input_size": INPUT}),
            rng=jax.random.PRNGKey(SEED))
        jm.speech_token_id = SPEECH
        jm.fbank_cfg = JaxFbank(**FBANK)
        return jtc, jm

    return build


def _jax_draws(inputs):
    """The JAX step's draws at each step under PRNGKey(SEED) (the step
    folded in), for the global batch (as tests/test_torch_frontend_train.py
    and tests/test_torch_text_only.py compute them)."""
    import jax

    from test_torch_frontend_train import jax_draws as frontend_draws
    from test_torch_text_only import jax_draws as noise_draws

    out = {"features": [None] * len(inputs["features"]), "dither": [], "text_only": []}
    for i, (b, t) in enumerate(zip(inputs["dither"], inputs["text_only"])):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), i)
        out["dither"].append(frontend_draws(
            b["waveform"].astype(np.float32) / 32768.0, b["waveform_length"].astype(np.int32),
            _port_configs("dither")[2], key=jax.random.fold_in(key, 1)))
        out["text_only"].append(noise_draws(key, 4, t["gt_ids"].shape[1],
                                            FLAGS["text_only"]["insert_prob"]))
    return out


def run_jax(inputs, mesh_shape, n):
    import jax
    import jax.numpy as jnp

    from ps_slm_tpu.models import tasu as jtasu
    from ps_slm_tpu.parallel import mesh as jmesh
    from ps_slm_tpu.training import step as jstep
    from ps_slm_tpu.training import train_state as jts
    from ps_slm_tpu_torch import convert

    build = _jax_models()
    mesh = jmesh.build_mesh(mesh_shape, jax.devices()[:n])
    out = {}
    for kind in ("features", "dither", "text_only"):
        jtc, jm = build(kind)
        jm.cmvn = inputs["cmvn"]
        jm.mesh = mesh
        jm.pp_microbatches = PP_MICRO
        jm.params = jmesh.shard_params(jm.params, mesh, MIN_SIZE)
        trainable = jtasu.trainable_mask(jm, jtc)
        tx, _ = jts.build_optimizer(jtc, trainable)
        state = jts.create_train_state(jm.params, tx, trainable)
        step = jstep.make_train_step(jm, tx, trainable)
        metrics = []
        for b in inputs[kind]:
            jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                  for k, v in b.items()}
            state, m = step(state, jmesh.shard_batch(jb, mesh), jax.random.PRNGKey(SEED))
            metrics.append([float(m["loss"]), float(m["acc"]), int(m["ntokens"])])
        proj = convert.projector_state_dict(
            jax.tree_util.tree_map(np.asarray, state.params["projector"]))
        adam = next(s for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
        mu = convert.projector_state_dict(
            jax.tree_util.tree_map(np.asarray, adam.mu["projector"]))
        out[kind] = {"metrics": metrics,
                     "projector": {f"projector.{k}": v for k, v in proj.items()},
                     "moments": {f"projector.{k}": v for k, v in mu.items()}}
    return out


# ----------------------------------------------------------------------------
# fixtures
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    import jax

    from ps_slm_tpu_torch import convert

    d = tmp_path_factory.mktemp("multiprocess")
    inputs = make_inputs()
    _, jm = _jax_models()("features")
    state = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    s = {"state": state, "inputs": inputs, "draws": _jax_draws(inputs)}
    path = str(d / "spec.pt")
    torch.save(s, path)
    return {"path": path, "spec": s, "dir": d, "one": run_port(s)}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **tol, err_msg=what)


def _moments_close(got, want, what):
    """Each trained tensor's first moment within MOMENT_TOL of its largest."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[k], np.float64) - w).max()
        assert err <= MOMENT_TOL * np.abs(w).max(), f"{what} {k}: {err} of {np.abs(w).max()}"


@pytest.mark.parametrize("mesh_shape,n", MESHES, ids=[json.dumps(m) for m, _ in MESHES])
def test_mesh_training_matches_one_process_and_jax(spec, mesh_shape, n):
    import threading

    out = spec["dir"] / ("out_" + "_".join(f"{k}{v}" for k, v in mesh_shape.items()))
    out.mkdir()
    # the ranks run while this process computes the JAX step on the same mesh
    failed = []

    def ranks_run():
        try:
            _launch([sys.executable, __file__, spec["path"], str(out), json.dumps(mesh_shape)], n)
        except BaseException as e:
            failed.append(e)

    th = threading.Thread(target=ranks_run)
    th.start()
    try:
        jax_out = run_jax(spec["spec"]["inputs"], mesh_shape, n)
    finally:
        th.join()
    if failed:
        raise failed[0]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]
    one = spec["one"]
    for key, want in one.items():
        kind, source = key.split("/")
        got = ranks[0][key]
        for r in ranks[1:]:               # every process: the same global metrics, bit for bit
            assert r[key]["metrics"] == got["metrics"], key
        assert all(r[key]["frozen_equal"] for r in ranks), key
        if source == "fed":
            j = jax_out[kind]
            _close([m[:2] for m in got["metrics"]], [m[:2] for m in j["metrics"]], TOL,
                   f"{key} vs JAX")
            assert [m[2] for m in got["metrics"]] == [m[2] for m in j["metrics"]]
            for k, v in j["projector"].items():
                _close(got["projector"][k], v, TOL, f"{key} {k} vs JAX")
            _moments_close(got["moments"], j["moments"], f"{key} moments vs JAX")
            continue
        _close([m[:2] for m in got["metrics"]], [m[:2] for m in want["metrics"]], TOL, key)
        assert [m[2] for m in got["metrics"]] == [m[2] for m in want["metrics"]], key
        for k, v in want["projector"].items():
            _close(got["projector"][k], v, TOL, f"{key} {k}")
        _moments_close(got["moments"], want["moments"], f"{key} moments")
        if kind == "features":
            j = jax_out[kind]
            _close([m[:2] for m in got["metrics"]], [m[:2] for m in j["metrics"]], TOL,
                   f"{key} vs JAX")
            for k, v in j["projector"].items():
                _close(got["projector"][k], v, TOL, f"{key} {k} vs JAX")
            _moments_close(got["moments"], j["moments"], f"{key} moments vs JAX")
    # the ragged batch: the processes' blocks hold different label counts
    feats = spec["spec"]["inputs"]["features"][1]["labels"]
    assert (feats[:2, 1:] != -100).sum() != (feats[2:, 1:] != -100).sum()


# ----------------------------------------------------------------------------
# the finetune CLI in 2 processes
# ----------------------------------------------------------------------------

CLI = ("import sys; from ps_slm_tpu_torch.cli import finetune; "
       "raise SystemExit(finetune.main(sys.argv[1:], device='cpu'))")


@pytest.fixture(scope="module")
def cli_one(fixtures, tmp_path_factory):
    """The one-process CLI on tests/test_torch_finetune.py's manifest."""
    from ps_slm_tpu_torch.cli import finetune

    out = str(tmp_path_factory.mktemp("cli") / "one")
    assert finetune.main(_args(fixtures, out) + ["++train_config.save_last=true"],
                         device="cpu") == 0
    return fixtures, out


def _state_bytes(path):
    """The bytes of the tensors of a train-state file's model, AdamW state
    and accumulation (a tensor another rank's file holds counts 0)."""
    blob = torch.load(path, weights_only=True)
    accum = blob["train"]["accum"]
    acc = accum["acc"] or []
    tensors = (list(blob["model"].values()) + list(acc.values() if isinstance(acc, dict) else acc)
               + [v for st in accum["optimizer"]["state"].values() for v in st.values()])
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t) and t.dim() > 0)


@pytest.mark.parametrize("mesh_shape", [{"data": 2}, {"fsdp": 2}, {"pipe": 2}],
                         ids=["data2", "fsdp2", "pipe2"])
def test_finetune_cli_two_processes(cli_one, mesh_shape, tmp_path):
    data, one = cli_one
    out = str(tmp_path / "two")
    mesh = ["++train_config.mesh_shape=" + json.dumps(mesh_shape),
            "++train_config.fsdp_min_size=1", "++train_config.save_last=true"]
    _launch([sys.executable, "-c", CLI] + _args(data, out) + mesh, 2)
    want, want_eval = _metrics(one)
    got, got_eval = _metrics(out)
    assert sorted(got) == sorted(want)
    for s in want:
        _close(got[s], want[s], TOL, f"step {s}")
    assert sorted(got_eval) == sorted(want_eval)
    _close([got_eval[s] for s in sorted(got_eval)], [want_eval[s] for s in sorted(want_eval)],
           TOL, "eval")
    assert _steps(out) == _steps(one)
    for tag in _steps(one) + ["last"]:
        a = torch.load(f"{one}/{tag}/pytorch_model.bin", weights_only=True)
        b = torch.load(f"{out}/{tag}/pytorch_model.bin", weights_only=True)
        assert sorted(a) == sorted(b)
        for k in a:
            _close(b[k].numpy(), a[k].numpy(), TOL, f"{tag} {k}")
        assert sorted(os.listdir(f"{out}/{tag}/state")) == [
            "train_state.rank0.pt", "train_state.rank1.pt"]
        # each shard and each replicated tensor in one rank's file
        assert sum(_state_bytes(f"{out}/{tag}/state/train_state.rank{r}.pt")
                   for r in range(2)) == _state_bytes(f"{one}/{tag}/state/train_state.pt"), tag
    with open(f"{out}/log.txt") as f:
        assert "exported the reference checkpoint" in f.read()
    with open(f"{out}/log.txt.rank1") as f:
        assert "exported the reference checkpoint" not in f.read()
    # resume from the first checkpoint: the rest of the run bit for bit
    first = _steps(out)[0]
    res = str(tmp_path / "resumed")
    _launch([sys.executable, "-c", CLI] + _args(data, res) + mesh
            + [f"++train_config.resume_from={out}/{first}/state"], 2)
    again, _ = _metrics(res)
    assert sorted(again) == [s for s in sorted(got) if s > int(first[len("step_"):])]
    assert all(again[s] == got[s] for s in again)
    a = torch.load(f"{out}/last/pytorch_model.bin", weights_only=True)
    b = torch.load(f"{res}/last/pytorch_model.bin", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)


if __name__ == "__main__":
    _worker(*sys.argv[1:4])
