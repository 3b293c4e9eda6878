"""PyTorch port: the training CLI, loop, train-state checkpoints, resume,
gradient accumulation, remat and prefetch, against the JAX package (CPU,
fp32, plain versions of the kernels), at ``tests/test_cli.py``'s sizes.

* Loop parity: the JAX ``training.loop.train`` (its CLI's wiring on one
  device) and the port's ``cli.finetune.main`` train the same weights (the
  JAX random init handed over as a full reference checkpoint) on the same
  manifest for 2 epochs with validation every 2 steps and dither 0.  Per-step
  loss and accuracy, eval losses, the set of ``step_N`` checkpoints and
  their exported projectors agree within LOSS_TOL / WEIGHT_TOL.
* Resume: interrupted-and-resumed training equals straight training bit
  for bit (parameters, AdamW and accumulation state, the generator, the
  per-step losses) in the loop's three fast-forward cases and in the middle
  of an accumulation window; the dither and SpecAugment draws come from the
  step's generator, so its saved state is what makes this hold.
* Gradient accumulation against ``optax.MultiSteps``; remat against the
  port without it (bit-identical) and the JAX step with ``remat=True``.
* The CLI: both recipes' argv parse to the JAX package's values; a closed
  loop trains on ``scripts/decode.sh``'s asset layout, then the JAX and the
  port decode CLIs read the port's export and write byte-identical files.

Tolerances (fp32, the packages sum in different orders): losses and
accuracies 1e-4; projector weights atol 1e-4 (AdamW's g / (|g| + eps)
scales a gradient's rounding up where |g| is near eps, as
tests/test_torch_train.py states); accumulation 1e-6; the JAX remat step
as test_torch_train.py's gradients (1e-4).
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ps_slm_tpu.config import RunConfig as JaxRunConfig
from ps_slm_tpu.config import parse_cli as jax_parse_cli
from ps_slm_tpu.data import audio_io as jaudio
from ps_slm_tpu.models.tasu import model_factory as jax_model_factory
from ps_slm_tpu.training.checkpoint import export_reference_checkpoint as jax_export
from ps_slm_tpu_torch import config as pconfig
from ps_slm_tpu_torch.cli import finetune
from ps_slm_tpu_torch.config import LogConfig, ModelConfig, TrainConfig
from ps_slm_tpu_torch.data.prefetch import device_prefetch, prefetch
from ps_slm_tpu_torch.models import tasu
from ps_slm_tpu_torch.training import checkpoint as ckpt
from ps_slm_tpu_torch.training.loop import train
from ps_slm_tpu_torch.training.step import make_train_step
from ps_slm_tpu_torch.training.train_state import MultiSteps, warmup_cosine

LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------------------------
# fixtures: tests/test_cli.py's manifest (8 utterances of 0.5-1 s)
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("finetune")
    rng = np.random.default_rng(0)
    rate = 16000
    entries = {f"utt{i}": (rate, rng.normal(size=int(rng.integers(rate // 2, rate))).astype(
        np.float32) * 0.1) for i in range(8)}
    offsets = jaudio.write_kaldi_wav_ark(str(d / "wav.ark"), entries)
    for split in ("train", "dev", "test"):
        (d / split).mkdir()
        with open(d / split / "multitask.jsonl", "w") as f:
            for i in range(8):
                f.write(json.dumps({"key": f"utt{i}", "path": f"{d / 'wav.ark'}:{offsets[f'utt{i}']}",
                                    "target": f"word{i} hello", "GT": f"word{i} hello",
                                    "task": "ASR"}) + "\n")
    (d / "multiprompt.jsonl").write_text(json.dumps({"task": "ASR", "prompt": "transcribe:"}) + "\n")
    return d


def _args(d, out):
    """tests/test_cli.py's overrides with fixed batches of 4 (one shape a
    split, so the JAX side compiles its step once) and dither 0."""
    return [
        "++model_config.llm_path=",
        "++model_config.encoder_projector=linear-silu",
        "++model_config.encoder_dim=11",
        "++model_config.llm_dim=64",
        '++model_config.encoder_config_overrides={"input_size": 560}',
        "++train_config.ctc_posterior=true",
        "++train_config.do_psd=true",
        "++train_config.freeze_llm=true",
        "++train_config.freeze_encoder=true",
        "++train_config.mixed_precision=false",
        "++train_config.batching_strategy=padding",
        "++train_config.batch_size_training=4",
        "++train_config.val_batch_size=8",
        "++train_config.num_epochs=2",
        "++train_config.validation_interval=2",
        "++train_config.lr=1e-2",
        "++train_config.warmup_steps=1",
        "++train_config.total_steps=20",
        f"++train_config.output_dir={out}",
        "++dataset_config.fbank.dither=0.0",
        f"++dataset_config.multitask_prompt_path={d}/multiprompt.jsonl",
        f"++dataset_config.train_scp_file_path={d}/train",
        f"++dataset_config.dev_scp_file_path={d}/dev",
        "++dataset_config.feature_bucket=32",
        "++dataset_config.token_bucket=16",
        f"++log_config.log_file={out}/log.txt",
        "++log_config.log_interval=1",
    ]


def _jax_train(args, out):
    """The JAX CLI's training wiring (cli/finetune.py) on one CPU device,
    checkpoints exported as the CLI exports them (projector only)."""
    from ps_slm_tpu.data.tokenizer import load_tokenizer
    from ps_slm_tpu.models.tasu import trainable_mask
    from ps_slm_tpu.parallel.mesh import build_mesh
    from ps_slm_tpu.registry import get_dataset_factory
    from ps_slm_tpu.training.loop import train as jax_loop
    from ps_slm_tpu.training.train_state import build_optimizer, create_train_state
    from ps_slm_tpu.utils.logging import MetricLogger as JaxMetricLogger

    cfg = jax_parse_cli(args, JaxRunConfig())
    tc, mc, dc, lc = cfg.train_config, cfg.model_config, cfg.dataset_config, cfg.log_config
    os.makedirs(out, exist_ok=True)
    tok = load_tokenizer(None)
    model = jax_model_factory(tc, mc, rng=jax.random.PRNGKey(tc.seed))
    model.speech_token_id, model.pad_token_id = tok.speech_token_id, tok.pad_token_id
    model.fbank_cfg = dc.fbank
    jax_export(model, f"{out}/init.bin")
    trainable = trainable_mask(model, tc)
    tx, _ = build_optimizer(tc, trainable)
    state = create_train_state(model.params, tx, trainable)
    factory = get_dataset_factory(dc.factory)

    def train_batches(epoch, skip_batches=0):
        return iter(factory(dc, tok, "train", fixed_batch_size=tc.batch_size_training,
                            seed=tc.seed + epoch, skip_batches=skip_batches))

    def eval_batches():
        return iter(factory(dc, tok, "val", fixed_batch_size=tc.val_batch_size))

    def checkpoint_fn(state, tag):
        os.makedirs(f"{out}/{tag}")
        model.params = state.params
        jax_export(model, f"{out}/{tag}/pytorch_model.bin", exclude=("llm", "encoder"))

    metrics = JaxMetricLogger(lc)
    try:
        jax_loop(model, state, tx, tc, lc, train_batches, eval_batches,
                 build_mesh({"data": 1}, devices=[jax.devices()[0]]), trainable=trainable,
                 metric_logger=metrics, checkpoint_fn=checkpoint_fn)
    finally:
        metrics.close()
    return f"{out}/init.bin"


def _metrics(out):
    """(per-step (loss, acc), eval losses by step) from a run's metrics.jsonl."""
    train_m, eval_m = {}, {}
    with open(f"{out}/metrics.jsonl") as f:
        for rec in map(json.loads, f):
            if "train/loss" in rec:
                train_m[rec["step"]] = (rec["train/loss"], rec["train/acc"])
            if "eval_loss" in rec:
                eval_m[rec["step"]] = rec["eval_loss"]
    return train_m, eval_m


def _steps(out):
    return sorted(p for p in os.listdir(out) if p.startswith("step_"))


@pytest.fixture(scope="module")
def parity_runs(fixtures, tmp_path_factory):
    """The JAX loop and the port's CLI on the same weights and manifest."""
    root = tmp_path_factory.mktemp("parity")
    jout, pout = str(root / "jax"), str(root / "port")
    init = _jax_train(_args(fixtures, jout), jout)
    t0 = time.perf_counter()
    assert finetune.main(_args(fixtures, pout) + [f"ckpt_path={init}", "++train_config.save_last=true"],
                         device="cpu") == 0
    return jout, pout, time.perf_counter() - t0


def test_loop_parity_with_jax(parity_runs):
    jout, pout, _ = parity_runs
    jtrain, jeval = _metrics(jout)
    ptrain, peval = _metrics(pout)
    assert sorted(ptrain) == sorted(jtrain) == [1, 2, 3, 4]
    for s in jtrain:
        np.testing.assert_allclose(ptrain[s], jtrain[s], **LOSS_TOL, err_msg=f"step {s}")
    assert sorted(peval) == sorted(jeval) == [2, 4]
    np.testing.assert_allclose([peval[s] for s in (2, 4)], [jeval[s] for s in (2, 4)], **LOSS_TOL)
    assert ptrain[4][0] < ptrain[1][0]              # it learned
    assert _steps(pout) == _steps(jout) and _steps(pout)
    for tag in _steps(pout):
        want = torch.load(f"{jout}/{tag}/pytorch_model.bin", weights_only=False)
        got = torch.load(f"{pout}/{tag}/pytorch_model.bin", weights_only=True)
        assert sorted(got) == sorted(want)
        assert all(k.startswith("encoder_projector.") for k in got)   # frozen llm + encoder left out
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **WEIGHT_TOL, err_msg=k)


def test_cli_writes_the_run_files(parity_runs):
    _, pout, secs = parity_runs
    with open(f"{pout}/resolved_config.json") as f:
        resolved = json.load(f)
    assert resolved["train_config"]["validation_interval"] == 2
    assert resolved["dataset_config"]["fbank"]["dither"] == 0.0
    assert os.path.exists(f"{pout}/metrics.jsonl")
    for tag in _steps(pout) + ["last"]:
        assert os.path.exists(f"{pout}/{tag}/pytorch_model.bin")
        assert os.path.exists(f"{pout}/{tag}/state/{ckpt.TRAIN_STATE_FILE}")
    with open(f"{pout}/log.txt") as f:
        log = f.read()
    assert "module projector" in log and "trainable" in log and "epoch 1:" in log
    assert secs < 60


def test_cli_resume_reproduces_the_straight_run(parity_runs, fixtures, tmp_path):
    """``resume_from`` a mid-run checkpoint: the CLI's GlobalBatcher skips
    the trained batches (marker batches, no audio decoded) and the run ends
    where the straight one ended, bit for bit."""
    _, pout, _ = parity_runs
    first = _steps(pout)[0]
    out = str(tmp_path / "resumed")
    args = _args(fixtures, out) + [f"++train_config.resume_from={pout}/{first}/state",
                                   "++train_config.save_last=true"]
    assert finetune.main(args, device="cpu") == 0
    with open(f"{out}/log.txt") as f:
        assert f"resume fast-forward: skipping {first[len('step_'):]} trained batches" in f.read()
    want, _ = _metrics(pout)
    got, _ = _metrics(out)
    assert sorted(got) == [s for s in sorted(want) if s > int(first[len("step_"):])]
    assert all(got[s] == want[s] for s in got)
    a = torch.load(f"{pout}/last/pytorch_model.bin", weights_only=True)
    b = torch.load(f"{out}/last/pytorch_model.bin", weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)


# ----------------------------------------------------------------------------
# the recipes' argv, and what is not ported
# ----------------------------------------------------------------------------

def _recipe_argv(name, root):
    """The overrides of ``scripts/<name>.sh`` with its variables set."""
    env = {"LLM": f"{root}/llm", "ENCODER": f"{root}/enc", "DATA": f"{root}/data",
           "INIT": f"{root}/init.bin", "OUT": f"{root}/out"}
    return chip_smoke.recipe_args(name, env)


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k.endswith("config") or k == "fbank":
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("recipe", ["finetune_text_only", "finetune_half_audio"])
def test_recipe_argv_parses_as_in_jax(recipe, tmp_path):
    from ps_slm_tpu import config as jconfig

    argv = _recipe_argv(recipe, tmp_path)
    assert len(argv) >= 25
    port = _flat(pconfig.to_dict(pconfig.parse_cli(argv)))
    want = _flat(jconfig.to_dict(jax_parse_cli(argv, JaxRunConfig())))
    for arg in argv:
        key = arg.split("=", 1)[0].lstrip("+")
        assert key in port, key
    common = sorted(set(port) & set(want))
    assert len(common) > 100
    assert {k: port[k] for k in common} == {k: want[k] for k in common}
    assert port["train_config.num_epochs"] == 3 and port["train_config.output_dir"] == f"{tmp_path}/out"


# ----------------------------------------------------------------------------
# resume: interrupted and resumed equals straight, bit for bit
# ----------------------------------------------------------------------------

BATCH, TEXT_LEN, STEPS_PER_EPOCH, SAMPLES = 2, 8, 3, 4000
RESUME_FBANK = dict(dither=1.0, specaug=True, specaug_t_width=2, specaug_f_width=20)


def _resume_configs(num_epochs, accum=1):
    tc = TrainConfig(ctc_posterior=True, do_psd=False, freeze_llm=False, freeze_encoder=True,
                     mixed_precision=False, num_epochs=num_epochs, lr=1e-3, warmup_steps=2,
                     total_steps=50, run_validation=False, save_model=False, seed=3,
                     gradient_accumulation_steps=accum, weight_decay=0.01)
    mc = ModelConfig(encoder_dim=11, llm_dim=64, encoder_config_overrides={"input_size": 560})
    return tc, mc


def _batches(epoch, limit=None):
    """A deterministic waveform stream (the front end dithers and masks
    from the step's generator)."""
    rng = np.random.default_rng(100 + epoch)
    for i in range(STEPS_PER_EPOCH if limit is None else limit):
        ids = rng.integers(1, 200, size=(BATCH, TEXT_LEN)).astype(np.int32)
        ids[:, 2] = 250
        labels = ids.copy()
        labels[:, :3] = -100
        yield {"input_ids": ids, "attention_mask": np.ones(ids.shape, bool), "labels": labels,
               "waveform": (rng.normal(size=(BATCH, SAMPLES)) * 3000).astype(np.int16),
               "waveform_length": np.asarray([SAMPLES, SAMPLES - 700], np.int32)}


def _markers(epoch, skip_batches=0):
    """A skip-capable source yielding marker batches, as GlobalBatcher."""
    for i, b in enumerate(_batches(epoch)):
        yield {"batch_skipped": True} if i < skip_batches else b


def _internal(epoch, skip_batches=0):
    """A skip-capable source that skips internally."""
    it = _batches(epoch)
    for _ in range(skip_batches):
        next(it, None)
    return it


class _Losses:
    def __init__(self):
        self.losses = {}

    def log(self, metrics, step=None):
        if "train/loss" in metrics:
            self.losses[step] = metrics["train/loss"]


def _run(tc, mc, source, state_dir=None):
    model = tasu.model_factory(tc, mc, device="cpu")
    model.speech_token_id = 250
    model.fbank_cfg = pconfig.FbankConfig(**RESUME_FBANK)
    step = make_train_step(model, tc, device="cpu")
    if state_dir:
        ckpt.restore_train_state(state_dir, step)
    sink = _Losses()
    train(model, step, tc, LogConfig(log_interval=1), source, None, metric_logger=sink,
          logger=_Quiet())
    return step, sink.losses


class _Quiet:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def _assert_same_state(a, b):
    for (na, pa), (nb, pb) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] and torch.equal(sa["generator"], sb["generator"])
    oa, ob = sa["accum"], sb["accum"]
    assert (oa["mini_step"], oa["gradient_step"]) == (ob["mini_step"], ob["gradient_step"])
    for i, st in oa["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["optimizer"]["state"][i][k]), (i, k)


@pytest.mark.parametrize("case", ["markers", "plain", "internal", "accumulating"])
def test_resume_mid_epoch_bit_equal(case, tmp_path):
    """Interrupted after 4 micro-steps (epoch 1's first batch), saved,
    restored, resumed: the same parameters, optimizer, accumulation,
    generator and losses as the straight run.  ``accumulating`` stops at
    micro-step 3 with k = 2, inside an accumulation window."""
    accum = 2 if case == "accumulating" else 1
    stop = 3 if case == "accumulating" else STEPS_PER_EPOCH + 1
    src = {"markers": _markers, "plain": lambda e: _batches(e), "internal": _internal,
           "accumulating": _markers}[case]
    tc, mc = _resume_configs(2, accum)
    straight, want = _run(tc, mc, src)
    assert straight.step == 2 * STEPS_PER_EPOCH

    def cut(epoch):   # the interrupted run's stream: it ends after `stop` batches
        return _batches(epoch, limit=max(min(stop - epoch * STEPS_PER_EPOCH, STEPS_PER_EPOCH), 0))

    mid, first = _run(tc, mc, cut)
    assert mid.step == stop and (mid.accum.mini_step == 1) == (case == "accumulating")
    nbytes = ckpt.save_train_state(str(tmp_path / "state"), mid)
    assert nbytes > 0
    resumed, rest = _run(tc, mc, src, str(tmp_path / "state"))
    _assert_same_state(straight, resumed)
    assert {**first, **rest} == want


def test_resume_skips_whole_epochs(tmp_path):
    """A checkpoint at an epoch boundary fast-forwards the whole epoch
    without running it; resuming a finished run is a no-op."""
    tc1, mc = _resume_configs(1)
    mid, _ = _run(tc1, mc, _markers)
    ckpt.save_train_state(str(tmp_path / "state"), mid)
    done, losses = _run(tc1, mc, _markers, str(tmp_path / "state"))
    assert losses == {} and done.step == STEPS_PER_EPOCH
    _assert_same_state(mid, done)
    tc2, _ = _resume_configs(2)
    straight, want = _run(tc2, mc, _markers)
    resumed, rest = _run(tc2, mc, _markers, str(tmp_path / "state"))
    assert sorted(rest) == [4, 5, 6] and all(rest[s] == want[s] for s in rest)
    _assert_same_state(straight, resumed)


def test_train_state_round_trip(tmp_path):
    """save/restore: every parameter, AdamW's moments and step, the
    generator; read back with ``weights_only=True``."""
    tc, mc = _resume_configs(1)
    a, _ = _run(tc, mc, _markers)
    ckpt.save_train_state(str(tmp_path / "s"), a)
    blob = torch.load(tmp_path / "s" / ckpt.TRAIN_STATE_FILE, weights_only=True)
    assert set(blob) == {"model", "train"} and blob["train"]["step"] == STEPS_PER_EPOCH
    model = tasu.model_factory(dataclasses.replace(tc, seed=9), mc, device="cpu")
    b = make_train_step(model, tc, device="cpu")
    assert not torch.equal(b.generator.get_state(), a.generator.get_state())
    ckpt.restore_train_state(str(tmp_path / "s"), b)
    _assert_same_state(a, b)


# ----------------------------------------------------------------------------
# gradient accumulation against optax.MultiSteps
# ----------------------------------------------------------------------------

def test_gradient_accumulation_equals_optax_multisteps():
    """k = 2 over 4 micro-steps of given gradients: the parameters of
    ``optax.MultiSteps(adamw)`` within 1e-6, still on every odd micro-step,
    and the learning rate read at the applied-update count."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(4)]
    lr, warmup, total, k = 1e-2, 1, 10, 2

    sched = optax.warmup_cosine_decay_schedule(0.0, lr, 1, total, lr * 1e-4)
    tx = optax.MultiSteps(optax.adamw(sched, 0.9, 0.999, 1e-6, weight_decay=0.1),
                          every_k_schedule=k)
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.1)
    lrs = []
    acc = MultiSteps(opt, lambda n: lrs.append(n) or warmup_cosine(lr, warmup, total)(n), k)
    for i, g in enumerate(grads):
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        before = [p.detach().clone() for p in params]
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        moved = acc.step()
        assert moved == (i % k == k - 1)
        if not moved:
            assert all(torch.equal(a, p) for a, p in zip(before, params))
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert lrs == [0, 1] and acc.gradient_step == 2 == int(jstate.gradient_step)
    assert warmup_cosine(lr, warmup, total)(1) == pytest.approx(float(sched(1)))
    assert warmup_cosine(lr, warmup, total)(1) != pytest.approx(float(sched(3)))


# ----------------------------------------------------------------------------
# remat
# ----------------------------------------------------------------------------

def test_remat_bit_identical_and_equal_to_jax_remat():
    """A training step with remat on and off: the same loss and projector
    gradients bit for bit on the CPU (the LLM trains, so its blocks are
    recomputed); the JAX step with ``remat=True`` on the same weights
    within 1e-4."""
    from ps_slm_tpu.config import ModelConfig as JaxModelConfig
    from ps_slm_tpu.config import TrainConfig as JaxTrainConfig
    from ps_slm_tpu.models import tasu as jtasu
    from ps_slm_tpu_torch import convert

    flags = dict(ctc_posterior=True, do_psd=True, freeze_encoder=True)
    jm = jtasu.model_factory(JaxTrainConfig(remat=True, **flags), JaxModelConfig(
        encoder_dim=11, llm_dim=64), rng=jax.random.PRNGKey(0))
    jm.speech_token_id = 250
    assert jm.remat
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 200, size=(3, 6)).astype(np.int32)
    ids[:, 3] = 250
    labels = ids.copy()
    labels[:, :2] = -100
    batch = {"input_ids": ids, "attention_mask": np.ones(ids.shape, bool), "labels": labels,
             "input_features": rng.normal(size=(3, 16, 24)).astype(np.float32),
             "input_feature_length": np.asarray([16, 11, 5], np.int32)}

    def jax_loss(proj):
        params = dict(jm.params, projector=proj)
        return jtasu.forward(jm, params, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0))[0]

    jloss, jgrad = jax.value_and_grad(jax_loss)(jm.params["projector"])
    jflat = convert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, dict(jm.params, projector=jgrad)))

    out = {}
    for remat in (False, True):
        pm = tasu.model_factory(TrainConfig(remat=remat, **flags),
                                ModelConfig(encoder_dim=11, llm_dim=64), device="cpu")
        pm.load_state_dict(convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params)))
        pm.speech_token_id = 250
        assert pm.remat == remat and pm.llm.remat == pm.encoder.remat == remat
        tasu.trainable_mask(pm, TrainConfig(**flags))
        loss, _ = tasu.forward(pm, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad.clone() for n, p in pm.named_parameters()
                                      if n.startswith("projector.")})
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(out[False][1][n], g) for n, g in out[True][1].items())
    np.testing.assert_allclose(float(out[True][0]), float(jloss), rtol=1e-5, atol=1e-5)
    for name, g in out[True][1].items():
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=1e-4, atol=1e-4, err_msg=name)


# ----------------------------------------------------------------------------
# closed loop: train on scripts/decode.sh's layout, decode with both CLIs
# ----------------------------------------------------------------------------

def test_closed_loop_train_decode_both_clis(tmp_path):
    """The port's finetune CLI on the recipe's asset layout (HF dir with a
    byte-level tokenizer, funasr dir with am.mvn, a train and a dev
    manifest); then the JAX and the port decode CLIs read its export and
    write byte-identical ``_pred`` and ``_gt`` files; the port's WER runs."""
    from ps_slm_tpu.cli import decode as jdecode
    from ps_slm_tpu_torch.cli import decode
    from ps_slm_tpu_torch.tools import clean_marks, wer

    root = str(tmp_path)
    src = tasu.model_factory(TrainConfig(ctc_posterior=True, do_psd=True, seed=3),
                             ModelConfig(llm_dim=64, encoder_dim=11,
                                         llm_config_overrides=dict(vocab_size=300),
                                         encoder_config_overrides=dict(input_size=560)),
                             device="cpu")
    specials = {"<|endoftext|>": 256, "<|im_start|>": 257, "<|im_end|>": 258}
    assets = chip_smoke.write_assets(root, src, llm_dtype=torch.float32,
                                     specials=specials, utts={"ark": 3, "wav": 1, "flac": 0},
                                     seconds=(0.5, 1.0))
    for split, seed in (("train", 1), ("dev", 2)):
        chip_smoke.write_manifest(f"{root}/{split}", {"ark": 4, "wav": 0, "flac": 0},
                                  (0.5, 1.0), seed)
    out = f"{root}/out"
    args = chip_smoke.finetune_args(assets, root, out, llm_dim=64, encoder_dim=11) + [
        "++train_config.mixed_precision=false", "++train_config.num_epochs=1",
        "++train_config.validation_interval=1", "++train_config.lr=1e-2",
        "++train_config.warmup_steps=1", "++dataset_config.train_max_frame_length=30",
        "++dataset_config.feature_bucket=16", "++dataset_config.token_bucket=8"]
    assert finetune.main(args, device="cpu") == 0
    export = f"{out}/{_steps(out)[-1]}/pytorch_model.bin"
    assert all(k.startswith("encoder_projector.") for k in torch.load(export, weights_only=True))

    dec = chip_smoke.decode_args(assets, "unused", 6, llm_dim=64, encoder_dim=11)
    dec = [a for a in dec if not a.startswith(("decode_log=", "ckpt_path=", "++log_config"))]
    dec += ["++train_config.mixed_precision=false", "++train_config.num_beams=2",
            "++dataset_config.eval_max_frame_length=300", "++dataset_config.feature_bucket=16",
            "++dataset_config.token_bucket=8", f"ckpt_path={export}",
            f"++log_config.log_file={root}/dec.log"]
    assert jdecode.main(dec + [f"decode_log={root}/jax/test"]) == 0
    assert decode.main(dec + [f"decode_log={root}/port/test"], device="cpu") == 0
    for suffix in ("_pred", "_gt"):
        with open(f"{root}/jax/test{suffix}", "rb") as f, open(f"{root}/port/test{suffix}", "rb") as g:
            assert f.read() == g.read()
    for path in (f"{root}/port/test_pred", f"{root}/port/test_gt"):
        clean_marks.clean_file(path)
    with open(os.devnull, "w") as null:
        score = wer.score_files(f"{root}/port/test_gt", f"{root}/port/test_pred", stream=null)
    assert score["all"] > 0 and score["wer"] >= 0


# ----------------------------------------------------------------------------
# prefetch (tests/test_prefetch.py's cases, and the device placement)
# ----------------------------------------------------------------------------

def test_prefetch_order_preserved():
    assert list(prefetch(range(50), depth=4)) == list(range(50))


def test_prefetch_empty():
    assert list(prefetch([], depth=2)) == []
    assert list(device_prefetch([], "cpu", dict)) == []


def test_prefetch_exception_propagates():
    def gen():
        yield {"x": np.zeros(2)}
        raise ValueError("boom")

    it = device_prefetch(gen(), "cpu", dict, depth=2)
    host, dev = next(it)
    assert torch.equal(dev["x"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_prefetch_overlap():
    """Producer sleeps overlap with consumer sleeps."""
    def slow():
        for i in range(5):
            time.sleep(0.05)
            yield {"i": np.asarray([i]), "key": f"k{i}"}

    t0 = time.perf_counter()
    seen = []
    for host, dev in device_prefetch(slow(), "cpu", lambda b: {"i": b["i"]}, depth=2):
        time.sleep(0.05)
        seen.append((host["key"], int(dev["i"])))
    assert time.perf_counter() - t0 < 0.45   # serial would be ~0.5 s
    assert seen == [(f"k{i}", i) for i in range(5)]
