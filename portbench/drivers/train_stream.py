"""Training cells: the recipe's ``TrainStep`` fed by ``device_prefetch``
over the port's dataset stream, as ``training/loop.py::train`` feeds it
(metrics read at each ``log_interval``), epoch after epoch.

Set-up builds the step and drives it through the stream's first
``compared_steps`` batches with the front end's dither drawn by the
benchmark (``TrainStep(..., draws=...)``); the same object then runs the
window.  The reference follows those first steps: each step's loss, the
first step's gradient by leaf (read back from AdamW's first moment), and
each leaf's change over the steps.

``train_tokens_per_s``: label tokens (targets and their EOS, in rows that
hold data) of every step in the window, over the window, which ends at a
synchronize after its last step.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np

from portbench import assets, feed, harness, traffic, weights
from portbench.harness import Check, Run, span


def _label_tokens(host: Dict) -> int:
    labels = np.asarray(host["labels"]) != -100
    valid = np.asarray(host.get("batch_valid", np.ones(labels.shape[0], bool)))
    return int(labels[valid].sum())


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> float:
    """The worst leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    leaves = list(leaves if leaves is not None else ref)
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def run(r: Run) -> None:
    import torch

    from ps_slm_tpu_torch.data.dataset import get_speech_dataset
    from ps_slm_tpu_torch.data.prefetch import device_prefetch
    from ps_slm_tpu_torch.data.spm import SenseVoiceTokenizer
    from ps_slm_tpu_torch.data.tokenizer import load_tokenizer
    from ps_slm_tpu_torch.ops.fbank import FrontendDraws
    from ps_slm_tpu_torch.ops.pseudo_posterior import NoiseDraws
    from ps_slm_tpu_torch.training.loop import device_fields
    from ps_slm_tpu_torch.training.step import make_train_step

    dev = torch.device(r.device)
    if dev.type == "cuda":
        from ps_slm_tpu_torch import _build

        _build.build_all()
    cfg, mix, recipe = r.cfg, r.mix, r.recipe
    utts = traffic.utterances(mix, r.seed, dev)
    if r.control:
        return _control(r, utts)
    paths = feed.write(r.workdir, cfg, utts, "train")
    cmvn = weights.cmvn(cfg, r.seed, dev)
    w = weights.make(cfg, r.seed, dev)
    model, tc, dc = harness.build_tasu(cfg, recipe, r.seed, w, cmvn, dev)
    del w
    tokenizer = load_tokenizer(paths["tokenizer"])
    enc_tok = SenseVoiceTokenizer(paths["encoder"])
    model.speech_token_id, model.pad_token_id = tokenizer.speech_token_id, tokenizer.pad_token_id
    dc.train_scp_file_path = paths["data"]
    dc.multitask_prompt_path = feed.PROMPTS
    dc.train_max_frame_length = mix["batch_budget"]
    state = make_train_step(model, tc, device=dev)

    def epochs():
        epoch = 0
        while True:
            yield from get_speech_dataset(dc, tokenizer, "train", encoder_tokenizer=enc_tok,
                                          seed=tc.seed + epoch)
            epoch += 1

    stream = device_prefetch(epochs(), dev, device_fields, depth=2)

    # the compared steps, through the window's own call and feed
    params = {n.split(".", 1)[1]: p for n, p in model.named_parameters()
              if n in state.trainable and n.startswith("projector.")}
    if len(params) != len(state.trainable):
        raise RuntimeError(f"the recipe trains more than the projector: {state.trainable}")
    start = {n: p.detach().float().clone() for n, p in params.items()}
    draw = torch.Generator(device=dev).manual_seed((r.seed * 7919 + 17) % (2 ** 63))
    frame_len = 400
    compared, losses = [], []
    for i in range(mix["compared_steps"]):
        host, dbatch = next(stream)
        if tc.gt_emb:
            b, g = dbatch["gt_ids"].shape
            alpha = (torch.rand((b, 1, 1), generator=draw, device=dev)
                     * (tc.smooth_high - tc.smooth_low) + tc.smooth_low)
            u_drop = torch.rand((b, g), generator=draw, device=dev)
            draws, kept = NoiseDraws(alpha, u_drop), (alpha.cpu(), u_drop.cpu())
        else:
            b, n = dbatch["waveform"].shape
            frames = max(1 + (n - frame_len) // 160, 0)
            noise = torch.randn((b, frames, frame_len), generator=draw, device=dev)
            draws, kept = FrontendDraws(dither=noise), noise.cpu()
        losses.append(state(dbatch, draws=draws)["loss"])
        if i == 0:
            b1 = tc.adam_beta1
            # the first gradient as AdamW holds it (none: no step was taken)
            grad = {n: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    .float() / (1 - b1) for n, p in params.items()}
        compared.append((host, kept))
    change = {n: float((p.detach().float() - start[n]).norm()) for n, p in params.items()}
    losses = [float(v) for v in losses]
    del start
    for _ in range(mix.get("warmup_steps", 0)):
        state(next(stream)[1])
    r.setup_done()

    # the window
    seconds = min(r.seconds, mix["trace_seconds"]) if r.trace else r.seconds
    tokens = steps = 0
    wait = 0.0
    records: List[Dict] = []
    pending = []
    with harness.traced(r), span("window"):
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            with span("train.data_wait"):
                tw = time.perf_counter()
                host, dbatch = next(stream)
                wait += time.perf_counter() - tw
            with span("train.step"):
                pending.append(state(dbatch))
            steps += 1
            tokens += _label_tokens(host)
            if r.trace:
                records.append(_record(host))
            if steps % mix["log_interval"] == 0:
                with span("train.log"):
                    for m in pending:
                        float(m["loss"])
                    pending = []
            if time.perf_counter() >= deadline:
                break
        with span("train.sync"):
            harness.sync(dev)
        t_end = time.perf_counter()
    window = t_end - t_start
    r.e2e["train_tokens_per_s"] = tokens / window
    r.attempted = steps
    r.mem_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    r.facts.update(window_s=window, data_wait_s=wait, tokens=tokens, encoder=not tc.gt_emb)
    del state, model, stream, pending, params
    harness.free(dev)

    _compare(r, utts, compared, losses, grad, change, records, cmvn)


def _record(host: Dict) -> Dict:
    """What the per-layer readers need of a window step: its rows' keys,
    text tokens and labels."""
    valid = np.asarray(host.get("batch_valid", np.ones(len(host["keys"]), bool)))
    text = np.asarray(host["attention_mask"]).sum(1)
    labels = (np.asarray(host["labels"]) != -100).sum(1)
    return {"rows": [{"key": k, "text": int(t), "labels": int(n)}
                     for k, t, n, v in zip(host["keys"], text, labels, valid) if v]}


def _kept_frames(r: Run, w, records, by_key, cmvn) -> None:
    """Each traced row's encoder positions and the frames the reference's
    PSD keeps (without dither), for the per-layer counts; text-only rows
    have no encoder and their expected share of the transcript."""
    from portbench.reference import frontend, tasu

    memo = {}
    text_only = r.recipe["train_config"].get("gt_emb", False)
    for rec in records:
        for row in rec["rows"]:
            u = by_key[row["key"]]
            if text_only:
                # the noise's drops are the window's own draws: the expected count
                drop = r.recipe.get("drop_prob", 0.05)
                row.update(enc=0, kept=round(len(assets.bpe_ids(u.text)) * (1 - drop)))
                continue
            if u.key not in memo:
                post = tasu.posterior(w["encoder"], r.cfg["encoder"],
                                      feed.reference_row(u, r.recipe, False, device=r.device), cmvn)
                memo[u.key] = len(tasu.psd_segments(post, threshold=r.recipe["blank_threshold"]))
            row.update(enc=frontend.n_lfr(len(u.samples)) + len(tasu.QUERY_IDS), kept=memo[u.key])
    r.facts["steps"] = records


def _compare(r: Run, utts, compared, losses, grad, change, records, cmvn) -> None:
    """The reference over the compared steps; the checks and their limits
    (the traffic's ``limits``)."""
    import torch

    from portbench import reference
    from portbench.reference import tasu

    reference.strict_fp32()
    dev = torch.device(r.device)
    by_key = {u.key: u for u in utts}
    recipe = r.recipe
    epoch = feed.reference_batches(utts, recipe, r.mix["batch_budget"],
                                   recipe["dataset_config"]["ds_rate"])
    expect = epoch * (1 + len(compared) // len(epoch))     # every epoch batches alike
    steps, keys_ok = [], True
    text_only = recipe["train_config"].get("gt_emb", False)
    for i, (host, noise) in enumerate(compared):
        valid = np.asarray(host.get("batch_valid", np.ones(len(host["keys"]), bool)))
        keys = [k for k, v in zip(host["keys"], valid) if v]
        keys_ok &= keys == expect[i]
        rows = []
        for j, key in enumerate(keys):
            u = by_key[key]
            if text_only:
                row = feed.reference_row(u, recipe, train=True, device=dev)
                row.gt_ids = assets.bpe_ids(u.text)
                row.alpha = float(noise[0][j].reshape(()))
                row.u_drop = noise[1][j, :len(row.gt_ids)].to(dev)
            else:
                f = max(1 + (len(u.samples) - 400) // 160, 0)
                row = feed.reference_row(u, recipe, train=True, noise=noise[j, :f].to(dev),
                                         device=dev)
            rows.append(row)
        steps.append(rows)
    w = {k: weights.fp32(v) for k, v in weights.make(r.cfg, r.seed, dev).items()}
    ref_recipe = dict(recipe["train_config"], dither=recipe["fbank"]["dither"],
                      blank_threshold=recipe["blank_threshold"],
                      drop_prob=recipe.get("drop_prob", 0.05))
    ref = tasu.train_steps(w, r.cfg, ref_recipe, steps, cmvn,
                           storage_dtype=weights.DTYPES[r.cfg["dtype"]])
    if r.trace:
        with torch.no_grad():
            _kept_frames(r, w, records, by_key, cmvn)
    del w
    harness.free(dev)
    r.checks["batches"] = Check(0.0 if keys_ok else 1.0, 0.0)
    _checks(r, losses, grad, change, ref)


def _checks(r: Run, losses, grad, change, ref) -> None:
    """Against the reference's: the parameters' change over the steps and
    the first gradient, by the worst leaf.  The change is a gap between
    the two norms; the gradient is the norm of the two's difference, since
    a gap of norms moves with no precision (PERF.md).  Each step's loss
    and the gap between the gradients' norms are readings only: neither a
    lower precision nor a fault of step 3 reads ten times a sound run."""
    import numpy as np

    lim = r.mix["limits"]
    # leaves whose reference gradient is rounding noise move by round-off alone
    med = statistics.median(ref.grad_norms.values())
    moving = [k for k, v in ref.grad_norms.items() if v >= 1e-3 * med]
    norms = {k: float(v.norm()) for k, v in grad.items()}
    diff = max(float((grad[k].to(v.device) - v).norm()) / max(ref.grad_norms[k], med, 1e-30)
               for k, v in ref.grad.items())
    r.readings.update(blank_share=ref.blank_share, kept_frames=float(np.mean(sum(ref.kept_frames, []))),
                      loss_gap=max(abs(a - b) / abs(b) for a, b in zip(losses, ref.losses)),
                      grad_norm_gap=leaf_gap(norms, ref.grad_norms),
                      **{f"loss{i + 1}": v for i, v in enumerate(losses)},
                      **{f"ref_loss{i + 1}": v for i, v in enumerate(ref.losses)})
    r.checks["grad_diff"] = Check(diff, lim["grad_diff"])
    r.checks["change_gap"] = Check(leaf_gap(change, ref.change_norms, moving), lim["change_gap"])


def _control(r: Run, utts) -> None:
    """The limits' upper readings: the reference put in the program's
    place, computed in fp8 (``--control fp8``) or with half of each batch
    left out and the mean taken over the rest (``--control half_batch``),
    over the recipe's first batches with the benchmark's own draws; held
    to the same checks as a run of the program.  No window runs."""
    import torch

    from portbench import reference
    from portbench.reference import precision, tasu

    reference.strict_fp32()
    dev = torch.device(r.device)
    recipe, cfg = r.recipe, r.cfg
    cmvn = weights.cmvn(cfg, r.seed, dev)
    text_only = recipe["train_config"].get("gt_emb", False)
    by_key = {u.key: u for u in utts}
    batches = feed.reference_batches(utts, recipe, r.mix["batch_budget"],
                                     recipe["dataset_config"]["ds_rate"])
    gen = torch.Generator(device=dev).manual_seed((r.seed * 7919 + 17) % (2 ** 63))
    tc = recipe["train_config"]
    steps = []
    for keys in batches[:r.mix["compared_steps"]]:
        rows = []
        for key in keys:
            u = by_key[key]
            row = feed.reference_row(u, recipe, train=True, device=dev)
            if text_only:
                row.gt_ids = assets.bpe_ids(u.text)
                row.alpha = float(torch.rand((), generator=gen, device=dev)
                                  * (tc["smooth_high"] - tc["smooth_low"]) + tc["smooth_low"])
                row.u_drop = torch.rand(len(row.gt_ids), generator=gen, device=dev)
            else:
                f = max(1 + (len(u.samples) - 400) // 160, 0)
                row.noise = torch.randn((f, 400), generator=gen, device=dev)
            rows.append(row)
        steps.append(rows)
    w = {k: weights.fp32(v) for k, v in weights.make(cfg, r.seed, dev).items()}
    ref_recipe = dict(tc, dither=recipe["fbank"]["dither"], blank_threshold=recipe["blank_threshold"],
                      drop_prob=recipe.get("drop_prob", 0.05))
    storage = weights.DTYPES[cfg["dtype"]]
    ref = tasu.train_steps(w, cfg, ref_recipe, steps, cmvn, storage_dtype=storage)
    if r.control == "fp8":
        with precision.fp8():
            ctl = tasu.train_steps(w, cfg, ref_recipe, steps, cmvn, storage_dtype=storage)
    elif r.control == "half_batch":
        ctl = tasu.train_steps(w, cfg, ref_recipe, [rows[: max(len(rows) // 2, 1)] for rows in steps],
                               cmvn, storage_dtype=storage)
    else:
        raise ValueError(f"no control {r.control!r} for a training cell")
    r.setup_done()
    _checks(r, ctl.losses, ctl.grad, ctl.change_norms, ref)
