"""One-command asset-day rehearsal: every BASELINE quality row, unattended.

Counterpart of ``ps_slm_tpu/tools/asset_day.py`` on the port's CLIs.  With
the released assets mounted:

    python -m ps_slm_tpu_torch.tools.asset_day --assets /assets --workdir out/asset_day

It expects the layout::

    <assets>/SenseVoiceSmall/            funasr dir (model.pt, config.yaml,
                                         chn_jpn_yue_eng_ko_spectok.bpe.model)
    <assets>/Qwen2.5-1.5B-Instruct/      HF dir
    <assets>/text_only/pytorch_model.bin           released TASU ckpts
    <assets>/half_audio_finetuned/pytorch_model.bin
    <assets>/test_sets/<name>/multitask.jsonl      eval manifests
    <assets>/multiprompt.jsonl

and produces:

  1. the activation goldens' verdict: ``tools/goldens.py``'s ``verify`` of
     the port's loaders against ``<workdir>/goldens.npz`` when that file is
     there (captured by the JAX package's tool, which runs the reference's
     own modules); else ``"goldens": null`` and the reason under
     ``"goldens_reason"`` (the JAX tool captures first, then verifies);
  2. for every (checkpoint, test set): the reference decode pipeline,
     ``cli/decode`` with ``decode_sensevoice.sh``'s knobs (ctc_posterior,
     do_psd, beam 4) -> ``clean_marks`` -> ``tools/wer --char=1``;
  3. ``<workdir>/BASELINE_QUALITY.json`` with one row per pair.

``--dry-run`` writes synthetic stand-ins in the same layout from a tiny
random port model (``tools/_assets.py``'s writers) and runs the same code
path.  WER on random weights is meaningless; the artifact is that every
stage runs and every row is produced.  The default device is the CUDA
card; ``device="cpu"`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil

RECIPES = ("text_only", "half_audio_finetuned")
# the prompts of the tasks the synthetic manifest draws
DRY_PROMPTS = {
    "ASR": "Transcribe the speech into English text, output only the transcript:",
    "ZH2EN": "Recognize the speech and translate it into English:",
    "EN2ZH": "Recognize the speech and translate it into Chinese, output only the translation:",
    "EN2DE": "Recognize the speech and translate it into German, output only the translation:",
}
DRY_SPECIALS = {"<|endoftext|>": 256, "<|im_start|>": 257, "<|im_end|>": 258}


def _llm_dim(llm_dir: str) -> int:
    with open(os.path.join(llm_dir, "config.json")) as f:
        return int(json.load(f)["hidden_size"])


def _encoder_vocab(enc_dir: str) -> int:
    from ps_slm_tpu_torch.training.checkpoint import _parse_encoder_yaml

    return int(_parse_encoder_yaml(os.path.join(enc_dir, "config.yaml"))["vocab_size"])


def decode_and_score(
    enc_dir: str, llm_dir: str, ckpt: str, test_dir: str, prompt_path: str,
    out_prefix: str, *, extra_args=(), log=print, device="cuda",
) -> dict:
    """cli/decode with the reference decode knobs -> clean_marks -> wer
    (``decode_sensevoice.sh:60-97``)."""
    from ps_slm_tpu_torch.cli.decode import main as decode_main
    from ps_slm_tpu_torch.tools.clean_marks import clean_file
    from ps_slm_tpu_torch.tools.wer import score_files

    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    rc = decode_main([
        f"++model_config.llm_path={llm_dir}",
        f"++model_config.llm_dim={_llm_dim(llm_dir)}",
        f"++model_config.encoder_path={enc_dir}",
        f"++model_config.encoder_dim={_encoder_vocab(enc_dir)}",
        "++model_config.encoder_projector=linear-silu",
        "++model_config.encoder_projector_ds_rate=1",
        "++train_config.ctc_posterior=true",
        "++train_config.do_psd=true",
        "++train_config.gt_emb=false",
        f"++dataset_config.test_scp_file_path={test_dir}",
        f"++dataset_config.multitask_prompt_path={prompt_path}",
        f"ckpt_path={ckpt}",
        f"decode_log={out_prefix}",
    ] + list(extra_args), device=device)
    if rc != 0:
        raise RuntimeError(f"decode failed rc={rc} for {ckpt} x {test_dir}")
    clean_file(out_prefix + "_pred")
    clean_file(out_prefix + "_gt")
    buf = io.StringIO()
    result = score_files(out_prefix + "_gt", out_prefix + "_pred", char=True, verbose=True,
                         stream=buf)
    with open(out_prefix + "_wer", "w") as f:
        f.write(buf.getvalue())
    log(f"  {out_prefix}: WER {result['wer']:.2f}% (N={result['all']})")
    return result


def run_all(assets: str, workdir: str, *, extra_args=(), log=print, device="cuda") -> dict:
    from ps_slm_tpu_torch.tools import goldens

    os.makedirs(workdir, exist_ok=True)
    enc_dir = os.path.join(assets, "SenseVoiceSmall")
    llm_dir = os.path.join(assets, "Qwen2.5-1.5B-Instruct")
    prompt_path = os.path.join(assets, "multiprompt.jsonl")
    out: dict = {"assets": assets, "goldens": None, "rows": []}

    # 1. activation goldens: the port's loaders against a captured npz
    npz = os.path.join(workdir, "goldens.npz")
    have_enc, have_llm = os.path.isdir(enc_dir), os.path.isdir(llm_dir)
    if not os.path.exists(npz):
        out["goldens_reason"] = (f"no {npz}: capture it with the JAX package's "
                                 "tools/goldens.py, which runs the reference's modules")
        log(f"== goldens: skipped ({out['goldens_reason']}) ==")
    elif have_enc or have_llm:
        log("== goldens: verify (the port's loaders) ==")
        rc = goldens.verify(npz, encoder_dir=enc_dir if have_enc else None,
                            llm_dir=llm_dir if have_llm else None, device=device, log=log)
        out["goldens"] = "PASS" if rc == 0 else "FAIL"

    # 2. decode + WER for every (recipe ckpt, test set)
    ts_root = os.path.join(assets, "test_sets")
    test_sets = sorted(
        d for d in (os.listdir(ts_root) if os.path.isdir(ts_root) else [])
        if os.path.exists(os.path.join(ts_root, d, "multitask.jsonl"))
    )
    for recipe in RECIPES:
        ckpt = os.path.join(assets, recipe, "pytorch_model.bin")
        if not os.path.exists(ckpt):
            log(f"== {recipe}: no checkpoint, skipped ==")
            continue
        for ts in test_sets:
            log(f"== decode {recipe} x {ts} ==")
            r = decode_and_score(
                enc_dir, llm_dir, ckpt, os.path.join(ts_root, ts), prompt_path,
                os.path.join(workdir, f"{recipe}_{ts}", "test"),
                extra_args=extra_args, log=log, device=device,
            )
            out["rows"].append({"recipe": recipe, "test_set": ts, "wer": round(r["wer"], 2),
                                "n_ref_tokens": r["all"]})

    path = os.path.join(workdir, "BASELINE_QUALITY.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {path}")
    return out


# ----------------------------------------------------------------------------
# dry run: synthetic stand-ins in the exact asset layout
# ----------------------------------------------------------------------------

def build_dry_assets(assets: str, *, seed: int = 0, utts=None, seconds=(0.5, 1.0)) -> None:
    """Write the whole asset layout from a tiny random port model (fp32,
    linear-silu, a 300-token LLM with Qwen2.5's specials at 256-258, a
    560-wide encoder input): both recipe checkpoints hold its projector."""
    import torch

    from ps_slm_tpu_torch.config import ModelConfig, TrainConfig
    from ps_slm_tpu_torch.models.tasu import model_factory
    from ps_slm_tpu_torch.tools._assets import write_assets

    os.makedirs(assets, exist_ok=True)
    model = model_factory(
        TrainConfig(ctc_posterior=True, do_psd=True, seed=seed),
        ModelConfig(encoder_projector="linear-silu", llm_dim=64, encoder_dim=11,
                    llm_config_overrides=dict(vocab_size=300),
                    encoder_config_overrides=dict(input_size=560)), device="cpu")
    out = write_assets(assets, model, llm_dtype=torch.float32, specials=DRY_SPECIALS,
                       utts=utts or {"ark": 4, "wav": 1, "flac": 1}, seconds=seconds,
                       seed=seed)
    ts = os.path.join(assets, "test_sets", "synthetic")
    os.makedirs(ts, exist_ok=True)     # the manifest; its audio stays beside the original
    shutil.copy(os.path.join(out["data"], "multitask.jsonl"), os.path.join(ts, "multitask.jsonl"))
    text_only = os.path.join(assets, "text_only")
    os.makedirs(text_only, exist_ok=True)
    shutil.copy(out["ckpt_path"], os.path.join(text_only, "pytorch_model.bin"))
    with open(os.path.join(assets, "multiprompt.jsonl"), "w") as f:
        for task, prompt in DRY_PROMPTS.items():
            f.write(json.dumps({"task": task, "prompt": prompt}) + "\n")


def main(argv=None, *, device="cuda"):
    ap = argparse.ArgumentParser(
        description="asset-day rehearsal: goldens + every BASELINE quality row in one command")
    ap.add_argument("--assets", default=os.environ.get("PS_ASSETS_DIR"))
    ap.add_argument("--workdir", default="asset_day")
    ap.add_argument("--dry-run", action="store_true",
                    help="write synthetic stand-ins in the asset layout first")
    ap.add_argument("--decode-arg", action="append", default=[],
                    help="extra ++overrides forwarded to every decode")
    a = ap.parse_args(argv)
    assets = a.assets
    extra = list(a.decode_arg)
    if a.dry_run:
        assets = assets or os.path.join(a.workdir, "dry_assets")
        build_dry_assets(assets)
        # tiny stand-ins answer in a few tokens; cap the loop accordingly
        extra += [
            "++train_config.max_new_tokens=12",
            "++dataset_config.eval_max_frame_length=96",
            "++dataset_config.prompt_style={} <speech> ",
        ]
    if not assets:
        ap.error("--assets (or PS_ASSETS_DIR) required without --dry-run")
    out = run_all(assets, a.workdir, extra_args=extra, device=device)
    print(json.dumps({"metric": "asset_day", "goldens": out["goldens"], "rows": out["rows"],
                      "dry_run": bool(a.dry_run)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
