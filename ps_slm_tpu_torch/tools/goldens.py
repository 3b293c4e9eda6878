"""Activation goldens: verify the port's loaders and modules against them.

Counterpart of ``ps_slm_tpu/tools/goldens.py``'s ``verify``: load released
weights through the port's loaders (``load_funasr_encoder``,
``qwen2.load_hf_checkpoint``), run the port's encoder, CTC head and LLM in
fp32 on the same seeded fixture and compare with a goldens ``.npz``
(``enc_hidden``, ``ctc_logits``, ``llm_ids`` / ``llm_logits``) at the JAX
tool's tolerances: ``ATOL`` for the encoder's valid frames, 10 x ``ATOL``
for the CTC logits and the LLM's logits.

    python -m ps_slm_tpu_torch.tools.goldens verify goldens.npz \\
        --encoder-dir /path/SenseVoiceSmall [--llm-dir /path/Qwen2.5-1.5B]

``capture`` (running the reference implementation's own torch modules)
is not ported: it imports them from the reference source tree, which
this repository does not hold (ROADMAP.md queue 1, 'Long tail').  A
goldens file captured by the JAX package's tool on a machine that has it
is what ``verify`` reads.

The default device is the CUDA card; ``device="cpu"`` runs the plain
versions of the kernels.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ps_slm_tpu_torch._build import resolve_device

ATOL = 2e-4


def _fixture(batch=2, frames=64, dim=560, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, frames, dim)).astype(np.float32)
    lens = np.asarray([frames, frames - 9], np.int32)
    return feats, lens


def capture(out_path: str, encoder_dir: str = None, llm_dir: str = None):
    raise NotImplementedError(
        "goldens capture runs the reference implementation's torch modules, imported from "
        "the reference source tree, which this repository does not hold; capture with "
        "the JAX package's tool where that tree is present (ROADMAP.md queue 1, 'Long tail')"
    )


def _encoder(encoder_dir: str, dev):
    from ps_slm_tpu_torch.models.sensevoice import SenseVoiceEncoder
    from ps_slm_tpu_torch.training.checkpoint import load_funasr_encoder

    state, cfg = load_funasr_encoder(encoder_dir)
    with torch.device("meta"):
        enc = SenseVoiceEncoder(cfg)
    enc = enc.to_empty(device=dev)
    enc.load_state_dict({k: v.float() for k, v in state.items()})
    return enc.eval()


def _llm(llm_dir: str, dev):
    from ps_slm_tpu_torch.models.qwen2 import Qwen2Model, load_hf_checkpoint

    state, cfg = load_hf_checkpoint(llm_dir)
    with torch.device("meta"):
        llm = Qwen2Model(cfg)
    llm = llm.to_empty(device=dev)
    llm.load_state_dict({k: v.float() for k, v in state.items()})
    return llm.eval()


@torch.no_grad()
def verify(golden_path: str, encoder_dir: str = None, llm_dir: str = None, *,
           device="cuda", log=print) -> int:
    """0 (PASS) when every golden in ``golden_path`` that the given
    directories can reproduce agrees within its tolerance, else 1."""
    dev = resolve_device(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 goldens demand fp32 matmuls
    try:
        return _verify(np.load(golden_path), encoder_dir, llm_dir, dev, log)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _verify(g, encoder_dir, llm_dir, dev, log) -> int:
    feats, lens = _fixture()
    rc = 0
    if encoder_dir and "enc_hidden" in g:
        enc = _encoder(encoder_dir, dev)
        hid, _ = enc(torch.from_numpy(feats).to(dev), torch.from_numpy(lens).to(dev))
        # padded frames are unspecified output: compare the valid ones only
        valid = np.arange(feats.shape[1])[None, :] < lens[:, None]
        err = float(np.max(np.abs(hid.cpu().numpy() - g["enc_hidden"])[valid]))
        log(f"encoder hidden max|err| = {err:.2e} (atol {ATOL})")
        rc |= int(err > ATOL)
        if "ctc_logits" in g:
            logits = enc.ctc_logits(hid).cpu().numpy()
            err = float(np.max(np.abs(logits - g["ctc_logits"])[valid]))
            log(f"ctc logits max|err| = {err:.2e}")
            rc |= int(err > 10 * ATOL)
    if llm_dir and "llm_logits" in g:
        llm = _llm(llm_dir, dev)
        ids = torch.from_numpy(np.asarray(g["llm_ids"])).long().to(dev)
        mask = torch.ones(ids.shape, dtype=torch.bool, device=dev)
        pos = torch.arange(ids.shape[1], device=dev)[None].expand(ids.shape[0], -1)
        hid, _ = llm(llm.embed(ids), mask, pos)
        logits = llm.unembed(hid).cpu().numpy()
        err = float(np.max(np.abs(logits - g["llm_logits"])))
        log(f"llm logits max|err| = {err:.2e} (atol {10 * ATOL})")
        rc |= int(err > 10 * ATOL)
    log("PASS" if rc == 0 else "FAIL")
    return rc


def main(argv=None, *, device="cuda"):
    """``verify goldens.npz`` with ``--encoder-dir`` / ``--llm-dir`` (or
    ``PS_SENSEVOICE_DIR`` / ``PS_QWEN_DIR``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("capture", "verify"))
    ap.add_argument("npz")
    ap.add_argument("--encoder-dir", default=os.environ.get("PS_SENSEVOICE_DIR"),
                    help="SenseVoiceSmall funasr dir (env PS_SENSEVOICE_DIR)")
    ap.add_argument("--llm-dir", default=os.environ.get("PS_QWEN_DIR"),
                    help="Qwen2.5 HF dir (env PS_QWEN_DIR)")
    a = ap.parse_args(argv)
    if a.mode == "capture":
        return capture(a.npz, encoder_dir=a.encoder_dir, llm_dir=a.llm_dir)
    return verify(a.npz, encoder_dir=a.encoder_dir, llm_dir=a.llm_dir, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
