"""Kaldi fbank, LFR stacking and global CMVN of one utterance (funasr's
WavFrontend), in float64.

Kaldi's conventions: frames of 25 ms every 10 ms with snip_edges
(``1 + (n - 400) // 160`` frames), samples in the int16 range, dither
added before the DC offset is removed, preemphasis 0.97 with the first
sample its own predecessor, a Hamming window, the power of a 512-point FFT
over bins [0, 256), 80 triangular mel filters on 1127 ln(1 + f / 700)
between 0 and 8 kHz, log floored at float32's epsilon.  LFR stacks 7
frames every 6, padding the front with 3 copies of the first frame and the
tail with the last; CMVN is ``(x + shift) * scale``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

FRAME, SHIFT, FFT, MELS = 400, 160, 512, 80
LFR_M, LFR_N = 7, 6
FLOOR = float(np.finfo(np.float32).eps)


def _mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


def mel_matrix() -> np.ndarray:
    """[256, 80] triangular filters (float64)."""
    m = _mel(np.arange(FFT // 2) * 16000.0 / FFT)[:, None]
    lo, hi = _mel(0.0), _mel(8000.0)
    edges = lo + np.arange(MELS + 2) * (hi - lo) / (MELS + 1)
    left, center, right = edges[:-2], edges[1:-1], edges[2:]
    up = (m - left) / (center - left)
    down = (right - m) / (right - center)
    return np.where((m > left) & (m < right), np.where(m <= center, up, down), 0.0)


def n_frames(n_samples: int) -> int:
    return max(1 + (n_samples - FRAME) // SHIFT, 0)


def n_lfr(n_samples: int) -> int:
    return -(-n_frames(n_samples) // LFR_N)


def log_mel(samples: torch.Tensor, dither: float = 0.0,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[frames, 80] float32 log-mel of int16 ``samples`` [n]; ``noise``
    [frames, 400] N(0, 1) scaled by ``dither``."""
    x = samples.double()
    f = n_frames(x.numel())
    frames = x.unfold(0, FRAME, SHIFT)[:f]
    if noise is not None and dither > 0.0:
        frames = frames + dither * noise.double()
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames - 0.97 * prev
    i = torch.arange(FRAME, dtype=torch.float64, device=x.device)
    frames = frames * (0.54 - 0.46 * torch.cos(2 * math.pi * i / (FRAME - 1)))
    power = torch.fft.rfft(frames, n=FFT, dim=1).abs().square()[:, : FFT // 2]
    mel = power @ torch.from_numpy(mel_matrix()).to(x.device)
    return torch.log(torch.clamp(mel, min=FLOOR)).float()


def lfr(feats: torch.Tensor) -> torch.Tensor:
    """[frames, 80] -> [ceil(frames / 6), 560]."""
    f = feats.shape[0]
    t = np.arange(-(-f // LFR_N))[:, None] * LFR_N + np.arange(LFR_M)[None] - (LFR_M - 1) // 2
    idx = torch.from_numpy(np.clip(t, 0, f - 1)).to(feats.device)
    return feats[idx].reshape(idx.shape[0], -1)


def features(samples: torch.Tensor, cmvn, dither: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[T, 560] float32 encoder input of one utterance."""
    shift, scale = cmvn
    x = lfr(log_mel(samples, dither, noise))
    return (x + shift.to(x.device).float()) * scale.to(x.device).float()
