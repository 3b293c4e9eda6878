"""Kaldi-convention fbank front end + LFR + CMVN, on the device.

Counterpart of ``ps_slm_tpu/ops/fbank.py`` (eval mode): batched torch ops
on the waveform's device, from int16 or float waveforms to the [B, T', 560]
features the encoder takes.  framing -> DC removal -> preemphasis ->
window -> 512-point ``torch.fft.rfft`` power spectrum -> Kaldi mel banks
(one ``power @ mel`` product) -> log -> LFR -> CMVN, as the JAX package
computes them with ``jnp.fft.rfft`` and a plain product outside any Pallas
kernel.

Precision: the JAX package runs the fbank in fp32, and two fp32 FFTs
(XLA's and torch's, or cuFFT's) round differently: in a mel bin whose
power lies far below the frame's peak, the log-mel values of two fp32
implementations can differ by more than 1e-3, each as far from the exact
value as the other.  The port runs framing, FFT, power and the mel product
in float64 and rounds the log-mel to fp32 once, so its features are the
exact ones to fp32 rounding: they differ from the JAX package's by that
package's own fp32 error (the tests' tolerance is atol 1e-3), and the card
and the CPU give the same features but for float64 rounding, which keeps
the discrete choices downstream (PSD's argmax and blank threshold, the
beam's top-k) the same on both.

Kaldi conventions:
  * snip_edges frame count: 1 + (N - frame_len) // frame_shift (0 when
    N < frame_len)
  * waveform scaled by 32768 (funasr's WavFrontend feeds int16-range floats)
  * remove_dc_offset, preemphasis 0.97 (x[t] - 0.97 x[t-1], x[-1] := x[0])
  * Hamming window 0.54 - 0.46 cos(2 pi n / (N-1))
  * power spectrum on a 512-point FFT, mel banks over bins [0, 256) (the
    Nyquist bin excluded), mel scale 1127 ln(1 + f/700)
  * log(max(e, eps))

LFR (funasr apply_lfr): left-pad (m-1)//2 copies of frame 0, stack m frames
every n, repeat the last valid frame to fill the tail; T_lfr = ceil(T/n).
CMVN (funasr apply_cmvn, Kaldi am.mvn): x := (x + neg_mean) * inv_stddev.

Training (``frontend(train=True)``) adds dither and SpecAugment, as the
JAX front end does: ``dither * N(0, 1)`` noise on the int16-range frames
before DC removal, then, after CMVN, time masks drawn inside each row's
valid LFR frames and frequency masks over all bins, zero-filled.  The
JAX functions draw from ``jax.random`` inside; torch's generators cannot
reproduce those draws, so here every random number of one call comes in a
:class:`FrontendDraws` (tests feed the JAX draws recomputed from the same
key) or is drawn by :func:`frontend_draws` from a ``torch.Generator`` on
the waveform's device.  The fp32 noise is added to the float64 frames.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ps_slm_tpu_torch.ops import RowBlock, draw_rows

EPS = 1.1920928955078125e-07  # torch float32 eps, the Kaldi log-energy floor


class FrontendDraws(NamedTuple):
    """The random numbers of one training front end call; a field is None
    when its augmentation is off."""

    dither: Optional[torch.Tensor] = None     # [B, T, frame_len] fp32 N(0, 1)
    t_starts: Optional[torch.Tensor] = None   # [B, t_masks] in [0, max(lfr_len, 1))
    t_widths: Optional[torch.Tensor] = None   # [B, t_masks] in [0, t_width]
    f_starts: Optional[torch.Tensor] = None   # [B, f_masks] in [0, D)
    f_widths: Optional[torch.Tensor] = None   # [B, f_masks] in [0, f_width]


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=8)
def mel_banks(
    num_bins: int = 80,
    fft_len: int = 512,
    sample_rate: int = 16000,
    low_freq: float = 0.0,
    high_freq: float = 8000.0,
) -> np.ndarray:
    """Kaldi MelBanks matrix [fft_len//2, num_bins] (Nyquist bin excluded).
    Cached: callers must not write to it."""
    if high_freq <= 0:
        high_freq = sample_rate / 2 + high_freq
    num_fft_bins = fft_len // 2
    fft_bin_width = sample_rate / fft_len
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_fft_bins, num_bins), np.float32)
    for j in range(num_bins):
        left = mel_low + j * mel_delta
        center = mel_low + (j + 1) * mel_delta
        right = mel_low + (j + 2) * mel_delta
        for i in range(num_fft_bins):
            m = _mel(i * fft_bin_width)
            if left < m < right:
                if m <= center:
                    bins[i, j] = (m - left) / (center - left)
                else:
                    bins[i, j] = (right - m) / (right - center)
    return bins


def _window(n: int, window_type: str) -> np.ndarray:
    i = np.arange(n)
    if window_type == "hamming":
        return (0.54 - 0.46 * np.cos(2 * np.pi * i / (n - 1))).astype(np.float32)
    if window_type == "hanning":
        return (0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))).astype(np.float32)
    if window_type == "povey":
        return ((0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85).astype(np.float32)
    if window_type == "rectangular":
        return np.ones(n, np.float32)
    raise ValueError(f"unknown window {window_type!r}")


def fbank(
    waveform: torch.Tensor,       # [B, N] float in [-1, 1]
    lengths: torch.Tensor,        # [B] samples
    *,
    num_mel_bins: int = 80,
    frame_length_ms: int = 25,
    frame_shift_ms: int = 10,
    sample_rate: int = 16000,
    window_type: str = "hamming",
    preemphasis: float = 0.97,
    remove_dc: bool = True,
    low_freq: float = 0.0,
    high_freq: float = 8000.0,
    dither: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Kaldi log-mel fbank: ([B, T, num_mel_bins] fp32, frame
    lengths [B] int32), computed in float64 (see the module docstring).  T
    is the frame count of the padded N; a row's valid frames are
    ``1 + (len - frame_len) // shift`` (0 when len < frame_len).  With
    ``dither`` > 0 and ``noise`` (N(0, 1) of shape [B, T, frame_len]),
    ``dither * noise`` is added to the int16-range frames before DC
    removal."""
    b, n = waveform.shape
    dev = waveform.device
    frame_len = sample_rate * frame_length_ms // 1000
    shift = sample_rate * frame_shift_ms // 1000
    fft_len = 1 << max(frame_len - 1, 1).bit_length()  # 400 -> 512

    num_frames, frame_lens = framing(n, lengths.to(dev), frame_len, shift)

    x = waveform.double() * 32768.0  # int16 range (funasr)
    idx = (torch.arange(num_frames, device=dev)[:, None] * shift
           + torch.arange(frame_len, device=dev)[None])         # [T, L]
    frames = x[:, idx]                                          # [B, T, L]
    if dither > 0.0 and noise is not None:
        if noise.shape != frames.shape:
            raise ValueError(f"dither noise {tuple(noise.shape)}, frames {tuple(frames.shape)}")
        frames = frames + dither * noise.to(dev, torch.float64)
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis > 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * torch.from_numpy(_window(frame_len, window_type)).to(dev, torch.float64)

    spec = torch.fft.rfft(frames, n=fft_len, dim=-1)             # zero-padded to fft_len
    power = spec.abs().square()[..., : fft_len // 2]            # drop Nyquist
    mel = torch.from_numpy(
        mel_banks(num_mel_bins, fft_len, sample_rate, low_freq, high_freq)).to(dev, torch.float64)
    feats = torch.log(torch.clamp(power @ mel, min=EPS)).float()
    return feats, frame_lens


def lfr(
    feats: torch.Tensor,     # [B, T, D]
    lens: torch.Tensor,      # [B]
    m: int = 7,
    n: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-frame-rate stacking (funasr apply_lfr): [B,T,D] -> [B,ceil(T/n),D*m].

    Per row, on its valid frames: left-pad (m-1)//2 copies of frame 0, a
    window of m frames every n, tail windows repeat the last valid frame
    (a gather with indices clamped to [0, len-1]).  The output length
    follows the padded T."""
    b, t, d = feats.shape
    dev = feats.device
    t_lfr = -(-t // n)
    lens = lens.to(dev).long()
    base = (torch.arange(t_lfr, device=dev)[:, None] * n
            + torch.arange(m, device=dev)[None] - (m - 1) // 2)   # [T', m]
    hi = (lens - 1).clamp(min=0)[:, None, None]                   # [B, 1, 1]
    idx = torch.minimum(base[None].clamp(min=0), hi)              # [B, T', m]
    out = torch.gather(feats, 1, idx.reshape(b, t_lfr * m, 1).expand(-1, -1, d))
    return out.reshape(b, t_lfr, m * d), lfr_lengths(lens, n)


def load_cmvn(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a Kaldi ``am.mvn`` (text) -> (neg_mean [D], inv_stddev [D]):
    the last two bracketed vectors (<AddShift> means and <Rescale> vars,
    after an optional <Splice> vector)."""
    with open(path) as f:
        text = f.read().split()
    arrays = []
    i = 0
    while i < len(text):
        if text[i] == "[":
            j = i + 1
            vals = []
            while text[j] != "]":
                vals.append(float(text[j]))
                j += 1
            arrays.append(np.asarray(vals, np.float32))
            i = j
        i += 1
    if len(arrays) < 2:
        raise ValueError(f"could not parse CMVN stats from {path}")
    return arrays[-2], arrays[-1]


def apply_cmvn(feats: torch.Tensor, neg_mean, inv_std) -> torch.Tensor:
    """(feats + neg_mean) * inv_std; the vectors as tensors or arrays."""
    neg_mean = torch.as_tensor(neg_mean, device=feats.device)
    inv_std = torch.as_tensor(inv_std, device=feats.device)
    return (feats + neg_mean) * inv_std


def framing(num_samples: int, lengths: torch.Tensor, frame_len: int, shift: int
            ) -> Tuple[int, torch.Tensor]:
    """Kaldi snip_edges framing: (frames of a waveform padded to
    ``num_samples``, int32 valid frames of each row of ``lengths``
    samples), each ``1 + (samples - frame_len) // shift`` and at least 0."""
    num_frames = max(1 + (num_samples - frame_len) // shift, 0)
    lens = (1 + torch.div(lengths - frame_len, shift, rounding_mode="floor")).clamp(min=0)
    return num_frames, lens.to(torch.int32)


def lfr_lengths(lens: torch.Tensor, n: int) -> torch.Tensor:
    """int32 LFR frames of rows of ``lens`` frames, one every ``n``."""
    return torch.div(lens.long() + n - 1, n, rounding_mode="floor").to(torch.int32)


def _randint(shape, high: torch.Tensor, generator: torch.Generator,
             block: Optional[RowBlock] = None) -> torch.Tensor:
    """Integers uniform in [0, high) (``high`` >= 1, broadcast to ``shape``);
    the uniforms of ``block``'s rows of the global batch (``draw_rows``)."""
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=generator.device,
                                       dtype=torch.float64), shape, block)
    return torch.minimum((u * high).floor().long(), high - 1)


def mask_draws(lfr_lens: torch.Tensor, feat_dim: int, generator: torch.Generator, cfg,
               block: Optional[RowBlock] = None) -> Tuple[torch.Tensor, ...]:
    """SpecAugment's (t_starts, t_widths, f_starts, f_widths) for rows of
    ``lfr_lens`` valid LFR frames: starts uniform inside each row's valid
    frames (at least [0, 1)) and over the ``feat_dim`` bins, widths uniform
    in [0, width], as the JAX ``spec_augment`` draws them."""
    dev = generator.device
    b = lfr_lens.shape[0]
    t_lim = lfr_lens.to(dev).long().clamp(min=1)[:, None]
    t_starts = _randint((b, cfg.specaug_t_masks), t_lim, generator, block)
    t_widths = _randint((b, cfg.specaug_t_masks), torch.tensor(cfg.specaug_t_width + 1, device=dev),
                        generator, block)
    f_starts = _randint((b, cfg.specaug_f_masks), torch.tensor(feat_dim, device=dev), generator,
                        block)
    f_widths = _randint((b, cfg.specaug_f_masks), torch.tensor(cfg.specaug_f_width + 1, device=dev),
                        generator, block)
    return t_starts, t_widths, f_starts, f_widths


def frontend_draws(waveform: torch.Tensor, lengths: torch.Tensor, generator: torch.Generator,
                   cfg, block: Optional[RowBlock] = None) -> FrontendDraws:
    """Every draw of one ``frontend(train=True)`` call under ``cfg``, from
    ``generator`` (on the waveform's device): the dither noise when
    ``cfg.dither`` > 0, the masks when ``cfg.specaug``; with ``block``,
    ``block``'s rows of the draws for the global batch."""
    b, n = waveform.shape
    frame_len = cfg.sample_rate * cfg.frame_length // 1000
    t, flens = framing(n, lengths.to(generator.device), frame_len,
                       cfg.sample_rate * cfg.frame_shift // 1000)
    dither = None
    if cfg.dither > 0.0:
        dither = draw_rows(lambda s: torch.randn(s, generator=generator, device=generator.device),
                           (b, t, frame_len), block)
    if not cfg.specaug:
        return FrontendDraws(dither)
    return FrontendDraws(dither, *mask_draws(lfr_lengths(flens, cfg.lfr_n),
                                             cfg.num_mel_bins * cfg.lfr_m, generator, cfg, block))


def spec_augment(feats: torch.Tensor, lens: torch.Tensor, draws: FrontendDraws) -> torch.Tensor:
    """SpecAugment time and frequency masking, zero fill: frame t of a row
    is masked when some time mask covers it (start <= t < start + width)
    and t < the row's length; bin f when some frequency mask covers it."""
    b, t, d = feats.shape
    dev = feats.device

    def hit(starts, widths, size):
        pos = torch.arange(size, device=dev)[None, None, :]
        starts, widths = starts.to(dev)[..., None], widths.to(dev)[..., None]
        return ((pos >= starts) & (pos < starts + widths)).any(dim=1)   # [B, size]

    t_mask = hit(draws.t_starts, draws.t_widths, t) & (
        torch.arange(t, device=dev)[None] < lens.to(dev)[:, None])
    f_mask = hit(draws.f_starts, draws.f_widths, d)
    out = torch.where(t_mask[..., None], 0.0, feats)
    return torch.where(f_mask[:, None, :], 0.0, out)


def frontend(
    waveform: torch.Tensor,
    lengths: torch.Tensor,
    *,
    cfg=None,
    cmvn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[FrontendDraws] = None,
    block: Optional[RowBlock] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """funasr WavFrontend's pipeline: fbank -> LFR -> CMVN, on the
    waveform's device, fp32 out.  int16 waveforms (the wire format) are rescaled to
    [-1, 1] here, so the round trip of 16-bit sources is exact.  Returns
    ([B, T', num_mel_bins * lfr_m], lengths [B] int32).

    ``train`` adds dither (``cfg.dither`` > 0) and SpecAugment
    (``cfg.specaug``), from ``draws`` when given, else drawn from
    ``generator`` (``block``'s rows of the global batch's draws, when
    given); without ``train`` neither acts."""
    from ps_slm_tpu_torch.config import FbankConfig

    cfg = cfg or FbankConfig()
    augment = train and (cfg.dither > 0.0 or cfg.specaug)
    if augment and draws is None:
        if generator is None:
            raise ValueError("the training front end (dither, SpecAugment) needs a generator "
                             "or draws")
        draws = frontend_draws(waveform, lengths, generator, cfg, block)
    if augment and ((cfg.dither > 0.0 and draws.dither is None)
                    or (cfg.specaug and draws.t_starts is None)):
        raise ValueError("the draws lack the dither noise or the masks that cfg asks for")
    if waveform.dtype == torch.int16:
        waveform = waveform.float() / 32768.0
    feats, flens = fbank(
        waveform, lengths,
        num_mel_bins=cfg.num_mel_bins,
        frame_length_ms=cfg.frame_length,
        frame_shift_ms=cfg.frame_shift,
        sample_rate=cfg.sample_rate,
        window_type=cfg.window_type,
        low_freq=float(cfg.low_freq),
        high_freq=float(cfg.high_freq),
        dither=cfg.dither if augment else 0.0,
        noise=draws.dither if augment else None,
    )
    feats, flens = lfr(feats, flens, cfg.lfr_m, cfg.lfr_n)
    if cmvn is not None:
        feats = apply_cmvn(feats, cmvn[0], cmvn[1])
    if augment and cfg.specaug:
        feats = spec_augment(feats, flens, draws)
    return feats, flens


# ----------------------------------------------------------------------------
# Whisper-style log-mel (the collator's encoder == "whisper" path)
# ----------------------------------------------------------------------------

def _mel_slaney(num_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """librosa-convention mel filters (slaney scale + slaney norm) used by
    whisper's precomputed mel_filters; [n_fft // 2 + 1, num_mels] fp32."""
    fmax = sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        return np.where(
            log_region,
            15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mel,
        )

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), num_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    weights = np.zeros((num_mels, len(bins)), np.float32)
    for i in range(num_mels):
        lower = (bins - hz[i]) / (hz[i + 1] - hz[i])
        upper = (hz[i + 2] - bins) / (hz[i + 2] - hz[i + 1])
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz[2: num_mels + 2] - hz[:num_mels])   # slaney normalization
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def pad_or_trim(waveform: torch.Tensor, length: int = 480000) -> torch.Tensor:
    """whisper.pad_or_trim: fix the last axis to ``length`` samples (30 s)."""
    n = waveform.shape[-1]
    if n >= length:
        return waveform[..., :length]
    return torch.nn.functional.pad(waveform, (0, length - n))


def whisper_log_mel(waveform: torch.Tensor, *, n_mels: int = 128, n_fft: int = 400,
                    hop: int = 160) -> torch.Tensor:
    """whisper.log_mel_spectrogram of ``waveform`` [B, N] (use
    :func:`pad_or_trim` first) on its device: centered (reflect-padded)
    periodic-hann STFT -> slaney mel -> log10 -> dynamic-range clamp
    (max - 8) -> (x + 4) / 4.  Returns [B, n_mels, T] fp32, the last STFT
    frame dropped as whisper drops it.  Computed in float64 when the
    waveform is float64 (the collator's host path, as the fbank front end),
    else in fp32."""
    dtype = torch.float64 if waveform.dtype == torch.float64 else torch.float32
    x = waveform.to(dtype)
    half = n_fft // 2
    x = torch.nn.functional.pad(x[:, None], (half, half), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop)                            # [B, T, n_fft]
    window = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)
    ).to(device=x.device, dtype=dtype)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = (spec.real.square() + spec.imag.square())[:, :-1, :]
    mel = torch.from_numpy(_mel_slaney(n_mels, n_fft, 16000)).to(device=x.device, dtype=dtype)
    logspec = torch.log10(torch.clamp(power @ mel, min=1e-10))
    peak = logspec.amax(dim=(1, 2), keepdim=True)
    logspec = torch.maximum(logspec, peak - 8.0)
    return ((logspec + 4.0) / 4.0).transpose(1, 2).float()
