"""MFCC feature extraction (host-side, numpy).

Copy of gesturediffusion_tpu/ops/mfcc.py (hz2mel, mel2hz, mel_filterbank,
frame_signal, mfcc, mfcc_for_window) for the port, which imports nothing of
the JAX package: ``python_speech_features.mfcc`` as the reference gesture
dataset calls it (winlen 0.06, winstep 1 / fps, 22050 Hz, numcep 27, nfft
5000; nfilt 26, preemph 0.97, ceplifter 22, the energy in column 0,
rectangular window).  With numcep > nfilt the DCT yields nfilt
coefficients, so the reference's "27" MFCCs are 26 columns (mfcc_dim 26).
Pre-emphasis runs in float64 and frame sizes round half up, as the
reference's; the same code as the JAX package's, so the same features.
"""

from __future__ import annotations

import numpy as np
from scipy.fftpack import dct


def hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank(
    nfilt: int, nfft: int, samplerate: float, lowfreq: float = 0.0,
    highfreq: float | None = None,
) -> np.ndarray:
    """Triangular mel filterbank [nfilt, nfft//2 + 1]."""
    highfreq = highfreq or samplerate / 2.0
    melpoints = np.linspace(hz2mel(lowfreq), hz2mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel2hz(melpoints) / samplerate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank


def frame_signal(signal: np.ndarray, frame_len: int, frame_step: int) -> np.ndarray:
    """Split a 1-D signal into overlapping frames, zero-padding the tail."""
    slen = len(signal)
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(np.ceil((slen - frame_len) / frame_step))
    padlen = (numframes - 1) * frame_step + frame_len
    padded = np.concatenate([signal, np.zeros(padlen - slen)])
    indices = (
        np.tile(np.arange(frame_len), (numframes, 1))
        + np.tile(np.arange(0, numframes * frame_step, frame_step), (frame_len, 1)).T
    )
    return padded[indices]


def mfcc(
    signal: np.ndarray,
    samplerate: float = 22050,
    winlen: float = 0.06,
    winstep: float = 1.0 / 30,
    numcep: int = 27,
    nfilt: int = 26,
    nfft: int = 5000,
    lowfreq: float = 0.0,
    highfreq: float | None = None,
    preemph: float = 0.97,
    ceplifter: int = 22,
    append_energy: bool = True,
) -> np.ndarray:
    """MFCCs [num_frames, min(numcep, nfilt)] of a mono signal."""
    signal = np.asarray(signal, np.float64)
    if preemph:
        # float64 on purpose: bit-parity with python_speech_features
        signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])

    # round-HALF-UP like python_speech_features.sigproc (decimal
    # ROUND_HALF_UP): Python's round() banker's-rounds, which shifts
    # every frame boundary by one sample for half-sample params (e.g.
    # winstep=1/20 @ 22050 Hz -> 1102 vs the reference's 1103)
    frame_len = int(np.floor(winlen * samplerate + 0.5))
    frame_step = int(np.floor(winstep * samplerate + 0.5))
    frames = frame_signal(signal, frame_len, frame_step)

    # power spectrum over nfft bins
    mag = np.abs(np.fft.rfft(frames, nfft))
    pspec = (1.0 / nfft) * (mag**2)
    energy = np.sum(pspec, axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)

    fb = mel_filterbank(nfilt, nfft, samplerate, lowfreq, highfreq)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = np.log(feat)

    feat = dct(feat, type=2, axis=1, norm="ortho")[:, :numcep]

    if ceplifter > 0:
        n = np.arange(feat.shape[1])
        lift = 1 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter)
        feat = feat * lift

    if append_energy:
        feat[:, 0] = np.log(energy)
    return feat


def mfcc_for_window(
    audio: np.ndarray,
    *,
    fps: float = 30,
    samplerate: float = 22050,
    numcep: int = 27,
    nfft: int = 5000,
    winlen: float = 0.06,
) -> np.ndarray:
    """MFCCs aligned to motion frames at `fps` (one feature row per frame)."""
    return mfcc(
        audio,
        samplerate=samplerate,
        winlen=winlen,
        winstep=1.0 / fps,
        numcep=numcep,
        nfft=nfft,
    ).astype(np.float32)
