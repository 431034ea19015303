"""Audio export of DAS channels (the port's copy of
``das4whales_tpu.utils.audio``; host numpy and the stdlib ``wave``).

The reference tutorial plays a filtered channel with
``IPython.display.Audio(data=trf_fk[idx, :], rate=fs*5)`` — deliberate 5x
time compression so 15-30 Hz fin-whale calls land in the audible band
(SURVEY.md §3.4). This module provides that capability as a file export
with no IPython/soundfile dependency: normalized 16-bit PCM WAV via the
stdlib ``wave`` module.
"""

from __future__ import annotations

import wave

import numpy as np


def channel_to_pcm16(channel, normalize: bool = True) -> np.ndarray:
    """Scale a strain channel to int16 PCM samples."""
    x = np.asarray(channel, dtype=np.float64)
    if normalize:
        peak = np.max(np.abs(x))
        if peak > 0:
            x = x / peak
    x = np.clip(x, -1.0, 1.0)
    return (x * 32767.0).astype(np.int16)


def export_audio(channel, fs: float, path: str, speed: float = 5.0,
                 normalize: bool = True) -> str:
    """Write one channel as a WAV file at ``fs * speed`` playback rate.

    ``speed=5`` reproduces the tutorial's audible time compression.
    Returns the path written.
    """
    pcm = channel_to_pcm16(channel, normalize=normalize)
    rate = int(round(fs * speed))
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return path


def read_audio(path: str):
    """Read back a mono 16-bit WAV written by :func:`export_audio`.

    Returns ``(samples_float64_in_[-1,1], rate_hz)``.
    """
    with wave.open(path, "rb") as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
    return pcm.astype(np.float64) / 32767.0, rate
