"""Time correlation of the video motion track against the flight log.

Reference video/correlate.py:14-120 ``sync_clocks``: resample both signals
to a common rate (60 Hz), 2nd-order Butterworth low-pass at 10 Hz, full
cross-correlation, argmax → time shift; then axis-ratio scale estimation
between the movie's (pitch, yaw) proxies and the logged q/r rates.

Port of the JAX package's ``video/correlate.py``. The cross-correlation
runs as a float32 FFT product on the given device (np.correlate's O(N²)
full mode becomes O(N log N)), at the reference's power-of-two length;
everything else is small host math, a copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import checked


def _resample(times, values, hz):
    times = np.asarray(times, float)
    values = np.asarray(values, float)
    t0, t1 = times.min(), times.max()
    n = max(int(round((t1 - t0) * hz)), 2)
    grid = np.linspace(t0, t1, n)
    return grid, np.interp(grid, times, values)


def _butter_filtfilt(x, wn=10.0 / (200.0 / 2), order=2):
    import scipy.signal as signal

    b, a = signal.butter(order, wn)
    return signal.filtfilt(b, a, x)


def cross_correlate_full(a, b, device="cuda"):
    """np.correlate(a, b, mode='full') via FFT on device."""
    dev = checked(device, "cross_correlate_full")
    n = len(a) + len(b) - 1
    nfft = 1 << (n - 1).bit_length()
    ta = torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    tb = torch.as_tensor(np.ascontiguousarray(b[::-1], np.float32),
                         device=dev)
    fa = torch.fft.rfft(ta, nfft)
    fb = torch.fft.rfft(tb, nfft)
    return torch.fft.irfft(fa * fb, nfft)[:n].cpu().numpy()


def sync_clocks(flight_times, flight_gyro, movie_times, movie_rot, hz=60,
                smooth=True, device="cuda"):
    """Returns (time_shift, correlation): movie_time + time_shift ≈
    flight_time (reference correlate.py:90-100 sign conventions)."""
    device = checked(device, "sync_clocks")
    ft, fv = _resample(flight_times, flight_gyro, hz)
    mt, mv = _resample(movie_times, movie_rot, hz)
    if smooth:
        fv = _butter_filtfilt(fv)
        mv = _butter_filtfilt(mv)
    ycorr = cross_correlate_full(fv, mv, device)
    movie_len = mt[-1] - mt[0]
    shift_sec = np.argmax(ycorr) / hz - movie_len
    start_diff = ft[0] - mt[0]
    time_shift = start_diff + shift_sec
    return float(time_shift), ycorr


def estimate_ratios(flight_times, flight_q, flight_r, movie_times, movie_ty,
                    movie_tx, time_shift, hz=60):
    """|movie|/|flight| amplitude ratios over the overlap window (reference
    correlate.py:101-120) — used to scale pixel translations to rates."""
    tmin = max(np.min(movie_times) + time_shift, np.min(flight_times))
    tmax = min(np.max(movie_times) + time_shift, np.max(flight_times))
    if tmax <= tmin:
        return 1.0, 1.0
    grid = np.linspace(tmin, tmax, max(int(round((tmax - tmin) * hz)), 2))
    mq = np.abs(np.interp(grid - time_shift, movie_times, movie_ty)).sum()
    mr = np.abs(np.interp(grid - time_shift, movie_times, movie_tx)).sum()
    fq = np.abs(np.interp(grid, flight_times, flight_q)).sum()
    fr = np.abs(np.interp(grid, flight_times, flight_r)).sum()
    qratio = mq / fq if fq > 1e-3 else 1.0
    rratio = -mr / fr if fr > 1e-3 else 1.0
    return float(qratio), float(rratio)
