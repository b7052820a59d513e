"""BSS-eval v4 metrics (SDR/ISR/SIR/SAR), museval-compatible.

Port of xumx_slicq_tpu/ops/bsseval.py. BSS Eval v4 (Stoter et al., SiSEC
2018) fits time-invariant 512-tap least-squares distortion filters over the
whole track, then forms energy ratios over 1 s windows and takes medians.

Decomposition of an estimate e for target j (bss_eval images):
    s_true  = reference image s_j
    e_spat  = P_j(e) - s_j       (projection onto delayed copies of s_j)
    e_interf= P_all(e) - P_j(e)  (projection onto all references)
    e_artif = e - P_all(e)
Framewise ratios (per 1 s window w):
    SDR = 10log10 ||s_true||^2 / ||e_spat+e_interf+e_artif||^2
    ISR = 10log10 ||s_true||^2 / ||e_spat||^2
    SIR = 10log10 ||s_true+e_spat||^2 / ||e_interf||^2
    SAR = 10log10 ||s_true+e_spat+e_interf||^2 / ||e_artif||^2
Aggregation: median over windows per track (museval EvalStore), median over
tracks per target.

Two engines:
- the host engine (`bss_eval_images`, `eval_track`): a NumPy/SciPy copy of
  the JAX package's float64 engine (bsseval.py:25-340). The JAX package's
  `use_jax=True` branches, which ran its FFTs and solves through jnp, are
  left out: the card engine below takes their place.
- `DeviceBssEval`: the same blocked overlap-save math in PyTorch on an
  explicit device (bsseval.py:343-563), in float32: cuFFT for the FFTs,
  cuBLAS for the correlation and filter products, cuSOLVER for the
  Cholesky solves. Only seven (nsrc, nwin) energy arrays come back to the
  host, where the dB ratios are formed in float64.
"""

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..audio import apply_pcm_scale, pcm_scale_info
from ..device import resolve_device, use_device

METRICS = ["SDR", "ISR", "SIR", "SAR"]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# Blocked (overlap-save) path: the whole-track filters only need lags
# |tau| < flen, so instead of one 2^ceil(log2(N))-point FFT per signal the
# correlations and convolutions accumulate over short blocks with batched
# _BLK_NFFT-point FFTs. Exact, not an approximation: every product pair
# lands in an unaliased region.
_BLK_NFFT = 8192


def _rfft(x, n, axis=-1):
    import scipy.fft as sfft

    return sfft.rfft(x, n, axis=axis)


def _irfft(x, n):
    import scipy.fft as sfft

    return sfft.irfft(x, n)


class _BlockedBss:
    """Blocked-FFT engine for one track's whole-track filters.

    The three forward FFT banks (reference a-blocks, reference b-blocks,
    estimate b-blocks) are computed once and shared by the Gram and
    cross-correlation stage and by every filter application. a-blocks
    (K, nb, Lb) tile the signal; b-block i is the nfft-long window starting
    at sample i*Lb (a-block i plus the head of block i+1, a strided view of
    one padded copy), so sum_i <a_i, b_i[.+lam]> is the full-signal
    correlation at lags 0..flen-1: a-blocks are zero-padded Lb -> nfft by
    the FFT, so no product wraps for lam < flen."""

    def __init__(self, R: np.ndarray, E: np.ndarray, flen: int):
        K, N = R.shape
        self.flen, self.N = flen, N
        self.nfft = nfft = _BLK_NFFT
        self.Lb = Lb = nfft - flen
        self.nb = -(-N // Lb)
        pR = self._pad(R)  # one padded copy shared by the a-view and b-view
        a_R = pR[:, : self.nb * Lb].reshape(K, self.nb, Lb)
        self.FA = _rfft(a_R, nfft)                       # (K, nb, F)
        self.FBr = _rfft(self._bview(pR), nfft)
        self.FBe = _rfft(self._bview(self._pad(E)), nfft)

    def _pad(self, x):
        out = np.zeros((x.shape[0], self.nb * self.Lb + self.flen), np.float64)
        out[:, : x.shape[1]] = x
        return out

    def _bview(self, p):
        s0, s1 = p.strides
        return np.lib.stride_tricks.as_strided(
            p, (p.shape[0], self.nb, self.nfft), (s0, self.Lb * s1, s1),
            writeable=False,
        )

    def correlations(self):
        """(G, D) with the same contract as `_correlations`."""
        K, flen, nfft = self.FA.shape[0], self.flen, self.nfft
        CA = np.conj(self.FA)
        Srr = np.einsum("knf,lnf->klf", CA, self.FBr, optimize=True)
        Sre = np.einsum("knf,lnf->klf", CA, self.FBe, optimize=True)
        # positive lags 0..flen-1: r_rr[k,l,lam] = sum_n R[k,n] R[l,n+lam]
        r_rr = _irfft(Srr, nfft)[..., :flen]
        r_re = _irfft(Sre, nfft)[..., :flen]
        # full lag axis -(flen-1)..flen-1 via r[k,l,-lam] = r[l,k,lam]
        full = np.concatenate(
            [r_rr.transpose(1, 0, 2)[..., 1:][..., ::-1], r_rr], axis=-1
        )                                                # (K, K, 2*flen-1)
        lags = np.arange(flen)
        lag_mat = lags[:, None] - lags[None, :] + (flen - 1)
        G = full[:, :, lag_mat]                          # (K, K, flen, flen)
        G = G.transpose(0, 2, 1, 3).reshape(K * flen, K * flen)
        D = r_re.transpose(0, 2, 1).reshape(K * flen, -1)
        return G, D

    def apply(self, coeffs: np.ndarray, rows=slice(None)):
        """Filter-and-sum over the `rows`-selected reference channels,
        reusing their cached a-block FFTs: coeffs (k*flen, E) -> (E, N)."""
        FA = self.FA[rows]
        k = FA.shape[0]
        E = coeffs.shape[1]
        flen, nfft, Lb, nb = self.flen, self.nfft, self.Lb, self.nb
        c = coeffs.reshape(k, flen, E)
        FC = _rfft(c, nfft, axis=1)                      # (k, F, E)
        Y = np.einsum("knf,kfe->enf", FA, FC, optimize=True)
        y = _irfft(Y, nfft)                              # (E, nb, nfft)
        # overlap-add: block i's tail [Lb, Lb+flen-1) lands at (i+1)*Lb;
        # the last block's tail falls past nb*Lb >= N and is dropped.
        out = y[..., :Lb].reshape(E, nb * Lb)            # fresh array (copy)
        out[:, Lb:].reshape(E, nb - 1, Lb)[..., : flen - 1] += \
            y[:, :-1, Lb: Lb + flen - 1]
        return out[:, : self.N]


def _correlations(refs: np.ndarray, ests: np.ndarray, flen: int):
    """FFT cross-correlations.

    refs: (K, N) flattened (src*chan) references
    ests: (E, N) flattened estimate channels
    Returns (G, D):
      G[(k,tau),(k2,tau2)] = sum_n refs[k, n-tau] refs[k2, n-tau2]
      D[(k,tau), e]        = sum_n refs[k, n-tau] ests[e, n]
    """
    K, N = refs.shape
    n2 = _next_pow2(N + flen - 1)
    rf = np.fft.rfft(refs, n2)
    ef = np.fft.rfft(ests, n2)
    cross_rr = np.fft.irfft(rf[:, None].conj() * rf[None, :], n2)   # (K,K,n2)
    cross_re = np.fft.irfft(rf[:, None].conj() * ef[None, :], n2)   # (K,E,n2)

    # G[(k,tau),(k2,tau2)] = <s_k[.-tau], s_k2[.-tau2]> = r_{k,k2}[tau - tau2]
    lags = np.arange(flen)
    lag_mat = (lags[:, None] - lags[None, :]) % n2           # (flen, flen): tau - tau2
    G = cross_rr[:, :, lag_mat]                              # (K,K,flen,flen)
    G = G.transpose(0, 2, 1, 3).reshape(K * flen, K * flen)
    # D[(k,tau), e] = sum_n refs[k, n-tau] ests[e, n] = cross_re[k, e, tau]
    D = cross_re[:, :, :flen]                                # (K,E,flen)
    D = D.transpose(0, 2, 1).reshape(K * flen, -1)
    return G, D


def _apply_filters(refs: np.ndarray, coeffs: np.ndarray, flen: int, N: int):
    """Filter-and-sum: coeffs (K*flen, E) applied to refs (K, N) -> (E, N)."""
    K = refs.shape[0]
    E = coeffs.shape[1]
    n2 = _next_pow2(N + flen - 1)
    c = coeffs.reshape(K, flen, E)
    rf = np.fft.rfft(refs, n2)
    cf = np.fft.rfft(c, n2, axis=1)
    return np.fft.irfft(np.einsum("kf,kfe->ef", rf, cf), n2)[:, :N]


def _solve(G: np.ndarray, D: np.ndarray) -> np.ndarray:
    import scipy.linalg as sl

    reg = 1e-10 * np.trace(G) / G.shape[0] if G.shape[0] else 0.0
    A = G + reg * np.eye(G.shape[0])
    return sl.solve(A, D, assume_a="pos")


def bss_eval_images(
    reference_sources: np.ndarray,
    estimated_sources: np.ndarray,
    window: int = 44100,
    hop: int = 44100,
    filters_len: int = 512,
):
    """BSS-eval v4 with whole-track filters + framewise ratios, in float64.

    reference_sources/estimated_sources: (nsrc, nsampl, nchan).
    Returns dict of metric -> (nsrc, nwin) arrays."""
    refs = np.asarray(reference_sources, np.float64)
    ests = np.asarray(estimated_sources, np.float64)
    nsrc, N, nchan = refs.shape
    flen = filters_len

    R = refs.transpose(0, 2, 1).reshape(nsrc * nchan, N)     # (K, N)
    E = ests.transpose(0, 2, 1).reshape(nsrc * nchan, N)

    plan = None
    if N > _BLK_NFFT and flen <= _BLK_NFFT // 4:
        plan = _BlockedBss(R, E, flen)
        G, D = plan.correlations()
    else:
        G, D = _correlations(R, E, flen)

    def apply(coeffs, rows=slice(None)):
        if plan is not None:
            return plan.apply(coeffs, rows)
        return _apply_filters(R[rows], coeffs, flen, N)

    # projection onto ALL references, for every estimate channel
    C_all = _solve(G, D)                                     # (K*flen, nsrc*nchan)
    P_all = apply(C_all)                                     # (nsrc*nchan, N)

    # projection of estimate j onto reference j only
    P_self = np.zeros_like(E)
    for j in range(nsrc):
        rows = slice(j * nchan * flen, (j + 1) * nchan * flen)
        cols = slice(j * nchan, (j + 1) * nchan)
        Cj = _solve(G[rows, rows], D[rows, cols])            # (nchan*flen, nchan)
        P_self[cols] = apply(Cj, cols)

    # decompositions per source (nsrc, nchan, N); the error components
    # telescope, so each energy operand is a single difference (or a
    # projection directly): dist = e - s_true, ts = s_true + e_spat =
    # p_self, tsi = s_true + e_spat + e_interf = p_all.
    s_true = refs.transpose(0, 2, 1)
    p_self = P_self.reshape(nsrc, nchan, N)
    p_all = P_all.reshape(nsrc, nchan, N)
    e_est = E.reshape(nsrc, nchan, N)

    # framewise energy ratios (museval: clips shorter than one window get
    # one partial window)
    nwin = max((N - window) // hop + 1, 1)

    def frame_energy(x):
        # (nsrc, nchan, N) -> (nsrc, nwin) summed over chan+win
        if hop == window and nwin * window <= N:
            xw = x[..., : nwin * window].reshape(nsrc, nchan, nwin, window)
            return np.einsum("scwt,scwt->sw", xw, xw)
        out = np.empty((nsrc, nwin))
        for w in range(nwin):
            seg = x[..., w * hop: w * hop + window]
            out[:, w] = np.sum(seg ** 2, axis=(1, 2))
        return out

    return _ratios(
        frame_energy(s_true), frame_energy(p_self - s_true), frame_energy(p_all - p_self),
        frame_energy(e_est - p_all), frame_energy(e_est - s_true), frame_energy(p_self),
        frame_energy(p_all),
    )


def _ratios(Es_true, Es_spat, Es_interf, Es_artif, Es_dist, Es_ts, Es_tsi) -> dict:
    """The four dB ratios from the seven framewise energies, in float64."""
    eps = np.finfo(np.float64).eps

    def db(num, den):
        return 10.0 * np.log10((num + eps) / (den + eps))

    return {
        "SDR": db(Es_true, Es_dist),
        "ISR": db(Es_true, Es_spat),
        "SIR": db(Es_ts, Es_interf),
        "SAR": db(Es_tsi, Es_artif),
    }


# ---------------------------------------------------------------------------
# the engine on the card
# ---------------------------------------------------------------------------

_FP32_LOCK = threading.Lock()
_FP32_USERS = [0, False]   # engine calls in flight, the TF32 flag they found


@contextmanager
def _full_fp32():
    """cuBLAS in full fp32 (no TF32) while any engine call runs: the
    correlation and filter products sum ~10^7 samples, and the JAX engine
    pins them to Precision.HIGHEST. A caller may have allowed TF32 for the
    CDAE's matmuls; the flag is process-wide, so it is switched off by the
    first call in flight and restored by the last."""
    with _FP32_LOCK:
        if _FP32_USERS[0] == 0:
            _FP32_USERS[1] = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _FP32_USERS[0] += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _FP32_USERS[0] -= 1
            if _FP32_USERS[0] == 0:
                torch.backends.cuda.matmul.allow_tf32 = _FP32_USERS[1]


class DeviceBssEval:
    """BSS-eval v4 on a device, in float32: the blocked overlap-save
    pipeline of the host engine (FFT banks, Gram and cross-correlations,
    Cholesky solves, filter applications, framewise energies) in PyTorch.
    Only the seven (nsrc, nwin) energy arrays come back to the host, where
    the dB ratios are formed in float64; estimates already on the card
    never leave it.

    Numerics: the Gram ridge is 1e-7*trace/n (the host engine's is 1e-10)
    so that the float32 Cholesky stays positive definite on real signals.
    Where it does not, `torch.linalg.cholesky_ex` reports it without a host
    sync and the scores come out NaN, the caller's cue to rescore on the
    float64 host engine (`eval_track_device`, which counts each such
    fall-back in `fallbacks`).

    Shape bucketing, as in the JAX engine: signals are zero-padded so the
    block count nb rounds up to a multiple of `nb_round` (a power of two
    below it). Exact, not approximate: zero samples add nothing to the
    correlations, the projections are masked to the true length, and
    windows past it are dropped on the host. The JAX engine buckets to bound
    its XLA compiles; here it keeps the same shapes, so that the two engines
    do the same work. The JAX engine's jit cache, its lock and
    `trace_counts` exist only for XLA's compiles and have no counterpart.

    `device` is where host (numpy) inputs are staged; tensors already on a
    device are scored there. One engine may serve several threads."""

    def __init__(self, window: int = 44100, hop: int = 44100,
                 filters_len: int = 512, nb_round: int = 128, device="cuda"):
        if hop != window:
            raise NotImplementedError("device engine assumes hop == window (museval v4 default)")
        self.window, self.hop, self.flen = window, hop, filters_len
        self.nfft = _BLK_NFFT
        self.Lb = self.nfft - filters_len
        self.nb_round = nb_round
        self.device = resolve_device(device)
        self.fallbacks = 0       # host rescorings of non-finite scores (eval_track_device)
        self._count_lock = threading.Lock()

    def count_fallback(self):
        with self._count_lock:
            self.fallbacks += 1

    def padded_blocks(self, n: int) -> int:
        """The bucketed block count for n samples: multiples of nb_round
        for long tracks, the next power of two for short ones (a 30 s clip
        must not pad to a full track's shape)."""
        nb = -(-n // self.Lb)
        return -(-nb // self.nb_round) * self.nb_round if nb >= self.nb_round else _next_pow2(nb)

    # -- the device program ---------------------------------------------------

    def _solve_pos(self, G: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
        """(..., n, n) Gram, (..., n, e) right sides -> G^-1 D by Cholesky,
        NaN where the ridged Gram is not positive definite in float32."""
        n = G.shape[-1]
        reg = 1e-7 * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / n
        A = G + reg[..., None, None] * torch.eye(n, dtype=G.dtype, device=G.device)
        L, info = torch.linalg.cholesky_ex(A)
        y = torch.linalg.solve_triangular(L, D, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return torch.where((info == 0)[..., None, None], x, torch.full_like(x, float("nan")))

    def _apply_filters(self, FA: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
        """Filter-and-sum for g groups: FA (g, k, nb, F) spectra of the
        reference a-blocks, coeffs (g, k*flen, e) -> (g, e, nb*Lb)."""
        g, k, nb, _ = FA.shape
        e = coeffs.shape[-1]
        flen, nfft, Lb = self.flen, self.nfft, self.Lb
        FC = torch.fft.rfft(coeffs.reshape(g, k, flen, e), nfft, dim=2)   # (g, k, F, e)
        Y = torch.einsum("gknf,gkfe->genf", FA, FC)
        y = torch.fft.irfft(Y, nfft)                                       # (g, e, nb, nfft)
        # overlap-save tail: block i's samples [Lb, Lb+flen-1) land at
        # (i+1)*Lb; the last block's tail falls past nb*Lb and is dropped
        out = y[..., :Lb].contiguous()
        out[:, :, 1:, : flen - 1] += y[:, :, :-1, Lb: Lb + flen - 1]
        return out.reshape(g, e, nb * Lb)

    def _energies(self, R: torch.Tensor, E: torch.Tensor, n_true: int, nchan: int):
        """R, E: (K, nb*Lb + flen) float32, zero-padded past n_true.
        Returns the 7 (nsrc, nwin_all) float32 energy arrays."""
        flen, nfft, Lb, window = self.flen, self.nfft, self.Lb, self.window
        K = R.shape[0]
        nb = (R.shape[1] - flen) // Lb
        Npad = nb * Lb
        nsrc = K // nchan
        nwin_all = max(Npad // window, 1)

        aR = R[:, :Npad].reshape(K, nb, Lb)
        FA = torch.fft.rfft(aR, nfft)                                      # (K, nb, F)
        # b-block i = a-block i ++ the first flen samples of block i+1
        # (the last one's head is the flen-sample margin): windows of
        # nfft samples every Lb samples of the padded signal
        FBr = torch.fft.rfft(R.unfold(1, nfft, Lb), nfft)
        FBe = torch.fft.rfft(E.unfold(1, nfft, Lb), nfft)
        CA = FA.conj()
        r_rr = torch.fft.irfft(torch.einsum("knf,lnf->klf", CA, FBr), nfft)[..., :flen]
        r_re = torch.fft.irfft(torch.einsum("knf,lnf->klf", CA, FBe), nfft)[..., :flen]
        del FBr, FBe, CA
        # full lag axis -(flen-1)..flen-1 via r[k,l,-lam] = r[l,k,lam]
        full = torch.cat([torch.flip(r_rr.transpose(0, 1)[..., 1:], dims=(-1,)), r_rr], dim=-1)
        lags = torch.arange(flen, device=R.device)
        lag_mat = lags[:, None] - lags[None, :] + (flen - 1)               # (flen, flen)
        G = full[:, :, lag_mat].permute(0, 2, 1, 3).reshape(K * flen, K * flen)
        D = r_re.permute(0, 2, 1).reshape(K * flen, K)
        del full

        # the projections ring out flen-1 samples past the true length,
        # which must not leak into a partial last window
        valid = (torch.arange(Npad, device=R.device) < n_true).to(R.dtype)
        P_all = self._apply_filters(FA[None], self._solve_pos(G, D)[None])[0] * valid

        # each source's own channels: nsrc solves of (nchan*flen)^2, batched
        m = nchan * flen
        Gj = torch.stack([G[j * m:(j + 1) * m, j * m:(j + 1) * m] for j in range(nsrc)])
        Dj = torch.stack([D[j * m:(j + 1) * m, j * nchan:(j + 1) * nchan] for j in range(nsrc)])
        del G, D
        P_self = self._apply_filters(FA.reshape(nsrc, nchan, nb, -1), self._solve_pos(Gj, Dj))
        P_self = P_self.reshape(K, Npad) * valid

        s_true = R[:, :Npad].reshape(nsrc, nchan, Npad)
        e_est = E[:, :Npad].reshape(nsrc, nchan, Npad)
        p_self = P_self.reshape(nsrc, nchan, Npad)
        p_all = P_all.reshape(nsrc, nchan, Npad)

        def frame_energy(x):
            win_n = min(nwin_all * window, Npad)
            xw = x[..., :win_n]
            if win_n < nwin_all * window:     # one partial window
                xw = torch.nn.functional.pad(xw, (0, nwin_all * window - win_n))
            xw = xw.reshape(nsrc, nchan, nwin_all, window)
            return xw.square().sum(dim=(1, 3))

        return (
            frame_energy(s_true),
            frame_energy(p_self - s_true),
            frame_energy(p_all - p_self),
            frame_energy(e_est - p_all),
            frame_energy(e_est - s_true),
            frame_energy(p_self),
            frame_energy(p_all),
        )

    # -- host-facing API ------------------------------------------------------

    def stage(self, x, device=None) -> torch.Tensor:
        """(nsrc, nsampl, nchan) numpy array or tensor, float or raw PCM
        ints -> float32 on the device (a tensor stays on its own device).
        The dtype is checked before the copy; ints cross the link as they
        are and are scaled on the device."""
        pcm_scale_info(x.dtype)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x)).to(device or self.device)
        return apply_pcm_scale(x)

    def __call__(self, reference_sources, estimated_sources):
        """reference_sources/estimated_sources: (nsrc, nsampl, nchan), numpy
        arrays or tensors, float or raw PCM ints (unsupported dtypes raise,
        as in the host loader). Returns dict metric -> (nsrc, nwin)
        float64, museval semantics."""
        dev = next((x.device for x in (reference_sources, estimated_sources) if isinstance(x, torch.Tensor)),
                   self.device)
        use_device(dev)
        with torch.inference_mode(), _full_fp32():
            def flatten(x):
                x = self.stage(x, dev)
                nsrc, N, nchan = x.shape
                return x.permute(0, 2, 1).reshape(nsrc * nchan, N), N, nchan

            R, N, nchan = flatten(reference_sources)
            E, Ne, _ = flatten(estimated_sources)
            n = min(N, Ne)
            pad = self.padded_blocks(n) * self.Lb + self.flen - n
            R = torch.nn.functional.pad(R[:, :n], (0, pad))
            E = torch.nn.functional.pad(E[:, :n], (0, pad))
            energies = self._energies(R, E, n, nchan)
            host = torch.stack(energies).cpu().double().numpy()           # one copy back
        nwin = max((n - self.window) // self.hop + 1, 1)
        return _ratios(*(e[:, :nwin] for e in host))


def fast_sdr(track_estimate: np.ndarray, track_reference: np.ndarray, eps: float = 1e-10) -> float:
    """Simple energy-ratio SDR (reference slicqfinder.py:20-40): the cheap
    metric used for sliCQT param search, not BSS-eval."""
    num = np.sum(track_reference ** 2)
    den = np.sum((track_reference - track_estimate) ** 2)
    return float(10.0 * np.log10((num + eps) / (den + eps)))


# ---------------------------------------------------------------------------
# museval-style aggregation
# ---------------------------------------------------------------------------


@dataclass
class TrackScores:
    name: str
    targets: Dict[str, Dict[str, np.ndarray]]  # target -> metric -> (nwin,)

    def median_scores(self) -> Dict[str, Dict[str, float]]:
        return {
            t: {m: float(np.nanmedian(v)) for m, v in ms.items()}
            for t, ms in self.targets.items()
        }

    def __str__(self):
        lines = [self.name]
        for t, ms in self.median_scores().items():
            vals = "  ".join(f"{m}:{v:7.3f}" for m, v in ms.items())
            lines.append(f"  {t:8s} ==> {vals}")
        return "\n".join(lines)


@dataclass
class EvalStore:
    """Median-over-windows then median-over-tracks aggregation
    (museval.EvalStore semantics)."""

    tracks: List[TrackScores] = field(default_factory=list)

    def add_track(self, track: TrackScores):
        self.tracks.append(track)

    def agg_frames_tracks_scores(self) -> Dict[str, Dict[str, float]]:
        if not self.tracks:
            return {}
        targets = self.tracks[0].targets.keys()
        out = {}
        for t in targets:
            out[t] = {}
            for m in METRICS:
                per_track = [np.nanmedian(tr.targets[t][m]) for tr in self.tracks]
                out[t][m] = float(np.nanmedian(per_track))
        return out

    def total_sdr(self) -> float:
        agg = self.agg_frames_tracks_scores()
        return float(np.mean([v["SDR"] for v in agg.values()]))

    def __str__(self):
        agg = self.agg_frames_tracks_scores()
        lines = ["Aggregated Scores (median over frames, median over tracks)"]
        for t, ms in agg.items():
            vals = "  ".join(f"{m}:{v:7.3f}" for m, v in ms.items())
            lines.append(f"{t:8s} ==> {vals}")
        if agg:
            lines.append(f"total SDR: {self.total_sdr():.3f} dB")
        return "\n".join(lines)


def _stack_broadcast(refs, ests):
    """Mono references against stereo estimates (a mono source tree: the
    separator repeats the mixture to stereo, references stay 1-channel) or
    the other way round: repeat the mono side so both flatten to the same
    src*chan row count."""
    if refs.shape[2] == 1 and ests.shape[2] > 1:
        refs = refs.repeat_interleave(ests.shape[2], 2) if isinstance(refs, torch.Tensor) \
            else np.repeat(refs, ests.shape[2], axis=2)
    elif ests.shape[2] == 1 and refs.shape[2] > 1:
        ests = ests.repeat_interleave(refs.shape[2], 2) if isinstance(ests, torch.Tensor) \
            else np.repeat(ests, refs.shape[2], axis=2)
    return refs, ests


def eval_track(
    references: Dict[str, np.ndarray],
    estimates: Dict[str, np.ndarray],
    track_name: str = "",
    window: int = 44100,
    hop: int = 44100,
) -> TrackScores:
    """Evaluate one track on the host engine. references/estimates:
    {target: (nsampl, nchan)}."""
    targets = list(references.keys())
    refs, ests = _stack_broadcast(np.stack([references[t] for t in targets]),
                                  np.stack([estimates[t] for t in targets]))
    n = min(refs.shape[1], ests.shape[1])
    refs, ests = refs[:, :n], ests[:, :n]
    scores = bss_eval_images(refs, ests, window=window, hop=hop)
    return TrackScores(
        name=track_name,
        targets={t: {m: scores[m][i] for m in METRICS} for i, t in enumerate(targets)},
    )


def eval_track_device(
    references,
    estimates,
    engine: DeviceBssEval,
    track_name: str = "",
) -> TrackScores:
    """eval_track on `engine`: references/estimates {target: (nsampl,
    nchan)} numpy arrays or tensors, float or raw PCM ints. A mono side is
    repeated on the device, so staged bytes stay halved for mono sources.
    Where the float32 Cholesky leaves scores non-finite, the track is
    rescored on the float64 host engine (the JAX package's rule) and
    `engine.fallbacks` counts it."""
    targets = list(references.keys())
    # the dtype check runs on the source arrays, before anything is staged
    for v in list(references.values()) + list(estimates.values()):
        pcm_scale_info(v.dtype)

    def stacked(d):
        xs = [d[t] for t in targets]
        dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), engine.device)
        use_device(dev)
        return torch.stack([engine.stage(x, dev) for x in xs])

    refs, ests = _stack_broadcast(stacked(references), stacked(estimates))
    scores = engine(refs, ests)
    if not all(np.all(np.isfinite(v)) for v in scores.values()):
        engine.count_fallback()

        def host(x):
            return apply_pcm_scale(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)

        return eval_track({t: host(references[t]) for t in targets},
                          {t: host(estimates[t]) for t in targets},
                          track_name=track_name, window=engine.window, hop=engine.hop)
    return TrackScores(
        name=track_name,
        targets={t: {m: scores[m][i] for m in METRICS} for i, t in enumerate(targets)},
    )
