"""Measured (Fourier-basis) BSDF tables (port of pbrt_tpu/scene/fourier.py).

Counterpart of ``materials/fourier.{h,cpp}``, ``FourierBSDF::f``
(core/reflection.cpp) and the Catmull–Rom weights of
``core/interpolation.{h,cpp}``: ``read_bsdf`` reads the layerlab
'SCATFUN' v1 binary format (header at materials/fourier.cpp:44-90) into
dense tables, ``write_bsdf`` writes one, and ``eval_fourier`` evaluates
f(wo, wi) batched over shading points. Each series is padded to the
table's mMax, so the sum is a fixed loop of mMax masked terms.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch


@dataclasses.dataclass
class FourierTable:
    mu: torch.Tensor        # (nMu,) elevation grid
    a_dense: torch.Tensor   # (nMu, nMu, nChannels, mMax) padded coefficients
    m: torch.Tensor         # (nMu, nMu) int32 series lengths
    cdf: torch.Tensor       # (nMu, nMu)
    eta: torch.Tensor       # ()
    n_channels: int
    m_max: int


def read_bsdf(path: str) -> FourierTable:
    """FourierBSDFTable::Read (materials/fourier.cpp)."""
    with open(path, "rb") as f:
        if f.read(8) != b"SCATFUN\x01":
            raise ValueError(f"{path}: not a SCATFUN v1 file")
        ints = struct.unpack("<9i", f.read(36))
        flags, n_mu, n_coeffs, m_max, n_channels, n_bases = ints[:6]
        eta = struct.unpack("<f", f.read(4))[0]
        f.read(16)  # alpha[2] and two unused words
        if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
            raise ValueError(f"{path}: unsupported SCATFUN variant")
        mu = np.frombuffer(f.read(4 * n_mu), "<f4")
        cdf = np.frombuffer(f.read(4 * n_mu * n_mu), "<f4").reshape(
            n_mu, n_mu)
        off_len = np.frombuffer(f.read(8 * n_mu * n_mu), "<i4").reshape(
            n_mu, n_mu, 2)
        a = np.frombuffer(f.read(4 * n_coeffs), "<f4")
    # dense (nMu, nMu, C, mMax): a series of length m per channel, the
    # channels one after another (GetAk reads ap[c·m + k])
    dense = np.zeros((n_mu, n_mu, n_channels, m_max), np.float32)
    for i in range(n_mu):
        for o in range(n_mu):
            off, mc = off_len[i, o]
            for c in range(n_channels if mc > 0 else 0):
                dense[i, o, c, :mc] = a[off + c * mc: off + (c + 1) * mc]

    def t(x):
        return torch.as_tensor(np.array(x))
    return FourierTable(mu=t(mu), a_dense=t(dense),
                        m=t(off_len[..., 1].astype(np.int32)), cdf=t(cdf),
                        eta=t(np.float32(eta)), n_channels=n_channels,
                        m_max=m_max)


def write_bsdf(path: str, mu, coeffs, eta=1.0):
    """Write a SCATFUN v1 file (the inverse of ``read_bsdf``).
    ``coeffs[i][o]`` is a (C, m) array."""
    n_mu = len(mu)
    n_channels = np.asarray(coeffs[0][0]).shape[0]
    flat = []
    off_len = np.zeros((n_mu, n_mu, 2), np.int32)
    for i in range(n_mu):
        for o in range(n_mu):
            c = np.asarray(coeffs[i][o], np.float32)
            off_len[i, o] = (len(flat), c.shape[1])
            flat.extend(c.reshape(-1).tolist())
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9i", 1, n_mu, len(flat),
                            int(off_len[..., 1].max()), n_channels, 1, 0, 0,
                            0))
        f.write(struct.pack("<f", eta))
        f.write(struct.pack("<4f", 0.0, 0.0, 0.0, 0.0))
        f.write(np.asarray(mu, "<f4").tobytes())
        f.write(np.zeros((n_mu, n_mu), "<f4").tobytes())   # cdf (unused)
        f.write(off_len.astype("<i4").tobytes())
        f.write(np.asarray(flat, "<f4").tobytes())


def catmull_rom_weights(nodes, x):
    """CatmullRomWeights (interpolation.cpp), batched: (offset (R,),
    weights (R,4)), the weights zero where x lies outside the nodes."""
    n = nodes.shape[0]
    valid = (x >= nodes[0]) & (x <= nodes[-1])
    i = torch.clamp(torch.searchsorted(nodes, x.contiguous(), right=True)
                    - 1, 0, n - 2)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    t = (x - x0) / torch.clamp_min(x1 - x0, 1e-12)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    d1 = t3 - 2 * t2 + t
    d2 = t3 - t2
    # the left end: the derivative from the node before, else one-sided
    has_left = i > 0
    x_m1 = nodes[torch.clamp_min(i - 1, 0)]
    wl = d1 * (x1 - x0) / torch.clamp_min(x1 - x_m1, 1e-12)
    w0 = torch.where(has_left, -wl, 0.0)
    w2 = torch.where(has_left, w2 + wl, w2)
    w1 = torch.where(has_left, w1, w1 - d1)
    w2 = torch.where(has_left, w2, w2 + d1)
    # the right end
    has_right = i + 2 < n
    x_p2 = nodes[torch.clamp_max(i + 2, n - 1)]
    wr = d2 * (x1 - x0) / torch.clamp_min(x_p2 - x0, 1e-12)
    w3 = torch.where(has_right, wr, 0.0)
    w1 = torch.where(has_right, w1 - wr, w1 - d2)
    w2 = torch.where(has_right, w2, w2 + d2)
    weights = torch.where(valid[..., None],
                          torch.stack([w0, w1, w2, w3], -1), 0.0)
    # the weights apply to nodes[offset .. offset + 3]
    return i - 1, weights


def fourier_sum(ak, m, cos_phi, m_max: int):
    """Σ_k ak[k]·cos(kφ) by the Chebyshev recurrence cos(kφ) =
    2cosφ·cos((k−1)φ) − cos((k−2)φ) (interpolation.cpp Fourier), each
    lane's series cut at its length m."""
    val = torch.zeros_like(cos_phi)
    c_curr = torch.ones_like(cos_phi)   # cos(0φ)
    c_prev = cos_phi                    # cos(−φ)
    for k in range(m_max):
        val = val + torch.where(k < m, ak[..., k] * c_curr, 0.0)
        c_curr, c_prev = 2.0 * cos_phi * c_curr - c_prev, c_curr
    return val


def eval_fourier(table: FourierTable, wo, wi):
    """FourierBSDF::f (reflection.cpp), batched: local-frame wo, wi (R,3)
    → (R,3) RGB (a one-channel table's value in all three)."""
    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    # CosDPhi(−wi, wo)
    wix, wiy = -wi[..., 0], -wi[..., 1]
    wox, woy = wo[..., 0], wo[..., 1]
    waxy = wix * wix + wiy * wiy
    wbxy = wox * wox + woy * woy
    cos_phi = torch.clamp((wix * wox + wiy * woy)
                          * torch.rsqrt(torch.clamp_min(waxy * wbxy, 1e-20)),
                          -1.0, 1.0)
    cos_phi = torch.where((waxy < 1e-12) | (wbxy < 1e-12), 1.0, cos_phi)
    off_i, w_i = catmull_rom_weights(table.mu, mu_i)
    off_o, w_o = catmull_rom_weights(table.mu, mu_o)
    n_mu = table.mu.shape[0]
    C = table.n_channels
    ak = torch.zeros(mu_i.shape + (C, table.m_max), device=wo.device)
    m_eff = torch.zeros(mu_i.shape, dtype=torch.int32, device=wo.device)
    for b in range(4):
        for a in range(4):
            ii = torch.clamp(off_i + a, 0, n_mu - 1)
            oo = torch.clamp(off_o + b, 0, n_mu - 1)
            w = w_i[..., a] * w_o[..., b]
            ak = ak + w[..., None, None] * table.a_dense[ii, oo]
            m_eff = torch.maximum(m_eff, torch.where(
                w.abs() > 0, table.m[ii, oo], 0).to(torch.int32))
    Y = torch.clamp_min(fourier_sum(ak[..., 0, :], m_eff, cos_phi,
                                    table.m_max), 0.0)
    scale = torch.where(mu_i.abs() > 1e-9, 1.0 / mu_i.abs(), 0.0)
    # the adjoint eta scale of a transmission (radiance transport)
    trans = mu_i * mu_o > 0
    eta_sc = torch.where(mu_i > 0, 1.0 / table.eta, table.eta)
    scale = scale * torch.where(trans, eta_sc * eta_sc, 1.0)
    if C == 1:
        return (Y * scale)[..., None].expand(mu_i.shape + (3,))
    R = fourier_sum(ak[..., 1, :], m_eff, cos_phi, table.m_max)
    B = fourier_sum(ak[..., 2, :], m_eff, cos_phi, table.m_max)
    G = 1.39829 * Y - 0.100913 * B - 0.297375 * R
    return torch.clamp_min(torch.stack([R * scale, G * scale, B * scale],
                                       -1), 0.0)


def eval_fourier_set(tables, fourier_id, wo, wi, n_channels: int):
    """A tuple of FourierTables evaluated per lane by ``fourier_id`` (the
    material rows' table index), one masked evaluation a table; a 60-bin
    scene takes the RGB mean as a flat spectrum, as pbrt_tpu does."""
    out = torch.zeros(wo.shape[:-1] + (n_channels,), device=wo.device)
    for k, tbl in enumerate(tables):
        rgb = eval_fourier(tbl, wo, wi)
        v = (rgb if n_channels == 3
             else rgb.mean(-1, keepdim=True).expand(rgb.shape[:-1]
                                                    + (n_channels,)))
        out = torch.where((fourier_id == k)[..., None], v, out)
    return out
