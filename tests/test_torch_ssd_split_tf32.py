"""B6's and B6-bwd's fp32 routes on the CPU: their split-TF32 arithmetic
against the JAX package.

The kernels (``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``) take every
product of fp32 operands in split TF32 on the tensor cores and keep cum,
the decay (one exp an entry) and the carried states in fp32.  The
emulations below repeat that arithmetic in plain PyTorch at the kernels'
tile sizes (64-row query, row and column tiles; 32-row streamed key and
row tiles), and the tests hold them against the reference: the forward
against ``ssd_scan_pallas`` in interpret mode, the backward against
``jax.vjp`` of ``ssd_chunked``, each within the fp32 routes' bound of
1e-4 of max|reference|.  Test-only: the kernels' numeric design, checked
without a card (``tests/test_torch_cuda.py`` holds the kernels against
the plain version on one).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.layers.mamba2 import ssd_chunked
from repro_torch.kernels import ref
from torch_split_tf32 import mm3

torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT",
                                                "1"))))

ROWS, KEYS = 64, 32   # the kernels' resident and streamed tile rows


def _inputs(b, s, h, p, n, rng, a=None):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32) if a is None \
        else np.asarray(a, np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    return x, dt, a, bm, cm


def _chunked(x, dt, b, c, chunk):
    """Zero steps appended up to whole chunks, then (B, H, chunks, Q, .)
    layouts of x and dt and (B, 1, chunks, Q, N) of b and c."""
    pad = -x.shape[1] % chunk
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dt, b, c = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                for t in (dt, b, c))
    bs, sp, h, p = x.shape
    n, nc = b.shape[-1], sp // chunk
    return (x.reshape(bs, nc, chunk, h, p).permute(0, 3, 1, 2, 4),
            dt.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2),
            b.reshape(bs, 1, nc, chunk, n), c.reshape(bs, 1, nc, chunk, n))


def _tiles(chunk, size):
    return [(t0, min(t0 + size, chunk)) for t0 in range(0, chunk, size)]


def _decay(cum, rows, cols, dtj=None, *, lower=True):
    """One exp an entry, zero elsewhere: exp(cum_i - cum_j) (times dt_j)
    for rows i and columns j <= i (lower), or exp(cum_j - cum_i) for
    columns j >= i (the columns launch's transposed tiles)."""
    i0, i1 = rows
    j0, j1 = cols
    ri = torch.arange(i0, i1)[:, None]
    cj = torch.arange(j0, j1)[None, :]
    diff = cum[..., i0:i1, None] - cum[..., None, j0:j1]
    e = torch.exp(diff if lower else -diff)
    if dtj is not None:
        e = e * dtj[..., None, j0:j1]
    return torch.where(cj <= ri if lower else cj >= ri, e, 0.0)


def _states(xc, dtc, bc, cum, single):
    """The chunk-state launch (X^T (B o w) in split TF32) and the fp32
    state pass: the state entering each chunk and h_last."""
    cq = cum[..., -1]
    w = torch.exp(cq[..., None] - cum) * dtc
    own = mm3(xc.transpose(-1, -2), bc * w[..., None], single=single)
    h = torch.zeros_like(own[:, :, 0])
    h0 = []
    for i in range(own.shape[2]):
        h0.append(h)
        h = torch.exp(cq[..., i])[..., None, None] * h + own[:, :, i]
    return torch.stack(h0, dim=2), h


def ssd_split_tf32_emulation(x, dt, a, b, c, chunk, *, single=False):
    """The arithmetic of B6's fp32 route on (B,S,H,P) x, (B,S,H) dt, (H,)
    a and (B,S,N) b, c: the chunk states, the state pass, then per
    64-row query tile the carried term exp(cum_i) C_i h^T and per 32-key
    tile up to the tile's last row W = (C_i B_j^T) o exp(cum_i - cum_j) o
    dt_j, y += W X_j; every product split TF32 (``single``: one TF32
    product).  Returns (y, h_last, the states entering the chunks)."""
    s = x.shape[1]
    xc, dtc, bc, cc = _chunked(x, dt, b, c, chunk)
    cum = torch.cumsum(dtc * a[None, :, None, None], dim=-1)
    h0, h_last = _states(xc, dtc, bc, cum, single)
    y = torch.zeros_like(xc)
    for r0, r1 in _tiles(chunk, ROWS):
        ci = cc[..., r0:r1, :]
        acc = torch.exp(cum[..., r0:r1, None]) * mm3(
            ci, h0.transpose(-1, -2), single=single)
        for k0, k1 in _tiles(min(r1, chunk), KEYS):
            sm = mm3(ci, bc[..., k0:k1, :].transpose(-1, -2), single=single)
            wm = sm * _decay(cum, (r0, r1), (k0, k1), dtc)
            acc = acc + mm3(wm, xc[..., k0:k1, :], single=single)
        y[..., r0:r1, :] = acc
    bs, h, nc, q, p = y.shape
    y = y.permute(0, 2, 3, 1, 4).reshape(bs, nc * q, h, p)[:, :s]
    return y, h_last, h0


def ssd_bwd_split_tf32_emulation(x, dt, a, b, c, dy, chunk, dh_last=None):
    """The arithmetic of B6-bwd's fp32 route from the forward route's
    kept states, with a cotangent ``dh_last`` on h_last or none: the rows
    launch per 64-row tile i (Z = dY_i h0, then per 32-key tile G = C_i
    B_j^T, D = dY_i X_j^T, W_D = D o L o dt_j, dC_i += W_D B_j, M = W_D o
    G without its diagonal into dcum) and U = dY^T (C o exp(cum)); the
    reverse state pass in fp32; the columns launch per 64-row tile j (T =
    B_j dh1^T, X_j dh1, then per 32-row tile i >= j G^T, D^T, the row sums
    of D^T o G^T o L^T, dx_j += W_G^T dY_i, dB_j += W_D^T C_i); the
    reverse cumulative sum g and ddt, da in fp32; every product split
    TF32.  Returns (dx, ddt, da, db, dc)."""
    s = x.shape[1]
    xc, dtc, bc, cc = _chunked(x, dt, b, c, chunk)
    dyc = _chunked(dy, dt, b, c, chunk)[0]
    bs, h, nc, q, p = xc.shape
    cum = torch.cumsum(dtc * a[None, :, None, None], dim=-1)
    cq = cum[..., -1]
    e = torch.exp(cum)
    w = torch.exp(cq[..., None] - cum) * dtc
    h0, _ = _states(xc, dtc, bc, cum, False)
    # 1. rows
    dc_h = torch.zeros(bs, h, nc, q, b.shape[-1])
    dcum = torch.zeros_like(cum)
    for r0, r1 in _tiles(q, ROWS):
        ci, dyi = cc[..., r0:r1, :], dyc[..., r0:r1, :]
        z = mm3(dyi, h0)
        dcum[..., r0:r1] = e[..., r0:r1] * (z * ci).sum(-1)
        acc = e[..., r0:r1, None] * z
        for k0, k1 in _tiles(r1, KEYS):
            g = mm3(ci, bc[..., k0:k1, :].transpose(-1, -2))
            d = mm3(dyi, xc[..., k0:k1, :].transpose(-1, -2))
            wd = d * _decay(cum, (r0, r1), (k0, k1), dtc)
            off = torch.arange(r0, r1)[:, None] != torch.arange(k0, k1)
            dcum[..., r0:r1] += torch.where(off, wd * g, 0.0).sum(-1)
            acc = acc + mm3(wd, bc[..., k0:k1, :])
        dc_h[..., r0:r1, :] = acc
    u = mm3(dyc.transpose(-1, -2), cc * e[..., None])
    # 2. the state pass, from the last chunk back
    dh1, carry = [None] * nc, torch.zeros_like(h0[:, :, 0])
    if dh_last is not None:
        carry = dh_last
    for i in reversed(range(nc)):
        dh1[i] = carry
        carry = torch.exp(cq[..., i])[..., None, None] * carry + u[:, :, i]
    dh1 = torch.stack(dh1, dim=2)
    # 3. columns
    dx = torch.zeros_like(xc)
    db_h = torch.zeros_like(dc_h)
    ddt_direct = torch.zeros_like(cum)
    s_all = torch.zeros_like(cum)
    for j0, j1 in _tiles(q, ROWS):
        bj, xj = bc[..., j0:j1, :], xc[..., j0:j1, :]
        t = mm3(bj, dh1.transpose(-1, -2))
        sj = (xj * t).sum(-1)
        s_all[..., j0:j1] = sj
        wj = w[..., j0:j1, None]
        dxa, dba = wj * t, wj * mm3(xj, dh1)
        r_all = torch.zeros_like(sj)
        r_off = torch.zeros_like(sj)
        for i0, i1 in _tiles(q, KEYS):
            if i1 <= j0:
                continue
            gt = mm3(bj, cc[..., i0:i1, :].transpose(-1, -2))
            dtt = mm3(xj, dyc[..., i0:i1, :].transpose(-1, -2))
            lt = _decay(cum, (j0, j1), (i0, i1), lower=False)
            r = dtt * gt * lt
            off = torch.arange(j0, j1)[:, None] != torch.arange(i0, i1)
            r_all = r_all + r.sum(-1)
            r_off = r_off + torch.where(off, r, 0.0).sum(-1)
            f = lt * dtc[..., j0:j1, None]
            dxa = dxa + mm3(gt * f, dyc[..., i0:i1, :])
            dba = dba + mm3(dtt * f, cc[..., i0:i1, :])
        dx[..., j0:j1, :] = dxa
        db_h[..., j0:j1, :] = dba
        ddt_direct[..., j0:j1] = torch.exp(cq[..., None] - cum[..., j0:j1]) \
            * sj + r_all
        dcum[..., j0:j1] += -dtc[..., j0:j1] * r_off - w[..., j0:j1] * sj
    dcum[..., -1] += torch.exp(cq) * (dh1 * h0).sum((-1, -2)) \
        + (w * s_all).sum(-1)
    g = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = ddt_direct + a[None, :, None, None] * g
    da = (dtc * g).sum((0, 2, 3))

    def back(t):
        return t.permute(0, 2, 3, 1, *range(4, t.dim())).reshape(
            bs, nc * q, h, *t.shape[4:])[:, :s]
    return (back(dx), back(ddt), da,
            db_h.sum(1).reshape(bs, nc * q, -1)[:, :s],
            dc_h.sum(1).reshape(bs, nc * q, -1)[:, :s])


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) \
        / max(float(np.max(np.abs(want))), 1e-30)


# (b, s, h, p, n, chunk, a): the reference's grid, ragged tails, one past
# and one short of a chunk's edge, every head dim, N in 8, 16, 128,
# mamba2-1.3b's N=128 at chunk 256, and heads whose cum rises (a > 0)
FWD_CASES = [
    (2, 256, 3, 32, 16, 64, None), (1, 100, 2, 16, 8, 32, None),
    (1, 64, 1, 64, 128, 64, None), (1, 129, 2, 64, 16, 64, None),
    (1, 255, 2, 32, 8, 64, None), (1, 300, 2, 64, 128, 256, None),
    (1, 200, 4, 16, 16, 64, [-1.0, 0.1, -0.5, 0.02]),
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,a", FWD_CASES)
def test_ssd_split_tf32_arithmetic_matches_pallas(b, s, h, p, n, chunk, a,
                                                  rng):
    """B6's fp32 route: its arithmetic against ``ssd_scan_pallas`` in
    interpret mode on the same fp32 inputs, y and h_last within 1e-4 of
    max|reference|."""
    args = _inputs(b, s, h, p, n, rng, a)
    yj, hj = jops.ssd_scan(*(jnp.asarray(t) for t in args), chunk=chunk,
                           interpret=True)
    yt, ht, _ = ssd_split_tf32_emulation(
        *(torch.from_numpy(t) for t in args), chunk)
    assert yt.shape == (b, s, h, p) and ht.shape == (b, h, p, n)
    devs = [_rel(yt, yj), _rel(ht, hj)]
    print(f"B6 split-TF32 arithmetic vs pallas {(b, s, h, p, n, chunk)} "
          f"a={a}: y {devs[0]:.3e}, h_last {devs[1]:.3e} of max|reference|")
    assert max(devs) <= 1e-4


def test_one_tf32_product_breaks_the_ssd_fp32_bound(rng):
    """The witness for the split: B6's fp32 route with one TF32 product
    (hi x hi) in place of three misses the 1e-4 bound against a float64
    plain scan, where the split holds it (mamba2-1.3b's N=128 at chunk
    256)."""
    args = [torch.from_numpy(t) for t in _inputs(1, 300, 2, 64, 128, rng)]
    want = ref.ssd_scan_ref(*(t.double() for t in args), 256)[0]
    devs = [_rel(ssd_split_tf32_emulation(*args, 256, single=single)[0],
                 want) for single in (False, True)]
    print(f"B6 fp32 route against float64: split TF32 {devs[0]:.3e}, one "
          f"TF32 product {devs[1]:.3e} of max|y|")
    assert devs[0] <= 1e-5 and devs[1] > 1e-4


def _jax_vjp(x, dt, a, bm, cm, dy, dh, chunk):
    """``jax.vjp`` of the reference's ``ssd_chunked`` (a ragged tail padded
    with zero steps, as mamba2_apply pads) at fp32 inputs: (dx, ddt, da,
    db, dc), with a cotangent ``dh`` on h_last or none."""
    s = x.shape[1]
    pad = -s % chunk

    def f(x, dt, a, bm, cm):
        padt = lambda t: jnp.pad(t, [(0, 0), (0, pad)]  # noqa: E731
                                 + [(0, 0)] * (t.ndim - 2))
        y, h_last = ssd_chunked(padt(x), padt(dt), a, padt(bm), padt(cm),
                                chunk)
        return y[:, :s], h_last
    (_, h_last), vjp = jax.vjp(f, *(jnp.asarray(t) for t in (x, dt, a, bm,
                                                            cm)))
    dh = jnp.zeros_like(h_last) if dh is None else jnp.asarray(dh)
    return vjp((jnp.asarray(dy), dh))


# (b, s, h, p, n, chunk, a): chunk edges, ragged tails, every head dim, N
# in 8, 16 and mamba2-1.3b's 128 at chunk 256, a rising cum
BWD_CASES = [
    (2, 64, 3, 16, 16, 32, None), (1, 100, 2, 32, 16, 48, None),
    (1, 130, 2, 64, 8, 64, None), (1, 260, 2, 64, 128, 256, None),
    (1, 150, 3, 32, 16, 64, [-1.0, 0.1, 0.02]),
]


@pytest.mark.parametrize("with_h_last", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk,a", BWD_CASES)
def test_ssd_bwd_split_tf32_arithmetic_matches_jax_vjp(b, s, h, p, n, chunk,
                                                       a, with_h_last, rng):
    """B6-bwd's fp32 route: its arithmetic, from the forward route's
    kept states, against ``jax.vjp`` of the reference's ``ssd_chunked``
    on the same fp32 inputs, with and without a cotangent on h_last: dx,
    ddt, da, db and dc each within 1e-4 of its max|reference|."""
    x, dt, a_, bm, cm = _inputs(b, s, h, p, n, rng, a)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dh = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if with_h_last else None
    want = _jax_vjp(x, dt, a_, bm, cm, dy, dh, chunk)
    got = ssd_bwd_split_tf32_emulation(
        *(torch.from_numpy(t) for t in (x, dt, a_, bm, cm, dy)), chunk,
        None if dh is None else torch.from_numpy(dh))
    devs = []
    for g_, w in zip(got, want):
        assert g_.shape == w.shape and g_.dtype == torch.float32
        devs.append(_rel(g_, w))
    print(f"B6-bwd split-TF32 arithmetic vs jax.vjp {(b, s, h, p, n, chunk)}"
          f" a={a} h_last={with_h_last}: dx, ddt, da, db, dc "
          f"{['%.3e' % d for d in devs]} of max|reference|")
    assert max(devs) <= 1e-4


def test_ssd_bwd_split_tf32_arithmetic_on_the_cancelling_draw():
    """The saved draw of (1, 100, 2, 32, 16, 48) with a cotangent on
    h_last on which bf16 ``da`` once read 0.106 of max|plain| (``da`` is
    ~1/50 of its terms there), read in fp32: the route's arithmetic
    against ``jax.vjp`` of ``ssd_chunked``, every gradient within 1e-4 of
    its max|reference|."""
    d = torch.load(os.path.join(os.path.dirname(__file__), "data",
                                "ssd_scan_bwd_da_draw.pt"),
                   weights_only=True)
    b, s, h, p, n = d["shape"]
    chunk = d["chunk"]
    xs, bm, cm = d["conv"].float().split([h * p, n, n], dim=-1)
    x = xs.reshape(b, s, h, p)
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    dt, dy, dh = (d[k].float() for k in ("dt", "dy", "dh"))
    want = _jax_vjp(*(t.numpy() for t in (x, dt, a, bm, cm, dy, dh)), chunk)
    got = ssd_bwd_split_tf32_emulation(x, dt, a, bm, cm, dy, chunk, dh)
    devs = [_rel(g_, w) for g_, w in zip(got, want)]
    print(f"B6-bwd split-TF32 arithmetic on the saved draw in fp32: dx, ddt,"
          f" da, db, dc {['%.3e' % x for x in devs]} of max|reference|")
    assert max(devs) <= 1e-4
