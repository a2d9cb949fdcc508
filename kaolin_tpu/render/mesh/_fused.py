"""Fused tile-binned DIB-R engine (Pallas kernels on the Triton route).

Parity: ``kaolin/csrc/render/mesh/rasterization_cuda.cu:43-236`` (z-buffer
selection) and ``dibr_soft_mask_cuda.cu:27-404`` (soft mask).

Design
------
The CUDA kernels run one thread per pixel, loop over every face and keep a
z-buffer (and a k-buffer for the soft mask).  This engine keeps that shape
and adds spatial binning so a pixel only visits faces near it:

1. **Spatial face sort + tile binning** (XLA, :func:`build_face_tiles`):
   faces are sorted by the pixel tile containing their (enlarged) bbox
   center and padded to chunks of ``FC`` faces.  After the sort each chunk
   is spatially local, so for every image tile only the *range*
   ``[lo, hi)`` of chunk ids whose bboxes overlap it is visited, and a
   per-chunk bbox test skips the rest.  A face spanning many tiles widens
   the ranges of the tiles it covers; nothing is dropped.

2. **Face columns**: per chunk, every per-face scalar (vertices, depths,
   validity, original id, enlarged bbox) is stored as one contiguous
   ``FC``-vector, table layout ``(B, nC, NCOL, FC)``.  Inside a kernel a
   column is one vector load, broadcast against the tile's pixel vector to
   an ``(FC, P)`` block: each thread keeps its pixels and walks the chunk's
   faces in registers.

3. **Forward kernel** (one program per pixel tile, ``P = PS * TW``
   pixels): the z-buffer winner (lowest original face id among the
   nearest covering faces, as the CUDA loop and the ``'jnp'`` backend
   keep it) and the soft-mask product ``prod(1 - p)`` over *all* faces
   whose enlarged bbox covers the pixel (the CUDA kernel caps at ``knum``
   per its fixed k-buffer; results agree whenever coverage <= knum).  The
   per-pixel arithmetic is the ``'jnp'`` backend's op for op.

4. **Backward kernel** (one program per face chunk): the soft-mask
   gradient w.r.t. image-space vertices with the CUDA backward's
   product-division (``dibr_soft_mask_cuda.cu:283-284``:
   ``dL/dp_k = g * allprod / (1 - p_k + EPS)``).  Each program walks the
   tiles its chunk overlaps and accumulates its own ``(6, FC)`` rows, so
   no two programs write the same output and no atomics are needed.

Semantics note: the product division differs from ``dibr.py``'s exact
exclusive cumprods only where some covering face has ``p ~ 1`` (pixel
exactly on a face boundary).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

__all__ = ['FusedSelection', 'fused_selection', 'softmask_fused']

_EPS = 1e-7        # reference dibr_soft_mask_cuda.cu:23
# tile shape: of eight shapes timed on an H100 (PERF.md) this one
# ran the forward + backward at 40k faces, 512^2, 4 views fastest
PS = 8             # pixel tile rows
TW = 16            # pixel tile columns
FC = 4             # faces per chunk
NUM_WARPS = 4

# face-table columns (each a contiguous FC-vector per chunk)
_VX = 0            # x1, y1, x2, y2, x3, y3 (scaled image coords)
_Z = 6             # z1, z2, z3
_VALID = 9         # 1. where the face takes part in the z-buffer
_FID = 10          # original face id (exact in f32 below 2**24)
_BB = 11           # enlarged bbox: xlo, ylo, xhi, yhi
_NCOL = 15


@functools.partial(jax.tree_util.register_dataclass, meta_fields=[
    'interpret'], data_fields=['face_idx', 'prod', 'vt', 'chunk_tranges',
                               'chunk_bbox', 'inv_perm'])
@dataclasses.dataclass(frozen=True)
class FusedSelection:
    """Selection-pass outputs + residuals for the soft-mask backward."""
    face_idx: jnp.ndarray      # (B, H, W) int32, original face ids, -1 empty
    prod: jnp.ndarray          # (B, H, W) f32 prod(1-p) over covering faces
    vt: jnp.ndarray            # (B, nC, NCOL, FC) sorted face columns
    chunk_tranges: jnp.ndarray  # (B, nC, 2) int32 tile range per chunk
    chunk_bbox: jnp.ndarray    # (B, nC, 4) f32 chunk bbox (union of faces)
    inv_perm: jnp.ndarray      # (B, F) sorted position of each original face
    interpret: bool = False    # the backward runs its kernel the same way


def _padded_dims(height, width):
    """Tile-aligned padded image dims; extra pixels computed then cropped."""
    return -(-height // PS) * PS, -(-width // TW) * TW


def _pixel_xy(wi, hi, height, width, multiplier):
    """Pixel-center coords, op for op as ``rasterization.pixel_coords``."""
    x0 = jnp.float32(multiplier / width) * jnp.asarray(
        2 * wi + 1 - width).astype(jnp.float32)
    y0 = jnp.float32(multiplier / height) * jnp.asarray(
        height - 2 * hi - 1).astype(jnp.float32)
    return x0, y0


def _tile_bounds(i, j, height, width, multiplier):
    """(xlo, xhi, ylo, yhi) pixel-center coords of tile (i, j)."""
    xlo, yhi = _pixel_xy(j * TW, i * PS, height, width, multiplier)
    xhi, ylo = _pixel_xy(j * TW + TW - 1, i * PS + PS - 1, height, width,
                         multiplier)
    return xlo, xhi, ylo, yhi


def build_face_tiles(face_vertices_z, fvi_scaled, valid_faces, height,
                     width, multiplier, margin):
    """Sort faces spatially, build per-face columns + tile/chunk ranges.

    Single mesh: fvz (F, 3), fvi_scaled (F, 3, 2), valid (F,).

    Returns:
        (vt (nC, NCOL, FC), tile_ranges (T, 2), chunk_tranges (nC, 2),
        chunk_bbox (nC, 4), inv_perm (F,)).
    """
    F = face_vertices_z.shape[0]
    hp, wp = _padded_dims(height, width)
    nI, nJ = hp // PS, wp // TW
    T = nI * nJ
    dtype = jnp.float32

    mn = jnp.min(fvi_scaled, axis=-2) - margin    # (F, 2) enlarged bbox
    mx = jnp.max(fvi_scaled, axis=-2) + margin

    # ---- spatial sort by tile of bbox center --------------------------
    cx = (mn[:, 0] + mx[:, 0]) * 0.5
    cy = (mn[:, 1] + mx[:, 1]) * 0.5
    wi_c = (cx * (width / multiplier) + (width - 1)) * 0.5
    hi_c = ((height - 1) - cy * (height / multiplier)) * 0.5
    tx = jnp.clip(wi_c.astype(jnp.int32) // TW, 0, nJ - 1)
    ty = jnp.clip(hi_c.astype(jnp.int32) // PS, 0, nI - 1)
    perm = jnp.argsort((ty * nJ + tx).astype(jnp.int32),
                       stable=True).astype(jnp.int32)
    inv_perm = jnp.argsort(perm).astype(jnp.int32)

    fpad = (-F) % FC
    Fp = F + fpad
    nC = Fp // FC

    def pad(a, fill=0.):
        return jnp.pad(a, ((0, fpad),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=fill)

    # padded faces: bbox that never covers and never overlaps a tile
    mn = pad(mn[perm], fill=2. * float(multiplier))
    mx = pad(mx[perm], fill=-2. * float(multiplier))
    cols = [pad(fvi_scaled[perm]).reshape(Fp, 6),       # _VX
            pad(face_vertices_z[perm]),                 # _Z
            pad(valid_faces[perm].astype(dtype))[:, None],
            pad(perm.astype(dtype))[:, None],           # _FID
            mn, mx]                                     # _BB
    vt = jnp.concatenate([c.astype(dtype) for c in cols], axis=-1)
    vt = vt.reshape(nC, FC, _NCOL).transpose(0, 2, 1)

    # ---- chunk bboxes + tile <-> chunk overlap ranges ------------------
    cmn = mn.reshape(nC, FC, 2).min(axis=1)                 # (nC, 2)
    cmx = mx.reshape(nC, FC, 2).max(axis=1)
    chunk_bbox = jnp.concatenate([cmn, cmx], axis=-1)       # (nC, 4)

    t_xlo, t_xhi, _, _ = _tile_bounds(0, jnp.arange(nJ), height, width,
                                      multiplier)
    _, _, t_ylo, t_yhi = _tile_bounds(jnp.arange(nI), 0, height, width,
                                      multiplier)
    ov_x = ((cmn[None, :, 0] <= t_xhi[:, None])
            & (cmx[None, :, 0] >= t_xlo[:, None]))          # (nJ, nC)
    ov_y = ((cmn[None, :, 1] <= t_yhi[:, None])
            & (cmx[None, :, 1] >= t_ylo[:, None]))          # (nI, nC)
    ov = (ov_y[:, None, :] & ov_x[None, :, :]).reshape(T, nC)

    def ranges(mask, n):
        """[lo, hi) covering the True entries of each row of mask (M, n)."""
        idx = jnp.arange(n, dtype=jnp.int32)
        lo = jnp.min(jnp.where(mask, idx, n), axis=-1)
        hi = jnp.max(jnp.where(mask, idx + 1, 0), axis=-1)
        return jnp.stack([jnp.minimum(lo, hi), hi], axis=-1)

    tile_ranges = ranges(ov, nC)                            # (T, 2)
    chunk_tranges = ranges(ov.T, T)                         # (nC, 2)
    return vt, tile_ranges, chunk_tranges, chunk_bbox, inv_perm


def _tile_pixels(t, nJ, height, width, multiplier):
    """Pixel-center coords (1, P) of tile t, row-major inside the tile."""
    i = t // nJ
    j = t % nJ
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, PS * TW), 1)
    return _pixel_xy(j * TW + lane % TW, i * PS + lane // TW, height, width,
                     multiplier)


def _chunk_hits_tile(cbb_ref, b, c, i, j, height, width, multiplier):
    """Whether chunk c's bbox overlaps tile (i, j) (exact skip test)."""
    xlo, xhi, ylo, yhi = _tile_bounds(i, j, height, width, multiplier)
    return ((cbb_ref[b, c, 0] <= xhi) & (cbb_ref[b, c, 2] >= xlo)
            & (cbb_ref[b, c, 1] <= yhi) & (cbb_ref[b, c, 3] >= ylo))


def _edge_terms(col, x0, y0):
    """Per-edge terms of ``dibr._soft_mask_edge_terms`` in coordinates
    relative to the edge's first vertex: the same quantities without the
    cancellation of ``A * x0 + B * y0 + C`` (``C`` ~ multiplier**2)."""
    out = []
    for e in range(3):
        x1, y1 = col(_VX + 2 * e), col(_VX + 2 * e + 1)
        jj = (e + 1) % 3
        A = col(_VX + 2 * jj + 1) - y1
        B = x1 - col(_VX + 2 * jj)
        dn = A * A + B * B + _EPS
        dx = x0 - x1
        dy = y0 - y1
        up = A * dx + B * dy
        t_ = up / dn
        ex = dx - A * t_                    # x3 - x1 (foot of perpendicular)
        ey = dy - B * t_
        direct = ex * (ex + B) + ey * (ey - A)
        out.append((A, B, dx, dy, up, dn, up * t_, direct))
    return out


def _soft_prob(col, x0, y0, inv_sigma, sentinel):
    """(p, min distance, the six distances, edge terms) of an (FC, P)
    block."""
    edges = _edge_terms(col, x0, y0)
    dists = [jnp.where(e[7] > 0., sentinel, e[6]) for e in edges]
    dists += [(x0 - col(_VX + 2 * v)) ** 2 + (y0 - col(_VX + 2 * v + 1)) ** 2
              for v in range(3)]
    d = dists[0]
    for x in dists[1:]:
        d = jnp.minimum(d, x)
    inb = ((x0 >= col(_BB)) & (x0 < col(_BB + 2))
           & (y0 >= col(_BB + 1)) & (y0 < col(_BB + 3)))
    p = jnp.where(inb, jnp.exp(-(inv_sigma * d)), 0.)
    return p, d, dists, edges


# ---------------------------------------------------------------------------
# forward kernel: z-buffer winner + soft-mask product per pixel tile

def _fwd_kernel(ranges_ref, cbb_ref, vt_ref, fid_ref, prod_ref, *, nJ,
                height, width, multiplier, eps, inv_sigma, sentinel,
                with_softmask):
    b = pl.program_id(0)
    t = pl.program_id(1)
    x0, y0 = _tile_pixels(t, nJ, height, width, multiplier)   # (1, P)
    neg_inf = jnp.float32(-jnp.inf)
    big = jnp.float32(2 ** 30)

    def process(ci, carry):
        bz, bf, lsum = carry

        def col(c):
            return vt_ref[b, ci, c, :].reshape(FC, 1)

        # normalized barycentrics, as rasterization._bary_weights_pairwise
        a_ex = col(_VX) - x0
        a_ey = col(_VX + 1) - y0
        b_ex = col(_VX + 2) - x0
        b_ey = col(_VX + 3) - y0
        c_ex = col(_VX + 4) - x0
        c_ey = col(_VX + 5) - y0
        w0 = b_ex * c_ey - b_ey * c_ex
        w1 = c_ex * a_ey - c_ey * a_ex
        w2 = a_ex * b_ey - a_ey * b_ex
        norm = w0 + w1 + w2
        neg = jax.lax.bitcast_convert_type(norm, jnp.int32) < 0
        norm = norm + jnp.where(neg, -eps, eps)             # copysign
        w0 = w0 / norm
        w1 = w1 / norm
        w2 = w2 / norm
        z = w0 * col(_Z) + w1 * col(_Z + 1) + w2 * col(_Z + 2)
        cov = ((w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.) & (col(_VALID) > 0.))
        z = jnp.where(cov, z, neg_inf)
        zc = jnp.max(z, axis=0, keepdims=True)              # (1, P)
        fc = jnp.min(jnp.where(cov & (z == zc), col(_FID), big), axis=0,
                     keepdims=True)
        upd = (zc > bz) | ((zc == bz) & (zc > neg_inf) & (fc < bf))
        bz = jnp.where(upd, zc, bz)
        bf = jnp.where(upd, fc, bf)
        if with_softmask:
            p, _, _, _ = _soft_prob(col, x0, y0, inv_sigma, sentinel)
            # no product reduction on this route: sum of logs
            lsum = lsum + jnp.sum(jnp.log1p(-p), axis=0, keepdims=True)
        return bz, bf, lsum

    def body(ci, carry):
        hit = _chunk_hits_tile(cbb_ref, b, ci, t // nJ, t % nJ, height,
                               width, multiplier)
        return jax.lax.cond(hit, process, lambda _, c: c, ci, carry)

    init = (jnp.full((1, PS * TW), neg_inf, jnp.float32),
            jnp.full((1, PS * TW), big, jnp.float32),
            jnp.zeros((1, PS * TW), jnp.float32))
    _, bf, lsum = jax.lax.fori_loop(ranges_ref[b, t, 0], ranges_ref[b, t, 1],
                                    body, init)
    fid_ref[b, t, :] = jnp.where(bf < big, bf, -1.).astype(
        jnp.int32).reshape(PS * TW)
    prod_ref[b, t, :] = jnp.exp(lsum).reshape(PS * TW)


@functools.partial(jax.jit, static_argnames=(
    'height', 'width', 'multiplier', 'eps', 'sigmainv', 'with_softmask',
    'interpret'))
def _fused_forward(vt, tile_ranges, chunk_bbox, height, width, multiplier,
                   eps, sigmainv, with_softmask, interpret):
    """Batched fused forward.  vt (B, nC, NCOL, FC) etc (sorted space).

    Returns (face_idx (B, H, W) int32 original ids, prod (B, H, W) f32).
    """
    B = vt.shape[0]
    hp, wp = _padded_dims(height, width)
    nI, nJ = hp // PS, wp // TW
    T = nI * nJ
    P = PS * TW
    fid_t, prod_t = pl.pallas_call(
        functools.partial(
            _fwd_kernel, nJ=nJ, height=height, width=width,
            multiplier=multiplier, eps=eps,
            inv_sigma=sigmainv / multiplier ** 2,
            sentinel=4. * multiplier ** 2, with_softmask=with_softmask),
        grid=(B, T),
        out_shape=[jax.ShapeDtypeStruct((B, T, P), jnp.int32),
                   jax.ShapeDtypeStruct((B, T, P), jnp.float32)],
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name='dibr_fused_forward',
    )(tile_ranges, chunk_bbox, vt)

    def untile(img):
        img = img.reshape(B, nI, nJ, PS, TW).transpose(0, 1, 3, 2, 4)
        return img.reshape(B, hp, wp)[:, :height, :width]
    return untile(fid_t), untile(prod_t)


# ---------------------------------------------------------------------------
# backward kernel: soft-mask gradient w.r.t. image-space vertices

def _bwd_kernel(tranges_ref, cbb_ref, vt_ref, gprod_ref, out_ref, *, nJ,
                height, width, multiplier, inv_sigma, sentinel):
    b = pl.program_id(0)
    c = pl.program_id(1)

    def col(cc):
        return vt_ref[b, c, cc, :].reshape(FC, 1)

    def process(t, acc):
        x0, y0 = _tile_pixels(t, nJ, height, width, multiplier)
        gt = gprod_ref[b, t, :].reshape(1, PS * TW)
        p, d, dists, edges = _soft_prob(col, x0, y0, inv_sigma, sentinel)
        # CUDA product-division backward (dibr_soft_mask_cuda.cu:283-284)
        dd = (-inv_sigma) * p * gt / (1. - p + _EPS)        # (FC, P)
        # the argmin branch, first index on ties (dibr.py's backward)
        remaining = jnp.ones(dd.shape, jnp.bool_)
        comp = [0.] * 6
        for e in range(3):
            A, Bc, dx, dy, up, dn, perp, direct = edges[e]
            sel = remaining & (dists[e] == d)
            remaining = remaining & jnp.logical_not(sel)
            w = 2. * jnp.where(sel & (direct <= 0.), dd, 0.) / dn
            jj = (e + 1) % 3
            comp[2 * e] += w * (up * (dy - A) - perp * Bc)
            comp[2 * e + 1] += w * (perp * A - up * (dx + Bc))
            comp[2 * jj] += w * (perp * Bc - up * dy)
            comp[2 * jj + 1] += w * (up * dx - perp * A)
        for v in range(3):
            sel = remaining & (dists[3 + v] == d)
            remaining = remaining & jnp.logical_not(sel)
            w = 2. * jnp.where(sel, dd, 0.)
            comp[2 * v] += w * (col(_VX + 2 * v) - x0)
            comp[2 * v + 1] += w * (col(_VX + 2 * v + 1) - y0)
        return tuple(a + jnp.sum(x, axis=1) for a, x in zip(acc, comp))

    def body(t, acc):
        hit = _chunk_hits_tile(cbb_ref, b, c, t // nJ, t % nJ, height,
                               width, multiplier)
        return jax.lax.cond(hit, process, lambda _, a: a, t, acc)

    init = tuple(jnp.zeros((FC,), jnp.float32) for _ in range(6))
    acc = jax.lax.fori_loop(tranges_ref[b, c, 0], tranges_ref[b, c, 1],
                            body, init)
    for k in range(6):
        out_ref[b, c, k, :] = acc[k]


@functools.partial(jax.jit, static_argnames=(
    'height', 'width', 'multiplier', 'sigmainv', 'interpret'))
def _fused_backward(vt, chunk_tranges, chunk_bbox, g_prod_tiled, height,
                    width, multiplier, sigmainv, interpret):
    """Batched soft-mask backward.  Returns (B, nC*FC, 6) sorted grads."""
    B, nC = vt.shape[:2]
    nJ = _padded_dims(height, width)[1] // TW
    out = pl.pallas_call(
        functools.partial(
            _bwd_kernel, nJ=nJ, height=height, width=width,
            multiplier=multiplier, inv_sigma=sigmainv / multiplier ** 2,
            sentinel=4. * multiplier ** 2),
        grid=(B, nC),
        out_shape=jax.ShapeDtypeStruct((B, nC, 6, FC), jnp.float32),
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name='dibr_fused_backward',
    )(chunk_tranges, chunk_bbox, vt, g_prod_tiled)
    return out.transpose(0, 1, 3, 2).reshape(B, nC * FC, 6)


def _tile_image(img, height, width):
    """(B, H, W) -> (B, T, P) in the kernels' tile layout."""
    B = img.shape[0]
    hp, wp = _padded_dims(height, width)
    img = jnp.pad(img, ((0, 0), (0, hp - height), (0, wp - width)))
    img = img.reshape(B, hp // PS, PS, wp // TW, TW).transpose(0, 1, 3, 2, 4)
    return img.reshape(B, (hp // PS) * (wp // TW), PS * TW)


# ---------------------------------------------------------------------------
# public API

def fused_selection(face_vertices_z, face_vertices_image, valid_faces=None,
                    height=256, width=256, multiplier=1000., boxlen=0.02,
                    sigmainv=7000., eps=1e-8, with_softmask=True,
                    interpret=False):
    """Fused z-buffer + soft-mask selection pass (non-differentiable).

    Args:
        face_vertices_z: (B, F, 3) camera-space z.
        face_vertices_image: (B, F, 3, 2) image coords in [-1, 1].
        valid_faces: (B, F) bool (z-buffer only; the soft mask uses all
            faces, as the reference does).
        interpret: run the kernels in the Pallas interpreter (CPU tests).

    Returns:
        :class:`FusedSelection` — feed to :func:`softmask_fused` for the
        differentiable mask and to ``rasterize(precomputed_face_idx=...)``
        for feature interpolation.
    """
    B, F = face_vertices_z.shape[:2]
    if valid_faces is None:
        valid_faces = jnp.ones((B, F), dtype=bool)
    multiplier = float(multiplier)
    margin = float(boxlen) * multiplier
    fvz = jax.lax.stop_gradient(face_vertices_z).astype(jnp.float32)
    fvi_scaled = (jax.lax.stop_gradient(face_vertices_image)
                  * multiplier).astype(jnp.float32)

    prep = jax.vmap(lambda z, i, v: build_face_tiles(
        z, i, v, height, width, multiplier, margin))
    vt, tile_ranges, chunk_tranges, chunk_bbox, inv_perm = prep(
        fvz, fvi_scaled, valid_faces)
    face_idx, prod = _fused_forward(
        vt, tile_ranges, chunk_bbox, height, width, multiplier, float(eps),
        float(sigmainv), with_softmask, interpret)
    return FusedSelection(face_idx, prod, vt, chunk_tranges, chunk_bbox,
                          inv_perm, bool(interpret))


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def softmask_fused(fvi_scaled, sel: FusedSelection, config):
    """Differentiable soft mask from a :class:`FusedSelection`.

    ``config`` = (height, width, multiplier, sigmainv) hashable.  ``fvi_scaled`` must be the same geometry the selection was
    built from (the forward value reuses the selection's product; the
    backward differentiates it w.r.t. ``fvi_scaled``).
    """
    del fvi_scaled, config
    return jnp.where(sel.face_idx < 0, 1. - sel.prod, 1.)


def _softmask_fused_fwd(fvi_scaled, sel, config):
    return softmask_fused(fvi_scaled, sel, config), sel


def _softmask_fused_bwd(config, sel, g):
    height, width, multiplier, sigmainv = config
    B, F = sel.inv_perm.shape
    g_prod = jnp.where(sel.face_idx < 0, g * sel.prod, 0.)
    dsorted = _fused_backward(
        sel.vt, sel.chunk_tranges, sel.chunk_bbox,
        _tile_image(g_prod, height, width), height, width,
        float(multiplier), float(sigmainv), sel.interpret)  # (B, Fp, 6)
    dfvi = jnp.take_along_axis(dsorted, sel.inv_perm[..., None], axis=1)
    fl0 = lambda a: np.zeros(a.shape, jax.dtypes.float0)
    return dfvi.reshape(B, F, 3, 2), jax.tree_util.tree_map(fl0, sel)


softmask_fused.defvjp(_softmask_fused_fwd, _softmask_fused_bwd)
