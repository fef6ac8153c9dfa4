"""INTAC numerics in PyTorch: exact accumulation in an integer domain.

The counterpart of the reference's ``core/intac.py`` on one device:
quantization to a shared power-of-two scale, int32 limbs with an exact
wraparound predicate, the exponent-indexed digit bins of the ``exact2``
residual and the ``procrastinate`` tier, ``intac_sum``, and the two- and
three-limb carry-save states (``LimbState``, ``Limb3State``) that the
streaming accumulators of ``reduce.accumulator`` push into.  Every
function is elementwise (or a column sum) on tensors and runs on
whatever device its input lives on; each one gives the reference's bits
on the inputs where both are IEEE-exact.  The cross-rank sums
(``intac_psum``, ``intac_psum2``, ``intac_psum3``, ``bin_psum``,
``limb3_merge_across``, ``compressed_psum_mean``) take a process group
where the reference takes a mesh axis, and cross ranks only through
``distributed.comm``: integer payloads in one ``psum``, the shared
scale or anchor from a ``pmax``.

Two places depart from a literal transcription, on purpose:

* ``choose_scale`` computes its exponent exactly, from the integer
  mantissa of ``max_abs`` and the row count, instead of
  ``floor(qbits - log2(N) - log2(max))`` in f32.  The f32 logs are
  inexact near powers of two: the reference's scale is then 2x the exact
  one (breaking its own ``n * max * scale <= 2^qbits`` bound) or half of
  it (merely conservative).  Both deviations are pinned by the tests.
* Subnormals are kept, as IEEE arithmetic on the CPU and the GPU keeps
  them (nothing here is built with flush-to-zero).  JAX on the CPU
  flushes them to zero, so a stream whose values or ``exact2`` residuals
  fall below 2^-126 ends in different bits; the tests pin that too.

``ldexp`` follows the reference's frexp-based construction, with the
power of two built exactly from its bit pattern, and ``_ldexp2`` keeps
its two half-exponent steps.  Float-to-int32 casts saturate and map NaN
to 0, as XLA's conversion does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..distributed import comm

LIMB_SHIFT = 15
BIN_BITS = 8
NUM_BINS = 6
#: per-bin int32 headroom: max terms accumulated with no overflow
BIN_MAX_TERMS = 1 << (31 - BIN_BITS - 1)
#: the exact2 residual superaccumulator: digits of RES_BIN_BITS bits,
#: RES_NUM_BINS of them, anchored at the quantum (a 49-bit window)
RES_BIN_BITS = 7
RES_NUM_BINS = 7

_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


def _i32(e, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(e, dtype=torch.int32, device=like.device)


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 2^e for integer tensor ``e``: normal powers from their
    bit pattern, subnormal ones as a product of two normal powers (one
    rounding-free multiply), 0 below 2^-149 and inf above 2^127."""
    e = e.to(torch.int32)
    normal = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    # a Python scalar, not a tensor made on the host: that would be a
    # host-to-device copy, and a stream sync, at every call on the card
    tiny = ((e.clamp(-252, -127) + 126 + 127) << 23).view(torch.float32) \
        * (2.0 ** -126)
    out = torch.where(e >= -126, normal, tiny)
    return torch.where(e > 127, torch.full_like(out, float("inf")), out)


def ldexp(x: torch.Tensor, e) -> torch.Tensor:
    """x * 2^e, built as the reference builds it: split x with frexp,
    add the exponents, multiply the mantissa by an exact power of two."""
    x = x.to(torch.float32)
    e = _i32(e, x)
    m, ex = torch.frexp(x)
    big = ex.to(torch.int32) + e
    m = torch.where(big > 0, m * 2, m)
    big = torch.where(big > 0, big - 1, big)
    y = m * pow2(big)
    return torch.where(torch.isinf(x) | (x == 0), x, y)


def _ldexp2(x: torch.Tensor, e) -> torch.Tensor:
    """x * 2^e in two half-exponent ldexp steps (floor-halved, as the
    reference's ``e // 2``), so no intermediate factor over/underflows."""
    e = _i32(e, x)
    h = torch.div(e, 2, rounding_mode="floor")
    return ldexp(ldexp(x, h), e - h)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Saturating f32 -> int32 cast with NaN -> 0 (XLA's conversion;
    torch's own cast is undefined out of range)."""
    x = torch.nan_to_num(x.to(torch.float32), nan=0.0)
    hi = x >= 2.0 ** 31
    out = x.clamp(float(_I32_MIN), 2.0 ** 31).masked_fill(hi, 0.0)
    out = out.to(torch.int32)
    return out.masked_fill(hi, _I32_MAX)


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth two-sum: s = fl(a+b) and the exact rounding error e, six
    IEEE ops in this order (never to be simplified)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def choose_scale(max_abs, num_terms: int, qbits: int = 30) -> torch.Tensor:
    """Power-of-two scale 2^e with e = floor(qbits - log2(N * max_abs)),
    computed exactly.

    ``max_abs`` (floored at 2^-126) is M * 2^(ex-24) with an integer
    24-bit mantissa M, so L = N * M is an exact int64 and
    log2(N * max) = log2(L) + ex - 24: with b = bit_length(L), the floor
    is qbits - (ex - 24) - b, plus one when L is a power of two.  The
    degenerate all-zero (or NaN) stream gets the unit scale, and e is
    clamped to the f32 exponent range, as in the reference.
    """
    max_abs = torch.as_tensor(max_abs, dtype=torch.float32)
    n = max(int(num_terms), 1)
    floored = torch.clamp(max_abs, min=2.0 ** -126)
    mant, ex = torch.frexp(floored)
    big_m = (mant.to(torch.float64) * (1 << 24)).to(torch.int64)
    k = n.bit_length()
    lo_bits = 23 + k                       # L in [2^(22+k), 2^(24+k))
    prod = big_m * n
    b = torch.where(prod >= (1 << lo_bits), lo_bits + 1, lo_bits)
    is_pow2 = (big_m == (1 << 23)) & ((n & (n - 1)) == 0)
    e = qbits - (ex.to(torch.int64) - 24) - b + is_pow2.to(torch.int64)
    e = torch.where(torch.isinf(max_abs), torch.full_like(e, -126), e)
    e = torch.where(max_abs > 0, e, torch.zeros_like(e))
    return pow2(e.clamp(-126, 127).to(torch.int32))


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """round-half-even(x * scale) as int32."""
    return to_i32(torch.round(x.to(torch.float32) * scale))


def wrap_add(a: torch.Tensor, b: torch.Tensor):
    """int32 add plus the exact two's-complement wrap predicate."""
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    s = a + b
    return s, ((a ^ s) & (b ^ s)) < 0


def descale(xf: torch.Tensor, scale) -> torch.Tensor:
    """xf / scale; two exact half-exponent ldexp steps when scale is a
    power of two (its exponent read exactly from frexp), plain division
    otherwise."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=xf.device)
    xf = xf.to(torch.float32)
    mant, ex = torch.frexp(scale)
    e = ex.to(torch.int32) - 1
    exact = _ldexp2(xf, -e)
    return torch.where(mant == 0.5, exact, xf / scale)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return descale(q.to(torch.float32), scale)


def intac_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Exact-within-quantization, order-independent sum along ``axis``:
    one scale from the whole array's max |x| and the term count, int32
    quanta summed (wrapping, as the reference's int32 sum), descaled."""
    x = x.to(torch.float32)
    n = x.shape[axis]
    scale = choose_scale(torch.max(torch.abs(x)), n).to(x.device)
    q = quantize(x, scale)
    return dequantize(torch.sum(q, dim=axis, dtype=torch.int32), scale)


class LimbState(NamedTuple):
    """Two-limb carry-save accumulator: the value is
    (hi * 2^15 + lo) / scale.  Carries between the limbs wait for
    ``limbs_resolve``."""
    hi: torch.Tensor      # int32
    lo: torch.Tensor      # int32
    scale: torch.Tensor   # f32, 0-d


def _scale_tensor(scale, device) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32).to(device)


def limb_init(shape, scale, *, device=None) -> LimbState:
    """Zero limbs of ``shape`` on ``device`` (None: the CPU)."""
    z = torch.zeros(tuple(shape), dtype=torch.int32, device=device)
    return LimbState(z, z, _scale_tensor(scale, z.device))


def limb_split(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q == hi * 2^15 + lo with lo in [0, 2^15): arithmetic shift + mask."""
    q = q.to(torch.int32)
    return q >> LIMB_SHIFT, q & ((1 << LIMB_SHIFT) - 1)


def limbs_canonical(hi: torch.Tensor, lo: torch.Tensor):
    """Carry lo's bits above LIMB_SHIFT into hi (the Euclidean pair)."""
    return hi + (lo >> LIMB_SHIFT), lo & ((1 << LIMB_SHIFT) - 1)


def limb_add(state: LimbState, x: torch.Tensor) -> LimbState:
    """Push one operand: quantize to int32 first (|x * scale| < 2^31),
    split with shift and mask, add each limb."""
    hi, lo = limb_split(quantize(x, state.scale))
    return LimbState(state.hi + hi, state.lo + lo, state.scale)


def limbs_resolve(hi: torch.Tensor, lo: torch.Tensor, scale) -> torch.Tensor:
    """Canonicalize the limbs, then one f32 rounding: hi * 2^15 + lo,
    descaled.  ``lo`` is a sum of remainders in [0, 2^15), so >= 0."""
    hi, lo = limbs_canonical(hi, lo)
    total = ldexp(hi.to(torch.float32), LIMB_SHIFT) + lo.to(torch.float32)
    return descale(total, scale)


def limb_finalize(state: LimbState) -> torch.Tensor:
    return limbs_resolve(state.hi, state.lo, state.scale)


def limb_merge(a: LimbState, b: LimbState) -> LimbState:
    """Integer adds: exact and order-free; ``a``'s scale is kept."""
    return LimbState(a.hi + b.hi, a.lo + b.lo, a.scale)


class Limb3State(NamedTuple):
    """Three-limb carry-save accumulator: (hi, lo) int32 limbs plus the
    compensated f32 residual pair (res, comp); the value is
    (hi * 2^15 + lo) / scale + res + comp.  ``ovf`` counts int32 limb
    wraps (``wrap_add``); None turns the count off."""
    hi: torch.Tensor      # int32
    lo: torch.Tensor      # int32
    res: torch.Tensor     # f32: the exactly captured quantization residuals
    comp: torch.Tensor    # f32: the two_sum compensation of ``res``
    scale: torch.Tensor   # f32, 0-d
    ovf: Optional[torch.Tensor] = None


def limb3_init(shape, scale, *, device=None) -> Limb3State:
    z = torch.zeros(tuple(shape), dtype=torch.int32, device=device)
    r = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    return Limb3State(z, z, r, r, _scale_tensor(scale, z.device), z)


def limb_split3(x: torch.Tensor, scale):
    """One f32 operand -> (hi, lo, residual), losslessly: the residual
    x - q / scale is exact for a power-of-two scale (Sterbenz)."""
    x = x.to(torch.float32)
    q = quantize(x, scale)
    hi, lo = limb_split(q)
    return hi, lo, x - dequantize(q, scale)


def limb_add3(state: Limb3State, x: torch.Tensor) -> Limb3State:
    """Push one operand: limbs through ``wrap_add`` (each wrap counted in
    ``ovf``), the residual through ``two_sum``."""
    hi, lo, r = limb_split3(x, state.scale)
    nhi, w1 = wrap_add(state.hi, hi)
    nlo, w2 = wrap_add(state.lo, lo)
    s, e = two_sum(state.res, r)
    ovf = state.ovf
    if ovf is not None:
        ovf = ovf + w1.to(torch.int32) + w2.to(torch.int32)
    return Limb3State(nhi, nlo, s, state.comp + e, state.scale, ovf)


def limb_merge3(a: Limb3State, b: Limb3State) -> Limb3State:
    """Limbs add exactly (wraps counted), the residual pairs through
    ``two_sum``: deterministic for a pinned merge order."""
    nhi, w1 = wrap_add(a.hi, b.hi)
    nlo, w2 = wrap_add(a.lo, b.lo)
    s, e = two_sum(a.res, b.res)
    ovf = None
    if a.ovf is not None or b.ovf is not None:
        za = torch.zeros_like(nhi)
        ovf = ((a.ovf if a.ovf is not None else za)
               + (b.ovf if b.ovf is not None else za)
               + w1.to(torch.int32) + w2.to(torch.int32))
    return Limb3State(nhi, nlo, s, a.comp + b.comp + e, a.scale, ovf)


def limbs_resolve3(hi: torch.Tensor, lo: torch.Tensor, res: torch.Tensor,
                   scale, comp: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Canonicalize the limbs, split hi once more (it may need 31 bits),
    and fold lo, hi's low and high parts into the residual pair
    least-significant-first through compensated two-sums."""
    hi, lo = limbs_canonical(hi, lo)
    hsplit = 14
    hih = hi >> hsplit
    hil = hi & ((1 << hsplit) - 1)
    acc = res.to(torch.float32)
    cmp_ = torch.zeros_like(acc) if comp is None else comp.to(torch.float32)
    for quanta, shift in ((lo, 0), (hil, LIMB_SHIFT),
                          (hih, LIMB_SHIFT + hsplit)):
        term = descale(_ldexp2(quanta.to(torch.float32), shift), scale)
        acc, e = two_sum(acc, term)
        cmp_ = cmp_ + e
    return acc + cmp_


def limb3_finalize(state: Limb3State) -> torch.Tensor:
    return limbs_resolve3(state.hi, state.lo, state.res, state.scale,
                          comp=state.comp)


def bin_ref_exponent(max_abs) -> torch.Tensor:
    """Window anchor: e with max_abs * 2^-e in [0.5, 1)."""
    m = torch.clamp(torch.as_tensor(max_abs, dtype=torch.float32),
                    min=2.0 ** -126)
    return torch.frexp(m)[1].to(torch.int32)


def bin_digits(x: torch.Tensor, e_ref, *, bits: int = BIN_BITS,
               num: int = NUM_BINS):
    """Yield the ``num`` f32 digit planes of ``bin_split`` in order (each
    an integer-valued f32 of magnitude <= 2^bits), so callers can write
    them straight into a preallocated domain."""
    v = _ldexp2(x.to(torch.float32), -_i32(e_ref, x))
    radix = float(1 << bits)
    for _ in range(num):
        s = v * radix
        d = torch.round(s)
        v = s - d                     # exact: both multiples of ulp(s)
        yield d


def bin_split(x: torch.Tensor, e_ref, *, bits: int = BIN_BITS,
              num: int = NUM_BINS) -> torch.Tensor:
    """(num, *x.shape) int32 exponent-bin digits (Dekker extraction)."""
    return torch.stack([to_i32(d) for d in
                        bin_digits(x, e_ref, bits=bits, num=num)])


def _bin_carry_resolve(bins: torch.Tensor, bits: int) -> list:
    """Canonicalize (num, ...) int32 digit bins: each digit beyond
    +-2^(bits-1) carries into the next-more-significant bin."""
    num = bins.shape[0]
    resolved = [bins[k] for k in range(num)]
    half = 1 << (bits - 1)
    for k in range(num - 1, 0, -1):
        c = (resolved[k] + half) >> bits
        resolved[k] = resolved[k] - (c << bits)
        resolved[k - 1] = resolved[k - 1] + c
    return resolved


def bin_combine(bins: torch.Tensor, e_ref, *,
                bits: int = BIN_BITS) -> torch.Tensor:
    """(num, ...) int32 bins -> f32: integer carry-resolve, then a
    least-significant-first compensated combine."""
    e_ref = _i32(e_ref, bins)
    num = bins.shape[0]
    resolved = _bin_carry_resolve(bins, bits)
    acc = torch.zeros(bins.shape[1:], dtype=torch.float32,
                      device=bins.device)
    comp = torch.zeros_like(acc)
    for k in range(num - 1, -1, -1):
        term = _ldexp2(resolved[k].to(torch.float32),
                       e_ref - (k + 1) * bits)
        acc, e = two_sum(acc, term)
        comp = comp + e
    return acc + comp


def limbs_resolve3_binned(hi: torch.Tensor, lo: torch.Tensor,
                          rbins: torch.Tensor, scale, *,
                          bits: int = RES_BIN_BITS) -> torch.Tensor:
    """Resolve (hi, lo) limbs plus binned residual digits into f32: every
    input to the float combine is a canonical integer, combined
    least-significant-first through compensated two-sums."""
    hi, lo = limbs_canonical(hi, lo)
    num = rbins.shape[0]
    resolved = _bin_carry_resolve(rbins, bits)
    hsplit = 14                      # hi may need 31 bits: split it once
    hih = hi >> hsplit
    hil = hi & ((1 << hsplit) - 1)
    acc = torch.zeros(hi.shape, dtype=torch.float32, device=hi.device)
    cmp_ = torch.zeros_like(acc)
    terms = [(resolved[k], -(k + 1) * bits) for k in range(num - 1, -1, -1)]
    terms += [(lo, 0), (hil, LIMB_SHIFT), (hih, LIMB_SHIFT + hsplit)]
    for quanta, shift in terms:
        term = descale(_ldexp2(quanta.to(torch.float32), shift), scale)
        acc, e = two_sum(acc, term)
        cmp_ = cmp_ + e
    return acc + cmp_


# ---------------------------------------------------------------------------
# Sums across the ranks of a process group
# ---------------------------------------------------------------------------


def fused_psum(arrays, group):
    """One integer ``psum`` per dtype instead of one per tensor: the
    tensors of a dtype are concatenated, summed across the group's ranks
    in one collective and split back.  psum is elementwise, so the bits
    are those of one collective each.  Integer tensors only
    (``comm.psum``)."""
    arrays = tuple(arrays)
    by_dtype = {}
    for i, a in enumerate(arrays):
        by_dtype.setdefault(a.dtype, []).append(i)
    out = [None] * len(arrays)
    for idxs in by_dtype.values():
        flat = comm.psum(torch.cat([arrays[i].reshape(-1) for i in idxs]),
                         group)
        off = 0
        for i in idxs:
            size = arrays[i].numel()
            out[i] = flat[off:off + size].reshape(arrays[i].shape)
            off += size
    return tuple(out)


def _gmax(x: torch.Tensor, group) -> torch.Tensor:
    return comm.pmax(torch.max(torch.abs(x.to(torch.float32))), group)


def intac_psum(x: torch.Tensor, group, *, qbits: int = 30,
               nterms: Optional[int] = None) -> torch.Tensor:
    """Bitwise-deterministic sum across ranks: one power-of-two scale from
    the pmax-shared max |x| and the rank count, int32 quanta summed by an
    integer ``psum`` (any order, the same bits), dequantized once."""
    n = nterms or comm.axis_size(group)
    scale = choose_scale(_gmax(x, group), n, qbits).to(x.device)
    q = quantize(x, scale)
    return dequantize(comm.psum(q, group), scale)


def intac_psum2(x: torch.Tensor, group, *, qbits: int = 30) -> torch.Tensor:
    """Two-limb exact sum across ranks: the scale sized by magnitude alone
    (``num_terms=1``), each rank's quanta split into (hi, lo) limbs, both
    limbs summed as integers, one ``limbs_resolve``."""
    scale = choose_scale(_gmax(x, group), 1, qbits).to(x.device)
    hi, lo = limb_split(quantize(x, scale))
    hi, lo = fused_psum((hi, lo), group)
    return limbs_resolve(hi, lo, scale)


def limb3_merge_across(hi: torch.Tensor, lo: torch.Tensor, res: torch.Tensor,
                       comp: torch.Tensor, group):
    """The one merge of three-limb state across ranks -> (hi, lo, res,
    comp): the limbs sum as integers; the residual pair is split into
    exponent-indexed int32 digits of a window anchored at the
    pmax-shared residual maximum, the digits sum as integers in the same
    ``psum`` as the limbs, and one carry-resolve rebuilds the residual
    (comp comes back zero).  Every input to the result is a pure
    function of the ranks' states taken together, so the merged state is
    bitwise the same at any rank count or order."""
    m = torch.maximum(torch.max(torch.abs(res)), torch.max(torch.abs(comp)))
    e_ref = bin_ref_exponent(comm.pmax(m, group))
    digits = (bin_split(res, e_ref, bits=RES_BIN_BITS, num=RES_NUM_BINS)
              + bin_split(comp, e_ref, bits=RES_BIN_BITS, num=RES_NUM_BINS))
    hi, lo, digits = fused_psum((hi, lo, digits), group)
    res = bin_combine(digits, e_ref, bits=RES_BIN_BITS)
    return hi, lo, res, torch.zeros_like(res)


def intac_psum3(x: torch.Tensor, group, *, qbits: int = 30) -> torch.Tensor:
    """Three-limb exact sum across ranks: ``intac_psum2``'s limbs plus the
    exactly captured quantization residual (``limb3_merge_across``);
    bitwise the same at any rank count, within 1 ulp of float64."""
    scale = choose_scale(_gmax(x, group), 1, qbits).to(x.device)
    hi, lo, res = limb_split3(x, scale)
    hi, lo, res, comp = limb3_merge_across(hi, lo, res, torch.zeros_like(res),
                                           group)
    return limbs_resolve3(hi, lo, res, scale, comp=comp)


def bin_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Exponent-binned exact sum across ranks: a pmax-shared anchor, each
    rank's digit bins summed as integers, one carry-resolve."""
    e_ref = bin_ref_exponent(_gmax(x, group)).to(x.device)
    return bin_combine(comm.psum(bin_split(x, e_ref), group), e_ref)


class EFState(NamedTuple):
    """Error-feedback residual of the compressed gradient mean."""
    residual: torch.Tensor


def compressed_psum_mean(x: torch.Tensor, residual: torch.Tensor, group, *,
                         bits: int = 8):
    """The compressed gradient mean with error feedback -> (mean, new
    residual): the carried residual is added, one power-of-two scale for
    ``bits``-bit payloads is shared by pmax, the quanta sum as integers
    across ranks and are dequantized once; what quantization dropped on
    this rank is its next residual."""
    xr = x.to(torch.float32) + residual
    n = comm.axis_size(group)
    scale = choose_scale(_gmax(xr, group), 1, qbits=bits - 1).to(x.device)
    q = quantize(xr, scale)
    new_residual = xr - dequantize(q, scale)
    total = comm.psum(q, group)
    return dequantize(total, scale) / n, new_residual


def compressed_psum_mean_tree(grads, residuals, group, *, bits: int = 8):
    """``compressed_psum_mean`` over a dict of tensors, leaf by leaf in
    the dict's order -> (means, new residuals)."""
    out, res = {}, {}
    for k, g in grads.items():
        out[k], res[k] = compressed_psum_mean(g, residuals[k], group,
                                              bits=bits)
    return out, res


def zeros_like_residuals(grads):
    """Zero float32 residuals shaped as ``grads`` (a dict of tensors)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}
