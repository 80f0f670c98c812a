"""Signal-processing and vision ONNX ops: DFT, STFT, MelWeightMatrix,
GridSample, RoiAlign, DeformConv and the random family.

Counterpart of ``infera_tpu/onnx/signal_vision_ops.py``, as eager torch ops:

- DFT and STFT are dense matmuls against [k, n] cosine and sine bases,
  built in f64 with numpy and cast to f32 (moved to the device once per
  node), not ``torch.fft``: the same sums as ``infera_tpu``'s.
- MelWeightMatrix folds to a constant on the host (the ONNX reference's
  integer-bin triangles).
- GridSample and RoiAlign are batched gathers with the corner weights
  computed elementwise (GridSample rounds nearest half to even and reflects
  as ``infera_tpu`` does); RoiAlign's adaptive sampling grid needs static
  rois or an explicit ``sampling_ratio``. DeformConv samples each kernel tap
  with four gathers and contracts with one einsum (TF32 off).
- The random ops draw from a ``torch.Generator`` on the model's device,
  seeded from ``infera_tpu``'s folded seed (``_seed``): the same seed gives
  the same values on every call, another seed other values. ONNX leaves the
  values arbitrary; they are not ``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import OnnxError
from .ops import _node_const, _saturating_cast, register

# ---------------------------------------------------------------------------
# DFT family
# ---------------------------------------------------------------------------


def _dft_matrices(ctx, node, n: int, n_out: int, inverse: bool):
    """[n_out, n] cosine and sine bases (f64 trig, f32 values) on the device."""
    def basis(fn):
        k = np.arange(n_out, dtype=np.float64)[:, None]
        j = np.arange(n, dtype=np.float64)[None, :]
        m = fn(2.0 * np.pi * k * j / n)
        return (m / n if inverse else m).astype(np.float32)

    key = ("dft", n, n_out, inverse)
    return (_node_const(node, ctx, key + ("cos",), lambda: basis(np.cos)),
            _node_const(node, ctx, key + ("sin",), lambda: basis(np.sin)))


def _apply_dft(ctx, node, xr, xi, n: int, onesided: bool, inverse: bool):
    """The DFT along the LAST axis of xr/xi; (re, im), the last axis sized
    n // 2 + 1 when onesided."""
    n_out = n // 2 + 1 if onesided else n
    c, s = _dft_matrices(ctx, node, n, n_out, inverse)

    def mm(v, m):
        return torch.matmul(v, m.T)

    if inverse:  # e^{+i theta}
        re = mm(xr, c) - mm(xi, s) if xi is not None else mm(xr, c)
        im = mm(xr, s) + mm(xi, c) if xi is not None else mm(xr, s)
    else:  # e^{-i theta}
        re = mm(xr, c) + mm(xi, s) if xi is not None else mm(xr, c)
        im = -mm(xr, s) + mm(xi, c) if xi is not None else -mm(xr, s)
    return re, im


@register("DFT", static=(1, 2))
def _dft(node, inputs, ctx):
    x = inputs[0].float()
    inverse = bool(node.attr("inverse", 0))
    onesided = bool(node.attr("onesided", 0))
    if inverse and onesided:
        raise OnnxError("DFT: inverse and onesided are mutually exclusive")
    axis = int(node.attr("axis", 1))
    if len(inputs) > 2 and inputs[2] is not None:  # opset-20 axis input
        ax = ctx.as_static(inputs[2])
        if ax is None:
            raise OnnxError("DFT: axis must be statically known")
        axis = int(np.asarray(ax))
    if axis < 0:
        axis += x.dim()
    if axis == x.dim() - 1:
        raise OnnxError("DFT: axis cannot be the component dimension")
    comp = x.shape[-1]
    if comp not in (1, 2):
        raise OnnxError("DFT: last dimension must be 1 (real) or 2 (complex)")
    n = x.shape[axis]
    if len(inputs) > 1 and inputs[1] is not None:
        dl = ctx.as_static(inputs[1])
        if dl is None:
            raise OnnxError("DFT: dft_length must be statically known")
        dft_length = int(np.asarray(dl))
        if dft_length < n:
            x = x.narrow(axis, 0, dft_length)
        elif dft_length > n:
            pad = [0, 0] * (x.dim() - 1 - axis) + [0, dft_length - n]
            x = torch.nn.functional.pad(x, pad)
        n = dft_length
    # the transform axis last (the components split off first)
    xr = torch.movedim(x[..., 0], axis, -1)
    xi = torch.movedim(x[..., 1], axis, -1) if comp == 2 else None
    re, im = _apply_dft(ctx, node, xr, xi, n, onesided, inverse)
    return [torch.stack([torch.movedim(re, -1, axis), torch.movedim(im, -1, axis)], dim=-1)]


@register("STFT", static=(1, 3))
def _stft(node, inputs, ctx):
    signal = inputs[0].float()
    onesided = bool(node.attr("onesided", 1))
    step = ctx.as_static(inputs[1])
    if step is None:
        raise OnnxError("STFT: frame_step must be statically known")
    step = int(np.asarray(step))
    window = inputs[2] if len(inputs) > 2 else None
    frame_length = None
    if len(inputs) > 3 and inputs[3] is not None:
        fl = ctx.as_static(inputs[3])
        if fl is None:
            raise OnnxError("STFT: frame_length must be statically known")
        frame_length = int(np.asarray(fl))
    if frame_length is None:
        if window is None:
            raise OnnxError("STFT: needs window or frame_length")
        frame_length = int(window.shape[0])
    comp = signal.shape[-1]
    if comp not in (1, 2):
        raise OnnxError("STFT: last dimension must be 1 (real) or 2")
    if onesided and comp == 2:
        raise OnnxError("STFT: onesided requires a real signal")
    frames = (signal.shape[1] - frame_length) // step + 1
    if frames < 1:
        raise OnnxError("STFT: signal shorter than one frame")
    # [b, frames, frame_length, c]: overlapping frames as a strided view
    framed = signal.unfold(1, frame_length, step).movedim(-1, 2)
    if window is not None:
        framed = framed * window.float()[None, None, :, None]
    xr = framed[..., 0]
    xi = framed[..., 1] if comp == 2 else None
    re, im = _apply_dft(ctx, node, xr, xi, frame_length, onesided, inverse=False)
    return [torch.stack([re, im], dim=-1)]


@register("MelWeightMatrix", static=(0, 1, 2, 3, 4))
def _mel_weight_matrix(node, inputs, ctx):
    vals = [ctx.as_static(v) for v in inputs[:5]]
    if any(v is None for v in vals):
        raise OnnxError("MelWeightMatrix: all five inputs must be statically known")
    num_mel, dft_length, sample_rate = (int(np.asarray(v)) for v in vals[:3])
    low_hz, high_hz = (float(np.asarray(v)) for v in vals[3:5])
    key = ("mel", num_mel, dft_length, sample_rate, low_hz, high_hz)
    # an f64 output is f32 on the device, as infera_tpu's (x64 off)
    return [_node_const(node, ctx, key, lambda: _mel_triangles(*key[1:]).astype(np.float32))]


def _mel_triangles(num_mel, dft_length, sample_rate, low_hz, high_hz) -> np.ndarray:
    """[dft_length // 2 + 1, num_mel] f64 triangles on integer FFT-bin
    centres, as in the ONNX reference implementation."""
    n_spec = dft_length // 2 + 1

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(low_hz), hz_to_mel(high_hz), num_mel + 2)
    bins = np.floor((dft_length + 1) * mel_to_hz(mel_pts) / sample_rate)
    out = np.zeros((n_spec, num_mel), np.float64)
    spec = np.arange(n_spec, dtype=np.float64)
    for i in range(num_mel):
        left, center, right = bins[i], bins[i + 1], bins[i + 2]
        up = (spec - left) / max(center - left, 1.0)
        down = (right - spec) / max(right - center, 1.0)
        tri = np.maximum(0.0, np.minimum(up, down))
        tri[spec > right] = 0.0
        tri[spec < left] = 0.0
        out[:, i] = tri
    return out


# ---------------------------------------------------------------------------
# GridSample / RoiAlign
# ---------------------------------------------------------------------------


def _i32(t):
    """XLA's convert of floats to int32 (NaN to 0, saturating), as long."""
    return _saturating_cast(t, np.int32).long()


def _mod(x, y: float):
    """``jnp.mod`` of floats: C's fmod, moved to the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord, size: int, align_corners: bool):
    """Reflection padding in continuous coordinates (torch's semantics)."""
    if size == 1:
        return torch.zeros_like(coord)
    if align_corners:
        span = 2.0 * (size - 1)
        c = torch.abs(_mod(coord, span))
        return torch.where(c > size - 1, span - c, c)
    span = 2.0 * size
    c = torch.abs(_mod(coord + 0.5, span))
    c = torch.where(c > size, span - c, c) - 0.5
    return torch.clamp(c, 0.0, size - 1)


def _sample_2d(xp, b_idx, ys, xs, H: int, W: int, padding: str,
               align_corners: bool, nearest: bool):
    """Gather and interpolate xp [N, H, W, C] at the continuous (ys, xs)
    (broadcast against the batch index ``b_idx``); returns [..., C]."""
    if padding == "reflection":
        ys = _reflect(ys, H, align_corners)
        xs = _reflect(xs, W, align_corners)
    if nearest:
        yi = _i32(torch.round(ys))
        xi = _i32(torch.round(xs))
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = xp[b_idx, torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        if padding == "zeros":
            v = torch.where(inb[..., None], v, 0.0)
        return v
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yi = _i32(y0) + dy
            xi = _i32(x0) + dx
            inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = xp[b_idx, torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
            w = wy * wx
            if padding == "zeros":
                w = torch.where(inb, w, 0.0)
            out = out + v * w[..., None]
    return out


@register("GridSample")
def _grid_sample(node, inputs, ctx):
    x = inputs[0].float()
    grid = inputs[1].float()
    mode = node.attr("mode", "linear")
    if mode == "bilinear":
        mode = "linear"
    if mode not in ("linear", "nearest"):
        raise OnnxError(f"GridSample: unsupported mode '{mode}'")
    padding = node.attr("padding_mode", "zeros")
    if padding not in ("zeros", "border", "reflection"):
        raise OnnxError(f"GridSample: unsupported padding_mode '{padding}'")
    align = bool(node.attr("align_corners", 0))
    if x.dim() != 4 or grid.dim() != 4:
        raise OnnxError("GridSample: only 4-D (NCHW) input is supported")
    N, C, H, W = x.shape
    xp = x.permute(0, 2, 3, 1)  # NHWC: the channels trail each gather
    gx = _unnormalize(grid[..., 0], W, align)  # [N, Ho, Wo]
    gy = _unnormalize(grid[..., 1], H, align)
    b_idx = torch.arange(N, device=x.device)[:, None, None]
    out = _sample_2d(xp, b_idx, gy, gx, H, W, padding, align, nearest=(mode == "nearest"))
    return [out.permute(0, 3, 1, 2)]


@register("RoiAlign", static=(1,))
def _roi_align(node, inputs, ctx):
    x = inputs[0].float()
    rois = ctx.tensor(node, 1, inputs[1]).float()
    batch_idx = inputs[2].long()
    out_h = int(node.attr("output_height", 1))
    out_w = int(node.attr("output_width", 1))
    ratio = int(node.attr("sampling_ratio", 0))
    scale = float(node.attr("spatial_scale", 1.0))
    mode = node.attr("mode", "avg")
    ctm = node.attr("coordinate_transformation_mode", "half_pixel")
    if mode not in ("avg", "max"):
        raise OnnxError(f"RoiAlign: unsupported mode '{mode}'")
    N, C, H, W = x.shape
    R = rois.shape[0]
    if ratio < 1:
        static_rois = ctx.as_static(inputs[1])
        if static_rois is None:
            raise OnnxError(
                "RoiAlign: sampling_ratio=0 (adaptive) needs static rois; "
                "set an explicit sampling_ratio for runtime rois")
        r = np.asarray(static_rois, np.float64) * scale
        if ctm == "half_pixel":
            r = r - 0.5
        rw = r[:, 2] - r[:, 0]
        rh = r[:, 3] - r[:, 1]
        if ctm != "half_pixel":
            rw, rh = np.maximum(rw, 1.0), np.maximum(rh, 1.0)
        # one static grid covering every roi's adaptive count
        ratio = max(1, int(np.ceil(max(rw.max() / out_w, rh.max() / out_h))) if R else 1)
    xp = x.permute(0, 2, 3, 1)  # NHWC
    x1, y1, x2, y2 = (rois[:, i] * scale for i in range(4))
    if ctm == "half_pixel":
        x1, y1, x2, y2 = x1 - 0.5, y1 - 0.5, x2 - 0.5, y2 - 0.5
    rw = x2 - x1
    rh = y2 - y1
    if ctm != "half_pixel":
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bin_w = rw / out_w
    bin_h = rh / out_h
    dev = x.device
    ph = torch.arange(out_h, dtype=torch.float32, device=dev)
    pw = torch.arange(out_w, dtype=torch.float32, device=dev)
    steps = torch.arange(ratio, dtype=torch.float32, device=dev)
    # ys: [R, out_h, sample_y]; xs: [R, out_w, sample_x]
    ys = (y1[:, None, None] + ph[None, :, None] * bin_h[:, None, None]
          + (steps[None, None, :] + 0.5) * bin_h[:, None, None] / ratio)
    xs = (x1[:, None, None] + pw[None, :, None] * bin_w[:, None, None]
          + (steps[None, None, :] + 0.5) * bin_w[:, None, None] / ratio)
    # broadcast to [R, out_h, out_w, sy, sx]
    shape = (R, out_h, out_w, ratio, ratio)
    ysb = ys[:, :, None, :, None]
    xsb = xs[:, None, :, None, :]
    yc = torch.clamp(ysb.expand(shape), 0.0, H - 1)
    xc = torch.clamp(xsb.expand(shape), 0.0, W - 1)
    # the ONNX reference: samples wholly outside [-1, size] add nothing
    valid = ((ysb > -1.0) & (ysb < H) & (xsb > -1.0) & (xsb < W)).expand(shape)
    b_idx = batch_idx[:, None, None, None, None]
    v = _sample_2d(xp, b_idx, yc, xc, H, W, "border", True, nearest=False)
    v = torch.where(valid[..., None], v, 0.0 if mode == "avg" else float("-inf"))
    if mode == "avg":
        out = v.sum(dim=(3, 4)) / torch.clamp(valid.sum(dim=(3, 4))[..., None].float(), min=1.0)
    else:
        out = torch.amax(v, dim=(3, 4))
        out = torch.where(torch.isfinite(out), out, 0.0)
    return [out.permute(0, 3, 1, 2)]


@register("DeformConv")
def _deform_conv(node, inputs, ctx):
    """Deformable convolution v2 (opset 19): the offsets are runtime
    tensors but every shape is static, so each kernel tap is four gathers
    with bilinear weights (zero outside the input), and the tap-weighted
    contraction is one einsum."""
    x = inputs[0].float()
    w = inputs[1].float()
    offset = inputs[2].float()
    b = inputs[3] if len(inputs) > 3 and inputs[3] is not None else None
    mask = inputs[4].float() if len(inputs) > 4 and inputs[4] is not None else None
    if x.dim() != 4:
        raise OnnxError("DeformConv: only 2-D (NCHW) input is supported")
    N, C, H, W = x.shape
    oC, wc, kH, kW = w.shape
    group = int(node.attr("group", 1))
    og = int(node.attr("offset_group", 1))
    strides = [int(v) for v in node.attr("strides", [1, 1])]
    dil = [int(v) for v in node.attr("dilations", [1, 1])]
    pads = [int(v) for v in node.attr("pads", [0, 0, 0, 0])]
    oH, oW = offset.shape[2], offset.shape[3]
    dev = x.device
    # the base sampling grid of each tap: [kH, kW, oH, oW]
    oy = torch.arange(oH, dtype=torch.float32, device=dev) * strides[0] - pads[0]
    ox = torch.arange(oW, dtype=torch.float32, device=dev) * strides[1] - pads[1]
    ky = torch.arange(kH, dtype=torch.float32, device=dev) * dil[0]
    kx = torch.arange(kW, dtype=torch.float32, device=dev) * dil[1]
    base_y = ky[:, None, None, None] + oy[None, None, :, None]
    base_x = kx[None, :, None, None] + ox[None, None, None, :]
    off = offset.reshape(N, og, kH, kW, 2, oH, oW)
    ys = base_y[None, None] + off[:, :, :, :, 0]   # [N, og, kH, kW, oH, oW]
    xs = base_x[None, None] + off[:, :, :, :, 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    xp = x.permute(0, 2, 3, 1).reshape(N, H, W, og, C // og)
    b_idx = torch.arange(N, device=dev)[:, None, None, None, None, None]
    g_idx = torch.arange(og, device=dev)[None, :, None, None, None, None]
    sampled = 0.0
    for dy, wy in ((0, 1.0 - ly), (1, ly)):
        for dx, wx in ((0, 1.0 - lx), (1, lx)):
            yi = _i32(y0) + dy
            xi = _i32(x0) + dx
            inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = xp[b_idx, torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1), g_idx]
            sampled = sampled + v * torch.where(inb, wy * wx, 0.0)[..., None]
    if mask is not None:
        sampled = sampled * mask.reshape(N, og, kH, kW, oH, oW)[..., None]
    # [N, og, kH, kW, oH, oW, C//og] -> [N, C, kH, kW, oH, oW]
    sampled = torch.movedim(sampled, -1, 2).reshape(N, og * (C // og), kH, kW, oH, oW)
    # grouped contraction: each output channel sees C/group input channels
    sg = sampled.reshape(N, group, C // group, kH, kW, oH, oW)
    wg = w.reshape(group, oC // group, wc, kH, kW)
    out = torch.einsum("ngcijhw,gocij->ngohw", sg, wg).reshape(N, oC, oH, oW)
    if b is not None:
        out = out + b.float()[None, :, None, None]
    return [out]


# ---------------------------------------------------------------------------
# The random family: a torch.Generator on the model's device, seeded from
# the seed attribute as infera_tpu folds it (a fixed default when unseeded)
# ---------------------------------------------------------------------------


def _seed(node) -> int:
    seed = node.attr("seed")
    bits = np.uint64(np.float64(seed if seed is not None else 0.0).view(np.uint64))
    # fold all 64 bits of the seed (the low word of a small float's bits is
    # zero: masking alone would alias 3.0 and 4.0)
    folded = int(bits >> np.uint64(32)) ^ int(bits & np.uint64(0xFFFFFFFF))
    return folded & 0x7FFFFFFF


def _generator(node, ctx):
    return torch.Generator(device=ctx.device).manual_seed(_seed(node))


def _rand_shape(node, inputs, like):
    if like:
        return tuple(inputs[0].shape)
    return tuple(int(v) for v in node.attr("shape"))


def _rand_dtype(node, default=1):
    # f64 is f32 on the device, as infera_tpu's (x64 off)
    return {1: torch.float32, 11: torch.float32,
            10: torch.bfloat16}.get(int(node.attr("dtype", default)), torch.float32)


def _random_normal(like):
    def impl(node, inputs, ctx):
        shape = _rand_shape(node, inputs, like)
        v = torch.randn(shape, generator=_generator(node, ctx), device=ctx.device)
        v = v * float(node.attr("scale", 1.0)) + float(node.attr("mean", 0.0))
        return [v.to(_rand_dtype(node))]

    return impl


def _random_uniform(like):
    def impl(node, inputs, ctx):
        shape = _rand_shape(node, inputs, like)
        low = float(node.attr("low", 0.0))
        high = float(node.attr("high", 1.0))
        v = torch.rand(shape, generator=_generator(node, ctx), device=ctx.device)
        return [(v * (high - low) + low).to(_rand_dtype(node))]

    return impl


register("RandomNormal")(_random_normal(False))
register("RandomNormalLike")(_random_normal(True))
register("RandomUniform")(_random_uniform(False))
register("RandomUniformLike")(_random_uniform(True))


@register("Bernoulli")
def _bernoulli(node, inputs, ctx):
    p = inputs[0].float()
    u = torch.rand(p.shape, generator=_generator(node, ctx), device=ctx.device)
    dtype = _rand_dtype(node, default=0) if node.attr("dtype") is not None else p.dtype
    return [(u < p).to(dtype)]


@register("Multinomial")
def _multinomial(node, inputs, ctx):
    logits = inputs[0].float()  # [batch, classes]
    n = int(node.attr("sample_size", 1))
    probs = torch.softmax(logits, dim=-1)
    out = torch.multinomial(probs, n, replacement=True, generator=_generator(node, ctx))
    return [out.to(torch.int32)]
