"""Plain PyTorch reference of the Swin UNETR ppp+dec network and its
training step.

Written from Hatamizadeh et al., "Swin UNETR: Swin Transformers for
Semantic Segmentation of Brain Tumors in MRI Images" (arXiv:2201.01266)
and MONAI's ``monai/networks/nets/swin_unetr.py`` (``SwinUNETR`` with
``normalize=True``, ``norm_name="instance"``, no dropout or drop-path),
in functional ops over a flat dict of leaves as ``model.py`` holds the
U-Net:

- patch embed: ``Conv3d(C_in, F, k=2, s=2)`` with a bias, no norm, odd
  extents zero-padded at the end;
- stage i: ``depths[i]`` Swin blocks at ``F * 2**i`` channels;
  ``x = x + proj(WA(LN1(x)))``, ``x = x + fc2(GELU(fc1(LN2(x))))``, the
  exact GELU, LayerNorm epsilon 1e-5, biases on qkv, proj, fc1 and fc2;
- ``WA``: the normalised tokens zero-padded to window multiples (padded
  tokens not masked), cut into windows, ``softmax(q * hd**-0.5 @ k^T +
  B[index] + M) @ v``; ``B`` a ((2w - 1)^3, heads) table, ``index`` the
  full window's relative positions cut to the first n x n entries for a
  window of n tokens (``relative_position_index[:n, :n]``); odd blocks
  roll by -w // 2 before and +w // 2 after, ``M`` MONAI's
  ``compute_mask`` (-100 across the regions of the rolled padded
  extent); a stage no wider than the window takes the extent as its
  window and no shift (``get_window_size``);
- patch merging after every stage: ``cat`` of ``x[:, i::2, j::2,
  k::2]`` over ``itertools.product(range(2), repeat=3)``, ``LN(8C)``,
  ``Linear(8C -> 2C)`` without a bias;
- each hidden state through ``F.layer_norm`` over channels (no affine,
  epsilon 1e-5);
- ``UnetResBlock``: conv3 (no bias) -> IN -> LeakyReLU(0.01) -> conv3 ->
  IN, plus conv1 -> IN of the input where the channel counts differ,
  then LeakyReLU; IN without an affine, epsilon 1e-5;
- decoder: ``enc0 = Res(x)``, ``enc_i = Res(h_{i-1})`` for the first
  stages, the bottleneck ``Res(h_n)``, then up blocks
  (``ConvTranspose3d(k=2, s=2)`` without a bias, ``cat((up, skip))``,
  ``Res(2C -> C)``) from the bottleneck to the input's resolution, the
  last hidden state before the bottleneck a skip as it is;
- MONAI's ``out`` convolution replaced by the ppp+dec heads, and the code
  decoder, of ``model.py``.

Departures from MONAI: ``SwinUNETR``'s default ``PatchMerging`` orders
the eight neighbours its own way; this follows ``PatchMergingV2``'s
order.  None else.  Leaves are named as the program's checkpoints name
them (Flax layout: conv kernels (kz, ky, kx, in, out), a ``Dense``
kernel (in, out), a transposed convolution's kernel correlated with the
stride-dilated input as ``model.py`` computes it).

The float32 path runs with TF32 off; ``tf32=True`` is the control:
on a card TF32 for every convolution and product, on the CPU both
operands of each rounded to TF32 (``model.round_tf32``).

This module imports nothing of the program under test.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from .model import Net, precision, round_tf32, strip
from .train import losses

EPS = 1e-5


def window_size(extent, window, shift):
    """MONAI's ``get_window_size``: (window, shift) for a stage extent."""
    ws, sh = list(window), list(shift)
    for i, e in enumerate(extent):
        if e <= window[i]:
            ws[i] = e
            sh[i] = 0
    return tuple(ws), tuple(sh)


def relative_position_index(window) -> torch.Tensor:
    """(W, W) index into the ((2w - 1)^3, heads) table, as MONAI's
    ``WindowAttention`` builds it."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in window], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in window])
    rel[:, :, 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[:, :, 1] *= 2 * window[2] - 1
    return rel.sum(-1)


def partition(x, ws):
    """(B, D, H, W, C) -> (B * windows, n, C)."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, int(np.prod(ws)), c)


def reverse(x, ws, dims):
    """Inverse of ``partition`` for the padded extent ``dims`` (B, D, H,
    W)."""
    b, d, h, w = dims
    x = x.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2],
               -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def compute_mask(dims, ws, shift, device):
    """MONAI's ``compute_mask``: (windows, n, n), -100 across regions."""
    d, h, w = dims
    img = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    spans = [(slice(-ws[i]), slice(-ws[i], -shift[i]), slice(-shift[i], None))
             for i in range(3)]
    for sd in spans[0]:
        for sh in spans[1]:
            for sw in spans[2]:
                img[:, sd, sh, sw, :] = cnt
                cnt += 1
    win = partition(img, ws).squeeze(-1)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


class SwinUNETRNet:
    """The network of one configuration (a ``model`` section with
    ``padding`` added, as ``model.net_config`` gives it) over a parameter
    dict without the leading 'params/'."""

    def __init__(self, cfg: dict, params: dict, tf32: bool = False):
        self.cfg = cfg
        self.p = params
        self.tf32 = tf32
        self.f = int(cfg["num_fmaps"])
        self.depths = [int(d) for d in cfg["swin_depths"]]
        self.heads = [int(h) for h in cfg["swin_heads"]]
        self.window = (int(cfg["swin_window"]),) * 3
        self.heads_net = Net(cfg, params, tf32)   # heads and code decoder

    def _op(self, a, b):
        if self.tf32 and not a.is_cuda:
            return round_tf32(a), round_tf32(b)
        return a, b

    def linear(self, x, name, bias=True):
        x, w = self._op(x, self.p[name + "/kernel"])
        y = x @ w
        return y + self.p[name + "/bias"] if bias else y

    def mm(self, a, b):
        a, b = self._op(a, b)
        return a @ b

    def ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.p[name + "/scale"],
                            self.p[name + "/bias"], EPS)

    def conv(self, x, name, stride=1, pad=0):
        w = self.p[name + "/kernel"].permute(4, 3, 0, 1, 2)
        x, w = self._op(x, w)
        return F.conv3d(x, w, self.p.get(name + "/bias"), stride=stride,
                        padding=pad)

    def trans_conv(self, x, name):
        """kernel = stride = 2, no bias, as ``model.Net.trans_conv``."""
        k = self.p[name + "/kernel"].flip(0, 1, 2)
        x, k = self._op(x, k)
        n, _, d, h, w = x.shape
        y = torch.einsum("ncijk,xyzco->noixjykz", x, k)
        return y.reshape(n, k.shape[-1], 2 * d, 2 * h, 2 * w)

    # -- the encoder ------------------------------------------------------

    def attention(self, x, name, heads, mask):
        b, n, c = x.shape
        hd = c // heads
        qkv = self.linear(x, name + "/Dense_0").reshape(
            b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = self.mm(q, k.transpose(-2, -1))
        index = relative_position_index(self.window)[:n, :n].reshape(-1)
        bias = self.p[name + "/rel_pos_bias"][index.to(x.device)]
        attn = attn + bias.reshape(n, n, -1).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, heads, n, n) + mask[None, :, None]
            attn = attn.view(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = self.mm(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.linear(out, name + "/Dense_1")

    def block(self, x, name, heads, shifted):
        b, d, h, w, c = x.shape
        half = tuple(v // 2 for v in self.window)
        ws, shift = window_size((d, h, w), self.window, half)
        if not shifted:
            shift = (0, 0, 0)
        pads = [(ws[i] - e % ws[i]) % ws[i] for i, e in enumerate((d, h, w))]
        dp, hp, wp = d + pads[0], h + pads[1], w + pads[2]
        mask = None
        shortcut = x
        x = self.ln(x, name + "/LayerNorm_0")
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        if any(shift):
            x = torch.roll(x, [-s for s in shift], (1, 2, 3))
            mask = compute_mask((dp, hp, wp), ws, shift, x.device)
        x = self.attention(partition(x, ws), name + "/WindowAttention_0",
                           heads, mask)
        x = reverse(x, ws, (b, dp, hp, wp))
        if any(shift):
            x = torch.roll(x, list(shift), (1, 2, 3))
        x = shortcut + x[:, :d, :h, :w]
        y = self.linear(self.ln(x, name + "/LayerNorm_1"), name + "/Dense_0")
        return x + self.linear(F.gelu(y), name + "/Dense_1")

    def merge(self, x, name):
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), range(2), range(2))], -1)
        return self.linear(self.ln(x, name + "/LayerNorm_0"),
                           name + "/Dense_0", bias=False)

    def hidden_states(self, raw):
        d, h, w = raw.shape[2:]
        x = self.conv(F.pad(raw, (0, w % 2, 0, h % 2, 0, d % 2)),
                      "unet/Conv_0", stride=2)
        out = [x]
        x = x.permute(0, 2, 3, 4, 1)
        k = 0
        for i, depth in enumerate(self.depths):
            for blk in range(depth):
                x = self.block(x, f"unet/SwinBlock_{k}", self.heads[i],
                               blk % 2 == 1)
                k += 1
            x = self.merge(x, f"unet/PatchMerging_{i}")
            out.append(x.permute(0, 4, 1, 2, 3))
        return [F.layer_norm(t.permute(0, 2, 3, 4, 1), (t.shape[1],),
                             eps=EPS).permute(0, 4, 1, 2, 3) for t in out]

    # -- the decoder ------------------------------------------------------

    def res(self, x, name):
        y = F.instance_norm(self.conv(x, name + "/Conv_0", pad=1), eps=EPS)
        y = F.leaky_relu(y, 0.01)
        y = F.instance_norm(self.conv(y, name + "/Conv_1", pad=1), eps=EPS)
        if name + "/Conv_2/kernel" in self.p:
            x = F.instance_norm(self.conv(x, name + "/Conv_2"), eps=EPS)
        return F.leaky_relu(y + x, 0.01)

    def up(self, x, skip, name):
        x = self.trans_conv(x, name + "/ConvTranspose_0")
        return self.res(torch.cat([x, skip], dim=1), name + "/ResBlock_0")

    def features(self, raw):
        """raw (N, C, *S) -> (N, F, *S), before the heads."""
        hs = self.hidden_states(raw)
        n = len(self.depths)
        skips = [self.res(raw, "unet/ResBlock_0")] + [
            self.res(hs[i], f"unet/ResBlock_{i + 1}") for i in range(n - 1)
        ] + [hs[n - 1]]
        y = self.res(hs[n], f"unet/ResBlock_{n}")
        for j in range(n + 1):
            y = self.up(y, skips[n - j], f"unet/UpBlock_{j}")
        return y

    def forward(self, raw):
        x = self.features(raw)
        return (self.heads_net.conv(x, "head_code_affs", 0),
                self.heads_net.conv(x, "head_fgbg_numinst", 0))

    def decode(self, codes):
        return self.heads_net.decode(codes)


def leaf_shapes(cfg: dict, in_channels: int) -> list:
    """[(Flax leaf name, shape)] of a configuration's parameters: the
    backbone, both heads and the code decoder."""
    out = []
    f = int(cfg["num_fmaps"])
    depths = [int(d) for d in cfg["swin_depths"]]
    heads = [int(h) for h in cfg["swin_heads"]]
    w = int(cfg["swin_window"])
    n = len(depths)
    dims = [f * 2 ** i for i in range(n + 1)]
    u = "params/unet/"

    def add(name, *shape):
        out.append((name, tuple(shape)))

    def ln(name, c):
        add(name + "/scale", c)
        add(name + "/bias", c)

    def dense(name, cin, cout, bias=True):
        add(name + "/kernel", cin, cout)
        if bias:
            add(name + "/bias", cout)

    def res(name, cin, cout):
        add(name + "/Conv_0/kernel", 3, 3, 3, cin, cout)
        add(name + "/Conv_1/kernel", 3, 3, 3, cout, cout)
        if cin != cout:
            add(name + "/Conv_2/kernel", 1, 1, 1, cin, cout)

    add(u + "Conv_0/kernel", 2, 2, 2, in_channels, f)
    add(u + "Conv_0/bias", f)
    k = 0
    for i, depth in enumerate(depths):
        c = dims[i]
        for _ in range(depth):
            b = f"{u}SwinBlock_{k}/"
            ln(b + "LayerNorm_0", c)
            dense(b + "WindowAttention_0/Dense_0", c, 3 * c)
            add(b + "WindowAttention_0/rel_pos_bias", (2 * w - 1) ** 3,
                heads[i])
            dense(b + "WindowAttention_0/Dense_1", c, c)
            ln(b + "LayerNorm_1", c)
            dense(b + "Dense_0", c, 4 * c)
            dense(b + "Dense_1", 4 * c, c)
            k += 1
        ln(f"{u}PatchMerging_{i}/LayerNorm_0", 8 * c)
        dense(f"{u}PatchMerging_{i}/Dense_0", 8 * c, 2 * c, bias=False)
    res(u + "ResBlock_0", in_channels, f)
    for i in range(n - 1):
        res(f"{u}ResBlock_{i + 1}", dims[i], dims[i])
    res(f"{u}ResBlock_{n}", dims[n], dims[n])
    for j in range(n + 1):
        cin, cout = dims[n - j], dims[n - j - 1] if j < n else f
        add(f"{u}UpBlock_{j}/ConvTranspose_0/kernel", 2, 2, 2, cin, cout)
        res(f"{u}UpBlock_{j}/ResBlock_0", 2 * cout, cout)
    for name, cout in (("head_code_affs", int(cfg["code_units"])),
                       ("head_fgbg_numinst", int(cfg["max_num_inst"]) + 1)):
        add(f"params/{name}/kernel", 1, 1, 1, f, cout)
        add(f"params/{name}/bias", cout)
    ae = cfg["autoencoder"]
    fm = [int(v) for v in ae["num_fmaps"]]
    reps = int(ae["num_repetitions"])
    add("params/decoder/ConvPass_0/Conv_0/kernel", 1, 1, 1,
        int(ae["code_fmaps"]), fm[-1])
    add("params/decoder/ConvPass_0/Conv_0/bias", fm[-1])
    prev = fm[-1]
    for i, c in enumerate(list(reversed(fm))[1:] + [1]):
        add(f"params/decoder/Upsample_{i}/Conv_0/kernel", 1, 1, 1, prev, c)
        add(f"params/decoder/Upsample_{i}/Conv_0/bias", c)
        for r in range(reps):
            add(f"params/decoder/ConvPass_{i + 1}/Conv_{r}/kernel",
                3, 3, 3, c, c)
            add(f"params/decoder/ConvPass_{i + 1}/Conv_{r}/bias", c)
        prev = c
    return out


def reference_steps(cfg: dict, tree: dict, batches, gen_states, dev,
                    lr: float, tf32: bool = False) -> dict:
    """As ``train.reference_steps``, over this network: the losses of
    each step [(loss, patch, fg)], each leaf's first gradient and each
    leaf's change after the last step."""
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              .clone().requires_grad_(True) for k, v in tree.items()}
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    s = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"losses": [], "grad1": None}
    gen = torch.Generator(device=dev)
    with precision(tf32):
        for t, ((raw, labels), state) in enumerate(zip(batches, gen_states),
                                                   start=1):
            net = SwinUNETRNet(cfg, strip(params), tf32=tf32)
            gen.set_state(state)
            loss, lp, lf = losses(
                net, cfg, torch.as_tensor(raw, device=dev).float(),
                torch.as_tensor(labels, device=dev), gen)
            grads = torch.autograd.grad(loss, list(params.values()))
            out["losses"].append(tuple(float(v.detach())
                                       for v in (loss, lp, lf)))
            with torch.no_grad():
                g = dict(zip(params, grads))
                if out["grad1"] is None:
                    out["grad1"] = {k: v.clone() for k, v in g.items()}
                for k, p in params.items():
                    m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    s[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                    mh = m[k] / (1 - b1 ** t)
                    vh = s[k] / (1 - b2 ** t)
                    p.sub_(lr * mh / (vh.sqrt() + eps))
    out["change"] = {k: (p.detach() - start[k]) for k, p in params.items()}
    return out
