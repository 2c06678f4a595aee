"""JAX-package parameter trees -> the port's ``state_dict``.

The JAX package's parameters are a Flax tree ``{"params": {"unet":
{"ConvPass_0": {"Conv_0": {"kernel", "bias"}}}, ...}}``; the port's
modules carry the same names, so the mapping is name for name, with
three changes of layout:

- a Flax conv kernel ``(kz, ky, kx, in, out)`` (2D: ``(ky, kx, in,
  out)``) becomes torch's ``(out, in, k...)``;
- Flax ``nn.ConvTranspose`` (``transpose_kernel=False``) correlates the
  stride-dilated input with its kernel, i.e. ``y[s*i + t] = x[i] *
  w[k-1-t]``, while torch's ``ConvTranspose2d`` / ``3d`` computes
  ``y[s*i + t] = x[i] * W[t]`` with ``W`` laid out ``(in, out, k...)``:
  the kernel is permuted to that layout and flipped along each spatial axis
  (two in 2D, three in 3D);
- a ``Dense`` kernel ``(in, out)`` becomes ``nn.Linear``'s ``(out, in)``
  weight (the Swin backbone's; conv kernels have at least three axes);
- a ``LayerNorm`` ``scale`` becomes its ``weight``;
- biases and the Swin attention's ``rel_pos_bias`` tables are unchanged.

``parity/bench_ckpt_params.npz`` holds the trained crop checkpoint's tree
flattened with '/'-joined keys (``scripts/export_torch_fixtures.py``
writes it from the orbax checkpoint ``parity/bench_ckpt``).

Checkpoints: the JAX package's CLI reads orbax checkpoints
``<train dir>/train_net_checkpoint_<step>``, which the GPU machine cannot
read.  The port's checkpoint is a torch file of that name holding
``params`` and, where present, ``swa_params`` as flat trees of float32
tensors ('/'-joined keys, as above), ``step``, and from a training run
``swa_n`` and ``opt_state`` (the optimizer's name, whether an lr schedule
ran, its update count and, for Adam, the moments ``mu`` / ``nu`` as flat
trees in the same layout): ``write_checkpoint(load_npz(...), train_dir,
step)`` turns the exported tree into one, and ``load_checkpoint`` reads it
back.  ``from_state_dict`` is the inverse of ``to_state_dict``, so a
trained module is written back in the Flax layout.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from .models import PPPConfig, PPPModel
from .utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PARAMS = os.path.join(REPO, "parity", "bench_ckpt_params.npz")


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict of arrays -> {'a/b/c': array}; tensors stay tensors."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_tree(dict(v), key))
        else:
            out[key] = v if torch.is_tensor(v) else np.asarray(v)
    return out


def load_npz(path: str = BENCH_PARAMS) -> dict:
    """Flat {'params/unet/...': float32 array} from an exported .npz."""
    with np.load(path) as z:
        return {k: np.asarray(z[k], np.float32) for k in z.files}


def seeded_tree(leaves, seed: int = 0) -> dict:
    """Reproducible random parameters without storing them: ``leaves`` is a
    list of ('/'-joined Flax leaf name, shape); each leaf is drawn from
    ``np.random.default_rng([seed, crc32(name)])``, kernels normal with
    variance 2 / fan_in (fan_in = all axes but the last), biases normal
    with deviation 0.1.  Returns the flat {'params/...': float32 array}
    tree ``to_state_dict`` takes; the same call feeds the Flax model."""
    out = {}
    for name, shape in leaves:
        shape = tuple(int(s) for s in shape)
        rng = np.random.default_rng([int(seed), zlib.crc32(name.encode())])
        v = rng.standard_normal(shape)
        if name.endswith("/bias"):
            v *= 0.1
        else:
            v *= np.sqrt(2.0 / max(1, int(np.prod(shape[:-1]))))
        out[name] = v.astype(np.float32)
    return out


def to_state_dict(tree: dict) -> dict:
    """Flax parameter tree (nested or '/'-flattened) -> torch state_dict."""
    sd = {}
    for key, val in flatten_tree(tree).items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        leaf = parts[-1]
        name = ".".join(parts[:-1])
        t = (val.detach().float() if torch.is_tensor(val) else
             torch.tensor(np.asarray(val, np.float32)))
        if leaf in ("bias", "rel_pos_bias"):
            sd[f"{name}.{leaf}" if name else leaf] = t
        elif leaf == "scale":
            sd[name + ".weight"] = t
        elif leaf == "kernel" and t.ndim == 2:
            sd[name + ".weight"] = t.T.contiguous()
        elif leaf == "kernel":
            nd = t.ndim - 2
            sp = tuple(range(nd))
            if parts[-2].startswith("ConvTranspose"):
                w = t.permute(nd, nd + 1, *sp).flip(
                    tuple(range(2, 2 + nd)))
            else:
                w = t.permute(nd + 1, nd, *sp)
            sd[name + ".weight"] = w.contiguous()
        else:
            raise KeyError(f"unexpected parameter leaf {key!r}")
    return sd


def from_state_dict(sd) -> dict:
    """torch state_dict (tensors) -> flat {'params/...': tensor} Flax
    tree; the exact inverse of ``to_state_dict`` (permutes and flips only),
    on the tensors' own device and dtype."""
    out = {}
    for key, t in sd.items():
        name, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        parts = name.split(".") if name else []
        flax = "params/" + "/".join(parts)
        if leaf in ("bias", "rel_pos_bias"):
            out[f"{flax}/{leaf}"] = t
            continue
        if leaf != "weight":
            raise KeyError(f"unexpected state_dict entry {key!r}")
        if parts[-1].startswith("LayerNorm"):
            out[flax + "/scale"] = t
            continue
        if t.ndim == 2:
            out[flax + "/kernel"] = t.T.contiguous()
            continue
        nd = t.ndim - 2
        if parts[-1].startswith("ConvTranspose"):
            w = t.flip(tuple(range(2, 2 + nd))).permute(
                *range(2, 2 + nd), 0, 1)
        else:
            w = t.permute(*range(2, 2 + nd), 1, 0)
        out[flax + "/kernel"] = w.contiguous()
    return out


def build_model(cfg: PPPConfig, tree: dict | None = None,
                device="cuda") -> PPPModel:
    """PPPModel with the given Flax parameters (default: the committed
    trained crop checkpoint), in eval mode, cast to the config's compute
    dtype, on ``device``."""
    dev = resolve_device(device)
    model = PPPModel(cfg)
    sd = to_state_dict(load_npz() if tree is None else tree)
    model.load_state_dict(sd, strict=True)
    return model.to(device=dev, dtype=model.compute_dtype).eval()


def checkpoint_path(train_dir: str, step: int) -> str:
    return os.path.join(train_dir, f"train_net_checkpoint_{int(step)}")


def _flat_f32(tree: dict) -> dict:
    """Flat {'params/...': float32 CPU tensor} of a nested or flat tree of
    numpy arrays or tensors."""
    out = {}
    for k, v in flatten_tree(tree).items():
        if torch.is_tensor(v):
            out[k] = v.detach().to("cpu", torch.float32).clone()
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32))
    return out


def write_checkpoint(tree: dict, train_dir: str, step: int,
                     swa_tree: dict | None = None,
                     opt_state: dict | None = None,
                     swa_n: int | None = None) -> str:
    """Write a checkpoint of ``tree`` (nested or '/'-flattened, numpy or
    tensors) and, if given, its SWA average with its count and the
    optimizer state (``{"name", "schedule", "count"}`` and, for Adam,
    ``"mu"`` / ``"nu"`` flat trees); returns its path."""
    state = {"step": int(step), "params": _flat_f32(tree)}
    if swa_tree is not None:
        state["swa_params"] = _flat_f32(swa_tree)
    if swa_n is not None:
        state["swa_n"] = int(swa_n)
    if opt_state is not None:
        state["opt_state"] = {
            k: (_flat_f32(v) if isinstance(v, dict) else v)
            for k, v in opt_state.items()}
    os.makedirs(train_dir, exist_ok=True)
    path = checkpoint_path(train_dir, step)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(path: str) -> dict:
    """{"step", "params" and, where written, "swa_params", "swa_n" and
    "opt_state"}, the trees as flat {'params/...': float32 numpy array}.
    Reads params-only checkpoints as well."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    out = {"step": int(state["step"])}
    for key in ("params", "swa_params"):
        if key in state:
            out[key] = {k: v.numpy() for k, v in state[key].items()}
    if "swa_n" in state:
        out["swa_n"] = int(state["swa_n"])
    if "opt_state" in state:
        out["opt_state"] = {
            k: ({kk: vv.numpy() for kk, vv in v.items()}
                if isinstance(v, dict) else v)
            for k, v in state["opt_state"].items()}
    return out
