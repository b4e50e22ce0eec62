"""Carry weights between the JAX package and the port.

:func:`state_dict_from_jax` is the inverse of the JAX package's
``tools/convert_torch_ckpt.convert_state_dict``: it maps a ``{"params": ...}``
tree of arrays to the port's (reference-named) state dict. A Flax conv kernel
(kh, kw, I, O) and a Flax transpose-conv kernel (kh, kw, O, I) both go back
with axes (3, 2, 0, 1); a norm's ``scale`` and ``bias`` become the reference's
``weight`` and ``bias``.

Gradients cross the same way: a ``tcs_tpu`` gradient tree has the structure
of its parameter tree, so ``state_dict_from_jax(grads)`` gives the gradients
under the port's parameter names, laid out as ``p.grad`` is.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _res(t: str, j: Path) -> Iterator[Tuple[str, Path]]:
    yield t + ".conv1", j + ("conv1",)
    yield t + ".conv2", j + ("conv2",)
    yield t + ".downsample.0", j + ("downsample",)


def _seq(t: str, j: Path, torch_indices) -> Iterator[Tuple[str, Path]]:
    for i, ti in enumerate(torch_indices):
        yield f"{t}.{ti}", j + (f"conv{i}",)


def _conv2x(t: str, j: Path) -> Iterator[Tuple[str, Path]]:
    yield t + ".conv1.conv", j + ("conv1", "conv")  # the transpose conv
    yield t + ".conv2.conv", j + ("conv2", "conv")


def _res_norms(t: str, j: Path) -> Iterator[Tuple[Tuple[str, ...], Path]]:
    yield (t + ".norm1",), j + ("norm1",)
    yield (t + ".norm2",), j + ("norm2",)
    yield (t + ".norm3", t + ".downsample.1"), j + ("norm3",)


def _cnet_blocks() -> Iterator[Tuple[str, Path]]:
    for i in range(1, 6):
        for b, r in ((0, "res1"), (1, "res2")):
            yield f"cnet.layer{i}.{b}", ("cnet", f"layer{i}", r)
    for i in range(2):
        yield f"cnet.outputs08.{i}.0", ("cnet", f"outputs04_{i}", "res")
        yield f"cnet.outputs16.{i}.0", ("cnet", f"outputs08_{i}", "res")


def _gru(t: str, j: Path) -> Iterator[Tuple[str, Path]]:
    yield t + ".convzr", j + ("convzr",)
    yield t + ".convq", j + ("convq",)


def module_map(n_gru_layers: int = 3) -> Iterator[Tuple[str, Path]]:
    """(port module prefix, JAX params path) of every conv, as
    ``tools/convert_torch_ckpt.convert_state_dict`` pairs them. Optional
    modules are listed too."""
    yield "cnet.conv1", ("cnet", "conv1")
    for t, j in _cnet_blocks():
        yield from _res(t, j)
    for i in range(2):
        yield f"cnet.outputs08.{i}.1", ("cnet", f"outputs04_{i}", "conv")
        yield f"cnet.outputs16.{i}.1", ("cnet", f"outputs08_{i}", "conv")
        yield f"cnet.outputs32.{i}", ("cnet", f"outputs16_{i}", "conv")
    yield from _res("conv2.0", ("conv2", "res"))
    yield "conv2.1", ("conv2", "conv")
    # the non-shared backbone's matching encoder (tools/convert_torch_ckpt.py:132-138)
    yield "fnet.conv1", ("fnet", "conv1")
    for i in range(1, 4):
        for b, r in ((0, "res1"), (1, "res2")):
            yield from _res(f"fnet.layer{i}.{b}", ("fnet", f"layer{i}", r))
    yield "fnet.conv2", ("fnet", "conv2")
    for i in range(n_gru_layers):
        yield f"context_zqr_convs.{i}", (f"context_zqr_convs_{i}",)
        yield f"context_zqr_convs_grad.{i}", (f"context_zqr_convs_grad_{i}",)
        yield from _gru(f"previous_current_hideen_fuse.{i}", (f"hidden_fuse_{i}",))

    dc = ("disp_completor",)
    for stem in ("conv_disp_stem", "conv_cost_stem", "conv_mask_stem",
                 "conv_disp_fuse", "disp_head", "w_head"):
        yield from _seq(f"disp_completor.{stem}", dc + (stem,), (0, 2))
    for blk in ("conv_4_4", "conv_4_8", "conv_8_8", "conv_8_16", "conv_16_16",
                "conv_out4_disp", "conv_out8_disp", "conv_out16_disp"):
        yield from _seq(f"disp_completor.{blk}", dc + (blk,), (0, 3))
    for blk in ("conv_16_8", "conv_8_4"):
        yield from _conv2x(f"disp_completor.{blk}", dc + (blk,))

    ub = ("iter_cell", "update_block")
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        yield f"update_block.encoder.{name}", ub + ("encoder", name)
    for t, j in (("gru08", "gru_fine"), ("gru16", "gru_mid"), ("gru32", "gru_coarse")):
        yield from _gru(f"update_block.{t}", ub + (j,))
    yield "update_block.flow_head.conv1", ub + ("flow_head", "conv1")
    yield "update_block.flow_head.conv2", ub + ("flow_head", "conv2")

    gr = ("iter_cell", "disp_grad_refine")
    for name, idx in (("conv_grad_stem", (0, 2)), ("conv_grad_candidate_stem", (0, 2)),
                      ("conv_4_4", (0,)), ("conv_4_8", (0,)), ("conv_8_8", (0,)),
                      ("conv_8_16", (0,)), ("conv_16_16", (0,)),
                      ("residual_head", (0, 2)), ("conv_out", (0,))):
        yield from _seq(f"disp_grad_refine.{name}", gr + (name,), idx)
    for blk in ("conv_16_8", "conv_8_4"):
        yield from _conv2x(f"disp_grad_refine.{blk}", gr + (blk,))

    dr = ("iter_cell", "disp_refine")
    for name in ("context_compress", "disp_f_stem", "conv_fuse", "w_head"):
        yield from _seq(f"disp_refine.{name}", dr + (name,), (0, 2))
    yield from _seq("disp_refine.mask", ("upsample_mask_head", "mask"), (0, 2))

    hu = ("iter_cell", "hiddenstate_update")
    yield "hiddenstate_update.convs.0", hu + ("convs0",)
    yield "hiddenstate_update.convs.2", hu + ("convs1",)
    yield from _gru("hiddenstate_update", hu)


def norm_map() -> Iterator[Tuple[Tuple[str, ...], Path]]:
    """(port module prefixes, JAX params path) of every norm that can carry
    parameters: those of the context encoder, whose ``norm_fn`` is
    ``context_norm``. The matching networks' norms are instance norms."""
    yield ("cnet.norm1",), ("cnet", "norm1")
    for t, j in _cnet_blocks():
        yield from _res_norms(t, j)


def _leaves(tree, prefix: Path = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix


def _node(tree, path: Path):
    for k in path:
        tree = tree.get(k) if isinstance(tree, Mapping) else None
        if tree is None:
            return None
    return tree


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x, np.float32), order="C"))


def state_dict_from_jax(params, n_gru_layers: int = 3) -> Dict[str, torch.Tensor]:
    """``{"params": tree}`` of arrays → the port's state dict (fp32 tensors).

    Raises if a parameter of the tree has no place in the port.
    """
    tree = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    used = set()
    for tprefix, jpath in module_map(n_gru_layers):
        node = _node(tree, jpath)
        if node is None:
            continue
        (layer, leaf), = node.items()  # {"Conv_0" | "ConvTranspose_0": {...}}
        sd[tprefix + ".weight"] = _tensor(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
        used.add(jpath + (layer, "kernel"))
        if "bias" in leaf:
            sd[tprefix + ".bias"] = _tensor(leaf["bias"])
            used.add(jpath + (layer, "bias"))
    for tprefixes, jpath in norm_map():
        node = _node(tree, jpath)
        if node is None:
            continue
        path = jpath
        while "scale" not in node:  # down the Norm's single-child scopes
            (k, node), = node.items()
            path += (k,)
        for tprefix in tprefixes:
            sd[tprefix + ".weight"] = _tensor(node["scale"])
            sd[tprefix + ".bias"] = _tensor(node["bias"])
        used.update({path + ("scale",), path + ("bias",)})
    unused = [p for p in _leaves(tree) if p not in used]
    if unused:
        raise KeyError(f"parameters with no place in the port: {unused[:5]}")
    return sd


# The Flax modules under a ``Norm`` that hold its parameters, by ``norm_fn``
# (``tcs_tpu/models/layers.py:52-118``).
_NORM_SCOPES = {"group": ("GroupNorm_0", "GroupNorm_0"), "batch": ("BatchNorm_0",)}
_DECONVS = frozenset(f"{m}.{blk}.conv1.conv" for m in ("disp_completor", "disp_grad_refine")
                     for blk in ("conv_16_8", "conv_8_4"))


def _set(tree, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def params_from_state_dict(sd, context_norm: str = "none"):
    """The port's (reference-named) state dict → ``{"params": tree}`` of
    float32 numpy arrays in ``tcs_tpu``'s layout, the inverse of
    :func:`state_dict_from_jax` over the same module and norm maps (which,
    unlike ``tools/convert_torch_ckpt.py``, keeps the group and batch context
    norms' parameters). ``context_norm`` names the Flax scopes of the context
    encoder's norm parameters. Raises if an entry of ``sd`` has no place in
    the tree."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in sd.items()}
    tree: dict = {}
    used = set()
    for tprefix, jpath in module_map():
        if tprefix + ".weight" not in sd:
            continue
        layer = "ConvTranspose_0" if tprefix in _DECONVS else "Conv_0"
        _set(tree, jpath + (layer, "kernel"), sd[tprefix + ".weight"].transpose(2, 3, 1, 0))
        used.add(tprefix + ".weight")
        if tprefix + ".bias" in sd:
            _set(tree, jpath + (layer, "bias"), sd[tprefix + ".bias"])
            used.add(tprefix + ".bias")
    for tprefixes, jpath in norm_map():
        if tprefixes[0] + ".weight" not in sd:
            continue
        scope = jpath + _NORM_SCOPES[context_norm]
        _set(tree, scope + ("scale",), sd[tprefixes[0] + ".weight"])
        _set(tree, scope + ("bias",), sd[tprefixes[0] + ".bias"])
        used.update(t + s for t in tprefixes for s in (".weight", ".bias"))
    unused = sorted(set(sd) - used)
    if unused:
        raise KeyError(f"state dict entries with no place in tcs_tpu's tree: {unused[:5]}")
    return {"params": tree}
