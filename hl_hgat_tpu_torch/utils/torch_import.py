"""Import reference PyTorch checkpoints into the port's models
(``hl_hgat_tpu/utils/torch_import.py``, NumPy and torch only).

The reference ships one pretrained artifact,
``HL-HGAT-DEMO/weights/HL_HGAT_Brain.pt`` (loaded at OHBM_DEMO.ipynb cell
47): a ``state_dict`` of ``HL_HGAT_attpool``
(HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:250-332); its research scripts train
the ``HL_HGCNN_*`` family (lib/Hodge_ST_Model.py).  The translation tables
are the JAX module's, key for key: a reference key becomes a (collection,
flax path) entry, and ``_apply_entries`` writes each entry into the port
model under its ``state_dict`` name (``weights.py``: the module names
follow the flax paths).

Layout conventions translated:

* torch ``Linear.weight`` is ``[out, in]`` → flax ``kernel`` ``[in, out]``
  → the port's ``weight`` ``[out, in]`` again.
* torch ``Conv1d.weight`` is ``[out, in, k]`` → flax ``Conv`` kernel
  ``[k, in, out]`` → the port's Conv1d ``weight`` ``[out, in, k]``.
* ``HodgeLaguerreFastConv`` stores K bias-free Linears ``lins.{k}.weight``
  (HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:530-537) → one stacked
  ``LaguerreConv`` weight ``[K, in, out]`` plus ``bias``.
* ``BatchNorm1d``: ``weight``/``bias`` (params; flax ``scale``/``offset``)
  and ``running_mean``/``running_var`` (flax batch stats ``mean``/``var``);
  ``num_batches_tracked`` is dropped (the BN uses a fixed momentum, like
  the reference's default).

Every translated tensor must land on an existing leaf with an identical
shape; unconsumed checkpoint tensors or untouched model leaves are
reported (and raise under ``strict=True``), so a mismatched architecture
fails loudly rather than half-loading.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np
import torch

from hl_hgat_tpu_torch.weights import _LEAF_NAMES

Path = tuple[str, ...]


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """``torch.load`` a ``state_dict`` file → plain ``{name: np.ndarray}``."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):  # a full module was saved
        sd = sd.state_dict()
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in sd.items()}


def infer_hgat_config(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """Recover the ``HL_HGAT_attpool`` constructor arguments from its
    state-dict shapes (reference defaults at
    HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:251-253)."""
    k = len({m.group(1) for key in sd
             if (m := re.fullmatch(r"HL_init_conv\.module_0\.lins\.(\d+)\.weight", key))})
    blocks: dict[int, set[int]] = {}
    filters: dict[int, int] = {}
    for key, v in sd.items():
        m = re.fullmatch(r"NEConv(\d)(\d)\.module_0\.bias", key)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            blocks.setdefault(i, set()).add(j)
            filters[i] = v.shape[0]
    n_blocks = max(blocks) + 1
    channels = tuple(len(blocks[i]) for i in range(n_blocks))
    pool_num = len({key.split(".")[0] for key in sd if key.startswith("NEAtt")})
    mlp_channels = tuple(
        sd[f"mlp{i}.0.bias"].shape[0]
        for i in range(sum(1 for key in sd
                           if re.fullmatch(r"mlp\d+\.0\.bias", key)))
    )
    head_in = sd["out.weight"].shape[1] if not mlp_channels else sd["mlp0.0.weight"].shape[1]
    return dict(
        channels=channels,
        filters=tuple(filters[i] for i in range(n_blocks)),
        k=k,
        pool_num=pool_num,
        mlp_channels=mlp_channels,
        num_classes=sd["out.weight"].shape[0],
        num_nodepedge=head_in,
        node_dim=sd["HL_init_conv.module_0.lins.0.weight"].shape[1],
        edge_dim=sd["HL_init_conv.module_4.lins.0.weight"].shape[1],
    )


@dataclass
class ImportReport:
    consumed: list[str] = field(default_factory=list)
    dropped: list[str] = field(default_factory=list)  # num_batches_tracked
    unmatched: list[str] = field(default_factory=list)  # torch keys w/o rule
    untouched: list[str] = field(default_factory=list)  # model leaves not set

    def summary(self) -> str:
        return (
            f"imported {len(self.consumed)} tensors, dropped "
            f"{len(self.dropped)}, unmatched {len(self.unmatched)}, "
            f"untouched model leaves {len(self.untouched)}"
        )


_BN_MAP = {
    "weight": ("params", "scale"),
    "bias": ("params", "offset"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def _translate_hgat(
    sd: Mapping[str, np.ndarray],
) -> tuple[dict[tuple[str, Path], np.ndarray], ImportReport]:
    """torch key → (collection, flax path) for ``HLHGATAttpool``."""
    out: dict[tuple[str, Path], np.ndarray] = {}
    report = ImportReport()
    lag_stacks: dict[Path, dict[int, np.ndarray]] = {}

    def put(col: str, path: Path, val: np.ndarray, key: str) -> None:
        out[(col, path)] = val
        report.consumed.append(key)

    def bn(base: Path, stat: str, val: np.ndarray, key: str) -> None:
        if stat == "num_batches_tracked":
            report.dropped.append(key)
            return
        col, leaf = _BN_MAP[stat]
        put(col, base + (leaf,), val, key)

    def lag(base: Path, rest: str, val: np.ndarray, key: str) -> None:
        """HodgeLaguerreFastConv params: lins.{k}.weight / bias."""
        if rest == "bias":
            put("params", base + ("bias",), val, key)
            return
        m = re.fullmatch(r"lins\.(\d+)\.weight", rest)
        assert m, rest
        lag_stacks.setdefault(base, {})[int(m.group(1))] = val.T
        report.consumed.append(key)

    for key, val in sd.items():
        parts = key.split(".")
        head, rest = parts[0], ".".join(parts[1:])

        if head == "node_embedding":
            # Inception1D (HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:400-446)
            name = parts[1]
            if name.startswith("bn"):
                bn(("node_embedding", name), parts[2], val, key)
            elif parts[2] == "weight":  # Conv1d [out,in,k] → [k,in,out]
                put("params", ("node_embedding", name, "kernel"),
                    val.transpose(2, 1, 0), key)
            else:
                put("params", ("node_embedding", name, "bias"), val, key)

        elif head == "HL_init_conv" or re.fullmatch(r"NEConv\d\d", head):
            # gnn.Sequential: module_0/1 = node conv+BN, module_4/5 = edge
            base: Path = (("backbone", "init_node") if head == "HL_init_conv"
                          else ("backbone", head, "node"))
            ebase: Path = (("backbone", "init_edge") if head == "HL_init_conv"
                           else ("backbone", head, "edge"))
            mod = parts[1]
            if mod == "module_0":
                lag(base + ("conv",), ".".join(parts[2:]), val, key)
            elif mod == "module_4":
                lag(ebase + ("conv",), ".".join(parts[2:]), val, key)
            elif mod == "module_1":
                bn(base + ("bn",), parts[3], val, key)
            elif mod == "module_5":
                bn(ebase + ("bn",), parts[3], val, key)
            else:
                report.unmatched.append(key)

        elif re.fullmatch(r"NEInt\d\d", head):
            # NodeEdgeInt value mode: WV_*.{0,3}=Linear, {1,4}=BN
            # (HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:612-629)
            wv, idx = parts[1], parts[2]
            base = ("backbone", head, wv)
            if idx in ("0", "3"):
                lin = "TorchLinear_0" if idx == "0" else "TorchLinear_1"
                leaf = "kernel" if parts[3] == "weight" else "bias"
                v = val.T if parts[3] == "weight" else val
                put("params", base + (lin, leaf), v, key)
            elif idx in ("1", "4"):
                bnm = "MaskedBatchNorm_0" if idx == "1" else "MaskedBatchNorm_1"
                bn(base + (bnm,), parts[3], val, key)
            else:
                report.unmatched.append(key)

        elif re.fullmatch(r"NEAtt\d", head):
            # attention gates: WQ_/WK_ Node/Edge Linears
            # (HL-HGAT-DEMO/lib/Hodge_Cheb_Conv.py:631-640)
            leaf = "kernel" if parts[2] == "weight" else "bias"
            v = val.T if parts[2] == "weight" else val
            put("params", ("backbone", head, parts[1], leaf), v, key)

        elif head == "readout":
            tgt = "readout_node" if parts[1] == "module_0" else "readout_edge"
            lag((tgt,), ".".join(parts[2:]), val, key)

        elif re.fullmatch(r"mlp\d+", head):
            i = head[3:]
            if parts[1] == "0":
                leaf = "kernel" if parts[2] == "weight" else "bias"
                v = val.T if parts[2] == "weight" else val
                put("params", ("head", f"mlp{i}_lin", leaf), v, key)
            elif parts[1] == "1":
                bn(("head", f"mlp{i}_bn"), parts[2], val, key)
            else:
                report.unmatched.append(key)

        elif head == "out":
            leaf = "kernel" if rest == "weight" else "bias"
            v = val.T if rest == "weight" else val
            put("params", ("head", "out", leaf), v, key)

        else:
            report.unmatched.append(key)

    for base, terms in lag_stacks.items():
        ks = sorted(terms)
        assert ks == list(range(len(ks))), f"missing Laguerre terms at {base}"
        out[("params", base + ("weights",))] = np.stack(
            [terms[i] for i in ks], axis=0
        )
    return out, report


class _Translator:
    """Shared torch-key → flax-path machinery for the reference families."""

    def __init__(self) -> None:
        self.out: dict[tuple[str, Path], np.ndarray] = {}
        self.report = ImportReport()
        self.lag_stacks: dict[Path, dict[int, np.ndarray]] = {}

    def put(self, col: str, path: Path, val: np.ndarray, key: str) -> None:
        self.out[(col, path)] = val
        self.report.consumed.append(key)

    def bn(self, base: Path, stat: str, val: np.ndarray, key: str) -> None:
        if stat == "num_batches_tracked":
            self.report.dropped.append(key)
            return
        col, leaf = _BN_MAP[stat]
        self.put(col, base + (leaf,), val, key)

    def lag(self, base: Path, rest: str, val: np.ndarray, key: str) -> None:
        """HodgeLaguerre(Fast)Conv params: lins.{k}.weight / bias."""
        if rest == "bias":
            self.put("params", base + ("bias",), val, key)
            return
        m = re.fullmatch(r"lins\.(\d+)\.weight", rest)
        assert m, rest
        self.lag_stacks.setdefault(base, {})[int(m.group(1))] = val.T
        self.report.consumed.append(key)

    def linear(self, base: Path, leaf_kind: str, val: np.ndarray,
               key: str) -> None:
        leaf = "kernel" if leaf_kind == "weight" else "bias"
        self.put("params", base + (leaf,),
                 val.T if leaf_kind == "weight" else val, key)

    def finish(self) -> tuple[dict[tuple[str, Path], np.ndarray], ImportReport]:
        for base, terms in self.lag_stacks.items():
            ks = sorted(terms)
            assert ks == list(range(len(ks))), f"missing Laguerre terms at {base}"
            self.out[("params", base + ("weights",))] = np.stack(
                [terms[i] for i in ks], axis=0
            )
        return self.out, self.report


def _translate_hgcnn(
    sd: Mapping[str, np.ndarray], head: str = "graph",
) -> tuple[dict[tuple[str, Path], np.ndarray], ImportReport]:
    """torch key → (collection, flax path) for the ``HL_HGCNN_*`` family
    (reference lib/Hodge_ST_Model.py:412-1090).

    ``head='graph'`` maps the graph-level models (zinc/pepfunc/CIFAR
    pyr/attpool/poolint3 → :class:`HLHGCNNGraph`: ``mlp{i}``/``out`` are
    Linears under the ``head`` MLP).  ``head='tsp'`` maps the edge-level
    model (reference :756-852 → :class:`HLHGCNNTsp`: ``mlp``/``out`` are
    K=1 Laguerre conv stages on edge features).  ``head='abcd'`` maps the
    brain model (reference :26-168 → :class:`HLHGCNNAbcd`): like 'graph'
    plus the ``node_embedding`` Inception1D and the K=1 ``readout`` convs.
    """
    t = _Translator()
    for key, val in sd.items():
        parts = key.split(".")
        h = parts[0]

        if h == "node_embedding" and head == "abcd":
            # Inception1D (reference lib/Hodge_Cheb_Conv.py:317-341)
            name = parts[1]
            if name.startswith("bn"):
                t.bn(("node_embedding", name), parts[2], val, key)
            elif parts[2] == "weight":  # Conv1d [out,in,k] → [k,in,out]
                t.put("params", ("node_embedding", name, "kernel"),
                      val.transpose(2, 1, 0), key)
            else:
                t.put("params", ("node_embedding", name, "bias"), val, key)

        elif h == "readout" and head == "abcd":
            tgt = "readout_node" if parts[1] == "module_0" else "readout_edge"
            t.lag((tgt,), ".".join(parts[2:]), val, key)

        elif h == "HL_init_conv" or re.fullmatch(r"NEConv\d\d?", h):
            base: Path = (("backbone", "init_node") if h == "HL_init_conv"
                          else ("backbone", h, "node"))
            ebase: Path = (("backbone", "init_edge") if h == "HL_init_conv"
                           else ("backbone", h, "edge"))
            mod = parts[1]
            if mod == "module_0":
                t.lag(base + ("conv",), ".".join(parts[2:]), val, key)
            elif mod == "module_4":
                t.lag(ebase + ("conv",), ".".join(parts[2:]), val, key)
            elif mod == "module_1":
                t.bn(base + ("bn",), parts[3], val, key)
            elif mod == "module_5":
                t.bn(ebase + ("bn",), parts[3], val, key)
            else:
                t.report.unmatched.append(key)

        elif re.fullmatch(r"NEInt\d\d?", h):
            wv, idx = parts[1], parts[2]
            base = ("backbone", h, wv)
            if idx in ("0", "3"):
                lin = "TorchLinear_0" if idx == "0" else "TorchLinear_1"
                t.linear(base + (lin,), parts[3], val, key)
            elif idx in ("1", "4"):
                bnm = "MaskedBatchNorm_0" if idx == "1" else "MaskedBatchNorm_1"
                t.bn(base + (bnm,), parts[3], val, key)
            else:
                t.report.unmatched.append(key)

        elif re.fullmatch(r"NEAtt\d", h):
            t.linear(("backbone", h, parts[1]), parts[2], val, key)

        elif re.fullmatch(r"mlp\d+", h) and head in ("graph", "abcd"):
            i = h[3:]
            if parts[1] == "0":
                t.linear(("head", f"mlp{i}_lin"), parts[2], val, key)
            elif parts[1] == "1":
                t.bn(("head", f"mlp{i}_bn"), parts[2], val, key)
            else:
                t.report.unmatched.append(key)

        elif h == "out" and head in ("graph", "abcd"):
            t.linear(("head", "out"), parts[1], val, key)

        elif h == "mlp" and head == "tsp":
            if parts[1] == "module_0":
                t.lag(("mlp", "conv"), ".".join(parts[2:]), val, key)
            elif parts[1] == "module_1":
                t.bn(("mlp", "bn"), parts[3], val, key)
            else:
                t.report.unmatched.append(key)

        elif h == "out" and head == "tsp":
            if parts[1] == "module_0":
                t.lag(("out",), ".".join(parts[2:]), val, key)
            else:
                t.report.unmatched.append(key)

        else:
            t.report.unmatched.append(key)

    return t.finish()


def infer_hgcnn_config(sd: Mapping[str, np.ndarray]) -> dict[str, Any]:
    """Recover HL_HGCNN constructor shapes from a state dict (the bridge
    for reference-trained checkpoints, reference lib/Hodge_ST_Model.py:
    544-554 zinc defaults)."""
    k = len({m.group(1) for key in sd
             if (m := re.fullmatch(
                 r"NEConv00\.module_0\.lins\.(\d+)\.weight", key))})
    init_k = len({m.group(1) for key in sd
                  if (m := re.fullmatch(
                      r"HL_init_conv\.module_0\.lins\.(\d+)\.weight", key))})
    blocks: dict[int, set[int]] = {}
    filters: dict[int, int] = {}
    for key, v in sd.items():
        m = re.fullmatch(r"NEConv(\d)(\d)\.module_0\.bias", key)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            blocks.setdefault(i, set()).add(j)
            filters[i] = v.shape[0]
    n_blocks = max(blocks) + 1
    att_locs = tuple(sorted(
        int(key[5]) for key in sd
        if re.fullmatch(r"NEAtt\d\.WQ_Node\.weight", key)
    ))
    mlp_channels = tuple(
        sd[f"mlp{i}.0.bias"].shape[0]
        for i in range(sum(1 for key in sd
                           if re.fullmatch(r"mlp\d+\.0\.bias", key)))
    )
    out = dict(
        channels=tuple(len(blocks[i]) for i in range(n_blocks)),
        filters=tuple(filters[i] for i in range(n_blocks)),
        k=k,
        init_k=init_k,
        att_locs=att_locs,
        mlp_channels=mlp_channels,
        node_dim=sd["HL_init_conv.module_0.lins.0.weight"].shape[1],
        edge_dim=sd["HL_init_conv.module_4.lins.0.weight"].shape[1],
    )
    if "out.weight" in sd:  # graph head (Linear)
        out["num_classes"] = sd["out.weight"].shape[0]
    elif "out.module_0.lins.0.weight" in sd:  # edge head (K=1 conv)
        out["num_classes"] = sd["out.module_0.lins.0.weight"].shape[0]
        out["mlp_channels"] = tuple(
            [sd["mlp.module_0.lins.0.weight"].shape[0]]
            if "mlp.module_0.lins.0.weight" in sd else []
        )
    return out


def _apply_entries(
    model: torch.nn.Module,
    entries: dict[tuple[str, Path], np.ndarray],
    report: ImportReport,
    *,
    strict: bool,
) -> tuple[torch.nn.Module, ImportReport]:
    """Write the translated entries into ``model``'s ``state_dict`` in
    place; a flax ``kernel`` is transposed into its torch ``weight`` as
    ``weights.from_flax_variables`` does."""
    state = model.state_dict()
    written: set[str] = set()
    errors: list[str] = []
    updates: dict[str, torch.Tensor] = {}
    for (col, path), val in entries.items():
        full = "/".join((col,) + path)
        name = (".".join(path[:-1] + (_LEAF_NAMES[path[-1]],))
                if path[-1] in _LEAF_NAMES else None)
        if name not in state:
            errors.append(f"no model leaf at {full}")
            continue
        arr = val.T if path[-1] == "kernel" else val
        if tuple(state[name].shape) != arr.shape:
            errors.append(
                f"shape mismatch at {full}: "
                f"model {tuple(state[name].shape)} vs checkpoint {arr.shape}"
            )
            continue
        updates[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(state[name].dtype)
        written.add(name)

    report.untouched = sorted(n for n in state if n not in written)
    if strict:
        problems = errors + [f"unmatched checkpoint key {k}"
                             for k in report.unmatched]
        if report.untouched:
            problems.append(
                "model leaves not covered by the checkpoint: "
                + ", ".join(report.untouched[:8])
                + ("..." if len(report.untouched) > 8 else "")
            )
        if problems:
            raise ValueError("torch import failed:\n  " + "\n  ".join(problems))
    elif errors:
        report.unmatched.extend(errors)

    with torch.no_grad():
        for name, val in updates.items():
            state[name].copy_(val)
    return model, report


def import_hgat_attpool(
    model: torch.nn.Module,
    sd: Mapping[str, np.ndarray],
    *,
    strict: bool = True,
) -> tuple[torch.nn.Module, ImportReport]:
    """Load a reference ``HL_HGAT_attpool`` state dict into the port's
    :class:`~hl_hgat_tpu_torch.models.hgat.HLHGATAttpool` in place.

    Returns ``(model, report)``.  ``strict`` raises if any checkpoint
    tensor has no rule, any translated tensor has no matching leaf (or a
    shape mismatch), or any model leaf was left at its initialization
    value; nothing is written then.
    """
    entries, report = _translate_hgat(sd)
    return _apply_entries(model, entries, report, strict=strict)


def import_hgcnn(
    model: torch.nn.Module,
    sd: Mapping[str, np.ndarray],
    *,
    head: str = "graph",
    strict: bool = True,
) -> tuple[torch.nn.Module, ImportReport]:
    """Load a reference ``HL_HGCNN_*`` state dict (reference
    lib/Hodge_ST_Model.py:412-1090) into the port's ``HLHGCNNGraph``
    (``head='graph'``: zinc/pepfunc/CIFAR pyr + attpool),
    ``HLHGCNNTsp`` (``head='tsp'``) or ``HLHGCNNAbcd`` (``head='abcd'``)
    in place.

    Pair with :func:`infer_hgcnn_config` to recover the preset arguments
    from the checkpoint shapes.  Same strictness contract as
    :func:`import_hgat_attpool`.
    """
    entries, report = _translate_hgcnn(sd, head=head)
    return _apply_entries(model, entries, report, strict=strict)
