"""Export the port's WaveRNN weights to the native engine's binary format
(counterpart of ``rtvc_tpu/native/convert.py``).

The engine (``native/src/wavernn_engine.cpp``, a copy of the JAX package's)
reads one file format, RTVCNAT1, for all three variants: batch-norm folded
into the adjacent conv weights; Linear and GRU matrices stored dense, or
group-of-4 sparse (CSR of groups, uint16 group-column indices) where at
least ``sparse_threshold`` of their groups are all zero (pruned); the
per-sample matrices (I, GRU, FC) in f32 or f16, the per-frame upsampler in
f32. The format helpers below (``write_vec``, ``write_dense``,
``write_sparse``, ``write_matrix``, ``fold_batchnorm``) are numpy copies of
the original's, held equal in source to them by
``tests/test_torch_imports.py``. :func:`export_wavernn` reads the port's
state_dict (the reference torch layout) and writes the bytes the JAX
``export_wavernn`` writes from the same weights' variables.

Layout (little-endian):
  magic 'RTVCNAT1'
  int32 ×10: variant, mode, n_classes, rnn_dims, fc_dims, feat_dims,
             aux_dims, res_blocks, pad, hop
  int32: n_upsample; int32[n_upsample] factors
  upsample tensors (conv_in w+b, per block w1 b1 w2 b2, conv_out w+b,
                    smoothing kernels) then I, GRUs, FCs in graph order.
Matrices:  int32 kind (0 dense f32 | 1 sparse f32 | 2 dense f16 |
           3 sparse f16), int32 rows, int32 cols, then
  dense:   float32|float16[rows*cols]
  sparse:  int32 group, int32 n_groups, int32 row_ptr[rows+1],
           uint16 group_col[n_groups], float32|float16 vals[n_groups*group]
Vectors:   int32 n, float32[n]

f16 weights: the per-sample matrices (I, GRU, FC) are what the engine's
sample loop reads every step, so halving their bytes halves that loop's
memory traffic; the upsampler runs once a frame and stays f32.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, BinaryIO, Dict

import numpy as np

from rtvc_tpu_torch.ops.wavernn_generate import LAYERS

MAGIC = b"RTVCNAT1"
VARIANT_IDS = {"fatchord-wavernn": 0, "geneing-wavernn": 1, "runtimeracer-wavernn": 2}
MODE_IDS = {"RAW": 0, "BITS": 1, "MOL": 2}


def _w(f: BinaryIO, fmt: str, *vals) -> None:
    f.write(struct.pack("<" + fmt, *vals))


def write_vec(f: BinaryIO, v: np.ndarray) -> None:
    v = np.ascontiguousarray(v, dtype=np.float32).reshape(-1)
    _w(f, "i", v.size)
    f.write(v.tobytes())


def _weight_payload(v: np.ndarray, dtype: str) -> bytes:
    if dtype == "f16":
        return np.ascontiguousarray(v, dtype=np.float16).tobytes()
    return np.ascontiguousarray(v, dtype=np.float32).tobytes()


def write_dense(f: BinaryIO, m: np.ndarray, dtype: str = "f32") -> None:
    m = np.ascontiguousarray(m, dtype=np.float32)
    assert m.ndim == 2
    _w(f, "iii", 0 if dtype == "f32" else 2, m.shape[0], m.shape[1])
    f.write(_weight_payload(m, dtype))


def write_sparse(f: BinaryIO, m: np.ndarray, group: int = 4,
                 dtype: str = "f32") -> None:
    """Group-compressed storage: keep only groups with any nonzero weight."""
    m = np.ascontiguousarray(m, dtype=np.float32)
    rows, cols = m.shape
    assert cols % group == 0, (rows, cols, group)
    n_gcols = cols // group
    blocks = m.reshape(rows, n_gcols, group)
    keep = np.abs(blocks).sum(axis=2) > 0  # (rows, n_gcols)
    row_ptr = np.zeros(rows + 1, dtype=np.int32)
    group_cols = []
    vals = []
    for r in range(rows):
        idx = np.nonzero(keep[r])[0]
        row_ptr[r + 1] = row_ptr[r] + len(idx)
        group_cols.append(idx.astype(np.uint16))
        vals.append(blocks[r, idx].reshape(-1))
    group_cols = np.concatenate(group_cols) if group_cols else np.zeros(0, np.uint16)
    vals = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    _w(f, "iii", 1 if dtype == "f32" else 3, rows, cols)
    _w(f, "ii", group, int(row_ptr[-1]))
    f.write(row_ptr.tobytes())
    f.write(np.ascontiguousarray(group_cols).tobytes())
    f.write(_weight_payload(vals, dtype))


def write_matrix(f: BinaryIO, m: np.ndarray, sparse_threshold: float = 0.5,
                 group: int = 4, dtype: str = "f32") -> None:
    """Choose dense vs sparse by actual group sparsity."""
    m = np.asarray(m, dtype=np.float32)
    if m.shape[1] % group == 0:
        blocks = m.reshape(m.shape[0], m.shape[1] // group, group)
        zero_frac = float((np.abs(blocks).sum(axis=2) == 0).mean())
        if zero_frac >= sparse_threshold and m.shape[1] // group < 65536:
            write_sparse(f, m, group, dtype=dtype)
            return
    write_dense(f, m, dtype=dtype)


def fold_batchnorm(
    conv_w: np.ndarray, conv_b: np.ndarray | None, bn_p: Dict, bn_s: Dict,
    eps: float = 1e-5,
):
    """Fold inference-mode BN into the preceding conv:
    y = γ·(Wx + b − μ)/√(σ²+ε) + β  →  W' = W·s, b' = (b − μ)·s + β."""
    gamma = np.asarray(bn_p["weight"], np.float64)
    beta = np.asarray(bn_p["bias"], np.float64)
    mean = np.asarray(bn_s["running_mean"], np.float64)
    var = np.asarray(bn_s["running_var"], np.float64)
    s = gamma / np.sqrt(var + eps)
    w = np.asarray(conv_w, np.float64)
    w_f = w * s.reshape((-1,) + (1,) * (w.ndim - 1))
    b = np.zeros_like(mean) if conv_b is None else np.asarray(conv_b, np.float64)
    b_f = (b - mean) * s + beta
    return w_f.astype(np.float32), b_f.astype(np.float32)


def _numpy_state(model_or_state_dict) -> Dict[str, np.ndarray]:
    """A WaveRNN module or its state_dict → {name: f32 numpy array} on the
    host."""
    sd = (model_or_state_dict.state_dict() if hasattr(model_or_state_dict, "state_dict")
          else model_or_state_dict)
    return {k: np.asarray(v.detach().cpu().float() if hasattr(v, "detach") else v,
                          dtype=np.float32) for k, v in sd.items()}


def export_wavernn(model_or_state_dict: Any, dims, out_path: Path,
                   sparse_threshold: float = 0.5,
                   weight_dtype: str = "f32") -> None:
    """Serialize a WaveRNN (the port's module, or its state_dict under the
    reference's names, any variant) for the native engine, in the graph
    order the engine reads: header, upsampler (conv_in and each residual
    block's convs with their batch-norms folded, conv_out, the smoothing
    kernels), ``I``, the variant's GRUs, its FCs.

    ``sparse_threshold``: the group-zero fraction from which a Linear or
    GRU matrix is stored group-sparse (above 1 forces dense storage).
    ``weight_dtype``: ``"f32"`` or ``"f16"`` for the per-sample matrices
    (I, GRU, FC); the engine widens f16 to f32 in registers."""
    sd = _numpy_state(model_or_state_dict)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    layers = LAYERS[dims.variant]
    pre = "upsample.resnet."

    def bn(prefix: str):
        return ({k: sd[prefix + k] for k in ("weight", "bias")},
                {k: sd[prefix + k] for k in ("running_mean", "running_var")})

    def matrix(f: BinaryIO, name: str):
        write_matrix(f, sd[name], sparse_threshold=sparse_threshold, dtype=weight_dtype)

    with open(out_path, "wb") as f:
        f.write(MAGIC)
        _w(
            f, "i" * 10,
            VARIANT_IDS[dims.variant], MODE_IDS[dims.mode], dims.n_classes,
            dims.rnn_dims, dims.fc_dims, dims.feat_dims, dims.aux_dims,
            dims.res_blocks, dims.pad, dims.hop_length,
        )
        _w(f, "i", len(dims.upsample_factors))
        for fac in dims.upsample_factors:
            _w(f, "i", fac)

        # conv_in (O, I, K) + folded BN → dense (O, K*I), the engine's
        # [k][channel] inner layout
        w_in, b_in = fold_batchnorm(sd[pre + "conv_in.weight"], None, *bn(pre + "batch_norm."))
        O, I, K = w_in.shape
        write_dense(f, np.transpose(w_in, (0, 2, 1)).reshape(O, K * I))
        write_vec(f, b_in)

        for i in range(dims.res_blocks):
            block = f"{pre}layers.{i}."
            for k in (1, 2):
                w, b = fold_batchnorm(sd[f"{block}conv{k}.weight"][:, :, 0], None,
                                      *bn(f"{block}batch_norm{k}."))
                write_dense(f, w)
                write_vec(f, b)

        write_dense(f, sd[pre + "conv_out.weight"][:, :, 0])
        write_vec(f, sd[pre + "conv_out.bias"])

        for i in range(len(dims.upsample_factors)):
            write_vec(f, sd[f"upsample.up_layers.{2 * i + 1}.weight"].reshape(-1))

        matrix(f, "I.weight")
        write_vec(f, sd["I.bias"])

        for rnn in layers.rnns:
            matrix(f, f"{rnn.name}.weight_ih_l0")
            matrix(f, f"{rnn.name}.weight_hh_l0")
            write_vec(f, sd[f"{rnn.name}.bias_ih_l0"])
            write_vec(f, sd[f"{rnn.name}.bias_hh_l0"])

        for fc in layers.fcs:
            matrix(f, f"{fc.name}.weight")
            write_vec(f, sd.get(f"{fc.name}.bias", np.zeros(0)))
