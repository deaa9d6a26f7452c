"""The mixed-precision training policy (counterpart of
``rtvc_tpu/ops/precision.py``).

Under the bf16 policy a training step casts the model's parameters and the
float leaves of its batch to bf16 for the forward; master parameters, the
optimizer's state, the losses and the gradient clip stay f32. The matrix
products then stream bf16 operands and accumulate in f32 (``__init__`` turns
off the reduced-precision reduction of cuBLAS's bf16 GEMMs), as the TPU's
matrix unit does for the JAX package. What the JAX package keeps f32 under
any policy stays f32 here: the attention softmaxes, the Tacotron decoder's
attention context and cumulative scores, batch-norm statistics, layer norm,
log-softmax, the GE2E similarity and loss, and every loss, taken against the
f32 batch.

Mechanism: :func:`cast_parameters` swaps each float parameter of a module
for its bf16 cast for the length of a forward, so that autograd carries the
bf16 gradients back through the cast to the f32 masters as f32 gradients
(the transpose of the JAX package's in-loss cast); :func:`compute_dtype`
sets the dtype that :func:`matmul`, :func:`biased` and :func:`linear` give
their products (JAX's ``preferred_element_type=matmul_dtype()``), and they
add a bias after the product is rounded, as JAX does: the port's
``Linear`` and ``Conv1d`` and the Tacotron decoder's projections, where an
f32 island meets a bf16 weight, all take their products through them. Bare ``torch.autocast`` is not this policy: it leaves the
parameters f32, so the hoisted input products of the recurrences would come
out f32 and K3 and K4 would never see a bf16 stream.

One difference from the JAX package, of the same kind as that between its
own TPU and CPU paths: where JAX runs a ``lax.scan`` instead of its fused
kernels (on its CPU default, at the CBHG's hidden width 64, which its LSTM
and GRU kernels do not take, and for the Tacotron decoder chain, whose
kernel is off by default), its scan carries the recurrent state in bf16.
The port follows the kernels' contract on every path: K3 and K4 stream bf16
and carry f32 state, and K5 runs in f32 with its inputs widened around it.
"""
from __future__ import annotations

import collections
import contextvars
from contextlib import contextmanager
from typing import Any, Iterator, Optional

import torch
from torch import nn
from torch.nn import functional as F

Tensor = torch.Tensor

_COMPUTE_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "rtvc_torch_compute_dtype", default=torch.float32)


def matmul_dtype() -> torch.dtype:
    """The dtype a model product takes: f32 outside any policy context."""
    return _COMPUTE_DTYPE.get()


@contextmanager
def compute_dtype(dtype: torch.dtype) -> Iterator[None]:
    """Make ``dtype`` the compute dtype for the products run inside."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def resolve(name: Any) -> torch.dtype:
    """'bf16' / 'bfloat16' / 'f32' / 'float32' / 'auto' / None (or a torch
    dtype) → the dtype. ``auto`` is f32 on every device the port runs on:
    the JAX package resolves it to bf16 only on a TPU, and whether bf16
    should be the default on the card is for a measured change to decide.
    Raises ValueError for any other name."""
    if name is None or name == "auto":
        return torch.float32
    if isinstance(name, torch.dtype):
        if name not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unknown compute_dtype {name!r}")
        return name
    dtypes = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "f32": torch.float32, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dtypes[name]


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """A floating tensor, or each floating tensor of a dict (a batch), cast
    to ``dtype``; integer and bool tensors and anything else untouched."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


@contextmanager
def cast_parameters(module: nn.Module, dtype: torch.dtype) -> Iterator[None]:
    """For the length of the block, every floating parameter of ``module``
    (and its submodules) reads as its cast to ``dtype``: a differentiable
    copy, so a backward run on what the block computed gives the f32
    parameters f32 gradients. Buffers (running statistics) are not cast,
    as the JAX policy casts the parameters only. A no-op for f32."""
    if dtype == torch.float32:
        yield
        return
    swapped = []
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and p.is_floating_point():
                mod._parameters[name] = p.to(dtype)
                swapped.append((mod, name, p))
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


@contextmanager
def policy(module: nn.Module, dtype: torch.dtype) -> Iterator[None]:
    """The training step's policy for a forward of ``module``: its
    parameters cast (:func:`cast_parameters`) and ``dtype`` the compute
    dtype. The caller casts the batch with :func:`cast_floats`."""
    with cast_parameters(module, dtype), compute_dtype(dtype):
        yield


@contextmanager
def product_dtypes() -> Iterator[collections.Counter]:
    """Count, by dtype, what every ``nn.Linear`` and ``nn.Conv1d`` module
    (the port's ``Linear`` and ``Conv1d`` among them) called inside the
    block returns. Under the bf16 policy a model's products come out bf16,
    so a counter with no bf16 in it, or with f32 in it, shows a step that
    ran outside the policy: the check the tests and ``chip_smoke.py`` hold
    the bf16 steps to."""
    counts: collections.Counter = collections.Counter()

    def hook(module, args, out):
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            counts[out.dtype] += 1

    handle = nn.modules.module.register_module_forward_hook(hook)
    try:
        yield counts
    finally:
        handle.remove()


def widen(t: Tensor) -> Tensor:
    """``t`` in at least f32: a bf16 tensor widened to f32, any other
    returned as it is (the kernels' plain versions compute in f32 on bf16
    streams, and in f64 where a gradient check feeds them f64)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def matmul(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` as the JAX package's ``jnp.dot(x, w,
    preferred_element_type=matmul_dtype())``: the operands promoted to their
    common type, the product in the compute dtype. Where an f32 island (the
    decoder chain's output) meets a bf16 weight, the product is taken in
    f32 and rounded once."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return (x.to(dt) @ w.to(dt)).to(matmul_dtype())


def biased(product: Tensor, bias: Optional[Tensor]) -> Tensor:
    """A product in the compute dtype, then its bias: the JAX package adds
    the bias after the product is rounded, where a fused ``addmm`` or
    convolution would round once. Under bf16 that one unit matters: a
    BatchNorm downstream of a wide-ranged activation (ForwardTacotron's
    postnet over ``lin(padding_value)`` frames) turns it into percents of
    its output."""
    product = product.to(matmul_dtype())
    return product if bias is None else product + bias


def fused(*operands: Tensor) -> bool:
    """Whether a product and its bias may run as one fused call: where no
    operand is bf16, rounding once and rounding twice agree."""
    return all(t.dtype != torch.bfloat16 for t in operands)


def linear(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """``F.linear(x, weight, bias)`` with the JAX package's dtype rule
    (:func:`matmul`, then :func:`biased`) where a bf16 operand takes part;
    the fused call otherwise, so the f32 policy computes as it always has."""
    if fused(x, weight):
        return F.linear(x, weight, bias)
    return biased(matmul(x, weight.t()), bias)
