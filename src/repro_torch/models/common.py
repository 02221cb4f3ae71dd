"""Model substrate: sharding rules, norms, projections, rotary, parameters.

The JAX package names a logical axis for every parameter and activation and
maps it onto a mesh through a rules table. The port keeps the tables
(``Rules``, ``make_rules``) as plain dicts, and ``constrain`` is the
identity: the reference's ``with_sharding_constraint`` has no numeric
effect, and one card holds the whole model. The partition-spec helpers wait
for the dry run (ROADMAP Queue 1 item 15e).

Rounding follows the reference op by op: ``dense`` takes bf16 in, adds in
f32 and rounds once to bf16; ``rms_norm`` computes in f32, casts to the
input's dtype, then multiplies by the bf16 gamma; ``rotary`` promotes bf16
x f32 to f32 and casts back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

_DRYRUN = ("the partition specs of a dry run are not ported yet (ROADMAP "
           "Queue 1 item 15e)")


# --------------------------------------------------------------- rules
@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axis, separately for activations and params.

    Params: "embed"/state axes shard over the FSDP axis ("data"), head/
    mlp/vocab/expert axes over "model" (TP/EP). `sizes` carries the mesh
    axis sizes. The port reads no field of it except where a path has no
    one-card form (``moe_impl="a2a"``, ROADMAP Queue 1 item 15b).
    """
    act: dict
    param: dict
    sizes: dict
    mesh: Any = None  # set when shard_map islands (moe_a2a) are in play


PROD_SIZES = {"pod": 2, "data": 16, "model": 16}


def make_rules(multi_pod: bool = False, long_context: bool = False,
               fsdp: bool = True, sizes: dict | None = None,
               decode: bool = False, mesh=None, ep2d: bool = False,
               dp_only: bool = False) -> Rules:
    """The reference's rules tables, entry for entry."""
    if dp_only:
        allax = ("pod", "data", "model") if multi_pod else ("data", "model")
        act = {"batch": allax, "seq": None, "kv_seq": None, "embed": None,
               "heads": None, "kv_heads": None, "mlp": None, "vocab": None,
               "experts": None}
        param = {"embed": ("data", "model") if fsdp else None,
                 "heads": None, "kv_heads": None, "mlp": None,
                 "vocab": None, "experts": None, "layers": None,
                 "batch": allax, "kv_seq": None}
        return Rules(act=act, param=param, sizes=sizes or dict(PROD_SIZES),
                     mesh=mesh)
    dp = ("pod", "data") if multi_pod else "data"
    act = {
        "batch": dp, "seq": None, "kv_seq": None, "embed": None,
        "heads": "model", "kv_heads": "model", "mlp": "model",
        "vocab": "model", "experts": "model",
    }
    if decode:  # batch shards "data"; KV sequence takes the model axis
        act.update(kv_seq="model")
    if long_context:  # batch=1 decode: shard the KV sequence instead
        act.update(batch=None, kv_seq=dp)
    param = {
        "embed": "data" if fsdp else None,
        "heads": "model", "kv_heads": "model", "mlp": "model",
        "vocab": "model", "layers": None,
        "experts": ("data", "model") if ep2d else "model",
        "batch": act["batch"], "kv_seq": act["kv_seq"],
    }
    return Rules(act=act, param=param, sizes=sizes or dict(PROD_SIZES),
                 mesh=mesh)


def constrain(x: torch.Tensor, axes: tuple, rules: Rules | None):
    """The reference's logical sharding constraint: no numeric effect."""
    return x


def spec_for(axes: tuple, table: dict):
    raise NotImplementedError(_DRYRUN)


def tree_specs(axes_tree: Any, table: dict):
    raise NotImplementedError(_DRYRUN)


def tree_specs_for_shapes(shapes_tree: Any, axes_tree: Any, table: dict,
                          sizes: dict):
    raise NotImplementedError(_DRYRUN)


# --------------------------------------------------------------- params
class ParamCollector:
    """Draws a model's parameters into a nested dict, as the reference's
    ``ParamCollector`` does: the same shapes, dtypes and scales (a
    normal draw times ``scale``, by default fan_in ** -0.5 with fan_in the
    leading dim, as the reference takes it), from ``generator`` on
    ``device``. torch cannot redraw ``jax.random``'s numbers, so the values
    differ; ``repro_torch.convert.lm_params_from_numpy`` carries the
    reference's own."""

    def __init__(self, generator: torch.Generator, device: torch.device,
                 tree: dict | None = None):
        self.generator = generator
        self.device = device
        self.params = {} if tree is None else tree

    def sub(self, name: str) -> "ParamCollector":
        tree = {}
        self.params[name] = tree
        return ParamCollector(self.generator, self.device, tree)

    def param(self, name: str, shape: tuple, *, scale: float | None = None,
              dtype=torch.bfloat16, init: str = "normal") -> torch.Tensor:
        if init == "zeros":
            v = torch.zeros(shape, dtype=dtype, device=self.device)
        elif init == "ones":
            v = torch.ones(shape, dtype=dtype, device=self.device)
        else:
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            s = scale if scale is not None else fan_in ** -0.5
            v = (torch.randn(shape, generator=self.generator,
                             dtype=torch.float32, device=self.device)
                 * s).to(dtype)
        self.params[name] = v
        return v


def index_tree(tree: dict, i: int) -> dict:
    """The i-th slice of every leaf of a stacked tree (views)."""
    return {k: index_tree(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# --------------------------------------------------------------- layers
def f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def einsum32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=f32)``: the operands taken
    exactly into f32, products added in f32."""
    return torch.einsum(eq, *(f32(o) for o in ops))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = f32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] with f32 accumulation, out in x's dtype.
    On the card a bf16 pair goes to cuBLAS's bf16 product, which adds in
    f32 and rounds once (with
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off, as ``chip_smoke.py`` sets it); elsewhere the product runs in
    f32."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return torch.matmul(x, w)
    return torch.matmul(f32(x), f32(w)).to(x.dtype)


def scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX takes it beside an array: rounded to the
    array's dtype (bf16 x 45.254834 multiplies by 45.25)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it: 1 / (1 + exp(-x)), each op
    rounded to x's dtype (torch.sigmoid rounds once, which differs in bf16
    on about a third of the values)."""
    one = scalar(1.0, x)
    return one / (one + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (the tanh form), op by op in x's dtype."""
    c = scalar(float(np.sqrt(2 / np.pi).astype(np.float32)), x)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + scalar(0.044715, x) * x ** 3)))
    return x * cdf


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: exp(x - max) / sum."""
    e = torch.exp(x - torch.amax(x, dim=dim, keepdim=True))
    return e / torch.sum(e, dim=dim, keepdim=True)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))  # nemotron squared-ReLU


ACTIVATIONS = {"silu": silu, "gelu": gelu, "relu2": _relu2}


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
           rope_dim: int | None = None) -> torch.Tensor:
    """RoPE over the last dim of x [..., S, H, dh] with positions [..., S]."""
    dh = x.shape[-1]
    rd = rope_dim or dh
    half = rd // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), expo)
    ang = f32(positions)[..., None] * freq                  # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:rd]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot.to(x.dtype), x[..., rd:]], dim=-1)
