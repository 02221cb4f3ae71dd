"""Filtering-query pruning (paper §4.1 Ex. 1): predicate decomposition.

A monotone boolean formula over basic predicates is split into
switch-supported and unsupported parts; each unsupported predicate is
replaced by a tautology (True) and the formula is reduced. The switch
evaluates the relaxed formula, so a superset of the matching rows survives,
and the master applies the full formula to complete the query.

Predicates are a tiny AST; supported ones are elementwise tensor compares
(the switch's comparator ALUs), and the combined formula is evaluated by
the paper's truth-table trick: pack the basic predicates' results into a bit
vector and look the verdict up in a 2^n table. No kernel: elementwise work
and one gather.

torch compares no ``uint32`` tensors on the CPU, so a uint32 column is
compared by value in int64. A Python number is a weakly typed literal, as
in the JAX package (``_operands``): an int outside int32 raises
OverflowError, an int wraps into an integer column's dtype, and a float
compares in f32 with an integer column. A ``like`` predicate's callable
receives the column tensor as it is.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch

from ..kernels.common import flush_subnormals
from .hashing import by_value
from .pruning import PruneResult


# ----------------------------------------------------------------- AST
@dataclasses.dataclass(frozen=True)
class Pred:
    """Basic predicate on one column. switch_supported=False models e.g.
    `name LIKE e%s` (string ops the switch cannot evaluate)."""
    column: str
    op: str  # gt|ge|lt|le|eq|ne|like (like = unsupported on switch)
    value: object
    switch_supported: bool = True

    def evaluate(self, cols: dict) -> torch.Tensor:
        raw = cols[self.column]
        if self.op == "like":
            return self.value(raw)  # host-side callable
        c, v = _operands(raw, self.value)
        if c.dtype == torch.float32:
            # XLA compares f32 with subnormals flushed (A25); a literal
            # that _operands passes on as it is (a numpy scalar) converts
            # to the column's dtype first, as JAX converts it
            v = torch.as_tensor(v, dtype=c.dtype, device=c.device)
            c, v = flush_subnormals(c), flush_subnormals(v)
        fn: dict[str, Callable] = {
            "gt": lambda: c > v, "ge": lambda: c >= v,
            "lt": lambda: c < v, "le": lambda: c <= v,
            "eq": lambda: c == v, "ne": lambda: c != v,
        }
        return fn[self.op]()


def _operands(col: torch.Tensor, value):
    """(column, literal) to compare, as JAX compares an array with a weakly
    typed Python literal (x64 off): an int is converted to int32 first, so
    one outside int32 raises OverflowError; it then wraps into an integer
    column's dtype (-1 against uint32 is 2^32 - 1) and rounds into a float
    column's; a float literal compares with an integer column in f32. A
    bool column compares by value. Any other literal compares by value."""
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        if not -(1 << 31) <= value < (1 << 31):
            raise OverflowError(f"Python int {value} too large to convert to "
                                "int32")
        if col.is_floating_point():
            return col, torch.tensor(value, dtype=col.dtype)
        if col.dtype != torch.bool:
            bits = torch.iinfo(col.dtype).bits
            value &= (1 << bits) - 1
            if col.dtype.is_signed and value >= 1 << (bits - 1):
                value -= 1 << bits
        return by_value(col), value
    if isinstance(value, float):
        if col.is_floating_point():
            return col, torch.tensor(value, dtype=col.dtype)
        return (by_value(col).to(torch.float32),
                torch.tensor(value, dtype=torch.float32))
    return by_value(col), value


@dataclasses.dataclass(frozen=True)
class And:
    terms: tuple


@dataclasses.dataclass(frozen=True)
class Or:
    terms: tuple


@dataclasses.dataclass(frozen=True)
class TRUE:
    pass


Formula = object  # Pred | And | Or | TRUE


def relax(f: Formula) -> Formula:
    """Replace unsupported predicates by tautologies; reduce (modus ponens).

    Sound for *monotone* formulas: relaxed(f) is implied by f, so rows
    failing relaxed(f) provably fail f, and pruning them is safe.
    """
    if isinstance(f, Pred):
        return f if f.switch_supported else TRUE()
    if isinstance(f, And):
        terms = tuple(t for t in (relax(x) for x in f.terms)
                      if not isinstance(t, TRUE))
        if not terms:
            return TRUE()
        return terms[0] if len(terms) == 1 else And(terms)
    if isinstance(f, Or):
        terms = tuple(relax(x) for x in f.terms)
        if any(isinstance(t, TRUE) for t in terms):
            return TRUE()
        return terms[0] if len(terms) == 1 else Or(terms)
    return f


def basic_preds(f: Formula) -> list[Pred]:
    if isinstance(f, Pred):
        return [f]
    if isinstance(f, (And, Or)):
        out: list[Pred] = []
        for t in f.terms:
            out.extend(basic_preds(t))
        return out
    return []


def _all_rows(cols: dict) -> torch.Tensor:
    some = next(iter(cols.values()))
    return torch.ones(some.shape[0], dtype=torch.bool, device=some.device)


def evaluate(f: Formula, cols: dict) -> torch.Tensor:
    """Direct vectorized evaluation (master side / oracle)."""
    if isinstance(f, TRUE):
        return _all_rows(cols)
    if isinstance(f, Pred):
        return f.evaluate(cols)
    sub = [evaluate(t, cols) for t in f.terms]
    out = sub[0]
    for s in sub[1:]:
        out = (out & s) if isinstance(f, And) else (out | s)
    return out


def _eval_assign(g: Formula, assign: dict) -> bool:
    if isinstance(g, TRUE):
        return True
    if isinstance(g, Pred):
        return assign[id(g)]
    vals = [_eval_assign(t, assign) for t in g.terms]
    return all(vals) if isinstance(g, And) else any(vals)


def evaluate_truthtable(f: Formula, cols: dict) -> torch.Tensor:
    """Switch-style: evaluate the basic predicates, pack their results into
    bits, look the verdict up in a 2^n truth table (paper: 'writes the values
    of the predicates as a bit vector and looks up the value in a truth
    table')."""
    preds = basic_preds(f)
    n = len(preds)
    assert n <= 16, "truth-table lookup limited to 16 basic predicates"
    some = next(iter(cols.values()))
    # predicate i sits at bit n-1-i of the index: itertools.product varies
    # the last predicate fastest, so entry j of the table is the assignment
    # whose bits spell j
    index = torch.zeros(some.shape[0], dtype=torch.int64, device=some.device)
    for i, p in enumerate(preds):
        index |= p.evaluate(cols).to(torch.int64) << (n - 1 - i)
    # the control plane installs one match-action rule per assignment
    table = [_eval_assign(f, {id(p): combo[i] for i, p in enumerate(preds)})
             for combo in itertools.product([False, True], repeat=n)]
    return torch.tensor(table, dtype=torch.bool, device=some.device)[index]


def filter_prune(formula: Formula, cols: dict,
                 use_truthtable: bool = True) -> PruneResult:
    """Switch pass: prune rows failing the relaxed formula."""
    r = relax(formula)
    ev = evaluate_truthtable if use_truthtable else evaluate
    keep = _all_rows(cols) if isinstance(r, TRUE) else ev(r, cols)
    return PruneResult(keep=keep, state=r)


def master_complete_filter(formula: Formula, cols: dict,
                           keep: torch.Tensor) -> torch.Tensor:
    """Master applies the FULL formula to surviving rows."""
    return keep & evaluate(formula, cols)
