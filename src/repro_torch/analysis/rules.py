"""The port's rule set: the torch counterparts of the reference's hazards.

Each rule is a :class:`Rule` with a code, a one-line summary, its rationale
and a ``check(ctx)`` returning :class:`~repro_torch.analysis.core.Finding`\\ s.
Like the reference's rules (``repro.analysis.rules``), they prefer missing an
exotic case over flooding the tree with false positives.  The reference's
RPL005 (``assert`` in ``kernels/``) and RPL008 (ambient ``current_*``) lint
the port's files already (``repro-lint`` walks ``src``) and are not repeated
here.  A host sync inside a loop is not linted: ``analysis/tracegate.py``
counts the syncs of pinned workloads on the card.

* RPT001 (↔ RPL001) — a hidden fixed seed: ``torch.manual_seed`` and its
  CUDA and ``torch.random`` forms, or ``torch.Generator(…).manual_seed(<int
  literal>)``, outside tests: every run shares entropy.
* RPT002 (↔ RPL002) — randomness with no explicit source: a torch draw
  without ``generator=``, any ``*_like`` draw, or an in-place ``Tensor``
  draw without ``generator=``, outside tests: the global generator is
  shared state, so a draw depends on whatever drew before it.
* RPT003 (↔ RPL003) — a ``functools`` cache over device state: a cached
  function taking or returning a ``Tensor``, or making one with a torch
  factory, keeps tensors (and card memory) alive for the process and hands
  every caller the same mutable tensor.
* RPT004 (↔ RPL004) — ``@dataclass`` without ``eq=False`` holding a
  ``Tensor`` field: the generated ``__eq__`` compares tensors elementwise, so
  ``==``, ``in`` and ``list.remove`` raise (or wait on the card).
* RPT005 — TF32 in an exact product: setting ``…allow_tf32 = True`` or
  ``torch.set_float32_matmul_precision`` below ``"highest"`` outside tests
  rounds every float32 matmul's inputs to 10 bits of mantissa, which breaks
  the port's exactness bounds (|S| < 2²⁴ on the float paths, the LM rule's τ).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.core import FileContext, Finding


def qual(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain (``torch.cuda.manual_seed``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = qual(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def qual_tail(node: ast.AST) -> Optional[str]:
    """Last component of a dotted name (``manual_seed``), or None."""
    q = qual(node)
    return q.split(".")[-1] if q else None


def _has_keyword(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


def _calls(ctx: FileContext):
    return (node for node in ast.walk(ctx.tree) if isinstance(node, ast.Call))


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    summary: str
    rationale: str
    check: Callable[[FileContext], List[Finding]]


def _finding(ctx: FileContext, node: ast.AST, code: str, message: str) -> Finding:
    return Finding(ctx.path, node.lineno, node.col_offset + 1, code, message)


# ---------------------------------------------------------------------------
# RPT001 — a hidden fixed seed outside tests
# ---------------------------------------------------------------------------

_GLOBAL_SEEDERS = {
    "torch.manual_seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.random.manual_seed",
}


def _int_literal(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool))


def check_rpt001(ctx: FileContext) -> List[Finding]:
    if ctx.is_test_path:
        return []
    out = []
    for node in _calls(ctx):
        q = qual(node.func)
        if q in _GLOBAL_SEEDERS:
            out.append(_finding(
                ctx, node, "RPT001",
                f"{q}() seeds torch's global generator outside tests: every draw "
                "anywhere in the process shares its stream — pass a "
                "torch.Generator seeded from a caller's seed",
            ))
        elif (isinstance(node.func, ast.Attribute) and node.func.attr == "manual_seed"
              and isinstance(node.func.value, ast.Call)
              and qual_tail(node.func.value.func) == "Generator"
              and node.args and _int_literal(node.args[0])):
            out.append(_finding(
                ctx, node, "RPT001",
                f"torch.Generator().manual_seed({node.args[0].value!r}) outside tests: "
                "a literal seed makes every run share entropy — take the seed or "
                "the generator as a parameter",
            ))
    return out


# ---------------------------------------------------------------------------
# RPT002 — a draw with no explicit generator outside tests
# ---------------------------------------------------------------------------

_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli", "multinomial", "normal",
          "poisson"}
_LIKE_DRAWS = {"rand_like", "randn_like", "randint_like"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_", "exponential_",
                  "geometric_", "cauchy_", "log_normal_"}


def check_rpt002(ctx: FileContext) -> List[Finding]:
    if ctx.is_test_path:
        return []
    out = []
    for node in _calls(ctx):
        q = qual(node.func) or ""
        parts = q.split(".")
        if len(parts) == 2 and parts[0] == "torch" and parts[1] in _LIKE_DRAWS:
            out.append(_finding(
                ctx, node, "RPT002",
                f"{q}() draws from torch's global generator (the *_like draws take "
                "none): draw with torch.rand/randn(..., generator=g) instead",
            ))
        elif len(parts) == 2 and parts[0] == "torch" and parts[1] in _DRAWS:
            if not _has_keyword(node, "generator"):
                out.append(_finding(
                    ctx, node, "RPT002",
                    f"{q}() without generator= draws from torch's global generator: "
                    "the result depends on every draw before it — pass generator=",
                ))
        elif (isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_DRAWS
              and not _has_keyword(node, "generator")):
            out.append(_finding(
                ctx, node, "RPT002",
                f"in-place .{node.func.attr}() without generator= draws from torch's "
                "global generator — pass generator=",
            ))
    return out


# ---------------------------------------------------------------------------
# RPT003 — a functools cache over tensors
# ---------------------------------------------------------------------------

_TENSOR_ANNOTATION = re.compile(r"\bTensor\b")
_FACTORIES = {"tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty", "full", "arange"}
_FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _annotated_tensor(node: Optional[ast.AST]) -> bool:
    return node is not None and bool(_TENSOR_ANNOTATION.search(ast.unparse(node)))


def check_rpt003(ctx: FileContext) -> List[Finding]:
    out = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, _FUNCTIONS):
            continue
        cache_dec = next(
            (dec for dec in fn.decorator_list
             if qual_tail(dec.func if isinstance(dec, ast.Call) else dec) in ("lru_cache",
                                                                               "cache")),
            None,
        )
        if cache_dec is None:
            continue
        args = (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs)
        typed = _annotated_tensor(fn.returns) or any(_annotated_tensor(a.annotation)
                                                    for a in args)
        makes = any(
            isinstance(node, ast.Call)
            and (qual(node.func) or "").split(".")[0] == "torch"
            and qual_tail(node.func) in _FACTORIES
            for node in ast.walk(fn)
        )
        if typed or makes:
            out.append(_finding(
                ctx, cache_dec, "RPT003",
                f"functools cache on {fn.name!r}, which takes, returns or makes a "
                "tensor: the cache keeps every tensor (and its card memory) alive for "
                "the process and hands each caller the same mutable tensor — cache "
                "the shape-level plan, not the tensor, or keep it on an object the "
                "caller owns",
            ))
    return out


# ---------------------------------------------------------------------------
# RPT004 — @dataclass without eq=False holding tensors
# ---------------------------------------------------------------------------


def check_rpt004(ctx: FileContext) -> List[Finding]:
    out = []
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        dc = None
        eq_false = False
        for dec in cls.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if qual_tail(target) != "dataclass":
                continue
            dc = dec
            if isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "eq" and isinstance(kw.value, ast.Constant):
                        eq_false = kw.value.value is False
        if dc is None or eq_false:
            continue
        tensors = [
            stmt for stmt in cls.body
            if isinstance(stmt, ast.AnnAssign) and _annotated_tensor(stmt.annotation)
        ]
        if tensors:
            fields = ", ".join(ast.unparse(s.target) for s in tensors)
            out.append(_finding(
                ctx, cls, "RPT004",
                f"@dataclass {cls.name!r} holds tensor fields ({fields}) without "
                "eq=False: the generated __eq__ compares tensors elementwise, so ==, "
                "`in` and list.remove() raise or wait on the card — declare "
                "@dataclass(eq=False) to compare by identity",
            ))
    return out


# ---------------------------------------------------------------------------
# RPT005 — TF32 switched on outside tests
# ---------------------------------------------------------------------------


def check_rpt005(ctx: FileContext) -> List[Finding]:
    if ctx.is_test_path:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if not (isinstance(node.value, ast.Constant) and node.value.value is True):
                continue
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr.endswith("allow_tf32"):
                    out.append(_finding(
                        ctx, node, "RPT005",
                        f"{ast.unparse(t)} = True rounds float32 products to TF32 (10 "
                        "mantissa bits): the port's float paths are exact only in full "
                        "float32 — leave it False",
                    ))
        elif (isinstance(node, ast.Call)
              and qual_tail(node.func) == "set_float32_matmul_precision"
              and node.args and isinstance(node.args[0], ast.Constant)
              and node.args[0].value != "highest"):
            out.append(_finding(
                ctx, node, "RPT005",
                f"set_float32_matmul_precision({node.args[0].value!r}) lets float32 "
                "matmuls run in TF32 or bf16: the port's float paths are exact only "
                "at \"highest\"",
            ))
    return out


RULES: Dict[str, Rule] = {
    rule.code: rule
    for rule in (
        Rule("RPT001", "torch global seed, or Generator().manual_seed(literal), outside tests",
             "every run shares entropy (the reference's RPL001)", check_rpt001),
        Rule("RPT002", "torch draw without generator= (or any *_like draw) outside tests",
             "a draw depends on every global draw before it (the reference's RPL002)",
             check_rpt002),
        Rule("RPT003", "functools.lru_cache/cache over a function that holds tensors",
             "cached tensors live for the process and are shared mutable state "
             "(the reference's RPL003)", check_rpt003),
        Rule("RPT004", "@dataclass without eq=False holding Tensor fields",
             "the generated __eq__ raises or syncs on tensors (the reference's RPL004)",
             check_rpt004),
        Rule("RPT005", "TF32 switched on (allow_tf32 = True, float32 precision below "
             "'highest') outside tests",
             "TF32 breaks the exactness bounds of the port's float32 products",
             check_rpt005),
    )
}
