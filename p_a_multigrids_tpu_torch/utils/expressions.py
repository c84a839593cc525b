"""Math-expression evaluator for problem definition strings (copy of the
JAX package's ``utils/expressions.py``; tests/test_torch_expressions_geo.py
holds it bit-identical to the original).

The counterpart of the reference's expression engine ``evaluate.F90``
(``evalexpr``/``defparam`` with a symbol table).  The CLI accepts strings
like ``"sin(x+y)"`` or ``"exp(-k*t)*sin(pi*x)"`` for initial conditions,
Dirichlet values, sources and analytical solutions, and this module
compiles them into NumPy-vectorized callables for ProblemFns, evaluated on
the host at setup.

Design: a recursive-descent parser over a fixed grammar — no ``eval``, no
attribute access, no names beyond the declared variables, parameters, and
the whitelisted function table — so config files and CLI strings are safe
to evaluate.

Grammar:
    expr    := term (('+' | '-') term)*
    term    := unary (('*' | '/') unary)*
    unary   := ('+' | '-')* power
    power   := atom ('^' power | '**' power)?
    atom    := NUMBER | NAME | NAME '(' expr (',' expr)* ')' | '(' expr ')'
"""

from __future__ import annotations

import math
import re

import numpy as np

__all__ = ["Expression", "compile_expression", "evaluate", "ExpressionError"]


class ExpressionError(ValueError):
    """Raised on parse errors or unknown symbols (the reference prints an
    error code from evalexpr; we raise)."""


_FUNCTIONS = {
    "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "atan2": np.arctan2,
    "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "exp": np.exp, "log": np.log, "log10": np.log10,
    "sqrt": np.sqrt, "abs": np.abs, "sign": np.sign,
    "floor": np.floor, "ceil": np.ceil,
    "min": np.minimum, "max": np.maximum,
    "erf": np.vectorize(math.erf), "erfc": np.vectorize(math.erfc),
    "heaviside": lambda x: np.heaviside(x, 0.5),
    "where": np.where,
}

_CONSTANTS = {"pi": math.pi, "e": math.e}

_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>\*\*|[-+*/^(),]))")


def _tokenize(text: str):
    pos, out = 0, []
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise ExpressionError(
                    f"unexpected character {text[pos:].strip()[0]!r} "
                    f"at position {pos} in {text!r}")
            break
        pos = m.end()
        if m.group("num"):
            out.append(("num", float(m.group("num"))))
        elif m.group("name"):
            out.append(("name", m.group("name")))
        else:
            out.append(("op", m.group("op")))
    out.append(("end", None))
    return out


class _Parser:
    def __init__(self, tokens, variables, parameters):
        self.toks = tokens
        self.i = 0
        self.vars = variables
        self.params = parameters

    def peek(self):
        return self.toks[self.i]

    def take(self, kind=None, value=None):
        k, v = self.toks[self.i]
        if (kind and k != kind) or (value is not None and v != value):
            raise ExpressionError(f"expected {value or kind}, got {v!r}")
        self.i += 1
        return v

    # each parse method returns a closure env -> ndarray
    def expr(self):
        node = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            op = self.take("op")
            rhs = self.term()
            lhs = node
            node = ((lambda e, a=lhs, b=rhs: a(e) + b(e)) if op == "+"
                    else (lambda e, a=lhs, b=rhs: a(e) - b(e)))
        return node

    def term(self):
        node = self.unary()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            op = self.take("op")
            rhs = self.unary()
            lhs = node
            node = ((lambda e, a=lhs, b=rhs: a(e) * b(e)) if op == "*"
                    else (lambda e, a=lhs, b=rhs: a(e) / b(e)))
        return node

    def unary(self):
        sign = 1.0
        while self.peek() in (("op", "+"), ("op", "-")):
            if self.take("op") == "-":
                sign = -sign
        node = self.power()
        if sign < 0:
            inner = node
            node = lambda e, a=inner: -a(e)
        return node

    def power(self):
        base = self.atom()
        if self.peek() in (("op", "^"), ("op", "**")):
            self.take("op")
            exp = self.power()      # right-associative
            return lambda e, a=base, b=exp: a(e) ** b(e)
        return base

    def atom(self):
        kind, value = self.peek()
        if kind == "num":
            self.take()
            return lambda e, v=value: v
        if kind == "op" and value == "(":
            self.take()
            node = self.expr()
            self.take("op", ")")
            return node
        if kind == "name":
            self.take()
            if self.peek() == ("op", "("):
                fn = _FUNCTIONS.get(value)
                if fn is None:
                    raise ExpressionError(f"unknown function {value!r}")
                self.take()
                args = [self.expr()]
                while self.peek() == ("op", ","):
                    self.take()
                    args.append(self.expr())
                self.take("op", ")")
                return lambda e, f=fn, a=tuple(args): f(*(x(e) for x in a))
            if value in self.vars:
                return lambda e, n=value: e[n]
            if value in self.params:
                return lambda e, v=self.params[value]: v
            if value in _CONSTANTS:
                return lambda e, v=_CONSTANTS[value]: v
            raise ExpressionError(f"unknown symbol {value!r}")
        raise ExpressionError(f"unexpected token {value!r}")


class Expression:
    """A compiled expression over named variables.

    >>> f = Expression("sin(x + y)", variables=("x", "y"))
    >>> f(0.25, 0.25)
    0.479...

    ``parameters`` plays the role of the reference's ``defparam`` symbol
    table (evaluate.F90: defparam/getparam): named constants folded in at
    compile time.
    """

    def __init__(self, text: str, variables=("x", "y"),
                 parameters: dict | None = None):
        self.text = text
        self.variables = tuple(variables)
        self.parameters = dict(parameters or {})
        toks = _tokenize(text)
        p = _Parser(toks, set(self.variables), self.parameters)
        self._fn = p.expr()
        if p.peek()[0] != "end":
            raise ExpressionError(
                f"trailing input {p.peek()[1]!r} in {text!r}")

    def __call__(self, *args):
        if len(args) != len(self.variables):
            raise ExpressionError(
                f"{self.text!r} takes {len(self.variables)} args "
                f"({', '.join(self.variables)}), got {len(args)}")
        env = dict(zip(self.variables, (np.asarray(a) for a in args)))
        return np.asarray(self._fn(env))

    def __repr__(self):
        return f"Expression({self.text!r}, variables={self.variables})"


def compile_expression(text: str, variables=("x", "y"),
                       parameters: dict | None = None) -> Expression:
    """Compile ``text`` into a vectorized callable (evalexpr equivalent)."""
    return Expression(text, variables, parameters)


def evaluate(text: str, parameters: dict | None = None, **variables):
    """One-shot evaluation: evaluate("2*a+1", a=3) -> 7.0."""
    expr = Expression(text, variables=tuple(variables),
                      parameters=parameters)
    return expr(*variables.values())
