"""Parser for the SPD (stream processing description) DSL (a verbatim copy
of the JAX package's ``core/spd.py``; ``tests/test_torch_frontend.py``
holds both parsers to the same ``Core`` on every shipped source).

Accepts the paper's syntax (Figs. 4, 5, 6, 8, 10, 11 and Tables I/II):

    Name      <core name>;
    Main_In   {<if>::p1,p2,...};        Main_Out {<if>::p1,...};
    Brch_In   {<if>::p1,...};           Brch_Out {<if>::p1,...};
    Append_Reg{<if>::r1,r2,...};        # constant (register) inputs
    Param     <name> = <constant>;
    EQU       <node>, <out> = <formula>;
    HDL       <node>, <delay>, (outs)[(bouts)] = Module(ins)[(bins)] [, params];
    DRCT      (dest ports) = (src ports);

Strings after '#' are comments; statements may span lines and end with ';'.
Formulae support + - * / unary-minus, parentheses, numeric literals, named
parameters, and calls (sqrt, abs, min, max, rsqrt, exp).

This is the first stage of the compilation pipeline
(docs/pipeline.md §parse); the complete grammar, statement by statement,
is docs/spd_reference.md (whose snippets are parsed by this module in
``tests/test_docs.py``).
"""

from __future__ import annotations

import re

from ..tracing import timed
from .dfg import (
    Bin,
    Call,
    Core,
    Expr,
    Interface,
    Neg,
    Node,
    Num,
    SPDError,
    SUPPORTED_CALLS,
    Var,
)


class SPDParseError(SPDError):
    pass


# --------------------------------------------------------------------------
# Formula (Pratt) parser
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<ident>[A-Za-z_][A-Za-z_0-9:]*)"
    r"|(?P<op>[-+*/(),]))"
)


def _tokenize_formula(s: str) -> list[tuple[str, str]]:
    toks: list[tuple[str, str]] = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise SPDParseError(f"bad token at {s[pos:]!r} in formula {s!r}")
        pos = m.end()
        for kind in ("num", "ident", "op"):
            v = m.group(kind)
            if v is not None:
                toks.append((kind, v))
                break
    toks.append(("end", ""))
    return toks


class _FormulaParser:
    def __init__(self, text: str):
        self.toks = _tokenize_formula(text)
        self.i = 0
        self.text = text

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val: str) -> None:
        k, v = self.next()
        if v != val:
            raise SPDParseError(f"expected {val!r}, got {v!r} in {self.text!r}")

    def parse(self) -> Expr:
        e = self.expr()
        if self.peek()[0] != "end":
            raise SPDParseError(f"trailing tokens in formula {self.text!r}")
        return e

    def expr(self) -> Expr:  # additive
        e = self.term()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            e = Bin(op, e, self.term())
        return e

    def term(self) -> Expr:  # multiplicative
        e = self.unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            e = Bin(op, e, self.unary())
        return e

    def unary(self) -> Expr:
        if self.peek()[1] == "-":
            self.next()
            return Neg(self.unary())
        if self.peek()[1] == "+":
            self.next()
            return self.unary()
        return self.atom()

    def atom(self) -> Expr:
        kind, v = self.next()
        if kind == "num":
            return Num(float(v))
        if v == "(":
            e = self.expr()
            self.expect(")")
            return e
        if kind == "ident":
            if self.peek()[1] == "(":
                if v not in SUPPORTED_CALLS:
                    raise SPDParseError(f"unknown function {v!r} in {self.text!r}")
                self.next()
                args = [self.expr()]
                while self.peek()[1] == ",":
                    self.next()
                    args.append(self.expr())
                self.expect(")")
                return Call(v, tuple(args))
            return Var(_strip_qual(v))
        raise SPDParseError(f"unexpected token {v!r} in formula {self.text!r}")


def parse_formula(text: str) -> Expr:
    return _FormulaParser(text).parse()


# --------------------------------------------------------------------------
# Statement-level parsing
# --------------------------------------------------------------------------


def _strip_comments(text: str) -> str:
    return "\n".join(line.split("#", 1)[0] for line in text.splitlines())


def _strip_qual(name: str) -> str:
    """``Mi::sop`` -> ``sop`` (interface qualifier is advisory in this IR)."""
    return name.split("::")[-1].strip()


def _parse_iface(body: str, default: str) -> Interface:
    body = body.strip()
    if not (body.startswith("{") and body.endswith("}")):
        raise SPDParseError(f"interface body must be braced: {body!r}")
    inner = body[1:-1]
    ifname = default
    items = [x.strip() for x in inner.split(",") if x.strip()]
    if items and "::" in items[0]:
        ifname, first = items[0].split("::", 1)
        ifname = ifname.strip()
        items[0] = first.strip()
    ports = tuple(_strip_qual(x) for x in items)
    if len(set(ports)) != len(ports):
        raise SPDParseError(f"duplicate ports in interface {ifname}: {ports}")
    return Interface(ifname, ports)


def _parse_port_list(text: str) -> tuple[str, ...]:
    text = text.strip()
    if not (text.startswith("(") and text.endswith(")")):
        raise SPDParseError(f"expected parenthesized port list: {text!r}")
    return tuple(
        _strip_qual(x) for x in text[1:-1].split(",") if x.strip() != ""
    )


_CALL_RE = re.compile(
    r"^\s*(?P<outs>\([^()]*\))\s*(?P<bouts>\([^()]*\))?\s*=\s*"
    r"(?P<mod>[A-Za-z_][A-Za-z_0-9]*)\s*(?P<ins>\([^()]*\))\s*"
    r"(?P<bins>\([^()]*\))?\s*$"
)


def _parse_module_call(text: str) -> tuple[tuple[str, ...], str, tuple[str, ...]]:
    """``(o1,o2)(bo1) = Mod(i1,i2)(bi1)`` -> (outputs, module, inputs).

    Branch ports are concatenated after the main ports on each side, which
    matches how the compiler binds positional HDL arguments.
    """
    m = _CALL_RE.match(text)
    if not m:
        raise SPDParseError(f"bad module call: {text!r}")
    outs = _parse_port_list(m.group("outs"))
    if m.group("bouts"):
        outs += _parse_port_list(m.group("bouts"))
    ins = _parse_port_list(m.group("ins"))
    if m.group("bins"):
        ins += _parse_port_list(m.group("bins"))
    return outs, m.group("mod"), ins


def _split_top_commas(text: str, maxsplit: int = -1) -> list[str]:
    """Split on commas not nested in parentheses."""
    parts: list[str] = []
    depth = 0
    cur: list[str] = []
    n = 0
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0 and (maxsplit < 0 or n < maxsplit):
            parts.append("".join(cur))
            cur = []
            n += 1
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


@timed("setup.parse")
def parse_spd(text: str, *, name_hint: str = "core") -> Core:
    """Parse one SPD source into a :class:`Core`."""
    body = _strip_comments(text)
    stmts = [s.strip() for s in body.replace("\n", " ").split(";")]
    core = Core(name=name_hint)
    seen_name = False
    n_if = 0

    for stmt in stmts:
        if not stmt:
            continue
        m = re.match(r"^(\w+)\s*(.*)$", stmt, re.S)
        if not m:
            raise SPDParseError(f"bad statement: {stmt!r}")
        func, rest = m.group(1), m.group(2).strip()
        lf = func.lower()

        if lf == "name":
            core.name = rest.strip()
            seen_name = True
        elif lf in ("main_in", "main_out", "brch_in", "brch_out", "append_reg"):
            n_if += 1
            itf = _parse_iface(rest, default=f"if{n_if}")
            if lf == "main_in":
                core.main_in.append(itf)
            elif lf == "main_out":
                core.main_out.append(itf)
            elif lf == "brch_in":
                core.brch_in.append(itf)
            elif lf == "brch_out":
                core.brch_out.append(itf)
            else:  # Append_Reg: constant scalar inputs
                core.regs.extend(itf.ports)
        elif lf == "param":
            pm = re.match(r"^([A-Za-z_]\w*)\s*=\s*(.+)$", rest)
            if not pm:
                raise SPDParseError(f"bad Param: {stmt!r}")
            core.params[pm.group(1)] = float(pm.group(2))
        elif lf == "equ":
            parts = _split_top_commas(rest, maxsplit=1)
            if len(parts) != 2:
                raise SPDParseError(f"bad EQU: {stmt!r}")
            node_name = parts[0].strip()
            em = re.match(r"^([A-Za-z_][\w:]*)\s*=\s*(.+)$", parts[1].strip(), re.S)
            if not em:
                raise SPDParseError(f"bad EQU assignment: {stmt!r}")
            out = _strip_qual(em.group(1))
            expr = parse_formula(em.group(2))
            # Parameters are constants, not dataflow inputs.
            from .dfg import expr_vars

            ins = tuple(v for v in expr_vars(expr) if v not in core.params)
            core.nodes.append(
                Node(node_name, "equ", ins, (out,), expr=expr)
            )
        elif lf == "hdl":
            parts = _split_top_commas(rest)
            if len(parts) < 3:
                raise SPDParseError(f"bad HDL: {stmt!r}")
            node_name = parts[0].strip()
            delay = int(float(parts[1].strip()))
            call = parts[2].strip()
            params = tuple(p.strip() for p in parts[3:] if p.strip())
            outs, mod, ins = _parse_module_call(call)
            core.nodes.append(
                Node(
                    node_name,
                    "hdl",
                    ins,
                    outs,
                    module=mod,
                    delay=delay,
                    params=params,
                )
            )
        elif lf == "drct":
            dm = re.match(r"^(\([^()]*\))\s*=\s*(\([^()]*\))$", rest)
            if not dm:
                raise SPDParseError(f"bad DRCT: {stmt!r}")
            dests = _parse_port_list(dm.group(1))
            srcs = _parse_port_list(dm.group(2))
            core.drcts.append((dests, srcs))
        else:
            raise SPDParseError(f"unknown SPD function {func!r} in {stmt!r}")

    if not seen_name:
        raise SPDParseError("SPD source missing Name statement")
    return core


def parse_spd_file(path: str) -> Core:
    with open(path) as f:
        return parse_spd(f.read(), name_hint=path)
