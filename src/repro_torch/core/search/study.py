"""Durable, resumable search studies (docs/pipeline.md §study).

A copy of the JAX package's ``core/search/study.py`` with the port's own
default directory (docs/port.md §dse).

A :class:`Study` is a named JSON-lines journal of everything a search
learned: every measured trial (the full
:data:`~repro_torch.core.search.runner.EXECUTED_POINT_FIELDS` record plus its
measurement context) and every infeasible candidate (its lattice
coordinates and continuous
:func:`~repro_torch.core.legalize.constraint_violation` distance). Trials are
keyed by the same content fingerprints as
:class:`~repro_torch.core.measure.MeasurementCache` — the core-IR fingerprint,
grid shape, backend descriptor, interpret flag and measurement policy —
so a study written by one process is meaningful to any other process
measuring the same kernel, and synthetic walls from an injected test
timer (namespaced ``injected-timer:``) can never replay into an honest
run.

The write path is a single ``os.write`` on an ``O_APPEND`` descriptor
per record: POSIX appends of one small buffer are atomic, so two
processes appending trials to the same study concurrently interleave
whole records and lose nothing (the concurrency regression test in
``tests/test_study.py`` exercises exactly this). Loading tolerates a
torn trailing line — a crash mid-append costs at most the record being
written, never the journal.

``Study.resume(name, dir)`` re-opens a journal by name;
:meth:`Study.replay_into` then seeds a
:class:`~repro_torch.core.search.runner.SearchRunner`'s plan-dedupe table with
every context-matching measured wall, so an interrupted search continues
with **zero** re-measurement — a replayed plan is served from the dedupe
table before the budget check, exactly like an in-run duplicate.
:meth:`Study.report` renders the journal as a convergence/Pareto report
(text and a self-contained HTML page) for the BENCH artifacts.
"""

from __future__ import annotations

import json
import os

__all__ = [
    "Study",
    "TRIAL_CONTEXT_FIELDS",
    "default_study_dir",
]

#: The measurement-context keys every trial record carries (in addition
#: to ``point`` / ``coords``). Together they name the same identity as a
#: MeasurementCache key: a trial replays into a runner only when all of
#: them match the runner's own context.
TRIAL_CONTEXT_FIELDS = (
    "fingerprint",
    "grid",
    "backend",
    "interpret",
    "warmup",
)


def default_study_dir() -> str:
    """Where named studies live: ``$REPRO_TORCH_STUDY_DIR``, or
    ``build/repro_torch/studies`` of the checkout (beside the port's
    measurement cache; docs/port.md §dse)."""
    env = os.environ.get("REPRO_TORCH_STUDY_DIR")
    if env:
        return env
    from repro_torch.kernels.build import build_dir

    return str(build_dir() / "studies")


class Study:
    """A named durable journal of search trials.

    Parameters
    ----------
    name:
        The study's identity. Resuming a search means re-opening a
        study with the same name in the same directory.
    dir:
        Directory holding ``<name>.jsonl``; :func:`default_study_dir`
        when omitted.
    """

    VERSION = 1

    def __init__(self, name: str, dir: str | None = None):
        if not name or os.sep in name or name.startswith("."):
            raise ValueError(f"invalid study name: {name!r}")
        self.name = name
        self.dir = default_study_dir() if dir is None else str(dir)
        self.path = os.path.join(self.dir, f"{name}.jsonl")
        self.records: list[dict] = []
        self._seen: set[tuple] = set()  # identity of every loaded/written rec
        self._load()

    # ---- construction ------------------------------------------------------

    @classmethod
    def resume(cls, name: str, dir: str | None = None) -> "Study":
        """Re-open a study by name (creating it if it does not exist yet).

        Identical to the constructor — the separate name documents
        intent at call sites: ``Study.resume("nightly-lbm")`` says the
        prior trials are expected and will be replayed.
        """
        return cls(name, dir)

    # ---- persistence -------------------------------------------------------

    def _load(self) -> None:
        self.records = []
        self._seen = set()
        try:
            with open(self.path, encoding="utf-8") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn trailing line from a crashed writer
            if not isinstance(rec, dict):
                continue
            self.records.append(rec)
            ident = self._identity(rec)
            if ident is not None:
                self._seen.add(ident)

    def reload(self) -> None:
        """Re-read the journal (picks up records from other processes)."""
        self._load()

    def _append(self, rec: dict) -> None:
        """Durably append one record: a single atomic O_APPEND write."""
        os.makedirs(self.dir, exist_ok=True)
        data = (json.dumps(rec, sort_keys=True) + "\n").encode("utf-8")
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        self.records.append(rec)
        ident = self._identity(rec)
        if ident is not None:
            self._seen.add(ident)

    @staticmethod
    def _identity(rec: dict) -> tuple | None:
        """What makes two records duplicates of one another.

        Measured trials: the measurement context plus the concrete
        legalized plan. Violations: the context plus the raw lattice
        coordinates. ``None`` for unrecognized records (never deduped).
        """
        ctx = tuple(
            json.dumps(rec.get(f), sort_keys=True)
            for f in TRIAL_CONTEXT_FIELDS
        )
        point = rec.get("point")
        if isinstance(point, dict):
            return ctx + (
                "trial",
                point.get("block_h"), point.get("m"),
                point.get("steps"), point.get("d"), point.get("reps"),
                # Older journals predate the double_buffer plan dimension
                # (docs/pipeline.md §stream); they recorded the
                # then-default ping/pong protocol. Likewise b=1 for
                # journals older than the batch axis
                # (docs/pipeline.md §serve).
                bool(point.get("double_buffer", True)),
                int(point.get("b", 1)),
                # "" for journals older than the fusion plan dimension
                # (docs/pipeline.md §program).
                str(point.get("fusion", "") or ""),
                # 1 (the row ring) for journals older than the mesh
                # column axis (DESIGN.md §15): a d-only record resumes
                # into the (dy, dx) identity with zero re-measurement.
                int(point.get("dx", 1) or 1),
            )
        coords = rec.get("coords")
        if coords is not None:
            return ctx + ("violation", tuple(coords))
        return None

    # ---- recording ---------------------------------------------------------

    def _context(self, runner) -> dict:
        return {
            "fingerprint": runner.study_fingerprint(),
            "grid": [runner.h, runner.w],
            "backend": runner.backend,
            "interpret": bool(runner.interpret),
            "warmup": int(runner.warmup),
        }

    def record_trial(self, runner, executed, **meta) -> bool:
        """Journal one measured point; False when it is already recorded.

        ``executed`` is an :class:`~repro_torch.core.search.runner
        .ExecutedPoint`; its ``as_dict()`` — the one executed-point
        schema — becomes the record's ``point`` field verbatim, and the
        record also carries the runner's MeasurementCache key for the
        plan so cache and study agree on the plan's content identity.
        """
        from .runner import RunPlan

        point = executed.as_dict()
        plan = RunPlan.from_dict(point)
        rec = {
            "v": self.VERSION,
            "study": self.name,
            "trial": len(self.records),
            "key": runner.cache_key(plan),
            **self._context(runner),
            "point": point,
            "violation": 0.0,
            **{k: v for k, v in meta.items() if v is not None},
        }
        if self._identity(rec) in self._seen:
            return False
        self._append(rec)
        return True

    def record_violation(self, runner, coords: tuple,
                         violation: float, **meta) -> bool:
        """Journal an infeasible candidate's (block_h, m, d) coordinates
        and its continuous constraint-violation distance."""
        rec = {
            "v": self.VERSION,
            "study": self.name,
            "trial": len(self.records),
            "key": None,
            **self._context(runner),
            "point": None,
            "coords": [int(c) for c in coords],
            "violation": float(violation),
            **{k: v for k, v in meta.items() if v is not None},
        }
        if self._identity(rec) in self._seen:
            return False
        self._append(rec)
        return True

    # ---- queries -----------------------------------------------------------

    def _matches(self, rec: dict, ctx: dict) -> bool:
        return all(rec.get(f) == ctx[f] for f in TRIAL_CONTEXT_FIELDS)

    def trials_for(self, runner) -> list[dict]:
        """Every measured trial recorded under this runner's context."""
        ctx = self._context(runner)
        return [
            r for r in self.records
            if isinstance(r.get("point"), dict) and self._matches(r, ctx)
        ]

    def violations_for(self, runner) -> list[dict]:
        """Every infeasible-candidate record under this runner's context."""
        ctx = self._context(runner)
        return [
            r for r in self.records
            if r.get("point") is None and r.get("coords") is not None
            and self._matches(r, ctx)
        ]

    def replay_into(self, runner) -> int:
        """Seed the runner's plan-dedupe table from completed trials.

        Every measured trial whose context (fingerprint, grid, backend,
        interpret, warmup) matches the runner becomes an entry in its
        in-run wall table — the table :meth:`SearchRunner.measure`
        consults *before* the budget check, so a replayed plan costs
        zero budget and zero kernel runs. Returns the number of plans
        replayed; the runner's ``replayed`` counter is bumped so the
        search result can report it.
        """
        from .runner import RunPlan

        n = 0
        for rec in self.trials_for(runner):
            plan = RunPlan.from_dict(rec["point"])
            if plan.key() not in runner._walls:
                runner._walls[plan.key()] = float(rec["point"]["wall_s"])
                n += 1
        runner.replayed += n
        return n

    # ---- reporting ---------------------------------------------------------

    def _measured(self) -> list[dict]:
        return [r for r in self.records if isinstance(r.get("point"), dict)]

    def convergence(self) -> list[tuple[int, float]]:
        """(trial index, best measured GFLOP/s so far) per measured trial."""
        out, best = [], float("-inf")
        for i, rec in enumerate(self._measured()):
            g = float(rec["point"]["measured_gflops"])
            best = max(best, g)
            out.append((i, best))
        return out

    def pareto(self) -> list[dict]:
        """Non-dominated trials over (measured GFLOP/s ↑, devices ↓).

        The paper's trade-off: more spatial parallelism (d) buys
        throughput at the cost of devices; the Pareto set is every trial
        no other trial beats on both axes.
        """
        meas = self._measured()
        front = []
        for rec in meas:
            p = rec["point"]
            dominated = any(
                float(o["point"]["measured_gflops"])
                >= float(p["measured_gflops"])
                and int(o["point"]["d"]) <= int(p["d"])
                and (
                    float(o["point"]["measured_gflops"])
                    > float(p["measured_gflops"])
                    or int(o["point"]["d"]) < int(p["d"])
                )
                for o in meas
            )
            if not dominated:
                front.append(rec)
        front.sort(key=lambda r: (int(r["point"]["d"]),
                                  -float(r["point"]["measured_gflops"])))
        # one representative per device count
        seen_d, uniq = set(), []
        for rec in front:
            d = int(rec["point"]["d"])
            if d not in seen_d:
                seen_d.add(d)
                uniq.append(rec)
        return uniq

    def report_text(self) -> str:
        """Human-readable convergence + Pareto summary of the journal."""
        meas = self._measured()
        nviol = len(self.records) - len(meas)
        lines = [
            f"study {self.name!r}: {len(self.records)} records "
            f"({len(meas)} measured trials, {nviol} infeasible candidates)",
        ]
        if not meas:
            lines.append("  (no measured trials yet)")
            return "\n".join(lines)
        conv = self.convergence()
        best_rec = max(
            meas, key=lambda r: float(r["point"]["measured_gflops"])
        )
        bp = best_rec["point"]
        lines.append(
            f"  best: {bp['measured_gflops']:.3f} GFLOP/s at "
            f"block_h={bp['block_h']} m={bp['m']} d={bp['d']} "
            f"(trial {meas.index(best_rec)})"
        )
        lines.append("  convergence (trial -> best-so-far GFLOP/s):")
        step = max(1, len(conv) // 8)
        shown = conv[::step]
        if shown[-1] != conv[-1]:
            shown.append(conv[-1])
        for i, best in shown:
            lines.append(f"    {i:4d}  {best:.3f}")
        lines.append("  pareto (devices -> best GFLOP/s):")
        for rec in self.pareto():
            p = rec["point"]
            lines.append(
                f"    d={p['d']:2d}  {p['measured_gflops']:.3f} GFLOP/s  "
                f"(block_h={p['block_h']}, m={p['m']})"
            )
        return "\n".join(lines)

    def report_html(self) -> str:
        """Self-contained HTML report: convergence SVG + Pareto table.

        No external assets or scripts — one file that renders anywhere,
        suitable for CI artifact upload next to ``BENCH_dse.json``.
        """
        conv = self.convergence()
        pareto = self.pareto()
        meas = self._measured()
        svg = self._convergence_svg(conv)
        rows = "\n".join(
            "<tr><td>{d}</td><td>{g:.3f}</td><td>{bh}</td><td>{m}</td>"
            "<td>{s}</td></tr>".format(
                d=r["point"]["d"], g=float(r["point"]["measured_gflops"]),
                bh=r["point"]["block_h"], m=r["point"]["m"],
                s=r.get("strategy", "?"),
            )
            for r in pareto
        )
        return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>study {self.name}</title>
<style>
 body {{ font: 14px/1.5 system-ui, sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #999; padding: 0.3em 0.8em; }}
 svg {{ border: 1px solid #ccc; }}
</style></head><body>
<h1>Study <code>{self.name}</code></h1>
<p>{len(self.records)} records — {len(meas)} measured trials,
{len(self.records) - len(meas)} infeasible candidates.</p>
<h2>Convergence (best measured GFLOP/s by trial)</h2>
{svg}
<h2>Pareto front: throughput vs device count</h2>
<table><tr><th>d</th><th>GFLOP/s</th><th>block_h</th><th>m</th>
<th>strategy</th></tr>
{rows}
</table>
<pre>{self.report_text()}</pre>
</body></html>
"""

    @staticmethod
    def _convergence_svg(conv: list[tuple[int, float]],
                         w: int = 560, h: int = 240) -> str:
        if not conv:
            return "<p>(no measured trials)</p>"
        xs = [i for i, _ in conv]
        ys = [g for _, g in conv]
        x0, x1 = min(xs), max(max(xs), min(xs) + 1)
        y0, y1 = 0.0, max(max(ys), 1e-12)
        pad = 30
        def px(x):  # noqa: E306 — tiny local mappers
            return pad + (x - x0) / (x1 - x0) * (w - 2 * pad)
        def py(y):
            return h - pad - (y - y0) / (y1 - y0) * (h - 2 * pad)
        pts = " ".join(f"{px(i):.1f},{py(g):.1f}" for i, g in conv)
        return (
            f'<svg width="{w}" height="{h}" viewBox="0 0 {w} {h}" '
            f'xmlns="http://www.w3.org/2000/svg">'
            f'<line x1="{pad}" y1="{h - pad}" x2="{w - pad}" '
            f'y2="{h - pad}" stroke="#333"/>'
            f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{h - pad}" '
            f'stroke="#333"/>'
            f'<polyline points="{pts}" fill="none" stroke="#06c" '
            f'stroke-width="2"/>'
            f'<text x="{w - pad}" y="{h - 8}" text-anchor="end" '
            f'font-size="11">trial</text>'
            f'<text x="6" y="{pad}" font-size="11">{y1:.2f} GF/s</text>'
            "</svg>"
        )

    def report(self, out_dir: str | None = None,
               basename: str | None = None) -> dict:
        """Write the text and HTML reports; returns their paths + text."""
        out_dir = self.dir if out_dir is None else str(out_dir)
        base = basename or f"{self.name}.report"
        os.makedirs(out_dir, exist_ok=True)
        text = self.report_text()
        html = self.report_html()
        txt_path = os.path.join(out_dir, f"{base}.txt")
        html_path = os.path.join(out_dir, f"{base}.html")
        with open(txt_path, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
        with open(html_path, "w", encoding="utf-8") as fh:
            fh.write(html)
        return {"text": txt_path, "html": html_path, "summary": text}
