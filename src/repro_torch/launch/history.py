"""History launcher: metric-vs-revision trend tables + verdicts.

    PYTHONPATH=src python -m repro_torch.launch.history \
        [--root results/torch_history] [--kind sweep] [--name PREFIX]
        [--last 8] [--out results/torch_history_report.md] [--check]

Counterpart of ``repro/launch/history.py`` over the port's history root
(``REPRO_HISTORY``, else ``results/torch_history``). Renders the
run-history store (``repro_torch.obs.HistoryStore`` — appended by
``python -m repro_torch.launch.sweep --history`` and serve snapshots) as a
markdown report: one section per record name, metrics as rows, the last
K comparable records (same backend / device count / ``use_pallas`` as
the newest) as columns keyed by short git rev. The final column is the
noise-aware sentinel verdict (median/MAD over the earlier records —
``repro_torch.obs.regress``), so the report answers both "how has this number
moved across revisions" and "is the latest one a regression".

``--check`` additionally exits non-zero on any regression.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.obs.history import (DEFAULT_ROOT, HistoryStore, comparable,
                                     history_root)
from repro_torch.obs.regress import (DEFAULT_K, DEFAULT_TOLERANCE, REGRESSION,
                               check_history, metric_direction,
                               summarize_verdicts)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.history", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=None,
                    help="history store dir (default REPRO_HISTORY or "
                         f"{DEFAULT_ROOT})")
    ap.add_argument("--kind", default=None,
                    choices=(None, "bench", "sweep", "serve"),
                    help="restrict to one record kind")
    ap.add_argument("--name", default="",
                    help="restrict to record names starting with PREFIX")
    ap.add_argument("--last", type=int, default=DEFAULT_K,
                    help="trend window: newest K comparable records")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE)
    ap.add_argument("--out", default="results/torch_history_report.md",
                    help="markdown report path ('' prints only)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any metric regressed")
    return ap


def _fmt(v) -> str:
    if v is None:
        return "·"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def trend_report(store: HistoryStore, *, kind=None, name_prefix: str = "",
                 last: int = DEFAULT_K,
                 tolerance: float = DEFAULT_TOLERANCE) -> tuple:
    """(markdown text, verdicts) for the store's current contents."""
    verdicts = check_history(store, k=last, tolerance=tolerance, kind=kind)
    by_key = {(v["name"], v["metric"]): v for v in verdicts}
    lines = ["# Run-history trends", ""]
    names = [n for n in store.names(kind=kind)
             if n.startswith(name_prefix)]
    if not names:
        lines.append("(no matching history records)")
        return "\n".join(lines) + "\n", []
    for name in names:
        recs = store.records(name=name)
        newest = recs[-1]
        window = [r for r in recs if comparable(r, newest)][-last:]
        man = newest.get("manifest") or {}
        lines.append(f"## `{name}`")
        lines.append("")
        lines.append(f"{len(window)} of {len(recs)} records comparable to "
                     f"newest (backend={man.get('backend')}, "
                     f"devices={man.get('n_devices')}, "
                     f"use_pallas={man.get('use_pallas')}); oldest first.")
        lines.append("")
        revs = [str((r.get('manifest') or {}).get('git_rev') or '?')[:8]
                for r in window]
        header = "| metric | " + " | ".join(revs) + " | verdict |"
        lines.append(header)
        lines.append("|" + "---|" * (len(window) + 2))
        metric_keys = [k for k, v in (newest.get("metrics") or {}).items()
                       if isinstance(v, (int, float))
                       and not isinstance(v, bool)]
        for key in metric_keys:
            vals = [(r.get("metrics") or {}).get(key) for r in window]
            v = by_key.get((name, key))
            if v is None:
                tag = "—" if metric_direction(key) == 0 else ""
            else:
                tag = v["status"]
                if v.get("ratio") is not None and v["status"] != "ok":
                    tag += f" ({v['ratio']:.2f}x median)"
            lines.append("| " + " | ".join(
                [f"`{key}`"] + [_fmt(x) for x in vals] + [tag]) + " |")
        lines.append("")
    counts = summarize_verdicts(verdicts)
    lines.append(f"Sentinel: {counts['total']} gated metrics — "
                 f"{counts['ok']} ok, {counts[REGRESSION]} regressions, "
                 f"{counts['improvement']} improvements, "
                 f"{counts['insufficient-history']} insufficient-history "
                 f"(window K={last}, tolerance={tolerance:.0%} + 3 robust "
                 f"sigmas).")
    return "\n".join(lines) + "\n", verdicts


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    root = args.root if args.root is not None else (history_root()
                                                   or DEFAULT_ROOT)
    store = HistoryStore(root)
    text, verdicts = trend_report(store, kind=args.kind,
                                  name_prefix=args.name, last=args.last,
                                  tolerance=args.tolerance)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
        print(f"[history] report -> {args.out}", flush=True)
    counts = summarize_verdicts(verdicts)
    if args.check and counts[REGRESSION]:
        raise SystemExit(1)
    return counts


if __name__ == "__main__":
    main()
