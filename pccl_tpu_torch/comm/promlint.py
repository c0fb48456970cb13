"""Strict Prometheus text-format (0.0.4) validator.

The master's ``/metrics`` surface is consumed by real scrapers, which
reject the WHOLE scrape on a single malformed line — a regression there
is an observability outage, not a cosmetic bug. This module is the
reusable gate both the unit tests and the fleet-scale bench lane apply to
every scrape they take:

* every line parses (comment, blank, or ``name{labels} value``),
* ``# TYPE`` precedes its family's samples and appears at most once,
* a family's samples are contiguous (no interleaving — scrapers group by
  family and many reject re-opened families),
* no duplicate series (same name + identical label set),
* label values are well-formed (quotes closed, only ``\\``, ``\\"`` and
  ``\\n`` escapes),
* histograms are coherent: ``le`` parses as a float, bucket counts are
  monotone non-decreasing in ``le`` order, the ``+Inf`` bucket exists and
  equals ``_count``, and ``_sum``/``_count`` accompany the buckets.

``lint(text)`` returns a list of violation strings (empty = clean);
``assert_valid(text)`` raises ``AssertionError`` with the first few.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_of(name: str, hist_families: set) -> str:
    """Collapse histogram sample names onto their declared family."""
    for suf in _HIST_SUFFIXES:
        if name.endswith(suf) and name[: -len(suf)] in hist_families:
            return name[: -len(suf)]
    return name


def _parse_labels(raw: str, lineno: int, errors: List[str]):
    """Parse the inside of ``{...}`` into an ordered (name, value) tuple.

    Returns None (and records the violation) on any malformed construct.
    """
    labels: List[Tuple[str, str]] = []
    i, n = 0, len(raw)
    while i < n:
        m = _LABEL_NAME_RE.match(raw, i)
        if not m:
            errors.append(f"line {lineno}: bad label name at {raw[i:i+20]!r}")
            return None
        lname = m.group(0)
        i = m.end()
        if i >= n or raw[i] != "=":
            errors.append(f"line {lineno}: expected '=' after label {lname!r}")
            return None
        i += 1
        if i >= n or raw[i] != '"':
            errors.append(f"line {lineno}: unquoted value for label {lname!r}")
            return None
        i += 1
        val = []
        closed = False
        while i < n:
            ch = raw[i]
            if ch == "\\":
                if i + 1 >= n or raw[i + 1] not in ('"', "\\", "n"):
                    errors.append(
                        f"line {lineno}: invalid escape in label {lname!r}")
                    return None
                val.append({"n": "\n"}.get(raw[i + 1], raw[i + 1]))
                i += 2
                continue
            if ch == '"':
                closed = True
                i += 1
                break
            if ch == "\n":
                break
            val.append(ch)
            i += 1
        if not closed:
            errors.append(f"line {lineno}: unterminated value for {lname!r}")
            return None
        labels.append((lname, "".join(val)))
        if i < n and raw[i] == ",":
            i += 1
        elif i < n:
            errors.append(f"line {lineno}: expected ',' between labels")
            return None
    return tuple(labels)


def lint(text: str) -> List[str]:
    errors: List[str] = []
    types: Dict[str, str] = {}          # family -> declared type
    helped: set = set()
    hist_families: set = set()
    closed_families: set = set()        # families whose sample block ended
    seen_series: set = set()
    # histogram accounting: (family, labels-without-le) -> buckets/sum/count
    buckets: Dict[Tuple, List[Tuple[float, float, int]]] = {}
    counts: Dict[Tuple, float] = {}
    sums: Dict[Tuple, bool] = {}
    current_family = None

    for lineno, line in enumerate(text.split("\n"), 1):
        if line == "":
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = parts[2]
                if not _NAME_RE.fullmatch(fam):
                    errors.append(f"line {lineno}: bad family name {fam!r}")
                    continue
                if parts[1] == "TYPE":
                    if len(parts) < 4 or parts[3].split()[0] not in (
                            "counter", "gauge", "histogram", "summary",
                            "untyped"):
                        errors.append(f"line {lineno}: bad TYPE for {fam}")
                        continue
                    if fam in types:
                        errors.append(f"line {lineno}: duplicate TYPE {fam}")
                    t = parts[3].split()[0]
                    types[fam] = t
                    if t == "histogram":
                        hist_families.add(fam)
                else:
                    if fam in helped:
                        errors.append(f"line {lineno}: duplicate HELP {fam}")
                    helped.add(fam)
            # other comments are legal and ignored
            continue
        m = _NAME_RE.match(line)
        if not m:
            errors.append(f"line {lineno}: unparsable line {line[:40]!r}")
            continue
        name = m.group(0)
        rest = line[m.end():]
        labels: Tuple = ()
        if rest.startswith("{"):
            close = rest.rfind("}")
            if close < 0:
                errors.append(f"line {lineno}: unclosed label set")
                continue
            parsed = _parse_labels(rest[1:close], lineno, errors)
            if parsed is None:
                continue
            labels = parsed
            rest = rest[close + 1:]
        fields = rest.split()
        if len(fields) not in (1, 2):  # value [timestamp]
            errors.append(f"line {lineno}: expected value after series")
            continue
        try:
            value = float(fields[0])
        except ValueError:
            errors.append(f"line {lineno}: bad value {fields[0]!r}")
            continue

        fam = _family_of(name, hist_families)
        if fam in types and fam not in helped and fam not in closed_families \
                and fam != current_family:
            pass  # TYPE-only families are fine
        if fam != current_family:
            if fam in closed_families:
                errors.append(
                    f"line {lineno}: family {fam} reopened (samples must be "
                    "contiguous)")
            if current_family is not None:
                closed_families.add(current_family)
            current_family = fam
        series_key = (name, labels)
        if series_key in seen_series:
            errors.append(f"line {lineno}: duplicate series {name}{labels!r}")
        seen_series.add(series_key)

        if fam in hist_families:
            base = tuple(l for l in labels if l[0] != "le")
            key = (fam, base)
            if name == fam + "_bucket":
                le = dict(labels).get("le")
                if le is None:
                    errors.append(f"line {lineno}: bucket without le label")
                    continue
                try:
                    le_f = math.inf if le == "+Inf" else float(le)
                except ValueError:
                    errors.append(f"line {lineno}: bad le {le!r}")
                    continue
                buckets.setdefault(key, []).append((le_f, value, lineno))
            elif name == fam + "_count":
                counts[key] = value
            elif name == fam + "_sum":
                sums[key] = True
            elif name != fam:
                errors.append(
                    f"line {lineno}: stray sample {name} in histogram {fam}")

    for (fam, base), bs in buckets.items():
        bs_sorted = sorted(bs, key=lambda b: b[0])
        prev = -1.0
        for le_f, v, lineno in bs_sorted:
            if v < prev:
                errors.append(
                    f"line {lineno}: {fam}{dict(base)!r} bucket le={le_f} "
                    f"count {v} < previous {prev} (non-monotone)")
            prev = v
        if not bs_sorted or bs_sorted[-1][0] != math.inf:
            errors.append(f"{fam}{dict(base)!r}: missing +Inf bucket")
        else:
            inf_v = bs_sorted[-1][1]
            if (fam, base) not in counts:
                errors.append(f"{fam}{dict(base)!r}: buckets without _count")
            elif counts[(fam, base)] != inf_v:
                errors.append(
                    f"{fam}{dict(base)!r}: +Inf bucket {inf_v} != _count "
                    f"{counts[(fam, base)]}")
        if (fam, base) not in sums:
            errors.append(f"{fam}{dict(base)!r}: buckets without _sum")
    return errors


def assert_valid(text: str, context: str = "scrape") -> None:
    errs = lint(text)
    if errs:
        shown = "\n  ".join(errs[:12])
        more = f"\n  ... and {len(errs) - 12} more" if len(errs) > 12 else ""
        raise AssertionError(
            f"{context}: {len(errs)} prometheus-text violation(s):\n"
            f"  {shown}{more}")
