"""Run-log scraper — the ``slurm_out_parser.py`` capability over the
pipelines' and trainers' printouts.

Port of ``scd_tpu/utils/logparse.py`` (the port prints the same metric
lines, so one scraper reads the logs of both packages).

The reference regex-scrapes hyperparameters and final accuracies out of
slurm stdout into pandas rows (``gcd/project_utils/slurm_out_parser.py``:
a ``Namespace(...)`` line for hparams, the last ``Train Accuracies:`` line
for metrics).  This repo's primary metric stream is structured
(``MetricWriter`` JSONL + ``read_scalars``), but runs driven from shell
logs still need the scrape path; this module parses the pipeline/trainer
stdout formats:

- ``<TAG> Accuracies: All <x> | Old <y> | New <z>``  (pipelines, eval)
- ``ACC/sACC_avg/sACC_all: <subset> <a>/<b>/<c>``    (voting metric block)
- ``ACC/Soft sACC: <subset> <a>/<b>``
- ``Epoch <n>: k1 v1 | k2 v2 | ...``                 (trainer epoch lines)
- ``IoU: <x>``
- argparse ``Namespace(...)`` hparam echoes (reference-compatible)
"""

from __future__ import annotations

import re
from typing import Dict, List

_RX = {
    # tag admits spaces ("Best Train Accuracies", the reference's
    # learn_metric.py:329 format) and is stripped on capture
    "accs": re.compile(
        r"^(?P<tag>[\w -]*?)\s*Accuracies: All (?P<all>[\d.]+) \| "
        r"Old (?P<old>[\d.]+) \| New (?P<new>[\d.]+)"),
    "sacc": re.compile(
        r"^ACC/sACC_avg/sACC_all: (?P<subset>\w+) "
        r"(?P<acc>[\d.]+)/(?P<avg>[\d.]+)/(?P<all>[\d.]+)"),
    "soft": re.compile(
        r"^ACC/Soft sACC: (?P<subset>\w+) (?P<acc>[\d.]+)/(?P<soft>[\d.]+)"),
    "epoch": re.compile(r"^Epoch (?P<n>\d+): (?P<rest>.+)"),
    "iou": re.compile(r"^IoU: (?P<iou>[\d.]+)"),
    "namespace": re.compile(r"Namespace\((?P<body>.*)\)"),
    "kv": re.compile(r"(\w+)=('[^']*'|[^,()]+)"),
}


def parse_run_log(path_or_lines) -> Dict:
    """Scrape a run log into ``{"hparams", "accs", "sacc", "soft_sacc",
    "epochs", "iou"}``.

    ``accs`` keeps every occurrence in order (the reference takes the LAST
    ``Train Accuracies`` line — use ``parsed["accs"][-1]``); ``epochs`` is
    a list of per-epoch scalar dicts from trainer logs.
    """
    if isinstance(path_or_lines, (list, tuple)):
        lines = list(path_or_lines)
    else:
        with open(path_or_lines) as f:
            lines = f.readlines()

    out: Dict = {"hparams": {}, "accs": [], "sacc": [], "soft_sacc": [],
                 "epochs": [], "iou": None}
    for line in lines:
        line = line.rstrip("\n")
        m = _RX["namespace"].search(line)
        if m and not out["hparams"]:
            for k, v in _RX["kv"].findall(m.group("body")):
                v = v.strip().strip("'")
                for cast in (int, float):
                    try:
                        v = cast(v)
                        break
                    except ValueError:
                        continue
                out["hparams"][k] = v
            continue
        m = _RX["accs"].match(line)
        if m:
            out["accs"].append({"tag": m.group("tag").strip(),
                                "all": float(m.group("all")),
                                "old": float(m.group("old")),
                                "new": float(m.group("new"))})
            continue
        m = _RX["sacc"].match(line)
        if m:
            out["sacc"].append({"subset": m.group("subset"),
                                "acc": float(m.group("acc")),
                                "avg": float(m.group("avg")),
                                "all": float(m.group("all"))})
            continue
        m = _RX["soft"].match(line)
        if m:
            out["soft_sacc"].append({"subset": m.group("subset"),
                                     "acc": float(m.group("acc")),
                                     "soft": float(m.group("soft"))})
            continue
        m = _RX["epoch"].match(line)
        if m:
            scalars = {"epoch": int(m.group("n"))}
            for part in m.group("rest").split(" | "):
                bits = part.rsplit(" ", 1)
                if len(bits) == 2:
                    try:
                        scalars[bits[0].strip()] = float(bits[1])
                    except ValueError:
                        pass
            out["epochs"].append(scalars)
            continue
        m = _RX["iou"].match(line)
        if m:
            out["iou"] = float(m.group("iou"))
    return out


def summarize_runs(paths: List[str]) -> List[Dict]:
    """One summary row per run log (the reference's sweep-table use case:
    hparams + the final accuracy line), sortable/printable without
    pandas."""
    rows = []
    for p in paths:
        parsed = parse_run_log(p)
        row = dict(parsed["hparams"])
        row["log"] = p
        if parsed["accs"]:
            last = parsed["accs"][-1]
            row.update({"all": last["all"], "old": last["old"],
                        "new": last["new"]})
        if parsed["iou"] is not None:
            row["iou"] = parsed["iou"]
        rows.append(row)
    return rows
