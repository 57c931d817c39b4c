"""The benchmark of ``slrsfs_tpu_torch`` on NVIDIA H100 cards.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` in this process: its configuration
(``benchmark/configs/<config>.json``) under its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver in
``benchmark/drivers/``), with the limits of its output check
(``benchmark/limits/<cell>.json``). Set-up makes the weights and the
traffic from the seed and warms up the cell's shapes; the window then runs
for ``--seconds``; the output check follows. With ``--trace 1`` a bounded
slice after the window is traced and the cell's per-layer metrics are
reported (each read by ``benchmark/metrics/<metric>.py``); otherwise its
end-to-end metrics. The last line of standard output is the result as one
JSON object. Without the cards the cell asks for, or with JAX or the JAX
package loaded, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def find_cell(bench, name: str):
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if len(cells) != 1:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    cfg = [c for c in bench["configs"] if c["name"] == cell["config"]][0]
    return cell, cfg


def run_cell(args, device: str = "cuda", t_start: float = None) -> dict:
    """Run the cell ``args.workload`` on ``device`` and return its result:
    the driver's output plus the metrics read from its readings. It is
    correct when every compared number is within its limit and no answer
    of the window failed."""
    bench = harness.load_json("BENCHMARK.json")
    cell, cfg_entry = find_cell(bench, args.workload)
    cfg = harness.load_json(cfg_entry["file"])
    mix = harness.load_json(os.path.join("benchmark", "traffic", cell["traffic"] + ".json"))
    limits = harness.load_json(os.path.join("benchmark", "limits", cell["name"] + ".json"))
    driver = importlib.import_module("benchmark.drivers." + mix["kind"])
    out = driver.run(args, cell, mix, cfg, limits,
                     T_START if t_start is None else t_start, device=device)
    r = out["readings"]
    r.chips = cell["chips"]
    out["metrics"] = harness.read_metrics(
        harness.cell_metrics(bench, cell["name"], bool(args.trace)), r)
    out["correct"] = (all(c["value"] <= c["limit"] for c in out["checks"].values())
                      and out["failed"] == 0)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    harness.set_cache_dirs()
    import torch

    bench = harness.load_json("BENCHMARK.json")
    chips = find_cell(bench, args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 2
    r = out["readings"]
    harness.print_result(out["correct"], out["attempted"], out["failed"], out["metrics"],
                         harness.device_info(r.chips, r.peak_bytes, r.trace),
                         out["checks"], out["breakdown"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
