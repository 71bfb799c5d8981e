"""The device ops that make up one launch of each measured kernel, by the
names the program's CUDA sources give them, and their time per launch in a
traced window.

A launch is its `lead` kernel, with the op right before it when that
matches `before` and the ops right after it that match `after`, in order
(one stream runs them back to back). A kernel renamed or taken off the
path leaves its launches empty, and the metric that reads them silent.
"""

from __future__ import annotations

import re

GROUPS = {
    # csrc/bsr_predict.cu: kernel 3, exhaustive fp32
    "bsr_predict_f32": dict(lead=r"\bex_kernel<"),
    # csrc/topk.cu: kernel 9
    "topk": dict(lead=r"\bblocked_topk_kernel<"),
    # csrc/hinge.cu on csrc/split_tf32.cuh: kernel 1, four kernels a launch
    "hinge": dict(lead=r"\bhinge_scores_kernel\b",
                  before=r"\bsplit_rows_kernel\b",
                  after=(r"\breg_plus_rx_kernel<true>",
                         r"\bobjective_kernel\b")),
    # csrc/hvp.cu on csrc/split_tf32.cuh: kernel 2, three kernels a launch
    "hvp": dict(lead=r"\bmasked_scores_kernel\b",
                before=r"\bsplit_rows_kernel\b",
                after=(r"\breg_plus_rx_kernel<false>",)),
}


def launch_seconds(trace, group: str) -> list[float]:
    """Device seconds of each launch of `group` that began in the window."""
    spec = GROUPS[group]
    ops = trace.in_window()
    lead = re.compile(spec["lead"])
    before = re.compile(spec["before"]) if "before" in spec else None
    after = [re.compile(p) for p in spec.get("after", ())]
    out = []
    for i, op in enumerate(ops):
        if not lead.search(op.name):
            continue
        t = op.end - op.start
        if before is not None and i > 0 and before.search(ops[i - 1].name):
            t += ops[i - 1].end - ops[i - 1].start
        j = i + 1
        for rx in after:
            if j < len(ops) and rx.search(ops[j].name):
                t += ops[j].end - ops[j].start
                j += 1
        out.append(t / 1e9)
    return out
