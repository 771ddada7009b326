"""Generate docs/api.md from the package's public surface.

Dependency-free stand-in for a mkdocstrings/Documenter ``@autodocs`` page
(the reference ships a generated API reference,
the reference's ``docs/src/api.md:17-21``): walks the public modules, renders
each ``__all__`` symbol's signature and docstring as markdown.  Run manually
or in the docs CI job before ``mkdocs build``; the output is committed so the
page also reads fine on the repo itself.

Usage: python tools/gen_api_docs.py
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MODULES = [
    ("montecarlo_tpu", "Top-level exports"),
    ("montecarlo_tpu.core.simulation", "Simulation orchestrator"),
    ("montecarlo_tpu.core.schedule", "Schedules"),
    ("montecarlo_tpu.core.system", "System protocol"),
    ("montecarlo_tpu.core.moves", "Move / Policy protocol"),
    ("montecarlo_tpu.core.metropolis", "Metropolis"),
    ("montecarlo_tpu.core.algorithms", "Algorithm lifecycle & recorders"),
    ("montecarlo_tpu.core.tempering", "Parallel tempering"),
    ("montecarlo_tpu.core.wanglandau", "Wang-Landau"),
    ("montecarlo_tpu.core.ecmc", "Event-chain MC"),
    ("montecarlo_tpu.policy_guided", "Policy-guided MC (PGMC)"),
    ("montecarlo_tpu.policy_guided.gradients", "PGMC gradient kernel"),
    ("montecarlo_tpu.policy_guided.estimator", "PGMC estimator"),
    ("montecarlo_tpu.policy_guided.update", "PGMC update"),
    ("montecarlo_tpu.policy_guided.learning", "PGMC optimisers"),
    ("montecarlo_tpu.checkpoint", "Checkpoint / resume"),
    ("montecarlo_tpu.parallel.mesh", "Device mesh & sharding"),
    ("montecarlo_tpu.parallel.distributed", "Multi-host runtime"),
    ("montecarlo_tpu.models.particle1d", "Model: particle-1d"),
    ("montecarlo_tpu.models.lennard_jones", "Model: 2-D Lennard-Jones"),
    ("montecarlo_tpu.models.polydisperse",
     "Model: polydisperse soft spheres (swap MC)"),
    ("montecarlo_tpu.models.hard_disks", "Model: hard disks (ECMC)"),
    ("montecarlo_tpu.models.ising", "Model: Ising chain"),
    ("montecarlo_tpu.models.ising2d", "Model: 2-D Ising"),
    ("montecarlo_tpu.models.potts", "Model: Potts"),
    ("montecarlo_tpu.models.xy", "Model: XY"),
    ("montecarlo_tpu.models.heisenberg", "Model: Heisenberg"),
    ("montecarlo_tpu.models.tfim", "Model: transverse-field Ising (PIMC)"),
    ("montecarlo_tpu.ops.fused_sweep",
     "Triton kernel: 1-D Gaussian sweep"),
    ("montecarlo_tpu.ops.cell_mc", "Checkerboard cell-list MC (large N)"),
    ("montecarlo_tpu.ops.cluster", "Cluster-move ops"),
    ("montecarlo_tpu.utils.analysis", "Analysis toolkit"),
    ("montecarlo_tpu.utils.observability", "Observability"),
    ("montecarlo_tpu.utils.runtime", "Entry-point set-up"),
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ""


def _doc(obj, indent=""):
    doc = inspect.getdoc(obj)
    if not doc:
        return ""
    return "\n".join(indent + ln for ln in doc.splitlines())


def render_symbol(mod, name):
    obj = getattr(mod, name)
    out = []
    if inspect.isclass(obj):
        out.append(f"#### `class {name}{_sig(obj)}`\n")
        out.append(_doc(obj) + "\n")
        for mname, m in sorted(vars(obj).items()):
            if mname.startswith("_") or not callable(m):
                continue
            doc = inspect.getdoc(m)
            if not doc:
                continue
            out.append(f"- **`{mname}{_sig(m)}`** — "
                       f"{doc.splitlines()[0]}")
        out.append("")
    elif callable(obj):
        out.append(f"#### `{name}{_sig(obj)}`\n")
        out.append(_doc(obj) + "\n")
    else:
        out.append(f"#### `{name}`\n")
        out.append(f"Value: `{obj!r}`\n")
    return "\n".join(out)


def main():
    lines = [
        "# API reference",
        "",
        "*Generated from the package's public `__all__` surface by "
        "`tools/gen_api_docs.py` — do not edit by hand.*",
        "",
    ]
    for modname, title in MODULES:
        mod = importlib.import_module(modname)
        names = getattr(mod, "__all__", None)
        if not names:
            continue
        lines.append(f"## {title} — `{modname}`\n")
        head = (inspect.getdoc(mod) or "").split("\n\n")[0]
        if head:
            lines.append(head + "\n")
        for name in names:
            lines.append(render_symbol(mod, name))
    out_path = os.path.join(os.path.dirname(__file__), "..", "docs",
                            "api.md")
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {os.path.normpath(out_path)} "
          f"({sum(len(getattr(importlib.import_module(m), '__all__', []))
                  for m, _ in MODULES)} symbols)")


if __name__ == "__main__":
    main()
