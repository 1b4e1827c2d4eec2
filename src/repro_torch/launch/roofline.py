"""Roofline on the H100's peaks (the port's counterpart of
`repro.launch.roofline`): per cell, from the analytic census
(`launch.analytic`), and per route, from the kernels' launch census
(`kernels.census`, carried by `kernels.counters`).

  compute term = analytic FLOPs / (cards x peak)   [the bf16 peak, and
                 the policy's activation format's peak, `PEAK_OPS`; the
                 f32 CUDA-core peak when DPA is off]
  memory term  = analytic HBM bytes / (cards x HBM rate)
  collective term = analytic wire bytes a card receives / NVLink rate
                 (`analytic.cell_wire_bytes_per_device`: the TP decode
                 step's pool all-gather; 0 on one card)

plus MODEL_FLOPS / analytic FLOPs and the dominant term.  Nothing is read
from a dry run: the cells are arithmetic on the config.

Usage: python -m repro_torch.launch.roofline [--arch A] [--shape S]
       [--cards N]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import SHAPES, cell_applicable, get_config, \
    list_archs
from repro_torch.core.policy import get_policy
from repro_torch.kernels.census import (HBM_BYTES_PER_S, PEAK_OPS,
                                       wire_bound_s)
from repro_torch.launch import analytic as A

SUGGEST = {
    "compute": "raise DPA term count (fp8->fp4 operands) or cut remat "
               "recompute (selective checkpointing)",
    "memory": "quantize the streamed side (weights for decode, cache to "
              "fp8) — the paper's narrow-wire contract on HBM",
    "collective": "a narrower KV format on the wire (fp4 codes), fewer "
                  "ranks per pool, or attention local to each rank's "
                  "shard (flash decoding's partial softmax)",
}


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D train (fwd+bwd), 2*N*D inference, N = active."""
    n = cfg.n_active_params
    if kind == "train":
        tokens = shape["batch"] * shape["seq"]
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape["batch"] * shape["seq"]
        return 2.0 * n * tokens
    return 2.0 * n * shape["batch"]     # decode: one token per sequence


def roofline_terms(flops, hbm_bytes, peak: float,
                   wire_bytes: float = 0.0) -> dict:
    """The compute, memory and collective terms (s) of per-card totals at
    `peak` op/s, the card's HBM rate and its NVLink rate, the dominant
    one and the bound."""
    compute_s = flops / peak
    memory_s = hbm_bytes / HBM_BYTES_PER_S
    collective_s = wire_bound_s(wire_bytes)
    dominant = max((compute_s, "compute"), (memory_s, "memory"),
                   (collective_s, "collective"))[1]
    return dict(compute_s=compute_s, memory_s=memory_s,
                collective_s=collective_s, dominant=dominant,
                bound_s=max(compute_s, memory_s, collective_s))


def cell_roofline(cfg, kind: str, seq: int, batch: int,
                  n_cards: int = 1) -> dict:
    """One cell's terms under cfg's policy: compute at bf16 and at the
    DPA peak (`PEAK_OPS[fmt_acts]`, or f32 with DPA off), memory, the
    dominant term and the bound at the DPA peak (and at bf16), and
    MODEL_FLOPS / analytic FLOPs."""
    flops = A.cell_flops_per_device(cfg, seq, batch, kind, n_cards)
    hbm = A.cell_hbm_bytes_per_device(cfg, seq, batch, kind, n_cards)
    wire = A.cell_wire_bytes_per_device(cfg, seq, batch, kind, n_cards)
    pol = get_policy(cfg.policy)
    fmt = pol.fmt_acts if pol.enabled else "fp32"
    base = roofline_terms(flops, hbm, PEAK_OPS["bf16"], wire)
    dpa = roofline_terms(flops, hbm, PEAK_OPS[fmt], wire)
    model_fl = model_flops(cfg, {"seq": seq, "batch": batch}, kind) / n_cards
    return dict(
        arch=cfg.name, kind=kind, seq=seq, batch=batch, n_cards=n_cards,
        flops=flops, hbm_bytes=hbm, wire_bytes=wire, dpa_fmt=fmt,
        compute_s=base["compute_s"], compute_dpa_s=dpa["compute_s"],
        memory_s=base["memory_s"], collective_s=dpa["collective_s"],
        dominant=dpa["dominant"],
        bound_s=dpa["bound_s"], bound_bf16_s=base["bound_s"],
        model_analytic_ratio=model_fl / flops,
        roofline_frac=(model_fl / PEAK_OPS[fmt]) / dpa["bound_s"],
        suggest=SUGGEST[dpa["dominant"]])


def route_table(work_delta: dict, device_ms: dict) -> list:
    """Per route over one window: launches, summed bound (ms), device ms,
    device ms / bound and the loss (device - bound), largest loss first.
    `work_delta`: a `counters.diff` of two snapshots; `device_ms`: {route
    key ("wrapper" or "wrapper.route"), or keys joined by " + " where
    one profiled kernel serves several: the profile's device ms, or
    None}.  Routes with no launch are left out."""
    rows = []
    for label, ms in device_ms.items():
        keys = label.split(" + ")
        n = sum(work_delta.get(k, 0) for k in keys)
        if not n:
            continue
        b_ms = sum(work_delta.get(f"{k}:bound_s", 0) for k in keys) * 1e3
        nbytes = sum(work_delta.get(f"{k}:bytes", 0) for k in keys)
        ops = sum(work_delta.get(f"{k}:ops", 0) for k in keys)
        rows.append(dict(
            route=label, launches=n, bytes=nbytes, ops=ops, bound_ms=b_ms,
            device_ms=ms, ratio=None if ms is None or not b_ms
            else ms / b_ms, loss_ms=None if ms is None else ms - b_ms))
    return sorted(rows, key=lambda r: -(r["loss_ms"] or 0.0))


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | dominant | compute(bf16) s | compute(DPA) s | "
           "memory s | DPA peak | MODEL/analytic | roofline frac | "
           "collective s |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | **{r['dominant']}** | "
            f"{r['compute_s']:.3e} | {r['compute_dpa_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['dpa_fmt']} | "
            f"{r['model_analytic_ratio']:.2f} | {r['roofline_frac']:.3f} | "
            f"{r['collective_s']:.3e} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--cards", type=int, default=1)
    args = ap.parse_args(argv)
    rows = []
    for arch in [args.arch] if args.arch else list_archs():
        for shape in [args.shape] if args.shape else list(SHAPES):
            if not cell_applicable(arch, shape):
                continue
            sh = SHAPES[shape]
            rows.append(dict(cell_roofline(get_config(arch), sh["kind"],
                                           sh["seq"], sh["batch"],
                                           args.cards), shape=shape))
    if not rows:
        ap.error(f"{args.arch} x {args.shape} is not a cell of the grid")
    rows.sort(key=lambda r: (r["shape"], r["arch"]))
    print(f"H100 SXM5 peaks (kernels.census), {args.cards} card(s); "
          "collective term: the TP decode step's wire at the NVLink rate")
    print(markdown_table(rows))
    print()
    for r in rows:
        print(f"- {r['arch']} x {r['shape']}: {r['dominant']}-bound -> "
              f"{r['suggest']}")
    worst = min(rows, key=lambda r: r["roofline_frac"])
    print(f"\nworst roofline fraction: {worst['arch']} x {worst['shape']} "
          f"({worst['roofline_frac']:.3f})")
    return rows


if __name__ == "__main__":
    main()
