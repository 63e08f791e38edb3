"""A cell's comparison with every control of it, over many seeds, in one
process: the readings a cell's limits are set from.

    python3 benchmark/controls.py --workload <cell> --seeds 101 102 ... --seconds <s>
        [--options conv_reset=1 expert_bias=0 bf16_activations=1] [--routing]
        [--faults drop_product unnormalised]

Each seed is a whole run of the cell as ``run.py`` makes it, with the
controls of ``calibrate.py --controls`` (the tokens a reference one step
lower in precision puts first, the PCM of a Mimi with fp8 weights), and
then, for each ``--options`` entry, the tokens that the family's reference
built with that option puts first (``reference(params, config,
**option)``; ``lfm2_moe``'s are ``conv_reset``, ``expert_bias`` and the
precision witness ``bf16_activations``), judged against the reference
itself: its gap is put in the program's place before the verdict, as the
other controls' are.  ``--faults`` runs the cell again at the same seed
with the program broken before it is built, each fault once, and reads
its verdict: ``drop_product`` has the expert kernel leave out each row's
last routed product (its routing weight zeroed on the way in),
``unnormalised`` has the router skip ``norm_topk_prob``.  ``--routing``
also reads, for the longest greedy request, the share of (row, routed
layer) pairs whose chosen experts differ between the program (its prefill
through the bf16 shadow, then one S = 1 step a frame through the int8
experts, on the card) and the reference, by layer, and the same share
between the reference and its ``bf16_activations`` witness.  One JSON line
a seed.  Not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import check, specs, weights  # noqa: E402
from benchmark.reference import logits as ref_logits  # noqa: E402


def _greedy(finished: list, K: int) -> list:
    return [r for r in finished if r.greedy and r.frames(K).shape[0] > 0]


def option_gaps(cell, seed: int, device, voices, finished: list, options: dict) -> dict:
    """{option name: the widest gap, in the reference's logits, of the
    tokens the reference built with that option puts first} over the
    greedy requests of ``finished``."""
    config, family = cell.config, cell.family
    K = config["audio_num_codebooks"]
    reqs = _greedy(finished, K)
    out = {}
    with torch.no_grad():
        params = family.draw(config, seed, device)
        model = family.reference(params, config)
        base = []
        for r in reqs:
            frames = torch.from_numpy(r.frames(K)).to(device)
            base.append(model.frame_logits(check._prompt(config, voices, r, device), frames))
        del model
        for name, kwargs in options.items():
            ctrl = family.reference(params, config, **kwargs)
            gaps = []
            for r, logits in zip(reqs, base):
                frames = torch.from_numpy(r.frames(K)).to(device)
                other = ctrl.frame_logits(check._prompt(config, voices, r, device), frames)
                gaps.append(ref_logits.argmax_gaps(logits, other))
            out[name] = ref_logits.widest(gaps)
            del ctrl
    return out


def routing_differs(cell, seed: int, device, voices, request) -> dict:
    """The share of (row, routed layer) pairs of ``request`` (its prompt
    rows and the frames fed back) whose set of chosen experts differs
    between the program and the reference (module docstring)."""
    from sesameai_tts_tpu_torch.models import csm as csm_model
    from sesameai_tts_tpu_torch.models.transformer import precompute_rope
    from sesameai_tts_tpu_torch.ops import moe
    from sesameai_tts_tpu_torch.ops.quant import dequantize_csm

    from benchmark.reference import lfm2_moe as ref_lfm2

    config, family = cell.config, cell.family
    K = config["audio_num_codebooks"]
    seen = {"program": [], "reference": [], "witness": []}

    def recording(fn, key):
        def wrapped(*a, **k):
            ids, w = fn(*a, **k)
            seen[key].append(ids.sort(dim=-1).values.cpu())
            return ids, w
        return wrapped

    frames = torch.from_numpy(request.frames(K)).to(device)
    tokens, mask = check._prompt(config, voices, request, device)
    P = tokens.shape[0]
    routed = config["num_hidden_layers"] - config["num_dense_layers"]
    program_route, reference_route = moe.route, ref_lfm2.route
    moe.route = recording(program_route, "program")
    ref_lfm2.route = recording(reference_route, "reference")
    try:
        with torch.no_grad():
            params = family.draw(config, seed, device)
            model = family.reference(params, config)
            model.frame_logits((tokens, mask), frames)
            del model
            # the reference against its witness, its activations held in bf16
            ref_lfm2.route = recording(reference_route, "witness")
            family.reference(params, config, bf16_activations=True).frame_logits(
                (tokens, mask), frames)
            mcfg, _ = family.port(config, f"{cell.config_name}/routing")
            qp = family.quantize(params, 8)
            del params
            dtype = weights.dtype_of(config["dtype"])
            shadow = dequantize_csm(qp, torch.bfloat16)  # as the Generator's prefill shadow
            shadow["backbone"]["layers"] = tuple({k: w.to(dtype) for k, w in wl.items()}
                                                 for wl in shadow["backbone"]["layers"])
            rope = precompute_rope(mcfg.backbone, device=device)
            state = csm_model.init_state(mcfg, 1, dtype, device=device)
            _, state = csm_model.backbone_last_hidden(shadow, mcfg, state, tokens[None],
                                                      mask[None], rope_cs=rope)
            del shadow
            fmask = torch.ones((1, 1, K + 1), dtype=torch.bool, device=device)
            fmask[..., K] = False
            for f in frames[:-1]:
                row = torch.zeros((1, 1, K + 1), dtype=torch.int64, device=device)
                row[0, 0, :K] = f
                _, state = csm_model.backbone_last_hidden(qp, mcfg, state, row, fmask,
                                                          rope_cs=rope)
    finally:
        moe.route, ref_lfm2.route = program_route, reference_route
    rows = P + frames.shape[0] - 1
    want = torch.stack([x.reshape(rows, -1) for x in seen["reference"]])  # (layers, rows, k)
    # the program: each routed layer's prefill rows, then one row a step
    steps = [torch.cat([x.reshape(1, -1) for x in seen["program"][routed + i::routed]])
             for i in range(routed)]
    got = torch.stack([torch.cat([x.reshape(P, -1), s])
                       for x, s in zip(seen["program"][:routed], steps)])
    witness = torch.stack([x.reshape(rows, -1) for x in seen["witness"]])
    differs = (got != want).any(dim=-1)  # (routed layers, rows)
    itself = (witness != want).any(dim=-1)
    return {"routing_pairs": int(differs.numel()), "routing_differs": float(differs.float().mean()),
            "routing_differs_decode": float(differs[:, P:].float().mean()),
            "routing_differs_by_layer": [round(float(x), 4) for x in differs.float().mean(1)],
            "routing_differs_witness": float(itself.float().mean()),
            "routing_differs_witness_by_layer": [round(float(x), 4)
                                                 for x in itself.float().mean(1)]}


def drop_product():
    """The expert kernel fed each row's last routed weight as 0 (the
    kernel leaving out one of its k products) → the undo."""
    from sesameai_tts_tpu_torch.ops import moe

    kernel = moe.expert_swiglu

    def dropped(x, ids, weights, *rest, **kw):
        weights = weights.clone()
        weights[:, -1] = 0.0
        return kernel(x, ids, weights, *rest, **kw)

    dropped.launches = 0
    moe.expert_swiglu = dropped
    return lambda: setattr(moe, "expert_swiglu", kernel)


def unnormalised():
    """The router with ``norm_topk_prob`` left out → the undo."""
    from sesameai_tts_tpu_torch.ops import moe

    route = moe.route

    def raw(x, gate, bias, k, norm_topk_prob=True, scaling=1.0):
        return route(x, gate, bias, k, False, scaling)

    moe.route = raw
    return lambda: setattr(moe, "route", route)


FAULTS = {"drop_product": drop_product, "unnormalised": unnormalised}


def fault_run(cell, seed: int, seconds: float, fault: str, device="cuda") -> dict:
    """The cell's run at ``seed`` with the program broken by ``fault``
    before it is built → its verdict and readings."""
    gc.collect()  # the last run's pool, before another is built
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    undo = FAULTS[fault]()
    try:
        out = bench_run.run_cell(cell, seed, seconds, False, device=device,
                                 t_start=time.perf_counter())
    finally:
        undo()
    return {"correct": out["ok"], "logit_gap": out["readings"].get("logit_gap"),
            "topk_gap": out["readings"].get("topk_gap"),
            "compared_tokens": out["readings"].get("compared_tokens")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--options", nargs="*", default=[],
                   help="name=0|1 for the family's reference, one control each")
    p.add_argument("--routing", action="store_true")
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    args = p.parse_args(argv)
    options = {}
    for o in args.options:
        key, value = o.split("=")
        options[o] = {key: bool(int(value))}
    cell = specs.load_cell(args.workload)
    name, power = bench_run._card(cell.chips)
    limits, least = cell.settings["correct"], int(cell.settings["correct"]["min_tokens"])
    for seed in args.seeds:
        out = bench_run.run_cell(cell, seed, args.seconds, False, control=True,
                                 t_start=time.perf_counter())
        run = out["run"]
        run.device_name = name
        finished = [r for r in run.requests if r.ended is not None and r.error is None
                    and not r.cancelled]
        t0 = time.perf_counter()
        gaps = option_gaps(cell, seed, "cuda", run.voices, finished, options) if options else {}
        controls = dict(out["controls"])
        for key, gap in gaps.items():
            controls[key] = check.verdict(dict(out["readings"], logit_gap=gap), limits,
                                          least)[0]
        line = {"seed": seed, "correct": out["ok"], "controls_correct": controls,
                "option_gaps": gaps, "attempted": out["attempted"], "failed": out["failed"],
                "readings": out["readings"],
                "metrics": {k: v["value"] for k, v in bench_run.metrics_of(run, False).items()},
                "peak": run.peak, "card": name, "power_limit_w": power}
        if args.routing:
            reqs = _greedy(finished, cell.config["audio_num_codebooks"])
            if reqs:
                longest = max(reqs, key=lambda r: r.frames(cell.config["audio_num_codebooks"])
                              .shape[0])
                line.update(routing_differs(cell, seed, "cuda", run.voices, longest))
        line["controls_s"] = time.perf_counter() - t0
        del run, out, finished
        line["faults"] = {f: fault_run(cell, seed, args.seconds, f) for f in args.faults}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
