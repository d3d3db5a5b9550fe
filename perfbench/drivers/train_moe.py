"""Driver ``train_moe``: full-depth training steps of a DeepSeek-V3-style
decoder (latent attention, a sigmoid router with a correction bias,
dropless dispatch over the experts this card holds, shared experts, a
leading dense layer).

As ``drivers/train.py`` does for a dense decoder: the benchmark makes the
leaves in float32 from the seed (``reference/mla_moe_lm.py``'s
``make_params``: the router's bias among them) and hands them to the
program's step, ``repro_torch.runtime.train_lib.make_train_step`` (remat
per layer, AdamW with float32 masters and moments over every leaf but the
bias, bf16 compute, the bias update after AdamW), which updates them in
place.  Set-up builds the step and its state and drives it through the
traffic's ``check_steps`` first steps on batches of token ids drawn from
the seed; the window goes on stepping the same state.  A traced run then
traces :data:`TRACE_STEPS` more steps with the program's spans on
(``perfbench.spans.Spans``): device time by kernel, the device time
launched under the layer spans (:data:`LAYER_SPANS`), and the MoE
counters over those steps (:data:`COUNTERS`).

What the reference checks: as ``drivers/train.py``, the first steps'
losses, each trained leaf's first clipped gradient and each leaf's change,
and the same of one late step from a copy of the program's state after
the window; and one more number, ``router_bias``: the gap between the
program's biases after the steps and the reference's, over the
reference's move of them (all layers' together), so that a step that
skips or mistakes the bias update fails.  The late step's copy of the
state (33 GB at the cell's size) is kept in host memory.  After the
window, with the program's state freed, the reference runs the same steps
from the same leaves and batches, and the late step from the copy.
"""
from __future__ import annotations

import math
import time

import torch

from perfbench import faults, harness, roofline_moe
from perfbench.drivers.train import gaps, get, make_batches, program_tree
from perfbench.reference import mla_moe_lm as ref
from perfbench.tracing import Trace

#: steps a traced run traces after its window
TRACE_STEPS = 3
FAULTS = faults.TRAIN_FAULTS
fault = faults.train_fault
#: the program's spans the layer metrics read: a launch counts under the
#: innermost of these that encloses it
LAYER_SPANS = ("attn.", "moe.")
#: the program's counters the traced steps read
COUNTERS = ("moe.rows_routed", "moe.rows_padded", "moe.load_reads")


def host(t):
    """A copy of ``t`` in host memory (a copy on the CPU too)."""
    return t.detach().to("cpu", copy=True)


def model_config(config: dict):
    """The program's configuration of the file's sizes."""
    from repro_torch.configs.base import DeepSeekV3Config
    a = ref.arch_of(config)
    return DeepSeekV3Config(
        name=config["name"], family="moe", n_layers=a["layers"],
        d_model=a["d"], n_heads=a["h"], n_kv_heads=a["h"], d_ff=a["f"],
        vocab_size=a["vocab"], head_dim=a["dv"], rope_theta=a["theta"],
        norm_eps=a["eps"], tie_embeddings=config["tie_word_embeddings"],
        attn_type="mla", kv_lora_rank=a["r"], qk_nope_head_dim=a["nope"],
        qk_rope_head_dim=a["rope"], v_head_dim=a["dv"],
        n_experts=a["e"], experts_per_token=a["k"], moe_d_ff=a["fe"],
        router="sigmoid", n_shared_experts=a["shared"],
        routed_scale=a["scale"], router_aux_coef=a["alpha"],
        bias_rate=a["gamma"], bias_init_std=a["bias_std"],
        experts_held=tuple(a["held"]), first_k_dense=a["dense"])


def program_paths(a: dict) -> dict:
    """Each reference leaf's path in the program's tree."""
    out = {"embed": ("embed", "table"), "unembed": ("embed", "unembed"),
           "final_norm": ("final_norm", "scale")}
    for i in range(a["layers"]):
        dense = i < a["dense"]
        blk = (("lead", f"l{i}_attn") if dense
               else ("stack", i - a["dense"], "b0_moe"))
        pre = f"layers.{i}."
        out[pre + "norm1"] = blk + ("norm1", "scale")
        out[pre + "norm2"] = blk + ("norm2", "scale")
        for k in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo"):
            out[pre + k] = blk + ("attn", k)
        for k in ("w_gate", "w_up", "w_down"):
            if dense:
                out[pre + k] = blk + ("mlp", k)
            else:
                out[pre + "experts." + k] = blk + ("moe", k)
                out[pre + "shared." + k] = blk + ("moe", "shared", k)
        if not dense:
            out[pre + "router"] = blk + ("moe", "router")
            out[pre + ref.BIAS] = blk + ("moe", ref.BIAS)
    return out


class Program:
    """The program's step and state, from the benchmark's leaves.
    ``paths`` names the trained leaves, ``bias_paths`` the biases."""

    def __init__(self, ctx):
        from repro_torch.configs.base import ParallelConfig, TrainConfig
        from repro_torch.models.model import LM
        from repro_torch.optim import init_opt_state
        from repro_torch.runtime import train_lib

        cfg, traffic = ctx.cell.config, ctx.cell.traffic
        self.a = ref.arch_of(cfg)
        # first, before any device work: a program without this design
        # stops here
        self.lm = LM(model_config(cfg), device=ctx.device)
        opt = traffic["optimizer"]
        self.tcfg = TrainConfig(
            lr=opt["lr"], warmup_steps=opt["warmup_steps"],
            total_steps=opt["total_steps"],
            weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"],
            b1=opt["b1"], b2=opt["b2"])
        self.flat, self.views = ref.make_params(self.a, ctx.seed, ctx.device)
        paths = program_paths(self.a)
        self.params = program_tree(self.lm, self.views, paths)
        self.paths = {n: p for n, p in paths.items() if not ref.is_bias(n)}
        self.bias_paths = {n: p for n, p in paths.items() if ref.is_bias(n)}
        self.opt = init_opt_state(
            train_lib.trained(self.params),
            train_lib.make_adamw_config(self.lm.cfg, self.tcfg))
        self.step_fn = train_lib.make_train_step(
            self.lm, self.tcfg, ParallelConfig(remat=traffic["remat"]))

    def step(self, batch):
        tokens, labels = batch
        self.params, self.opt, metrics = self.step_fn(
            self.params, self.opt, {"tokens": tokens, "labels": labels})
        return metrics

    def leaf_norms(self, tree, scale: float = 1.0) -> dict:
        names = list(self.paths)
        norms = torch.stack([get(tree, self.paths[n]).float().norm()
                             for n in names]).tolist()
        return {n: v * scale for n, v in zip(names, norms)}

    def biases(self) -> dict:
        """Every layer's bias, on the host."""
        return {n: host(get(self.params, p).float())
                for n, p in self.bias_paths.items()}


def check_steps(prog: Program, batches: list, b1: float) -> dict:
    """The program's first steps and what the reference checks of them
    (the start kept on the host)."""
    p0 = {n: host(get(prog.params, p)) for n, p in prog.paths.items()}
    losses, grad_norm = [], None
    for i, batch in enumerate(batches):
        losses.append(prog.step(batch)["loss"])
        if i == 0:
            grad_norm = prog.leaf_norms(prog.opt["m"], 1.0 / (1.0 - b1))
    change = {n: float((get(prog.params, p).detach()
                        - p0[n].to(get(prog.params, p).device)).norm())
              for n, p in prog.paths.items()}
    return {"loss": [float(x) for x in losses], "grad_norm": grad_norm,
            "change_norm": change, "bias": prog.biases()}


def state_copy(prog: Program) -> dict:
    """A copy of the program's state on the host, by the reference's
    names: float32 leaves (the biases among them), moments of the trained
    ones, and the steps it has made."""
    def leaf(tree, path):
        return host(get(tree, path).float())
    paths = {**prog.paths, **prog.bias_paths}
    return {"p": {n: leaf(prog.params, p) for n, p in paths.items()},
            "m": {n: leaf(prog.opt["m"], p) for n, p in prog.paths.items()},
            "v": {n: leaf(prog.opt["v"], p) for n, p in prog.paths.items()},
            "step": int(prog.opt["step"])}


def late_step(prog: Program, batch, b1: float) -> tuple[dict, dict]:
    """One more step of the program from the state the window left, and
    what the reference checks of it (as ``drivers/train.py``'s
    ``late_step``, with the biases).  Returns the readings and the state
    copied to the host before the step."""
    before = state_copy(prog)
    loss = prog.step(batch)["loss"]
    grad, change = {}, {}
    with torch.no_grad():
        for n, path in prog.paths.items():
            m = get(prog.opt["m"], path).float()
            grad[n] = float(((m - b1 * before["m"][n].to(m.device))
                             / (1.0 - b1)).norm())
            p = get(prog.params, path).float()
            change[n] = float((p - before["p"][n].to(p.device)).norm())
    return {"loss": [float(loss)], "grad_norm": grad, "change_norm": change,
            "bias": prog.biases()}, before


def bias_gap(got: dict, want: dict, start: dict) -> float:
    """The norm of the program's biases less the reference's, over the
    norm of the reference's move of them from ``start`` (every layer
    together); ``inf`` for a NaN, or where the reference moves nothing
    and the program differs."""
    num = math.sqrt(sum(float((got[n] - want[n]).square().sum())
                        for n in want))
    den = math.sqrt(sum(float((want[n] - start[n]).square().sum())
                        for n in want))
    if math.isnan(num) or math.isnan(den):
        return math.inf
    if den == 0:
        return 0.0 if num == 0 else math.inf
    return num / den


def checks_of(got: dict, want: dict, start: dict, share: float) -> dict:
    return {**gaps(got, want, share),
            "router_bias": bias_gap(got["bias"], want["bias"], start)}


def start_biases(a: dict, seed: int, device) -> dict:
    """The biases the seed makes on ``device``, on the host."""
    _, views = ref.make_params(a, seed, device)
    return {n: host(t) for n, t in views.items() if ref.is_bias(n)}


def control_checks(ctx) -> dict:
    """The comparison's numbers with the control (the reference with its
    products in float8) in the program's place, on the run's leaves and
    batches: its first steps from the seed's leaves, and one late step
    from the state that the float32 reference reaches after as many steps
    as the traffic has batches; each number the worse of the two."""
    a = ref.arch_of(ctx.cell.config)
    traffic = ctx.cell.traffic
    n = traffic["check_steps"] + traffic["window_batches"]
    batches = make_batches(a, traffic, ctx.seed, ctx.device, n)
    share = traffic["min_grad_share"]
    check = batches[:traffic["check_steps"]]
    start = start_biases(a, ctx.seed, ctx.device)
    first = checks_of(
        ref.train_steps(a, ctx.seed, check, traffic, ctx.device, fp8=True),
        ref.train_steps(a, ctx.seed, check, traffic, ctx.device), start,
        share)
    state = ref.initial_state(a, ctx.seed, ctx.device)
    ref.train_steps(a, ctx.seed, batches[:-1], traffic, ctx.device,
                    state=state)
    late = batches[-1:]
    # the state before the late step, kept on the host: the card holds one
    # copy of it beside a step (33 GB at the cell's size)
    saved = {k: ({name: host(t) for name, t in v.items()}
                 if isinstance(v, dict) else v) for k, v in state.items()}
    want = ref.train_steps(a, ctx.seed, late, traffic, ctx.device,
                           state=state)
    with torch.no_grad():
        for k, v in saved.items():
            if isinstance(v, dict):
                for name, t in v.items():
                    state[k][name].copy_(t)
    state["step"] = saved["step"]
    got = ref.train_steps(a, ctx.seed, late, traffic, ctx.device, fp8=True,
                          state=state)
    before = {n: t for n, t in saved["p"].items() if ref.is_bias(n)}
    last = checks_of(got, want, before, share)
    return {k: harness.worst([first[k], last[k]]) for k in first}


def _launches() -> int:
    from repro_torch.kernels import gemm as K
    from repro_torch.kernels import grouped_gemm as G
    return sum(K.LAUNCHES.values()) + sum(G.LAUNCHES.values())


def _traced(prog: Program, pool: list, done: int, cuda: bool):
    """:data:`TRACE_STEPS` steps under the profiler with the program's
    spans on: (the benchmark's reduction without the spans' ranges, the
    device seconds launched under each layer span, the counters)."""
    from repro_torch import obs

    from perfbench import spans
    with spans.Spans() as sp, Trace() as tr:
        for i in range(TRACE_STEPS):
            with torch.profiler.record_function("perfbench.step"):
                prog.step(pool[(done + i) % len(pool)])
        if cuda:
            torch.cuda.synchronize()
        counters = {c: obs.metrics.get(c) for c in COUNTERS}
    red = spans.traced_record(tr, sp, "train")
    layer = {name: row["device_s"] for name, row in
             spans.by_span(tr.events, LAYER_SPANS, sp.names).items()}
    return red, layer, counters


def run(ctx) -> dict:
    traffic = ctx.cell.traffic
    b1 = traffic["optimizer"]["b1"]
    from repro_torch.runtime import train_lib  # noqa: F401  (set-up)
    ctx.mark("imports")
    prog = Program(ctx)
    ctx.mark("program")
    n_check = traffic["check_steps"]
    batches = make_batches(prog.a, traffic, ctx.seed, ctx.device,
                           n_check + traffic["window_batches"])
    start = prog.biases()
    got = check_steps(prog, batches[:n_check], b1)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    harness.end_setup()
    ctx.mark("checked_steps")
    setup_s = time.perf_counter() - ctx.t_start
    pool = batches[n_check:]
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    steps = 0
    launches0 = _launches()
    t0 = time.perf_counter()
    while True:
        with torch.profiler.record_function("perfbench.step"):
            prog.step(pool[steps % len(pool)])
        steps += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches() - launches0
    tokens = traffic["batch"] * traffic["seq_len"]
    device = harness.device_info(ctx.device)
    e2e = {"train_tokens_per_s": steps * tokens / wall, "setup_s": setup_s}
    rec = {"kind": "train", "steps": steps, "wall_s": wall,
           "tokens_per_step": tokens, "launches_per_step": launches / steps,
           "grouped_products": roofline_moe.grouped_products(
               ctx.cell.config, tokens),
           "model_flops_per_step": roofline_moe.train_model_flops(
               ctx.cell.config, traffic["batch"], traffic["seq_len"])}
    done = steps
    if ctx.trace:
        red, layer, counters = _traced(prog, pool, done, cuda)
        done += TRACE_STEPS
        device["busy_s"], device["window_s"] = red["busy_s"], red["window_s"]
        rec.update(trace=red, traced_steps=TRACE_STEPS, layer_spans=layer,
                   counters=counters,
                   breakdown={"device_ops": red["device_ops"],
                              "idle_gaps": red["idle_gaps"]})
    late_batch = pool[done % len(pool)]
    late, state = late_step(prog, late_batch, b1)
    del prog, pool
    if cuda:
        torch.cuda.empty_cache()
    a = ref.arch_of(ctx.cell.config)
    bias_before = {n: t for n, t in state["p"].items() if ref.is_bias(n)}
    state = {k: ({n: t.to(ctx.device) for n, t in v.items()}
                 if isinstance(v, dict) else v) for k, v in state.items()}
    want_late = ref.train_steps(a, ctx.seed, [late_batch], traffic,
                                ctx.device, state=state)
    del state
    if cuda:
        torch.cuda.empty_cache()
    want = ref.train_steps(a, ctx.seed, batches[:n_check], traffic,
                           ctx.device)
    share = traffic["min_grad_share"]
    first = checks_of(got, want, start, share)
    last = checks_of(late, want_late, bias_before, share)
    checks = {k: harness.worst([first[k], last[k]]) for k in first}
    failed = int(harness.over_limits(checks, ctx.cell.limits))
    return {"e2e": e2e, "rec": rec, "checks": checks, "attempted": steps,
            "failed": failed, "device": device}
