"""Co-serving driver of the PyTorch port: run the Echo engine on a
reduced-family model.

This driver serves a reduced variant with a real bursty online trace +
offline batch corpus, and prints the paper's metrics. The model runs on
the card unless ``--device cpu`` asks for the CPU (the kernels' plain
PyTorch versions):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --policy Echo --duration 30
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --arch qwen3-4b --duration 1 --n-docs 1 --questions 2

The flags are the JAX package's (``python -m repro.launch.serve``) but
for two. ``--attn-impl`` takes ``auto`` (split-K decode and chunked
prefill), ``splitk`` (the same kernels: the JAX package's accelerator
``auto`` is split-K) and ``pallas`` (the legacy decode kernel); ``ref`` is
refused, because no value sends a CUDA tensor to a plain version: pass
``--device cpu`` for those. ``--kernel-profile`` is gone: the port has no
tuning presets, the kernels' launch parameters follow the card.

With ``--replicas N`` (N > 1) the driver instead dry-runs a cluster of N
virtual-clock replicas behind the prefix-affinity router on a multi-tenant
workload — no model execution, the §5.4 simulator methodology fleet-wide:

  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 4 --router affinity

Ground truth vs. estimate (§5 calibration loop): ``--hw-profile`` selects
the true hardware clock (comma-separated to cycle profiles over a
heterogeneous fleet), ``--hw-drift``/``--hw-jitter`` perturb it away from
the scheduler's stock A100 estimate, and ``--calibrate`` turns on the
online refitting that closes the gap:

  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
      --hw-profile a100,h100 --hw-drift 2.0 --calibrate

Both paths drive the workload through the one ``EchoService`` facade
(``repro_torch.serving``); ``--max-online-queue`` / ``--slo-shed-factor`` /
``--offline-cap`` turn on its admission backpressure.

KV tiering: ``--host-kv-gb`` attaches a host-memory swap tier (per replica
on the cluster path) sized in GB, ``--pcie-gbps`` sets the transfer-term
bandwidth, ``--no-swap`` forces the recompute-only baseline, and
``--no-swap-overlap`` charges transfers serially instead of overlapping
them with compute on the async copy stream:

  PYTHONPATH=src python -m repro_torch.launch.serve --host-kv-gb 4 --pcie-gbps 25

Real-time serving: ``--serve`` listens on a TCP socket instead of replaying
a canned trace — the ``repro_torch.rt`` asyncio front door (continuous-batching
loop, wall-clock admission, streaming handles, graceful drain on Ctrl-C).
At startup the PCIe swap terms are refit from timed host↔device copies on
the ``--device`` (skip with ``--no-link-calibration``; on ``--device cpu``
the presets stay); ``--virtual`` serves the model-free virtual-clock
engine for protocol demos:

  PYTHONPATH=src python -m repro_torch.launch.serve --serve --port 8631
  PYTHONPATH=src python -m repro_torch.launch.serve --serve --virtual \
      --max-online-queue 64
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import ALL_POLICIES, SLO, EchoEngine, TimeModel
from repro_torch.core.block_io import BlockIOSpec, io_spec_for_model, paged_spec
from repro_torch.data import BurstyTrace, make_offline_corpus, make_online_requests
from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.serving import AdmissionConfig, EchoService

POLICY_BY_NAME = {p.name: p for p in ALL_POLICIES}

# --attn-impl as the JAX package names it -> the port's schedule; "ref"
# has none (see the module docstring)
ATTN_IMPLS = {"auto": "auto", "splitk": "auto", "pallas": "pallas"}

DEFAULT_ARCH = "qwen3-4b"


def host_kv_blocks(args, io: BlockIOSpec = None,
                   block_size: int = 16) -> int:
    """--host-kv-gb translated to host-tier slots through the served
    family's block I/O spec (0 with --no-swap): one slot parks one block's
    payload — a page of KV for attention models, one fixed-size state
    snapshot for SSM/hybrid ones — so the same GB budget buys far more
    slots on a state-family model."""
    if args.no_swap or args.host_kv_gb <= 0:
        return 0
    per_block = max((io or paged_spec()).block_bytes(block_size), 1)
    return max(int(args.host_kv_gb * 1e9 / per_block), 1)


def admission_config(args):
    """AdmissionConfig from the backpressure flags; None = legacy unbounded."""
    cfg = AdmissionConfig(max_online_queue=args.max_online_queue,
                          slo_shed_factor=args.slo_shed_factor,
                          offline_pool_cap=args.offline_cap)
    return cfg if cfg.active else None


def attach_host(tracer, backend) -> None:
    """--trace-out also records each engine thread's own spans on the wall
    clock (the tracer's host track): one per replica."""
    if tracer is None:
        return
    for i, eng in enumerate(backend.engines()):
        tracer.attach_host(eng, replica=i)


def setup_obs(args, service: EchoService):
    """Attach the observability layer when --trace-out/--metrics-out ask
    for it. Returns (tracer, registry), both None when disabled."""
    if not (args.trace_out or args.metrics_out):
        return None, None
    from repro_torch.obs import MetricsRegistry, Tracer
    tracer = Tracer(cap=args.trace_cap) if args.trace_out else None
    registry = MetricsRegistry()
    service.instrument(registry, tracer)
    attach_host(tracer, service.backend)
    return tracer, registry


def write_obs(args, tracer, registry) -> None:
    if tracer is not None and args.trace_out:
        tracer.write(args.trace_out)
        print(f"trace: {args.trace_out} ({len(tracer._events)} events, "
              f"{tracer.dropped_events} dropped; "
              f"{len(tracer.preempted_rids())} preempted / "
              f"{len(tracer.swapped_rids())} swapped requests) — "
              "load at https://ui.perfetto.dev")
    if registry is not None and args.metrics_out:
        registry.write(args.metrics_out)
        print(f"metrics: {args.metrics_out}")


def print_report(service: EchoService, stats, online, offline) -> None:
    """One reporter for both the single-engine and the cluster path — the
    metric surface is identical; only the per-engine detail lines vary."""
    m = stats.merged() if hasattr(stats, "merged") else stats
    on_done = sum(1 for r in m.finished if r.is_online)
    off_done = len(m.finished) - on_done
    print(f"online finished: {on_done}/{len(online)}  "
          f"offline finished: {off_done}/{len(offline)}")
    print(f"offline throughput: {stats.offline_throughput():.1f} "
          f"tok/s (virtual)")
    print(f"SLO attainment: TTFT {stats.slo_attainment('ttft'):.3f}  "
          f"TPOT {stats.slo_attainment('tpot'):.3f}")
    pcts = service.live.percentiles()
    if pcts:
        print("latency percentiles (s):")
        for name in ("ttft", "tpot", "queue_delay"):
            if name in pcts:
                v = pcts[name]
                print(f"  {name:>11}: p50 {v['p50']:.4f}  "
                      f"p90 {v['p90']:.4f}  p99 {v['p99']:.4f}")
    if service.live.shed or service.live.aborted:
        print(f"admission: shed {service.live.shed}  "
              f"aborted {service.live.aborted}")
    router = getattr(stats, "router", None)
    if router is not None:
        print(f"router: affinity hits {router.affinity_hits}/"
              f"{router.offline_dispatched}  "
              f"stolen {router.stolen_requests}")
    if service.live.swap_ins or service.live.swap_outs:
        print(f"kv swap: in {service.live.swapped_in_tokens} tok "
              f"({service.live.swap_ins} events)  "
              f"out {service.live.swapped_out_tokens} tok "
              f"({service.live.swap_outs} events)")
    if service.live.swap_transfer_time > 0:
        print(f"swap overlap: transfer {service.live.swap_transfer_time:.3f}s"
              f"  exposed {service.live.swap_exposed_time:.3f}s"
              f"  hidden {service.live.swap_hidden_frac():.0%}")
    if router is not None and router.migrations:
        print(f"kv migration: {router.migrations} shipments  "
              f"{router.migrated_blocks} blocks  "
              f"{router.migrated_bytes / 1e6:.1f} MB over the fabric")
    kills = getattr(stats, "kills", None)
    if kills:
        lats = stats.recovery_latencies()
        worst = f"  worst recovery {max(lats):.2f}s" if lats else ""
        print(f"chaos: {len(kills)} kill(s)  re-dispatched "
              f"{stats.redispatched_online} online / "
              f"{stats.redispatched_offline} offline  "
              f"lost {stats.lost_tokens} KV tokens{worst}")
    if getattr(stats, "replica_seconds", 0):
        print(f"fleet cost: {stats.replica_seconds:.1f} replica-seconds")
    sim = getattr(service.backend, "sim", None)
    replicas = sim.replicas if sim is not None else None
    for i, eng in enumerate(service.backend.engines()):
        if replicas is not None:
            rep = replicas[i]
            tag = f"  replica {rep.id} [{rep.state.value:>8}]:"
            rid = rep.id
        else:
            tag, rid = "engine:", i
        line = (f"{tag} hit rate {eng.bm.metrics.hit_rate:.3f}  "
                f"offline hit {eng.bm.metrics.offline_hit_rate:.3f}  "
                f"evictions {eng.bm.metrics.evictions}  "
                f"punished tokens {eng.bm.metrics.punished_tokens}  "
                f"t={eng.now:.1f}s")
        if eng.bm.host is not None:
            line += (f"  host {len(eng.bm.host)}/{eng.bm.host.capacity} blk"
                     f"  swap in/out {eng.bm.metrics.swapped_in_tokens}"
                     f"/{eng.bm.metrics.swapped_out_tokens} tok")
        if eng.bm.metrics.migrated_in_bytes or eng.bm.metrics.migrated_out_bytes:
            line += (f"  migrated in/out "
                     f"{eng.bm.metrics.migrated_in_blocks}"
                     f"/{eng.bm.metrics.migrated_out_blocks} blk")
        if router is not None:
            line += (f"  dispatched {router.per_replica_online.get(rid, 0)}"
                     f"on/{router.per_replica_offline.get(rid, 0)}off")
        if replicas is not None:
            off_tok = sum(r.prompt_len + r.n_output
                          for r in eng.stats.finished if not r.is_online)
            line += f"  offline tok {off_tok}"
        if eng.calibrator is not None:
            line += (f"  calib: refits {eng.calibrator.refits} "
                     f"err {eng.calibrator.mean_rel_err(100):.3f}")
        print(line)


def resolve_policy(args):
    policy = POLICY_BY_NAME[args.policy]
    if args.calibrate:
        policy = dataclasses.replace(policy, calibrate=True,
                                     name=policy.name + "+C")
    return policy


def clock_models(args, *, quadratic_prefill: bool = True,
                 swap_byte: float = None):
    """Ground-truth clocks from --hw-profile/--hw-drift/--hw-jitter; None
    when they match the stock estimate (classic perfect-clock serving)."""
    names = [n.strip() for n in args.hw_profile.split(",") if n.strip()]
    perturbed = args.hw_drift != 1.0 or args.hw_jitter > 0.0
    if names == ["a100"] and not perturbed:
        return None
    out = []
    for i, name in enumerate(names):
        kw = dict(quadratic_prefill=quadratic_prefill,
                  swap_overlap=not args.no_swap_overlap)
        if swap_byte is not None:
            kw["swap_byte"] = swap_byte
        base = TimeModel.preset(name, **kw)
        if perturbed:
            out.append(base.perturbed(scale=args.hw_drift,
                                      jitter=args.hw_jitter,
                                      seed=args.seed + 100 + i))
        else:
            out.append(base)
    return out


def calibrate(model: Model, params, *, chunk_size=64, num_blocks=192,
              block_size=16, device="cuda") -> TimeModel:
    """Fit the Eq.6-8 coefficients by micro-benchmarking the runner (§6).
    Each clock read follows a ``synchronize``: the runner's calls return
    host logits, so the work is done by then, but the wait is stated."""
    import time

    from repro_torch.models.paged import TorchPagedRunner
    runner = TorchPagedRunner(model, params, num_blocks, block_size,
                              max_pages_per_seq=num_blocks // 2,
                              chunk_size=chunk_size, device=device)

    def now():
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        return time.perf_counter()
    tm = TimeModel(quadratic_prefill=model.cfg.family not in ("ssm", "hybrid"))
    # prefill samples
    samples = []
    for l in (16, 32, 48, 64):
        toks = list(range(l))
        bt = list(range((l + block_size - 1) // block_size + 1))
        runner.prefill_chunk(toks, 0, bt)                  # warm
        t0 = now()
        for _ in range(3):
            runner.prefill_chunk(toks, 0, bt)
        samples.append((l, (now() - t0) / 3))
    tm.fit_prefill(samples)
    # decode samples
    dsamples = []
    for b in (1, 4, 8):
        toks = [1] * b
        bts = [[i] for i in range(b)]
        pos = [0] * b
        runner.decode(toks, bts, pos)
        t0 = now()
        for _ in range(3):
            runner.decode(toks, bts, pos)
        t = (now() - t0) / 3
        dsamples.append((1, 1.0, t))
    tm.fit_decode(dsamples)
    return tm


def chaos_config(args):
    """ChaosConfig from --kill-at/--degrade-at specs; None when unused."""
    kills, degrades = [], []
    for spec in args.kill_at or []:
        t, rid = spec.split(":")
        kills.append((float(t), int(rid)))
    for spec in args.degrade_at or []:
        t, rid, factor, dur = spec.split(":")
        degrades.append((float(t), int(rid), float(factor), float(dur)))
    if not kills and not degrades:
        return None
    from repro_torch.cluster import ChaosConfig
    return ChaosConfig(kills=kills, degrades=degrades, seed=args.seed)


def autoscaler_for(args):
    """FleetController from --autoscale/--max-replicas; None when off.
    The capacity figure defaults to an even share of the configured
    fleet-wide arrival rate (override with --rate-per-replica)."""
    if not args.autoscale:
        return None
    from repro_torch.cluster import FleetController
    rate = args.rate_per_replica or args.online_rate / max(args.replicas, 1)
    return FleetController(min_replicas=args.replicas,
                           max_replicas=max(args.max_replicas, args.replicas),
                           rate_per_replica=rate)


def serve_cluster(args) -> None:
    """--replicas N dry-run: co-serve a multi-tenant workload across N
    virtual-clock replicas behind the router and print fleet metrics.
    --online-rate scales the fleet-wide arrival rate across tenants;
    --n-docs/--questions size each tenant's offline corpus. --kill-at/
    --degrade-at inject failures; --autoscale turns on elastic membership."""
    from repro_torch.cluster import ClusterSimulator
    from repro_torch.data import default_tenants, make_multi_tenant_workload

    policy = resolve_policy(args)
    swap_byte = TimeModel.pcie_swap_byte(args.pcie_gbps)
    tm = TimeModel.a100(swap_byte=swap_byte,
                        swap_overlap=not args.no_swap_overlap)
    base = default_tenants(args.tenants)
    scale = args.online_rate / sum(t.online_rate for t in base)
    tenants = tuple(dataclasses.replace(t, online_rate=t.online_rate * scale,
                                        n_docs=args.n_docs,
                                        questions_per_doc=args.questions)
                    for t in base)
    online, offline = make_multi_tenant_workload(
        tenants, args.duration, seed=args.seed)
    sim = ClusterSimulator(args.replicas, policy,
                           router_policy=args.router,
                           num_blocks=args.num_blocks,
                           time_model=tm,
                           clock_models=clock_models(args,
                                                     swap_byte=swap_byte),
                           host_kv_blocks=host_kv_blocks(args),
                           seed=args.seed, chaos=chaos_config(args),
                           autoscaler=autoscaler_for(args))
    service = EchoService(sim, admission=admission_config(args))
    tracer, registry = setup_obs(args, service)
    stats = service.drive(online + offline, until_time=args.duration * 4)

    print(f"policy={policy.name} router={args.router} "
          f"replicas={args.replicas}")
    print_report(service, stats, online, offline)
    write_obs(args, tracer, registry)


def serve_realtime(args) -> None:
    """--serve: put the ``repro_torch.rt`` TCP front door over the engine (or a
    model-free cluster with --replicas>1) and listen until SIGINT/SIGTERM,
    then drain gracefully and report."""
    import asyncio
    import signal

    from repro_torch.rt import AsyncEchoEngine, EchoServer
    from repro_torch.rt.calibrate import calibrate_link

    policy = resolve_policy(args)
    swap_byte = TimeModel.pcie_swap_byte(args.pcie_gbps)
    quad, io, model, params = True, None, None, None
    if args.replicas == 1 and not args.virtual:
        cfg = get_config(args.arch or DEFAULT_ARCH).reduced()
        model = Model(cfg)
        params = model.init(torch.Generator(device=resolve_device(args.device))
                            .manual_seed(args.seed))
        quad = cfg.family not in ("ssm", "hybrid")
        io = io_spec_for_model(model)
    tm = TimeModel.a100(quadratic_prefill=quad, swap_byte=swap_byte,
                        swap_overlap=not args.no_swap_overlap)
    # cold-start link calibration: measure the real host<->device path and
    # refit the swap terms BEFORE the first request is priced against them
    if not args.no_link_calibration:
        print(calibrate_link(tm, device=args.device).summary())
    if args.replicas > 1:
        from repro_torch.cluster import ClusterSimulator
        target = ClusterSimulator(args.replicas, policy,
                                  router_policy=args.router,
                                  num_blocks=args.num_blocks, time_model=tm,
                                  host_kv_blocks=host_kv_blocks(args),
                                  seed=args.seed)
    else:
        target = EchoEngine(model, params, policy,
                            num_blocks=args.num_blocks, block_size=16,
                            chunk_size=64, max_pages_per_seq=32,
                            time_model=tm,
                            host_kv_blocks=host_kv_blocks(args, io),
                            attn_impl=ATTN_IMPLS[args.attn_impl],
                            device=args.device)
    rt = AsyncEchoEngine(target, admission=admission_config(args))
    tracer, registry = None, None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs import MetricsRegistry, Tracer
        tracer = Tracer(cap=args.trace_cap) if args.trace_out else None
        registry = rt.instrument(MetricsRegistry(), tracer)
        attach_host(tracer, rt.service.backend)

    async def _serve() -> None:
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:      # non-unix event loops
                pass
        await rt.start()
        srv = await EchoServer(rt, host=args.host, port=args.port).start()
        host, port = srv.address
        mode = (f"{args.replicas} virtual replicas" if args.replicas > 1
                else ("virtual engine" if model is None
                      else f"{(args.arch or DEFAULT_ARCH)} (reduced)"))
        print(f"listening on {host}:{port} — {mode}, policy={policy.name}; "
              "newline-delimited JSON, Ctrl-C to drain")
        if args.serve_duration > 0:
            try:
                await asyncio.wait_for(stop.wait(), args.serve_duration)
            except asyncio.TimeoutError:
                pass
        else:
            await stop.wait()
        print("draining (in-flight work finishes, new submits shed)...")
        await srv.close()
        print(f"served {srv.requests_served} requests over "
              f"{srv.connections} connections; "
              f"stats: finished={rt.stats.finished} shed={rt.stats.shed} "
              f"aborted={rt.stats.aborted} steps={rt.stats.steps}")
        leaks = rt.kv_leaks()
        print("kv leaks after drain: "
              + ("none" if not any(leaks.values()) else str(leaks)))

    asyncio.run(_serve())
    write_obs(args, tracer, registry)


def main() -> None:
    ap = argparse.ArgumentParser(
        epilog="The JAX package's --kernel-profile has no counterpart here: "
               "the port has no kernel tuning presets, the kernels' launch "
               "parameters follow the card they run on.")
    ap.add_argument("--arch", choices=ARCH_IDS, default=None,
                    help=f"model to serve (default {DEFAULT_ARCH}); "
                         "incompatible with --replicas>1 — the cluster "
                         "dry-run is model-free")
    ap.add_argument("--policy", choices=list(POLICY_BY_NAME), default="Echo")
    ap.add_argument("--duration", type=float, default=20.0)
    # the default workload is sized so the offline prefix working set
    # exceeds the device cache under online bursts — the paper's co-serving
    # regime, where preemption and host-tier swaps actually occur (and show
    # up on a --trace-out timeline)
    ap.add_argument("--num-blocks", type=int, default=64)
    ap.add_argument("--online-rate", type=float, default=4.0)
    ap.add_argument("--n-docs", type=int, default=12)
    ap.add_argument("--questions", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="N>1: dry-run a virtual N-replica cluster")
    ap.add_argument("--router", default="affinity",
                    choices=("affinity", "round_robin", "random"))
    ap.add_argument("--tenants", type=int, default=3,
                    help="tenant count for the --replicas workload")
    ap.add_argument("--kill-at", action="append", metavar="T:RID",
                    help="chaos: kill replica RID at virtual second T "
                         "(repeatable); its in-flight work is re-dispatched")
    ap.add_argument("--degrade-at", action="append",
                    metavar="T:RID:FACTOR:DUR",
                    help="chaos: slow replica RID's ground-truth clock by "
                         "FACTOR for DUR seconds starting at T (repeatable)")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic fleet: a FleetController adds replicas on "
                         "predicted online load and drains idle ones "
                         "(--replicas is the floor, --max-replicas the cap)")
    ap.add_argument("--max-replicas", type=int, default=4,
                    help="--autoscale ceiling on fleet size")
    ap.add_argument("--rate-per-replica", type=float, default=None,
                    help="--autoscale capacity figure: online req/s one "
                         "replica sustains at the SLO (default: an even "
                         "share of --online-rate)")
    ap.add_argument("--hw-profile", default="a100",
                    help="ground-truth hardware clock preset(s): one of "
                         f"{TimeModel.HW_PROFILES}, comma-separated to cycle "
                         "profiles over a heterogeneous --replicas fleet")
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "ref", "pallas", "splitk"],
                    help="attention schedule on the real-model runner: "
                         "auto = splitk = the split-K decode kernel, pallas "
                         "= the legacy decode kernel, both with the chunked "
                         "prefill kernel (see repro_torch.kernels.ops); "
                         "ref is refused: use --device cpu for the plain "
                         "PyTorch versions")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs: the card (default) or, "
                         "asked for explicitly, the CPU through the "
                         "kernels' plain versions; also the device whose "
                         "host link --serve calibrates")
    ap.add_argument("--hw-drift", type=float, default=1.0,
                    help="scale the ground-truth clock by this factor "
                         "(2.0 = hardware runs 2x slower than the estimate)")
    ap.add_argument("--hw-jitter", type=float, default=0.0,
                    help="sigma of per-iteration log-normal clock noise")
    ap.add_argument("--calibrate", action="store_true",
                    help="refit the scheduler's time model online from the "
                         "observed clock (§5 closed loop)")
    ap.add_argument("--max-online-queue", type=int, default=None,
                    help="admission control: bound the online queue; "
                         "arrivals beyond it are shed")
    ap.add_argument("--slo-shed-factor", type=float, default=None,
                    help="admission control: shed an online arrival whose "
                         "predicted TTFT exceeds this multiple of its SLO")
    ap.add_argument("--offline-cap", type=int, default=None,
                    help="admission control: soft cap on the offline "
                         "backlog; excess work is deferred, not dropped")
    ap.add_argument("--host-kv-gb", type=float, default=0.5,
                    help="host-memory KV swap tier per replica, in GB: "
                         "evicted blocks with future reuse are parked on "
                         "the host and restored over PCIe instead of "
                         "recomputed (0 or --no-swap = recompute-only)")
    ap.add_argument("--pcie-gbps", type=float, default=25.0,
                    help="effective host<->device bandwidth for the swap "
                         "tier's transfer-time terms (25 ~ PCIe 4.0 x16)")
    ap.add_argument("--no-swap", action="store_true",
                    help="disable the host swap tier even with "
                         "--host-kv-gb set (recompute-only baseline)")
    ap.add_argument("--no-swap-overlap", action="store_true",
                    help="charge PCIe swap traffic serially against every "
                         "iteration instead of overlapping it with compute "
                         "on an async copy stream (the pre-overlap cost "
                         "model; also disables the wall-path double buffer)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(request lifecycle spans + schedule/kernel/swap "
                         "tracks); load the file at https://ui.perfetto.dev")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics snapshot: Prometheus text, or a "
                         "structured JSON dump for .json paths")
    ap.add_argument("--trace-cap", type=int, default=200_000,
                    help="trace ring-buffer capacity in events; oldest "
                         "events drop beyond it (bounded memory)")
    ap.add_argument("--serve", action="store_true",
                    help="listen on a TCP socket (repro_torch.rt front door) "
                         "instead of replaying a canned trace; drains "
                         "gracefully on Ctrl-C")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--serve bind address")
    ap.add_argument("--port", type=int, default=8631,
                    help="--serve bind port (0 = ephemeral)")
    ap.add_argument("--virtual", action="store_true",
                    help="--serve the model-free virtual-clock engine "
                         "(protocol/scheduling demos; no model compute)")
    ap.add_argument("--no-link-calibration", action="store_true",
                    help="skip the cold-start PCIe micro-benchmark that "
                         "refits the swap terms from timed host<->device "
                         "copies before traffic is admitted")
    ap.add_argument("--serve-duration", type=float, default=0.0,
                    help="auto-drain the --serve listener after this many "
                         "wall seconds (0 = run until signal)")
    args = ap.parse_args()
    if args.attn_impl == "ref":
        ap.error("--attn-impl ref: the port has no schedule that sends a "
                 "CUDA tensor to a plain version; pass --device cpu to run "
                 "the plain PyTorch versions")

    if args.serve:
        serve_realtime(args)
        return

    elastic = args.autoscale or args.kill_at or args.degrade_at
    if args.replicas > 1 or elastic:
        if args.arch is not None:
            ap.error("--arch is incompatible with the cluster dry-run "
                     "(--replicas > 1 / --autoscale / --kill-at / "
                     "--degrade-at): it is model-free — drop --arch, or "
                     "drop the fleet flags to serve a real model)")
        serve_cluster(args)
        return

    cfg = get_config(args.arch or DEFAULT_ARCH).reduced()
    model = Model(cfg)
    params = model.init(torch.Generator(device=resolve_device(args.device))
                        .manual_seed(args.seed))
    policy = resolve_policy(args)

    quad = cfg.family not in ("ssm", "hybrid")
    io = io_spec_for_model(model)
    swap_byte = TimeModel.pcie_swap_byte(args.pcie_gbps)
    tm = TimeModel.a100(quadratic_prefill=quad, swap_byte=swap_byte,
                        swap_overlap=not args.no_swap_overlap)
    clocks = clock_models(args, quadratic_prefill=quad, swap_byte=swap_byte)
    if clocks and len(clocks) > 1:
        print(f"warning: --replicas 1 uses only the first --hw-profile "
              f"({args.hw_profile.split(',')[0].strip()}); extra profiles "
              f"are ignored — pass --replicas N for a heterogeneous fleet")
    trace = BurstyTrace(base_rate=args.online_rate, tidal_period=4 * args.duration,
                        seed=args.seed)
    arrivals = trace.sample(0, args.duration)
    online = make_online_requests(arrivals, prompt_mean=64, prompt_std=24,
                                  max_new_mean=16, vocab=cfg.vocab_size,
                                  slo=SLO(1.0, 0.1), seed=args.seed)
    offline = make_offline_corpus(args.n_docs, args.questions, doc_len=160,
                                  question_len=24, max_new=8,
                                  vocab=cfg.vocab_size, seed=args.seed + 1)

    eng = EchoEngine(model, params, policy, num_blocks=args.num_blocks,
                     block_size=16, chunk_size=64,
                     max_pages_per_seq=32, time_model=tm,
                     clock_model=clocks[0] if clocks else None,
                     host_kv_blocks=host_kv_blocks(args, io),
                     attn_impl=ATTN_IMPLS[args.attn_impl],
                     device=args.device)
    service = EchoService(eng, admission=admission_config(args))
    tracer, registry = setup_obs(args, service)
    stats = service.drive(online + offline, max_iters=100_000,
                          until_time=args.duration * 4)
    print(f"policy={policy.name}")
    print_report(service, stats, online, offline)
    write_obs(args, tracer, registry)


if __name__ == "__main__":
    main()
