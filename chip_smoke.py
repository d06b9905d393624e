#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FELARE simulator on one CUDA card.

    python3 chip_smoke.py                # the full check, on one card
    python3 chip_smoke.py --reps 10      # a shorter flat path
    python3 chip_smoke.py --fed-reps 10  # a shorter federated path
                                         # (the observed one takes
                                         # min(fed_reps, 10) replicates)
    python3 chip_smoke.py --kernels-only # phases 1-5, then stop

The port's float32 products stay in float32 (TF32 is switched off for
matmuls and cuDNN alike).

Phases, one JSON line each; any failed check raises, so the script
exits non-zero and prints no result line. Phases 1-8c run in this order
in this process; phases 8d-8f (the other model families' serving, the
edge example and training) in a process of their own, alone on the
card; phase 8g (the sharded substrate) in another, alone; phase 8h (the
roofline) in another, alone on the card (its dry-run cell in a CPU
process of its own); then phases 9-20 in six processes at once on the
same card, with 8h (d), the examples, in a seventh and phase 8i (the
discipline checker's walker audit) in an eighth
(``SWEEP_GROUPS``: the flat sweep; the flat sweep observed and the
faulted runs' parity; the paper_x8 sweeps, observed and faulted; the
tiered_x4 sweep and the network; the workload scenarios and the flat
synthetic fleets; the synthetic federations), each holding its own
launch counts, and their lines arrive interleaved:

  1. env      torch and CUDA versions, the card's name and power limit;
  2. build    nvcc builds the kernels from ``src/repro_torch/kernels/csrc``,
              one process per source, all at once; ptxas's registers and
              spills, and per library and kernel function the count of
              tensor-core (HGMMA: wgmma, HMMA: mma.sync), 128-bit
              global-load and shared-atomic (ATOMS) instructions in its
              SASS (``cuobjdump``): flash attention must issue wgmma,
              decode attention 16-byte loads, every tensor-core instance of
              the SSD scan mma.sync without spilling, map_decide's
              instances for up to 8 machines no shared atomic, and
              evict_stats and balance_scan 128-bit global loads;
  3. kernels  each scheduling kernel against its plain PyTorch version on
              the card, bit for bit (``torch.equal`` on every output): the
              map kernels at the flat path's shape and at a wide one, over
              every nominator x key x drop rule with the suffered split on
              and off, at the synthetic fleets' 8 x 6 (cvb) and 6 x 6
              (range) tables, and in their per-row EET form at the
              federation's block-fold and masked-fold shapes and at
              mixed_sites' fold of 7 machines in sites of 4 and 3
              (phase1_map too; task types int32), and at the router's
              one event (B = 1) over N = 1, 2, 3, 5, 8, 13 and 21 tasks;
              evict_stats also with row 0 without a free machine and
              deadlines at start + e and at +inf, at the flat, block-fold
              and masked-fold shapes; ``balance_scan`` at the federated
              path's shape, at F = 2 (the two-site fleets' walk), 1, 32,
              37 and 1024, with more new tasks
              than one tile of the kernel and N off every vector grain,
              over no, sparse and all tasks new, tied loads, dead-site
              penalties and loads too large for the packed keys;
  4. model_kernels  flash attention, decode attention and the SSD scan
              against their plain versions on the card, in float32 and
              bfloat16, at ``tests/test_kernels.py``'s shapes (MHA, GQA,
              MQA, Sq != Sk, ragged kv_len, q_offset 64, the four SSD
              cases), at head dims 24, 40 and 256, one query row, a batch
              row with no valid key, decode with kv_len at the boundaries
              of its split of the cache over 8 blocks (GQA 8, caches of
              1088 and 4096), and at the serve paths' full-width shapes
              (zamba2-2.7b's, and the dense configs' g = 2, 3 and 8 at
              head dim 128; decode at g = 3 on the 4-head instance with
              one head masked):
              attention within atol 1e-5 in float32, the SSD scan within
              2e-4, anything in bfloat16 within 2e-2 (sums in another
              order, p rounded to bf16 for the tensor cores); bf16
              attention also element by element within the bound of
              ``bf16_attention_bound`` (its two bf16 roundings of the
              output and the rounding of p), and bf16 flash attention
              again with q and k at 2.5 N(0, 1), where the softmax is
              peaked and outputs are O(|v|). The SSD scan runs on the
              route its shape picks (one launch on that route's count);
              on the tensor cores a bf16 y is held as
              ``ssd_bf16_on_tensor_cores`` says (element by element within
              two bf16 roundings of the plain version's, and 2e-2 where
              |y| < 4; the bf16 rounding of its float32 instance bit for
              bit, which is within 2e-4), and bf16 B and C must give the
              bits of their float32 values;
  5. times    per kernel at its path's shapes: device time per launch
              (``torch.profiler``), the plain version's device time per
              call, the eager time per call by CUDA events with the host's
              work included, the least time the card could take for the
              same bytes and operations, and for the attention kernels
              one ``scaled_dot_product_attention`` call on the same inputs
              (timed here, never called by the port), each kernel's share
              of its bound and its ratio to that call. map_decide and
              evict_stats at the flat, paper_x8, tiered_x4, cvb (8 x 6)
              and mixed_sites (masked fold of 7) shapes, phase1_map at
              the flat, cvb and mixed_sites ones, balance_scan at paper_x8's
              and tiered_x4's, the SSD scan with bf16 B and C
              as the serve path gives them (and with float32 B and C);
              then flash attention's float32 instantiation at the same
              shape, and decode attention with 2, 4 and 8 query heads per
              kv head; then, in a process of its own
              (``--serving-front-times front``: torch.profiler loses
              records once a process has opened many windows), the map
              kernels at the router's shape (one event of 8 tasks) and
              flash and decode attention at the dense configs' serve
              shapes (g = 2, 3, 8 at head dim 128), and in another
              (``--serving-front-times families``) at the other
              families' (g = 3, 7 and 1 at head dim 64, g = 4 at 128;
              whisper-medium's non-causal encoder over 1500 frames, its
              decoder, and its cross-attention over 1500 rows);
  6. profile  where one batched event's time goes (the device's records
              alone): the first 64
              iterations of the flat FELARE and phase1 ELARE sweeps, of
              the flat FELARE sweep with all four observers and with
              task_log alone, and of the federated FELARE + fair_spill
              sweep on paper_x2 and paper_x8 under torch.profiler (wall vs
              device-busy time, kernels per iteration, which must not grow
              with the sites), of the faulted paper_x8 sweeps (FELARE +
              health_aware under the outages, FELARE + fair_spill under
              churn; see phase 16), of tiered_x4 FELARE + fair_spill
              without a network and under phase 18's, and of phase 20's
              FELARE sweeps (the seven workload scenarios as one batch,
              wide-fleet, mixed_sites + least_queued, federated-skew +
              sticky by type);
  7. serve    zamba2-2.7b at its published width (54 layers, d_model 2560,
              bf16, random weights from torch.Generator seed 0) serves 8
              requests of 1024 prompt tokens (numpy seed 0) for 64 greedy
              tokens through ``make_serve_steps``: one prefill, then 64
              decode steps. The launch counts, zeroed just before, must be
              9 flash_attention and 54 ssd_scan on the tensor cores
              (ssd_scan_tc) per prefill and 9 decode_attention per decode
              step. Prefill ms, ms per decode
              step and tokens/s from CUDA events after a warm-up call,
              peak memory, then (``serve_profile``) where one prefill and
              one decode step spend their device time (torch.profiler);
  8. serve_parity  the kernel path against the plain path on the card
              (attn_impl = ssm_impl = "plain"): in float32 at full width,
              the prefill logits and the first decode step's within rel
              1e-3 of max|logits|; in bfloat16, every block of the prefill
              and the attention blocks of a decode step from the same
              input within 2e-2 of max|want|, and the first generated
              tokens reported (on the requests whose top-2 gap on the
              plain path is above 2e-2 x max|logits|, and against the
              float32 run);
  8a. serve_dense  the dense GQA configs at their published width, bf16,
              random weights from torch.Generator seed 0, each serving 8
              requests of 1024 prompt tokens for 64 greedy tokens as in
              phase 7: internlm2-1.8b (24 layers, 16/8 heads) and
              phi4-mini-3.8b (32 layers, 24/8 heads) at full depth,
              command-r-35b (64/8 heads) at 16 of its 40 layers (the line
              names the cut). Launches, zeroed just before: one
              flash_attention per layer and one decode_attention per
              layer and step; finite logits, tokens in range. Prefill
              ms, ms per decode step, tokens/s, peak memory, then where
              one prefill and one decode step spend their device time;
  8b. router  launch/serve.py's request loop on the card (400 requests at
              1000/s over its four archs and four machine groups) under
              plain FELARE and ELARE and under with_fused_map(FELARE),
              with_fused_map(ELARE) and with_fused_phase1(ELARE),
              registered by name: every metrics() field equal to the
              plain run's on the card and to the same name's run on the
              CPU; launches equal to the policy calls (FELARE on the map
              kernels: one evict_stats and one map_decide each); host ms
              per mapping event;
  8c. elastic launch/elastic.py at its defaults on the card and on the
              CPU: the same printout and result, and a site left (in the
              flat sweep's group process, after phase 10);
  8d. serve_families  (in a group process of its own, before phases
              9-20) the moe, vlm, audio and ssm families at their
              published width, bf16, random weights from torch.Generator
              seed 0, 8 requests, 64 greedy tokens each, as in phase 8a:
              granite-moe-3b-a800m (32 layers, 40 experts top-8) and
              internvl2-1b (256 patches + 1024 tokens) at full depth,
              phi3.5-moe-42b-a6.6b at 16 of its 32 layers (the line names
              the cut), whisper-medium (24 + 24 layers; 1500 frames, a
              4-token decoder prompt, caches of 1500 rows) and xlstm-125m
              (12 layers, 1024 tokens). Launches, zeroed just before: one
              flash_attention per attention block and prefill (whisper:
              24 encoder, 24 decoder, 24 cross) and one decode_attention
              per block attending a cache and step (whisper: self and
              cross), none for xlstm; finite logits, tokens in range, the
              cache lengths. Prefill ms, ms per decode step, tokens/s,
              peak memory, then where one prefill and one decode step
              spend their device time (xlstm: also one mLSTM's and one
              sLSTM's host ms); then granite-moe-3b, internvl2-1b and
              whisper-medium in float32 at full width, the kernel path
              against the plain path: the prefill logits and the first
              decode step's within rel 1e-3 of max|logits|;
  8e. serve_edge  examples/torch_serve_edge.py on the card (120 requests
              at 20/s, FELARE routing qwen1.5-0.5b and whisper-medium
              requests over four machine groups): its real prefill calls,
              and flash launches equal to their attention blocks;
  8f. train   (a) qwen1.5-0.5b at its published width and depth (24
              layers, d_model 1024, vocabulary 151,936), bf16 params,
              remat on, the plain attention path (the kernels have no
              backward), random weights from torch.Generator seed 0,
              trains 20 steps of SyntheticLM seed 0 (8 x 512 tokens per
              step in 2 microbatches, AdamW at lr 3e-4) through
              train.loop.run: finite losses and grad norms, the mean loss
              of the last 5 steps below the first 5's, and no launch of
              any kernel (counts zeroed just before); ms per step,
              tokens/s, peak memory, then where one step spends its
              device time (torch.profiler: top kernels, idle share) and
              the LM head's and loss's share of it (CUDA events); (b)
              under torch.use_deterministic_algorithms (set only for
              this part, with CUBLAS_WORKSPACE_CONFIG=:4096:8) the same
              job cut to 5 steps, run whole and run with a checkpoint
              after step 3 and a SimulatedFailure there, restarted by
              run_with_restarts from that checkpoint: every parameter and
              optimizer leaf equal bit for bit; (c) the smoke config of
              one arch per family (dense, hybrid, moe, vlm, audio, ssm)
              in float32, TF32 off: the first step's loss and every
              gradient leaf on the card within rel 1e-4 (of the leaf's
              max|g|) of the CPU's, then make_train_step with
              attn_impl="kernel" and flash attention on a tensor that
              requires grad must raise, launching nothing;
  8g. sharded (its own process, alone) the sharded substrate on a
              process group of one rank (NCCL, joined through a file://
              store in a temporary directory), as the card's machine
              has one GPU: (a) 8f's training cell for 3 steps through
              make_train_step(cfg, opt, mesh) on a (1, 1, 1) (pod, data,
              model) mesh, every leaf a DTensor in the reference's
              layout, against the one-device step from the same init
              and batches under deterministic algorithms: loss, grad
              norm and every parameter and moment bit for bit (else
              within rel 1e-6 and 1e-5 of max|p|, the cause printed);
              ms per step and peak memory both ways; (b) qwen1.5-0.5b
              serving 8 x 1024 tokens and 3 greedy tokens through
              make_serve_steps(cfg, mesh) on (1, 1) against the
              unmeshed steps: logits and every cache leaf bit for bit,
              24 flash and 72 decode launches both ways; (c) ring
              attention within 1e-5 of the plain attention, gpipe over
              one stage (and its gradient) against the sequential
              apply, the compressed mean equal to the
              quantize-dequantize; (d) run_sweep(shard=True) on the flat
              FELARE spec (2 rates x 3 reps x 200 tasks) equal to
              shard=False by sha256; one line with the card's name and
              power limit;
  8h. roofline (its own process, alone; ``chip_smoke.py --group
              roofline``) (a) every row of PERF.md's kernel table: the
              bound of the kernel's cost rule (``kernels/*/ops.py``, the
              roofline walker's count, rates from ``roofline/hw.py``)
              beside the hand count the timing phases used before the rules,
              with the ratio; flash and decode attention timed at 8g's
              qwen1.5-0.5b serve shape (16 heads of 64, 8 x 1024 tokens,
              the cache at 1024 + 1 of 1027 rows): device, eager, plain,
              one scaled_dot_product_attention call, the rule's bound;
              (b) the roofline share of whole steps: 8f's training cell
              (qwen1.5-0.5b, 8 x 512 tokens in 2 microbatches, remat) and
              phase 7's zamba2-2.7b prefill (8 x 1024) and decode step,
              each walked once on the card (the train step also on meta:
              the same counts), then the median of 5 steps or calls after
              2 (host clock around a synchronize): walker FLOPs and
              bytes, t_comp and t_mem, share (roofline step time over the
              measured), MFU, the walker's peak live bytes beside
              torch.cuda.max_memory_allocated; (c) one dry-run cell,
              qwen1.5-0.5b train_4k on the (16, 16) pod mesh over a fake
              group of 256 ranks (``python -m repro_torch.launch.dryrun``
              in a CPU process of its own): status ok, rank 0's matmul
              FLOPs x 16 equal to the world-size-1 count; (d) in a group
              process of its own beside phases 9-20 (``examples``:
              host-bound like them, and at their default sizes too long
              for 8h's process alone), examples/torch_quickstart.py and
              torch_fault_tolerance.py at their default sizes on the
              card, launches zeroed just before each (map_decide and
              evict_stats in both, phase1_map in the quickstart,
              balance_scan in the fault demo), their printouts equal to
              their CPU runs' (processes of their own, on the same
              CPU-drawn traces) line for line;
  8i. audit   (a process of its own beside the sweeps: it counts ops,
              launches and syncs, not times) the discipline checker's walker
              audit (``repro_torch.analysis``, Layer 2) on the card: the
              reference's five engine programs and the three fleet pairs
              walked on CUDA, the fused program on the kernels; no finding
              (flatness across F, no unmarked float64 op and no unmarked
              host read in a full iteration, including the syncs
              PyTorch's sync debug mode reports in a second run); kernel
              scopes per full iteration times the iterations equal to
              the ``LAUNCHES`` counts of each walk; iterations, ops per
              full iteration, kernel scopes and host reads equal to a CPU
              walk's (a CPU process of its own); the flat path (FELARE on the
              fused kernels) at B = 1 and at B = 150 (5 rates x 30 x 2000
              tasks, 64 iterations) with the same op multiset in every
              full iteration;
  9. main     the flat paper-scale sweep (paper 4x4 system, rates 2-8, 30
              replicates of 2000 tasks) with ELARE, FELARE and MM on the
              fused map kernels and ELARE on the phase1_map kernel; the
              launch counts, zeroed just before, must show every kernel
              ran on every batched event;
 10. parity   the same traces through the plain path on the card give
              identical counters and makespans (FELARE's plain run
              carries the observers and is held, Metrics and all, in
              phase 15), and a 2 x 2 subset
              through the port on the CPU gives identical counters with
              energies within rel 1e-5 (sums over machines run in another
              order there);
 11. fed      the federated sweep: paper_x8 (8 sites of the 4x4 system,
              total rates 16-64, 30 replicates of 2000 tasks) with FELARE
              + fair_spill and ELARE + least_queued, then tiered_x4 (four
              unequal sites, masked views; 10 replicates of 500 tasks)
              with FELARE + least_queued, all
              on the fused kernels: map_decide and balance_scan launch
              once per batched event, not once per site;
 12. fed_parity  the plain path on the card gives identical counters and
              makespans, and a 2 x 2 subset (each trace cut to its first
              700 tasks) gives the same counters on the CPU;
 13. observe  the flat sweep's FELARE run again, unobserved and then on
              the fused kernels with
              all four observers (task_log, timeline, fairness_trajectory,
              energy_budget unset): Metrics identical to the unobserved
              run, map_decide and evict_stats on every batched event, the
              observers' outputs consistent with the Metrics (final
              statuses, the timeline's last bucket); then on a battery of
              half the mean total energy, which must halt replicates and
              raise the share of their admitted tasks cancelled; wall
              seconds observed against unobserved;
 14. observe_fed  paper_x8 FELARE + fair_spill on the fused kernels
              (balance_scan on the card) with task_log and the per-site
              timeline, on the first min(--fed-reps, 10) replicates of the
              federated traces, each cut to its first 700 tasks: every
              kernel on every batched event, the final task_log.site equal
              to the engine's final SimState.site;
 15. observe_parity  the plain path on the card gives every aux leaf of
              phases 13 and 14 identical (float32 times included), and a
              2 x 2 subset of phase 13 on the CPU gives identical task_log
              and fairness_trajectory, energies within rel 1e-5;
 16. faults   machine faults on the kernels, the dynamics from fixed
              parameters, on the first 10 replicates of the flat and
              federated traces cut to 700 tasks (paper_x2's drawn at 500):
              paper_x8 under the outages of sites 0 and 3 (a quarter of
              the horizon each) with FELARE + health_aware (task_log and
              health attached) and with FELARE + sticky (on-time share
              reported beside it), paper_x8 under churn (p_fail 0.02,
              p_recover 0.2 per machine and event) with FELARE +
              fair_spill, paper_x2 under the same churn with
              with_backup(FELARE, 1) + health_aware (the failover at 8
              machines), and the flat system with machine 1 at 2.0 x
              under ELARE on phase1_map. Each run's launch counts, zeroed
              just before it, show every kernel of its path on every
              batched event; no task started on a machine in its site's
              window; retries within max_retries + 1; the health series
              shows sites 0 and 3 without a healthy machine in their
              windows and whole outside; churn wastes at least the energy
              the same sweep wastes without faults, and that sweep, run
              with dynamics="none", gives the Metrics of the fed phase's
              run (its 2 x 2 subset) and of phase 14's on the same traces;
 17. faults_parity  the faulted runs but the sticky one, on 5 replicates
              cut to 150 tasks, through the kernels and the plain path
              on the card: every Metrics field and aux leaf identical
              (float32 times, task_log with retries, health); the outage
              run's 2 x 2 subset on the CPU gives identical counters,
              task_log and health, energies within rel 1e-5;
 18. network  the edge-cloud network at the repo's documented
              configuration (benchmarks/ablations.py::tiered_network,
              full=True): tiered_x4 under the "harsh" tiered matrices, 6
              tasks/s, 12 replicates of 2000 tasks, ELARE + tier_aware,
              FELARE + tier_aware and FELARE + fair_spill on the kernels
              with task_log and the network series. Each run's launch
              counts, zeroed just before it, show every kernel of its path
              on every batched event; no task starts before it lands; per
              arm the on-time share, the per-type completion std, the
              transfer energy per tier and the tasks cancelled in transit;
              then the claim of benchmarks/TIERS_BASELINE.json must hold
              (FELARE + tier_aware's std at most ELARE + tier_aware's +
              0.02, its on-time share above FELARE + fair_spill's);
 19. network_parity  on 5 replicates of 300 tasks under the registered
              tiered network, FELARE + fair_spill (all three kernels of
              the path) through the kernels and the plain path on the
              card: every
              Metrics field and aux leaf identical (ready times, the
              network series); network="none" on the fed phase's tiered_x4
              traces gives that phase's Metrics;
 20. scenarios  the reference's workload scenarios and synthetic fleets
              at full width (5 rates x 30 replicates x 2000 tasks): the
              seven workload-only scenarios (bursty, diurnal, flash-crowd,
              heavy-tail, drift, tight-deadlines, bursty-heavy-tail) on
              the paper's system as one batch of 1050 traces through
              ``simulate_sweep``, FELARE on the fused map and ELARE on
              phase1_map, and bursty again end to end through
              ``run_sweep`` (its Metrics must be the batch's bursty rows);
              arrivals sorted and finite, MMPP's inter-arrival CV^2 above
              1.15 and Poisson's within 0.1 of 1; wide-fleet (the cvb
              fleet, 8 types on 6 machines) with FELARE and ELARE at rates
              2-8; mixed_sites (sites of 4 and 3 machines, masked fold)
              with FELARE + least_queued and + min_eet, and
              federated-skew (paper_x2 under a skewed mix) with FELARE +
              sticky by type and + fair_spill, at 4-16 tasks/s. Each
              run's launch counts, zeroed just before it, show every
              kernel of its path on every batched event;
     scenarios_parity  every run above, range FELARE (6 x 6) and ELARE
              + least_queued on phase1_map over mixed_sites, on 5
              replicates of 300 tasks through the kernels and the plain
              path on the card: Metrics identical (sha256).

Then the card's name and power limit as ``nvidia-smi`` prints them, one
``{"kernels": [...]}`` line (a row with ``by_shape`` gives each path
shape's times, bound, launches and launches x (ms - bound)), and the last
line
``{"ok": true, "device": {...}}``. With ``--kernels-only`` the script
stops after phase 5 and prints neither line.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import threading
import time
from functools import partial

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_SHAPE = dict(B=150, N=2000, M=4, S=4)
WIDE_SHAPE = dict(B=8, N=10_000, M=512, S=8)
RATES = (2.0, 3.0, 4.0, 6.0, 8.0)
# The federation: the paper's per-site rates (2-8 tasks/s) at every site.
FED_RATES = tuple(8 * r for r in RATES)          # paper_x8, total tasks/s
# 2000 tasks per trace, the paper's length (4000 until the faulted paths
# joined the smoke: the host sets a sweep's time by its iterations, so
# the tasks are what fits the phases under the limit)
FED_TASKS = 2000
TIER_RATES = (12.0, 24.0)                        # tiered_x4, total tasks/s
# tiered_x4's sweep at 500 tasks per trace (2000 until the network
# phases joined; they run tiered_x4 at 2000); its kernels are timed at
# 2000 tasks all the same
TIER_REPS, TIER_TASKS, TIER_TIMED_TASKS = 10, 500, 2000
# The observed paths: every built-in observer on the flat sweep (the
# energy budget unset), and paper_x8 on the first 10 replicates of the
# federated traces, each cut to its first 700 tasks (1000 until the
# network phases joined; an iteration costs the host about the same at
# any batch, so the length of the traces sets the phase's time).
OBSERVERS = ("task_log", "timeline", "fairness_trajectory", "energy_budget")
OBS_FED_REPS, OBS_FED_TASKS = 10, 700
# The fed phase's CPU subset: its card run is also the faults phase's
# dynamics="none" reference, so it shares the observed federation's cut.
CPU_SUBSET_TASKS = OBS_FED_TASKS
# Machine faults, the dynamics from fixed parameters: sites 0 and 3 of
# paper_x8 down for a quarter of the horizon each, churn (a machine fails
# with p 0.02 per event and recovers with p 0.2), and machine 1 of the
# flat system at twice the runtime. Each run: (label, system, heuristic,
# dispatcher, dynamics, observers, kernels). The faulted sweeps take the
# first 10 replicates of the flat and federated traces, cut to 700 tasks
# (the observed federation's traces; an iteration costs the host about
# the same at any batch, so only shorter traces shorten the phase); the
# plain path is held on 5 of them cut to 150.
FAULT_OUTAGES = ((0, 0.25, 0.5), (3, 0.5, 0.75))
FAULT_CHURN = dict(p_fail=0.02, p_recover=0.2, seed=0)
FAULT_STRAGGLER = dict(factor=2.0, machines=(1,))
FAULT_BACKUP = "FELARE_BACKUP1"                  # with_backup(FELARE, k=1)
FAULT_RUNS = (
    ("paper_x8 FELARE health_aware outage", "paper_x8", "FELARE",
     "health_aware", "outage", ("task_log", "health"), "map"),
    ("paper_x8 FELARE sticky outage", "paper_x8", "FELARE", "sticky",
     "outage", (), "map"),
    ("paper_x8 FELARE fair_spill churn", "paper_x8", "FELARE", "fair_spill",
     "churn", (), "map"),
    ("paper_x2 with_backup(FELARE, 1) health_aware churn", "paper_x2",
     FAULT_BACKUP, "health_aware", "churn", ("task_log",), "map"),
    ("paper ELARE straggler", "paper", "ELARE", "sticky", "straggler",
     ("task_log",), "phase1"),
)
FAULT_REPS, FAULT_TASKS = OBS_FED_REPS, OBS_FED_TASKS
FAULT_BACKUP_TASKS = 500                         # the paper_x2 backup run
FAULT_PARITY_REPS, FAULT_PARITY_TASKS = 5, 150
# The edge-cloud network: the repo's documented configuration,
# benchmarks/ablations.py::tiered_network(full=True): tiered_x4 (three
# device sites and a cloud site at tier 2) under the "harsh" tiered
# matrices, 6 tasks/s, 12 traces x 2000 tasks, ELARE + tier_aware,
# FELARE + tier_aware and FELARE + fair_spill on the kernels, with the
# task log and the network series. The claim of
# benchmarks/TIERS_BASELINE.json must hold on the port's own traces.
NET_LATENCY = ((0.05, 1.0, 6.0), (1.0, 0.05, 4.0), (6.0, 4.0, 0.0))
NET_ENERGY = ((0.1, 0.5, 2.0), (0.5, 0.1, 1.0), (2.0, 1.0, 0.0))
NET_RATES, NET_REPS, NET_TASKS = (6.0,), 12, 2000
NET_ARMS = (("ELARE", "tier_aware"), ("FELARE", "tier_aware"),
            ("FELARE", "fair_spill"))
NET_OBSERVERS = ("task_log", "network")
NET_PARITY_REPS, NET_PARITY_TASKS = 5, 300
# The workload scenarios and synthetic fleets: the reference's seven
# workload-only scenarios on the paper's system, one batch of 7 x 150
# traces; wide-fleet (the cvb fleet, 8 types on 6 machines) at the paper's
# rates; mixed_sites (sites of 4 and 3 machines, masked fold) and
# federated-skew (paper_x2 under a skewed mix, block fold) at twice the
# paper's rates (its per-site rates over two sites). All at 30 x 2000.
# Each run: (label, scenario, system, rates, heuristic, dispatcher, shape).
WORKLOAD_SCENARIOS = ("bursty", "diurnal", "flash-crowd", "heavy-tail",
                      "drift", "tight-deadlines", "bursty-heavy-tail")
PAIR_RATES = tuple(2 * r for r in RATES)         # two sites, total tasks/s
SCENARIO_RUNS = (
    ("wide-fleet FELARE", "wide-fleet", None, RATES, "FELARE", None,
     "cvb"),
    ("wide-fleet ELARE", "wide-fleet", None, RATES, "ELARE", None, "cvb"),
    ("mixed_sites FELARE least_queued", "poisson", "mixed_sites",
     PAIR_RATES, "FELARE", "least_queued", "mixed_sites"),
    ("mixed_sites FELARE min_eet", "poisson", "mixed_sites", PAIR_RATES,
     "FELARE", "min_eet", "mixed_sites"),
    ("federated-skew FELARE sticky by type", "federated-skew", None,
     PAIR_RATES, "FELARE", "sticky_by_type", "paper_x2"),
    ("federated-skew FELARE fair_spill", "federated-skew", None, PAIR_RATES,
     "FELARE", "fair_spill", "paper_x2"),
)
# Fused against plain at every new shape, on a cut of 5 x 300: the runs
# above, range (6 types on 6 machines) and ELARE on phase1_map over the
# mixed_sites fold.
SCENARIO_PARITY_RUNS = SCENARIO_RUNS + (
    ("range FELARE", "poisson", "range", RATES, "FELARE", None, "range"),
    ("mixed_sites ELARE least_queued", "poisson", "mixed_sites", PAIR_RATES,
     "ELARE", "least_queued", "mixed_sites"),
)
SCENARIO_PARITY_REPS, SCENARIO_PARITY_TASKS = 5, 300
# balance_scan: the federated path's shape, then more new tasks than one
# 4096-task tile of the kernel, and N off the 16-task vector grain.
BALANCE_SHAPES = (dict(B=150, N=FED_TASKS, F=8), dict(B=150, N=2000, F=2),
                  dict(B=8, N=10_000, F=32),
                  dict(B=8, N=10_000, F=37), dict(B=6, N=4001, F=1),
                  dict(B=6, N=5003, F=1024))
BALANCE_DENSITIES = (0.0, 0.01, 0.5, 1.0)
# Loads: all tied, small with dead sites, and above the packed keys' range
# (the 64-bit walk; sparse and full admissions only).
BALANCE_LOADS = {"equal": BALANCE_DENSITIES, "mixed": BALANCE_DENSITIES,
                 "wide": (0.5, 1.0)}
# Per-row EET shapes: paper_x8's block fold (B * F rows of m = 4 machines)
# and tiered_x4's masked fold (B * F rows of all 20 machines).
BLOCK_ROWS = dict(B=150, F=8, N=FED_TASKS, m=4, S=4)
MASKED_ROWS = dict(B=150, sites=(0,) * 4 + (1,) * 4 + (2,) * 4 + (3,) * 8,
                   N=TIER_TIMED_TASKS, S=4)
# The synthetic fleets' shapes: cvb's 8 x 6 and range's 6 x 6 tables, and
# mixed_sites' masked fold (B * 2 rows of all 7 machines).
FLEET_SHAPES = {"cvb": dict(B=150, N=2000, M=6, S=8),
                "range": dict(B=150, N=2000, M=6, S=6)}
MIXED_ROWS = dict(B=150, sites=(0,) * 4 + (1,) * 3, N=2000, S=4)
KERNEL_SOURCES = {
    "map_decide": ("src/repro_torch/kernels/csrc/map_fused.cu",
                   "src/repro/kernels/map_fused/kernel.py:195"),
    "evict_stats": ("src/repro_torch/kernels/csrc/map_fused.cu",
                    "src/repro/kernels/map_fused/kernel.py:246"),
    "phase1_map": ("src/repro_torch/kernels/csrc/phase1_map.cu",
                   "src/repro/kernels/phase1_map/kernel.py:47"),
    "balance_scan": ("src/repro_torch/kernels/csrc/balance_scan.cu",
                     "src/repro/kernels/map_fused/kernel.py:296"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:88"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:64"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan/kernel.py:74"),
}
# The serve path: zamba2-2.7b at its published width, 8 requests of 1024
# prompt tokens, 64 greedy tokens each.
SERVE_ARCH = "zamba2-2.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 1024, 64
SERVE_MAX_SEQ = SERVE_PROMPT + SERVE_NEW
# The dense GQA configs served at their published width, each 8 requests
# of 1024 prompt tokens for 64 greedy tokens like zamba2-2.7b: 16 query
# heads per 8 kv heads (g = 2), 24 (g = 3) and 64 (g = 8), head dim 128.
# command-r-35b's depth is cut to 16 of its 40 layers (13.4 B parameters,
# 27 GB in bf16; at full depth its 61 GB of weights and the float32
# temporaries of their init do not fit the card's 80 GB).
DENSE_SERVE = (("internlm2-1.8b", None), ("phi4-mini-3.8b", None),
               ("command-r-35b", 16))
# The moe, vlm, audio and ssm families served at their published width
# like the dense ones (bf16, torch.Generator seed 0, 8 requests, 64 greedy
# tokens): arch, layers served (None: all), prompt tokens. internvl2-1b
# prepends its 256 patches to the 1024 tokens; whisper-medium's decoder
# prompt is 4 tokens over the 1500 frames of its 30-s window, both its
# caches sized 1500. phi3.5-moe-42b's depth is cut to 16 of its 32
# layers (21 B parameters, 42 GB in bf16; its 84 GB at full depth do not
# fit the card's 80 GB).
FAMILY_SERVE = (("granite-moe-3b-a800m", None, SERVE_PROMPT),
                ("phi3.5-moe-42b-a6.6b", 16, SERVE_PROMPT),
                ("internvl2-1b", None, SERVE_PROMPT),
                ("whisper-medium", None, 4),
                ("xlstm-125m", None, SERVE_PROMPT))
AUDIO_FRAMES = 1500
# the kernel path against the plain path in float32 at full width
FAMILY_PARITY = ("granite-moe-3b-a800m", "internvl2-1b", "whisper-medium")
# examples/torch_serve_edge.py at its defaults
EDGE_REQUESTS, EDGE_RATE = 120, 20.0
# Training: qwen1.5-0.5b at its published width and depth (24 layers,
# d_model 1024, vocabulary 151,936), bf16 params, remat on, on its plain
# paths (the kernels have no backward), 8 x 512 tokens per step in 2
# microbatches, 20 steps of SyntheticLM seed 0 at a constant lr of 3e-4
# (at 1e-3 the loss fell to step 6, then rose again; at 2e-3 it diverged).
# The restart check runs the same job cut to 5 steps (a checkpoint after
# step 3, the failure there): each checkpoint holds 4.6 GB of params and
# AdamW moments, and the check writes two and reads one.
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 8, 512, 2, 20
TRAIN_LR = 3e-4
RESTART_STEPS, RESTART_AT = 5, 3
# one smoke config per family, float32, card against CPU
TRAIN_FAMILIES = {"dense": "qwen1.5-0.5b", "hybrid": "zamba2-2.7b",
                  "moe": "granite-moe-3b-a800m", "vlm": "internvl2-1b",
                  "audio": "whisper-medium", "ssm": "xlstm-125m"}
TRAIN_GRAD_TOL = 1e-4
# The sharded substrate at world size 1 (the card's machine has one GPU):
# PERF.md §4's training cell (qwen1.5-0.5b, 8 x 512 tokens in 2
# microbatches) for 3 steps through make_train_step(cfg, opt, mesh) on
# (1, 1, 1) (pod, data, model), and its serving for 8 x 1024-token
# prompts and 3 greedy tokens through make_serve_steps(cfg, mesh) on
# (1, 1) (data, model), each against the unmeshed path; the sweep on the
# flat FELARE spec at 2 rates x 3 reps x 200 tasks.
SHARDED_TRAIN_STEPS, SHARDED_NEW = 3, 3
SHARDED_RATES, SHARDED_REPS, SHARDED_TASKS = (3.0, 6.0), 3, 200
SHARDED_LOSS_REL, SHARDED_PARAM_OF_MAX = 1e-6, 1e-5
# The serving front: launch/serve.py's stream (its default fleet of four
# machine groups and four archs) at 400 requests and 1000 requests/s,
# routed by plain FELARE and ELARE and through the kernels; the map
# kernels are checked at the router's batch of one event over N tasks,
# and timed at N = 8.
ROUTER_REQUESTS, ROUTER_RATE = 400, 1000.0
ROUTER_RUNS = (("FELARE", None), ("FELARE", "map"), ("ELARE", None),
               ("ELARE", "map"), ("ELARE", "phase1"))
ROUTER_N = (1, 2, 3, 5, 8, 13, 21)
ROUTER_TIMED_N = 8
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The spread of q and k in the flash cases: 0.5 N(0, 1) as in
# tests/test_kernels.py (scores of std 0.25, a nearly flat softmax), and
# in bf16 also 2.5 N(0, 1) (std 6.25, a peaked one).
QK_SCALES = {"float32": (0.5,), "bfloat16": (0.5, 2.5)}
SSD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# tests/test_kernels.py's shapes, then the serve path's.
FLASH_CASES = (  # B, Sq, Sk, H, Hkv, hd, causal, q_offset, kv_len
    (2, 128, 128, 4, 4, 64, True, 0, None),
    (2, 128, 128, 4, 2, 64, True, 0, None),
    (2, 256, 256, 8, 1, 32, True, 0, None),
    (2, 64, 192, 4, 2, 128, False, 0, None),
    (2, 32, 128, 2, 2, 32, True, 64, "ragged"),
    (2, 100, 130, 4, 1, 80, True, 30, "ragged"),
    # head dims off the tensor cores' 16-column grain, the widest, one
    # query row, and a batch row with no valid key (the mean of V)
    (2, 96, 130, 4, 2, 24, True, 34, "ragged"),
    (2, 96, 130, 4, 2, 40, False, 0, "zero"),
    (2, 96, 130, 4, 2, 256, True, 34, "ragged"),
    (4, 1, 200, 8, 2, 80, False, 0, "zero"),
    (8, 1024, 1024, 32, 32, 80, True, 0, None),
    # the dense serve shapes: g = 2, 3 and 8 at head dim 128
    (8, 1024, 1024, 16, 8, 128, True, 0, None),
    (8, 1024, 1024, 24, 8, 128, True, 0, None),
    (8, 1024, 1024, 64, 8, 128, True, 0, None),
    # the other families' serve shapes: granite-moe-3b g = 3 and
    # internvl2-1b g = 7 (patches + tokens) at head dim 64, phi3.5-moe g = 4
    # at 128, whisper-medium's encoder (non-causal 1500 x 1500), decoder
    # and cross-attention (4 rows over 1500 frames), g = 1 at 64
    (8, 1024, 1024, 24, 8, 64, True, 0, None),
    (8, 1280, 1280, 14, 2, 64, True, 0, None),
    (8, 1024, 1024, 32, 8, 128, True, 0, None),
    (8, 1500, 1500, 16, 16, 64, False, 0, None),
    (8, 4, 4, 16, 16, 64, True, 0, None),
    (8, 4, 1500, 16, 16, 64, False, 0, None),
)
DECODE_CASES = (  # B, Sk, H, Hkv, hd
    (2, 256, 4, 4, 64), (2, 512, 8, 2, 64), (2, 1024, 4, 1, 128),
    (2, 192, 2, 2, 32), (8, SERVE_MAX_SEQ, 32, 32, 80),
    # the dense serve shapes (g = 3 on the kernel's 4-head instance with
    # one head masked)
    (8, SERVE_MAX_SEQ, 16, 8, 128), (8, SERVE_MAX_SEQ, 24, 8, 128),
    (8, SERVE_MAX_SEQ, 64, 8, 128),
    # the other families': granite-moe-3b g = 3 at 64, phi3.5-moe g = 4 at
    # 128, internvl2-1b g = 7 (the 8-head instance with one head masked)
    # over 1344 rows, whisper-medium's decoder self-attention over a
    # 1500-row cache
    (8, SERVE_MAX_SEQ, 24, 8, 64), (8, SERVE_MAX_SEQ, 32, 8, 128),
    (8, 1344, 14, 2, 64), (8, AUDIO_FRAMES, 16, 16, 64),
)
# Decode at the boundaries of the kernel's split of the cache over 8 blocks
# (chunks of ceil(Sk / 8) keys rounded up to 8), 8 query heads per kv head.
DECODE_SPLIT_CASES = (  # B, Sk, H, Hkv, hd
    (8, SERVE_MAX_SEQ, 16, 2, 80), (8, 4096, 16, 2, 128),
    # whisper-medium's cross cache, all 1500 rows valid among the others
    (8, AUDIO_FRAMES, 16, 16, 64),
)
# Decode under GQA, timed: B, Sk, kv_len, Hkv, hd and the query heads per
# kv head.
DECODE_GQA = dict(B=8, Sk=SERVE_MAX_SEQ, kv=SERVE_PROMPT + SERVE_NEW // 2,
                  Hkv=8, hd=80, g=(2, 4, 8))
SSD_CASES = (  # B, L, H, P, N, chunk
    (2, 64, 2, 32, 16, 16), (2, 128, 4, 64, 64, 32), (2, 96, 1, 16, 8, 32),
    (2, 256, 2, 64, 32, 128), (8, SERVE_PROMPT, 80, 64, 64, 128),
)


# The script's start on the wall clock; a group's process (``--group``)
# takes its parent's, so every line counts from the same start.
_T0 = float(os.environ.get("CHIP_SMOKE_T0", time.time()))


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.time() - _T0, 1)}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


SASS_OPS = (("HGMMA", r"\bHGMMA\."), ("HMMA", r"\bHMMA\."),
            ("LDG.E.128", r"\bLDG\.E\.128\b"), ("ATOMS", r"\bATOMS\."))


def sass_counts(build) -> dict:
    """Per library and per kernel function, how many tensor-core (HGMMA:
    wgmma, HMMA: mma.sync), 128-bit global-load and shared-memory atomic
    instructions its SASS holds (cuobjdump): ``{lib: {"total": counts,
    "functions": {mangled name: counts}}}``."""
    import re

    from concurrent.futures import ThreadPoolExecutor

    tool = pathlib.Path(build.nvcc()).parent / "cuobjdump"

    def dump(name):
        return subprocess.run(
            [str(tool), "-sass", str(build.lib_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout

    with ThreadPoolExecutor(len(build.SOURCES)) as pool:   # all at once
        texts = dict(zip(build.SOURCES, pool.map(dump, build.SOURCES)))
    out = {}
    for name, text in texts.items():
        funcs = {}
        for part in re.split(r"\n\s*Function : ", text)[1:]:
            fname, body = part.split("\n", 1)
            funcs[fname.strip()] = {op: len(re.findall(pat, body))
                                    for op, pat in SASS_OPS}
        out[name] = {"total": {op: sum(f[op] for f in funcs.values())
                               for op, _ in SASS_OPS},
                     "functions": funcs}
    return out


def ptxas_by_function(log: str) -> dict:
    """Registers, stack frame and spill-store bytes per kernel function,
    from ``ptxas -v``'s report."""
    import re

    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"registers": 0, "stack": 0, "spill": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      ln)
        if m:
            out[fn]["stack"], out[fn]["spill"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[fn]["registers"] = int(m[1])
    return out


def map_decide_slots(mangled: str):
    """The slot bound MS (4th template argument) of a ``map_decide_kernel``
    instance, None for any other function."""
    import re

    m = re.search(r"map_decide_kernelILi\d+ELi\d+ELi\d+ELi(\d+)E", mangled)
    return None if m is None else int(m.group(1))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Kernel inputs: random, with forced ties, negative urgency keys, full
# queues and stale tasks.
# --------------------------------------------------------------------------
def kernel_inputs(B, N, M, S, seed, device):
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    f32 = np.float32
    eet = np.round(r.uniform(0.5, 5.0, (S, M)) * 8) / 8
    if M > 1:
        eet[:, 1] = eet[:, 0]                          # duplicate columns
    now = np.round(r.uniform(0.0, 50.0, B) * 4) / 4
    start = now[:, None] + r.choice([0.0, 0.5, 1.0, 2.5], (B, M))
    deadline = now[:, None] + r.choice(np.arange(-4.0, 12.0, 0.5), (B, N))
    qfree = r.random((B, M)) < 0.7
    qfree[0] = False                                   # one replicate full
    arrays = dict(
        now=now.astype(f32), start=start.astype(f32),
        p_dyn=r.choice([1.5, 1.6, 3.0], M).astype(f32), qfree=qfree,
        eet=eet.astype(f32), deadline=deadline.astype(f32),
        pending=r.random((B, N)) < 0.8,
        # drawn as int64, kept as int32 (the type the kernels take)
        task_type=r.integers(0, S, (B, N)).astype(np.int32),
        suffered=r.random((B, N)) < 0.3,
    )
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def router_inputs(N, seed, device):
    """Map-kernel inputs of one router event (B = 1) over N tasks: row 1
    of :func:`kernel_inputs` (row 0 has no free machine)."""
    x = kernel_inputs(2, N, 4, 4, seed, device)
    return {k: v if k in ("eet", "p_dyn") else v[1:2].contiguous()
            for k, v in x.items()}


def evict_edges(x, seed):
    """``evict_stats`` inputs at their edges: row 0 without a free machine,
    30 % of the deadlines exactly start + e of a random machine, 10 % of
    them +inf."""
    import numpy as np
    import torch

    from repro_torch.core.eet import eet_at

    r = np.random.default_rng(seed)
    B, N = x["deadline"].shape
    M = x["start"].shape[1]
    dev = x["deadline"].device
    m = torch.as_tensor(r.integers(0, M, (B, N)), device=dev)
    exact = x["start"].gather(1, m) + eet_at(
        x["eet"], x["task_type"].long(), m)
    pick = torch.as_tensor(r.random((B, N)), device=dev)
    qfree = x["qfree"].clone()
    qfree[0] = False
    deadline = torch.where(pick < 0.3, exact, x["deadline"])
    deadline = torch.where(pick > 0.9, torch.full_like(deadline, np.inf),
                           deadline)
    return {**x, "qfree": qfree, "deadline": deadline.contiguous()}


def map_decide_args(x):
    return (x["now"], x["start"], x["p_dyn"], x["qfree"], x["eet"],
            x["deadline"], x["pending"], x["task_type"])


def evict_stats_args(x):
    return (x["start"], x["qfree"], x["eet"], x["deadline"], x["pending"],
            x["task_type"])


def phase1_args(x):
    from repro_torch.core.eet import type_rows

    return (x["start"], type_rows(x["eet"], x["task_type"].long()).contiguous(),
            x["deadline"], x["p_dyn"], x["pending"], x["qfree"])


def compare(outs_k, outs_p, what: str) -> float:
    """Raise unless every output is equal; return the max abs error."""
    import torch

    err = 0.0
    for i, (a, b) in enumerate(zip(outs_k, outs_p)):
        require(torch.equal(a, b), f"{what}: output {i} differs from plain")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def check_kernels(device) -> dict:
    """Every kernel against its plain version on the card, bit for bit."""
    import torch

    from repro_torch.kernels import map_fused, phase1_map
    from repro_torch.kernels.map_fused import ops as mf

    errs = {k: 0.0 for k in KERNEL_SOURCES}
    cases = 0
    for label, shape in (("main", MAIN_SHAPE), ("wide", WIDE_SHAPE),
                         *FLEET_SHAPES.items()):
        x = kernel_inputs(**shape, seed=11, device=device)
        for nom in mf.NOMINATOR_KINDS:
            for key in mf.KEY_KINDS:
                for drop in mf.DROP_KINDS:
                    for suff in (x["suffered"],
                                 torch.zeros_like(x["suffered"])):
                        kw = dict(nominator=nom, phase2_key=key,
                                  drop_rule=drop)
                        out_k = map_fused.map_decide(*map_decide_args(x),
                                                     suff, **kw)
                        torch.cuda.synchronize()
                        out_p = map_fused.map_decide_plain(
                            *map_decide_args(x), suff, **kw)
                        errs["map_decide"] = max(errs["map_decide"], compare(
                            out_k, out_p, f"map_decide {label} {kw}"))
                        cases += 1
        for case, xe in (("", x), (" edges", evict_edges(x, seed=12))):
            out_k = map_fused.evict_stats(*evict_stats_args(xe))
            torch.cuda.synchronize()
            errs["evict_stats"] = max(errs["evict_stats"], compare(
                out_k, map_fused.evict_stats_plain(*evict_stats_args(xe)),
                f"evict_stats {label}{case}"))
        out_k = phase1_map.phase1_map(*phase1_args(x))
        torch.cuda.synchronize()
        errs["phase1_map"] = max(errs["phase1_map"], compare(
            out_k, phase1_map.phase1_map_plain(*phase1_args(x)),
            f"phase1_map {label}"))
        cases += 3
        emit("kernels", shape=label, **shape, cases=cases, equal=True)
    # the router's calls: B = 1, N changing from call to call, fresh
    # outputs each time
    for N in ROUTER_N:
        x = router_inputs(N, seed=N, device=device)
        for nom, key, drop in itertools.product(
                mf.NOMINATOR_KINDS, mf.KEY_KINDS, mf.DROP_KINDS):
            kw = dict(nominator=nom, phase2_key=key, drop_rule=drop)
            out_k = map_fused.map_decide(*map_decide_args(x),
                                         x["suffered"], **kw)
            torch.cuda.synchronize()
            errs["map_decide"] = max(errs["map_decide"], compare(
                out_k, map_fused.map_decide_plain(*map_decide_args(x),
                                                  x["suffered"], **kw),
                f"map_decide router N={N} {kw}"))
        out_k = map_fused.evict_stats(*evict_stats_args(x))
        torch.cuda.synchronize()
        errs["evict_stats"] = max(errs["evict_stats"], compare(
            out_k, map_fused.evict_stats_plain(*evict_stats_args(x)),
            f"evict_stats router N={N}"))
        out_k = phase1_map.phase1_map(*phase1_args(x))
        torch.cuda.synchronize()
        errs["phase1_map"] = max(errs["phase1_map"], compare(
            out_k, phase1_map.phase1_map_plain(*phase1_args(x)),
            f"phase1_map router N={N}"))
    emit("kernels", shape="router", B=1, N=list(ROUTER_N), M=4, S=4,
         equal=True)
    return errs


def per_row_inputs(B, N, S, sites, seed, device, block: bool):
    """Map-kernel inputs for B * F site views, row ``b * F + f`` being site
    ``f`` of replicate ``b``, as the engine folds them. ``block``: each row
    holds its site's m machines and its own (S, m) EET and (m,) powers;
    otherwise each row holds all M machines, and the EET columns of the
    other sites read BIG (the powers stay shared)."""
    import numpy as np
    import torch

    from repro_torch.core.equations import BIG

    sites = np.asarray(sites)
    F, M = int(sites.max()) + 1, sites.size
    rows = B * F
    width = M // F if block else M
    x = kernel_inputs(rows, N, width, S, seed, device)
    r = np.random.default_rng(seed + 1)
    eet = np.round(r.uniform(0.5, 5.0, (F, S, width)) * 8) / 8
    eet[:, :, -1] = eet[:, :, 0]                     # tied columns
    if block:
        x["p_dyn"] = torch.as_tensor(np.tile(
            r.choice([1.5, 1.6, 3.0], (F, width)), (B, 1)).astype(np.float32),
            device=device)
    else:
        eet = np.where(sites[None, None, :] == np.arange(F)[:, None, None],
                       eet, BIG)
    x["eet"] = torch.as_tensor(np.tile(eet, (B, 1, 1)).astype(np.float32),
                               device=device)
    return x


def balance_inputs(B, N, F, density, loads, seed, device):
    """``balance_scan`` inputs: admissions at ``density``, targets on half
    the tasks (every task in the first half of the replicates, as for
    ``least_queued``), random homes, and loads all equal (every argmin a
    tie), small and random with some sites dead (+1,000,000), or from
    2^22 up ("wide": beyond the kernel's packed keys)."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    if loads == "equal":
        load0 = np.full((B, F), 3, np.int64)
    elif loads == "wide":
        load0 = r.integers(0, 6, (B, F)) + (1 << 22)
    else:
        load0 = r.integers(0, 6, (B, F)) \
            + 1_000_000 * (r.random((B, F)) < 0.25)
    target = r.random((B, N)) < 0.5
    target[: B // 2] = True
    arrays = (load0.astype(np.int64), r.random((B, N)) < density, target,
              r.integers(0, F, (B, N)).astype(np.int64))
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def check_federation_kernels(device, errs: dict) -> None:
    """``balance_scan`` and the per-row EET form of the map kernels against
    their plain versions on the card, bit for bit."""
    import torch

    from repro_torch.kernels import map_fused, phase1_map
    from repro_torch.kernels.map_fused import ops as mf

    cases = 0
    for shape in BALANCE_SHAPES:
        for loads, densities in BALANCE_LOADS.items():
            for density in densities:
                args = balance_inputs(**shape, density=density, loads=loads,
                                      seed=cases, device=device)
                got = map_fused.balance_scan(*args)
                torch.cuda.synchronize()
                errs["balance_scan"] = max(errs["balance_scan"], compare(
                    (got,), (map_fused.balance_scan_plain(*args),),
                    f"balance_scan {shape} {density} {loads}"))
                cases += 1
        emit("kernels", kernel="balance_scan", **shape,
             densities=list(BALANCE_DENSITIES), loads=list(BALANCE_LOADS),
             cases=cases, equal=True)
    for label, shape, block in (
            ("block_fold", BLOCK_ROWS, True),
            ("masked_fold", MASKED_ROWS, False),
            ("mixed_sites", MIXED_ROWS, False)):
        sites = shape.get("sites") or tuple(
            f for f in range(shape["F"]) for _ in range(shape["m"]))
        x = per_row_inputs(shape["B"], shape["N"], shape["S"], sites,
                           seed=17, device=device, block=block)
        n = 0
        for nom in mf.NOMINATOR_KINDS:
            for key in mf.KEY_KINDS:
                for drop in mf.DROP_KINDS:
                    for suff in (x["suffered"],
                                 torch.zeros_like(x["suffered"])):
                        kw = dict(nominator=nom, phase2_key=key,
                                  drop_rule=drop)
                        out_k = map_fused.map_decide(*map_decide_args(x),
                                                     suff, **kw)
                        torch.cuda.synchronize()
                        errs["map_decide"] = max(errs["map_decide"], compare(
                            out_k, map_fused.map_decide_plain(
                                *map_decide_args(x), suff, **kw),
                            f"map_decide {label} {kw}"))
                        n += 1
        for case, xe in (("", x), (" edges", evict_edges(x, seed=18))):
            out_k = map_fused.evict_stats(*evict_stats_args(xe))
            torch.cuda.synchronize()
            errs["evict_stats"] = max(errs["evict_stats"], compare(
                out_k, map_fused.evict_stats_plain(*evict_stats_args(xe)),
                f"evict_stats {label}{case}"))
        if label == "mixed_sites":      # ELARE's Phase I over the fold
            out_k = phase1_map.phase1_map(*phase1_args(x))
            torch.cuda.synchronize()
            errs["phase1_map"] = max(errs["phase1_map"], compare(
                out_k, phase1_map.phase1_map_plain(*phase1_args(x)),
                f"phase1_map {label}"))
            n += 1
        emit("kernels", shape=label, rows=int(x["eet"].shape[0]),
             N=shape["N"], M=int(x["eet"].shape[2]), eet=list(x["eet"].shape),
             cases=n + 2, equal=True)


# --------------------------------------------------------------------------
# Model kernels: flash attention, decode attention, the SSD scan
# --------------------------------------------------------------------------
def card_normal(gen, shape, dtype, scale=0.5):
    import torch

    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def bf16_attention_bound(plain, q, k, v):
    """Per element, how far a bf16 attention kernel may lie from the plain
    version ``plain(q, k, v)``. Both round a float32 output x to bf16 (at
    most 2^-8 |x| each); the tensor-core kernel also rounds each p to bf16
    before P.V, which moves an output by at most 2^-8 sum_j p_j |v_j| / l,
    the plain version on |v|; 2^-11 of that covers float32 sums in another
    order."""
    qf, kf, vf = q.float(), k.float(), v.float()
    return (2.0 ** -7 * plain(qf, kf, vf).abs()
            + (2.0 ** -8 + 2.0 ** -11) * plain(qf, kf, vf.abs()))


def ssd_inputs(gen, B, L, H, P, N, dtype):
    """``tests/test_kernels.py``'s distributions: x, B, C ~ 0.5 N(0, 1),
    dt = softplus(N(0, 1)), A = -exp(0.3 N(0, 1))."""
    import torch

    dt = torch.nn.functional.softplus(card_normal(gen, (B, L, H),
                                                  torch.float32, 1.0))
    A = -torch.exp(card_normal(gen, (H,), torch.float32, 0.3))
    return (card_normal(gen, (B, L, H, P), dtype), dt, A,
            card_normal(gen, (B, L, N), torch.float32),
            card_normal(gen, (B, L, N), torch.float32))


def bf16_ssd_bound(want):
    """Per element, how far the tensor-core scan's bf16 y may lie from the
    plain version's bf16 y ``want``: each is the bf16 rounding of a float32
    y (at most 2^-8 of it away), and the two float32 ys lie within the
    float32 tolerance of each other, so |got - want| <= 2^-7 |want| /
    (1 - 2^-8) + (1 + 2^-8) 2e-4. Where |want| < 4 one bf16 step is at most
    2^-6, and SSD_TOL's 2e-2 holds as well."""
    a = want.float().abs()
    return (2.0 ** -7 / (1 - 2.0 ** -8) * a
            + (1 + 2.0 ** -8) * SSD_TOL["float32"])


def ssd_bf16_on_tensor_cores(ssm_scan, args, chunk, got, want, report,
                             case) -> tuple:
    """How a bf16 x on the tensor-core route is held. The bf16 y against
    the plain version's bf16 y element by element: within
    ``bf16_ssd_bound`` everywhere and within SSD_TOL's 2e-2 wherever |y| <
    4 (further out a sum taken in another order lands on the neighbouring
    bf16 value now and then, one step of 2^-5 and more). The bf16 instance
    is the float32 instance on the same values (a bf16 x is exact in TF32)
    plus one round-to-nearest of y, so its y must also be exactly the bf16
    rounding of the float32 instance's y, and that float32 y is held within
    the float32 tolerance of the plain version's float32 y on the same
    values. The bf16 outputs that differ are reported. Returns the (got,
    want) pair of float32 y to hold."""
    import torch

    wide = (args[0].float(),) + tuple(args[1:])
    got32 = ssm_scan.ssm_scan(*wide, chunk=chunk)[0]
    want32 = ssm_scan.ssd_scan_plain(*wide, chunk=chunk)[0]
    torch.cuda.synchronize()
    require(torch.equal(got[0], got32.to(torch.bfloat16)),
            f"ssd_scan {case}: bf16 y is not the rounding of the float32 y")
    differ = got[0] != want[0]
    diff = (got[0].float() - want[0].float()).abs()
    near = want[0].float().abs() < 4
    ratio = float((diff / bf16_ssd_bound(want[0])).max())
    near_err = float(torch.where(near, diff, 0.0).max())
    require(ratio <= 1.0 and near_err <= SSD_TOL["bfloat16"],
            f"ssd_scan {case}: bf16 y at {ratio} of its per-element bound, "
            f"{near_err} from the plain version where |y| < 4 (tolerance "
            f"{SSD_TOL['bfloat16']})")
    report.append({"case": list(case[:6]),
                   "bf16_y_differing_from_plain": int(differ.sum()),
                   "of": int(differ.numel()),
                   "max_abs_diff": float(diff.max()),
                   "max_abs_diff_where_abs_y_below_4": near_err,
                   "max_share_of_bf16_bound": ratio,
                   "max_abs_y_where_differing": float(
                       (want[0].float().abs() * differ).max()),
                   "f32_y_max_abs_err": float(
                       (got32 - want32).abs().max())})
    return (got32,), (want32,)


def check_model_kernels(device, errs: dict) -> None:
    """The three model kernels against their plain versions on the card,
    float32 and bfloat16, within the stated tolerances."""
    import torch

    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import ssm_scan

    gen = torch.Generator(device=device).manual_seed(13)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def record(name, got, want, tol, case, bound=None):
        """Max abs error within tol, and with a bound (bf16 attention)
        every element within it; returns the error."""
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        ratio = 0.0 if bound is None else float(
            ((got[0].float() - want[0].float()).abs() / bound).max())
        require(err <= tol and ratio <= 1.0,
                f"{name} {case}: max abs err {err} (tolerance {tol}), "
                f"{ratio} of the per-element bf16 bound")
        errs[name] = max(errs[name], err)
        worst_ratio[name] = max(worst_ratio.get(name, 0.0), ratio)
        return err

    def attention_bound(plain, q, k, v):
        return None if q.dtype != torch.bfloat16 else \
            bf16_attention_bound(plain, q, k, v)

    for dname, dt in dtypes.items():
        worst = {k: 0.0 for k in ("flash_attention", "decode_attention",
                                  "ssd_scan")}
        worst_ratio = {}
        routes, ssd_bf16_outputs = {}, []
        for (B, Sq, Sk, H, Hkv, hd, causal, off, lens), qk_scale in \
                itertools.product(FLASH_CASES, QK_SCALES[dname]):
            q = card_normal(gen, (B, Sq, H, hd), dt, qk_scale)
            k = card_normal(gen, (B, Sk, Hkv, hd), dt, qk_scale)
            v = card_normal(gen, (B, Sk, Hkv, hd), dt)
            kv_len = None if lens is None else torch.randint(
                1, Sk + 1, (B,), generator=gen, device=device,
                dtype=torch.int32)
            if lens == "zero":
                kv_len[0] = 0
            kw = dict(causal=causal, kv_len=kv_len, q_offset=off)

            def plain(q, k, v, kw=kw):
                return flash_attention.flash_attention_plain(q, k, v, **kw)

            worst["flash_attention"] = max(worst["flash_attention"], record(
                "flash_attention", (flash_attention.flash_attention(
                    q, k, v, **kw),), (plain(q, k, v),),
                ATTN_TOL[dname], (B, Sq, Sk, H, Hkv, hd, causal, off,
                                  lens, qk_scale, dname),
                attention_bound(plain, q, k, v)))
        for B, Sk, H, Hkv, hd in DECODE_CASES:
            q = card_normal(gen, (B, 1, H, hd), dt)
            k = card_normal(gen, (B, Sk, Hkv, hd), dt)
            v = card_normal(gen, (B, Sk, Hkv, hd), dt)
            kv_len = torch.randint(max(1, Sk - SERVE_NEW), Sk + 1, (B,),
                                   generator=gen, device=device,
                                   dtype=torch.int32) \
                if Sk == SERVE_MAX_SEQ else torch.randint(
                    1, Sk, (B,), generator=gen, device=device,
                    dtype=torch.int32)
            plain = partial(decode_attention.decode_attention_plain,
                            kv_len=kv_len)
            worst["decode_attention"] = max(worst["decode_attention"], record(
                "decode_attention",
                (decode_attention.decode_attention(q, k, v, kv_len),),
                (plain(q, k, v),), ATTN_TOL[dname],
                (B, Sk, H, Hkv, hd, dname), attention_bound(plain, q, k, v)))
        for B, Sk, H, Hkv, hd in DECODE_SPLIT_CASES:
            q = card_normal(gen, (B, 1, H, hd), dt)
            k = card_normal(gen, (B, Sk, Hkv, hd), dt)
            v = card_normal(gen, (B, Sk, Hkv, hd), dt)
            c = -(-(-(-Sk // 8)) // 8) * 8          # keys per block
            kv_len = torch.tensor([0, 1, c, c + 1, 2 * c, 7 * c + 1, Sk - 1,
                                   Sk][:B], dtype=torch.int32, device=device)
            plain = partial(decode_attention.decode_attention_plain,
                            kv_len=kv_len)
            worst["decode_attention"] = max(worst["decode_attention"], record(
                "decode_attention",
                (decode_attention.decode_attention(q, k, v, kv_len),),
                (plain(q, k, v),), ATTN_TOL[dname],
                (B, Sk, H, Hkv, hd, "split", dname),
                attention_bound(plain, q, k, v)))
        for B, L, H, P, N, chunk in SSD_CASES:
            args = ssd_inputs(gen, B, L, H, P, N, dt)
            route = "ssd_scan_tc" if ssm_scan.tensor_core_route(
                min(chunk, L), N, P) else "ssd_scan"
            before = dict(ssm_scan.LAUNCHES)
            got = ssm_scan.ssm_scan(*args, chunk=chunk)
            want = ssm_scan.ssd_scan_plain(*args, chunk=chunk)
            case = (B, L, H, P, N, chunk, dname, route)
            require({k: v - before[k] for k, v in ssm_scan.LAUNCHES.items()}
                    == {k: int(k == route) for k in before},
                    f"ssd_scan {case}: not one launch on its route")
            if route == "ssd_scan_tc" and dt == torch.bfloat16:
                worst["ssd_scan"] = max(worst["ssd_scan"], record(
                    "ssd_scan", *ssd_bf16_on_tensor_cores(
                        ssm_scan, args, chunk, got, want, ssd_bf16_outputs,
                        case), SSD_TOL["float32"], case))
            else:
                worst["ssd_scan"] = max(worst["ssd_scan"], record(
                    "ssd_scan", got[:1], want[:1], SSD_TOL[dname], case))
            record("ssd_scan", got[1:], want[1:], SSD_TOL["float32"], case)
            routes[f"{B}x{L}x{H}x{P} N{N} Q{chunk}"] = route
        # The serve path passes B and C in bf16, exact in TF32: the kernel
        # then leaves out the products of their zero lo parts, which must
        # change no bit against the same values given as float32.
        x, dts_, A, Bm, Cm = ssd_inputs(gen, *SSD_CASES[-1][:5], dt)
        Bh, Ch = Bm.bfloat16(), Cm.bfloat16()
        got = ssm_scan.ssm_scan(x, dts_, A, Bh, Ch, chunk=SSD_CASES[-1][5])
        same = ssm_scan.ssm_scan(x, dts_, A, Bh.float(), Ch.float(),
                                 chunk=SSD_CASES[-1][5])
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, same)),
                f"ssd_scan {dname}: bf16 B and C differ from their float32 "
                f"values")
        emit("model_kernels", dtype=dname, max_abs_err=worst,
             tolerance={"attention": ATTN_TOL[dname],
                        "ssd_scan": SSD_TOL[dname]},
             max_share_of_bf16_bound=worst_ratio or None,
             cases={"flash_attention": len(FLASH_CASES)
                    * len(QK_SCALES[dname]),
                    "decode_attention": len(DECODE_CASES)
                    + len(DECODE_SPLIT_CASES),
                    "ssd_scan": len(SSD_CASES)},
             ssd_routes=routes,
             ssd_tensor_core_bf16_outputs=ssd_bf16_outputs or None,
             ssd_bf16_bc_bit_for_bit_with_float32_bc=True)


# --------------------------------------------------------------------------
# Main path and its parity
# --------------------------------------------------------------------------
def launch_counters() -> tuple:
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import ssm_scan
    from repro_torch.kernels.map_fused import ops as mf
    from repro_torch.kernels.phase1_map import ops as p1

    return (mf.LAUNCHES, p1.LAUNCHES, flash_attention.LAUNCHES,
            decode_attention.LAUNCHES, ssm_scan.LAUNCHES)


def reset_counts():
    from repro_torch.core import engine

    for d in (*launch_counters(), engine.COUNTS):
        for k in d:
            d[k] = 0


def read_counts() -> dict:
    return {k: v for d in launch_counters() for k, v in d.items()}


def summarize(result, run_name: str, phase: str = "main") -> None:
    import numpy as np

    m = result.metrics
    n_tasks = result.spec.n_tasks
    total = (m.completed_by_type + m.missed_by_type
             + m.cancelled_by_type).sum(-1)
    require(bool(np.all(total == n_tasks))
            and bool(np.all(m.arrived_by_type.sum(-1) == n_tasks)),
            f"{run_name}: tasks not conserved")
    for leaf in (m.energy_dynamic, m.energy_wasted, m.energy_idle,
                 m.makespan):
        require(bool(np.all(np.isfinite(leaf))), f"{run_name}: non-finite")
    for h_i, h in enumerate(result.heuristics):
        info = result.run_info[h]
        emit(phase, run=run_name, heuristic=h, seconds=info["seconds"],
             event_steps=info["loop_iterations"],
             ms_per_iteration=info["seconds"] * 1e3
             / max(info["loop_iterations"], 1),
             rates=list(result.rates),
             completion_rate=[float(v) for v in result.completion_rate[h_i]],
             worst_type_rate=[float(v) for v in result.worst_type_rate[h_i]],
             wasted_pct=[float(v) for v in result.wasted_pct[h_i]])


def same_counts(a, b, what: str, energy_rel=None) -> None:
    import numpy as np

    for k in ("completed_by_type", "missed_by_type", "cancelled_by_type",
              "arrived_by_type"):
        require(np.array_equal(getattr(a, k), getattr(b, k)),
                f"{what}: {k} differs")
    if energy_rel is None:
        require(np.array_equal(a.makespan, b.makespan),
                f"{what}: makespan differs")
        return
    for k in ("energy_dynamic", "energy_wasted", "energy_idle", "makespan"):
        x = np.asarray(getattr(a, k), np.float64)
        y = np.asarray(getattr(b, k), np.float64)
        rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-30)
        require(bool(np.all(rel <= energy_rel)),
                f"{what}: {k} off by rel {float(rel.max())}")


def run_main_path(device, reps: int, n_tasks: int) -> tuple:
    """The flat sweep on the kernels, then its parity runs; returns the
    launch counts, the traces and the fused sweep's result."""
    import numpy as np

    from repro_torch import scenarios
    from repro_torch.core import api
    from repro_torch.core.types import Metrics, Trace
    from repro_torch.experiments import SweepSpec, run_sweep

    system = api.paper_system()
    traces = scenarios.DEFAULT.stack(0, RATES, reps, n_tasks, system.eet,
                                     device=device)
    fused = SweepSpec(system="paper", rates=RATES, reps=reps,
                      n_tasks=n_tasks, heuristics=("ELARE", "FELARE", "MM"),
                      seed=0, use_fused_map=True)
    phase1 = SweepSpec(system="paper", rates=RATES, reps=reps,
                       n_tasks=n_tasks, heuristics=("ELARE",), seed=0,
                       use_fused_phase1=True)

    reset_counts()
    res_fused = run_sweep(fused, traces=traces, device=device)
    res_p1 = run_sweep(phase1, traces=traces, device=device)
    counts = read_counts()
    summarize(res_fused, "fused_map")
    summarize(res_p1, "fused_phase1")
    steps = {h: res_fused.run_info[h]["loop_iterations"]
             for h in fused.heuristics}
    expect = {"map_decide": sum(steps.values()),
              "evict_stats": steps["FELARE"],
              "phase1_map": res_p1.run_info["ELARE"]["loop_iterations"],
              "balance_scan": 0}
    emit("main", launches=counts, expected=expect)
    for k, v in expect.items():
        require(counts[k] == v and (v > 0 or k == "balance_scan"),
                f"{k}: {counts[k]} launches, {v} batched events")

    # -- parity: plain path on the card, same traces (FELARE's plain run
    # carries the observers and is held in observe_parity) ----------------
    others = [i for i, h in enumerate(fused.heuristics) if h != "FELARE"]
    plain = run_sweep(SweepSpec(system="paper", rates=RATES, reps=reps,
                                n_tasks=n_tasks, seed=0,
                                heuristics=tuple(fused.heuristics[i]
                                                 for i in others)),
                      traces=traces, device=device)
    same_counts(Metrics(*(x[others] for x in res_fused.metrics)),
                plain.metrics, "fused vs plain (card)")
    same_counts(res_p1.metrics, Metrics(*(x[:1] for x in plain.metrics)),
                "phase1 vs plain (card)")

    # -- parity: a 2 x 2 subset through the port on the CPU ----------------
    sub = Trace(*(x[:2, :2].cpu() for x in traces))
    cpu = run_sweep(SweepSpec(system="paper", rates=RATES[:2], reps=2,
                              n_tasks=n_tasks, heuristics=fused.heuristics,
                              seed=0, use_fused_map=True),
                    traces=sub, device="cpu")
    card_sub = Metrics(*(x[:, :2, :2] for x in res_fused.metrics))
    same_counts(cpu.metrics, card_sub, "card vs CPU subset", energy_rel=1e-5)
    emit("parity", plain_on_card="identical counters and makespans "
                                 "(FELARE: observe_parity)",
         cpu_subset="identical counters, energies within rel 1e-5",
         plain_seconds={h: plain.run_info[h]["seconds"]
                        for h in plain.heuristics},
         cpu_cells=int(np.prod(cpu.metrics.makespan.shape)))
    return counts, traces, res_fused


def run_federated_path(device, reps: int, system: str) -> tuple:
    """The federated sweeps of ``system`` on the fused kernels: paper_x8
    (block fold) with FELARE + fair_spill and ELARE + least_queued, or
    tiered_x4 (masked fold) with FELARE + least_queued. Each run's launch
    counts, zeroed just before it, must show one map_decide and one
    balance_scan per batched event, whatever the site count. Then the
    parity of the FELARE run with the plain path on the card and, for
    paper_x8, with the CPU. Returns the launch counts, the traces and
    the paper_x8 FELARE + fair_spill result on the card's 2 x 2 subset
    (paper_x8) or the FELARE result (tiered_x4)."""
    from repro_torch.core.types import Trace
    from repro_torch.experiments import SweepSpec, run_sweep

    def sweep(system, rates, n_reps, n_tasks, heuristic, dispatcher,
              traces, fused=True, dev=device):
        return run_sweep(SweepSpec(
            system=system, rates=rates, reps=n_reps, n_tasks=n_tasks,
            heuristics=(heuristic,), seed=0, use_fused_map=fused,
            dispatcher=dispatcher), traces=traces, device=dev)

    cfg, runs = {
        "paper_x8": (("paper_x8", FED_RATES, reps, FED_TASKS),
                     (("FELARE", "fair_spill"), ("ELARE", "least_queued"))),
        "tiered_x4": (("tiered_x4", TIER_RATES, TIER_REPS, TIER_TASKS),
                      (("FELARE", "least_queued"),)),
    }[system]
    traces = stack_traces(device, *cfg)
    total, fused = {}, {}
    for h, d in runs:
        label = f"{system} {h} {d}"
        reset_counts()
        res = sweep(*cfg, h, d, traces)
        counts = read_counts()
        summarize(res, label, phase="fed")
        steps = res.run_info[h]["loop_iterations"]
        expect = {"map_decide": steps, "balance_scan": steps,
                  "evict_stats": steps if h == "FELARE" else 0,
                  "phase1_map": 0}
        emit("fed", run=label, launches=counts, expected=expect)
        require(steps > 0, f"{label}: no batched event")
        for k, v in expect.items():
            require(counts[k] == v,
                    f"{label}: {k}: {counts[k]} launches, {v} expected")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        fused[label] = res

    # -- parity: plain path on the card, same traces ----------------------
    label = f"{system} FELARE {runs[0][1]}"
    plain = sweep(*cfg, "FELARE", runs[0][1], traces, fused=False)
    same_counts(fused[label].metrics, plain.metrics,
                f"{label}: fused vs plain (card)")
    parity = dict(plain_on_card="identical counters and makespans",
                  plain_seconds={label: plain.run_info["FELARE"]["seconds"]})
    if system == "tiered_x4":
        emit("fed_parity", **parity)
        return total, traces, fused[label]

    # -- parity: a 2 x 2 subset, each trace cut short, on the CPU ----------
    sub = Trace(*(x[:2, :2, :CPU_SUBSET_TASKS] for x in traces))
    cfg = ("paper_x8", FED_RATES[:2], 2, CPU_SUBSET_TASKS)
    card = sweep(*cfg, "FELARE", "fair_spill", sub)
    cpu = sweep(*cfg, "FELARE", "fair_spill",
                Trace(*(x.cpu() for x in sub)), dev="cpu")
    same_counts(cpu.metrics, card.metrics, "fed: card vs CPU subset",
                energy_rel=1e-5)
    emit("fed_parity", **parity,
         cpu_subset="identical counters, energies within rel 1e-5",
         cpu_subset_shape={"rates": list(cfg[1]), "reps": 2,
                           "tasks": CPU_SUBSET_TASKS},
         cpu_seconds=cpu.run_info["FELARE"]["seconds"])
    return total, traces, card


def stack_traces(device, system: str, rates, reps: int, n_tasks: int):
    """The smoke's traces of ``system``: seed 0, (rates, reps) on the
    card. Every group's process draws the same ones."""
    from repro_torch import scenarios

    eet = scenarios.get_fleet(system).build().eet
    return scenarios.DEFAULT.stack(0, rates, reps, n_tasks, eet,
                                   device=device)


# --------------------------------------------------------------------------
# Observers on the kernel path
# --------------------------------------------------------------------------
def check_observed(what: str, metrics, aux: dict) -> None:
    """What the observers report agrees with the Metrics of the same run:
    the task log's final statuses count the Metrics' completions, misses
    and cancellations, the timeline's last bucket holds the final
    counters, every started task has a machine, rates lie in [0, 1]."""
    import numpy as np

    log = aux.get("task_log")
    if log is not None:
        status = log["status"]
        for code, k in ((4, "completed_by_type"), (5, "missed_by_type"),
                        (6, "cancelled_by_type")):
            require(np.array_equal((status == code).sum(-1),
                                   getattr(metrics, k).sum(-1)),
                    f"{what}: task_log statuses {code} != {k}")
        started = log["start_time"] >= 0
        require(bool(np.all((log["machine"] >= 0) == started)),
                f"{what}: a started task without a machine, or the reverse")
        require(bool(np.all(log["end_time"][started]
                            >= log["start_time"][started])),
                f"{what}: a task ended before it started")
    tl = aux.get("timeline")
    if tl is not None:
        require(np.array_equal(tl["completed"][..., -1, :],
                               metrics.completed_by_type)
                and np.array_equal(tl["arrived"][..., -1, :],
                                   metrics.arrived_by_type),
                f"{what}: the timeline's last bucket is not the final state")
        require(bool(np.all(np.diff(tl["e_dyn"], axis=-1) >= 0)),
                f"{what}: cumulative dynamic energy falls")
    ft = aux.get("fairness_trajectory")
    if ft is not None:
        require(bool(np.all((ft["cr"] >= 0) & (ft["cr"] <= 1))),
                f"{what}: a completion rate outside [0, 1]")


def same_aux(a: dict, b: dict, what: str, energy_rel=None) -> None:
    """Every aux leaf identical; with ``energy_rel``, float leaves that
    carry energies within that relative distance instead."""
    import numpy as np

    require(set(a) == set(b), f"{what}: observers differ")
    for name in a:
        require(set(a[name]) == set(b[name]), f"{what}: {name} leaves differ")
        for leaf, x in a[name].items():
            y = b[name][leaf]
            if energy_rel is not None and leaf.startswith(("e_", "site_e_")):
                x64 = np.asarray(x, np.float64)
                y64 = np.asarray(y, np.float64)
                rel = np.abs(x64 - y64) / np.maximum(np.abs(y64), 1e-30)
                require(bool(np.all(rel <= energy_rel)),
                        f"{what}: {name}.{leaf} off by rel {rel.max()}")
            else:
                require(x.dtype == y.dtype and np.array_equal(x, y),
                        f"{what}: {name}.{leaf} differs")


def run_observed_path(device, traces, res_fused, n_tasks: int) -> dict:
    """The flat paper-scale FELARE sweep on the kernels with all four
    observers (the energy budget unset): the Metrics must be the
    unobserved run's and the launch counts must show both map kernels on
    every batched event. Then once more with a battery of half the mean
    total energy, which must halt replicates and raise the share of
    their admitted tasks cancelled. Then the plain path on the card
    (every aux leaf identical) and a 2 x 2 subset on the CPU. Returns the
    launch counts of the two observed runs and what the parity runs
    found."""
    import numpy as np

    from repro_torch.core import observe
    from repro_torch.core.types import Metrics, Trace
    from repro_torch.experiments import SweepSpec, run_sweep

    def spec(observers, fused=True, rates=RATES, reps=None):
        return SweepSpec(system="paper", rates=rates,
                         reps=reps or traces.arrival.shape[1],
                         n_tasks=n_tasks, heuristics=("FELARE",), seed=0,
                         use_fused_map=fused, observers=observers)

    h = res_fused.heuristics.index("FELARE")
    unobserved = Metrics(*(x[h:h + 1] for x in res_fused.metrics))
    reset_counts()
    obs = run_sweep(spec(OBSERVERS), traces=traces, device=device)
    counts = read_counts()
    summarize(obs, "observed fused_map", phase="observe")
    for a, b, k in zip(obs.metrics, unobserved, Metrics._fields):
        require(np.array_equal(a, b), f"observed vs unobserved: {k} differs")
    steps = obs.run_info["FELARE"]["loop_iterations"]
    expect = {"map_decide": steps, "evict_stats": steps, "phase1_map": 0,
              "balance_scan": 0}
    require(steps > 0, "observed: no batched event")
    for k, v in expect.items():
        require(counts[k] == v, f"observed: {k}: {counts[k]} launches, "
                                f"{v} batched events")
    check_observed("observed", obs.metrics, obs.aux)
    require(not bool(np.any(obs.aux["energy_budget"]["exhausted"])),
            "an unset budget halted a replicate")

    # -- the same traces on a battery of half the mean total energy --------
    total = obs.metrics.energy_dynamic + obs.metrics.energy_idle
    capacity = 0.5 * float(np.mean(total))
    budget = observe.EnergyBudget(capacity=capacity)
    reset_counts()
    cut = run_sweep(spec((budget, "task_log")), traces=traces, device=device)
    budget_counts = read_counts()
    check_observed("budget", cut.metrics, cut.aux)
    eb = cut.aux["energy_budget"]
    halted = eb["exhausted"]
    m = cut.metrics
    require(bool(np.any(halted)), "budget: no replicate halted")
    # A halted replicate admits no more arrivals, which then count neither
    # as arrived nor as cancelled: its share of admitted tasks cancelled
    # is what the halt raises.
    def cancelled_share(metrics):
        c = metrics.cancelled_by_type.sum(-1)[halted]
        return float(c.sum() / metrics.arrived_by_type.sum(-1)[halted].sum())

    cancelled = (int(m.cancelled_by_type.sum()),
                 int(obs.metrics.cancelled_by_type.sum()))
    share = (cancelled_share(m), cancelled_share(obs.metrics))
    require(share[0] > share[1],
            f"budget: the halted replicates cancelled {share[0]} of their "
            f"admitted tasks, {share[1]} unbudgeted")
    require(np.array_equal(m.completed_by_type + m.missed_by_type
                           + m.cancelled_by_type, m.arrived_by_type),
            "budget: admitted tasks not conserved")
    require(bool(np.all(eb["t_exhausted"][halted] <= m.makespan[halted])),
            "budget: exhausted after the last event")
    t_ex = eb["t_exhausted"][halted]
    emit("observe", run="observed fused_map",
         observers=[o if isinstance(o, str) else o.name for o in OBSERVERS],
         launches=counts, expected=expect,
         seconds=obs.run_info["FELARE"]["seconds"],
         unobserved_seconds=res_fused.run_info["FELARE"]["seconds"],
         loop_iterations=steps,
         unobserved_loop_iterations=res_fused.run_info["FELARE"][
             "loop_iterations"],
         metrics="identical to the unobserved run")
    emit("observe", run="energy_budget", capacity=capacity,
         replicates=int(halted.size), halted=int(halted.sum()),
         t_exhausted={"min": float(t_ex.min()),
                      "median": float(np.median(t_ex)),
                      "max": float(t_ex.max())},
         cancelled=cancelled[0], unbudgeted_cancelled=cancelled[1],
         halted_cancelled_share=share[0],
         unbudgeted_cancelled_share=share[1],
         completed=int(m.completed_by_type.sum()),
         unbudgeted_completed=int(obs.metrics.completed_by_type.sum()),
         seconds=cut.run_info["FELARE"]["seconds"],
         loop_iterations=cut.run_info["FELARE"]["loop_iterations"],
         launches=budget_counts)

    # -- parity: the plain path on the card, every aux leaf identical, and
    # the Metrics (this is the flat FELARE run's fused-vs-plain check) ----
    plain = run_sweep(spec(OBSERVERS, fused=False), traces=traces,
                      device=device)
    for a, b, k in zip(obs.metrics, plain.metrics, Metrics._fields):
        require(np.array_equal(a, b), f"observed fused vs plain: {k}")
    same_aux(obs.aux, plain.aux, "observed fused vs plain (card)")

    # -- parity: a 2 x 2 subset through the port on the CPU ----------------
    sub = Trace(*(x[:2, :2].cpu() for x in traces))
    cpu = run_sweep(spec(OBSERVERS, rates=RATES[:2], reps=2), traces=sub,
                    device="cpu")
    card_sub = observe.tree_map(lambda x: x[:, :2, :2], obs.aux)
    same_aux(cpu.aux, card_sub, "observed card vs CPU subset",
             energy_rel=1e-5)
    parity = dict(
        flat_plain_on_card="every aux leaf and Metrics field identical "
                           "(FELARE, all four observers)",
        flat_cpu_subset="task_log and fairness_trajectory identical, "
                        "energies within rel 1e-5",
        flat_plain_seconds=plain.run_info["FELARE"]["seconds"],
        flat_cpu_seconds=cpu.run_info["FELARE"]["seconds"])
    return {k: counts[k] + budget_counts[k] for k in counts}, parity


def run_observed_federation(device, traces, reps: int) -> dict:
    """paper_x8 FELARE + fair_spill on the kernels (balance_scan on the
    card) with ``task_log`` and the per-site timeline, on the first
    ``reps`` replicates of the federated path's traces, each cut to its
    first ``OBS_FED_TASKS`` tasks. The launch counts must show all three
    kernels on every batched event, the final ``task_log.site`` must be
    the engine's final ``SimState.site``, and the plain path on the card
    must give every aux leaf identical. Returns the launch counts, what
    the parity run found and the observed sweep's result."""
    import numpy as np
    import torch

    from repro_torch import scenarios
    from repro_torch.core import dispatch, engine, observe, policy
    from repro_torch.core.types import Trace
    from repro_torch.experiments import SweepSpec, run_sweep

    observers = ("task_log", observe.Timeline(per_site=True))
    sub = Trace(*(x[:, :reps, :OBS_FED_TASKS] for x in traces))
    reset_counts()
    res = run_sweep(SweepSpec(
        system="paper_x8", rates=FED_RATES, reps=reps, n_tasks=OBS_FED_TASKS,
        heuristics=("FELARE",), seed=0, use_fused_map=True,
        dispatcher="fair_spill", observers=observers), traces=sub,
        device=device)
    counts = read_counts()
    summarize(res, "paper_x8 FELARE fair_spill observed",
              phase="observe_fed")
    steps = res.run_info["FELARE"]["loop_iterations"]
    expect = {"map_decide": steps, "balance_scan": steps,
              "evict_stats": steps, "phase1_map": 0}
    require(steps > 0, "observed federation: no batched event")
    for k, v in expect.items():
        require(counts[k] == v, f"observed federation: {k}: {counts[k]} "
                                f"launches, {v} expected")
    check_observed("observed paper_x8", res.metrics, res.aux)

    # -- the plain path on the card, its final state kept ------------------
    system = scenarios.get_fleet("paper_x8").build()
    flat = Trace(*(x.reshape((-1,) + x.shape[2:]) for x in sub))
    t0 = time.perf_counter()
    run = engine._make_loop(
        policy.get("FELARE"), system.as_torch(device),
        queue_size=system.queue_size,
        fairness_factor=float(system.fairness_factor),
        dispatcher=dispatch.resolve("fair_spill"),
        site_of_machine=system.site_of_machine, observers=observers)
    st, aux = run(engine._to_device(flat, device))
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    plain = observe.tree_map(
        lambda x: x.cpu().numpy().reshape(
            (1, len(FED_RATES), reps) + tuple(x.shape[1:])), aux)
    same_aux(res.aux, plain, "observed paper_x8 fused vs plain (card)")
    site = res.aux["task_log"]["site"].reshape(-1, OBS_FED_TASKS)
    require(np.array_equal(site, st.site.cpu().numpy()),
            "task_log.site is not the engine's final SimState.site")
    emit("observe_fed", run="paper_x8 FELARE fair_spill observed",
         observers=["task_log", "timeline (per_site)"], reps=reps,
         tasks=OBS_FED_TASKS,
         launches=counts, expected=expect,
         seconds=res.run_info["FELARE"]["seconds"],
         loop_iterations=steps, plain_seconds=plain_seconds,
         sites=int(res.aux["timeline"]["site_qlen"].shape[-1]),
         final_site="task_log.site equals SimState.site")
    return counts, {"fed_plain_on_card": "every aux leaf identical "
                                         "(task_log, per-site timeline)",
                    "fed_plain_seconds": plain_seconds}, res


# --------------------------------------------------------------------------
# Machine faults on the kernel path
# --------------------------------------------------------------------------
def fault_dynamics(kind: str):
    """The smoke's machine dynamics, from fixed parameters."""
    from repro_torch.core import faults

    return {"outage": faults.SiteOutage(outages=FAULT_OUTAGES),
            "churn": faults.BernoulliUpDown(**FAULT_CHURN),
            "straggler": faults.Degrade(**FAULT_STRAGGLER)}[kind]


def fault_spec(run: tuple, rates, reps: int, n_tasks: int, fused=True):
    from repro_torch.experiments import SweepSpec

    _, system, heuristic, dispatcher, kind, observers, kernels = run
    return SweepSpec(system=system, rates=rates, reps=reps, n_tasks=n_tasks,
                     heuristics=(heuristic,), seed=0, dispatcher=dispatcher,
                     dynamics=fault_dynamics(kind), observers=observers,
                     use_fused_map=fused and kernels == "map",
                     use_fused_phase1=fused and kernels == "phase1")


def fault_expected(run: tuple, steps: int) -> dict:
    """Launches a faulted run must show: each kernel of its path on
    every batched event."""
    _, _, heuristic, dispatcher, _, _, kernels = run
    if kernels == "phase1":
        return {"map_decide": 0, "evict_stats": 0, "balance_scan": 0,
                "phase1_map": steps}
    walks = dispatcher in ("health_aware", "fair_spill", "least_queued")
    return {"map_decide": steps, "evict_stats": steps,
            "balance_scan": steps if walks else 0, "phase1_map": 0}


def check_outage(res, traces) -> dict:
    """The outage run against its windows: no task starts on a machine of
    a site inside that site's window (every task orphaned never, whose
    one start the task log holds), retries within ``max_retries + 1``,
    and the health series with no healthy machine of a site in buckets
    inside its window, all healthy in buckets clear of it, and every
    other site whole throughout."""
    import numpy as np

    from repro_torch import scenarios

    system = scenarios.get_fleet("paper_x8").build()
    sites = np.asarray(system.site_of_machine)
    m = int((sites == 0).sum())
    log = {k: v.reshape((-1,) + v.shape[3:])
           for k, v in res.aux["task_log"].items()}
    hl = {k: v.reshape((-1,) + v.shape[3:])
          for k, v in res.aux["health"].items()}
    horizon = traces.deadline.reshape(len(log["status"]), -1).amax(1)
    horizon = horizon.cpu().numpy()
    ran = log["machine"] >= 0
    once = ran & (log["retries"] == 0)
    started = log["start_time"]
    run_site = sites[np.maximum(log["machine"], 0)]
    bad = 0
    width = horizon * np.float32(1.0 / hl["t"].shape[1])
    hi = hl["t"]
    lo = hi - width[:, None]
    for s, a, b in FAULT_OUTAGES:
        t0 = (np.float32(a) * horizon)[:, None]
        t1 = (np.float32(b) * horizon)[:, None]
        bad += int((once & (run_site == s) & (started >= t0)
                    & (started < t1)).sum())
        # one bucket of margin against the rounding of the edges
        w = width[:, None]
        inside = (lo >= t0 + w) & (hi <= t1 - w)
        clear = (hi <= t0 - w) | (lo >= t1 + w)
        require(bool(np.all(hl["site_healthy"][..., s][inside] == 0)),
                f"outage: site {s} has a healthy machine in its window")
        require(bool(np.all(hl["site_healthy"][..., s][clear] == m)),
                f"outage: site {s} short of machines outside its window")
        require(bool(inside.any()) and bool(clear.any()),
                f"outage: no bucket inside or clear of site {s}'s window")
    require(bad == 0, f"outage: {bad} tasks started in their site's window")
    others = [f for f in range(system.n_sites)
              if f not in {s for s, _, _ in FAULT_OUTAGES}]
    require(bool(np.all(hl["site_healthy"][..., others] == m)),
            "outage: a site without a window lost a machine")
    retries = log["retries"]
    max_retries = fault_dynamics("outage").max_retries
    require(int(retries.max()) <= max_retries + 1
            and int(retries[log["status"] != 6].max(initial=0))
            <= max_retries, f"outage: retries {int(retries.max())}")
    require(int(retries.sum()) > 0, "outage: nothing was orphaned")
    return {"tasks_checked": int(once.sum()),
            "orphans": int(retries.sum()),
            "retried_tasks": int((retries > 0).sum()),
            "max_retries_seen": int(retries.max()),
            "cancelled_by_exhaustion": int(((retries > max_retries)
                                            & (log["status"] == 6)).sum())}


def fault_inputs(device, flat_traces, x8_traces) -> tuple:
    """The faulted runs' traces, tasks per trace and rates by system: the
    first ``FAULT_REPS`` replicates of the flat and paper_x8 traces cut
    to ``FAULT_TASKS``, paper_x2's drawn at ``FAULT_BACKUP_TASKS``; with
    ``with_backup(FELARE, 1)`` registered as ``FAULT_BACKUP``."""
    from repro_torch.core import faults, policy
    from repro_torch.core.types import Trace

    policy.register(FAULT_BACKUP, faults.with_backup("FELARE", 1),
                    overwrite=True)
    x2_rates = tuple(2 * r for r in RATES)
    traces = {
        "paper": Trace(*(x[:, :FAULT_REPS, :FAULT_TASKS]
                         for x in flat_traces)),
        "paper_x8": Trace(*(x[:, :FAULT_REPS, :FAULT_TASKS]
                            for x in x8_traces)),
        "paper_x2": stack_traces(device, "paper_x2", x2_rates, FAULT_REPS,
                                 FAULT_BACKUP_TASKS),
    }
    tasks = {"paper": FAULT_TASKS, "paper_x8": FAULT_TASKS,
             "paper_x2": FAULT_BACKUP_TASKS}
    rates = {"paper": RATES, "paper_x2": x2_rates, "paper_x8": FED_RATES}
    return traces, tasks, rates


def run_faults_path(device, flat_traces, x8_traces, fed_refs) -> dict:
    """The faulted sweeps on the kernels (see :data:`FAULT_RUNS`), each
    run's launch counts zeroed just before it and held to one launch per
    batched event of every kernel of its path; the outage run against
    its windows; the same paper_x8 sweep with ``dynamics="none"`` against
    ``fed_refs`` (the ``fed`` phase's run on its card subset and the
    observed federation's run, on the same traces) and as the churn
    run's baseline: churn wastes at least its energy. Returns the launch
    counts."""
    import numpy as np

    from repro_torch.core.types import Metrics
    from repro_torch.experiments import SweepSpec, run_sweep

    traces, tasks, rates = fault_inputs(device, flat_traces, x8_traces)
    total, results = {}, {}
    for run in FAULT_RUNS:
        label, system, heuristic = run[:3]
        reset_counts()
        res = run_sweep(fault_spec(run, rates[system], FAULT_REPS,
                                   tasks[system]), traces=traces[system],
                        device=device)
        counts = read_counts()
        summarize(res, label, phase="faults")
        steps = res.run_info[heuristic]["loop_iterations"]
        expect = fault_expected(run, steps)
        require(steps > 0, f"{label}: no batched event")
        for k, v in expect.items():
            require(counts[k] == v,
                    f"{label}: {k}: {counts[k]} launches, {v} expected")
        if "task_log" in res.aux:
            check_observed(label, res.metrics, res.aux)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        results[label] = res
        emit("faults", run=label, dynamics=run[4], launches=counts,
             expected=expect,
             orphans=(int(res.aux["task_log"]["retries"].sum())
                      if "task_log" in res.aux else None))

    aware = results[FAULT_RUNS[0][0]]
    outage = check_outage(aware, traces["paper_x8"])
    sticky = results[FAULT_RUNS[1][0]]
    emit("faults", run="outage: health_aware against sticky", **outage,
         completion_rate_health_aware=[float(v) for v in
                                       aware.completion_rate[0]],
         completion_rate_sticky=[float(v) for v in sticky.completion_rate[0]],
         rates=list(FED_RATES))

    # -- the same paper_x8 sweep with dynamics="none": the fed phase's and
    # the observed federation's Metrics on their traces, and the churn
    # run's baseline ----------------------------------------------------
    churn = results[FAULT_RUNS[2][0]]
    none = run_sweep(SweepSpec(
        system="paper_x8", rates=FED_RATES, reps=FAULT_REPS,
        n_tasks=FAULT_TASKS, heuristics=("FELARE",), seed=0,
        dispatcher="fair_spill", dynamics="none", use_fused_map=True),
        traces=traces["paper_x8"], device=device)
    for ref, what in zip(fed_refs, ("fed (card subset)", "observe_fed")):
        r, k = ref.metrics.makespan.shape[1:]
        head = Metrics(*(x[:, :r, :k] for x in none.metrics))
        for a, b, f in zip(head, ref.metrics, Metrics._fields):
            require(np.array_equal(a, b), f"dynamics='none' vs {what}: {f}")
    wasted = (float(churn.metrics.energy_wasted.sum()),
              float(none.metrics.energy_wasted.sum()))
    require(wasted[0] >= wasted[1],
            f"churn wasted {wasted[0]} J, {wasted[1]} J without faults")
    emit("faults", run="churn against no faults",
         wasted=wasted[0], unfaulted_wasted=wasted[1],
         completion_rate=[float(v) for v in churn.completion_rate[0]],
         unfaulted_completion_rate=[float(v) for v in
                                    none.completion_rate[0]],
         seconds=churn.run_info["FELARE"]["seconds"],
         unfaulted_seconds=none.run_info["FELARE"]["seconds"],
         loop_iterations=churn.run_info["FELARE"]["loop_iterations"],
         unfaulted_loop_iterations=none.run_info["FELARE"][
             "loop_iterations"],
         none="Metrics identical to the fed phase's (2 x 2 subset) and "
              "the observed federation's runs")
    return total


def run_faults_parity(device, traces: dict, rates: dict) -> None:
    """The faulted runs (the sticky comparison aside) through the kernels
    and through the plain path on the card, on the first
    ``FAULT_PARITY_REPS`` replicates cut to ``FAULT_PARITY_TASKS`` tasks:
    every Metrics field and aux leaf identical. Then the outage run's
    2 x 2 subset on the CPU: identical counters, task_log and health
    series, energies within rel 1e-5."""
    from repro_torch.core.types import Trace
    from repro_torch.experiments import run_sweep

    seconds = {}
    for run in FAULT_RUNS[:1] + FAULT_RUNS[2:]:   # the sticky one aside
        label, system = run[:2]
        sub = Trace(*(x[:, :FAULT_PARITY_REPS, :FAULT_PARITY_TASKS]
                      for x in traces[system]))
        out = [run_sweep(fault_spec(run, rates[system], FAULT_PARITY_REPS,
                                    FAULT_PARITY_TASKS, fused=fused),
                         traces=sub, device=device) for fused in (True, False)]
        fused, plain = out
        for a, b, k in zip(fused.metrics, plain.metrics,
                           fused.metrics._fields):
            require(a.dtype == b.dtype and (a == b).all(),
                    f"{label}: fused vs plain: {k} differs")
        same_aux(fused.aux, plain.aux, f"{label}: fused vs plain (card)")
        seconds[label] = {"fused": fused.run_info[run[2]]["seconds"],
                          "plain": plain.run_info[run[2]]["seconds"]}
        if run is FAULT_RUNS[0]:
            cpu_sub = Trace(*(x[:2, :2].cpu() for x in sub))
            cpu = run_sweep(fault_spec(run, rates[system][:2], 2,
                                       FAULT_PARITY_TASKS),
                            traces=cpu_sub, device="cpu")
            card = type(fused.metrics)(*(x[:, :2, :2]
                                         for x in fused.metrics))
            same_counts(cpu.metrics, card, f"{label}: card vs CPU subset",
                        energy_rel=1e-5)
            from repro_torch.core import observe

            same_aux(cpu.aux, observe.tree_map(lambda x: x[:, :2, :2],
                                               fused.aux),
                     f"{label}: card vs CPU subset")
            seconds["cpu_subset"] = cpu.run_info[run[2]]["seconds"]
    emit("faults_parity",
         plain_on_card="every Metrics field and aux leaf identical "
                       "(task_log with retries, health)",
         cpu_subset="identical counters, task_log and health; energies "
                    "within rel 1e-5",
         reps=FAULT_PARITY_REPS, tasks=FAULT_PARITY_TASKS, seconds=seconds)


# --------------------------------------------------------------------------
# The edge-cloud network on the kernel path
# --------------------------------------------------------------------------
def harsh_network():
    """The ablation's tiered network: cross-tier latencies past the
    deadline slack."""
    from repro_torch.core import network

    return network.Tiered(latency=NET_LATENCY, energy=NET_ENERGY)


def network_spec(heuristic, dispatcher, net, reps, n_tasks, observers,
                 fused=True, system="tiered_x4", rates=NET_RATES):
    from repro_torch.experiments import SweepSpec

    return SweepSpec(system=system, rates=rates, reps=reps, n_tasks=n_tasks,
                     heuristics=(heuristic,), seed=0, dispatcher=dispatcher,
                     network=net, observers=observers, use_fused_map=fused)


def run_network_path(device) -> dict:
    """The ablation's three arms (:data:`NET_ARMS`) at its full size on the
    kernels, each run's launch counts zeroed just before it and held to
    one launch per batched event of every kernel of its path. Per arm:
    the on-time share and the per-type completion std (pooled over the
    replicates, as the ablation pools them), loop iterations and seconds,
    the transfer energy per destination tier, the tasks cancelled in
    transit (CANCELLED with their ready time still ahead of their end)
    and the most tasks in transit at once; no task may start before it
    lands. Then the claim of ``benchmarks/TIERS_BASELINE.json``: FELARE +
    tier_aware's std at most ELARE + tier_aware's + 0.02, and its on-time
    share above FELARE + fair_spill's. Returns the launch counts."""
    import numpy as np

    from repro_torch import scenarios
    from repro_torch.experiments import run_sweep

    system = scenarios.get_fleet("tiered_x4").build()
    traces = scenarios.DEFAULT.stack(0, NET_RATES, NET_REPS, NET_TASKS,
                                     system.eet, device=device)
    total, arms = {}, {}
    for heuristic, dispatcher in NET_ARMS:
        label = f"tiered_x4 {heuristic} {dispatcher} harsh"
        reset_counts()
        res = run_sweep(network_spec(heuristic, dispatcher, harsh_network(),
                                     NET_REPS, NET_TASKS, NET_OBSERVERS),
                        traces=traces, device=device)
        counts = read_counts()
        summarize(res, label, phase="network")
        steps = res.run_info[heuristic]["loop_iterations"]
        expect = {"map_decide": steps,
                  "evict_stats": steps if heuristic == "FELARE" else 0,
                  "balance_scan": steps if dispatcher == "fair_spill" else 0,
                  "phase1_map": 0}
        require(steps > 0, f"{label}: no batched event")
        for k, v in expect.items():
            require(counts[k] == v,
                    f"{label}: {k}: {counts[k]} launches, {v} expected")
        check_observed(label, res.metrics, res.aux)
        log, net = res.aux["task_log"], res.aux["network"]
        started = log["start_time"] >= 0
        require(bool(np.all(log["start_time"][started]
                            >= log["ready_time"][started])),
                f"{label}: a task started before it landed")
        m = res.metrics
        ontime = float(m.completed_by_type.sum() / m.arrived_by_type.sum())
        std = float(res.fairness_spread[0, 0])
        arms[(heuristic, dispatcher)] = (ontime, std)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        emit("network", run=label, launches=counts, expected=expect,
             ontime_share=ontime, fairness_std=std,
             completion_rate_by_type=[
                 float(v) for v in res.completion_rate_by_type[0, 0]],
             seconds=res.run_info[heuristic]["seconds"],
             loop_iterations=steps,
             xfer_energy_by_tier=[float(v) for v in
                                  net["xfer_energy"][..., -1, :].sum(
                                      axis=(0, 1, 2))],
             cancelled_in_transit=int(((log["status"] == 6)
                                       & (log["ready_time"]
                                          > log["end_time"])).sum()),
             cancelled=int(m.cancelled_by_type.sum()),
             landed_late=int((log["ready_time"]
                              > traces.arrival.cpu().numpy()[None]).sum()),
             max_in_transit=int(net["in_transit"].max()))
    felare, elare = arms[("FELARE", "tier_aware")], arms[("ELARE",
                                                          "tier_aware")]
    spill = arms[("FELARE", "fair_spill")]
    claim = felare[1] <= elare[1] + 0.02 and felare[0] > spill[0]
    emit("network", run="TIERS claim", felare_fairness_std=felare[1],
         elare_fairness_std=elare[1], tier_aware_ontime=felare[0],
         fair_spill_ontime=spill[0], holds=claim)
    require(claim, f"the tiered-network claim fails on the port's traces: "
                   f"{arms}")
    return total


def run_network_parity(device, tier_traces, tier_res) -> None:
    """On a cut (:data:`NET_PARITY_REPS` x :data:`NET_PARITY_TASKS`) under
    the registered ``tiered`` network, FELARE + fair_spill (map_decide,
    evict_stats and balance_scan) with the task log and the network
    series: the kernel path equals the plain path on the card, every
    Metrics field and aux leaf.
    Then ``network="none"`` on the fed phase's tiered_x4 traces gives that
    phase's Metrics, every field."""
    import numpy as np

    from repro_torch import scenarios
    from repro_torch.core.types import Trace
    from repro_torch.experiments import run_sweep

    system = scenarios.get_fleet("tiered_x4").build()
    traces = scenarios.DEFAULT.stack(1, NET_RATES, NET_PARITY_REPS,
                                     NET_PARITY_TASKS, system.eet,
                                     device=device)
    label = "tiered_x4 FELARE fair_spill tiered"
    fused, plain = [run_sweep(network_spec(
        "FELARE", "fair_spill", "tiered", NET_PARITY_REPS, NET_PARITY_TASKS,
        NET_OBSERVERS, fused=f), traces=traces, device=device)
        for f in (True, False)]
    for a, b, k in zip(fused.metrics, plain.metrics, fused.metrics._fields):
        require(a.dtype == b.dtype and (a == b).all(),
                f"{label}: fused vs plain: {k} differs")
    same_aux(fused.aux, plain.aux, f"{label}: fused vs plain (card)")
    require(int(fused.aux["network"]["in_transit"].max()) > 0,
            f"{label}: nothing was ever in transit")
    seconds = {"fused": fused.run_info["FELARE"]["seconds"],
               "plain": plain.run_info["FELARE"]["seconds"]}
    sub = Trace(*(x[:, :TIER_REPS, :TIER_TASKS] for x in tier_traces))
    none = run_sweep(network_spec(
        "FELARE", "least_queued", "none", TIER_REPS, TIER_TASKS, (),
        rates=TIER_RATES), traces=sub, device=device)
    for a, b, f in zip(none.metrics, tier_res.metrics,
                       none.metrics._fields):
        require(np.array_equal(a, b), f"network='none' vs fed tiered_x4: {f}")
    emit("network_parity",
         plain_on_card="every Metrics field and aux leaf identical "
                       "(task_log with ready times, the network series)",
         reps=NET_PARITY_REPS, tasks=NET_PARITY_TASKS, seconds=seconds,
         none="Metrics identical to the fed phase's tiered_x4 run",
         none_seconds=none.run_info["FELARE"]["seconds"])


# --------------------------------------------------------------------------
# Workload scenarios and synthetic fleets on the kernel path
# --------------------------------------------------------------------------
def scenario_spec(run: tuple, reps: int, n_tasks: int, fused=True):
    """The SweepSpec of a :data:`SCENARIO_RUNS` entry: FELARE on the fused
    map (and the balance walk), ELARE on the fused Phase I."""
    from repro_torch.core import dispatch
    from repro_torch.experiments import SweepSpec

    _, scenario, system, rates, heuristic, disp, _ = run
    if disp == "sticky_by_type":
        disp = dispatch.Sticky(by_type=True)
    return SweepSpec(system=system, scenario=scenario, rates=rates,
                     reps=reps, n_tasks=n_tasks, heuristics=(heuristic,),
                     seed=0, dispatcher=disp or "sticky",
                     use_fused_map=fused and heuristic == "FELARE",
                     use_fused_phase1=fused and heuristic == "ELARE")


def expected_launches(run: tuple, steps: int) -> dict:
    """One launch per batched event of each kernel on ``run``'s path: the
    fused map carries the balance walk, the fused Phase I does not."""
    felare = run[4] == "FELARE"
    walk = felare and run[5] in ("least_queued", "fair_spill")
    return {"map_decide": steps if felare else 0,
            "evict_stats": steps if felare else 0,
            "phase1_map": 0 if felare else steps,
            "balance_scan": steps if walk else 0}


def gaps_cv2(arrival) -> float:
    """Mean over the traces of the inter-arrival CV^2 (1 for Poisson)."""
    g = arrival.diff(dim=-1).double()
    return float((g.var(dim=-1, unbiased=False) / g.mean(dim=-1) ** 2)
                 .mean())


def run_scenario_workloads(device, reps: int, n_tasks: int) -> dict:
    """The seven workload-only scenarios on the paper's system as one batch
    of 7 x (5 rates x ``reps``) traces: FELARE on the fused map and ELARE
    on the fused Phase I through ``simulate_sweep``, each kernel once per
    batched event; the arrivals sorted and finite, MMPP's inter-arrival
    CV^2 above 1 and Poisson's about 1; then ``bursty`` end to end
    through ``run_sweep``, whose FELARE Metrics must be the batch's bursty
    rows bit for bit. Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.types import Trace
    from repro_torch.experiments import SweepSpec, run_sweep, simulate_sweep

    system = SweepSpec().resolve_system()
    t0 = time.perf_counter()
    stacks = {name: SweepSpec(scenario=name).resolve_scenario().stack(
        0, RATES, reps, n_tasks, system.eet, device=device)
        for name in WORKLOAD_SCENARIOS}
    synth_seconds = time.perf_counter() - t0
    cv2 = {}
    for name, st in stacks.items():
        a = st.arrival
        require(bool(torch.isfinite(a).all()) and bool((a >= 0).all()),
                f"{name}: non-finite or negative arrivals")
        require(bool((a.diff(dim=-1) >= 0).all()),
                f"{name}: arrivals not sorted")
        cv2[name] = gaps_cv2(a)
    require(cv2["bursty"] > 1.15 and cv2["bursty-heavy-tail"] > 1.15,
            f"MMPP arrivals not bursty: CV^2 {cv2}")
    require(0.9 < cv2["heavy-tail"] < 1.1,
            f"Poisson arrivals: CV^2 {cv2['heavy-tail']}, not about 1")
    B = len(RATES) * reps
    batch = Trace(*(torch.cat([x.reshape((B,) + x.shape[2:])
                               for x in leaves])
                    for leaves in zip(*stacks.values())))
    total, results = {}, {}
    for heuristic, kw in (("FELARE", dict(use_fused_map=True)),
                          ("ELARE", dict(use_fused_phase1=True))):
        info = {}
        reset_counts()
        m = simulate_sweep(batch, system, (heuristic,), device=device,
                           run_info=info, **kw)
        counts = read_counts()
        steps = info[heuristic]["loop_iterations"]
        expect = expected_launches(("", "", None, RATES, heuristic, None,
                                    "paper"), steps)
        require(steps > 0, f"scenarios {heuristic}: no batched event")
        for k, v in expect.items():
            require(counts[k] == v,
                    f"scenarios {heuristic}: {k}: {counts[k]} launches, "
                    f"{v} expected")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        arrived = m.arrived_by_type[0].sum(-1)
        done = (m.completed_by_type + m.missed_by_type
                + m.cancelled_by_type)[0].sum(-1)
        require(bool(np.all(arrived == n_tasks))
                and bool(np.all(done == n_tasks)),
                f"scenarios {heuristic}: tasks not conserved")
        rate = (m.completed_by_type[0].sum(-1)
                / m.arrived_by_type[0].sum(-1)).reshape(
            len(WORKLOAD_SCENARIOS), len(RATES), reps).mean(-1)
        emit("scenarios", run=f"paper {heuristic}", traces=int(arrived.size),
             seconds=info[heuristic]["seconds"], event_steps=steps,
             ms_per_iteration=info[heuristic]["seconds"] * 1e3 / steps,
             launches=counts, expected=expect, rates=list(RATES),
             completion_rate={name: [float(v) for v in rate[i]]
                              for i, name in enumerate(WORKLOAD_SCENARIOS)})
        results[heuristic] = m
    # bursty end to end through run_sweep, unchanged
    reset_counts()
    res = run_sweep(SweepSpec(scenario="bursty", rates=RATES, reps=reps,
                              n_tasks=n_tasks, heuristics=("FELARE",),
                              seed=0, use_fused_map=True), device=device)
    counts = read_counts()
    summarize(res, "paper FELARE bursty (run_sweep)", phase="scenarios")
    steps = res.run_info["FELARE"]["loop_iterations"]
    require(counts["map_decide"] == steps and counts["evict_stats"] == steps,
            f"bursty run_sweep: {counts} launches, {steps} batched events")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    i = WORKLOAD_SCENARIOS.index("bursty")
    for leaf, got in zip(results["FELARE"], res.metrics):
        want = leaf[0, i * B:(i + 1) * B].reshape(got.shape[1:])
        require(np.array_equal(got[0], want),
                "bursty: run_sweep differs from its rows of the batch")
    emit("scenarios", run="workload checks", synth_seconds=synth_seconds,
         inter_arrival_cv2=cv2, bursty_run_sweep="Metrics identical to "
         "the batch's bursty rows", bursty_event_steps=steps)
    return total


def run_scenario_fleets(device, reps: int, n_tasks: int,
                        shapes: tuple) -> tuple:
    """The :data:`SCENARIO_RUNS` at ``shapes`` at full width through
    ``run_sweep``, each run's launch counts zeroed just before it and held
    to one launch per batched event of every kernel of its path; then the
    :data:`SCENARIO_PARITY_RUNS` at those shapes on a 5 x 300 cut through
    the kernels and the plain path on the card, Metrics bit for bit
    (sha256). Returns the launch counts of the runs and by shape."""
    from repro_torch.experiments import run_sweep

    total, by_shape = {}, {}

    def tally(run, counts):
        for d in (total, by_shape.setdefault(run[6], {})):
            for k, v in counts.items():
                d[k] = d.get(k, 0) + v

    for run in (r for r in SCENARIO_RUNS if r[6] in shapes):
        reset_counts()
        res = run_sweep(scenario_spec(run, reps, n_tasks), device=device)
        counts = read_counts()
        summarize(res, run[0], phase="scenarios")
        steps = res.run_info[run[4]]["loop_iterations"]
        expect = expected_launches(run, steps)
        emit("scenarios", run=run[0], shape=run[6], launches=counts,
             expected=expect)
        require(steps > 0, f"{run[0]}: no batched event")
        for k, v in expect.items():
            require(counts[k] == v,
                    f"{run[0]}: {k}: {counts[k]} launches, {v} expected")
        tally(run, counts)
    digests, seconds = {}, {}
    for run in (r for r in SCENARIO_PARITY_RUNS if r[6] in shapes):
        out = []
        for fused in (True, False):
            reset_counts()
            res = run_sweep(scenario_spec(run, SCENARIO_PARITY_REPS,
                                          SCENARIO_PARITY_TASKS, fused),
                            device=device)
            counts = read_counts()
            if fused:
                expect = expected_launches(
                    run, res.run_info[run[4]]["loop_iterations"])
                for k, v in expect.items():
                    require(counts[k] == v,
                            f"{run[0]} (cut): {k}: {counts[k]} launches, "
                            f"{v} expected")
                tally(run, counts)
            else:
                require(not any(counts.values()),
                        f"{run[0]}: the plain path launched {counts}")
            out.append(metrics_digest(res, run[4]))
            seconds[f"{run[0]} {'fused' if fused else 'plain'}"] = \
                res.run_info[run[4]]["seconds"]
        require(out[0] == out[1], f"{run[0]}: fused and plain Metrics differ")
        digests[run[0]] = out[0]
    emit("scenarios_parity", plain_on_card="every Metrics field identical "
         "(sha256)", reps=SCENARIO_PARITY_REPS, tasks=SCENARIO_PARITY_TASKS,
         sha256=digests, seconds=seconds)
    return total, by_shape


# --------------------------------------------------------------------------
# Serve path: zamba2-2.7b at full width
# --------------------------------------------------------------------------
def serve_prompt():
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    vocab = get_config(SERVE_ARCH).vocab_size
    toks = np.random.default_rng(0).integers(
        0, vocab, (SERVE_BATCH, SERVE_PROMPT))
    return {"tokens": torch.as_tensor(toks)}


def device_split(fn, host_ops: bool = True) -> dict:
    """Device time of one call of ``fn`` by kernel, from torch.profiler:
    busy ms, the call's wall ms, and the largest kernels. ``host_ops=
    False`` records the device's activity alone (a call of 100,000
    launches then takes seconds, not a minute, to digest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host_ops
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms_profiled": wall * 1e3, "device_busy_ms": busy,
            "launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:60], "launches": e.count,
                             "ms": e.self_device_time_total * 1e-3}
                            for e in top]}


def run_serve_path(device) -> tuple:
    """zamba2-2.7b at full width serves 8 x 1024-token prompts for 64
    greedy tokens through ``make_serve_steps``. Returns (launch counts of
    the timed run, the bf16 params, the prompt)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import make_serve_steps

    cfg = get_config(SERVE_ARCH)
    require(cfg.attn_impl == "kernel" and cfg.ssm_impl == "kernel",
            "the serve path must run the kernels")
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.init(cfg, gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(int(t.numel()) for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    steps = make_serve_steps(cfg, device=device)
    batch = serve_prompt()

    prefill_step, decode_step = steps
    logits, cache = prefill_step(params, batch, max_seq=SERVE_MAX_SEQ)
    decode_step(params, cache, logits.argmax(-1))           # warm-up
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base_mem = torch.cuda.memory_allocated(device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    reset_counts()
    ev[0].record()
    logits, cache = prefill_step(params, batch, max_seq=SERVE_MAX_SEQ)
    ev[1].record()
    finite = torch.isfinite(logits).all()
    toks = []
    for _ in range(SERVE_NEW):
        tok = logits.argmax(-1)
        toks.append(tok)
        logits, cache = decode_step(params, cache, tok)
        finite = finite & torch.isfinite(logits).all()
    ev[2].record()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    prefill_ms = ev[0].elapsed_time(ev[1])
    decode_ms = ev[1].elapsed_time(ev[2])
    toks = torch.cat(toks, 1)
    require(bool(finite), "serve: non-finite logits")
    require(tuple(toks.shape) == (SERVE_BATCH, SERVE_NEW)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
            "serve: tokens out of range")
    require(cache["len"].tolist() == [SERVE_MAX_SEQ] * SERVE_BATCH,
            f"serve: cache length {cache['len'].tolist()}")
    n_inv = cfg.n_layers // cfg.attn_every
    # the serve shape's scan runs on the tensor cores, every layer
    expect = {"flash_attention": n_inv, "ssd_scan_tc": cfg.n_layers,
              "ssd_scan": 0, "decode_attention": n_inv * SERVE_NEW}
    emit("serve", arch=SERVE_ARCH, params=n_params,
         weight_bytes=weight_bytes, init_seconds=init_s,
         batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_NEW,
         launches={k: counts[k] for k in expect}, expected=expect,
         prefill_ms=prefill_ms, decode_ms_per_step=decode_ms / SERVE_NEW,
         prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
         decode_tokens_per_s=SERVE_BATCH * SERVE_NEW / decode_ms * 1e3,
         end_to_end_ms=prefill_ms + decode_ms,
         peak_memory_bytes=peak, memory_before_bytes=base_mem,
         kv_cache_bytes=sum(cache[k].numel() * cache[k].element_size()
                            for k in ("k", "v")),
         ssm_state_bytes=sum(cache[k].numel() * cache[k].element_size()
                             for k in ("ssm", "conv")),
         first_tokens=toks[0, :8].tolist())
    for k, v in expect.items():
        require(counts[k] == v, f"serve: {k}: {counts[k]} launches, {v} "
                                f"expected")
    del cache
    split = {"prefill": device_split(lambda: prefill_step(
        params, batch, max_seq=SERVE_MAX_SEQ))}
    _, c2 = prefill_step(params, batch, max_seq=SERVE_MAX_SEQ)
    tok = toks[:, :1].contiguous()
    split["decode_step"] = device_split(lambda: decode_step(params, c2, tok))
    emit("serve_profile", **split)
    return {k: counts[k] for k in expect}, params, batch


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def bf16_blocks(cfg, params, batch) -> dict:
    """Every block of a prefill, and the attention blocks of a decode step
    (its Mamba step is the same code on both paths), on the kernel path
    and on the plain path from the same input (the kernel path's
    trajectory): the largest difference over max|plain| per kind of
    block, and how far the two paths' own trajectories have drifted apart
    by the last layer."""
    import torch

    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as tf

    cfgs = {"kernel": cfg,
            "plain": cfg.scaled(attn_impl="plain", ssm_impl="plain")}
    toks = batch["tokens"].to(params["inv_norms"].device)
    pos = torch.arange(toks.shape[1], device=toks.device)
    x = ll.embed_apply(params["embed"], toks, cfg.act_dtype)
    x_plain = x
    worst = {"mamba": 0.0, "attention": 0.0, "attention_decode": 0.0}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    with torch.no_grad():
        _, cache = tf.prefill(cfg, params, batch={"tokens": toks},
                              max_seq=SERVE_MAX_SEQ)
        xd = ll.embed_apply(params["embed"], toks[:, -1:], cfg.act_dtype)
        dpos = cache["len"][:, None]
        for i in range(cfg.n_layers):
            lp = tf._layer(params["blocks"], i)
            out = {k: tf._mamba_layer(c, lp, x) for k, c in cfgs.items()}
            worst["mamba"] = max(worst["mamba"],
                                 rel(out["kernel"], out["plain"]))
            x = out["kernel"]
            x_plain = tf._mamba_layer(cfgs["plain"], lp, x_plain)
            if (i + 1) % cfg.attn_every:
                continue
            g = i // cfg.attn_every
            sp = params["shared_attn"]
            out = {k: tf._attn_block_apply(
                c, sp, tf._shared_input(c, params, x, g), pos)[0]
                for k, c in cfgs.items()}
            worst["attention"] = max(worst["attention"],
                                     rel(out["kernel"], out["plain"]))
            x = out["kernel"]
            x_plain = tf._attn_block_apply(
                cfgs["plain"], sp, tf._shared_input(cfg, params, x_plain, g),
                pos)[0]
            xn = ll.norm_apply(cfg, sp["ln1"],
                               tf._shared_input(cfg, params, xd, g))
            dec = {k: ll.attn_decode(c, sp["attn"], xn, dpos,
                                     cache["k"][g].clone(),
                                     cache["v"][g].clone(), cache["len"])[0]
                   for k, c in cfgs.items()}
            worst["attention_decode"] = max(
                worst["attention_decode"], rel(dec["kernel"], dec["plain"]))
            xd = xd + dec["kernel"]
    return {"block_rel_err_over_max": worst,
            "trajectory_rel_drift_at_last_layer": rel(x, x_plain)}


def run_serve_parity(device, params_bf16, batch) -> None:
    """The kernel path against the plain path on the card.

    float32 at full width (the bf16 weights upcast, exactly): the prefill
    logits and the first decode step's within rel 1e-3 of max|logits|.
    bfloat16: every block of the prefill and the attention blocks of a
    decode step within 2e-2 of max|want| from the same input, as the
    kernels are held. The first
    generated token is compared and reported: on the rows whose top-2 gap
    on the plain path is above 2e-2 x max|logits|, and against the
    float32 run. It does not gate, because a one-ulp bf16 difference in a
    block grows along the 54 random-weight layers (the drift is
    reported): the two bf16 paths' final hidden states differ by tens of
    percent, so near-tied tokens flip between them.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import make_serve_steps

    cfg = get_config(SERVE_ARCH)
    plain = dict(attn_impl="plain", ssm_impl="plain")

    # -- float32 at full width ---------------------------------------------
    cfg32 = cfg.scaled(dtype="float32", param_dtype="float32")
    params32 = transformer.tree_map(lambda t: t.float(), params_bf16)
    rel = {}
    tok = None
    outs = {}
    for label, c in (("kernel", cfg32), ("plain", cfg32.scaled(**plain))):
        pre, dec = make_serve_steps(c, device=device)
        logits, cache = pre(params32, batch, max_seq=SERVE_MAX_SEQ)
        if tok is None:
            tok = logits.argmax(-1)
        step, _ = dec(params32, cache, tok)
        outs[label] = (logits, step)
        del cache
    finite = True
    for i, name in enumerate(("prefill", "decode")):
        k, p = outs["kernel"][i], outs["plain"][i]
        finite = finite and bool(torch.isfinite(k).all())
        rel[name] = float((k - p).abs().max() / p.abs().max())
    truth = outs["plain"][0][:, 0].argmax(-1)
    params32_bytes = sum(t.numel() * 4 for t in _leaves(params32))
    del params32, outs

    # -- bfloat16 ----------------------------------------------------------
    blocks = bf16_blocks(cfg, params_bf16, batch)
    got = make_serve_steps(cfg, device=device)[0](params_bf16, batch,
                                                  max_seq=SERVE_MAX_SEQ)[0]
    want = make_serve_steps(cfg.scaled(**plain), device=device)[0](
        params_bf16, batch, max_seq=SERVE_MAX_SEQ)[0]
    top2 = want[:, 0].topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]) / want.abs().max()
    clear = gap > 2e-2
    first_k, first_p = got[:, 0].argmax(-1), want[:, 0].argmax(-1)
    agree = first_k == first_p
    bf16 = {**blocks, "rows": SERVE_BATCH,
            "clear_gap_rows": int(clear.sum()),
            "first_token_agree_on_clear": int(agree[clear].sum()),
            "first_token_agree_on_others": int(agree[~clear].sum()),
            "top2_gap_over_max": [float(g) for g in gap],
            "first_token_agree_with_float32": {
                "kernel": int((first_k == truth).sum()),
                "plain": int((first_p == truth).sum())},
            "logit_diff_over_max": float(
                (got - want).abs().max() / want.abs().max())}
    emit("serve_parity", float32_rel_err_over_max=rel,
         float32_params_bytes=params32_bytes, bfloat16=bf16)
    require(finite, "f32: non-finite logits")
    for name, err in rel.items():
        require(err <= 1e-3, f"f32 {name}: rel err {err}")
    for kind, err in blocks["block_rel_err_over_max"].items():
        require(err <= 2e-2, f"bf16 {kind} block: rel err {err}")


# --------------------------------------------------------------------------
# Dense GQA serving at full width
# --------------------------------------------------------------------------
def run_dense_serve(device) -> dict:
    """internlm2-1.8b and phi4-mini-3.8b at their published width and
    depth, command-r-35b at full width and 16 of 40 layers, each serving
    8 x 1024-token prompts for 64 greedy tokens through
    ``make_serve_steps`` on the kernels. Returns each arch's launch
    counts of the timed run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import make_serve_steps

    out = {}
    for arch, n_layers in DENSE_SERVE:
        cfg = get_config(arch)
        full_layers = cfg.n_layers
        if n_layers is not None:
            cfg = cfg.scaled(n_layers=n_layers)
        require(cfg.attn_impl == "kernel", "the serve path must run the "
                                           "kernels")
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        params = transformer.init(cfg, gen, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(int(t.numel()) for t in _leaves(params))
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _leaves(params))
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
        batch = {"tokens": torch.as_tensor(toks)}
        prefill_step, decode_step = make_serve_steps(cfg, device=device)
        logits, cache = prefill_step(params, batch, max_seq=SERVE_MAX_SEQ)
        decode_step(params, cache, logits.argmax(-1))        # warm-up
        del logits, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        reset_counts()
        ev[0].record()
        logits, cache = prefill_step(params, batch, max_seq=SERVE_MAX_SEQ)
        ev[1].record()
        finite = torch.isfinite(logits).all()
        gen_toks = []
        for _ in range(SERVE_NEW):
            tok = logits.argmax(-1)
            gen_toks.append(tok)
            logits, cache = decode_step(params, cache, tok)
            finite = finite & torch.isfinite(logits).all()
        ev[2].record()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device)
        prefill_ms = ev[0].elapsed_time(ev[1])
        decode_ms = ev[1].elapsed_time(ev[2])
        gen_toks = torch.cat(gen_toks, 1)
        expect = {"flash_attention": cfg.n_layers,
                  "decode_attention": cfg.n_layers * SERVE_NEW,
                  "ssd_scan_tc": 0, "ssd_scan": 0}
        emit("serve_dense", arch=arch, layers=cfg.n_layers,
             published_layers=full_layers,
             cut=None if n_layers is None else
             f"depth {n_layers} of {full_layers} layers, full width",
             heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
             params=n_params, weight_bytes=weight_bytes,
             init_seconds=init_s, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
             new_tokens=SERVE_NEW,
             launches={k: counts[k] for k in expect}, expected=expect,
             prefill_ms=prefill_ms, decode_ms_per_step=decode_ms / SERVE_NEW,
             prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / prefill_ms
             * 1e3,
             decode_tokens_per_s=SERVE_BATCH * SERVE_NEW / decode_ms * 1e3,
             end_to_end_ms=prefill_ms + decode_ms,
             peak_memory_bytes=peak, memory_before_bytes=base_mem,
             kv_cache_bytes=sum(cache[k].numel() * cache[k].element_size()
                                for k in ("k", "v")),
             first_tokens=gen_toks[0, :8].tolist())
        require(bool(finite), f"serve_dense {arch}: non-finite logits")
        require(tuple(gen_toks.shape) == (SERVE_BATCH, SERVE_NEW)
                and int(gen_toks.min()) >= 0
                and int(gen_toks.max()) < cfg.vocab_size,
                f"serve_dense {arch}: tokens out of range")
        require(cache["len"].tolist() == [SERVE_MAX_SEQ] * SERVE_BATCH,
                f"serve_dense {arch}: cache length {cache['len'].tolist()}")
        for k, v in expect.items():
            require(counts[k] == v, f"serve_dense {arch}: {k}: {counts[k]} "
                                    f"launches, {v} expected")
        del cache, logits
        split = {"prefill": device_split(lambda: prefill_step(
            params, batch, max_seq=SERVE_MAX_SEQ))}
        _, c2 = prefill_step(params, batch, max_seq=SERVE_MAX_SEQ)
        tok = gen_toks[:, :1].contiguous()
        split["decode_step"] = device_split(
            lambda: decode_step(params, c2, tok))
        emit("serve_dense_profile", arch=arch, **split)
        out[arch] = {k: counts[k] for k in expect}
        del params, c2
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# The moe, vlm, audio and ssm families at full width, and the edge example
# --------------------------------------------------------------------------
def family_batch(cfg, prompt: int) -> dict:
    """8 requests from numpy seed 0, drawn as examples/serve_edge.py draws
    a request: the tokens, then the frames (audio) or patches (vlm) at
    0.1 N(0, 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (SERVE_BATCH, prompt)))}
    extra = {"audio": ("frames", AUDIO_FRAMES),
             "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if extra is not None:
        batch[extra[0]] = torch.as_tensor(rng.standard_normal(
            (SERVE_BATCH, extra[1], cfg.d_model)), dtype=torch.float32) * 0.1
    return batch


def family_plan(cfg, prompt: int) -> tuple:
    """(max_seq, the cache length after the prompt and SERVE_NEW steps,
    the launches of one prefill and SERVE_NEW steps by attention shape):
    one flash launch per attention block and prefill (an audio model's
    encoder, decoder and cross blocks), one decode launch per block
    attending a cache and step."""
    L, name = cfg.n_layers, cfg.name
    if cfg.family == "ssm":
        return prompt + SERVE_NEW, prompt + SERVE_NEW, {}
    if cfg.family == "audio":
        return AUDIO_FRAMES, prompt + SERVE_NEW, {
            f"{name} encoder": {"flash_attention": cfg.encoder_layers},
            f"{name} decoder": {"flash_attention": L,
                                "decode_attention": L * SERVE_NEW},
            f"{name} cross": {"flash_attention": L,
                              "decode_attention": L * SERVE_NEW}}
    ctx = prompt + (cfg.n_patches if cfg.family == "vlm" else 0)
    return ctx + SERVE_NEW, ctx + SERVE_NEW, {name: {
        "flash_attention": L, "decode_attention": L * SERVE_NEW}}


def xlstm_layer_ms(cfg, params, batch) -> dict:
    """Host ms of the first superblock's mLSTM and sLSTM over the prompt
    (CUDA events around each, after a warm-up call): the sLSTM runs one
    cell per token."""
    import torch

    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm

    lp = tf._layer(params["blocks"], 0)
    x = ll.embed_apply(params["embed"], batch["tokens"].to(
        params["embed"]["tok"].device), cfg.act_dtype)
    out = {}
    with torch.no_grad():
        for part, fn in (("mlstm", xlstm.mlstm_apply),
                         ("slstm", xlstm.slstm_apply)):
            fn(cfg, lp[part], x)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(cfg, lp[part], x)
            ev[1].record()
            torch.cuda.synchronize()
            out[f"{part}_ms_per_layer"] = ev[0].elapsed_time(ev[1])
    return out


def family_parity(device, cfg, params_bf16, batch, max_seq: int) -> None:
    """The kernel path against the plain path on the card in float32 at
    full width (the bf16 weights upcast, exactly): the prefill logits and
    the first decode step's within rel 1e-3 of max|logits|."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.train import make_serve_steps

    cfg32 = cfg.scaled(dtype="float32", param_dtype="float32")
    params32 = transformer.tree_map(lambda t: t.float(), params_bf16)
    outs, tok = {}, None
    for label, c in (("kernel", cfg32),
                     ("plain", cfg32.scaled(attn_impl="plain"))):
        pre, dec = make_serve_steps(c, device=device)
        logits, cache = pre(params32, batch, max_seq=max_seq)
        if tok is None:
            tok = logits.argmax(-1)
        step, _ = dec(params32, cache, tok)
        outs[label] = (logits, step)
        del cache
    rel, finite = {}, True
    for i, name in enumerate(("prefill", "decode")):
        k, p = outs["kernel"][i], outs["plain"][i]
        finite = finite and bool(torch.isfinite(k).all())
        rel[name] = float((k - p).abs().max() / p.abs().max())
    same = (outs["kernel"][0].argmax(-1) == outs["plain"][0].argmax(-1))
    emit("serve_families_parity", arch=cfg.name,
         float32_rel_err_over_max=rel,
         first_token_agree=int(same.sum()), rows=SERVE_BATCH,
         float32_params_bytes=sum(t.numel() * 4 for t in _leaves(params32)))
    require(finite, f"serve_families_parity {cfg.name}: non-finite logits")
    for name, err in rel.items():
        require(err <= 1e-3, f"serve_families_parity {cfg.name} {name}: "
                             f"rel err {err}")


def run_family_serve(device) -> tuple:
    """Each row of FAMILY_SERVE served through ``make_serve_steps`` on the
    kernels, as the dense configs are; the attention families' float32
    parity (FAMILY_PARITY). Returns (the launch counts of the timed runs
    summed, the launches by attention shape)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.train import make_serve_steps

    total, by_shape = {}, {}
    for arch, n_layers, prompt in FAMILY_SERVE:
        cfg = get_config(arch)
        full_layers = cfg.n_layers
        if n_layers is not None:
            cfg = cfg.scaled(n_layers=n_layers)
        require(cfg.attn_impl == "kernel", "the serve path must run the "
                                           "kernels")
        gen = torch.Generator(device=device).manual_seed(0)
        t0 = time.perf_counter()
        params = transformer.init(cfg, gen, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(int(t.numel()) for t in _leaves(params))
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in _leaves(params))
        batch = family_batch(cfg, prompt)
        max_seq, final_len, shapes = family_plan(cfg, prompt)
        prefill_step, decode_step = make_serve_steps(cfg, device=device)
        logits, cache = prefill_step(params, batch, max_seq=max_seq)
        decode_step(params, cache, logits.argmax(-1))        # warm-up
        del logits, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        reset_counts()
        t0 = time.perf_counter()
        ev[0].record()
        logits, cache = prefill_step(params, batch, max_seq=max_seq)
        ev[1].record()
        torch.cuda.synchronize()
        prefill_host_s = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        gen_toks = []
        for _ in range(SERVE_NEW):
            tok = logits.argmax(-1)
            gen_toks.append(tok)
            logits, cache = decode_step(params, cache, tok)
            finite = finite & torch.isfinite(logits).all()
        ev[2].record()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device)
        prefill_ms = ev[0].elapsed_time(ev[1])
        decode_ms = ev[1].elapsed_time(ev[2])
        gen_toks = torch.cat(gen_toks, 1)
        expect = {k: sum(s.get(k, 0) for s in shapes.values())
                  for k in ("flash_attention", "decode_attention")}
        expect.update({"ssd_scan_tc": 0, "ssd_scan": 0})
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in _leaves(cache))
        lens = {k: cache[k].tolist() for k in ("len", "xlen") if k in cache}
        emit("serve_families", arch=arch, family=cfg.family,
             layers=cfg.n_layers, published_layers=full_layers,
             encoder_layers=cfg.encoder_layers or None,
             cut=None if n_layers is None else
             f"depth {n_layers} of {full_layers} layers, full width",
             heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
             experts=cfg.n_experts or None,
             experts_per_token=cfg.experts_per_token or None,
             params=n_params, weight_bytes=weight_bytes,
             init_seconds=init_s, batch=SERVE_BATCH, prompt=prompt,
             inputs={k: list(v.shape) for k, v in batch.items()},
             max_seq=max_seq, new_tokens=SERVE_NEW,
             launches={k: counts[k] for k in expect}, expected=expect,
             prefill_ms=prefill_ms, prefill_host_ms=prefill_host_s * 1e3,
             decode_ms_per_step=decode_ms / SERVE_NEW,
             prefill_tokens_per_s=SERVE_BATCH * (final_len - SERVE_NEW)
             / prefill_ms * 1e3,
             decode_tokens_per_s=SERVE_BATCH * SERVE_NEW / decode_ms * 1e3,
             end_to_end_ms=prefill_ms + decode_ms,
             peak_memory_bytes=peak, memory_before_bytes=base_mem,
             cache_bytes=cache_bytes, cache_lengths=lens,
             first_tokens=gen_toks[0, :8].tolist())
        require(bool(finite), f"serve_families {arch}: non-finite logits")
        require(tuple(gen_toks.shape) == (SERVE_BATCH, SERVE_NEW)
                and int(gen_toks.min()) >= 0
                and int(gen_toks.max()) < cfg.vocab_size,
                f"serve_families {arch}: tokens out of range")
        require(lens["len"] == [final_len] * SERVE_BATCH,
                f"serve_families {arch}: cache length {lens['len']}")
        if cfg.family == "audio":
            require(lens["xlen"] == [AUDIO_FRAMES] * SERVE_BATCH,
                    f"serve_families {arch}: cross length {lens['xlen']}")
        for k, v in expect.items():
            require(counts[k] == v, f"serve_families {arch}: {k}: "
                                    f"{counts[k]} launches, {v} expected")
        del cache, logits
        split = {"prefill": device_split(lambda: prefill_step(
            params, batch, max_seq=max_seq), cfg.family != "ssm")}
        _, c2 = prefill_step(params, batch, max_seq=max_seq)
        tok = gen_toks[:, :1].contiguous()
        split["decode_step"] = device_split(
            lambda: decode_step(params, c2, tok))
        if cfg.family == "ssm":
            split["layers"] = xlstm_layer_ms(cfg, params, batch)
        emit("serve_families_profile", arch=arch, **split)
        del c2
        if arch in FAMILY_PARITY:
            family_parity(device, cfg, params, batch, max_seq)
        for k in expect:
            total[k] = total.get(k, 0) + counts[k]
        by_shape.update(shapes)
        del params
        torch.cuda.empty_cache()
    return total, by_shape


def run_serve_edge(device) -> dict:
    """examples/torch_serve_edge.py on the card (FELARE routing qwen1.5-0.5b
    and whisper-medium requests over four machine groups, executing every
    started request): its real prefill calls, flash launches equal to the
    calls' attention blocks. Returns its launch counts."""
    import importlib.util

    from repro_torch.configs import get_smoke_config

    spec = importlib.util.spec_from_file_location(
        "torch_serve_edge", ROOT / "examples" / "torch_serve_edge.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    reset_counts()
    t0 = time.perf_counter()
    out = example.serve(EDGE_REQUESTS, EDGE_RATE, device=device)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    blocks = []
    for arch in example.ARCHS:
        cfg = get_smoke_config(arch)
        blocks.append(cfg.encoder_layers + 2 * cfg.n_layers
                      if cfg.family == "audio" else cfg.n_layers)
    expect = {"flash_attention": sum(c * b for c, b in zip(
        out["prefill_calls"], blocks)), "decode_attention": 0}
    m = out["metrics"]
    emit("serve_edge", device=out["device"], requests=EDGE_REQUESTS,
         rate=EDGE_RATE, archs=list(example.ARCHS),
         executed=out["executed"], prefill_calls=out["prefill_calls"],
         base_latency_ms=[x * 1e3 for x in out["base_latency_s"]],
         completion=m["collective_completion_rate"],
         completion_by_type=m["completion_rate_by_type"].tolist(),
         jain=m["jain_fairness"], energy=float(m["energy"]),
         seconds=seconds, launches={k: counts[k] for k in expect},
         expected=expect)
    require(out["executed"] > 0, "serve_edge: no request was executed")
    for k, v in expect.items():
        require(counts[k] == v, f"serve_edge: {k}: {counts[k]} launches, "
                                f"{v} expected")
    return {k: counts[k] for k in expect}


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------
def train_job(device, steps: int, **kw):
    from repro_torch.configs import get_config
    from repro_torch.train import TRAIN_IMPLS
    from repro_torch.train.loop import TrainJob

    cfg = get_config(TRAIN_ARCH).scaled(**TRAIN_IMPLS)
    return TrainJob(cfg=cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    accum=TRAIN_ACCUM, lr=TRAIN_LR, device=device, **kw)


def lm_head_ms(device, cfg, params) -> float:
    """Device ms of one step's LM head and loss (forward, the chunk's
    recompute and backward), over the step's microbatches: the chunked
    loss on a bf16 hidden state that requires grad, by CUDA events."""
    import torch

    from repro_torch.train import chunked_lm_loss

    mb = TRAIN_BATCH // TRAIN_ACCUM
    gen = torch.Generator(device=device).manual_seed(0)
    hidden = torch.randn((mb, TRAIN_SEQ, cfg.d_model), generator=gen,
                         device=device).to(cfg.act_dtype).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (mb, TRAIN_SEQ),
                           generator=gen, device=device)
    mask = torch.ones((mb, TRAIN_SEQ), device=device)
    embed = {k: v.detach().requires_grad_() for k, v in
             params["embed"].items()}

    def call():
        loss, _ = chunked_lm_loss(cfg, {"embed": embed}, hidden, labels,
                                  mask)
        torch.autograd.grad(loss, [hidden, *embed.values()])
    return time_ms(call, 3) * TRAIN_ACCUM


def run_train(device) -> dict:
    """Phase 8f: (a) qwen1.5-0.5b trains TRAIN_STEPS steps at full width
    through ``train.loop.run`` on the card, with no kernel launch; (b) the
    same job, interrupted at a checkpoint and resumed, ends bit for bit
    where the uninterrupted one does, under deterministic algorithms; (c)
    each family's smoke config's first-step loss and gradients on the card
    against the CPU, and the kernel path refused. Returns the launch
    counts of (a)."""
    import shutil

    import torch

    from repro_torch import tree as tr
    from repro_torch.configs import get_smoke_config
    from repro_torch.datapipe.synthetic import SyntheticLM
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW
    from repro_torch.train import TRAIN_IMPLS, make_grad_step, \
        make_train_step
    from repro_torch.train.loop import SimulatedFailure, run, \
        run_with_restarts

    card = nvidia_smi()
    # (a) -----------------------------------------------------------------
    job = train_job(device, TRAIN_STEPS)
    cfg = job.cfg
    require(cfg.remat and cfg.param_dtype == "bfloat16"
            and cfg.n_layers == 24 and cfg.d_model == 1024
            and cfg.vocab_size == 151_936,
            f"train: {TRAIN_ARCH} is not at its published size")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    stamps = []
    reset_counts()
    t0 = time.perf_counter()
    params, opt_state, hist = run(
        job, on_step=lambda step, rec: stamps.append(time.perf_counter()))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    # step 0 also holds the init and the allocator's first growth
    ms_per_step = (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    first5 = sum(losses[:5]) / 5
    last5 = sum(losses[-5:]) / 5
    n_params = sum(t.numel() for t in tr.leaves(params))
    emit("train", arch=TRAIN_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, params=n_params, param_dtype=cfg.param_dtype,
         remat=cfg.remat, attn_impl=cfg.attn_impl, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, accum=TRAIN_ACCUM, steps=TRAIN_STEPS, lr=TRAIN_LR,
         losses=losses, grad_norms=norms, first5_mean=first5,
         last5_mean=last5, seconds=seconds, first_step_ms=(
             stamps[0] - t0) * 1e3, ms_per_step=ms_per_step,
         tokens_per_s=tokens / ms_per_step * 1e3, peak_memory_bytes=peak,
         launches=counts, card=card)
    require(all(map(math.isfinite, losses + norms)),
            "train: a non-finite loss or grad norm")
    require(last5 < first5, f"train: the loss did not fall ({first5} -> "
                            f"{last5})")
    require(not any(counts.values()),
            f"train: kernels launched on the training path: {counts}")

    step_fn = make_train_step(cfg, AdamW(lr=TRAIN_LR), donate=False,
                              device=device)
    batch = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        accum=TRAIN_ACCUM).batch_at(TRAIN_STEPS)
    split = device_split(lambda: step_fn(params, opt_state, batch),
                         host_ops=False)
    head = lm_head_ms(device, cfg, params)
    emit("train_profile", arch=TRAIN_ARCH, step=split,
         idle_share=1 - split["device_busy_ms"] / split["wall_ms_profiled"],
         lm_head_and_loss_ms=head,
         lm_head_share_of_busy=head / split["device_busy_ms"], card=card)
    del params, opt_state, step_fn
    torch.cuda.empty_cache()

    # (b) -----------------------------------------------------------------
    ckpt_dir = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env_before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        pa, sa, _ = run(train_job(device, RESTART_STEPS))
        whole_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pb, sb, hist_b, restarts = run_with_restarts(
            train_job(device, RESTART_STEPS, ckpt_dir=str(ckpt_dir),
                      ckpt_every=RESTART_AT),
            failures={RESTART_AT: SimulatedFailure("preempted")})
        interrupted_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in
                         (ckpt_dir / f"step_{RESTART_AT:08d}").iterdir())
        differ = [n for (n, a), b in zip(tr.named_leaves((pa, sa)),
                                         tr.leaves((pb, sb)))
                  if not torch.equal(a, b)]
    finally:
        torch.use_deterministic_algorithms(False)
        if env_before is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env_before
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit("train_restart", arch=TRAIN_ARCH, steps=RESTART_STEPS,
         failure_at=RESTART_AT, restarts=restarts,
         resumed_at=hist_b[0]["step"], leaves=len(tr.leaves((pa, sa))),
         leaves_differ=differ, checkpoint_bytes=ckpt_bytes,
         uninterrupted_seconds=whole_s, interrupted_seconds=interrupted_s,
         cut=f"{RESTART_STEPS} of the {TRAIN_STEPS} steps", card=card)
    require(restarts == 1 and hist_b[0]["step"] == RESTART_AT,
            f"train_restart: {restarts} restarts, resumed at "
            f"{hist_b[0]['step']}")
    require(not differ, f"train_restart: leaves differ after the restart: "
                        f"{differ[:5]}")
    del pa, sa, pb, sb
    torch.cuda.empty_cache()

    # (c) -----------------------------------------------------------------
    errs = {}
    for family, arch in TRAIN_FAMILIES.items():
        fcfg = get_smoke_config(arch).scaled(
            **TRAIN_IMPLS, dtype="float32", param_dtype="float32")
        host = transformer.init(fcfg, seed=0, device="cpu")
        card_params = transformer.tree_map(lambda t: t.to(device), host)
        b = SyntheticLM(fcfg, batch=4, seq=32, accum=2).batch_at(0)
        want, wm = make_grad_step(fcfg, device="cpu")(host, b)
        got, gm = make_grad_step(fcfg, device=device)(card_params, b)
        loss_rel = abs(float(gm["loss"]) - float(wm["loss"])) / abs(
            float(wm["loss"]))
        worst = 0.0
        for (name, w), g in zip(tr.named_leaves(want), tr.leaves(got)):
            scale = float(w.abs().max())
            err = float((g.cpu() - w).abs().max()) / max(scale, 1e-30)
            require(math.isfinite(err), f"train_families {arch}: {name} "
                                        f"is not finite")
            if err >= worst:
                worst, worst_leaf = err, name
        errs[arch] = {"family": family, "loss": float(gm["loss"]),
                      "loss_rel": loss_rel, "grad_rel_of_max": worst,
                      "worst_leaf": worst_leaf,
                      "tokens": float(gm["tokens"])}
        require(loss_rel <= TRAIN_GRAD_TOL and worst <= TRAIN_GRAD_TOL,
                f"train_families {arch}: card against CPU: loss rel "
                f"{loss_rel}, grad {worst} of max at {worst_leaf}")
    refused = []
    try:
        make_train_step(get_smoke_config(TRAIN_ARCH), AdamW(), device=device)
    except ValueError as e:
        refused.append(str(e))
    q = torch.randn((1, 16, 2, 64), device=device, requires_grad=True)
    before = flash_ops.LAUNCHES["flash_attention"]
    try:
        flash_ops.flash_attention(q, q.detach(), q.detach())
    except RuntimeError as e:
        refused.append(str(e))
    emit("train_families", tolerance=TRAIN_GRAD_TOL, dtype="float32",
         tf32=False, by_arch=errs, kernel_path_refused=refused)
    require(len(refused) == 2
            and flash_ops.LAUNCHES["flash_attention"] == before,
            f"train_families: the kernel path was not refused: {refused}")
    return counts


# --------------------------------------------------------------------------
# The sharded substrate at world size 1
# --------------------------------------------------------------------------
def _first_difference(a_tree, b_tree) -> tuple:
    """(leaves that differ, the largest |a - b| over max|b| among them,
    its leaf) of two trees of tensors in the same structure."""
    from repro_torch import tree as tr

    import torch

    differ, worst, where = [], 0.0, None
    for (name, a), b in zip(tr.named_leaves(a_tree), tr.leaves(b_tree)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            differ.append(name)
            rel = _of_max(a, b)
            if rel >= worst:
                worst, where = rel, name
    return differ, worst, where


def _timed(fn):
    """``(fn(), its wall ms)`` of one call between two syncs: a train or
    decode step changes its state, so it is timed once per call, not
    repeated as ``time_ms`` repeats a kernel."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sharded_train(device, mesh, init) -> dict:
    """(a) 3 train steps of qwen1.5-0.5b through make_train_step(cfg, opt,
    mesh) against the one-device step, each from a copy of ``init`` (the
    parameters) and the same batches."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as tr
    from repro_torch.configs import get_config
    from repro_torch.datapipe.synthetic import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW
    from repro_torch.train import TRAIN_IMPLS, make_train_step

    cfg = get_config(TRAIN_ARCH).scaled(**TRAIN_IMPLS)
    require(cfg.remat and cfg.param_dtype == "bfloat16"
            and cfg.n_layers == 24 and cfg.d_model == 1024
            and cfg.vocab_size == 151_936,
            f"sharded: {TRAIN_ARCH} is not at its published size")
    opt = AdamW(lr=TRAIN_LR)
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       accum=TRAIN_ACCUM)
    runs = {}
    for label in ("single", "meshed"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        params = transformer.tree_map(torch.clone, init)
        if label == "meshed":
            step = make_train_step(cfg, opt, mesh)
            params = sh.distribute(params, step.param_shardings)
            opt_state = opt.init(params)
            layouts = {"p": step.param_shardings, "o": step.opt_shardings}
            for (name, x), lay in zip(
                    tr.named_leaves({"p": params, "o": opt_state}),
                    tr.leaves(layouts)):
                require(isinstance(x, DTensor)
                        and tuple(x.placements) == lay.placements,
                        f"sharded: {name} is not in the reference's layout")
            step = step.jit_for(data.batch_at(0))
        else:
            step = make_train_step(cfg, opt, device=device)
            opt_state = opt.init(params)
        ms, losses, norms = [], [], []
        torch.cuda.reset_peak_memory_stats(device)
        for i in range(SHARDED_TRAIN_STEPS):
            batch = data.batch_at(i)
            (params, opt_state, m), t = _timed(
                lambda: step(params, opt_state, batch))
            ms.append(t)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs[label] = {"ms": ms, "loss": losses, "grad_norm": norms,
                       "peak_bytes": torch.cuda.max_memory_allocated(device)
                       - base,
                       "state": {"p": sh.to_local(params),
                                 "o": sh.to_local(opt_state)}}
    a, b = runs["meshed"], runs["single"]
    differ, worst, where = _first_difference(a["state"], b["state"])
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["loss"],
                                                       b["loss"]))
    out = {"arch": TRAIN_ARCH, "mesh": "(1, 1, 1) pod, data, model",
           "deterministic_algorithms": True,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "accum": TRAIN_ACCUM,
           "steps": SHARDED_TRAIN_STEPS,
           "loss": {k: runs[k]["loss"] for k in runs},
           "grad_norm": {k: runs[k]["grad_norm"] for k in runs},
           "ms_per_step": {k: runs[k]["ms"] for k in runs},
           "ms_per_step_after_first": {
               k: sum(runs[k]["ms"][1:]) / (SHARDED_TRAIN_STEPS - 1)
               for k in runs},
           # the run's own state and the steps' working set: the peak
           # over its steps above what was resident before its init
           "peak_bytes": {k: runs[k]["peak_bytes"] for k in runs},
           "leaves": len(tr.leaves(b["state"])),
           "bit_for_bit": not differ and a["loss"] == b["loss"]
           and a["grad_norm"] == b["grad_norm"],
           "leaves_differ": len(differ), "loss_rel": loss_rel,
           "largest_difference_of_max": worst, "at": where}
    if differ or a["loss"] != b["loss"]:
        # world size 1 has no cross-rank sum: any difference would be the
        # order of a reduction inside one device's kernels
        out["cause"] = "reduction order"
        require(loss_rel <= SHARDED_LOSS_REL
                and worst <= SHARDED_PARAM_OF_MAX,
                f"sharded train: meshed against single: loss rel "
                f"{loss_rel}, {worst} of max at {where}")
    return out


def sharded_serve(device, mesh, params) -> tuple:
    """(b) qwen1.5-0.5b prefill (8 x 1024) and 3 greedy decode steps
    through make_serve_steps(cfg, mesh) against the unmeshed steps: logits
    and every cache leaf bit for bit, the same flash and decode launches.
    Returns (the phase's numbers, the meshed run's launch counts)."""
    import numpy as np
    import torch

    from repro_torch import tree as tr
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer
    from repro_torch.train import make_serve_steps

    cfg = get_config(TRAIN_ARCH)
    require(cfg.attn_impl == "kernel", "sharded serve: not on the kernels")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)))}
    max_seq = SERVE_PROMPT + SHARDED_NEW
    # load (or, run alone, build) both kernels before either run is timed
    pre, dec = make_serve_steps(cfg, device=device)
    logits, cache = pre(params, {"tokens": batch["tokens"][:1, :128]},
                        max_seq=129)
    dec(params, cache, logits.argmax(-1))
    runs = {}
    for label in ("unmeshed", "meshed"):
        if label == "meshed":
            p = sh.distribute(params, sh.param_shardings(params, mesh, cfg))
            prefill_for, decode_for = make_serve_steps(cfg, mesh)
            prefill = prefill_for(batch, max_seq)
        else:
            p = params
            prefill_step, decode_step = make_serve_steps(cfg, device=device)
            prefill = (lambda pp, bb: prefill_step(pp, bb, max_seq=max_seq))
        reset_counts()
        (logits, cache), pre_ms = _timed(lambda: prefill(p, batch))
        outs, dec_ms = [logits], []
        for _ in range(SHARDED_NEW):
            toks = sh.gather(logits).argmax(-1)
            if label == "meshed":
                cshard = sh.cache_sharding(cfg, mesh, cache)
                for (name, x), lay in zip(tr.named_leaves(cache),
                                          tr.leaves(cshard)):
                    require(tuple(x.placements) == lay.placements,
                            f"sharded serve: cache {name} layout")
                decode = decode_for(cache, toks)
            else:
                decode = decode_step
            (logits, cache), t = _timed(lambda: decode(p, cache, toks))
            outs.append(logits)
            dec_ms.append(t)
        counts = read_counts()
        runs[label] = {"logits": [sh.gather(x) for x in outs],
                       "cache": sh.to_local(cache), "counts": counts,
                       "prefill_ms": pre_ms, "decode_ms": dec_ms}
    a, b = runs["meshed"], runs["unmeshed"]
    logits_equal = all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                         b["logits"]))
    differ, worst, where = _first_difference(a["cache"], b["cache"])
    kernels = ("flash_attention", "decode_attention")
    out = {"arch": TRAIN_ARCH, "mesh": "(1, 1) data, model",
           "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
           "new_tokens": SHARDED_NEW, "logits_bit_for_bit": logits_equal,
           "cache_leaves": len(tr.leaves(b["cache"])),
           "cache_leaves_differ": differ,
           "launches": {k: {r: runs[r]["counts"][k] for r in runs}
                        for k in kernels},
           "prefill_ms": {r: runs[r]["prefill_ms"] for r in runs},
           "decode_ms": {r: runs[r]["decode_ms"] for r in runs}}
    require(logits_equal, "sharded serve: meshed logits differ")
    require(not differ, f"sharded serve: cache leaves differ: {differ} "
                        f"({worst} of max at {where})")
    for k in kernels:
        require(a["counts"][k] == b["counts"][k] > 0,
                f"sharded serve: {k}: {a['counts'][k]} meshed launches, "
                f"{b['counts'][k]} unmeshed")
    require(a["counts"]["flash_attention"] == cfg.n_layers
            and a["counts"]["decode_attention"] == cfg.n_layers * SHARDED_NEW,
            f"sharded serve: launches {a['counts']}")
    return out, a["counts"]


def sharded_collectives(device) -> dict:
    """(c) ring attention, gpipe over one stage and the compressed mean at
    world size 1 against what they reduce to."""
    import torch

    from repro_torch.distributed import compression as comp
    from repro_torch.distributed.pipeline import gpipe, stack_stages
    from repro_torch.distributed.ring_attention import ring_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import sdpa_plain

    gen = torch.Generator(device=device).manual_seed(0)
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    q, k, v = (torch.randn((2, 256, 4, 64), generator=gen, device=device)
               * 0.5 for _ in range(3))
    ring = {}
    for causal in (True, False):
        got = ring_attention(q, k, v, mesh, "model", causal=causal)
        want = sdpa_plain(q, k, v, causal=causal)
        ring[causal] = float((got.to_local() - want).abs().max())
    require(max(ring.values()) <= 1e-5,
            f"sharded: ring attention against plain: {ring}")

    pipe = make_mesh((1,), ("pipe",), device=device)
    W = (torch.randn((4, 64, 64), generator=gen, device=device)
         * 64 ** -0.5).requires_grad_(True)
    xs = torch.randn((6, 8, 64), generator=gen, device=device)

    def stage(Ws, x):
        for i in range(Ws.shape[0]):
            x = torch.tanh(x @ Ws[i])
        return x
    got = gpipe(stage, pipe, "pipe")(stack_stages({"w": W}, 1)["w"], xs)
    g_pipe, = torch.autograd.grad((got ** 2).mean(), [W])
    want = torch.stack([stage(W, xs[m]) for m in range(xs.shape[0])])
    g_seq, = torch.autograd.grad((want ** 2).mean(), [W])
    pipe_err = float((got - want).detach().abs().max())
    pipe_grad_err = float((g_pipe - g_seq).abs().max())
    require(pipe_err <= 1e-6 and pipe_grad_err <= 1e-6,
            f"sharded: gpipe over one stage: {pipe_err}, {pipe_grad_err}")

    pod = make_mesh((1, 1, 1), ("pod", "data", "model"), device=device)
    g = {"w": torch.randn((1024, 1024), generator=gen, device=device),
         "b": torch.randn((1024,), generator=gen, device=device)
         .to(torch.bfloat16)}
    mean, res = comp.crosspod_mean_compressed(
        g, comp.init_residuals(g), pod.get_group("pod"))
    comp_equal = True
    for name, x in g.items():
        qq, s = comp.quantize_int8(x.float())
        deq = comp.dequantize_int8(qq, s)
        comp_equal &= (mean[name].dtype == x.dtype
                       and torch.equal(mean[name], deq.to(x.dtype))
                       and torch.equal(res[name], x.float() - deq))
    require(comp_equal, "sharded: the compressed mean over one rank is not "
                        "the quantize-dequantize of the gradient")
    return {"ring_max_abs_err": {str(c): e for c, e in ring.items()},
            "gpipe_max_abs_err": pipe_err,
            "gpipe_grad_max_abs_err": pipe_grad_err,
            "gpipe_bit_for_bit": pipe_err == 0 and pipe_grad_err == 0,
            "compressed_equals_quantize_dequantize": comp_equal}


def sharded_sweep(device) -> tuple:
    """(d) run_sweep(shard=True) on the flat FELARE spec equals shard=False
    bit for bit (one card: the plain path, as in the reference)."""
    import hashlib

    from repro_torch.distributed import sharding as sh
    from repro_torch.experiments import SweepSpec, run_sweep

    spec = SweepSpec(system="paper", rates=SHARDED_RATES,
                     reps=SHARDED_REPS, n_tasks=SHARDED_TASKS,
                     heuristics=("FELARE",), seed=0, use_fused_map=True)
    reset_counts()
    digests = {}
    for shard in (False, True):
        res = run_sweep(spec, device=device, shard=shard)
        digests[shard] = metrics_digest(res, "FELARE")
    counts = read_counts()
    devices = sh.sweep_devices(device)
    require(digests[True] == digests[False],
            "sharded: run_sweep(shard=True) differs from shard=False")
    require(devices is None or len(devices) > 1,
            f"sharded: sweep devices {devices}")
    return {"devices": None if devices is None else len(devices),
            "one_card_plain_path": devices is None,
            "sha256": digests[True], "traces": len(SHARDED_RATES)
            * SHARDED_REPS, "tasks": SHARDED_TASKS}, counts


def run_sharded(device) -> dict:
    """Phase 8g: the sharded substrate on a process group of one rank
    (NCCL, through a file:// store), alone on the card. Returns the
    launch counts of the meshed serve and the sweep."""
    import datetime
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    try:
        dev = mesh_mod.init_distributed(
            device, init_method=f"file://{store}/store", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=120))
        backend = dist.get_backend()
        require(backend == "nccl", f"sharded: backend {backend}")
        mesh3 = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"),
                                   device=dev)
        mesh2 = mesh_mod.make_mesh((1, 1), ("data", "model"), device=dev)
        # the embedding's backward accumulates with atomics unless asked
        # not to: two runs of a step agree bit for bit only under
        # deterministic algorithms (CUBLAS_WORKSPACE_CONFIG is set by
        # group_sharded before the first cuBLAS call)
        # qwen1.5-0.5b's parameters, drawn once (torch.Generator seed 0):
        # each training run starts from a copy, the serve steps read them
        init = transformer.init(
            get_config(TRAIN_ARCH),
            torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.use_deterministic_algorithms(True)
        try:
            train = sharded_train(dev, mesh3, init)
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()
        serve, counts = sharded_serve(dev, mesh2, init)
        del init
        torch.cuda.empty_cache()
        collectives = sharded_collectives(dev)
        sweep, sweep_counts = sharded_sweep(dev)
        for k, v in sweep_counts.items():
            counts[k] = counts.get(k, 0) + v
        dist.destroy_process_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    emit("sharded", world_size=1, backend=backend, train=train,
         serve=serve, collectives=collectives, sweep=sweep,
         seconds=time.perf_counter() - t0, card=nvidia_smi(),
         note="one card: collectives across cards wait for a machine "
              "with more than one")
    return counts


# --------------------------------------------------------------------------
# The sharded substrate across cards (--mesh-check, under torchrun)
# --------------------------------------------------------------------------
MESH_CHECK_ARCH = "internlm2-1.8b"    # the CPU tests' setup, float32
MESH_CHECK_B, MESH_CHECK_SEQ, MESH_CHECK_CLIP = 8, 32, 0.05


def _worst(x: float) -> float:
    """The largest of every rank's ``x``."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64,
                     device=torch.device("cuda", torch.cuda.current_device())
                     if torch.cuda.is_available() else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _of_max(a, b) -> float:
    """max|a - b| over max|b| of two tensors."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _check_meshes(world: int) -> list:
    """(name, shape, axes): the host mesh (world / 2, 2) and, when four
    divide the world, (2, world / 4, 2) over (pod, data, model)."""
    out = [(f"{world // 2}x2", (world // 2, 2), ("data", "model"))]
    if world % 4 == 0:
        out.append((f"2x{world // 4}x2", (2, world // 4, 2),
                    ("pod", "data", "model")))
    return out


def mesh_train_f32(device, world: int) -> dict:
    """The sharded train step against the one-device step on each rank's
    own card: internlm2-1.8b's smoke config in float32, batch 8, seq 32,
    2 microbatches, AdamW(lr=1e-3), with and without clipping."""
    import torch

    from repro_torch import tree as tr
    from repro_torch.configs import get_smoke_config
    from repro_torch.datapipe.synthetic import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW
    from repro_torch.train import TRAIN_IMPLS, make_grad_step, \
        make_train_step

    cfg = get_smoke_config(MESH_CHECK_ARCH).scaled(
        **TRAIN_IMPLS, dtype="float32", param_dtype="float32")
    batch = SyntheticLM(cfg, batch=MESH_CHECK_B, seq=MESH_CHECK_SEQ,
                        accum=2).batch_at(0)
    params = transformer.init(cfg, seed=0, device=device)
    grads, _ = make_grad_step(cfg, device)(params, batch)
    out = {}
    for name, shape, axes in _check_meshes(world):
        mesh = make_mesh(shape, axes, device=device)
        for clip in (1.0, MESH_CHECK_CLIP):
            opt = AdamW(lr=1e-3, clip_norm=clip)
            p1, o1, m1 = make_train_step(cfg, opt, donate=False,
                                         device=device)(
                params, opt.init(params), batch)
            step = make_train_step(cfg, opt, mesh, donate=False)
            pd = sh.distribute(params, step.param_shardings)
            gd, _ = step.sharded_grads(pd, batch)
            p8, o8, m8 = step(pd, opt.init(pd), batch)
            loss_rel = abs(float(m8["loss"]) - float(m1["loss"])) / abs(
                float(m1["loss"]))
            norm_rel = abs(float(m8["grad_norm"]) - float(
                m1["grad_norm"])) / float(m1["grad_norm"])
            g_err = max(_of_max(a, b) for a, b in zip(
                tr.leaves(sh.gather(gd)), tr.leaves(grads)))
            p_err = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(tr.leaves(sh.gather(p8)),
                                        tr.leaves(p1)))
            mu_err = max(_of_max(a, b) for a, b in zip(
                tr.leaves(sh.gather(o8.mu)), tr.leaves(o1.mu)))
            row = {"loss_rel": _worst(loss_rel),
                   "grad_norm_rel": _worst(norm_rel),
                   "grads_of_max": _worst(g_err),
                   "params_max_abs": _worst(p_err),
                   "mu_of_max": _worst(mu_err),
                   "grad_norm": float(m1["grad_norm"])}
            out[f"{name} clip={clip}"] = row
            require(row["loss_rel"] <= 1e-6 and row["grad_norm_rel"] <= 1e-5
                    and row["grads_of_max"] <= 1e-5
                    and row["params_max_abs"] <= 2e-3
                    and row["mu_of_max"] <= 1e-5,
                    f"mesh_check train {name} clip={clip}: {row}")
    return out


def mesh_train_whole_batch(device, world: int) -> dict:
    """The sharded step where a rank's mean is not its share of the
    batch's loss, against each rank's one-device step: granite-moe's
    smoke config (its experts route the whole batch) and internlm2's
    under a mask that leaves each rank another token count, float32, on
    the (world / 2, 2) mesh."""
    import numpy as np

    from repro_torch import tree as tr
    from repro_torch.configs import get_smoke_config
    from repro_torch.datapipe.synthetic import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW
    from repro_torch.train import TRAIN_IMPLS, make_grad_step, \
        make_train_step

    mesh = make_mesh((world // 2, 2), ("data", "model"), device=device)
    out = {}
    for name, arch, masked in (("moe", "granite-moe-3b-a800m", False),
                               ("mask", MESH_CHECK_ARCH, True)):
        cfg = get_smoke_config(arch).scaled(
            **TRAIN_IMPLS, dtype="float32", param_dtype="float32")
        batch = SyntheticLM(cfg, batch=MESH_CHECK_B, seq=MESH_CHECK_SEQ,
                            accum=2).batch_at(0)
        if masked:
            batch["mask"] = (np.random.default_rng(1).random(
                batch["tokens"].shape) < 0.6).astype(np.float32)
        params = transformer.init(cfg, seed=0, device=device)
        opt = AdamW(lr=1e-3)
        grads, _ = make_grad_step(cfg, device)(params, batch)
        p1, _, m1 = make_train_step(cfg, opt, donate=False,
                                    device=device)(
            params, opt.init(params), batch)
        step = make_train_step(cfg, opt, mesh, donate=False)
        pd = sh.distribute(params, step.param_shardings)
        gd, _ = step.sharded_grads(pd, batch)
        pm, _, mm = step(pd, opt.init(pd), batch)
        row = {
            "loss_rel": _worst(abs(float(mm["loss"]) - float(m1["loss"]))
                               / abs(float(m1["loss"]))),
            "grad_norm_rel": _worst(abs(float(mm["grad_norm"]) - float(
                m1["grad_norm"])) / float(m1["grad_norm"])),
            "grads_of_max": _worst(max(_of_max(a, b) for a, b in zip(
                tr.leaves(sh.gather(gd)), tr.leaves(grads)))),
            "params_max_abs": _worst(max(
                float((a - b).abs().max()) for a, b in zip(
                    tr.leaves(sh.gather(pm)), tr.leaves(p1))))}
        out[name] = row
        require(row["loss_rel"] <= 1e-6 and row["grad_norm_rel"] <= 1e-5
                and row["grads_of_max"] <= 1e-5
                and row["params_max_abs"] <= 2e-3,
                f"mesh_check whole-batch train {name}: {row}")
    return out


def mesh_sweep(device) -> dict:
    """run_sweep(shard=True) over every visible card, in this one
    process, against shard=False on its own card, bit for bit: paper_x8
    FELARE under fair_spill on the map kernels (map_decide, evict_stats,
    balance_scan) and flat ELARE on phase1_map, 2 x 3 traces of 200
    tasks (6 traces: padded to a multiple of the cards)."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.experiments import SweepSpec, run_sweep

    devices = sh.sweep_devices(device)
    n = torch.cuda.device_count()
    require(devices is not None and len(devices) == n > 1,
            f"mesh_check sweep: devices {devices} of {n}")
    runs = (("paper_x8 FELARE fair_spill", "FELARE",
             ("map_decide", "evict_stats", "balance_scan"),
             SweepSpec(system="paper_x8", dispatcher="fair_spill",
                       rates=(16.0, 24.0), reps=3, n_tasks=200,
                       heuristics=("FELARE",), seed=0,
                       use_fused_map=True)),
            ("paper ELARE phase1", "ELARE", ("phase1_map",),
             SweepSpec(system="paper", rates=SHARDED_RATES, reps=3,
                       n_tasks=200, heuristics=("ELARE",), seed=0,
                       use_fused_phase1=True)))
    out = {"devices": len(devices)}
    for label, heuristic, kernels, spec in runs:
        row = {}
        for shard in (False, True):
            reset_counts()
            t0 = time.perf_counter()
            res = run_sweep(spec, device=device, shard=shard)
            row[f"shard={shard}"] = {
                "sha256": metrics_digest(res, heuristic),
                "seconds": time.perf_counter() - t0,
                "launches": {k: read_counts()[k] for k in kernels}}
        out[label] = row
        got, want = row["shard=True"], row["shard=False"]
        require(got["sha256"] == want["sha256"],
                f"mesh_check sweep {label}: shard=True differs: {row}")
        require(all(got["launches"][k] > 0 for k in kernels),
                f"mesh_check sweep {label}: launches {got['launches']}")
    return out


def mesh_serve_f32(device, world: int) -> dict:
    """Prefill (8 x 16 tokens) and 2 greedy decode steps through
    make_serve_steps(cfg, mesh) against the unmeshed steps on each rank's
    card, on the kernels: KV heads split over model on (world / 2, 2),
    the sequence on (1, world) (2 KV heads do not divide it)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.train import make_serve_steps

    cfg = get_smoke_config(MESH_CHECK_ARCH).scaled(dtype="float32",
                                                   param_dtype="float32")
    params = transformer.init(cfg, seed=0, device=device)
    gen = torch.Generator(device="cpu").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (MESH_CHECK_B, 16),
                                     generator=gen)}
    max_seq = 64
    pre, dec = make_serve_steps(cfg, device=device)
    reset_counts()
    logits, cache = pre(params, batch, max_seq=max_seq)
    want = [logits]
    for _ in range(2):
        logits, cache = dec(params, cache, logits.argmax(-1))
        want.append(logits)
    want_counts = read_counts()
    out = {}
    for name, shape in ((f"{world // 2}x2", (world // 2, 2)),
                        (f"1x{world}", (1, world))):
        mesh = make_mesh(shape, ("data", "model"), device=device)
        pd = sh.distribute(params, sh.param_shardings(params, mesh, cfg))
        prefill_for, decode_for = make_serve_steps(cfg, mesh)
        reset_counts()
        logits, cache = prefill_for(batch, max_seq)(pd, batch)
        got = [logits]
        for _ in range(2):
            toks = logits.full_tensor().argmax(-1)
            logits, cache = decode_for(cache, toks)(pd, cache, toks)
            got.append(logits)
        counts = read_counts()
        err = max(_of_max(g.full_tensor(), w) for g, w in zip(got, want))
        spec = sh.cache_sharding(cfg, mesh, cache)["k"].spec
        out[name] = {"logits_of_max": _worst(err), "k_spec": spec,
                     "flash": counts["flash_attention"],
                     "decode": counts["decode_attention"]}
        require(out[name]["logits_of_max"] <= 1e-5,
                f"mesh_check serve {name}: {out[name]}")
        for k in ("flash_attention", "decode_attention"):
            require(counts[k] == want_counts[k] > 0,
                    f"mesh_check serve {name}: {k} {counts[k]} meshed, "
                    f"{want_counts[k]} unmeshed")
    return out


def mesh_collectives(device, world: int) -> dict:
    """Ring attention, gpipe (and its gradient) and the compressed mean
    over every rank against what they compute on one card."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import compression as comp
    from repro_torch.distributed.pipeline import gpipe, stack_stages
    from repro_torch.distributed.ring_attention import ring_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import sdpa_plain

    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((2, 64 * world, 4, 64), generator=gen,
                           device=device) * 0.5 for _ in range(3))
    ring_mesh = make_mesh((world,), ("model",), device=device)
    ring = {}
    for causal in (True, False):
        got = ring_attention(q, k, v, ring_mesh, "model", causal=causal)
        ring[str(causal)] = _worst(float((got.full_tensor() - sdpa_plain(
            q, k, v, causal=causal)).abs().max()))
    pipe = make_mesh((world,), ("pipe",), device=device)
    W = (torch.randn((2 * world, 64, 64), generator=gen, device=device)
         * 64 ** -0.5).requires_grad_(True)
    xs = torch.randn((6, 8, 64), generator=gen, device=device)

    def stage(Ws, x):
        for i in range(Ws.shape[0]):
            x = torch.tanh(x @ Ws[i])
        return x
    got = gpipe(stage, pipe, "pipe")(stack_stages({"w": W}, world)["w"], xs)
    g_pipe, = torch.autograd.grad((got ** 2).mean(), [W])
    want = torch.stack([stage(W, xs[m]) for m in range(xs.shape[0])])
    g_seq, = torch.autograd.grad((want ** 2).mean(), [W])
    rank = dist.get_rank()
    per = W.shape[0] // world
    mine = slice(rank * per, (rank + 1) * per)
    pipe_err = _worst(float((got - want).detach().abs().max()))
    grad_err = _worst(float((g_pipe[mine] - g_seq[mine]).abs().max()))
    pod = make_mesh((world,), ("pod",), device=device)
    g = torch.randn((4, 1024), generator=torch.Generator(
        device=device).manual_seed(100 + rank), device=device)
    mean, res = comp.crosspod_mean_compressed({"g": g}, {
        "g": torch.zeros_like(g)}, pod.get_group("pod"))
    every = [torch.empty_like(g) for _ in range(world)]
    dist.all_gather(every, g)
    # compression.py:47-66 on the gathered gradients, on this card
    s = max((torch.clamp(x.abs().max(), min=1e-12) / 127.0 for x in every),
            key=float)
    qs = [torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
          for x in every]
    total = torch.stack([x.to(torch.int32) for x in qs]).sum(0)
    comp_equal = bool(torch.equal(mean["g"], total.float() * s / world)
                      and torch.equal(res["g"], g - qs[rank].float() * s))
    flag = torch.tensor([0.0 if comp_equal else 1.0], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    out = {"ring_max_abs_err": ring, "gpipe_max_abs_err": pipe_err,
           "gpipe_grad_max_abs_err": grad_err,
           "compressed_bit_for_bit": float(flag) == 0.0}
    require(max(ring.values()) <= 1e-5 and pipe_err <= 1e-5
            and grad_err <= 1e-5 and out["compressed_bit_for_bit"],
            f"mesh_check collectives: {out}")
    return out


def mesh_train_full(device, world: int) -> dict:
    """8f's training cell (qwen1.5-0.5b, bf16, 8 x 512 in 2 microbatches)
    for 3 steps on the (world / 2, 2) mesh, each rank's one-device run of
    the same steps beside it: ms per step and peak memory both ways."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.datapipe.synthetic import SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW
    from repro_torch.train import TRAIN_IMPLS, make_train_step

    cfg = get_config(TRAIN_ARCH).scaled(**TRAIN_IMPLS)
    opt = AdamW(lr=TRAIN_LR)
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       accum=TRAIN_ACCUM)
    mesh = make_mesh((world // 2, 2), ("data", "model"), device=device)
    out = {}
    for label in ("single", "meshed"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        params = transformer.init(cfg, seed=0, device=device)
        if label == "meshed":
            step = make_train_step(cfg, opt, mesh)
            params = sh.distribute(params, step.param_shardings)
        else:
            step = make_train_step(cfg, opt, device=device)
        state = opt.init(params)
        torch.cuda.reset_peak_memory_stats(device)
        ms, losses = [], []
        for i in range(SHARDED_TRAIN_STEPS):
            batch = data.batch_at(i)
            (params, state, m), t = _timed(lambda: step(params, state,
                                                        batch))
            ms.append(t)
            losses.append(float(m["loss"]))
        out[label] = {"ms_per_step": ms, "loss": losses,
                      "peak_bytes": torch.cuda.max_memory_allocated(device)
                      - base}
        del params, state
    first = abs(out["meshed"]["loss"][0] - out["single"]["loss"][0]) / abs(
        out["single"]["loss"][0])
    out["first_loss_rel"] = _worst(first)
    require(all(map(math.isfinite, out["meshed"]["loss"]))
            and out["first_loss_rel"] <= 1e-3,
            f"mesh_check train_full: {out}")
    return out


def mesh_check(device=None) -> int:
    """``torchrun --nproc-per-node N chip_smoke.py --mesh-check``: the
    sharded substrate across N cards (N even, NCCL), each check against
    what one card computes; rank 0 prints one ``mesh_check`` line with
    the cards' name and power limit."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_mod

    require("WORLD_SIZE" in os.environ, "--mesh-check runs under torchrun")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = mesh_mod.init_distributed(
        device, timeout=datetime.timedelta(seconds=300))
    rank, world = dist.get_rank(), dist.get_world_size()
    require(world > 1 and world % 2 == 0,
            f"--mesh-check wants an even number of ranks, not {world}")
    if rank == 0 and dev.type == "cuda":
        build.build(("flash_attention", "decode_attention", "map_fused",
                     "phase1_map", "balance_scan"))
    dist.barrier()
    out = {"train_f32": mesh_train_f32(dev, world),
           "train_whole_batch": mesh_train_whole_batch(dev, world),
           "serve_f32": mesh_serve_f32(dev, world),
           "collectives": mesh_collectives(dev, world)}
    if dev.type == "cuda":
        out["train_full"] = mesh_train_full(dev, world)
        if rank == 0:       # one process over every card; the rest wait
            out["sweep"] = mesh_sweep(dev)
        dist.barrier()
    if rank == 0:
        emit("mesh_check", world_size=world, backend=dist.get_backend(),
             seconds=time.perf_counter() - t0, card=nvidia_smi(), **out)
    dist.destroy_process_group()
    return 0


# --------------------------------------------------------------------------
# The serving front: the router and the elastic launcher
# --------------------------------------------------------------------------
def router_name(heuristic: str, fused) -> str:
    return heuristic if fused is None else \
        f"{heuristic}_FUSED_{fused.upper()}"


def run_router(device) -> dict:
    """launch/serve.py's loop on the card (400 requests at 1000/s over the
    default four archs and four machine groups) under each of
    ``ROUTER_RUNS``, the fused ones registered under names: every
    ``metrics()`` field equal to its plain run's on the card and to the
    same name's run on the CPU, and each run's launches equal to its
    policy calls (FELARE on the map kernels: one evict_stats and one
    map_decide per call). Returns the launch counts of the card's runs."""
    import numpy as np

    from repro_torch.core import policy
    from repro_torch.launch import serve

    wrap = {"map": policy.with_fused_map, "phase1": policy.with_fused_phase1}
    for heuristic, fused in ROUTER_RUNS:
        if fused is not None:
            policy.register(router_name(heuristic, fused),
                            wrap[fused](heuristic), overwrite=True)

    def run(name, dev, requests=ROUTER_REQUESTS):
        args = serve.parse_args([
            "--requests", str(requests), "--rate", str(ROUTER_RATE),
            "--heuristic", name, "--device", str(dev)])
        reset_counts()
        t0 = time.perf_counter()
        router = serve.run(args)
        return router, time.perf_counter() - t0, read_counts()

    for heuristic, fused in ROUTER_RUNS:      # warm-up: first launches
        run(router_name(heuristic, fused), device, requests=20)
    total, metrics = {}, {}
    for heuristic, fused in ROUTER_RUNS:
        name = router_name(heuristic, fused)
        router, seconds, counts = run(name, device)
        cpu, cpu_seconds, _ = run(name, "cpu")
        m = router.metrics()
        metrics[name] = m
        calls = router.map_calls
        expect = {"map_decide": calls if fused == "map" else 0,
                  "evict_stats": calls if fused == "map"
                  and heuristic == "FELARE" else 0,
                  "phase1_map": calls if fused == "phase1" else 0}
        emit("router", heuristic=heuristic, fused=fused, device=str(device),
             requests=ROUTER_REQUESTS, rate=ROUTER_RATE,
             map_calls=calls, mean_tasks_per_call=router.map_tasks / calls,
             host_ms_per_map_event=router.map_seconds / calls * 1e3,
             cpu_host_ms_per_map_event=cpu.map_seconds / cpu.map_calls * 1e3,
             seconds=seconds, cpu_seconds=cpu_seconds,
             launches={k: counts[k] for k in expect}, expected=expect,
             completion=m["collective_completion_rate"],
             jain=m["jain_fairness"], energy=float(m["energy"]),
             energy_wasted=float(m["energy_wasted"]),
             completed=m["completed"].tolist(), missed=m["missed"].tolist(),
             cancelled=m["cancelled"].tolist())
        for k, v in expect.items():
            require(counts[k] == v, f"router {name}: {k}: {counts[k]} "
                                    f"launches, {v} expected")
        for label, other in (("cpu", cpu.metrics()),
                             ("plain", metrics[heuristic])):
            for k, v in other.items():
                require(np.array_equal(np.asarray(m[k]), np.asarray(v)),
                        f"router {name}: {k} differs from the {label} run")
        for k in expect:
            total[k] = total.get(k, 0) + counts[k]
    return total


def run_elastic(device) -> None:
    """launch/elastic.py at its defaults (paper_x4, 400 tasks at 6/s, site
    1 out for the middle half) on the card and on the CPU: the same
    result."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.launch import elastic

    res, text = {}, {}
    for dev in ("cuda", "cpu"):
        dev = str(device) if dev == "cuda" else dev
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res[dev] = elastic.main(["--device", dev])
        text[dev] = (buf.getvalue(), time.perf_counter() - t0)
    card, cpu = res[str(device)], res["cpu"]
    emit("elastic", device=str(device), ontime=card["ontime"],
         orphans=card["orphans"],
         min_sites_live=card["min_sites_live"],
         healthy_min=int(card["healthy"].min()),
         summary=text[str(device)][0].splitlines()[:2],
         seconds=text[str(device)][1], cpu_seconds=text["cpu"][1])
    require(text[str(device)][0] == text["cpu"][0],
            "elastic: the card's printout differs from the CPU's")
    for k, v in cpu.items():
        require(np.array_equal(np.asarray(card[k]), np.asarray(v)),
                f"elastic: {k} differs from the CPU run")
    require(card["min_sites_live"] < 4, "elastic: no site left the fleet")


def profile_sim(label: str, sim, flat, steps: int, windows: int = 1
                ) -> float:
    """Profile ``steps`` batched iterations of ``sim`` on ``flat`` after a
    warm-up; emit where the time goes and return the kernels launched per
    iteration.

    The run launches the same kernels every time, but torch.profiler
    loses some of their records in many windows and never adds one
    (paper_x2's window read 403.4, 405.0 and 408.8 kernels per iteration
    in three runs of the same code; four windows of one run counted
    22843, 23102, 23099 and 23101 records). So a count that a check
    reads is profiled in ``windows`` windows and the one with the most
    records is kept; every count is reported. Each window costs seconds
    (``key_averages``), so the others take one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sim(flat)                                            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim(flat)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    counts, best = [], None
    for _ in range(windows):
        # the device's records alone: the host's op records are not read,
        # and building them cost each window seconds in key_averages
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim(flat)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        require(bool(kernels), f"{label}: the profiler recorded no kernel")
        counts.append(sum(e.count for e in kernels))
        if best is None or counts[-1] > best[0]:
            best = (counts[-1], kernels, wall)
    count, kernels, wall = best
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    per_iteration = count / steps
    emit("profile", run=label, replicates=int(flat.arrival.shape[0]),
         iterations=steps, records_per_window=counts,
         wall_ms_per_iteration=wall_plain * 1e3 / steps,
         wall_ms_per_iteration_profiled=wall * 1e3 / steps,
         device_busy_ms_per_iteration=busy_us * 1e-3 / steps,
         device_idle_share=1.0 - busy_us * 1e-6 / wall_plain,
         kernels_per_iteration=per_iteration,
         top_kernels=[{"name": e.key[:60],
                       "us_per_launch": e.self_device_time_total
                       / e.count, "launches": e.count} for e in top],
         ours_us_per_launch={
             name: next((e.self_device_time_total / e.count
                         for e in kernels if f"{name}_kernel" in e.key),
                        None)
             for name in KERNEL_SOURCES})
    return per_iteration


def profile_main_path(device, reps: int, n_tasks: int, fed_reps: int,
                      steps: int = 64):
    """Where the time of one batched event goes: the first ``steps``
    iterations of the flat fused FELARE and phase1 ELARE sweeps, of the
    flat fused FELARE sweep with all four observers and with ``task_log``
    alone, then of
    the federated fused FELARE + fair_spill sweep on paper_x2 and on
    paper_x8, whose kernels per iteration must agree within 2, and of the
    faulted paper_x8 sweeps (the outage under health_aware, churn under
    fair_spill)."""
    import torch

    from repro_torch import scenarios
    from repro_torch.core import api, dispatch, engine, policy

    system = api.paper_system()
    traces = scenarios.DEFAULT.stack(0, RATES, reps, n_tasks, system.eet,
                                     device=device)
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    for label, pol, observers in (
            ("FELARE fused_map", policy.with_fused_map("FELARE"), ()),
            ("ELARE fused_phase1", policy.with_fused_phase1("ELARE"), ()),
            ("FELARE fused_map observed", policy.with_fused_map("FELARE"),
             OBSERVERS),
            ("FELARE fused_map task_log", policy.with_fused_map("FELARE"),
             ("task_log",))):
        sim = engine.make_simulator(
            pol, system.as_torch(device), queue_size=system.queue_size,
            max_steps=steps, observers=observers)
        profile_sim(label, sim, flat, steps)

    per_iteration = {}
    for name, sites in (("paper_x2", 2), ("paper_x8", 8)):
        system = scenarios.get_fleet(name).build()
        traces = scenarios.DEFAULT.stack(
            0, tuple(sites * r for r in RATES), fed_reps, FED_TASKS,
            system.eet, device=device)
        flat = type(traces)(*(x.reshape((-1,) + x.shape[2:])
                              for x in traces))
        sim = engine.make_simulator(
            policy.with_fused_map("FELARE"), system.as_torch(device),
            queue_size=system.queue_size, max_steps=steps,
            dispatcher=dispatch.with_fused_balance("fair_spill"),
            site_of_machine=system.site_of_machine)
        per_iteration[name] = profile_sim(
            f"FELARE fair_spill fused_map {name}", sim, flat, steps,
            windows=3)
    require(abs(per_iteration["paper_x2"] - per_iteration["paper_x8"]) <= 2,
            f"kernels per iteration grow with the sites: {per_iteration}")

    # the faulted paper_x8 runs, unobserved: the outage under health_aware
    # and churn under fair_spill (the first 64 iterations run whatever the
    # health: the faults stage issues the same ops on every event)
    faulted = {}
    for run in (FAULT_RUNS[0], FAULT_RUNS[2]):
        sim = engine.make_simulator(
            policy.with_fused_map(run[2]), system.as_torch(device),
            queue_size=system.queue_size, max_steps=steps,
            dispatcher=dispatch.with_fused_balance(run[3]),
            site_of_machine=system.site_of_machine,
            dynamics=fault_dynamics(run[4]))
        faulted[f"{run[3]}, {run[4]}"] = profile_sim(
            f"{run[2]} {run[3]} fused_map paper_x8, {run[4]}", sim, flat,
            steps)
    emit("profile", run="faulted against unfaulted paper_x8",
         kernels_per_iteration=faulted,
         unfaulted_kernels_per_iteration=per_iteration["paper_x8"])

    # the networked tiered_x4 FELARE + fair_spill run (the network phase's
    # third arm) against the same run without a network
    system = scenarios.get_fleet("tiered_x4").build()
    traces = scenarios.DEFAULT.stack(0, NET_RATES, NET_REPS, NET_TASKS,
                                     system.eet, device=device)
    flat = type(traces)(*(x.reshape((-1,) + x.shape[2:]) for x in traces))
    networked = {}
    for label, net in (("no network", None), ("harsh tiered",
                                              harsh_network())):
        sim = engine.make_simulator(
            policy.with_fused_map("FELARE"), system.as_torch(device),
            queue_size=system.queue_size, max_steps=steps,
            dispatcher=dispatch.with_fused_balance("fair_spill"),
            site_of_machine=system.site_of_machine, network=net,
            tier_of_site=system.tier_of_site)
        networked[label] = profile_sim(
            f"FELARE fair_spill fused_map tiered_x4, {label}", sim, flat,
            steps)
    emit("profile", run="networked against unnetworked tiered_x4",
         kernels_per_iteration=networked)

    # the scenarios phase: the seven workload scenarios as one batch, and
    # the synthetic fleets' shapes
    from repro_torch.core.types import Trace
    from repro_torch.experiments import SweepSpec

    system = api.paper_system()
    stacks = [SweepSpec(scenario=name).resolve_scenario().stack(
        0, RATES, reps, n_tasks, system.eet, device=device)
        for name in WORKLOAD_SCENARIOS]
    batch = Trace(*(torch.cat([x.reshape((-1,) + x.shape[2:])
                               for x in leaves]) for leaves in zip(*stacks)))
    sim = engine.make_simulator(
        policy.with_fused_map("FELARE"), system.as_torch(device),
        queue_size=system.queue_size, max_steps=steps)
    fleets = {"seven workload scenarios": profile_sim(
        "FELARE fused_map paper, seven workload scenarios", sim, batch,
        steps)}
    for run in (SCENARIO_RUNS[0], SCENARIO_RUNS[2], SCENARIO_RUNS[4]):
        spec = scenario_spec(run, reps, n_tasks)
        system = spec.resolve_system()
        traces = spec.resolve_scenario().stack(0, run[3], reps, n_tasks,
                                               system.eet, device=device)
        flat = type(traces)(*(x.reshape((-1,) + x.shape[2:])
                              for x in traces))
        disp = spec.dispatcher
        sim = engine.make_simulator(
            policy.with_fused_map(run[4]), system.as_torch(device),
            queue_size=system.queue_size, max_steps=steps,
            dispatcher=(dispatch.with_fused_balance(disp)
                        if system.n_sites > 1 else None),
            site_of_machine=system.site_of_machine)
        fleets[run[0]] = profile_sim(f"{run[0]} fused_map {run[6]}", sim,
                                     flat, steps)
    emit("profile", run="scenarios", kernels_per_iteration=fleets)


# --------------------------------------------------------------------------
# Times
# --------------------------------------------------------------------------
def time_ms(fn, iters: int) -> float:
    """Eager time per call by CUDA events: launches issued one after
    another from the host, so the host's own work per call shows."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call: the summed time of every kernel ``fn``
    launches, from ``torch.profiler`` over ``iters`` calls after warm-up
    (host work between launches does not count). torch.profiler was seen
    to drop device records late in a long process, so each attempt first
    counts the records of 3 calls, and a window of ``iters`` calls must
    hold exactly that count per call; an attempt whose counts disagree is
    made again, up to three times in all, and then the run fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        return (sum(e.count for e in events),
                sum(e.self_device_time_total for e in events))

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        per3, _ = window(3)
        count, us = window(iters)
        seen.append((per3, count))
        if per3 > 0 and per3 % 3 == 0 and count == per3 // 3 * iters:
            return us * 1e-3 / iters
    raise AssertionError(
        f"torch.profiler lost device records three times in {iters} calls "
        f"of {getattr(fn, '__name__', 'a lambda')} (records in 3 calls, in "
        f"{iters} calls: {seen})")


def map_path_inputs(path: str, device) -> dict:
    """Map-kernel inputs at the shape each path gives the kernels: the flat
    sweep's 150 replicates; paper_x8's block fold, 150 x 8 rows of its 4
    machines each with its own EET table; tiered_x4's masked fold, 2 rates
    x 10 replicates x 4 sites, each row all 20 machines; the cvb fleet's
    150 replicates of 8 types on 6 machines; mixed_sites' masked fold, 150
    x 2 rows of all 7 machines; the router's one event over 8 tasks on its
    4 machines."""
    if path == "flat":
        return kernel_inputs(**MAIN_SHAPE, seed=5, device=device)
    if path == "router":
        return router_inputs(ROUTER_TIMED_N, seed=5, device=device)
    if path == "cvb":
        return kernel_inputs(**FLEET_SHAPES["cvb"], seed=5, device=device)
    if path == "mixed_sites":
        return per_row_inputs(MIXED_ROWS["B"], MIXED_ROWS["N"],
                              MIXED_ROWS["S"], MIXED_ROWS["sites"], seed=5,
                              device=device, block=False)
    if path == "paper_x8":
        sites = tuple(f for f in range(BLOCK_ROWS["F"])
                      for _ in range(BLOCK_ROWS["m"]))
        return per_row_inputs(BLOCK_ROWS["B"], BLOCK_ROWS["N"],
                              BLOCK_ROWS["S"], sites, seed=5, device=device,
                              block=True)
    return per_row_inputs(len(TIER_RATES) * TIER_REPS, TIER_TIMED_TASKS,
                          MASKED_ROWS["S"], MASKED_ROWS["sites"], seed=5,
                          device=device, block=False)


def rule_bound(c: dict) -> dict:
    """The bound of a kernel's cost rule (``kernels/*/ops.py``, the
    roofline walker's count): the larger of its bytes over the HBM rate
    and its operations over the rule's peak (``roofline/hw.py``)."""
    from repro_torch.roofline import hw

    t_bytes = c["bytes"] / hw.HBM_BW * 1e3
    t_ops = c["flops"] / c["rate"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": c["bytes"], "operations": c["flops"]}


def timed_row(name, kern, plain, rule, iters=100, plain_iters=20) -> dict:
    """Device times of a kernel and its plain version, eager times, and the
    bound of its cost rule."""
    return {"ms": device_ms(kern, iters), "plain_ms": device_ms(plain,
                                                                plain_iters),
            "eager_ms": time_ms(kern, 2 * iters),
            "eager_plain_ms": time_ms(plain, plain_iters),
            **rule_bound(rule)}


def time_map_kernels(device, paths) -> dict:
    """map_decide and evict_stats at each path's shape, phase1_map at the
    shapes of the paths that run it: {kernel: {path: times}}."""
    from repro_torch.kernels import map_fused, phase1_map

    kinds = dict(nominator="min_energy_feasible", phase2_key="value",
                 drop_rule="stale_hopeless")          # FELARE's kinds
    by_shape = {"map_decide": {}, "evict_stats": {}, "phase1_map": {}}
    for path in paths:
        x = map_path_inputs(path, device)
        B, N = x["deadline"].shape
        M = x["eet"].shape[-1]
        md_args = map_decide_args(x) + (x["suffered"],)
        es_args = evict_stats_args(x)
        table = {
            # name: (kernel call, plain call, cost rule)
            "map_decide": (
                lambda: map_fused.map_decide(*md_args, **kinds),
                lambda: map_fused.map_decide_plain(*md_args, **kinds),
                map_fused.map_decide_cost(*md_args)),
            "evict_stats": (
                lambda: map_fused.evict_stats(*es_args),
                lambda: map_fused.evict_stats_plain(*es_args),
                map_fused.evict_stats_cost(*es_args)),
        }
        if path in ("flat", "cvb", "mixed_sites", "router"):
            p1_args = phase1_args(x)
            table["phase1_map"] = (
                lambda: phase1_map.phase1_map(*p1_args),
                lambda: phase1_map.phase1_map_plain(*p1_args),
                phase1_map.phase1_map_cost(*p1_args))
        for name, (kern, plain, rule) in table.items():
            r = timed_row(name, kern, plain, rule)
            by_shape[name][path] = {"rows": B, "N": N, "M": M, **r}
            emit("times", kernel=name, path=path, rows=B, N=N, M=M, **r)
    return by_shape


def time_kernels(device, errs: dict) -> list:
    """The scheduling kernels at the shapes the paths give them: map_decide
    and evict_stats at the flat, paper_x8, tiered_x4, cvb (8 x 6) and
    mixed_sites (4 x 7, masked fold) shapes, phase1_map at the flat, cvb
    and mixed_sites ones (the paths that run it), balance_scan at
    paper_x8's and tiered_x4's. Each row's top-level numbers are those of
    its first shape; ``by_shape`` holds every shape's (the router's are
    added by :func:`time_serving_front`)."""
    import torch

    by_shape = time_map_kernels(device, ("flat", "paper_x8", "tiered_x4",
                                         "cvb", "mixed_sites"))
    by_shape["balance_scan"] = time_balance_scan(device)
    rows = []
    for name, shapes in by_shape.items():
        first = next(iter(shapes.values()))
        rows.append({
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1],
            "max_abs_err": errs[name],
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")},
            "library_ms": None,
            "by_shape": {path: {k: v[k] for k in ("rows", "N", "ms",
                                                  "plain_ms", "bound_ms",
                                                  "bound_by")}
                         for path, v in shapes.items()},
        })
    torch.cuda.synchronize()
    return rows


def time_balance_scan(device) -> dict:
    """``balance_scan`` at the federated paths' shapes (paper_x8: 150
    replicates of ``FED_TASKS`` tasks over 8 sites; tiered_x4: 20
    replicates of 2000 tasks over 4 sites) on the data those paths give
    it: one admission per replicate per event. Times by CUDA events after
    warm-up (``ms``,
    ``plain_ms``), device time by ``torch.profiler``, and the same with
    every task new (the serial walk's longest case)."""
    import numpy as np
    import torch

    from repro_torch.kernels import map_fused

    out = {}
    for path, shape in (("paper_x8", BALANCE_SHAPES[0]),
                        ("tiered_x4", dict(B=len(TIER_RATES) * TIER_REPS,
                                           N=TIER_TIMED_TASKS, F=4))):
        B, N, F = shape["B"], shape["N"], shape["F"]
        load0, _, target, home = balance_inputs(**shape, density=0.0,
                                                loads="mixed", seed=3,
                                                device=device)
        load0 = load0 % 1_000_000                      # no dead site
        one = np.zeros((B, N), bool)
        one[np.arange(B), np.random.default_rng(4).integers(0, N, B)] = True
        fresh = torch.as_tensor(one, device=device)
        args = (load0, fresh, target, home)
        every = (load0, torch.ones_like(fresh), target, home)

        def kern(x=args):
            return map_fused.balance_scan(*x)

        def plain(x=args):
            return map_fused.balance_scan_plain(*x, max_new=1)

        r = {"rows": B, "N": N, "F": F,
             "ms": time_ms(kern, 200), "plain_ms": time_ms(plain, 50),
             **rule_bound(map_fused.balance_scan_cost(*args)),
             "new_tasks": int(fresh.sum()),
             "device_ms": device_ms(kern, 100),
             "plain_device_ms": device_ms(plain, 20),
             "ms_all_new": time_ms(lambda: kern(every), 20),
             "device_ms_all_new": device_ms(lambda: kern(every), 20)}
        out[path] = r
        emit("times", kernel="balance_scan", path=path, **r)
    return out


def time_model_kernels(device, errs: dict) -> list:
    """The three model kernels at the serve path's shapes (bf16, B = 8,
    32 heads of 80, 80 SSM heads of 64, N = 64, chunk 128): device time
    per call of the kernel, its plain version and, for the attention
    kernels, one ``scaled_dot_product_attention`` call on the same inputs
    laid out as it wants them; eager times by CUDA events; the bound of
    each kernel's cost rule on these inputs (the decode kernel's counts
    only the rows up to kv_len)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import ssm_scan
    from repro_torch.roofline import hw

    gen = torch.Generator(device=device).manual_seed(21)
    bf16 = torch.bfloat16
    B, S, H, hd = SERVE_BATCH, SERVE_PROMPT, 32, 80
    q, k, v = (card_normal(gen, (B, S, H, hd), bf16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    Sk, kv = SERVE_MAX_SEQ, SERVE_PROMPT + SERVE_NEW // 2
    q1 = card_normal(gen, (B, 1, H, hd), bf16)
    ck, cv = (card_normal(gen, (B, Sk, H, hd), bf16) for _ in range(2))
    kv_len = torch.full((B,), kv, dtype=torch.int32, device=device)
    q1t, ckt, cvt = (t.transpose(1, 2).contiguous() for t in (q1, ck, cv))
    mask = (torch.arange(Sk, device=device) < kv_len[:, None])[:, None, None]
    # the serve path's scan: bf16 x, B and C (the conv output), float32 dt
    ssd = ssd_inputs(gen, B, S, 80, 64, 64, bf16)
    ssd_f32_bc = ssd
    ssd = ssd[:3] + (ssd[3].bfloat16(), ssd[4].bfloat16())
    Q = 128
    table = {
        # name: (kernel, plain, library, cost rule, the rates it assumes)
        "flash_attention": (
            lambda: flash_attention.flash_attention(q, k, v, causal=True),
            lambda: flash_attention.flash_attention_plain(q, k, v,
                                                          causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
            flash_attention.flash_attention_cost(q, k, v, causal=True),
            "bf16 tensor cores, 989 TFLOP/s"),
        "decode_attention": (
            lambda: decode_attention.decode_attention(q1, ck, cv, kv_len),
            lambda: decode_attention.decode_attention_plain(q1, ck, cv,
                                                            kv_len),
            lambda: F.scaled_dot_product_attention(q1t, ckt, cvt,
                                                   attn_mask=mask,
                                                   enable_gqa=True),
            decode_attention.decode_attention_cost(q1, ck, cv, kv_len),
            "bf16 tensor cores, 989 TFLOP/s"),
        "ssd_scan": (
            lambda: ssm_scan.ssm_scan(*ssd, chunk=Q),
            lambda: ssm_scan.ssd_scan_plain(*ssd, chunk=Q),
            None,
            ssm_scan.ssm_scan_cost(*ssd, chunk=Q),
            ssm_scan.ssd_products(B, 80, S, 64, 64, Q, x_dtype=bf16,
                                  b_dtype=bf16, c_dtype=bf16)[2]),
    }
    rows = []
    for name, (kern, plain, lib, rule, rate_name) in table.items():
        bound = rule_bound(rule)
        moved, ops = bound["bytes"], bound["operations"]
        rows.append({
            "name": name, "route": "cuda",
            "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1],
            "max_abs_err": errs[name],
            "ms": device_ms(kern, 20), "plain_ms": device_ms(plain, 5),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None if lib is None else device_ms(lib, 20),
        })
        row = rows[-1]
        if name == "ssd_scan":
            # both routes count as this kernel's launches; the serve shape
            # takes the tensor cores
            row["counters"] = ["ssd_scan_tc", "ssd_scan"]
            row["bound_ms_cuda_cores"] = rule_bound(
                dict(rule, rate=hw.PEAK_FLOPS_F32))["bound_ms"]
        emit("times", kernel=name, bytes=moved, operations=ops,
             rate=rate_name, eager_ms=time_ms(kern, 20),
             eager_plain_ms=time_ms(plain, 5),
             eager_library_ms=None if lib is None else time_ms(lib, 20),
             share_of_bound=row["bound_ms"] / row["ms"],
             vs_library=None if lib is None else row["ms"] / row["library_ms"],
             achieved={"TFLOP/s": ops / row["ms"] * 1e-9,
                       "TB/s": moved / row["ms"] * 1e-9},
             **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")})
    # The scan with B and C given in float32 (C.B^T and C.S in three TF32
    # passes), at the same shape, against its own bound.
    bound = rule_bound(ssm_scan.ssm_scan_cost(*ssd_f32_bc, chunk=Q))
    ms = device_ms(lambda: ssm_scan.ssm_scan(*ssd_f32_bc, chunk=Q), 20)
    emit("times", kernel="ssd_scan", bc_dtype="float32", ms=ms,
         plain_ms=device_ms(lambda: ssm_scan.ssd_scan_plain(*ssd_f32_bc,
                                                           chunk=Q), 5),
         rate=ssm_scan.ssd_products(B, 80, S, 64, 64, Q, bf16,
                                    torch.float32, torch.float32)[2],
         share_of_bound=bound["bound_ms"] / ms, **bound)
    # The float32 instantiation of flash attention (the CUDA cores) at the
    # same shape, against the float32 CUDA cores' rate.
    qf, kf, vf = q.float(), k.float(), v.float()
    f32_ms = device_ms(lambda: flash_attention.flash_attention(
        qf, kf, vf, causal=True), 5)
    emit("times", kernel="flash_attention", dtype="float32", ms=f32_ms,
         eager_ms=time_ms(lambda: flash_attention.flash_attention(
             qf, kf, vf, causal=True), 5),
         bound_ms=rule_bound(flash_attention.flash_attention_cost(
             qf, kf, vf, causal=True))["bound_ms"],
         rate="float32 CUDA cores, 67 TFLOP/s",
         library_ms=device_ms(lambda: F.scaled_dot_product_attention(
             qt.float(), kt.float(), vt.float(), is_causal=True), 5))
    # Decode under GQA: one block serves the g query heads of a kv head,
    # so the bytes are those of the Hkv kv heads whatever g is.
    D = DECODE_GQA
    B, Hkv, kv = D["B"], D["Hkv"], D["kv"]
    ck, cv = (card_normal(gen, (B, D["Sk"], Hkv, D["hd"]), bf16)
              for _ in range(2))
    kv_len = torch.full((B,), kv, dtype=torch.int32, device=device)
    mask = (torch.arange(D["Sk"], device=device)
            < kv_len[:, None])[:, None, None]
    ckt, cvt = (t.transpose(1, 2).contiguous() for t in (ck, cv))
    for g in D["g"]:
        q1 = card_normal(gen, (B, 1, g * Hkv, D["hd"]), bf16)
        q1t = q1.transpose(1, 2).contiguous()
        ms = device_ms(lambda: decode_attention.decode_attention(
            q1, ck, cv, kv_len), 20)
        emit("times", kernel="decode_attention", gqa=g, shape=dict(
            B=B, Sk=D["Sk"], kv_len=kv, H=g * Hkv, Hkv=Hkv, hd=D["hd"]),
            ms=ms, bound_ms=rule_bound(decode_attention.decode_attention_cost(
                q1, ck, cv, kv_len))["bound_ms"],
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q1t, ckt, cvt, attn_mask=mask, enable_gqa=True), 20))
    torch.cuda.synchronize()
    return rows


def attention_shapes(which: str) -> dict:
    """The attention shapes of the dense configs' serve paths
    (``which="front"``), of the other families' (``"families"``) or of
    phase 8g's qwen1.5-0.5b serve (``"qwen"``: 8 x 1024 prompts, 3
    tokens), B = 8, bf16: {label: (H, Hkv, hd, flash (Sq, Sk, causal) or
    None, decode (Sk, kv_len) or None)}. Decode is timed against the
    cache as it is half-way through the generated tokens."""
    from repro_torch.configs import get_config

    mid = SERVE_NEW // 2
    shapes = {}
    if which == "qwen":
        cfg = get_config(TRAIN_ARCH)
        shapes[TRAIN_ARCH] = (
            cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            (SERVE_PROMPT, SERVE_PROMPT, True),
            (SERVE_PROMPT + SHARDED_NEW, SERVE_PROMPT + SHARDED_NEW // 2))
    for arch, _ in DENSE_SERVE if which == "front" else ():
        cfg = get_config(arch)
        shapes[arch] = (cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        (SERVE_PROMPT, SERVE_PROMPT, True),
                        (SERVE_MAX_SEQ, SERVE_PROMPT + mid))
    for arch, _, prompt in FAMILY_SERVE if which == "families" else ():
        cfg = get_config(arch)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        if cfg.family == "audio":
            shapes[f"{arch} encoder"] = heads + (
                (AUDIO_FRAMES, AUDIO_FRAMES, False), None)
            shapes[f"{arch} decoder"] = heads + (
                (prompt, prompt, True), (AUDIO_FRAMES, prompt + mid))
            shapes[f"{arch} cross"] = heads + (
                (prompt, AUDIO_FRAMES, False), (AUDIO_FRAMES, AUDIO_FRAMES))
        elif cfg.family != "ssm":
            ctx = prompt + (cfg.n_patches if cfg.family == "vlm" else 0)
            shapes[arch] = heads + ((ctx, ctx, True),
                                    (ctx + SERVE_NEW, ctx + mid))
    return shapes


def time_attention_shapes(device, which: str) -> dict:
    """Flash and decode attention at :func:`attention_shapes`: device and
    eager times of the kernel, its plain version and one
    ``scaled_dot_product_attention`` call, and the bound from the bytes
    and operations of these inputs: {kernel: {label: times}}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, flash_attention

    gen = torch.Generator(device=device).manual_seed(22)
    bf16, B = torch.bfloat16, SERVE_BATCH
    by_shape = {"flash_attention": {}, "decode_attention": {}}
    for label, (H, Hkv, hd, flash, dec) in attention_shapes(which).items():
        table = {}
        if flash is not None:
            Sq, Sk, causal = flash
            q = card_normal(gen, (B, Sq, H, hd), bf16)
            k, v = (card_normal(gen, (B, Sk, Hkv, hd), bf16)
                    for _ in range(2))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            table["flash_attention"] = (
                partial(flash_attention.flash_attention, q, k, v,
                        causal=causal),
                partial(flash_attention.flash_attention_plain, q, k, v,
                        causal=causal),
                partial(F.scaled_dot_product_attention, qt, kt, vt,
                        is_causal=causal, enable_gqa=True),
                flash_attention.flash_attention_cost(q, k, v, causal=causal),
                dict(B=B, Sq=Sq, Sk=Sk, causal=causal))
        if dec is not None:
            Sk, kv = dec
            q1 = card_normal(gen, (B, 1, H, hd), bf16)
            ck, cv = (card_normal(gen, (B, Sk, Hkv, hd), bf16)
                      for _ in range(2))
            kv_len = torch.full((B,), kv, dtype=torch.int32, device=device)
            q1t, ckt, cvt = (t.transpose(1, 2).contiguous()
                             for t in (q1, ck, cv))
            mask = (torch.arange(Sk, device=device)
                    < kv_len[:, None])[:, None, None]
            table["decode_attention"] = (
                partial(decode_attention.decode_attention, q1, ck, cv,
                        kv_len),
                partial(decode_attention.decode_attention_plain, q1, ck, cv,
                        kv_len),
                partial(F.scaled_dot_product_attention, q1t, ckt, cvt,
                        attn_mask=mask, enable_gqa=True),
                decode_attention.decode_attention_cost(q1, ck, cv, kv_len),
                dict(B=B, Sk=Sk, kv_len=kv))
        for name, (kern, plain, lib, rule, shape) in table.items():
            bound = rule_bound(rule)
            r = {"H": H, "Hkv": Hkv, "hd": hd, "g": H // Hkv, **shape,
                 "ms": device_ms(kern, 20), "plain_ms": device_ms(plain, 5),
                 "eager_ms": time_ms(kern, 20),
                 "library_ms": device_ms(lib, 20),
                 "bound_ms": bound["bound_ms"],
                 "bound_by": bound["bound_by"]}
            by_shape[name][label] = r
            emit("times", kernel=name, shape_of=label,
                 bytes=bound["bytes"], operations=bound["operations"],
                 share_of_bound=r["bound_ms"] / r["ms"],
                 vs_library=r["ms"] / r["library_ms"], **r)
        del table
        torch.cuda.empty_cache()
    return by_shape


def time_serving_front(args) -> int:
    """``--serving-front-times front``: the kernels at the shapes the
    serving front gives them, the map kernels at the router's and the
    attention kernels at the dense configs' serve shapes; ``families``:
    the attention kernels at the other families' serve shapes. Each in a
    process of its own (see :func:`add_serving_front_times`); its last
    line is ``{"serving_front_times": {kernel: {shape: times}}}``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(torch.cuda.is_available(), "no CUDA device in the timing "
                                       "process")
    device = torch.device("cuda")
    which = args.serving_front_times
    out = time_attention_shapes(device, which)
    if which == "front":
        out.update(time_map_kernels(device, ("router",)))
    print(json.dumps({"serving_front_times": out}), flush=True)
    return 0


def add_serving_front_times(rows) -> None:
    """Time the serving front's and the other families' shapes, each set
    in a fresh process, and add them to the rows' ``by_shape`` (the
    attention rows first get zamba2-2.7b's, their top-level numbers).
    Fresh processes, because torch.profiler loses device records once a
    process has opened many profiling windows: with these windows in the
    main process, the profile phase after them read fewer kernels per
    iteration on paper_x2 than on paper_x8 (403.4 against 411.6), with
    the profile moved before them the first timing window read no
    record, and after the families' serve profiles a first window read
    none either."""
    from repro_torch.configs import get_config

    extra = {}
    for which in ("front", "families"):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--serving-front-times", which],
            stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, CHIP_SMOKE_T0=repr(_T0)))
        got = None
        for line in proc.stdout.splitlines():
            if line.startswith('{"serving_front_times"'):
                got = json.loads(line)["serving_front_times"]
            else:
                print(line, flush=True)
        require(proc.returncode == 0 and got is not None,
                f"the {which} timing process failed (exit code "
                f"{proc.returncode})")
        for name, shapes in got.items():
            extra.setdefault(name, {}).update(shapes)
    by_name = {r["name"]: r for r in rows}
    zamba = get_config(SERVE_ARCH)
    for name in ("flash_attention", "decode_attention"):
        row = by_name[name]
        row["by_shape"] = {SERVE_ARCH: {
            "H": zamba.n_heads, "Hkv": zamba.n_kv_heads, "hd": zamba.hd,
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}}
    for name, shapes in extra.items():
        for shape, r in shapes.items():
            by_name[name]["by_shape"][shape] = r


# --------------------------------------------------------------------------
# Phase 8h: the roofline (its own process, alone, after 8g)
# --------------------------------------------------------------------------
# Measured steps or calls per median in (b); warm-up calls before them.
ROOFLINE_REPS, ROOFLINE_WARMUP = 5, 2
# (c): one cell of the production-mesh dry run, over a fake process group
DRYRUN_CELL = ("qwen1.5-0.5b", "train_4k", "pod")
# (d): the two examples at their default sizes
EXAMPLES = ("torch_quickstart", "torch_fault_tolerance")


def hand_count(name: str, args, out=None, **kw) -> tuple:
    """(bytes, operations, rate) as the timing phases counted them by
    hand before the cost rules, kept here only to set each rule beside
    it: every input and the outputs' bytes as launched, and the
    operations as the smoke wrote them per kernel."""
    import torch

    from repro_torch.roofline import hw

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    f32, bf16 = hw.PEAK_FLOPS_F32, hw.PEAK_FLOPS_BF16
    if name == "map_decide":
        (B, N), M = args[5].shape, args[4].shape[-1]
        return nb(*args, *out), B * N * (4 * M + 2), f32
    if name == "evict_stats":
        (B, N), (S, M) = args[3].shape, args[2].shape[-2:]
        return nb(*args, *out), B * (3 * S * M + 3 * N), f32
    if name == "phase1_map":
        B, N, M = args[1].shape
        return nb(*args, *out), B * N * 3 * M, f32
    if name == "balance_scan":
        (B, F), fresh = args[0].shape, args[1]
        return nb(*args, out), B * fresh.shape[1] + int(fresh.sum()) * F, f32
    if name == "flash_attention":
        q, k, v = args
        B, Sq, H, hd = q.shape
        pairs = Sq * (Sq + 1) // 2 if kw["causal"] else Sq * k.shape[1]
        return nb(q, k, v, q), 4 * B * H * hd * pairs, bf16
    if name == "decode_attention":
        q, k, v, kv_len = args
        B, _, H, hd = q.shape
        kv = int(kv_len[0])
        return (nb(q, q, kv_len) + 2 * B * k.shape[2] * kv * hd * 2,
                4 * B * H * kv * hd, bf16)
    # the SSD scan: ssd_products as the smoke had it (x in bf16)
    x, dt, A, Bm, Cm = args
    B, L, H, P = x.shape
    N, Q = Bm.shape[-1], min(kw["chunk"], L)
    n, tri = B * H * (L // Q), Q * (Q + 1) // 2
    cb, wx = 2 * n * tri * N, 2 * n * tri * P
    cs = st = 2 * n * Q * N * P
    tf32 = hw.PEAK_FLOPS_TF32
    secs = (cb / bf16 + 2 * (wx + cs + st) / tf32
            if Bm.dtype == torch.bfloat16
            else (3 * (cb + cs) + 2 * (wx + st)) / tf32)
    ops = cb + wx + cs + st
    return nb(x, dt, A, Bm, Cm, x) + B * H * N * P * 4, ops, ops / secs


def roofline_bounds(device) -> list:
    """(a) Every row of PERF.md's kernel table: the bound of the kernel's
    cost rule beside the hand count it replaces, with the ratio. The map
    kernels at the paths' shapes on the card (the hand count reads the
    outputs as launched); the attention rows and the SSD scan on ``meta``
    tensors of the serve shapes, kv_len on the host."""
    import torch

    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import map_fused, phase1_map, ssm_scan
    from repro_torch.roofline import hw

    kinds = dict(nominator="min_energy_feasible", phase2_key="value",
                 drop_rule="stale_hopeless")
    table = []          # (kernel, shape, rule, hand (bytes, ops, rate))
    for path in ("flat", "paper_x8", "tiered_x4", "cvb", "mixed_sites",
                 "router"):
        x = map_path_inputs(path, device)
        md = map_decide_args(x) + (x["suffered"],)
        table.append(("map_decide", path, map_fused.map_decide_cost(*md),
                      hand_count("map_decide", md,
                                 map_fused.map_decide(*md, **kinds))))
        es = evict_stats_args(x)
        table.append(("evict_stats", path, map_fused.evict_stats_cost(*es),
                      hand_count("evict_stats", es,
                                 map_fused.evict_stats(*es))))
        if path in ("flat", "cvb", "mixed_sites", "router"):
            p1 = phase1_args(x)
            table.append(("phase1_map", path,
                          phase1_map.phase1_map_cost(*p1),
                          hand_count("phase1_map", p1,
                                     phase1_map.phase1_map(*p1))))
    for path, shape in (("paper_x8", BALANCE_SHAPES[0]),
                        ("tiered_x4", dict(B=len(TIER_RATES) * TIER_REPS,
                                           N=TIER_TIMED_TASKS, F=4))):
        load0, _, target, home = balance_inputs(**shape, density=0.0,
                                                loads="mixed", seed=3,
                                                device=device)
        fresh = torch.zeros_like(target)
        fresh[:, 0] = True                      # one admission per row
        args = (load0 % 1_000_000, fresh, target, home)
        table.append(("balance_scan", path,
                      map_fused.balance_scan_cost(*args),
                      hand_count("balance_scan", args,
                                 map_fused.balance_scan(*args))))

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    zamba = {SERVE_ARCH: (32, 32, 80, (SERVE_PROMPT, SERVE_PROMPT, True),
                          (SERVE_MAX_SEQ, SERVE_PROMPT + SERVE_NEW // 2))}
    shapes = {**zamba, **attention_shapes("front"),
              **attention_shapes("families"), **attention_shapes("qwen")}
    B = SERVE_BATCH
    for label, (H, Hkv, hd, flash, dec) in shapes.items():
        if flash is not None:
            Sq, Sk, causal = flash
            qkv = (meta(B, Sq, H, hd), meta(B, Sk, Hkv, hd),
                   meta(B, Sk, Hkv, hd))
            table.append(("flash_attention", label,
                          flash_attention.flash_attention_cost(
                              *qkv, causal=causal),
                          hand_count("flash_attention", qkv,
                                     causal=causal)))
        if dec is not None:
            Sk, kv = dec
            args = (meta(B, 1, H, hd), meta(B, Sk, Hkv, hd),
                    meta(B, Sk, Hkv, hd),
                    torch.full((B,), kv, dtype=torch.int32))
            table.append(("decode_attention", label,
                          decode_attention.decode_attention_cost(*args),
                          hand_count("decode_attention", args)))
    L, H, P, N = SERVE_PROMPT, 80, 64, 64
    for bc in (torch.bfloat16, torch.float32):
        args = (meta(B, L, H, P), torch.empty((B, L, H), device="meta"),
                torch.empty((H,), device="meta"),
                torch.empty((B, L, N), dtype=bc, device="meta"),
                torch.empty((B, L, N), dtype=bc, device="meta"))
        table.append(("ssd_scan", f"serve, B and C {str(bc)[6:]}",
                      ssm_scan.ssm_scan_cost(*args, chunk=128),
                      hand_count("ssm_scan", args, chunk=128)))
    rows = []
    for name, shape, rule, (hb, hops, hrate) in table:
        hand = rule_bound({"bytes": hb, "flops": hops, "rate": hrate})
        got = rule_bound(rule)
        rows.append({"kernel": name, "shape": shape,
                     "bound_ms": got["bound_ms"], "bound_by": got["bound_by"],
                     "hand_bound_ms": hand["bound_ms"],
                     "ratio": got["bound_ms"] / hand["bound_ms"],
                     "bytes": got["bytes"], "hand_bytes": hb,
                     "operations": got["operations"], "hand_operations": hops})
    emit("roofline_bounds", rows=rows,
         max_ratio_gap=max(abs(r["ratio"] - 1) for r in rows),
         rates={"bf16": hw.PEAK_FLOPS_BF16, "tf32": hw.PEAK_FLOPS_TF32,
                "f32": hw.PEAK_FLOPS_F32, "hbm": hw.HBM_BW},
         card=nvidia_smi())
    return rows


def _median_ms(fn, reps=ROOFLINE_REPS, warmup=ROOFLINE_WARMUP) -> tuple:
    """(median, every) ms of ``fn()`` calls by the host clock around a
    synchronize, after ``warmup`` calls."""
    import statistics

    import torch

    out = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), out


def _share_row(name, c, measured_ms, model_flops, peak, before) -> dict:
    """The walker's counts of one step beside its measured time: the
    roofline terms, share, MFU at the roofline and measured, and the
    walker's peak live bytes beside the allocator's."""
    from repro_torch.roofline import analysis as ra
    from repro_torch.roofline import hw

    roof = ra.from_cost(name, "", "1 card", 1, c, model_flops)
    return {"walker_flops": c["flops"], "walker_bytes": c["bytes"],
            "matmul_flops": c["matmul_flops"],
            "by_kernel": {k: v["calls"] for k, v in c["by_kernel"].items()},
            "t_comp_ms": roof.t_comp * 1e3, "t_mem_ms": roof.t_mem * 1e3,
            "dominant": roof.dominant, "measured_ms": measured_ms,
            "share": ra.share(roof, measured_ms * 1e-3),
            "mfu_roofline": roof.mfu,
            "mfu_measured": model_flops / (measured_ms * 1e-3)
            / hw.PEAK_FLOPS_BF16,
            "model_flops": model_flops,
            "walker_peak_bytes": before + c["peak_bytes"],
            "max_memory_allocated": peak, "resident_before": before}


def step_roofline(device) -> dict:
    """(b) The roofline share of two whole steps on the card: phase 8f's
    training cell (qwen1.5-0.5b, bf16, 8 x 512 tokens in 2 microbatches,
    remat) and phase 7's zamba2-2.7b serve cell (8 x 1024-token prompts,
    then decode). Each is walked once on the card (the kernels count
    their rules), the train step also on ``meta`` (the same counts, or
    the walker lost the backward), then timed: median of 5 steps or calls
    after 2, host clock around a synchronize."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.datapipe.synthetic import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW
    from repro_torch.roofline import cost as rc
    from repro_torch.train import TRAIN_IMPLS, make_serve_steps, \
        make_train_step

    def resident():
        return torch.cuda.memory_allocated(device)

    out = {}
    # the training cell ------------------------------------------------------
    cfg = get_config(TRAIN_ARCH).scaled(**TRAIN_IMPLS)
    opt = AdamW(lr=TRAIN_LR)
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
                       accum=TRAIN_ACCUM)
    params = transformer.init(cfg, torch.Generator(device=device)
                              .manual_seed(0), device=device)
    state = opt.init(params)
    step = make_train_step(cfg, opt, donate=False, device=device)
    batch = data.batch_at(0)
    meta_batch = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype,
                                 device="meta") for k, v in batch.items()}
    shapes = transformer.param_shapes(cfg)
    on_meta = rc.cost(make_train_step(cfg, opt, donate=False,
                                      device="meta"),
                      shapes, opt.init(shapes), meta_batch)
    torch.cuda.synchronize()
    before = resident()
    c = rc.measure(step, params, state, batch)[1]    # its result freed
    # the same ops but the host-to-device copies of a few scalars: a
    # walker that lost the backward's thread would read a third
    keys = ("flops", "bytes", "matmul_flops")
    require(all(abs(c[k] - on_meta[k]) <= 1e-6 * on_meta[k] for k in keys),
            f"roofline: the train step's walk on the card "
            f"{[c[k] for k in keys]} differs from meta "
            f"{[on_meta[k] for k in keys]}")
    require(not c["by_kernel"], "roofline: training reached a kernel")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    i = iter(range(1, 1 + ROOFLINE_WARMUP + ROOFLINE_REPS))
    ms, every = _median_ms(lambda: step(params, state, data.batch_at(
        next(i))))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out["train"] = {"arch": TRAIN_ARCH, "tokens": tokens, "ms_each": every,
                    **_share_row("train", c, ms, 6.0 * cfg.active_params()
                                 * tokens, torch.cuda.max_memory_allocated(
                                     device), before)}
    del params, state, step
    torch.cuda.empty_cache()
    # the zamba2-2.7b serve cell ----------------------------------------------
    cfg = get_config(SERVE_ARCH)
    params = transformer.init(cfg, torch.Generator(device=device)
                              .manual_seed(0), device=device)
    pre, dec = make_serve_steps(cfg, device=device)
    prompt = serve_prompt()
    logits, cache = pre(params, prompt, max_seq=SERVE_MAX_SEQ)   # warm-up
    dec(params, cache, logits.argmax(-1))
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = resident()
    (logits, cache), cp = rc.measure(pre, params, prompt,
                                     max_seq=SERVE_MAX_SEQ)
    tok = logits.argmax(-1)
    before_dec = resident()
    cd = rc.measure(dec, params, cache, tok)[1]
    del logits, cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    ms, every = _median_ms(lambda: pre(params, prompt,
                                       max_seq=SERVE_MAX_SEQ))
    n_act = cfg.active_params()
    out["prefill"] = {"arch": SERVE_ARCH, "ms_each": every,
                      **_share_row("prefill", cp, ms, 2.0 * n_act
                                   * SERVE_BATCH * SERVE_PROMPT,
                                   torch.cuda.max_memory_allocated(device),
                                   before)}
    logits, cache = pre(params, prompt, max_seq=SERVE_MAX_SEQ)
    tok = logits.argmax(-1)
    torch.cuda.reset_peak_memory_stats(device)
    ms, every = _median_ms(lambda: dec(params, cache, tok))
    out["decode"] = {"arch": SERVE_ARCH, "ms_each": every,
                     "cache_len_walked": SERVE_PROMPT,
                     **_share_row("decode", cd, ms, 2.0 * n_act
                                  * SERVE_BATCH,
                                  torch.cuda.max_memory_allocated(device),
                                  before_dec)}
    require(cp["by_kernel"].get("flash_attention", {}).get("calls") and
            cp["by_kernel"].get("ssm_scan", {}).get("calls") and
            cd["by_kernel"].get("decode_attention", {}).get("calls"),
            f"roofline: the serve walk missed a kernel: "
            f"{cp['by_kernel']}, {cd['by_kernel']}")
    del params, cache
    torch.cuda.empty_cache()
    emit("step_roofline", card=nvidia_smi(), **out)
    return out


def cpu_process(args) -> subprocess.Popen:
    """A process of the CPU's own work for phase 8h (one thread)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=str(ROOT))


def finish(proc, what: str, timeout: float = 600) -> str:
    out, err = proc.communicate(timeout=timeout)
    require(proc.returncode == 0, f"{what} failed (exit code "
                                  f"{proc.returncode}): {out[-2000:]} "
                                  f"{(err or '')[-2000:]}")
    return out


def run_roofline(device) -> dict:
    """Phase 8h: (a) the kernel table's bounds from the rules, and flash
    and decode attention timed at phase 8g's qwen1.5-0.5b serve shape;
    (b) the step roofline shares; (c) one dry-run cell on the pod mesh
    over a fake group, in a CPU process of its own started first. Returns
    the qwen1.5-0.5b attention times."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_roofline_"))
    arch, shape, mesh = DRYRUN_CELL
    dry = cpu_process(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--mesh", mesh, "--out",
                       str(tmp / "dryrun")])
    try:
        qwen = time_attention_shapes(device, "qwen")
        bounds = roofline_bounds(device)
        step_roofline(device)
        t_card = time.perf_counter() - t0
        finish(dry, "roofline: the dry-run cell")
        rec = json.loads((tmp / "dryrun" / "cells.jsonl").read_text()
                         .splitlines()[-1])
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    require(rec["status"] == "ok", f"roofline: dry-run cell {rec}")
    world1 = rec["flops_global_over_chips"]["matmul_flops"] * rec["chips"]
    require(abs(rec["cost"]["matmul_flops"] * 16 - world1) <= 1e-9 * world1,
            f"roofline: rank 0's matmul FLOPs x 16 "
            f"{rec['cost']['matmul_flops'] * 16} against the world-size-1 "
            f"count {world1}")
    emit("roofline", dryrun_cell=rec, bound_rows=len(bounds),
         card_seconds=t_card, seconds=time.perf_counter() - t0,
         card=nvidia_smi())
    return qwen


# --------------------------------------------------------------------------
# Phase 8i: the discipline checker's walker audit (beside the sweeps)
# --------------------------------------------------------------------------
# The flat path walked at B = 1 (24 tasks) and at B = 150 (the main path's
# batch: 5 rates x 30 replicates of 2000 tasks) for 64 iterations.
AUDIT_FLAT = dict(fleet="paper", heuristic="FELARE", fused=True)
AUDIT_FLAT_BATCH = dict(rates=RATES, reps=30, n_tasks=2000, max_steps=64)


def run_audit() -> None:
    """Phase 8i: Layer 2 of ``repro_torch.analysis`` on the card (the
    three checks over the five programs and the fleet pairs), against the
    same walks on the CPU (in a process of its own, started first), and
    the flat path at B = 1 against B = 150."""
    from repro_torch.analysis import format_findings, load_config
    from repro_torch.analysis import walk_audit

    t0 = time.perf_counter()
    cpu = cpu_process(["-c", "import json\n"
                       "from repro_torch.analysis import walk_audit\n"
                       "print(json.dumps(walk_audit.summary('cpu')))"])
    try:
        cfg = load_config(str(ROOT), device="cuda")
        findings = [f for check in (
            walk_audit.FlatnessCheck(), walk_audit.DtypeCheck(),
            walk_audit.HostSyncAuditCheck()) for f in check.run(cfg)]
        card = walk_audit.summary("cuda")
        flat_params = {"B=1": AUDIT_FLAT,
                       "B=150": {**AUDIT_FLAT, **AUDIT_FLAT_BATCH}}
        flat = [(name, walk_audit.walk_program(params, "cuda"))
                for name, params in flat_params.items()]
        flat_d = {name: walk_audit.describe(w, walk_audit.sync_sites(
            flat_params[name], "cuda")) for name, w in flat}
        t_card = time.perf_counter() - t0
        cpu_out = json.loads(finish(cpu, "audit: the CPU walks")
                             .splitlines()[-1])
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    require(not findings, "audit: findings on the card:\n"
            + format_findings(findings))
    for name, got in card.items():
        want = cpu_out[name]
        # the set-up's ops depend on what the process cached before
        got["full"], want["full"] = got["ops"][1:-1], want["ops"][1:-1]
        for key in ("iterations", "full", "kernels_per_iteration",
                    "host_reads"):
            require(got[key] == want[key],
                    f"audit: {name}: {key} on the card {got[key]} against "
                    f"the CPU's {want[key]}")
        per_it = got["kernels_per_iteration"]
        require(set(got["launches"]) <= set(per_it) and all(
            n * got["iterations"] == got["launches"].get(k, 0)
            for k, n in per_it.items()),
            f"audit: {name}: kernel scopes {per_it} per iteration x "
            f"{got['iterations']} against the launches {got['launches']}")
    require(flat[1][1].iterations == 64,
            f"audit: the B = 150 walk ran {flat[1][1].iterations} "
            "iterations, not 64")
    differ = walk_audit.compare_full_iterations(
        walk_audit.FlatnessCheck(), flat)
    require(not differ, "audit: the flat path's iterations depend on B:\n"
            + format_findings(differ))

    def brief(d):
        return {"iterations": d["iterations"],
                "ops_per_iteration": sorted(set(d["ops"][1:-1])),
                "ops_setup_and_first": d["ops"][0], "ops_tail": d["ops"][-1],
                **{k: d[k] for k in ("kernels_per_iteration", "launches",
                                     "host_reads", "syncs")}}

    emit("audit", findings=0,
         programs={name: brief(d) for name, d in card.items()},
         flat={name: brief(d) for name, d in flat_d.items()},
         card_seconds=t_card, seconds=time.perf_counter() - t0,
         card=nvidia_smi())


def run_examples(device) -> dict:
    """Phase 8h (d): examples/torch_quickstart.py and
    torch_fault_tolerance.py at their default sizes on the card, each with
    the launch counts zeroed just before, against their CPU runs
    (processes of their own, started first): the printouts equal line for
    line, every scheduling kernel of each path launched. Returns the
    launch counts of both."""
    import contextlib
    import importlib.util
    import io

    t0 = time.perf_counter()
    cpu = {name: cpu_process([str(ROOT / "examples" / f"{name}.py"),
                              "--device", "cpu"]) for name in EXAMPLES}
    lines, counts, secs = {}, {}, {}
    try:
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                f"example_{name}", ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            reset_counts()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(["--device", str(device)])
            secs[name] = time.perf_counter() - t1
            counts[name] = read_counts()
            require(rc == 0, f"examples: {name} on the card exited {rc}")
            lines[name] = buf.getvalue().splitlines()
        t_card = time.perf_counter() - t0
        for name in EXAMPLES:
            want = finish(cpu[name], f"examples: {name} on the CPU")
            require(want.splitlines() == lines[name],
                    f"examples: {name} prints differently on the card: "
                    f"{lines[name]} against the CPU's {want.splitlines()}")
    finally:
        for p in cpu.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    quick, fault = counts["torch_quickstart"], counts["torch_fault_tolerance"]
    require(min(quick["map_decide"], quick["evict_stats"],
                quick["phase1_map"], fault["map_decide"],
                fault["evict_stats"], fault["balance_scan"]) > 0,
            f"examples: a scheduling kernel of a path never launched: "
            f"{counts}")
    emit("examples", equal_to_cpu=True, **{
        name: {"card_seconds": secs[name], "launches": counts[name],
               "lines": lines[name]} for name in EXAMPLES},
         card_seconds=t_card, seconds=time.perf_counter() - t0,
         card=nvidia_smi())
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


# --------------------------------------------------------------------------
# The sweep phases (9-20) in six processes at once (and 8h (d), the
# examples, in a seventh; 8i, the walker audit, in an eighth)
# --------------------------------------------------------------------------
# The sweeps are bound by the host's launches (85-93 % of the card idle),
# so six processes can share the one card. Each group draws its traces
# from the same seed, zeroes the launch counts just before each run and
# reads them just after, and returns them by path. Longest first. Each
# runs its CPU subsets on one thread: six processes share 8 cores, and
# the subsets' threads slowed the others' launches. The families' serving
# (phases 8d and 8e) runs in a process of its own before them, alone on
# the card: beside the six sweeps its prefills and decode steps took 4-10
# x their time alone, the card time-sliced between the processes
# (granite-moe-3b's decode step 843.9 ms against 78.6 ms alone on an
# NVIDIA H100 80GB HBM3 at 700 W).
SWEEP_GROUPS = ("fed", "fleets", "scenarios", "observe", "flat", "network",
                "examples", "audit")
GROUPS = ("families", "sharded", "roofline") + SWEEP_GROUPS


def metrics_digest(result, heuristic: str) -> str:
    """sha256 of every Metrics field of ``heuristic``'s run: two groups'
    runs of the same sweep must give the same bits."""
    import hashlib

    import numpy as np

    h = result.heuristics.index(heuristic)
    digest = hashlib.sha256()
    for leaf in result.metrics:
        digest.update(np.ascontiguousarray(leaf[h]).tobytes())
    return digest.hexdigest()


def group_flat(device, args) -> dict:
    """Phases 9 and 10: the flat sweep and its parity; then phase 8c (the
    elastic launcher), off the main process's serial path."""
    flat, _, res = run_main_path(device, args.reps, args.tasks)
    run_elastic(device)
    return {"paths": {"flat": flat}, "by_shape": {"flat": flat},
            "flat_felare": metrics_digest(res, "FELARE")}


def group_observe(device, args) -> dict:
    """Phases 13 and 15 (the flat sweep observed, against its own
    unobserved FELARE run on the same traces) and 17 (the faulted runs'
    parity)."""
    from repro_torch.experiments import SweepSpec, run_sweep

    traces = stack_traces(device, "paper", RATES, args.reps, args.tasks)
    unobserved = run_sweep(SweepSpec(
        system="paper", rates=RATES, reps=args.reps, n_tasks=args.tasks,
        heuristics=("FELARE",), seed=0, use_fused_map=True), traces=traces,
        device=device)
    observed, parity = run_observed_path(device, traces, unobserved,
                                         args.tasks)
    emit("observe_parity", **parity)
    x8 = stack_traces(device, "paper_x8", FED_RATES, args.fed_reps,
                      FED_TASKS)
    fault_traces, _, rates = fault_inputs(device, traces, x8)
    run_faults_parity(device, fault_traces, rates)
    return {"paths": {"observed": observed},
            "flat_felare": metrics_digest(unobserved, "FELARE")}


def group_fed(device, args) -> dict:
    """Phases 11 and 12 on paper_x8, 14 and 15 (the observed federation)
    and 16 (the faulted sweeps)."""
    fed, x8, fed_subset = run_federated_path(device, args.fed_reps,
                                             "paper_x8")
    obs_fed, parity, obs_fed_res = run_observed_federation(
        device, x8, min(args.fed_reps, OBS_FED_REPS))
    emit("observe_parity", **parity)
    flat = stack_traces(device, "paper", RATES, args.reps, args.tasks)
    faulted = run_faults_path(device, flat, x8, (fed_subset, obs_fed_res))
    return {"paths": {"federated": fed, "observed": obs_fed,
                      "faults": faulted},
            "by_shape": {"paper_x8": fed}}


def group_network(device, args) -> dict:
    """Phases 11 and 12 on tiered_x4, 18 and 19 (the network)."""
    tier, tier_traces, tier_res = run_federated_path(
        device, args.fed_reps, "tiered_x4")
    networked = run_network_path(device)
    run_network_parity(device, tier_traces, tier_res)
    return {"paths": {"federated": tier, "network": networked},
            "by_shape": {"tiered_x4": tier}}


def group_scenarios(device, args) -> dict:
    """Phase 20 on the paper's system and the flat synthetic fleets: the
    workload scenarios, wide-fleet (cvb) and range."""
    total = run_scenario_workloads(device, args.reps, args.tasks)
    fleets, by_shape = run_scenario_fleets(device, args.reps, args.tasks,
                                           ("cvb", "range"))
    for k, v in fleets.items():
        total[k] = total.get(k, 0) + v
    return {"paths": {"scenarios": total}, "by_shape": by_shape}


def group_families(device, args) -> dict:
    """Phases 8d, 8e and 8f: the moe, vlm, audio and ssm families served at
    full width (and the float32 parity of three of them), the
    edge-serving example, then training."""
    families, by_shape = run_family_serve(device)
    edge = run_serve_edge(device)
    train = run_train(device)
    return {"paths": {"serve_families": families, "serve_edge": edge,
                      "train": train},
            "by_shape": by_shape}


def group_sharded(device, args) -> dict:
    """Phase 8g: the sharded substrate at world size 1, in a process of its
    own (the training part's deterministic cuBLAS wants its workspace
    setting before the process's first cuBLAS call)."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    counts = run_sharded(device)
    return {"paths": {"sharded": counts},
            "by_shape": {TRAIN_ARCH: {k: counts[k] for k in (
                "flash_attention", "decode_attention")}}}


def group_roofline(device, args) -> dict:
    """Phase 8h (a)-(c): the roofline, alone on the card after 8g (the
    dry-run cell in a CPU process of its own)."""
    return {"paths": {}, "attention_times": run_roofline(device)}


def group_examples(device, args) -> dict:
    """Phase 8h (d): the two examples on the card beside the sweeps
    (host-bound like them), against their CPU runs."""
    return {"paths": {"examples": run_examples(device)}}


def group_audit(device, args) -> dict:
    """Phase 8i: the walker audit beside the sweeps (its launches are the
    audit's own, held against its walks, and join no path's count)."""
    run_audit()
    return {"paths": {}}


def group_fleets(device, args) -> dict:
    """Phase 20 on the synthetic federations: mixed_sites and
    federated-skew (paper_x2)."""
    total, by_shape = run_scenario_fleets(device, args.reps, args.tasks,
                                          ("mixed_sites", "paper_x2"))
    return {"paths": {"scenarios": total}, "by_shape": by_shape}


def run_group(args) -> int:
    """Run one group in this process (``--group``); its last line is
    ``{"group_result": ...}`` for the parent."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    require(torch.cuda.is_available(), "no CUDA device in a group process")
    out = globals()[f"group_{args.group}"](torch.device("cuda"), args)
    print(json.dumps({"group_result": out}), flush=True)
    return 0


def run_groups(args, groups) -> dict:
    """Start the processes of ``groups`` at once, pass their lines on as
    they come, and return their results by group. A group that fails
    stops the others and fails the run; a group's process dies with this
    one."""
    import ctypes
    import signal

    def die_with_parent():          # Linux: PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)

    env = dict(os.environ, CHIP_SMOKE_T0=repr(_T0))
    lock, results = threading.Lock(), {}
    procs = {g: subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--group", g,
         "--reps", str(args.reps), "--tasks", str(args.tasks),
         "--fed-reps", str(args.fed_reps)],
        stdout=subprocess.PIPE, text=True, env=env,
        preexec_fn=die_with_parent) for g in groups}

    def relay(g, proc):
        for line in proc.stdout:
            if line.startswith('{"group_result"'):
                results[g] = json.loads(line)["group_result"]
                continue
            with lock:
                sys.stdout.write(line)
                sys.stdout.flush()

    relays = [threading.Thread(target=relay, args=item, daemon=True)
              for item in procs.items()]
    for t in relays:
        t.start()
    try:
        while any(p.poll() is None for p in procs.values()):
            failed = {g: p.returncode for g, p in procs.items()
                      if p.returncode not in (None, 0)}
            require(not failed, f"groups failed (exit codes): {failed}")
            time.sleep(0.5)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in relays:
            t.join()
    failed = {g: p.returncode for g, p in procs.items() if p.returncode}
    require(not failed, f"groups failed (exit codes): {failed}")
    require(set(results) == set(groups),
            f"groups without a result: {set(groups) - set(results)}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30,
                    help="replicates per rate on the main path (default 30)")
    ap.add_argument("--tasks", type=int, default=2000,
                    help="tasks per trace on the main path (default 2000)")
    ap.add_argument("--fed-reps", type=int, default=30,
                    help="replicates per rate on the federated path "
                         "(default 30)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, check and time the kernels (phases 1-5), "
                         "then stop without a result line")
    ap.add_argument("--mesh-check", action="store_true",
                    help="under torchrun on N > 1 cards: the sharded "
                         "substrate across them (not part of the run "
                         "without arguments)")
    ap.add_argument("--group", choices=GROUPS,
                    help="run one group of the sweep phases (the script "
                         "starts them all itself)")
    ap.add_argument("--serving-front-times", choices=("front", "families"),
                    help="time the kernels at the serving front's or the "
                         "other families' shapes (the script starts these "
                         "processes itself)")
    args = ap.parse_args(argv)
    if args.mesh_check:
        return mesh_check()
    if args.group:
        return run_group(args)
    if args.serving_front_times:
        return time_serving_front(args)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import build  # fails outside a checkout

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], card=torch.cuda.get_device_name(0),
         nvidia_smi=smi, device_count=torch.cuda.device_count())

    t_build = time.perf_counter()
    logs = build.build(verbose=True)
    regs = {k: sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in v["log"].splitlines() if "registers" in ln})
            for k, v in logs.items()}
    spills = {k: max([int(ln.split("bytes spill stores")[0].split(",")[-1])
                      for ln in v["log"].splitlines()
                      if "bytes spill stores" in ln] or [0])
              for k, v in logs.items()}
    sass = sass_counts(build)
    ptxas_ssd = {f: r for f, r in ptxas_by_function(
        logs["ssm_scan"]["log"]).items() if "ssd_scan_tc_kernel" in f}
    ssd_tc = {f: c for f, c in sass["ssm_scan"]["functions"].items()
              if "ssd_scan_tc_kernel" in f}
    map_atoms = {}
    for f, c in sass["map_fused"]["functions"].items():
        ms = map_decide_slots(f)
        if ms is not None:
            map_atoms.setdefault(f"MS={ms}", []).append(c["ATOMS"])
    wide_loads = {
        name: [c["LDG.E.128"] for f, c in sass[lib]["functions"].items()
               if f"{name}_kernel" in f]
        for name, lib in (("evict_stats", "map_fused"),
                          ("balance_scan", "balance_scan"))}
    emit("build", wall_seconds=time.perf_counter() - t_build,
         seconds={k: v["seconds"] for k, v in logs.items()},
         registers_per_thread={k: [r[0], r[-1]] for k, r in regs.items()},
         max_spill_store_bytes=spills,
         sass={k: v["total"] for k, v in sass.items()},
         ssd_scan_tc={"sass": ssd_tc, "ptxas": ptxas_ssd},
         map_decide_atoms_by_slots={k: [min(v), max(v)]
                                    for k, v in map_atoms.items()},
         ldg128_by_instance=wide_loads)
    require(sass["flash_attention"]["total"]["HGMMA"] > 0,
            "flash_attention: no wgmma (HGMMA) in its SASS")
    require(sass["decode_attention"]["total"]["LDG.E.128"] > 0,
            "decode_attention: no 128-bit global loads in its SASS")
    # four tensor-core instances: x float32 or bf16, B and C exact in TF32
    # or not
    require(len(ssd_tc) == 4 and all(c["HMMA"] > 0 for c in ssd_tc.values()),
            f"ssd_scan: a tensor-core instance without HMMA: {ssd_tc}")
    require(len(ptxas_ssd) == 4
            and all(r["spill"] == 0 for r in ptxas_ssd.values()),
            f"ssd_scan: the tensor-core instances spill: {ptxas_ssd}")
    for name, counts in wide_loads.items():
        require(counts and min(counts) > 0,
                f"{name}: an instance without 128-bit loads: {counts}")
    require(map_atoms.get("MS=4") and map_atoms.get("MS=8")
            and max(map_atoms["MS=4"] + map_atoms["MS=8"]) == 0
            and min(map_atoms["MS=0"]) > 0,
            f"map_decide: shared atomics where M <= 8: {map_atoms}")

    errs = check_kernels(device)
    check_federation_kernels(device, errs)
    check_model_kernels(device, errs)
    # Times and profiles come before the long runs: late in a process
    # that has launched millions of kernels, torch.profiler was seen to
    # drop device records (fewer microseconds than the bound, then none).
    rows = time_kernels(device, errs) + time_model_kernels(device, errs)
    add_serving_front_times(rows)
    if args.kernels_only:
        emit("done", kernels_only=True, seconds=time.perf_counter() - t_start)
        return 0
    profile_main_path(device, args.reps, args.tasks, args.fed_reps)
    serve, params_bf16, prompt = run_serve_path(device)
    run_serve_parity(device, params_bf16, prompt)
    del params_bf16
    torch.cuda.empty_cache()
    dense = run_dense_serve(device)
    router = run_router(device)
    if args.reps != 30 or args.tasks != 2000:
        emit("cut", reps=args.reps, tasks=args.tasks,
             note="flat path run below paper scale (30 reps x 2000 tasks)")
    if args.fed_reps != 30:
        emit("cut", fed_reps=args.fed_reps,
             note="federated path run below paper scale (30 reps)")
    # the cuts that keep the whole script under its time limit: the host
    # sets a sweep's time by its iterations, so tasks are what is cut
    emit("cut", fed_tasks=FED_TASKS,
         note="federated sweeps at 2000 tasks per trace (4000 before the "
              "faulted sweeps joined)")
    emit("cut", fault_reps=FAULT_REPS, fault_tasks=FAULT_TASKS,
         fault_backup_tasks=FAULT_BACKUP_TASKS,
         note="faulted sweeps at 10 replicates x 700 tasks (10 x 2000 "
              "asked), the paper_x2 backup run at 500")
    emit("cut", fault_parity_reps=FAULT_PARITY_REPS,
         fault_parity_tasks=FAULT_PARITY_TASKS,
         note="faulted plain-path parity at 5 replicates x 150 tasks "
              "(5 x 1000 allowed)")
    emit("cut", tier_tasks=TIER_TASKS, obs_fed_tasks=OBS_FED_TASKS,
         cpu_subset_tasks=CPU_SUBSET_TASKS,
         note="the fed phase's tiered_x4 sweep at 10 x 500 tasks (the "
              "network phase runs tiered_x4 at 12 x 2000); the observed "
              "federation, the faulted sweeps and the fed CPU subset at "
              "700 tasks per trace (1000 before the network phases)")
    emit("cut", scenario_parity_reps=SCENARIO_PARITY_REPS,
         scenario_parity_tasks=SCENARIO_PARITY_TASKS,
         note="the scenarios phase's plain-path parity at 5 replicates x "
              "300 tasks; its sweeps run at full width")
    paths = {"flat": {}, "federated": {}, "serve": serve, "observed": {},
             "faults": {}, "network": {}, "scenarios": {},
             "serve_dense": {}, "router": router, "serve_families": {},
             "serve_edge": {}, "train": {}, "sharded": {},
             "examples": {}}
    for counts in dense.values():
        for k, v in counts.items():
            paths["serve_dense"][k] = paths["serve_dense"].get(k, 0) + v
    shape_counts = {SERVE_ARCH: serve, "router": router, **dense}
    results = run_groups(args, ("families",))
    results.update(run_groups(args, ("sharded",)))
    results.update(run_groups(args, ("roofline",)))
    results.update(run_groups(args, SWEEP_GROUPS))
    # the flat FELARE sweep of phase 9 and the unobserved one of phase 13
    # (whose Metrics phases 13 and 15 hold against the observed and plain
    # runs) ran in two processes: the same bits
    require(results["flat"]["flat_felare"]
            == results["observe"]["flat_felare"],
            "flat FELARE: the main and observe phases' Metrics differ")
    for result in results.values():
        for path, counts in result["paths"].items():
            for k, v in counts.items():
                paths[path][k] = paths[path].get(k, 0) + v
        shape_counts.update(result.get("by_shape", {}))
    by_name = {r["name"]: r for r in rows}
    for name, shapes in results["roofline"]["attention_times"].items():
        by_name[name]["by_shape"].update(shapes)
    for row in rows:
        counters = row.get("counters", [row["name"]])
        row["launches_by_path"] = {path: sum(p.get(c, 0) for c in counters)
                                   for path, p in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        for path, shape in row.get("by_shape", {}).items():
            shape["launches"] = shape_counts[path].get(row["name"], 0)
            # what this shape's launches lose against the bound per run
            shape["gap_ms_per_run"] = shape["launches"] * (
                shape["ms"] - shape["bound_ms"])
    emit("done", seconds=time.perf_counter() - t_start)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
