#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
                nvcc per source, in parallel; the port has no Triton);
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at the main path's full-width shapes and at edge shapes,
                with kernel / plain / library-yardstick times (cold L2)
                and the least time the card could take (bound: the bytes
                this data needs at the HBM rate — the fused entry reads
                each distinct table row once —, or fp32 operations at the faster of the
                CUDA cores and the 3xTF32 tensor-core route); the two
                paged kernels also over bf16, int8 and fp8 pages, held
                against the dequantize-then-attend plain version and,
                within the analytic bound, the pristine fp32 one;
                flash-decode over a ring and flash attention over ragged,
                windowed, bidirectional, offset and fully masked shapes,
                at whisper-small's two shapes and at gemma-2b's heads (Dh
                256, 8 over 1 KV head); the demux with its LN entry at
                rwkv6-7b's width (decode and a 32-token chunk); the RWKV6
                recurrence at decode, 7, 100, 109, 128 and 300 tokens,
                head dims 16, 32, 64 and 128, strong and weak decay,
                against its chunkwise plain version and the sequential
                oracle (elementwise, the reference suite's tolerance), bit
                for bit over two calls, and two halves chained through the
                state against one pass; flash-decode with q_pos in a device
                tensor (bit for bit the int's result), captured in a CUDA
                graph and replayed at new positions, at 16 query heads over
                one KV head and head dim 256, and bit for bit over two
                calls; the fused embed + mux entry at qwen2-1.5b's decode
                and chunk, rwkv6-7b's and whisper-small's decoder widths,
                and with a bf16 table and output (within one bf16
                half-ulp of the plain version's fp32 sum); the mux-combine
                entry at whisper-small's encoder entry, a qwen2-1.5b and
                an rwkv6-7b prefill entry, in fp32 and bf16, and at odd N,
                T and D; phase 8's shapes, each its own row and bit for
                bit over two calls: the fused entry at T 10240 over vocab
                30522, the mux-combine entry at (2, 10240, 768),
                bidirectional flash attention over 80 rows of 128 and of
                130 tokens (12 heads of 64), the demux with its LN entry
                at d 768, F 1536 over T 10240 at N=2 and T 2048 at N=10;
                phase 9's shapes, each its own row, read from the
                configs: both paged kernels at h2o-danube-1.8b's heads
                (head_dim 80 in the 128 instantiation, 32 over 8) over
                its long request, whose 4096-token window cuts the
                context, on the four page storages, and at gemma-7b's
                (MHA at head_dim 256), the fused entry at vocab 256000, d
                3072 scaled by sqrt(d), the demux with its RMS entry at d
                3072, F 6144 (T 4 and 32); the bf16 rows (the
                reference's compute dtype) at phase 10's shapes: both
                paged kernels with a bf16 q at phase 4's decode rows and
                32-token chunk (qwen2-1.5b's heads over bf16, int8 and
                fp8 pages, gemma-2b's over bf16 pages), the ring decode
                in bf16 at B 4, C 124 and the demux exit in bf16 (RMS
                entry, F = 2 * d, T 4 and 32) at both models' heads and
                widths, each within one bf16 ulp of its row's
                largest value of its plain version (the demux two), bit
                for bit over two calls where a repeat is checked, and
                timed beside the library call in bf16; the bf16 rows of
                phases 6-8's shapes (``BF16_REST_ROWS``): flash attention
                at whisper-small's encoder and cross-attention (whose
                keys split over blocks), qwen2-1.5b's causal L 116,
                gemma-2b's and h2o-danube-1.8b's heads and mux-bert-base's
                80 rows of 128 and 130, the RWKV6 recurrence at
                rwkv6-7b's decode and 100-token prefill, head dims 16 and
                128 and over two halves chained through the state
                (``out`` within the fp32 tolerance plus one bf16 ulp of
                the row max, the fp32 state within it), flash-decode at
                whisper's cross decode, and the LN-entry demux at
                rwkv6-7b's, whisper-small's and mux-bert-base's exits;
                phase 14's shapes (``MOE_ROWS``), read from the configs:
                both paged kernels at granite-moe-3b-a800m's heads (24
                over 8 of 64) and qwen2-moe-a2.7b's (16 over 16 of 128)
                in fp32 and with a bf16 q over bf16 pages, and the fused
                entry at granite's vocabulary 49155 and d 1536;
                phase 15's shapes (``HYBRID_ROWS``), read from
                recurrentgemma-9b's config, in fp32 and bf16: the ring
                decode at 16 query heads over 1 KV head of 256 (B 4, C
                124; the long request's B 1 over a wrapped 2048-slot ring,
                window 2048), flash attention at the same heads (B 4,
                causal L 116; B 1, L 2200, window 2048), the demux with its
                RMS entry at d 4096, F 8192, T 4, and in fp32 the fused
                entry at vocab 256000, d 4096 scaled by sqrt(d), and the
                mux-combine entry at (2, 464, 4096); phase 16's shapes
                (``LLAVA_ROWS``), read from llava-next-mistral-7b's config,
                in fp32: the mux-combine entry of a prefill over 576
                patches and a 100-token prompt (2, 4 * 676, 4096), flash
                attention at 32 query heads over 8 KV heads of 128 (B 4,
                causal L 676), the ring decode at the same heads over a
                700-slot ring at 690, and the fused entry at vocab 32000,
                d 4096;
                and the timer's floor, a one-element ``add_`` timed the
                same way, beside every kernel time;
  4. serve    — ``run_continuous`` on full-width qwen2-1.5b (28 layers,
                random seeded weights), mux N=2, chunked prefill, once
                per page storage (fp32, bf16, int8, fp8) on one trace;
                every request must complete, the launch counts must be
                exactly what the path requires (per storage kind), and
                the pool's bytes per token the reference's;
  4b. dense   — the same trace with ``attn_impl='flash'`` through the
                continuous ring arm, paged serving with blocking prefill,
                and fill-drain: every request complete, launch counts
                exact (flash_attention once per layer per prefill,
                decode_attention once per layer per ring decode step, no
                paged kernel on the ring, mux_combine once per blocking
                prefill: its unfused entry);
  5. paths    — kernel path against plain path, on fp32 and int8 pages:
                logits of one prefill chunk and of one decode step from
                identical caches, and the share of identical greedy
                tokens over the phase-4 trace (on int8 pages the chunk
                is held to the payloads it stores, see ``compare_paths``);
                on the ring, the flash prefill against the naive one and
                the ring decode step from identical caches, and the
                greedy share of the ring arm;
  6. rwkv     — the qwen2-1.5b weights freed, full-width rwkv6-7b (32
                layers, d 4096, random seeded weights) serves the same
                trace through the ring arm and fill-drain on the kernel
                path: every request complete, launch counts exact
                (rwkv6_chunked once per layer per forward, the entry and
                the LN-entry demux once per decode step, mux_combine once
                per prefill); then kernel path against plain path: logits
                of one prefill and of one decode step from identical
                states within 2e-3, and the ring arm's greedy tokens
                identical; then the same weights in bf16
                (``ServeConfig.dtype``'s default) through both arms with
                exact launch counts, the prefill's and a decode step's
                logits from identical states against the same model with
                the wrappers at their plain versions within
                ``BF16_LOGIT_ULPS`` bf16 ulps of |logits| max, greedy
                agreement with the fp32 run and with those plain
                versions printed;
  7. whisper  — the rwkv6-7b weights freed, full-width whisper-small (12
                encoder and 12 decoder layers, d 768, random seeded
                weights, ``attn_impl='flash'``) serves the same trace in
                fill-drain with seeded N(0, 1) frames (1500 a request):
                every request complete, launch counts exact (mux_combine
                twice per prefill — the encoder's and the decoder's entry
                —, flash_attention once per encoder layer and twice per
                decoder layer per prefill, decode_attention twice per
                decoder layer per decode step, the fused entry and exit
                once per step); then kernel path against plain path:
                logits of the prefill and of one decode step from
                identical caches within 2e-3, greedy tokens identical;
                then the same weights in bf16, the reference's default,
                held as phase 6's bf16 pass holds rwkv6-7b (launch counts
                exact, logits within ``BF16_LOGIT_ULPS``, greedy
                agreement printed);
  8. bert     — the whisper-small weights freed, full-width mux-bert-base
                (12 layers, d 768, 12 heads of 64, d_ff 3072, vocab
                30522, 512 positions; random seeded weights with the
                ELECTRA head, a classifier and a token head,
                ``attn_impl='flash'``), 160 instances of 128 seeded
                tokens held fixed so N shrinks the backbone batch (160,
                80, 32, 16 rows at N = 1, 2, 5, 10): for N=1, each (mux,
                demux) pair at N=2 and the Gaussian / RSA pair at N 5 and
                10, one ``hidden`` with exact launch counts (flash
                attention once a layer; the fused entry and exit for
                Gaussian / RSA, ``mux_combine`` for Gaussian / prefix, the
                fused exit alone for contextual / RSA, neither for
                contextual / prefix); at N > 1 the MLM, RTD, classifier
                and token heads on the kernel path against the plain path
                within 2e-3 and the MLM argmax identical at 0.999 or more;
                then instances per second of ``mlm_logits`` on the kernel
                path at N = 1, 2, 5, 10 (p50 of 5 calls after a warm one)
                and their ratios to N=1 beside the card's name and power
                limit (no claim rests on them), then one more N=2 call
                under ``torch.profiler``: its device busy time, idle
                share and device time by kernel group (matmuls, demux,
                flash, entry, other); then ``dtype=torch.bfloat16``: one
                N=2 Gaussian / RSA ``hidden`` with exact launch counts,
                the four heads against the wrappers' plain versions
                within ``BF16_LOGIT_ULPS`` (the MLM argmax agreement
                printed), and instances per second at N = 1, 2, 5, 10
                beside fp32's;
  9. dense    — the mux-bert-base weights freed, full-width gemma-2b,
                h2o-danube-1.8b and gemma-7b (seeded random weights,
                one at a time, each freed before the next) serve the
                phase-4 trace paged chunked: every request complete,
                launch counts exact per step, the pool's bytes per token
                on the card equal to ``ServeConfig.kv_bytes_per_token``;
                then kernel path against plain path (one chunk and one
                decode step from identical caches within 2e-3, greedy
                tokens identical).  h2o-danube-1.8b also serves on bf16,
                int8 and fp8 pages, and one 4200-token request past its
                window on both paths (greedy identical, the last chunk's
                and a decode step's logits within 2e-3, each path timed);
                gemma-2b also serves the ring arm and paged blocking
                prefill with ``attn_impl='flash'`` (launch counts exact,
                as phase 4b), and a pool under the worst case
                (``PRESSURE_BLOCKS``): every request complete, admission
                rollbacks and preemptions counted (each at least once),
                the pool drained with its invariants held, greedy
                agreement with the worst-case pool printed; the phase
                prints ``torch.cuda.max_memory_allocated``;
  10. bf16    — phase 9's weights freed, full-width qwen2-1.5b and then
                gemma-2b (seeded random weights) serve the phase-4 trace
                at ``ServeConfig.dtype=torch.bfloat16``, the default:
                qwen2-1.5b paged chunked on default (bf16), fp32, int8
                and fp8 pages, paged blocking and the ring arm; gemma-2b
                paged chunked and on the ring arm.  Every request
                complete, launch counts exact, the pool's bytes per token
                on the card equal to ``ServeConfig.kv_bytes_per_token``
                (the reference's figures for qwen2-1.5b); from identical
                caches a chunk's and a decode step's logits (the ring: a
                decode step's) on the kernel path against the same model
                with the wrappers at their plain versions (the kernels'
                rounding points), within ``BF16_LOGIT_ULPS`` bf16 ulps of
                |logits| max; greedy agreement of the kernel path with
                those plain versions, the plain model path and phase 4's
                fp32 run printed, and the near ties behind them (top-2
                logit gaps, teacher-forced over the prompts); one
                call of each bf16 kernel (flash attention and RWKV6 too)
                under ``torch.profiler`` shows only its own source's bf16
                kernels (no cast); decode and
                chunk p50, tok/s, ``torch.cuda.max_memory_allocated`` and
                the card's name and power limit;
  11. lanes   — phase 10's weights freed, full-width qwen2-1.5b in fp32,
                one backbone shared by reference across mux widths
                (phase 4's N=2 weights; N=1 without the mux and demux,
                N=4 with its own): (a) width lanes at N = 1, 2, 4, 4 rows
                each, paged chunked, on a seeded trace of 24 requests
                with SLO classes latency / balanced / throughput 1 : 1 :
                1 — every request complete, each lane's step signatures
                one decode plus one per bucket, launches per lane exact
                (at N=1 no entry or exit), each lane token-identical to a
                fixed-width run of its routed sub-schedule; then under a
                block budget of ``BUDGET_SHARE`` of the lanes' ceilings:
                quota rebalanced, every pool drained, the N=1 lane's
                tokens unchanged; routing counters and per-lane stats
                printed; (b) disaggregated: a prefill-only and a
                decode-only lane at N=2 on fp32 and int8 pages — phase
                4's tokens, no decode on the prefill lane and no prefill
                on the decode lane (launches per lane exact), handoffs
                counted on both sides, every migrated page (payload,
                scales, positions) ``torch.equal`` to its source taken
                just before the move; the handoff's host p50 and one
                row's page copy on the device beside its byte bound;
                (c) phase 4's trace with ``Telemetry(snapshot_every=4,
                annotate=True)`` and without: tokens and launches per
                step identical, the metrics JSON, ``.prom`` and Chrome
                trace written and parsed back (engine_step spans = engine
                steps, pid = lane), one profiled step showing the
                ``record_function`` ranges, the host wall of both runs;
  12. shards  — phase 11's N=2 weights (phase 4's), full-width qwen2-1.5b
                in fp32 on phase 4's trace, then freed: (a) two logical
                shards (``ServeConfig.n_shards=2``, 34 blocks, a trash
                block each) with straggler fencing armed — every request
                complete, launches exact, nothing fenced, greedy
                agreement with phase 4's one-shard run printed; then
                shard 1 killed at the first step both its rows decode:
                every request complete, the survivors token-identical to
                the undisturbed run, the re-prefill tokens those of the
                replayed requests' logs, every page of shard 1's segment
                but its trash block ``torch.equal`` from the kill to the
                end and the trash block's positions -1, the replayed
                streams' agreement and the recovery latency (host)
                printed; (b) one shard: a restart (snapshot into a
                temporary directory under ``build/``, a fresh runtime,
                restore) at the first step with nothing queued or
                mid-prefill on fp32, bf16 and fp8 pages — every restored
                cache leaf ``torch.equal`` to the one captured, no
                prefill after the restore, phase 4's tokens on that
                storage — and one fp32 restart mid-prefill that runs only
                the chunks an undisturbed run does; snapshot bytes, save
                and restore times (host) beside the card.
  13. train   — the paper's training on the plain model path:
                full-width mux-bert-base through the launcher, one step
                against the CPU, full-width qwen2-1.5b AdamW steps with
                remat on and off, then the trained weights served through
                the kernels;
  14. moe     — phase 13's weights gone, full-width granite-moe-3b-a800m
                (40 experts, top 8) and then qwen2-moe-a2.7b (60 routed
                experts, top 4, 4 shared; 53.3 GiB of fp32 weights),
                seeded random weights, on phase 4's trace: granite in
                fp32 paged chunked on fp32 and int8 pages, the ring arm,
                paged blocking with flash and fill-drain, every request
                complete, launch counts exact and one MoE call a layer a
                forward (dropped assignments per prefill event and the
                load per expert printed), the kernel path against the
                plain path (a chunk's and a decode step's logits from
                identical caches within 2e-3, greedy tokens identical);
                at the default bf16, paged chunked and on the ring,
                launch counts exact, logits against ``kernels_as_plain``
                within ``BF16_LOGIT_ULPS`` and greedy agreement with fp32
                printed; one granite decode step twice from one cache
                (bit for bit), once under ``set_sync_debug_mode("error")``
                and once under the profiler (device time by group, the
                dispatch's "moe dispatch" beside matmuls and the main-path
                kernels); one granite AdamW step on the plain path (2 x
                128 tokens, N=2, remat on: loss and aux finite, peak
                memory); qwen2-moe-a2.7b paged chunked in fp32 and bf16
                with the same checks; ``torch.cuda.max_memory_allocated``
                of each;
  15. hybrid  — phase 14's weights gone, full-width recurrentgemma-9b (38
                layers: 12 periods of two RG-LRU blocks and one local
                attention block, a tail of two RG-LRU blocks; 9.40 B
                params, 35.0 GiB in fp32; seeded random weights) on phase
                4's trace with ``attn_impl='flash'``: the ring arm in fp32
                and bf16 and fill-drain in fp32, every request complete,
                launch counts exact (a ring decode step 12
                decode_attention and the fused entry and exit once, a grid
                re-prefill mux_combine once and 12 flash_attention, no
                paged kernel); kernel path against plain path from
                identical caches (fp32: the prefill's and a decode step's
                logits within 2e-3, the ring arm's greedy tokens
                identical; bf16: within ``BF16_LOGIT_ULPS`` of the
                wrappers' plain versions, greedy agreement with fp32
                printed); one 2200-token request (16 new, one row, N=2) in
                fill-drain in fp32 and bf16, every local ring wrapped,
                greedy identical to the plain path and its prefill's and a
                decode step's logits within 2e-3; one ring decode step
                twice from one cache (bit for bit), once under
                ``set_sync_debug_mode("error")`` and once under the
                profiler (device time by group: matmuls, the four kernels,
                the RG-LRU's conv, scan and gate kernels); the peak
                memory;
  16. vlm     — phase 15's weights gone, full-width llava-next-mistral-7b
                (32 layers, d 4096, 32 query heads over 8 KV heads of 128,
                the multimodal projector 1024 -> 4096 -> 4096; seeded
                random weights, depth not cut) on phase 4's trace with 576
                seeded N(0, 1) patch embeddings a request and
                ``attn_impl='flash'``: (a) fill-drain at the reference
                CLI's capacity and decode positions, every request
                complete, launch counts exact (a prefill mux_combine once
                and 32 flash_attention, no demux kernel; a decode step 32
                decode_attention and the fused entry and exit once; no
                paged or RWKV kernel), kernel path against plain path (the
                prefill's and a decode step's logits from identical caches
                within 2e-3, greedy tokens identical); (b) the true
                positions (capacity 700, decode at 676 + t) through
                ``engine.prefill`` / ``decode_step``: launch counts exact,
                every step's logits within 2e-3 of the plain path's
                no-cache forward over [patches, prompt, tokens so far],
                greedy identical to the plain path; (c) bf16 on (b)'s path
                within ``BF16_LOGIT_ULPS`` of the wrappers' plain versions,
                greedy agreement with fp32 printed; (d) one decode step
                twice from one cache (bit for bit), under
                ``set_sync_debug_mode("error")`` and profiled (device time
                by group: matmuls, the kernels), one prefill profiled, the
                projector alone timed by CUDA events; (e) the peak memory.
  17. mesh    — phase 16's weights gone: (a) the shard-local wrappers
                ``sharded_paged_attention`` / ``sharded_paged_prefill_attention``
                at qwen2-1.5b's heads (12 over 2 of 128), phase 4's decode
                rows and a 32-token chunk a row, on fp32 and int8 pages in
                ``ShardedKVPool``'s layout split over 2 data shards and a
                model axis of 2 (6 query heads over 1 KV head a rank):
                each shard's call in this process against the unsharded
                kernel's rows and heads on the whole pool and the plain
                version, timed beside the unsharded call; (b) full-width
                qwen2-1.5b (seed 0, phase 4's weights) on a (2, 2) serve
                mesh, four ranks sharing the card over gloo
                (``launch.mesh.spawn``), phase 4's trace in fp32 at N=2,
                paged chunked with the kernels: every request complete on
                every rank, one decode signature and one per bucket, the
                main path's kernels and both shard-local wrappers
                launched, the first chunk's logits within ``LOGIT_TOL`` of
                the single-device run's, greedy agreement with phase 4
                printed, each rank's decode p50 and peak memory; (c)
                full-width granite-moe-3b-a800m on (1, 2): 20 of 40 experts
                a rank, its vocabulary of 49155 on the embedding's d axis,
                the same checks against phase 14; (d) in (b)'s spawn,
                after (b)'s weights are freed: width lanes N = 1, 2 (seeds
                1 and 2, as the CLI's) on (2, 2), the trace's requests
                latency and throughput in turn, then disaggregated N=2 (a
                prefill lane of 4 rows handing rows to a decode lane of 4),
                whose handoffs cross data shards, so ranks (``page_move``
                broadcasts): every request complete, the ranks' tokens
                identical, requests, tokens, prefill, handoffs and
                migrated bytes equal to the same runs unsharded (2 logical
                shards, in this process before the spawn), the first
                chunk's logits within ``LOGIT_TOL`` of the unsharded run's,
                each moved row's pages equal as bytes (sha256) on the
                source and the destination rank, the main path's four
                kernels and both shard-local wrappers launched on every
                rank; greedy agreement, each rank's decode p50, handoff
                time and bytes, peak and collectives printed.  The parent
                holds no weights while the ranks run; a rank's failure or
                timeout fails the run.
  18. train mesh — training on a device mesh, on the plain model path
                (no kernel has a backward): one spawn of four ranks
                sharing the card over gloo over CUDA tensors.  (a)
                full-width mux-bert-base N=2, the retrieval stage, 32 x
                128 over a data axis of 4 (8 rows a rank):
                ``make_compressed_dp_step`` three steps plain and
                compressed, every rank's params ``torch.equal`` to rank
                0's after each step, the compressed mean within gscale /
                2 of the plain mean on the same gradients, the plain
                step against one device's full-batch steps (losses, grad
                norms, the first step's gradient), step ms and the bytes
                each step hands to ``all_reduce``; (b) full-width
                qwen2-1.5b N=2, 4 x 256, on (data=2, model=2): three
                sharded AdamW steps (``make_train_step(mesh=)``) against
                the same steps on one device in the parent (loss within
                1e-4, Σ|params| within 1e-5 relative), each rank's peak
                memory and collectives a step (``weight_gather`` among
                them); (c) qwen2-1.5b's 28 blocks as 4 stages of 7 on
                ``('pipe',)`` 4, 8 microbatches of 128 tokens:
                ``pipeline_apply`` within 1e-5 of the blocks in turn, the
                gradients of a scalar of its output against the
                sequential ones.  The parent holds no weights while the
                ranks run.
  19. dry run — (a) ``launch.dryrun`` over the four cells of the reference's
                integration test (gemma-2b train, granite-moe-3b-a800m
                train at N=2, rwkv6-7b decode at N=2, whisper-small
                train) at full width, as rank (0, 0) of the (16, 16)
                production mesh on fake tensors, four host processes that
                touch no card: each row and the roofline table, all ok;
                (b) full-width qwen2-1.5b at N=2 materialised on the card
                with seeded weights, three cells each cut to fit one card
                (``DRY_CUTS``): a kernel prefill (``build_prefill(
                use_kernels=True)``), a ring decode and one AdamW step
                (``build_train_step``), each timed by CUDA events (2
                warm-ups, the median of 5) and traced by the dry run at
                the same cut on a (1, 1) recording mesh: the time must
                be at least the dry run's bound, the dry run's argument
                bytes exactly the bytes of the params, optimizer state,
                cache and batch on the card, the prefill must launch the
                fused entry and exit, and its logits meet phase 10's bf16
                gate against the wrappers' plain versions; (c)
                ``examples/torch_quickstart.py`` and
                ``examples/torch_serve_mux.py`` on the card, the serve
                demo's count lines equal to its CPU run's.
The kernels' JSON line lists every kernel of phases 3-17 and the timer
floor (``floor_ms``).  The last two
lines are the card's name and power limit, then the device
JSON.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_S = 67e12        # H100 SXM fp32 outside the tensor cores
TF32_FLOP_S = 495e12       # H100 SXM TF32 tensor cores, dense
BF16_FLOP_S = 989e12       # H100 SXM bf16 tensor cores, dense
# fp32-exact products on the tensor cores take three TF32 products (the
# flash kernel's split), so fp32 work can run at TF32_FLOP_S / 3
FP32_EXACT_FLOP_S = max(FP32_FLOP_S, TF32_FLOP_S / 3)
ATT_TOL = 1e-4             # fp32, summation order only; O(1) outputs
MUX_TOL = 1e-5             # a sum of N=2 products per element
# mux_combine against its plain version: the reference suite's tolerance
# (tests/test_kernels.py TOL); bf16 rounds the fp32 sum once on both sides
COMBINE_TOL = {"fp32": 2e-5, "bf16": 5e-2}
DEMUX_TOL = 5e-4           # fp32 sums over D=1536 then F=3072 terms, post-LN
LOGIT_TOL = 2e-3           # 28 fp32 layers, two summation orders
# the RWKV6 kernel against its plain versions, elementwise on out and sT:
# the reference suite's own kernel tolerance (tests/test_kernels.py
# test_rwkv6); the plain chunkwise form rounds exp(la_prev - la_j), a
# difference of cumulative sums, the kernel one exp per token
RWKV_TOL = {"atol": 5e-4, "rtol": 1e-3}
RWKV_TOL_TEXT = "atol 5e-4 + rtol 1e-3 * |want|"
RWKV_BF16_TEXT = ("out: that + 1 bf16 ulp of the row max; sT: "
                  + RWKV_TOL_TEXT)
BF16_REL = 2.0 ** -8       # bf16 half-ulp relative rounding error
BF16_ULP = 2.0 ** -7       # one bf16 ulp, relative
# phase 10: the bf16 kernel path against the same model with the wrappers at
# their plain versions (the kernels' rounding points), in bf16 ulps of the
# logits' largest magnitude.  The two differ by the kernels' fp32 summation
# order alone, which 18-28 bf16 layers amplify: 1.8-3.0 ulps over the twelve
# chunk and decode readings on an H100 (PERF.md §6), where the plain model
# path's own rounding points read 3.1-8.1 ulps and fp32 compute 2.8-8.6
BF16_LOGIT_ULPS = 4
KINDS = ("fp32", "bf16", "int8", "fp8")       # page storage
# the reference's ServeConfig figures for full-width qwen2-1.5b, N=2, 4 rows
# at capacity 124 in blocks of 16 (33 blocks with the trash block)
KV_BYTES_PER_TOKEN = {"fp32": 57456, "bf16": 28784, "int8": 14896,
                      "fp8": 14896}
POOL_BYTES = {"fp32": 30_336_768, "bf16": 15_197_952, "int8": 7_865_088,
              "fp8": 7_865_088}


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of ``fn`` over ``iters`` calls, each timed by its
    own CUDA events.  Before each call L2 is flushed (the serve path meets
    every kernel with a cold L2: 28 layers of weights pass between two
    calls of the same kernel) and the stream is held busy by a spin
    kernel, so the host enqueues the events and the call while the device
    is still spinning: the interval holds device time, not the host's
    launch overhead (which the serve-step latency in phase 4 includes).
    That holds only if ``fn`` never waits for the device, so the timed
    calls run under torch's sync debug mode "error": a call that
    synchronizes (a host-to-device copy, ``.item()``) fails the run."""

    SPIN_CYCLES = 20_000_000          # ~10 ms at the H100's boost clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def bound(nbytes, flops, bf16_flops=0):
    """The least time the card could take: bytes over the HBM rate, or the
    operations: ``flops`` fp32 ones over the faster of the CUDA cores and
    the 3xTF32 route, and ``bf16_flops`` of products whose operands are
    all exact in bf16 over the bf16 tensor cores' rate."""
    t_b = nbytes / HBM_BYTES_S
    t_f = flops / FP32_EXACT_FLOP_S + bf16_flops / BF16_FLOP_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def embed_bytes(tok, d, elt):
    """The bytes the fused entry must move: each distinct table row once
    (a repeated token's row is read once), the N keys, the (T, D) output
    in ``elt``-byte elements and the int32 tokens."""
    n = tok.shape[0]
    return ((tok.unique().numel() + n + tok.shape[1]) * d * elt
            + tok.numel() * 4)


def attn_bytes_flops(q, bt, pp, q_pos_rows, hkv, dh, elem=4, scaled=False,
                     window=None):
    """The work paged attention needs on this data: q and the output in
    q's dtype, K/V of the valid slots
    of each row's pages that some query of the row sees (all of them
    without a window; ``elem`` bytes per element, and with ``scaled``
    pages one fp32 K and one fp32 V scale per such (slot, KV head)), and
    QK + PV products only for the (query, slot) pairs that pass the
    validity, causal and window mask.  q (B, Lq, H, Dh); bt (B, MB);
    pp (P, BS); q_pos_rows (B, Lq): each query's position, -1 for a
    masked query.  Returns (bytes, flops, a note with both counts)."""
    bt, pp = bt.cpu().numpy(), pp.cpu().numpy()
    q_pos_rows = q_pos_rows.cpu().numpy()
    bs = pp.shape[1]
    h = q.shape[2]
    n_pages = valid = pairs = 0
    for b in range(bt.shape[0]):
        pages = bt[b][bt[b] >= 0]
        pos = pp[pages].ravel()
        pos = pos[pos >= 0]
        qps = [qp for qp in q_pos_rows[b] if qp >= 0]
        if window is not None and qps:
            pos = pos[pos > min(qps) - window]
        n_pages += len(pages)
        valid += len(pos)
        for qp in qps:
            seen = pos <= qp
            if window is not None:
                seen &= pos > qp - window
            pairs += int(seen.sum())
    nbytes = (2 * valid * hkv * dh * elem + 2 * q.numel() * q.element_size()
              + bt.size * 4 + n_pages * bs * 4
              + (2 * valid * hkv * 4 if scaled else 0))
    return nbytes, 4 * pairs * h * dh, (f"{valid} valid slots, {pairs} "
                                        "query-slot pairs")


def dense_bound(q, k, vis):
    """Least work of attention over fresh K/V: q and the output once, K/V
    of the keys some query sees once per KV head (all in q's dtype), 4 *
    Dh flops per (query head, visible pair); ``vis`` (Lq, Lk) bool."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    keys = int(vis.any(0).sum())
    pairs = int(vis.sum())
    nb = (2 * q.numel() + 2 * b * keys * hkv * dh) * q.element_size()
    fl = 4 * b * h * dh * pairs
    return nb, fl, (f"{keys} keys read, {pairs} query-key pairs per "
                    "(row, head)")


def sdpa_dense(q, k, v, mask):
    """Library yardstick: SDPA over the same K/V (GQA, boolean mask)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def phase_kernels(torch, timer):
    """Phase 3.  Returns {kernel: summary, "floor_ms": the timer floor}
    for the JSON line."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import demux_rsa as kd
    from repro_torch.kernels import mux_embed as km
    from repro_torch.kernels import paged_attention as kp
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(x):
        return torch.as_tensor(x, device=dev)

    def pool(lens, *, P, BS=16, MB=8, hkv=2, dh=128):
        k = rng.standard_normal((P, BS, hkv, dh), np.float32)
        v = rng.standard_normal((P, BS, hkv, dh), np.float32)
        bt = np.full((len(lens), MB), -1, np.int32)
        pp = np.full((P, BS), -1, np.int32)
        free = list(range(1, P))
        for b, n in enumerate(lens):
            if n < 0:
                continue
            blocks = [free.pop() for _ in range(-(-n // BS))]
            bt[b, :len(blocks)] = blocks
            for i in range(n):
                pp[blocks[i // BS], i % BS] = i
        return t(k), t(v), t(bt), t(pp)

    out = {}

    def record(name, case, err, tol, timing=None, share=None):
        """``share``: an elementwise tolerance's largest used share (the
        check is then share <= 1, and ``tol`` names the tolerance)."""
        s = out.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        line = f"  {name:<24} {case:<30} max_abs_err {err:.3e} "
        if share is None:
            line += f"(tol {tol:g})"
        else:
            line += f"({share:.3f} of {tol})"
            err, tol = share, 1.0
        if timing:
            s.setdefault("timing", timing)
            s["cases"].append({"case": case, **timing})
            lib = timing["library_ms"]
            line += ("  kernel {ms:.5f} ms  plain {plain_ms:.5f} ms  "
                     "library {lib}  bound {bound_ms:.6f} ms "
                     "({bound_by}: {bytes} bytes, {flops} flops)"
                     ).format(lib="none" if lib is None else f"{lib:.5f} ms",
                              **timing)
            if "work" in timing:
                line += f"  [{timing['work']}]"
        print(line, flush=True)
        need(err <= tol, f"{name} [{case}] disagrees with its plain version: "
             f"max_abs_err {err} > {tol}")

    def sdpa(q, k_pages, v_pages, bt, pp, qpos_rows, k_scales=None,
             v_scales=None, window=None):
        """Library yardstick: gather the rows' pages (and scales), dequant
        to fp32, then SDPA in q's dtype (K/V repeated to H heads, boolean
        mask)."""
        b, lq, h, dh = q.shape
        btc = bt.long().clamp(min=0)

        def rows(x):          # fp8 pages gather as their bytes
            if x.dtype == torch.float8_e4m3fn:
                return x.view(torch.uint8)[btc].view(x.dtype)
            return x[btc]
        k, v = rows(k_pages).float(), rows(v_pages).float()
        if k_scales is not None:
            k = k * rows(k_scales)[..., None]
            v = v * rows(v_scales)[..., None]
        k = k.reshape(b, -1, *k_pages.shape[2:]).to(q.dtype)
        v = v.reshape(b, -1, *v_pages.shape[2:]).to(q.dtype)
        pos = torch.where(bt[..., None] >= 0, pp[btc], -1).reshape(b, -1)
        g = h // k.shape[2]
        k = k.repeat_interleave(g, 2).transpose(1, 2)
        v = v.repeat_interleave(g, 2).transpose(1, 2)
        mask = (pos[:, None, :] >= 0) & (pos[:, None, :] <= qpos_rows[..., None])
        if window is not None:
            mask = mask & (pos[:, None, :] > qpos_rows[..., None] - window)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                              attn_mask=mask[:, None])

    # -- paged decode attention --------------------------------------------
    print("phase 3: kernels against their plain versions", flush=True)
    one = torch.zeros(1, device=dev)
    out["floor_ms"] = timer(lambda: one.add_(1.0))
    print(f"  timer floor (a one-element add_, same flush and spin): "
          f"{out['floor_ms']:.5f} ms", flush=True)
    decode_cases = [
        ("main: B=4 rows, ctx 100-117", [117, 108, 101, 100],
         [116, 107, 100, 99], 8, 33),
        ("edge: -1 entries + inactive", [40, 17, -1, 3], [39, 16, -1, 2], 8,
         33),
        ("edge: single-block rows", [16, 3, 1], [15, 2, 0], 1, 8),
        ("edge: non-pow2 lengths", [29, 13, 7], [28, 12, 6], 4, 16),
        ("edge: B=1", [13], [12], 4, 8),
    ]
    for i, (case, lens, qpos, mb, p) in enumerate(decode_cases):
        k_p, v_p, bt, pp = pool(lens, P=p, MB=mb)
        q = t(rng.standard_normal((len(lens), 1, 12, 128), np.float32))
        qp = t(np.asarray(qpos, np.int32))
        got = kp.paged_attention_cuda(q, k_p, v_p, bt, pp, qp)
        want = ref.paged_attention_ref(q, k_p, v_p, bt, pp, qp)
        timing = None
        if i == 0:
            nb, fl, work = attn_bytes_flops(q, bt, pp, qp[:, None], 2, 128)
            bms, by = bound(nb, fl)
            timing = {"work": work,
                "ms": timer(lambda: kp.paged_attention_cuda(q, k_p, v_p, bt,
                                                            pp, qp)),
                "plain_ms": timer(lambda: ref.paged_attention_ref(
                    q, k_p, v_p, bt, pp, qp)),
                "library_ms": timer(lambda: sdpa(q, k_p, v_p, bt, pp,
                                                 qp[:, None])),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("paged_attention", case, (got - want).abs().max().item(),
               ATT_TOL, timing)

    # -- paged chunked-prefill attention -----------------------------------
    prefill_cases = [
        ("main: chunk 32 at 64", [96], [64], [32], 32, 8, 33),
        ("main: bucket 4 at 96", [100], [96], [4], 4, 8, 33),
        ("edge: block boundary", [48, 32], [32, 16], [16, 16], 16, 8, 33),
        ("edge: padded + inactive", [23, -1], [16, -1], [7, 0], 8, 4, 12),
        ("edge: single-block rows", [16, 6], [8, 2], [8, 4], 8, 1, 8),
        ("edge: non-pow2 Lq=7", [23, 11], [16, 6], [7, 5], 7, 4, 12),
    ]
    for i, (case, lens, qs, ql, lq, mb, p) in enumerate(prefill_cases):
        k_p, v_p, bt, pp = pool(lens, P=p, MB=mb)
        q = t(rng.standard_normal((len(lens), lq, 12, 128), np.float32))
        qs_t, ql_t = t(np.asarray(qs, np.int32)), t(np.asarray(ql, np.int32))
        got = kp.paged_prefill_attention_cuda(q, k_p, v_p, bt, pp, qs_t, ql_t)
        want = ref.paged_prefill_attention_ref(q, k_p, v_p, bt, pp, qs_t,
                                               ql_t)
        timing = None
        if i < 2:                       # the chunk and a 4-token bucket
            li = torch.arange(lq, device=dev)[None]
            qrows = qs_t[:, None] + li
            masked = (li >= ql_t[:, None]) | (qs_t[:, None] < 0)
            nb, fl, work = attn_bytes_flops(
                q, bt, pp, torch.where(masked, -1, qrows), 2, 128)
            bms, by = bound(nb, fl)
            timing = {"work": work,
                "ms": timer(lambda: kp.paged_prefill_attention_cuda(
                    q, k_p, v_p, bt, pp, qs_t, ql_t)),
                "plain_ms": timer(lambda: ref.paged_prefill_attention_ref(
                    q, k_p, v_p, bt, pp, qs_t, ql_t)),
                "library_ms": timer(lambda: sdpa(q, k_p, v_p, bt, pp, qrows)),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("paged_prefill_attention", case,
               (got - want).abs().max().item(), ATT_TOL, timing)

    # -- fused embed + mux entry -------------------------------------------
    bf = torch.bfloat16
    tables = {}
    embed_cases = [
        # (case, vocab, D, T, table / key / output dtype); all timed, the
        # first is the JSON's
        ("main: qwen2 decode T=4", 151936, 1536, 4, torch.float32),
        ("main: qwen2 chunk T=32", 151936, 1536, 32, torch.float32),
        ("main: rwkv6-7b decode T=4", 65536, 4096, 4, torch.float32),
        ("main: whisper dec T=4", 51865, 768, 4, torch.float32),
        ("bf16: qwen2 decode T=4", 151936, 1536, 4, bf),
    ]
    for case, vocab, d, tt, dt in embed_cases:
        if (vocab, d) not in tables:
            tables[vocab, d] = t(rng.standard_normal((vocab, d), np.float32)
                                 * 0.02)
        emb = tables[vocab, d].to(dt)
        v = t(rng.standard_normal((2, d), np.float32)).to(dt)
        tok = t(rng.integers(0, vocab, (2, tt)).astype(np.int32))
        got = km.mux_embed_combine_cuda(tok, emb, v, out_dtype=dt)
        sum32 = ref.mux_embed_ref(tok, emb, v)
        need(got.dtype == dt and got.shape == (tt, d),
             f"mux_embed_combine [{case}]: {got.dtype} {tuple(got.shape)}")
        elt = emb.element_size()
        nb = embed_bytes(tok, d, elt)
        bms, by = bound(nb, 2 * 2 * tt * d)
        tl = tok.long()
        timing = {
            "ms": timer(lambda: km.mux_embed_combine_cuda(tok, emb, v,
                                                          out_dtype=dt)),
            "plain_ms": timer(lambda: ref.mux_embed_ref(tok, emb, v,
                                                        out_dtype=dt)),
            "library_ms": timer(lambda: torch.einsum(
                "ntd,nd->td", F.embedding(tl, emb), v) * 0.5),
            "bound_ms": bms, "bound_by": by, "bytes": nb,
            "flops": 2 * 2 * tt * d,
            "work": f"{tok.unique().numel()} distinct table rows of "
                    f"{tok.numel()} gathers"}
        err = (got.float() - sum32).abs()
        if dt == torch.float32:
            record("mux_embed_combine", case, err.max().item(), MUX_TOL,
                   timing)
        else:       # both round the fp32 sum once: within half a bf16 ulp
            record("mux_embed_combine[bf16]", case, err.max().item(),
                   "bf16 half-ulp rel + 1e-5", timing,
                   share=(err / (BF16_REL * sum32.abs() + MUX_TOL))
                   .max().item())
    del tables, emb

    # -- Gaussian mux-combine of precomputed embeddings ------------------
    from repro_torch.kernels import mux_combine as kc
    crng = np.random.default_rng(16)     # the other cases keep their draws
    combine_cases = [
        # (case, N, T, D, dtype); the first four are timed
        ("main: whisper enc N=2 T=6000", 2, 6000, 768, "fp32"),
        ("main: qwen2 prefill T=400", 2, 400, 1536, "fp32"),
        ("bf16: whisper enc T=6000", 2, 6000, 768, "bf16"),
        ("main: rwkv6-7b prefill T=436", 2, 436, 4096, "fp32"),
        ("edge: N=5 T=100 D=96", 5, 100, 96, "fp32"),
        ("edge: N=10 T=33 D=200 bf16", 10, 33, 200, "bf16"),
        ("edge: N=1 T=7 D=5", 1, 7, 5, "fp32"),
        ("edge: N=3 T=17 D=257 bf16", 3, 17, 257, "bf16"),
    ]
    for i, (case, n, tt, d, dt) in enumerate(combine_cases):
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        x = t(crng.standard_normal((n, tt, d), np.float32)).to(dtype)
        v = t(crng.standard_normal((n, d), np.float32)).to(dtype)
        got = kc.mux_combine_cuda(x, v)
        want = ref.mux_combine_ref(x, v)
        need(got.dtype == dtype and got.shape == (tt, d),
             f"mux_combine [{case}]: {got.dtype} {tuple(got.shape)}")
        timing = None
        if i < 4:
            nb = (n * tt * d + n * d + tt * d) * x.element_size()
            fl = 2 * n * tt * d
            bms, by = bound(nb, fl)
            timing = {
                "ms": timer(lambda: kc.mux_combine_cuda(x, v)),
                "plain_ms": timer(lambda: ref.mux_combine_ref(x, v)),
                # the one PyTorch call for this function; in fp32 it is
                # also the plain version's arithmetic
                "library_ms": timer(lambda: torch.einsum("ntd,nd->td", x, v)
                                    / n),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("mux_combine", case,
               (got.float() - want.float()).abs().max().item(),
               COMBINE_TOL[dt], timing)

    # -- fused demux exit --------------------------------------------------
    d, f, n = 1536, 3072, 2

    def r(*shape, s=1.0):
        return t((rng.standard_normal(shape) * s).astype(np.float32))
    w = (r(n, d), r(d, f, s=0.02), r(d, f, s=0.02), r(f, s=0.02),
         r(f, d, s=0.02), r(d, s=0.02))
    norms = {"entry_kind": "rms", "entry_scale": r(d, s=0.1),
             "exit_scale": 1.0 + r(d, s=0.1), "exit_bias": r(d, s=0.1)}
    for i, (case, tt) in enumerate([("main: decode T=4", 4),
                                    ("main: chunk T=32", 32),
                                    ("edge: T=5", 5)]):
        h = r(tt, d)
        got = kd.demux_rsa_cuda(h, *w, **norms)
        want = ref.demux_rsa_fused_ref(h, *w, **norms)
        timing = None
        if i < 2:          # decode rows (the JSON's) and a prefill chunk
            nb = (2 * d * f + tt * d + n * d + d * f + f + 4 * d) * 4 \
                + n * tt * d * 4
            fl = 2 * tt * d * f + 2 * n * tt * f * d + 2 * n * d * f
            bms, by = bound(nb, fl)

            def library():
                hn = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-6)
                hn = hn * (1 + norms["entry_scale"])
                z = F.gelu(torch.matmul(hn, w[1])[None]
                           + (w[0] @ w[2] + w[3])[:, None],
                           approximate="tanh")
                return F.layer_norm(torch.matmul(z, w[4]) + w[5], (d,),
                                    norms["exit_scale"], norms["exit_bias"],
                                    eps=1e-6)
            timing = {
                "ms": timer(lambda: kd.demux_rsa_cuda(h, *w, **norms)),
                "plain_ms": timer(lambda: ref.demux_rsa_fused_ref(h, *w,
                                                                  **norms)),
                "library_ms": timer(library),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("demux_rsa", case, (got - want).abs().max().item(), DEMUX_TOL,
               timing)

    # -- flash-decode over a ring cache ------------------------------------
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfl

    def ring_pos(c, written):
        """Slot positions of a c-slot ring after writing 0 .. written-1."""
        pos = np.full((c,), -1, np.int32)
        for p in range(written):
            pos[p % c] = p
        return t(pos)

    def visible(q_pos, k_pos, causal, window, valid):
        """(Lq, Lk) bool: which (query, key) pairs the mask lets through."""
        m = valid[None, :].expand(len(q_pos), len(k_pos))
        if causal:
            m = m & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            m = m & (k_pos[None, :] > q_pos[:, None] - window)
        return m

    decode_dense_cases = [
        # (case, C, written, q_pos, window, causal)
        ("main: B=4, C=124 at 116", 124, 117, 116, None, True),
        ("edge: ring wrapped at 139", 124, 140, 139, None, True),
        ("edge: C=37, empty slots", 37, 20, 19, None, True),
        ("edge: window 5, wrapped", 37, 50, 49, 5, True),
        ("edge: bidirectional", 37, 30, 10, None, False),
        ("edge: fully masked query", 37, 37, 80, 3, True),
    ]
    for i, (case, c, written, q_pos, window, causal) in enumerate(
            decode_dense_cases):
        q = t(rng.standard_normal((4, 1, 12, 128), np.float32))
        kc = t(rng.standard_normal((4, c, 2, 128), np.float32))
        vc = t(rng.standard_normal((4, c, 2, 128), np.float32))
        pos = ring_pos(c, written)
        kw = dict(q_pos=q_pos, window=window, causal=causal)
        got = kdec.decode_attention_cuda(q, kc, vc, pos, **kw)
        want = ref.decode_attention_ref(q, kc, vc, pos, **kw)
        timing = None
        if i == 0:
            vis = visible(torch.full((1,), q_pos, device=dev), pos.long(),
                          causal, window, pos >= 0)
            nb, fl, work = dense_bound(q, kc, vis)
            nb += c * 4                                   # slot positions
            bms, by = bound(nb, fl)
            timing = {"work": work,
                "ms": timer(lambda: kdec.decode_attention_cuda(
                    q, kc, vc, pos, **kw)),
                "plain_ms": timer(lambda: ref.decode_attention_ref(
                    q, kc, vc, pos, **kw)),
                "library_ms": timer(lambda: sdpa_dense(q, kc, vc, vis)),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("decode_attention", case, (got - want).abs().max().item(),
               ATT_TOL, timing)
        if i == 0:
            decode_main = (q, kc, vc, pos, kw, got)
    # the main shape again: q_pos in a device tensor (bit for bit the int's
    # result), repeats bit for bit, and a CUDA graph of the launch replayed
    # after the position, the ring's slot positions and q are overwritten
    xrng = np.random.default_rng(19)     # the other cases keep their draws
    q, kc, vc, pos, kw, got = decode_main
    qp = torch.tensor(kw["q_pos"], dtype=torch.int32, device=dev)
    need(torch.equal(kdec.decode_attention_cuda(q, kc, vc, pos, q_pos=qp),
                     got) and torch.equal(kdec.decode_attention_cuda(
                         q, kc, vc, pos, **kw), got),
         "decode_attention: q_pos as a tensor or a repeat changed the bits")
    q, pos = q.clone(), pos.clone()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kdec.decode_attention_cuda(q, kc, vc, pos, q_pos=qp)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        gout = kdec.decode_attention_cuda(q, kc, vc, pos, q_pos=qp)
    err = 0.0
    for written in (130, 140):
        q.copy_(t(xrng.standard_normal(q.shape, np.float32)))
        pos.copy_(ring_pos(124, written))
        qp.fill_(written - 1)
        graph.replay()
        err = max(err, (gout - ref.decode_attention_ref(
            q, kc, vc, pos, q_pos=written - 1)).abs().max().item())
    record("decode_attention", "graph replay, q_pos in memory", err,
           ATT_TOL)
    # 16 query heads over one KV head at head dim 256 (the kernel's limits)
    for case, written, q_pos, window in [("limits: G=16, Dh 256", 100, 99,
                                          None),
                                         ("limits: G=16, Dh 256, blind", 90,
                                          200, 3)]:
        q = t(xrng.standard_normal((2, 1, 16, 256), np.float32))
        kc = t(xrng.standard_normal((2, 90, 1, 256), np.float32))
        vc = t(xrng.standard_normal((2, 90, 1, 256), np.float32))
        pos = ring_pos(90, written)
        kw = dict(q_pos=q_pos, window=window)
        got = kdec.decode_attention_cuda(q, kc, vc, pos, **kw)
        need(torch.equal(kdec.decode_attention_cuda(q, kc, vc, pos, **kw),
                         got), "decode_attention: a repeat changed the bits")
        record("decode_attention", case, (got - ref.decode_attention_ref(
            q, kc, vc, pos, **kw)).abs().max().item(), ATT_TOL)

    # -- flash attention over fresh K/V --------------------------------------
    flash_cases = [
        # (case, Lq, Lk, kwargs)
        ("main: B=4, causal L=116", 116, 116, {}),
        ("edge: L=37 ragged", 37, 37, {}),
        ("edge: window 32", 116, 116, dict(window=32)),
        ("edge: bidirectional softcap 30", 40, 40,
         dict(causal=False, logit_softcap=30.0)),
        ("edge: q_offset 28, Lq 9 < Lk 37", 9, 37, dict(q_offset=28)),
        ("edge: fully masked queries", 9, 37, dict(q_offset=36, window=3)),
    ]
    for i, (case, lq, lk, kw) in enumerate(flash_cases):
        q = t(rng.standard_normal((4, lq, 12, 128), np.float32))
        k = t(rng.standard_normal((4, lk, 2, 128), np.float32))
        v = t(rng.standard_normal((4, lk, 2, 128), np.float32))
        got = kfl.flash_attention_cuda(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        timing = None
        if i == 0:
            vis = visible(torch.arange(lq, device=dev),
                          torch.arange(lk, device=dev), True, None,
                          torch.ones(lk, dtype=torch.bool, device=dev))
            nb, fl, work = dense_bound(q, k, vis)
            bms, by = bound(nb, fl)
            timing = {"work": work,
                "ms": timer(lambda: kfl.flash_attention_cuda(q, k, v, **kw)),
                "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v,
                                                                  **kw)),
                "library_ms": timer(lambda: sdpa_dense(q, k, v, vis)),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("flash_attention", case, (got - want).abs().max().item(),
               ATT_TOL, timing)

    # -- whisper-small's attention shapes (phase 7), timed beside the main
    # rows: MHA at head_dim 64, bidirectional over 1500 frames
    wrng = np.random.default_rng(17)     # the other cases keep their draws

    def wr(*shape, s=1.0):
        return t((wrng.standard_normal(shape) * s).astype(np.float32))
    every = torch.ones(1500, dtype=torch.bool, device=dev)
    for case, lq in [("whisper enc: L=1500 bidir.", 1500),
                     ("whisper cross: Lq 100 x 1500", 100)]:
        q, k, v = wr(4, lq, 12, 64), wr(4, 1500, 12, 64), wr(4, 1500, 12, 64)
        got = kfl.flash_attention_cuda(q, k, v, causal=False)
        want = ref.flash_attention_ref(q, k, v, causal=False)
        vis = every[None].expand(lq, 1500)
        nb, fl, work = dense_bound(q, k, vis)
        bms, by = bound(nb, fl)
        timing = {"work": work,
            "ms": timer(lambda: kfl.flash_attention_cuda(q, k, v,
                                                         causal=False)),
            "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v,
                                                              causal=False)),
            "library_ms": timer(lambda: sdpa_dense(q, k, v, vis)),
            "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("flash_attention", case, (got - want).abs().max().item(),
               ATT_TOL, timing)
    # gemma-2b's heads (8 over 1 KV head, head_dim 256), a causal prefill
    q, k, v = wr(4, 116, 8, 256), wr(4, 116, 1, 256), wr(4, 116, 1, 256)
    got = kfl.flash_attention_cuda(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    vis = visible(torch.arange(116, device=dev), torch.arange(116, device=dev),
                  True, None, torch.ones(116, dtype=torch.bool, device=dev))
    nb, fl, work = dense_bound(q, k, vis)
    bms, by = bound(nb, fl)
    timing = {"work": work,
        "ms": timer(lambda: kfl.flash_attention_cuda(q, k, v)),
        "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v)),
        "library_ms": timer(lambda: sdpa_dense(q, k, v, vis)),
        "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
    record("flash_attention", "gemma heads: Dh 256, 8 over 1",
           (got - want).abs().max().item(), ATT_TOL, timing)
    q, kc, vc = wr(4, 1, 12, 64), wr(4, 1500, 12, 64), wr(4, 1500, 12, 64)
    frames = torch.arange(1500, dtype=torch.int32, device=dev)
    kw = dict(q_pos=0, causal=False)
    got = kdec.decode_attention_cuda(q, kc, vc, frames, **kw)
    want = ref.decode_attention_ref(q, kc, vc, frames, **kw)
    need(torch.equal(kdec.decode_attention_cuda(q, kc, vc, frames, **kw),
                     got), "decode_attention: a repeat changed the bits")
    nb, fl, work = dense_bound(q, kc, every[None])
    nb += 1500 * 4                                        # slot positions
    bms, by = bound(nb, fl)
    timing = {"work": work,
        "ms": timer(lambda: kdec.decode_attention_cuda(q, kc, vc, frames,
                                                       **kw)),
        "plain_ms": timer(lambda: ref.decode_attention_ref(q, kc, vc, frames,
                                                           **kw)),
        "library_ms": timer(lambda: sdpa_dense(q, kc, vc, every[None])),
        "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
    record("decode_attention", "whisper cross: C=1500 bidir.",
           (got - want).abs().max().item(), ATT_TOL, timing)

    # -- fused demux exit with the LN entry (rwkv6-7b's final norm) --------
    d, f, n = 4096, 8192, 2
    w = (r(n, d), r(d, f, s=0.02), r(d, f, s=0.02), r(f, s=0.02),
         r(f, d, s=0.02), r(d, s=0.02))
    norms = {"entry_kind": "ln", "entry_scale": 1.0 + r(d, s=0.1),
             "entry_bias": r(d, s=0.1), "exit_scale": 1.0 + r(d, s=0.1),
             "exit_bias": r(d, s=0.1)}
    for i, (case, tt) in enumerate([("main: decode T=4", 4),
                                    ("edge: T=5", 5),
                                    ("chunk T=32", 32)]):
        h = r(tt, d) + 2.0                 # a residual stream with an offset
        got = kd.demux_rsa_cuda(h, *w, **norms)
        want = ref.demux_rsa_fused_ref(h, *w, **norms)
        timing = None
        if i != 1:
            nb = (2 * d * f + tt * d + n * d + d * f + f + 5 * d) * 4 \
                + n * tt * d * 4
            fl = 2 * tt * d * f + 2 * n * tt * f * d + 2 * n * d * f
            bms, by = bound(nb, fl)

            def library():
                hn = F.layer_norm(h, (d,), norms["entry_scale"],
                                  norms["entry_bias"], eps=1e-6)
                z = F.gelu(torch.matmul(hn, w[1])[None]
                           + (w[0] @ w[2] + w[3])[:, None],
                           approximate="tanh")
                return F.layer_norm(torch.matmul(z, w[4]) + w[5], (d,),
                                    norms["exit_scale"], norms["exit_bias"],
                                    eps=1e-6)
            timing = {
                "ms": timer(lambda: kd.demux_rsa_cuda(h, *w, **norms)),
                "plain_ms": timer(lambda: ref.demux_rsa_fused_ref(h, *w,
                                                                  **norms)),
                "library_ms": timer(library),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("demux_rsa[ln]", case, (got - want).abs().max().item(),
               DEMUX_TOL, timing)
    # whisper-small's exit (phase 7): d 768, F 1536, T=4 decode rows;
    # ``library`` above reads these tensors when it is called
    d, f, n = 768, 1536, 2
    w = (wr(n, d), wr(d, f, s=0.02), wr(d, f, s=0.02), wr(f, s=0.02),
         wr(f, d, s=0.02), wr(d, s=0.02))
    norms = {"entry_kind": "ln", "entry_scale": 1.0 + wr(d, s=0.1),
             "entry_bias": wr(d, s=0.1), "exit_scale": 1.0 + wr(d, s=0.1),
             "exit_bias": wr(d, s=0.1)}
    h = wr(4, d) + 2.0
    got = kd.demux_rsa_cuda(h, *w, **norms)
    want = ref.demux_rsa_fused_ref(h, *w, **norms)
    nb = (2 * d * f + 4 * d + n * d + d * f + f + 5 * d) * 4 + n * 4 * d * 4
    fl = 2 * 4 * d * f + 2 * n * 4 * f * d + 2 * n * d * f
    bms, by = bound(nb, fl)
    timing = {
        "ms": timer(lambda: kd.demux_rsa_cuda(h, *w, **norms)),
        "plain_ms": timer(lambda: ref.demux_rsa_fused_ref(h, *w, **norms)),
        "library_ms": timer(library),
        "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
    record("demux_rsa[ln]", "whisper: d 768, T=4", (got - want).abs().max()
           .item(), DEMUX_TOL, timing)

    # -- the RWKV6 recurrence ---------------------------------------------
    from repro_torch.kernels import rwkv6 as krw

    def rwkv_inputs(b, l, h, hd, logw=None):
        """As the reference suite draws them (tests/test_kernels.py
        test_rwkv6): logw = -exp(0.5 z), about -1.1 a token, or fixed."""
        shape = (b, l, h, hd)
        lw = (-torch.exp(r(*shape, s=0.5)) if logw is None
              else torch.full(shape, logw, device=dev))
        return (r(*shape), r(*shape, s=0.5), r(*shape), lw, r(h, hd, s=0.1),
                r(b, h, hd, hd, s=0.1))

    def rwkv_err(got, want):
        """Max abs error over (out, sT), and the largest share of the
        elementwise tolerance atol + rtol * |want| it uses."""
        err = share = 0.0
        for g, w_ in zip(got, want):
            diff = (g - w_).abs()
            err = max(err, diff.max().item())
            tol = RWKV_TOL["atol"] + RWKV_TOL["rtol"] * w_.abs()
            share = max(share, (diff / tol).max().item())
        return err, share

    rwkv_cases = [
        # (case, B, L, H, hd, chunk of the plain version, logw)
        ("main: decode L=1", 4, 1, 64, 64, 1, None),
        ("main: prefill L=100", 4, 100, 64, 64, 100, None),
        ("main: prefill L=109", 4, 109, 64, 64, 109, None),
        ("main: L=128 chunks of 32", 4, 128, 64, 64, 32, None),
        ("edge: L=7", 4, 7, 64, 64, 7, None),
        ("edge: L=300 chunks of 100", 2, 300, 64, 64, 100, None),
        ("edge: hd=16", 4, 100, 256, 16, 100, None),
        ("edge: hd=32", 4, 100, 128, 32, 100, None),
        ("edge: hd=128", 4, 100, 32, 128, 100, None),
        ("edge: strong decay -5", 4, 100, 64, 64, 100, -5.0),
        ("edge: weak decay -1e-3", 4, 100, 64, 64, 100, -1e-3),
    ]
    for i, (case, b, l, h, hd, chunk, logw) in enumerate(rwkv_cases):
        a = rwkv_inputs(b, l, h, hd, logw)
        got = krw.rwkv6_cuda(*a)
        again = krw.rwkv6_cuda(*a)
        need(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
             f"rwkv6_chunked [{case}]: a repeat changed the bits")
        err, share = rwkv_err(got, krw.rwkv_chunked(*a, chunk))
        err_o, share_o = rwkv_err(got, krw.rwkv6_ref(*a))
        print(f"  {'rwkv6_chunked':<24} {case:<30} vs sequential oracle: "
              f"max_abs_err {err_o:.3e} ({share_o:.3f} of {RWKV_TOL_TEXT})",
              flush=True)
        need(share_o <= 1.0, f"rwkv6_chunked [{case}] disagrees with the "
             "sequential oracle")
        timing = None
        if i < 2:          # decode (the JSON's) and a 100-token prefill
            nb = (5 * b * l * h * hd + h * hd + 2 * b * h * hd * hd) * 4
            fl = b * l * h * (5 * hd * hd + 5 * hd)
            bms, by = bound(nb, fl)
            timing = {
                "ms": timer(lambda: krw.rwkv6_cuda(*a)),
                "plain_ms": timer(lambda: krw.rwkv_chunked(*a, chunk)),
                "library_ms": None,     # no single PyTorch call computes it
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("rwkv6_chunked", case, err, RWKV_TOL_TEXT, timing,
               share=share)
    # two halves chained through the state equal one pass
    a = rwkv_inputs(4, 100, 64, 64)
    whole = krw.rwkv6_cuda(*a)
    o1, s1 = krw.rwkv6_cuda(*(x[:, :50] for x in a[:4]), a[4], a[5])
    o2, s2 = krw.rwkv6_cuda(*(x[:, 50:] for x in a[:4]), a[4], s1)
    err = max((torch.cat([o1, o2], 1) - whole[0]).abs().max().item(),
              (s2 - whole[1]).abs().max().item())
    print(f"  {'rwkv6_chunked':<24} {'edge: halves chained by sT':<30} "
          f"max_abs_err {err:.3e} against one pass (tol 1e-4)", flush=True)
    need(err <= 1e-4, "rwkv6_chunked: chained halves differ from one pass")

    # -- the paged kernels over bf16, int8 and fp8 pages -------------------
    from repro_torch.core import quant as tq

    def store(kind, k, v):
        """fp32 pages stored as the pool stores them at ``kind``."""
        if kind == "bf16":
            return k.bfloat16(), v.bfloat16(), {}
        kq, ks = tq.quantize_kv(k, kind)
        vq, vs = tq.quantize_kv(v, kind)
        return kq, vq, {"k_scales": ks, "v_scales": vs}

    def storage_bound(q, kind, k, v, sc):
        """Analytic bound on |attention over the stored pages - attention
        over the pristine fp32 pages|: core.quant's for int8 / fp8, its
        relative-rounding analogue for bf16 (tests/test_paged_attention.py
        ``_storage_bound``)."""
        if kind != "bf16":
            return tq.paged_attention_error_bound(
                q, sc["k_scales"], sc["v_scales"], kind).item()
        q_l1 = q.abs().sum(-1).max().item()
        e_k = BF16_REL * k.abs().max().item()
        v_max = v.abs().max().item()
        e_v = BF16_REL * v_max
        return 2.0 * q_l1 * e_k * q.shape[-1] ** -0.5 * (v_max + e_v) + e_v

    def oracle(name, kind, case, err, bnd):
        print(f"  {name:<24} {case:<30} vs pristine fp32: max_abs_err "
              f"{err:.3e} (analytic bound {bnd:.3e})", flush=True)
        need(err <= bnd, f"{name} [{case}] exceeds its analytic bound "
             f"against the fp32 oracle: {err} > {bnd}")

    for kind in KINDS[1:]:
        name = f"paged_attention[{kind}]"
        for i in (0, 1):                  # main rows; -1 entries + inactive
            case, lens, qpos, mb, p = decode_cases[i]
            k_p, v_p, bt, pp = pool(lens, P=p, MB=mb)
            q = t(rng.standard_normal((len(lens), 1, 12, 128), np.float32))
            qp = t(np.asarray(qpos, np.int32))
            kq, vq, sc = store(kind, k_p, v_p)

            def kernel():
                return kp.paged_attention_cuda(q, kq, vq, bt, pp, qp, **sc)

            def plain():
                if sc:
                    return ref.paged_attention_quant_ref(
                        q, kq, vq, sc["k_scales"], sc["v_scales"], bt, pp,
                        qp)
                return ref.paged_attention_ref(q, kq, vq, bt, pp, qp)
            got = kernel()
            err = (got - plain()).abs().max().item()
            act = qp >= 0
            pristine = ref.paged_attention_ref(q, k_p, v_p, bt, pp, qp)
            oracle(name, kind, case, (got - pristine)[act].abs().max().item(),
                   storage_bound(q[act], kind, k_p, v_p, sc) + ATT_TOL)
            timing = None
            if i == 0:
                nb, fl, work = attn_bytes_flops(
                    q, bt, pp, qp[:, None], 2, 128, elem=kq.element_size(),
                    scaled=bool(sc))
                bms, by = bound(nb, fl)
                timing = {"work": work, "ms": timer(kernel),
                          "plain_ms": timer(plain),
                          "library_ms": timer(lambda: sdpa(
                              q, kq, vq, bt, pp, qp[:, None], **sc)),
                          "bound_ms": bms, "bound_by": by, "bytes": nb,
                          "flops": fl}
            record(name, case, err, ATT_TOL, timing)

        name = f"paged_prefill_attention[{kind}]"
        for i in (0, 3):                  # chunk 32 at 64; padded + inactive
            case, lens, qs, ql, lq, mb, p = prefill_cases[i]
            k_p, v_p, bt, pp = pool(lens, P=p, MB=mb)
            q = t(rng.standard_normal((len(lens), lq, 12, 128), np.float32))
            qs_t, ql_t = t(np.asarray(qs, np.int32)), t(np.asarray(ql,
                                                                 np.int32))
            kq, vq, sc = store(kind, k_p, v_p)

            def kernel():
                return kp.paged_prefill_attention_cuda(
                    q, kq, vq, bt, pp, qs_t, ql_t, **sc)

            def plain():
                if sc:
                    return ref.paged_prefill_attention_quant_ref(
                        q, kq, vq, sc["k_scales"], sc["v_scales"], bt, pp,
                        qs_t, ql_t)
                return ref.paged_prefill_attention_ref(q, kq, vq, bt, pp,
                                                       qs_t, ql_t)
            got = kernel()
            err = (got - plain()).abs().max().item()
            li = torch.arange(lq, device=dev)[None]
            qrows = qs_t[:, None] + li
            masked = (li >= ql_t[:, None]) | (qs_t[:, None] < 0)
            pristine = ref.paged_prefill_attention_ref(q, k_p, v_p, bt, pp,
                                                       qs_t, ql_t)
            oracle(name, kind, case,
                   (got - pristine)[~masked].abs().max().item(),
                   storage_bound(q[~masked], kind, k_p, v_p, sc) + ATT_TOL)
            timing = None
            if i == 0:
                nb, fl, work = attn_bytes_flops(
                    q, bt, pp, torch.where(masked, -1, qrows), 2, 128,
                    elem=kq.element_size(), scaled=bool(sc))
                bms, by = bound(nb, fl)
                timing = {"work": work, "ms": timer(kernel),
                          "plain_ms": timer(plain),
                          "library_ms": timer(lambda: sdpa(
                              q, kq, vq, bt, pp, qrows, **sc)),
                          "bound_ms": bms, "bound_by": by, "bytes": nb,
                          "flops": fl}
            record(name, case, err, ATT_TOL, timing)

    # -- phase 9's shapes, each its own row (``DENSE_ROWS``), the shapes
    # read from the configs: h2o-danube-1.8b's heads (head_dim 80 in the
    # 128 instantiation, 32 over 8) over its long request, whose window
    # cuts the context (a decode row at its last position and a 32-token
    # chunk past the window), over the four page storages; gemma-7b's (MHA
    # at head_dim 256) at phase 4's decode rows and chunk
    from repro_torch.configs import get_config
    h2o, g7 = get_config("h2o-danube-1.8b"), get_config("gemma-7b")
    ctx = LONG_PROMPT + LONG_NEW - 1          # the long row's last decode
    mb_long = -(-(LONG_PROMPT + LONG_NEW + 8) // 16)
    chunk0 = (LONG_PROMPT - 1) // 32 * 32 - 32    # a full chunk past it
    paged_rows = [
        # (tag, cfg, storages, decode (lens, q_pos, MB),
        #  chunk (lens, q_start, q_len, MB))
        ("h2o", h2o, KINDS, ([ctx], [ctx - 1], mb_long),
         ([chunk0 + 32], [chunk0], [32], mb_long)),
        ("gemma-7b", g7, ("fp32",), ([117, 108, 101, 100],
                                     [116, 107, 100, 99], 8),
         ([96], [64], [32], 8)),
    ]
    for tag, cfg, kinds, (lens, qpos, mb), (clens, qs, ql, cmb) in \
            paged_rows:
        h, hkv, dh, window = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              cfg.window)
        for kind in kinds:
            sfx = "" if kind == "fp32" else f", {kind}"
            for wrapper, (ls, (args, lq, rows_mb)) in (
                    ("paged_attention", (lens, (qpos, 1, mb))),
                    ("paged_prefill_attention", (clens, ((qs, ql), 32,
                                                         cmb)))):
                k_p, v_p, bt, pp = pool(ls, P=sum(-(-n // 16) for n in ls)
                                        + 1, MB=rows_mb, hkv=hkv, dh=dh)
                q = t(rng.standard_normal((len(ls), lq, h, dh), np.float32))
                kq, vq, sc = (k_p, v_p, {}) if kind == "fp32" else store(
                    kind, k_p, v_p)
                if wrapper == "paged_attention":
                    qp = t(np.asarray(args, np.int32))
                    vecs = (qp,)
                    qrows = qp[:, None]
                    masked = qp[:, None] < 0
                    cuda_fn, plain_ref = (kp.paged_attention_cuda,
                                          ref.paged_attention_ref)
                    quant_ref = ref.paged_attention_quant_ref
                else:
                    qs_t, ql_t = (t(np.asarray(x, np.int32)) for x in args)
                    vecs = (qs_t, ql_t)
                    li = torch.arange(lq, device=dev)[None]
                    qrows = qs_t[:, None] + li
                    masked = (li >= ql_t[:, None]) | (qs_t[:, None] < 0)
                    cuda_fn, plain_ref = (kp.paged_prefill_attention_cuda,
                                          ref.paged_prefill_attention_ref)
                    quant_ref = ref.paged_prefill_attention_quant_ref

                def kernel():
                    return cuda_fn(q, kq, vq, bt, pp, *vecs, window=window,
                                   **sc)

                def plain():
                    if sc:
                        return quant_ref(q, kq, vq, sc["k_scales"],
                                         sc["v_scales"], bt, pp, *vecs,
                                         window=window)
                    return plain_ref(q, kq, vq, bt, pp, *vecs,
                                     window=window)
                got = kernel()
                err = (got - plain()).abs().max().item()
                name = f"{wrapper}[{tag}{sfx}]"
                case = (f"{tag}: {h} over {hkv} of {dh}, window {window}, "
                        f"MB {rows_mb}")
                if sc or kind == "bf16":
                    pristine = plain_ref(q, k_p, v_p, bt, pp, *vecs,
                                         window=window)
                    oracle(name, kind, case, (got - pristine)[~masked].abs()
                           .max().item(), storage_bound(
                               q[~masked], kind, k_p, v_p, sc) + ATT_TOL)
                nb, fl, work = attn_bytes_flops(
                    q, bt, pp, torch.where(masked, -1, qrows), hkv, dh,
                    elem=kq.element_size(), scaled=bool(sc), window=window)
                bms, by = bound(nb, fl)
                timing = {"work": work, "ms": timer(kernel),
                          "plain_ms": timer(plain),
                          "library_ms": timer(lambda: sdpa(
                              q, kq, vq, bt, pp, qrows, window=window,
                              **sc)),
                          "bound_ms": bms, "bound_by": by, "bytes": nb,
                          "flops": fl}
                record(name, case, err, ATT_TOL, timing)
    del k_p, v_p, kq, vq

    # gemma-7b's fused entry (vocab 256000, d 3072, scaled by sqrt(d)) at
    # a decode step and a chunk, and its fused exit (RMS entry, d 3072, F
    # 6144) at both
    d, vocab = g7.d_model, g7.vocab_size
    scale = d ** 0.5
    emb = t(rng.standard_normal((vocab, d), np.float32) * 0.02)
    v = t(rng.standard_normal((2, d), np.float32))
    for tt in (4, 32):
        tok = t(rng.integers(0, vocab, (2, tt)).astype(np.int32))
        tl = tok.long()
        got = km.mux_embed_combine_cuda(tok, emb, v, scale=scale)
        nb = embed_bytes(tok, d, 4)
        bms, by = bound(nb, 3 * 2 * tt * d)
        timing = {
            "ms": timer(lambda: km.mux_embed_combine_cuda(tok, emb, v,
                                                          scale=scale)),
            "plain_ms": timer(lambda: ref.mux_embed_ref(tok, emb, v,
                                                        scale=scale)),
            "library_ms": timer(lambda: torch.einsum(
                "ntd,nd->td", F.embedding(tl, emb) * scale, v) * 0.5),
            "bound_ms": bms, "bound_by": by, "bytes": nb,
            "flops": 3 * 2 * tt * d,
            "work": f"{tok.unique().numel()} distinct table rows of "
                    f"{tok.numel()} gathers"}
        record("mux_embed_combine[gemma-7b]", f"gemma-7b: T={tt} V {vocab} "
               f"d {d}", (got - ref.mux_embed_ref(tok, emb, v, scale=scale))
               .abs().max().item(), MUX_TOL, timing)
    del emb
    f, n = 2 * d, 2
    w = (r(n, d), r(d, f, s=0.02), r(d, f, s=0.02), r(f, s=0.02),
         r(f, d, s=0.02), r(d, s=0.02))
    norms = {"entry_kind": "rms", "entry_scale": r(d, s=0.1),
             "exit_scale": 1.0 + r(d, s=0.1), "exit_bias": r(d, s=0.1)}
    for tt in (4, 32):
        h = r(tt, d)
        got = kd.demux_rsa_cuda(h, *w, **norms)
        want = ref.demux_rsa_fused_ref(h, *w, **norms)
        nb = (2 * d * f + tt * d + n * d + d * f + f + 4 * d) * 4 \
            + n * tt * d * 4
        fl = 2 * tt * d * f + 2 * n * tt * f * d + 2 * n * d * f
        bms, by = bound(nb, fl)

        def library():
            hn = h * torch.rsqrt(h.square().mean(-1, keepdim=True) + 1e-6)
            hn = hn * (1 + norms["entry_scale"])
            z = F.gelu(torch.matmul(hn, w[1])[None]
                       + (w[0] @ w[2] + w[3])[:, None], approximate="tanh")
            return F.layer_norm(torch.matmul(z, w[4]) + w[5], (d,),
                                norms["exit_scale"], norms["exit_bias"],
                                eps=1e-6)
        timing = {
            "ms": timer(lambda: kd.demux_rsa_cuda(h, *w, **norms)),
            "plain_ms": timer(lambda: ref.demux_rsa_fused_ref(h, *w,
                                                              **norms)),
            "library_ms": timer(library),
            "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}
        record("demux_rsa[gemma-7b]", f"gemma-7b: T={tt} d {d} F {f}",
               (got - want).abs().max().item(), DEMUX_TOL, timing)
    del w

    bf16_kernels(torch, timer, record, pool, sdpa, store, ring_pos, visible,
                 decode_cases[0], prefill_cases[0])
    bf16_rest_kernels(torch, timer, record, visible)
    bert_kernels(torch, timer, record)
    moe_kernels(torch, timer, record, pool, sdpa, store, decode_cases[0],
                prefill_cases[0])
    hybrid_kernels(torch, timer, record, ring_pos, visible)
    llava_kernels(torch, timer, record, ring_pos, visible)
    torch.cuda.synchronize()
    return out


def bf16_share(got, want, ulps):
    """(max |got - want|, the largest share of the bf16 tolerance used):
    both bf16, within ``ulps`` bf16 ulps of each row's largest |want|."""
    import torch
    need(got.dtype == want.dtype == torch.bfloat16,
         f"bf16 outputs expected, got {got.dtype} / {want.dtype}")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = ulps * BF16_ULP * w.abs().amax(-1, keepdim=True)
    return err.max().item(), (err / tol.clamp(min=1e-30)).max().item()


# phase 3's bf16 rows, by phase 10's architecture: the name's tag and the
# page storages its paged rows cover (those phase 10 serves it on)
BF16_SHAPES = (("qwen2-1.5b", "", KINDS[1:]), ("gemma-2b", "gemma-2b, ",
                                              ("bf16",)))


def bf16_kernels(torch, timer, record, pool, sdpa, store, ring_pos, visible,
                 decode_case, prefill_case):
    """Phase 3's bf16 rows (the reference's compute dtype) at phase 10's
    shapes, read from the configs: qwen2-1.5b's heads (12 over 2 of 128)
    and gemma-2b's (8 over 1 of 256) with a bf16 q in the paged kernels
    at phase 4's decode rows and 32-token chunk (qwen2-1.5b over bf16,
    int8 and fp8 pages, gemma-2b over bf16 pages), the ring decode at B 4,
    C 124 and the demux exit with the RMS entry at d_model and F = 2 *
    d_model for T 4 and 32, each against its plain version (widened to
    fp32, rounded where the Pallas kernel rounds) within one bf16 ulp of
    each row's largest value (two for the demux, whose later sums move
    when an earlier one rounds the other way), and timed beside the
    library call in bf16.  The bounds price the products whose operands
    are all exact in bf16 (QK^T of a bf16 q over bf16, int8 or fp8 K; the
    demux's k @ W1k) at the bf16 tensor-core rate and the rest (P.V with
    an fp32 P, the demux's products of fp32 activations) at the fp32-exact
    one."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import demux_rsa as kd
    from repro_torch.kernels import paged_attention as kp
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rng = np.random.default_rng(29)     # phase 3's other rows keep theirs

    def t(x):
        return torch.as_tensor(x, device=dev)

    def bq(*shape):
        return t(rng.standard_normal(shape, np.float32)).to(bf)

    def r(*shape, s=1.0):
        return t((rng.standard_normal(shape) * s).astype(np.float32))

    case, lens, qpos, mb, p = decode_case
    pcase, plens, qs, ql, lq, pmb, pp_ = prefill_case
    for arch, tag, kinds in BF16_SHAPES:
        cfg = get_config(arch)
        h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        heads = f"{arch}: {h} over {hkv} of {dh}"
        for kind in kinds:
            k_p, v_p, bt, pp = pool(lens, P=p, MB=mb, hkv=hkv, dh=dh)
            kq, vq, sc = store(kind, k_p, v_p)
            q = bq(len(lens), 1, h, dh)
            qp = t(np.asarray(qpos, np.int32))

            def kernel():
                return kp.paged_attention_cuda(q, kq, vq, bt, pp, qp, **sc)

            def plain():
                if sc:
                    return ref.paged_attention_quant_ref(
                        q, kq, vq, sc["k_scales"], sc["v_scales"], bt, pp,
                        qp)
                return ref.paged_attention_ref(q, kq, vq, bt, pp, qp)
            err, share = bf16_share(kernel(), plain(), 1)
            nb, fl, work = attn_bytes_flops(q, bt, pp, qp[:, None], hkv, dh,
                                            elem=kq.element_size(),
                                            scaled=bool(sc))
            bms, by = bound(nb, fl // 2, fl // 2)
            record(f"paged_attention[{tag}bf16 q, {kind}]",
                   f"{case}; {heads}", err, "1 bf16 ulp of the row max", {
                       "work": work, "ms": timer(kernel),
                       "plain_ms": timer(plain),
                       "library_ms": timer(lambda: sdpa(q, kq, vq, bt, pp,
                                                        qp[:, None], **sc)),
                       "bound_ms": bms, "bound_by": by, "bytes": nb,
                       "flops": fl}, share=share)

            k_p, v_p, bt, pp = pool(plens, P=pp_, MB=pmb, hkv=hkv, dh=dh)
            kq, vq, sc = store(kind, k_p, v_p)
            q = bq(len(plens), lq, h, dh)
            qs_t = t(np.asarray(qs, np.int32))
            ql_t = t(np.asarray(ql, np.int32))

            def kernel():
                return kp.paged_prefill_attention_cuda(q, kq, vq, bt, pp,
                                                       qs_t, ql_t, **sc)

            def plain():
                if sc:
                    return ref.paged_prefill_attention_quant_ref(
                        q, kq, vq, sc["k_scales"], sc["v_scales"], bt, pp,
                        qs_t, ql_t)
                return ref.paged_prefill_attention_ref(q, kq, vq, bt, pp,
                                                       qs_t, ql_t)
            err, share = bf16_share(kernel(), plain(), 1)
            li = torch.arange(lq, device=dev)[None]
            qrows = qs_t[:, None] + li
            masked = (li >= ql_t[:, None]) | (qs_t[:, None] < 0)
            nb, fl, work = attn_bytes_flops(
                q, bt, pp, torch.where(masked, -1, qrows), hkv, dh,
                elem=kq.element_size(), scaled=bool(sc))
            bms, by = bound(nb, fl // 2, fl // 2)
            record(f"paged_prefill_attention[{tag}bf16 q, {kind}]",
                   f"{pcase}; {heads}", err, "1 bf16 ulp of the row max", {
                       "work": work, "ms": timer(kernel),
                       "plain_ms": timer(plain),
                       "library_ms": timer(lambda: sdpa(q, kq, vq, bt, pp,
                                                        qrows, **sc)),
                       "bound_ms": bms, "bound_by": by, "bytes": nb,
                       "flops": fl}, share=share)

        # the ring decode: q, K, V and the output in bf16
        c, written, q_pos = 124, 117, 116
        q, kc, vc = bq(4, 1, h, dh), bq(4, c, hkv, dh), bq(4, c, hkv, dh)
        pos = ring_pos(c, written)
        kw = dict(q_pos=q_pos)
        got = kdec.decode_attention_cuda(q, kc, vc, pos, **kw)
        err, share = bf16_share(got, ref.decode_attention_ref(
            q, kc, vc, pos, **kw), 1)
        need(torch.equal(kdec.decode_attention_cuda(q, kc, vc, pos, **kw),
                         got),
             f"decode_attention[{tag}bf16]: a repeat changed the bits")
        vis = visible(torch.full((1,), q_pos, device=dev), pos.long(), True,
                      None, pos >= 0)
        nb, fl, work = dense_bound(q, kc, vis)
        nb += c * 4
        bms, by = bound(nb, fl // 2, fl // 2)
        record(f"decode_attention[{tag}bf16]",
               f"main: B=4, C=124 at 116; {heads}", err,
               "1 bf16 ulp of the row max", {
                   "work": work,
                   "ms": timer(lambda: kdec.decode_attention_cuda(
                       q, kc, vc, pos, **kw)),
                   "plain_ms": timer(lambda: ref.decode_attention_ref(
                       q, kc, vc, pos, **kw)),
                   "library_ms": timer(lambda: sdpa_dense(q, kc, vc, vis)),
                   "bound_ms": bms, "bound_by": by, "bytes": nb,
                   "flops": fl}, share=share)

        # the demux exit: h, keys, weights and output bf16, norm params fp32
        d, n = cfg.d_model, 2
        f = 2 * d                       # MuxSpec's default demux_hidden
        w = tuple(x.to(bf) for x in (r(n, d), r(d, f, s=0.02),
                                     r(d, f, s=0.02), r(f, s=0.02),
                                     r(f, d, s=0.02), r(d, s=0.02)))
        norms = {"entry_kind": "rms", "entry_scale": r(d, s=0.1),
                 "exit_scale": 1.0 + r(d, s=0.1), "exit_bias": r(d, s=0.1)}
        for dcase, tt in (("main: decode T=4", 4), ("main: chunk T=32", 32)):
            x = r(tt, d).to(bf)
            got = kd.demux_rsa_cuda(x, *w, **norms)
            err, share = bf16_share(got, ref.demux_rsa_fused_ref(
                x, *w, **norms), 2)
            need(torch.equal(kd.demux_rsa_cuda(x, *w, **norms), got),
                 f"demux_rsa[{tag}bf16]: a repeat changed the bits")
            nb = ((3 * d * f + f + d + n * d + tt * d + n * tt * d) * 2
                  + 3 * d * 4)
            fl = 2 * tt * d * f + 2 * n * tt * f * d      # fp32 activations
            bms, by = bound(nb, fl, 2 * n * d * f)        # + k @ W1k

            def library():
                hn = x.float() * torch.rsqrt(x.float().square().mean(
                    -1, keepdim=True) + 1e-6) * (1 + norms["entry_scale"])
                z = F.gelu(torch.matmul(hn.to(bf), w[1])[None]
                           + (w[0] @ w[2] + w[3])[:, None],
                           approximate="tanh")
                return F.layer_norm(torch.matmul(z, w[4]) + w[5], (d,),
                                    norms["exit_scale"].to(bf),
                                    norms["exit_bias"].to(bf), eps=1e-6)
            record(f"demux_rsa[{tag}bf16]", f"{dcase}; {arch}: d {d} F {f}",
                   err, "2 bf16 ulps of the row max", {
                       "ms": timer(lambda: kd.demux_rsa_cuda(x, *w,
                                                             **norms)),
                       "plain_ms": timer(lambda: ref.demux_rsa_fused_ref(
                           x, *w, **norms)),
                       "library_ms": timer(library),
                       "bound_ms": bms, "bound_by": by, "bytes": nb,
                       "flops": fl + 2 * n * d * f}, share=share)


def bf16_rest_kernels(torch, timer, record, visible):
    """Phase 3's bf16 rows of the flash and RWKV6 kernels and of the
    encdec, RWKV and MUX-BERT exits, at the shapes phases 6-8 serve in
    bf16 (``BF16_REST_ROWS``): ``flash_attention`` at whisper-small's
    encoder (bidirectional L 1500, 12 heads of 64) and cross-attention (Lq
    100 over 1500, whose keys split over blocks), qwen2-1.5b's causal L
    116, gemma-2b's heads (Dh 256, 8 over 1), h2o-danube-1.8b's (Dh 80, 32
    over 8, a window of 64 over L 300) and mux-bert-base's 80 rows of 128
    and of 130; ``rwkv6_chunked`` at rwkv6-7b's decode and a 100-token
    prefill (64 heads of 64), at head dims 16 and 128, and over two halves
    chained through the state; ``decode_attention`` at whisper's cross
    decode (C 1500, bidirectional); the demux with its LN entry at
    rwkv6-7b's, whisper-small's and mux-bert-base's exits.  Each against
    its plain version (widened to fp32, rounded where the Pallas kernel
    rounds) within one bf16 ulp of each row's largest value (the demux
    two; RWKV6's below), bit for bit over two
    calls, timed beside its plain version and the library call in bf16
    (RWKV6's bf16 ``out`` within ``RWKV_TOL`` plus that ulp: its fp32
    forms, chunkwise and per token, part within ``RWKV_TOL`` before each
    rounds).  The bounds price QK^T of bf16 operands at the bf16 tensor-core rate
    and P.V (an fp32 P) at the fp32-exact one; the recurrence runs on the
    CUDA cores in fp32."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import demux_rsa as kd
    from repro_torch.kernels import flash_attention as kfl
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6 as krw
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rng = np.random.default_rng(37)     # phase 3's other rows keep theirs

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s).astype(
            np.float32), device=dev)

    def bq(*shape):
        return r(*shape).to(bf)

    def timed(kernel, plain, library, nb, fl, bf16_fl=0, work=None):
        bms, by = bound(nb, fl, bf16_fl)
        return {**({"work": work} if work else {}), "ms": timer(kernel),
                "plain_ms": timer(plain), "library_ms": timer(library),
                "bound_ms": bms, "bound_by": by, "bytes": nb,
                "flops": fl + bf16_fl}

    wh, q2, g2, h2o = (get_config(a) for a in (
        "whisper-small", "qwen2-1.5b", "gemma-2b", "h2o-danube-1.8b"))
    bert = get_config("mux-bert-base")
    enc = wh.encoder
    flash_rows = [
        # (row, case, B, Lq, Lk, H, Hkv, Dh, kwargs)
        ("flash_attention[bf16]",
         f"main: whisper enc L={enc.frontend_len} bidir.", 4,
         enc.frontend_len, enc.frontend_len, enc.n_heads, enc.n_kv_heads,
         enc.head_dim, dict(causal=False)),
        ("flash_attention[bf16]",
         f"whisper cross: Lq 100 x {enc.frontend_len}, split", 4, 100,
         enc.frontend_len, wh.n_heads, wh.n_kv_heads, wh.head_dim,
         dict(causal=False)),
        ("flash_attention[bf16]", "qwen2-1.5b: causal L=116", 4, 116, 116,
         q2.n_heads, q2.n_kv_heads, q2.head_dim, {}),
        ("flash_attention[bf16]", "gemma-2b heads: Dh 256, 8 over 1", 4,
         116, 116, g2.n_heads, g2.n_kv_heads, g2.head_dim, {}),
        ("flash_attention[bf16]", "h2o heads: Dh 80, 32 over 8, window 64",
         2, 300, 300, h2o.n_heads, h2o.n_kv_heads, h2o.head_dim,
         dict(window=64)),
        ("flash_attention[bf16, bert]", "main: bert B=80, L=128 bidir.",
         BERT_INSTANCES // 2, BERT_LEN, BERT_LEN, bert.n_heads,
         bert.n_kv_heads, bert.head_dim, dict(causal=False)),
        ("flash_attention[bf16, bert]", "bert B=80, L=130 (prefix) bidir.",
         BERT_INSTANCES // 2, BERT_LEN + 2, BERT_LEN + 2, bert.n_heads,
         bert.n_kv_heads, bert.head_dim, dict(causal=False)),
    ]
    for row, case, b, lq, lk, h, hkv, dh, kw in flash_rows:
        q, k, v = bq(b, lq, h, dh), bq(b, lk, hkv, dh), bq(b, lk, hkv, dh)
        if "split" in case:
            need(kfl.splits(b, lq, lk, h, dh)[0] > 1,
                 f"{row} [{case}]: the keys do not split")
        got = kfl.flash_attention_cuda(q, k, v, **kw)
        need(torch.equal(kfl.flash_attention_cuda(q, k, v, **kw), got),
             f"{row} [{case}]: a repeat changed the bits")
        err, share = bf16_share(got, ref.flash_attention_ref(q, k, v, **kw),
                                1)
        vis = visible(torch.arange(lq, device=dev),
                      torch.arange(lk, device=dev), kw.get("causal", True),
                      kw.get("window"), torch.ones(lk, dtype=torch.bool,
                                                   device=dev))
        nb, fl, work = dense_bound(q, k, vis)
        record(row, f"{case}; {b} rows", err, "1 bf16 ulp of the row max",
               timed(lambda: kfl.flash_attention_cuda(q, k, v, **kw),
                     lambda: ref.flash_attention_ref(q, k, v, **kw),
                     lambda: sdpa_dense(q, k, v, vis), nb, fl // 2, fl // 2,
                     work), share=share)
    del q, k, v

    # the ring decode over whisper's cross-K/V: q, K, V and the output bf16
    q = bq(4, 1, wh.n_heads, wh.head_dim)
    kc, vc = (bq(4, enc.frontend_len, wh.n_kv_heads, wh.head_dim)
              for _ in range(2))
    frames = torch.arange(enc.frontend_len, dtype=torch.int32, device=dev)
    kw = dict(q_pos=0, causal=False)
    got = kdec.decode_attention_cuda(q, kc, vc, frames, **kw)
    need(torch.equal(kdec.decode_attention_cuda(q, kc, vc, frames, **kw),
                     got), "decode_attention[bf16, whisper]: a repeat "
         "changed the bits")
    err, share = bf16_share(got, ref.decode_attention_ref(q, kc, vc, frames,
                                                          **kw), 1)
    every = torch.ones(enc.frontend_len, dtype=torch.bool, device=dev)
    nb, fl, work = dense_bound(q, kc, every[None])
    nb += enc.frontend_len * 4                            # slot positions
    record("decode_attention[bf16, whisper]",
           f"main: cross C={enc.frontend_len} bidir.",
           err, "1 bf16 ulp of the row max",
           timed(lambda: kdec.decode_attention_cuda(q, kc, vc, frames, **kw),
                 lambda: ref.decode_attention_ref(q, kc, vc, frames, **kw),
                 lambda: sdpa_dense(q, kc, vc, every[None]), nb, fl // 2,
                 fl // 2, work), share=share)
    del kc, vc

    # the RWKV6 recurrence: bf16 r, k, v and out; fp32 logw, u and state
    def rwkv_inputs(b, l, h, hd):
        shape = (b, l, h, hd)
        return (bq(*shape), r(*shape, s=0.5).to(bf), bq(*shape),
                -torch.exp(r(*shape, s=0.5)), r(h, hd, s=0.1),
                r(b, h, hd, hd, s=0.1))

    def rwkv_check(got, want):
        """(max abs error, the largest share used): out within RWKV_TOL
        plus one bf16 ulp of the row max (the fp32 forms part within
        RWKV_TOL, then each rounds once), sT within RWKV_TOL."""
        err = share = 0.0
        for g, w_, ulp in ((got[0].float(), want[0].float(), BF16_ULP),
                           (got[1], want[1], 0.0)):
            diff = (g - w_).abs()
            tol = (RWKV_TOL["atol"] + RWKV_TOL["rtol"] * w_.abs()
                   + ulp * w_.abs().amax(-1, keepdim=True))
            err = max(err, diff.max().item())
            share = max(share, (diff / tol).max().item())
        need(got[0].dtype == want[0].dtype == bf
             and got[1].dtype == want[1].dtype == torch.float32,
             "rwkv6_chunked[bf16]: bf16 out and fp32 sT expected")
        return err, share
    heads = get_config("rwkv6-7b").rwkv_heads
    hd64 = get_config("rwkv6-7b").d_model // heads
    for case, b, l, h, hd in [("main: decode L=1", 4, 1, heads, hd64),
                              ("main: prefill L=100", 4, 100, heads, hd64),
                              ("edge: hd=16", 4, 100, 256, 16),
                              ("edge: hd=128", 4, 100, 32, 128)]:
        a = rwkv_inputs(b, l, h, hd)
        got = krw.rwkv6_cuda(*a)
        again = krw.rwkv6_cuda(*a)
        need(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
             f"rwkv6_chunked[bf16] [{case}]: a repeat changed the bits")
        err_o, share_o = rwkv_check(got, krw.rwkv6_ref(*a))
        print(f"  {'rwkv6_chunked[bf16]':<24} {case:<30} vs sequential "
              f"oracle: max_abs_err {err_o:.3e} ({share_o:.3f} of the bound)",
              flush=True)
        need(share_o <= 1.0, f"rwkv6_chunked[bf16] [{case}] disagrees with "
             "the sequential oracle")
        err, share = rwkv_check(got, krw.rwkv_chunked(*a, l))
        # r, k, v and out in bf16; logw, u and the state in and out fp32
        nb = (4 * b * l * h * hd * 2 + b * l * h * hd * 4 + h * hd * 4
              + 2 * b * h * hd * hd * 4)
        fl = b * l * h * (5 * hd * hd + 5 * hd)
        bms, by = bound(nb, fl)
        record("rwkv6_chunked[bf16]", f"{case}; {h} heads of {hd}", err,
               RWKV_BF16_TEXT, {
                   "ms": timer(lambda: krw.rwkv6_cuda(*a)),
                   "plain_ms": timer(lambda: krw.rwkv_chunked(*a, l)),
                   "library_ms": None,   # no single PyTorch call computes it
                   "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl},
               share=share)
    a = rwkv_inputs(4, 100, heads, hd64)
    whole = krw.rwkv6_cuda(*a)
    o1, s1 = krw.rwkv6_cuda(*(x[:, :50] for x in a[:4]), a[4], a[5])
    o2, s2 = krw.rwkv6_cuda(*(x[:, 50:] for x in a[:4]), a[4], s1)
    err, share = rwkv_check((torch.cat([o1, o2], 1), s2), whole)
    record("rwkv6_chunked[bf16]", "edge: halves chained by sT", err,
           RWKV_BF16_TEXT, share=share)
    del a, whole

    # the demux exit with its LN entry: h, keys, weights and output bf16,
    # norm params fp32
    exits = [("demux_rsa[ln, bf16]", "main: rwkv6-7b decode T=4",
              get_config("rwkv6-7b").d_model, 4, 2),
             ("demux_rsa[ln, bf16, whisper]", "main: whisper decode T=4",
              wh.d_model, 4, 2),
             ("demux_rsa[ln, bf16, bert N=2]", "main: bert T=10240",
              bert.d_model, BERT_INSTANCES // 2 * BERT_LEN, 2)]
    for row, case, d, tt, n in exits:
        f = 2 * d                       # MuxSpec's default demux_hidden
        w = tuple(x.to(bf) for x in (r(n, d), r(d, f, s=0.02),
                                     r(d, f, s=0.02), r(f, s=0.02),
                                     r(f, d, s=0.02), r(d, s=0.02)))
        norms = {"entry_kind": "ln", "entry_scale": 1.0 + r(d, s=0.1),
                 "entry_bias": r(d, s=0.1), "exit_scale": 1.0 + r(d, s=0.1),
                 "exit_bias": r(d, s=0.1)}
        x = (r(tt, d) + 2.0).to(bf)       # a residual stream with an offset
        got = kd.demux_rsa_cuda(x, *w, **norms)
        need(torch.equal(kd.demux_rsa_cuda(x, *w, **norms), got),
             f"{row}: a repeat changed the bits")
        err, share = bf16_share(got, ref.demux_rsa_fused_ref(x, *w, **norms),
                                2)
        nb = (3 * d * f + f + d + n * d + tt * d + n * tt * d) * 2 + 4 * d * 4
        fl = 2 * tt * d * f + 2 * n * tt * f * d          # fp32 activations

        def library():
            hn = F.layer_norm(x.float(), (d,), norms["entry_scale"],
                              norms["entry_bias"], eps=1e-6).to(bf)
            z = F.gelu(torch.matmul(hn, w[1])[None]
                       + (w[0] @ w[2] + w[3])[:, None], approximate="tanh")
            return F.layer_norm(torch.matmul(z, w[4]) + w[5], (d,),
                                norms["exit_scale"].to(bf),
                                norms["exit_bias"].to(bf), eps=1e-6)
        record(row, f"{case}; d {d} F {f} N {n}", err,
               "2 bf16 ulps of the row max",
               timed(lambda: kd.demux_rsa_cuda(x, *w, **norms),
                     lambda: ref.demux_rsa_fused_ref(x, *w, **norms),
                     library, nb, fl, 2 * n * d * f), share=share)


def bert_kernels(torch, timer, record):
    """Phase 3 at phase 8's shapes (mux-bert-base: 160 instances of 128
    tokens, d 768, 12 heads of 64, vocab 30522, demux hidden 1536): the
    four kernels of that path against their plain versions, each shape
    timed and recorded as its own row (``BERT_ROWS``)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import demux_rsa as kd
    from repro_torch.kernels import flash_attention as kfl
    from repro_torch.kernels import mux_combine as kc
    from repro_torch.kernels import mux_embed as km
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)      # the other cases keep their draws

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s)
                               .astype(np.float32), device=dev)

    def timed(kernel, plain, library, nb, fl, **extra):
        bms, by = bound(nb, fl)
        return {"ms": timer(kernel), "plain_ms": timer(plain),
                "library_ms": timer(library), "bound_ms": bms,
                "bound_by": by, "bytes": nb, "flops": fl, **extra}

    # the entry of (gaussian, rsa) at N=2: 80 rows of 128 tokens
    tt, d, vocab = 10240, 768, 30522
    emb, v = r(vocab, d, s=0.02), r(2, d)
    tok = torch.as_tensor(rng.integers(0, vocab, (2, tt)).astype(np.int32),
                          device=dev)
    tl = tok.long()
    got = km.mux_embed_combine_cuda(tok, emb, v)
    need(torch.equal(got, km.mux_embed_combine_cuda(tok, emb, v)),
         "mux_embed_combine [bert]: a repeat changed the bits")
    record("mux_embed_combine[bert]", "bert: N=2 T=10240 V 30522",
           (got - ref.mux_embed_ref(tok, emb, v)).abs().max().item(), MUX_TOL,
           timed(lambda: km.mux_embed_combine_cuda(tok, emb, v),
                 lambda: ref.mux_embed_ref(tok, emb, v),
                 lambda: torch.einsum("ntd,nd->td", F.embedding(tl, emb), v)
                 * 0.5, embed_bytes(tok, d, 4), 4 * tt * d,
                 work=f"{tok.unique().numel()} distinct table rows of "
                 f"{tok.numel()} gathers"))
    del emb
    # the entry of (gaussian, prefix) at N=2: embeddings given
    x = r(2, tt, d)
    got = kc.mux_combine_cuda(x, v)
    need(torch.equal(got, kc.mux_combine_cuda(x, v)),
         "mux_combine [bert]: a repeat changed the bits")
    record("mux_combine[bert]", "bert: (2, 10240, 768)",
           (got - ref.mux_combine_ref(x, v)).abs().max().item(),
           COMBINE_TOL["fp32"],
           timed(lambda: kc.mux_combine_cuda(x, v),
                 lambda: ref.mux_combine_ref(x, v),
                 lambda: torch.einsum("ntd,nd->td", x, v) / 2,
                 (3 * tt * d + 2 * d) * 4, 4 * tt * d))
    del x
    # bidirectional attention over the row and over the prefix demux's row
    for name, lq in (("flash_attention[bert L=128]", 128),
                     ("flash_attention[bert L=130]", 130)):
        q, k, vv = r(80, lq, 12, 64), r(80, lq, 12, 64), r(80, lq, 12, 64)
        got = kfl.flash_attention_cuda(q, k, vv, causal=False)
        need(torch.equal(got, kfl.flash_attention_cuda(q, k, vv,
                                                       causal=False)),
             f"{name}: a repeat changed the bits")
        vis = torch.ones(lq, lq, dtype=torch.bool, device=dev)
        nb, fl, work = dense_bound(q, k, vis)
        record(name, f"bert: B=80, L={lq} bidir.",
               (got - ref.flash_attention_ref(q, k, vv, causal=False)).abs()
               .max().item(), ATT_TOL,
               timed(lambda: kfl.flash_attention_cuda(q, k, vv, causal=False),
                     lambda: ref.flash_attention_ref(q, k, vv, causal=False),
                     lambda: sdpa_dense(q, k, vv, vis), nb, fl, work=work))
    del q, k, vv
    # the fused exit with the LN entry over a whole encoder batch
    f = 2 * d
    for name, tt, n in (("demux_rsa[ln, bert N=2]", 10240, 2),
                        ("demux_rsa[ln, bert N=10]", 2048, 10)):
        w = (r(n, d), r(d, f, s=0.02), r(d, f, s=0.02), r(f, s=0.02),
             r(f, d, s=0.02), r(d, s=0.02))
        norms = {"entry_kind": "ln", "entry_scale": 1.0 + r(d, s=0.1),
                 "entry_bias": r(d, s=0.1), "exit_scale": 1.0 + r(d, s=0.1),
                 "exit_bias": r(d, s=0.1)}
        h = r(tt, d) + 2.0                 # a residual stream with an offset
        got = kd.demux_rsa_cuda(h, *w, **norms)
        need(torch.equal(got, kd.demux_rsa_cuda(h, *w, **norms)),
             f"{name}: a repeat changed the bits")

        def library():
            hn = F.layer_norm(h, (d,), norms["entry_scale"],
                              norms["entry_bias"], eps=1e-6)
            z = F.gelu(torch.matmul(hn, w[1])[None]
                       + (w[0] @ w[2] + w[3])[:, None], approximate="tanh")
            return F.layer_norm(torch.matmul(z, w[4]) + w[5], (d,),
                                norms["exit_scale"], norms["exit_bias"],
                                eps=1e-6)
        nb = (3 * d * f + tt * d + n * d + f + 5 * d) * 4 + n * tt * d * 4
        fl = 2 * tt * d * f + 2 * n * tt * f * d + 2 * n * d * f
        record(name, f"bert: T={tt} N={n} d 768 F 1536",
               (got - ref.demux_rsa_fused_ref(h, *w, **norms)).abs().max()
               .item(), DEMUX_TOL,
               timed(lambda: kd.demux_rsa_cuda(h, *w, **norms),
                     lambda: ref.demux_rsa_fused_ref(h, *w, **norms), library,
                     nb, fl))


def serve_trace(cfg, n_req=8, prompt_len=100, new_tokens=16, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    # pairs of requests every 2 steps: each row fills with a mux group of
    # 2 and prefill chunks interleave with decode steps
    return [((i // 2) * 2, rng.integers(4, cfg.vocab_size, prompt_len),
             new_tokens) for i in range(n_req)]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script measures the port on "
              "an NVIDIA GPU and has no CPU mode", file=sys.stderr)
        return 3
    try:
        from repro_torch.configs import get_config
        from repro_torch.core import MuxSpec
        from repro_torch.kernels import build
        from repro_torch.models import TransformerLM, param_count
        from repro_torch.serve import engine
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--profile-bf16-kernels"]:    # phase 10's child
        build.build_all()
        profile_bf16_kernels(torch)
        return 0
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"phase 1: device {name} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # 2. build
    b = build.build_all()
    print(f"phase 2: nvcc build {b['seconds']:.1f} s (parallel, "
          f"{len(build.SOURCES)} sources, no Triton); into "
          f"{build.build_dir()}", flush=True)
    for line in b["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "Function properties",
                                   "==")):
            print("  " + line.strip())

    # 3. kernels
    timer = Timer(torch)
    summary = phase_kernels(torch, timer)

    # 4. serve, full width, once per page storage
    cfg = get_config("qwen2-1.5b")
    mux = MuxSpec(n=2)
    t0 = time.perf_counter()
    params = TransformerLM.init(
        torch.Generator(device="cuda").manual_seed(0), cfg, mux)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"phase 4: qwen2-1.5b full width, {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B params ({param_count(cfg) / 1e9:.3f} B "
          f"backbone) in {time.perf_counter() - t0:.1f} s", flush=True)
    prompt_len, new_tokens, rows = 100, 16, 4
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    runs = {}
    for kind in KINDS:
        sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                                capacity=prompt_len + new_tokens + 8,
                                cache_layout="paged", block_size=16,
                                kv_dtype=kind)
        runs[kind] = serve_once(params, sc, rows, trace, new_tokens)
    fp32_out = runs["fp32"]["outputs"]
    for kind in KINDS[1:]:
        out = runs[kind]["outputs"]
        same = sum(a == b for u in out for a, b in zip(out[u], fp32_out[u]))
        total = sum(len(v) for v in out.values())
        print(f"  {kind} pages: greedy tokens identical to the fp32 trace "
              f"{same}/{total} ({same / total:.3f})", flush=True)

    # 4b. ring, paged-blocking and fill-drain serving with the flash prefill
    cfg_flash = cfg.replace(attn_impl="flash")
    print("phase 4b: ring / blocking / fill-drain, attn_impl='flash'",
          flush=True)
    dense = {mode: serve_dense(params, cfg_flash, mux, rows, trace,
                               new_tokens, mode)
             for mode in ("ring", "blocking", "fill-drain")}

    # 5. kernel path against plain path
    print("phase 5: kernel path against plain path", flush=True)
    for kind in ("fp32", "int8"):
        sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                                capacity=prompt_len + new_tokens + 8,
                                cache_layout="paged", block_size=16,
                                kv_dtype=kind)
        compare_paths(params, sc, rows, trace, prompt_len, runs[kind])
    compare_ring_paths(params, cfg_flash, mux, rows, trace, new_tokens,
                       dense["ring"])

    # 6. rwkv6-7b, full width, ring arm and fill-drain; the qwen2-1.5b
    # weights are freed first (a finished runtime and its stats refer to
    # each other, so only the cycle collector lets them go)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rwkv = phase_rwkv(torch, mux, rows, prompt_len, new_tokens)

    # 7. whisper-small, full width, fill-drain; the rwkv6-7b weights were
    # phase 6's own and are gone with it
    gc.collect()
    torch.cuda.empty_cache()
    whisper = phase_whisper(torch, mux, rows, prompt_len, new_tokens)

    # 8. mux-bert-base, full width; the whisper-small weights were phase
    # 7's own and are gone with it
    gc.collect()
    torch.cuda.empty_cache()
    bert = phase_bert(torch)

    # 9. gemma-2b, h2o-danube-1.8b and gemma-7b, full width; the
    # mux-bert-base weights were phase 8's own and are gone with it
    gc.collect()
    torch.cuda.empty_cache()
    dense_runs = phase_dense(torch, mux, rows, prompt_len, new_tokens)

    # 10. qwen2-1.5b and gemma-2b in bf16, ServeConfig.dtype's default;
    # phase 9's weights were its own and are gone with it
    gc.collect()
    torch.cuda.empty_cache()
    bf16_runs = phase_bf16(torch, mux, rows, prompt_len, new_tokens, runs)

    # 11. width lanes, disaggregated serving and the telemetry outputs,
    # qwen2-1.5b in fp32; phase 10's weights were its own and are gone
    gc.collect()
    torch.cuda.empty_cache()
    p2 = phase_lanes(torch, rows, prompt_len, new_tokens, runs)

    # 12. logical shards, kill-shard replay and hot restart on phase 11's
    # N=2 weights (phase 4's), then they are freed
    phase_shards(torch, p2, rows, prompt_len, new_tokens, runs)
    del p2

    # 13. training on the plain model path, then serving the trained
    # weights through the kernels; phase 12's weights are gone
    gc.collect()
    torch.cuda.empty_cache()
    phase_train(torch)

    # 14. the MoE LMs, granite-moe-3b-a800m and qwen2-moe-a2.7b, full
    # width; phase 13's weights were its own and are gone with it
    gc.collect()
    torch.cuda.empty_cache()
    moe_runs = phase_moe(torch, mux, rows, prompt_len, new_tokens)

    # 15. recurrentgemma-9b, full width; phase 14's weights were its own
    # and are gone with it
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_runs = phase_hybrid(torch, mux, rows, prompt_len, new_tokens)

    # 16. llava-next-mistral-7b, full width; phase 15's weights were its
    # own and are gone with it
    gc.collect()
    torch.cuda.empty_cache()
    vlm_runs = phase_vlm(torch, mux, rows, prompt_len, new_tokens)

    # 17. the serve mesh: the shard-local paged wrappers, then full-width
    # qwen2-1.5b on (2, 2) and granite-moe-3b-a800m on (1, 2), ranks
    # sharing the card; phase 16's weights were its own and are gone
    gc.collect()
    torch.cuda.empty_cache()
    mesh_summary, mesh_runs = phase_mesh(torch, timer, mux, rows, prompt_len,
                                         new_tokens, runs, moe_runs)
    summary.update(mesh_summary)

    # 18. training on a device mesh: the compressed data-parallel step,
    # the sharded train step and the pipeline, ranks sharing the card;
    # phase 17's ranks and weights are gone
    gc.collect()
    torch.cuda.empty_cache()
    phase_dist_train(torch)

    # 19. the dry run on the host, and three of its cells materialised on
    # the card; phase 18's ranks and weights are gone
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun(torch)

    # summary
    entry_src = "src/repro_torch/kernels/csrc/mux_entry.cu"
    meta = {
        "mux_embed_combine": ("cuda", entry_src,
                              "src/repro/kernels/mux_embed.py:68"),
        "demux_rsa": ("cuda", "src/repro_torch/kernels/csrc/demux_rsa.cu",
                      "src/repro/kernels/demux_rsa.py:135"),
    }
    meta["decode_attention"] = (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:89")
    meta["flash_attention"] = (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:100")
    meta["rwkv6_chunked"] = ("cuda", "src/repro_torch/kernels/csrc/rwkv6.cu",
                             "src/repro/kernels/rwkv6.py:82")
    meta["demux_rsa[ln]"] = ("cuda",
                             "src/repro_torch/kernels/csrc/demux_rsa.cu",
                             "src/repro/kernels/demux_rsa.py:135")
    meta["mux_combine"] = ("cuda", entry_src,
                           "src/repro/kernels/mux_combine.py:35")
    for kname, (wrapper, _) in BERT_ROWS.items():
        meta[kname] = meta[wrapper]
    paged_src = "src/repro_torch/kernels/csrc/paged_attention.cu"
    for kind in KINDS:
        sfx = "" if kind == "fp32" else f"[{kind}]"
        meta[f"paged_attention{sfx}"] = (
            "cuda", paged_src, "src/repro/kernels/paged_attention.py:162")
        meta[f"paged_prefill_attention{sfx}"] = (
            "cuda", paged_src, "src/repro/kernels/paged_attention.py:297")
    for kname, (wrapper, _, _) in DENSE_ROWS.items():
        meta[kname] = meta[wrapper]
    for kname, (wrapper, _, _) in BF16_ROWS.items():
        meta[kname] = meta[wrapper]
    for kname, (wrapper, _) in BF16_REST_ROWS.items():
        meta[kname] = meta[wrapper]
    for kname, (wrapper, _, _) in MOE_ROWS.items():
        meta[kname] = meta[wrapper]
    for kname, (wrapper, _) in HYBRID_ROWS.items():
        meta[kname] = meta[wrapper]
    for kname, (wrapper, _) in LLAVA_ROWS.items():
        meta[kname] = meta[wrapper]
    for kname, repl in MESH_ROWS.items():
        meta[kname] = ("cuda", paged_src, repl)
    rest_runs = {"rwkv": rwkv["ring, bf16"]["launches"],
                 "whisper": whisper["bf16"]["launches"], "bert": bert["bf16"]}
    rows_json = []
    for kname, (route, src, repl) in meta.items():
        s = summary[kname]
        tm = s["timing"]
        base, _, kind = kname.partition("[")
        kind = kind.rstrip("]") or "fp32"
        if kname in MESH_ROWS:            # phase 17 (b), summed over ranks
            launches = mesh_runs["qwen2-1.5b"]["sharded"][kname]
        elif kname in LLAVA_ROWS:         # phase 16's run
            wrapper, run = LLAVA_ROWS[kname]
            launches = vlm_runs[run][wrapper]
        elif kname in HYBRID_ROWS:        # phase 15's run
            wrapper, run = HYBRID_ROWS[kname]
            launches = hybrid_runs[run]["launches"][wrapper]
        elif kname in MOE_ROWS:           # phase 14's run of that arch
            wrapper, arch, run = MOE_ROWS[kname]
            launches = moe_runs[arch][run]["launches"][wrapper]
        elif kname in BF16_REST_ROWS:     # phases 6-8's bf16 runs
            wrapper, run = BF16_REST_ROWS[kname]
            launches = rest_runs[run][wrapper]
        elif kname in BF16_ROWS:          # phase 10's run of that arch
            wrapper, arch, run = BF16_ROWS[kname]
            got = bf16_runs[arch][run]
            launches = (got["by_storage"][wrapper][run]
                        if wrapper.startswith("paged") else
                        got["launches"][wrapper])
        elif kname in BERT_ROWS:          # one hidden call of phase 8's arm
            wrapper, arm = BERT_ROWS[kname]
            launches = bert[arm][wrapper]
        elif kname in DENSE_ROWS:         # phase 9's run of that arch
            wrapper, arch, kind = DENSE_ROWS[kname]
            launches = dense_runs[arch][kind]["launches"][wrapper]
        elif base in ("paged_attention", "paged_prefill_attention"):
            launches = runs[kind]["by_storage"][base][kind]
        elif base in ("decode_attention", "flash_attention"):
            launches = dense["ring"]["launches"][base]     # the CLI default
        elif kname in ("rwkv6_chunked", "demux_rsa[ln]"):
            launches = rwkv["ring"]["launches"][base]
        elif kname == "mux_combine":      # the encoder's and decoder's entry
            launches = whisper["fp32"]["launches"][base]
        else:                   # the entry and exit run on every path
            launches = runs["fp32"]["launches"][base]
        rows_json.append({
            "name": kname, "route": route, "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": s["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"], "floor_ms": summary["floor_ms"]})
        need(launches > 0, f"{kname} was never launched on the main path")
    print("kernels: " + "; ".join(
        f"{k['name']} launches={k['launches']} max_abs_err="
        f"{k['max_abs_err']:.3e} ms={k['ms']:.4f}" for k in rows_json))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows_json, "floor_ms": summary["floor_ms"]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def paged_launches(launches, n_layers, dsteps, chunks):
    """The launches paged chunked serving requires: each paged kernel once
    a layer per decode step or chunk, the fused entry and exit once a
    step or chunk, nothing else."""
    want = dict.fromkeys(launches, 0)
    want.update({"paged_attention": n_layers * dsteps,
                 "paged_prefill_attention": n_layers * chunks,
                 "mux_embed_combine": dsteps + chunks,
                 "demux_rsa": dsteps + chunks})
    return want


def storage_name(sc) -> str:
    """The page storage of ``sc``: 'fp32', 'bf16', 'int8' or 'fp8' (its
    ``kv_dtype``, or the compute dtype's when that is None)."""
    import torch
    return sc.kv_quant or ("bf16" if sc.page_dtype == torch.bfloat16
                           else "fp32")


def pool_bytes_per_token(runtime) -> float:
    """The bytes the runtime's page pool holds on the card (payload,
    scales and slot positions of every layer) over its token slots."""
    held = sum(x.numel() * x.element_size() for c in runtime.cache["layers"]
               for k, x in c.items() if k in ("kp", "vp", "ksc", "vsc",
                                              "ppos"))
    return held / (runtime.pool.num_blocks * runtime.pool.block_size)


def serve_once(params, sc, rows, trace, new_tokens, ref_bytes=True,
               label=""):
    """Phase 4 (or 9) for one page storage: the launch counts set to 0
    just before the run and read just after, and every check of the path;
    the pool's bytes per token on the card equal to
    ``ServeConfig.kv_bytes_per_token`` and, with ``ref_bytes`` (qwen2-1.5b),
    to the reference's figures.  Returns what phases 5, 6 and 9 read."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve.telemetry import Telemetry
    cfg, store = sc.cfg, storage_name(sc)
    kind = f"{label}{store}"
    tele = Telemetry()
    ops.reset_counts()
    stats = run_continuous(params, sc, rows, trace, chunk=32,
                           telemetry=tele, device="cuda",
                           on_prefill=lambda *_: torch.cuda.synchronize())
    launches = ops.counts("launches")
    by_storage = {w.__name__: dict(w.by_storage) for w in ops.PAGED}
    dsteps, chunks = stats["decode_steps"], stats["prefill_events"]
    need(len(stats["completed"]) == len(trace),
         f"{kind}: {len(stats['completed'])} of {len(trace)} requests "
         "completed")
    need(all(len(r.output) == new_tokens for r in stats["completed"]),
         f"{kind}: a request stopped short of its new tokens")
    want = paged_launches(launches, cfg.n_layers, dsteps, chunks)
    need(launches == want, f"{kind}: launch counts {launches} != required "
         f"{want} ({dsteps} decode steps, {chunks} prefill chunks)")
    need(by_storage == {k: {store: v} for k, v in want.items()
                        if k in by_storage},
         f"{kind}: paged launches by storage {by_storage}")
    need(set(stats["trace_counts"]) == {"decode", "prefill_4", "prefill_32"},
         f"{kind}: step signatures {stats['trace_counts']}")
    held = pool_bytes_per_token(stats["runtime"])
    need(held == sc.kv_bytes_per_token() == stats["kv_bytes_per_token"],
         f"{kind}: the pool holds {held} bytes per token on the card; "
         f"ServeConfig.kv_bytes_per_token says {sc.kv_bytes_per_token()}")
    if ref_bytes:
        need(stats["kv_bytes_per_token"] == KV_BYTES_PER_TOKEN[store]
             and stats["pool_bytes"] == POOL_BYTES[store],
             f"{kind}: {stats['kv_bytes_per_token']} bytes per token, pool "
             f"{stats['pool_bytes']} bytes; the reference's figures are "
             f"{KV_BYTES_PER_TOKEN[store]} and {POOL_BYTES[store]}")
    spans = {}
    for ev in tele.tracer.events:
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[3] / 1e3)
    decode_ms = statistics.median(spans["decode"])
    chunk_ms = statistics.median(spans["prefill_chunk"])
    tok_s = stats["generated_tokens"] / stats["wall"]
    print(f"  {kind} pages: served {len(stats['completed'])} requests, "
          f"{stats['generated_tokens']} tokens in {stats['wall']:.3f} s: "
          f"{tok_s:.2f} tok/s; decode step p50 {decode_ms:.3f} ms over "
          f"{dsteps} steps; prefill chunk p50 {chunk_ms:.3f} ms over "
          f"{chunks} chunks; pool {stats['pool_bytes']} bytes, "
          f"{held:g} bytes per token on the card (kv_bytes_per_token "
          f"{sc.kv_bytes_per_token()}); launches {launches}", flush=True)
    return {"outputs": {r.uid: r.output for r in stats["completed"]},
            "launches": launches, "by_storage": by_storage,
            "decode_ms": decode_ms, "chunk_ms": chunk_ms, "tok_s": tok_s,
            "forwards": dsteps + chunks}


def clone_pages(c):
    """A copy of a paged cache (every layer's pages and the shared block
    table)."""
    layers = [{k: v.clone() for k, v in lc.items()} for lc in c["layers"]]
    bt = c["bt"].clone()
    for lc in layers:
        lc["bt"] = bt
    return {"layers": layers, "bt": bt}


def compare_paths(params, sc, rows, trace, prompt_len, kernel_run,
                  identical=False, label=""):
    """Phase 5 (or 9) for one page storage: kernel path against plain path
    on one chunk and one decode step from identical caches, then the
    share of identical greedy tokens over the phase-4 trace, which must be
    1 with ``identical``."""
    import torch
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    kind = f"{label}{sc.kv_dtype}"
    cache = engine.init_cache(sc, 2 * rows, device="cuda")
    pool = engine.make_pool(sc, 2 * rows)
    pool.allocate(0, prompt_len)
    engine.set_block_tables(cache, pool.table_array(range(rows)))
    toks = torch.as_tensor(trace[0][1][:32], device="cuda").repeat(2, 1)
    plain_cache = clone_pages(cache)
    lk, _ = engine.prefill_chunk(params, sc, cache, toks, rows=[0], start=0,
                                 length=32, use_kernels=True)
    lp, _ = engine.prefill_chunk(params, sc, plain_cache, toks, rows=[0],
                                 start=0, length=32, use_kernels=False)
    err_chunk = (lk - lp).abs().max().item()
    chunk_tol = LOGIT_TOL
    if sc.kv_quant == "int8":
        # Each path writes its own chunk K/V at every layer, from hidden
        # states ~1e-6 apart (two summation orders); an element that sits
        # on a rounding boundary then stores one level apart on the two
        # paths, and that difference carries into the next layers.  So the
        # payloads are held to one level, and the logits to a tenth of
        # what int8 storage itself moves them from fp32 pages.
        flips, levels = 0, 0
        kv_width = sc.cfg.n_kv_heads * sc.cfg.head_dim
        for a, b in zip(cache["layers"], plain_cache["layers"]):
            for key in ("kp", "vp"):
                d = (a[key].int() - b[key].int()).abs()
                flips += int((d > 0).sum())
                levels = max(levels, int(d.max()))
        sc32 = dataclasses.replace(sc, kv_dtype="fp32")
        cache32 = engine.init_cache(sc32, 2 * rows, device="cuda")
        engine.set_block_tables(cache32, pool.table_array(range(rows)))
        l32, _ = engine.prefill_chunk(params, sc32, cache32, toks, rows=[0],
                                      start=0, length=32, use_kernels=True)
        effect = (lk - l32).abs().max().item()
        chunk_tol = 0.1 * effect
        print(f"  {kind} pages: chunk K/V payloads written by the two paths: "
              f"{flips} of {2 * len(cache['layers']) * 32 * kv_width} differ, "
              f"by at most {levels} level(s); int8 against fp32 pages moves "
              f"the chunk logits by {effect:.3e}", flush=True)
        need(levels <= 1, f"{kind}: the paths' stored payloads differ by "
             f"{levels} levels")
    plain_cache = clone_pages(cache)
    dtok = torch.as_tensor([[int(lk[0].argmax())]] * (2 * rows),
                           device="cuda")
    pos = torch.as_tensor([32, -1, -1, -1], device="cuda")
    dk, _ = engine.decode_step(params, sc, cache, dtok, pos, use_kernels=True)
    dp, _ = engine.decode_step(params, sc, plain_cache, dtok, pos,
                               use_kernels=False)
    act = torch.as_tensor([0, rows], device="cuda")      # row 0's streams
    err_dec = (dk[act] - dp[act]).abs().max().item()
    print(f"  {kind} pages: logits max_abs_err: chunk {err_chunk:.3e} (tol "
          f"{chunk_tol:.3e}), decode from identical caches {err_dec:.3e} "
          f"(tol {LOGIT_TOL:g}); |logits| max {lk.abs().max().item():.3f}",
          flush=True)
    need(err_chunk <= chunk_tol and err_dec <= LOGIT_TOL,
         f"{kind}: kernel path disagrees with the plain path")
    plain = run_continuous(params, sc, rows, trace, chunk=32,
                           use_kernels=False, device="cuda")
    ko = kernel_run["outputs"]
    po = {r.uid: r.output for r in plain["completed"]}
    same = sum(a == b for u in ko for a, b in zip(ko[u], po[u]))
    total = sum(len(v) for v in ko.values())
    print(f"  {kind} pages: greedy tokens identical, kernel vs plain path: "
          f"{same}/{total} ({same / total:.3f}); plain path "
          f"{plain['generated_tokens'] / plain['wall']:.2f} tok/s",
          flush=True)
    need(same == total or not identical, f"{kind} pages: the kernel path's "
         "greedy tokens differ from the plain path's")


def serve_dense(params, cfg, mux, rows, trace, new_tokens, mode, label="",
                dtype=None, kind="lm", frames=None):
    """Phase 4b (or 10) for one mode: the continuous ring arm, paged
    serving with blocking prefill, or fill-drain, on the phase-4 trace in
    ``dtype`` (fp32 by default), with the launch counts set to 0 just
    before the run and read just after.  Every prefill is blocking and,
    under ``attn_impl='flash'``, runs flash_attention once per layer; a
    ring decode step runs decode_attention once per layer, a paged one
    paged_attention; each decode step runs the fused entry and exit, each
    prefill the mux-combine kernel of its unfused entry.  A paged pool's
    bytes per token on the card equal ``ServeConfig.kv_bytes_per_token``.
    The attention counts are per attention layer ('attn' or 'local'):
    every layer of a dense model, recurrentgemma-9b's 12 local layers of
    38 (phase 15).  kind 'vlm' (phase 16): fill-drain with the requests'
    patch embeddings ``frames``, each prefill over the patches and the
    prompt."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fill_drain, run_continuous
    from repro_torch.serve import engine
    from repro_torch.serve.telemetry import Telemetry
    layout = "paged" if mode == "blocking" else "ring"
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=dtype or torch.float32,
                            capacity=len(trace[0][1]) + new_tokens + 8,
                            cache_layout=layout, block_size=16, kind=kind)
    tele = Telemetry()
    ops.reset_counts()
    if mode == "fill-drain":
        stats = fill_drain(params, sc, rows, [a[1] for a in trace],
                           new_tokens, frames=frames, telemetry=tele,
                           device="cuda")
    else:
        stats = run_continuous(
            params, sc, rows, trace, prefill_mode="blocking", telemetry=tele,
            device="cuda", on_prefill=lambda *_: torch.cuda.synchronize())
    launches = ops.counts("launches")
    dsteps, events = stats["decode_steps"], stats["prefill_events"]
    need(len(stats["completed"]) == len(trace),
         f"{mode}: {len(stats['completed'])} of {len(trace)} requests "
         "completed")
    need(all(len(r.output) == new_tokens for r in stats["completed"]),
         f"{mode}: a request stopped short of its new tokens")
    attn = "paged_attention" if layout == "paged" else "decode_attention"
    want = dict.fromkeys(launches, 0)
    flash = cfg.attn_impl == "flash"
    n_attn = sum(b in ("attn", "local") for b in cfg.pattern_layers)
    want.update({attn: n_attn * dsteps,
                 "flash_attention": n_attn * events * flash,
                 "mux_embed_combine": dsteps, "demux_rsa": dsteps,
                 "mux_combine": events})
    need(launches == want, f"{mode}: launch counts {launches} != required "
         f"{want} ({dsteps} decode steps, {events} prefill events)")
    if layout == "paged":
        held = pool_bytes_per_token(stats["runtime"])
        need(held == sc.kv_bytes_per_token() == stats["kv_bytes_per_token"],
             f"{mode}: the pool holds {held} bytes per token on the card; "
             f"ServeConfig.kv_bytes_per_token says {sc.kv_bytes_per_token()}")
    spans = {}
    for ev in tele.tracer.events:
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[3] / 1e3)
    pre = spans["prefill_chunk" if layout == "paged" else "prefill"]
    tok_s = stats["generated_tokens"] / stats["wall"]
    print(f"  {label}{mode}: served {len(stats['completed'])} requests, "
          f"{stats['generated_tokens']} tokens in {stats['wall']:.3f} s: "
          f"{tok_s:.2f} tok/s; decode step p50 "
          f"{statistics.median(spans['decode']):.3f} ms over {dsteps} "
          f"steps; prefill p50 {statistics.median(pre):.3f} ms over "
          f"{events} prefills; launches {launches}", flush=True)
    return {"outputs": {r.uid: r.output for r in stats["completed"]},
            "launches": launches, "forwards": dsteps + events}


def copy_ring(src, dst):
    """Copy a ring cache's every layer (ring K/V and positions, recurrent
    state) into ``dst``, a cache of the same config, in place."""
    for a, b in zip(src["layers"], dst["layers"]):
        for key, x in a.items():
            if isinstance(x, int):
                b[key] = x
            else:
                b[key].copy_(x)


def compare_ring_paths(params, cfg, mux, rows, trace, new_tokens, ring_run,
                       identical=False, label=""):
    """Phase 5 for the ring: the flash prefill against the naive one, and
    the kernel decode step against the plain one from identical caches
    (logits of every stream), then the share of identical greedy tokens
    of the ring arm's kernel and plain paths over the phase-4 trace
    (``identical``: all of them, as phase 15 requires)."""
    import torch
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=len(trace[0][1]) + new_tokens + 8)
    import numpy as np
    sc_naive = dataclasses.replace(sc, cfg=cfg.replace(attn_impl="naive"))
    nb = max(mux.n, 1) * rows
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    cache = engine.init_cache(sc, nb, device="cuda")
    plain_cache = engine.init_cache(sc_naive, nb, device="cuda")
    lk, _ = engine.prefill(params, sc, cache, toks)
    lp, _ = engine.prefill(params, sc_naive, plain_cache, toks)
    need(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
         f"{label}ring: prefill logits are not finite")
    err_pre = (lk - lp).abs().max().item()
    copy_ring(cache, plain_cache)
    dtok = lk.argmax(-1)[:, None]
    pos = toks.shape[1]
    dk, _ = engine.decode_step(params, sc, cache, dtok, pos, use_kernels=True)
    dp, _ = engine.decode_step(params, sc, plain_cache, dtok, pos,
                               use_kernels=False)
    err_dec = (dk - dp).abs().max().item()
    print(f"  {label}ring: logits max_abs_err: flash vs naive prefill "
          f"{err_pre:.3e}, decode from identical caches {err_dec:.3e} (tol "
          f"{LOGIT_TOL:g}); |logits| max {lk.abs().max().item():.3f}",
          flush=True)
    need(err_pre <= LOGIT_TOL and err_dec <= LOGIT_TOL,
         f"{label}ring: kernel path disagrees with the plain path")
    plain = run_continuous(params, sc_naive, rows, trace, use_kernels=False,
                           device="cuda")
    ko = ring_run["outputs"]
    po = {r.uid: r.output for r in plain["completed"]}
    same = sum(a == b for u in ko for a, b in zip(ko[u], po[u]))
    total = sum(len(v) for v in ko.values())
    print(f"  {label}ring: greedy tokens identical, kernel vs plain path: "
          f"{same}/{total} ({same / total:.3f}); plain path "
          f"{plain['generated_tokens'] / plain['wall']:.2f} tok/s",
          flush=True)
    need(same == total or not identical, f"{label}ring: the kernel path's "
         "greedy tokens differ from the plain path's")


def phase_rwkv(torch, mux, rows, prompt_len, new_tokens):
    """Phase 6: full-width rwkv6-7b from seeded random weights on the
    card, the phase-4 trace through the ring arm and fill-drain on the
    kernel path with exact launch counts, then the kernel path against
    the plain path.  Returns {mode: serve_rwkv's result}."""
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, param_count
    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    params = TransformerLM.init(
        torch.Generator(device="cuda").manual_seed(0), cfg, mux)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"phase 6: rwkv6-7b full width, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.rwkv_heads} heads of "
          f"{cfg.d_model // cfg.rwkv_heads}, {n_params / 1e9:.3f} B params "
          f"({param_count(cfg) / 1e9:.3f} B backbone) in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    runs = {mode: serve_rwkv(params, cfg, mux, rows, trace, new_tokens, mode)
            for mode in ("ring", "fill-drain")}
    compare_rwkv_paths(params, cfg, mux, rows, trace, new_tokens,
                       runs["ring"])
    # the same weights at ServeConfig.dtype's default, bf16
    bf = torch.bfloat16
    for mode in ("ring", "fill-drain"):
        runs[f"{mode}, bf16"] = serve_rwkv(params, cfg, mux, rows, trace,
                                           new_tokens, mode, dtype=bf)
        print(f"  rwkv {mode}, bf16: greedy agreement with the fp32 run "
              "%d/%d" % agreement(runs[f"{mode}, bf16"]["outputs"],
                                  runs[mode]["outputs"]), flush=True)
    bf16_rwkv_vs_plain(params, cfg, mux, rows, trace, new_tokens,
                       runs["ring, bf16"])
    return runs


def serve_rwkv(params, cfg, mux, rows, trace, new_tokens, mode,
               dtype=None):
    """Phase 6 for one mode in ``dtype`` (fp32 by default), the launch
    counts set to 0 just before the run and read just after.  Every
    forward (blocking prefill or decode step) runs rwkv6_chunked once per
    layer; each decode step runs the fused entry and exit (demux_rsa with
    the LN entry), the prefill the plain ones, as in the reference, its
    entry through mux_combine; nothing else launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fill_drain, run_continuous
    from repro_torch.serve import engine
    from repro_torch.serve.telemetry import Telemetry
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=dtype or torch.float32,
                            capacity=len(trace[0][1]) + new_tokens + 8)
    mode_name = mode if sc.dtype == torch.float32 else f"{mode}, bf16"
    tele = Telemetry()
    ops.reset_counts()
    if mode == "fill-drain":
        stats = fill_drain(params, sc, rows, [a[1] for a in trace],
                           new_tokens, telemetry=tele, device="cuda")
    else:
        stats = run_continuous(
            params, sc, rows, trace, telemetry=tele, device="cuda",
            on_prefill=lambda *_: torch.cuda.synchronize())
    launches = ops.counts("launches")
    dsteps, events = stats["decode_steps"], stats["prefill_events"]
    need(len(stats["completed"]) == len(trace),
         f"rwkv {mode_name}: {len(stats['completed'])} of {len(trace)} requests "
         "completed")
    need(all(len(r.output) == new_tokens for r in stats["completed"]),
         f"rwkv {mode_name}: a request stopped short of its new tokens")
    want = dict.fromkeys(launches, 0)
    want.update({"rwkv6_chunked": cfg.n_layers * (dsteps + events),
                 "mux_embed_combine": dsteps, "demux_rsa": dsteps,
                 "mux_combine": events})
    need(launches == want, f"rwkv {mode_name}: launch counts {launches} != "
         f"required {want} ({dsteps} decode steps, {events} prefills)")
    spans = {}
    for ev in tele.tracer.events:
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[3] / 1e3)
    lens = ([g for _, g in stats["prefill_log"]] if mode == "ring"
            else [len(trace[0][1])])
    tok_s = stats["generated_tokens"] / stats["wall"]
    print(f"  rwkv {mode_name}: served {len(stats['completed'])} requests, "
          f"{stats['generated_tokens']} tokens in {stats['wall']:.3f} s: "
          f"{tok_s:.2f} tok/s; decode step p50 "
          f"{statistics.median(spans['decode']):.3f} ms over {dsteps} "
          f"steps; prefill p50 {statistics.median(spans['prefill']):.3f} ms "
          f"over {events} prefills of {rows} rows x {lens} tokens; launches "
          f"{launches}", flush=True)
    return {"outputs": {r.uid: r.output for r in stats["completed"]},
            "launches": launches}


def bf16_rwkv_vs_plain(params, cfg, mux, rows, trace, new_tokens,
                       ring_run, label="rwkv"):
    """Phase 6 in bf16 (phase 15's too, ``label`` 'hybrid'): from
    identical (zero) states, one blocking prefill of the grid and then one
    decode step from identical states, the kernel path against the same
    model with the wrappers at their plain versions (``bf16_logit_check``,
    the plain model path printed beside); the ring arm's greedy agreement
    with those plain versions printed."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    sc = engine.ServeConfig(cfg=cfg, mux=mux,
                            capacity=len(trace[0][1]) + new_tokens + 8)
    nb = max(mux.n, 1) * rows
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    caches = [engine.init_cache(sc, nb, device="cuda") for _ in range(3)]
    lk = engine.prefill(params, sc, caches[0], toks, use_kernels=True)[0]
    with kernels_as_plain():
        lp = engine.prefill(params, sc, caches[1], toks, use_kernels=True)[0]
    lm = engine.prefill(params, sc, caches[2], toks, use_kernels=False)[0]
    bf16_logit_check(f"{label}, bf16", "prefill", lk.float(), lp.float(),
                     lm.float())
    for c in caches[1:]:
        copy_ring(caches[0], c)
    dtok = lk.argmax(-1)[:, None]
    dk = engine.decode_step(params, sc, caches[0], dtok, toks.shape[1])[0]
    with kernels_as_plain():
        dp = engine.decode_step(params, sc, caches[1], dtok,
                                toks.shape[1])[0]
    dm = engine.decode_step(params, sc, caches[2], dtok, toks.shape[1],
                            use_kernels=False)[0]
    bf16_logit_check(f"{label}, bf16", "decode", dk.float(), dp.float(),
                     dm.float())
    with kernels_as_plain():
        plain = run_continuous(params, sc, rows, trace, device="cuda")
    print(f"  {label} ring, bf16: greedy agreement of the kernel path with "
          "its plain versions %d/%d" % agreement(
              ring_run["outputs"],
              {r.uid: r.output for r in plain["completed"]}), flush=True)


def compare_rwkv_paths(params, cfg, mux, rows, trace, new_tokens, ring_run):
    """Phase 6, kernel path against plain path: the logits of one blocking
    prefill of the grid (100 tokens: one chunk of the plain version) and
    of one decode step from identical states, then the share of identical
    greedy tokens of the ring arm's two paths over the trace."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=len(trace[0][1]) + new_tokens + 8)
    nb = max(mux.n, 1) * rows
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    cache = engine.init_cache(sc, nb, device="cuda")
    plain_cache = engine.init_cache(sc, nb, device="cuda")
    lk, _ = engine.prefill(params, sc, cache, toks, use_kernels=True)
    lp, _ = engine.prefill(params, sc, plain_cache, toks, use_kernels=False)
    need(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
         "rwkv: prefill logits are not finite")
    err_pre = (lk - lp).abs().max().item()
    copy_ring(cache, plain_cache)
    dtok = lk.argmax(-1)[:, None]
    dk, _ = engine.decode_step(params, sc, cache, dtok, toks.shape[1],
                               use_kernels=True)
    dp, _ = engine.decode_step(params, sc, plain_cache, dtok, toks.shape[1],
                               use_kernels=False)
    err_dec = (dk - dp).abs().max().item()
    print(f"  rwkv: logits max_abs_err kernel vs plain path: prefill "
          f"{err_pre:.3e}, decode from identical states {err_dec:.3e} (tol "
          f"{LOGIT_TOL:g}); |logits| max {lk.abs().max().item():.3f}",
          flush=True)
    need(err_pre <= LOGIT_TOL and err_dec <= LOGIT_TOL,
         "rwkv: kernel path disagrees with the plain path")
    plain = run_continuous(params, sc, rows, trace, use_kernels=False,
                           device="cuda")
    ko = ring_run["outputs"]
    po = {r.uid: r.output for r in plain["completed"]}
    same = sum(a == b for u in ko for a, b in zip(ko[u], po[u]))
    total = sum(len(v) for v in ko.values())
    print(f"  rwkv ring: greedy tokens identical, kernel vs plain path: "
          f"{same}/{total} ({same / total:.3f}); plain path "
          f"{plain['generated_tokens'] / plain['wall']:.2f} tok/s",
          flush=True)
    need(same == total, "rwkv ring: the kernel path's greedy tokens differ "
         "from the plain path's")


def phase_whisper(torch, mux, rows, prompt_len, new_tokens):
    """Phase 7: full-width whisper-small from seeded random weights on the
    card, ``attn_impl='flash'`` in both stacks, the phase-4 trace in
    fill-drain with seeded N(0, 1) frames, exact launch counts, then the
    kernel path against the plain path.  Returns the run's result."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import EncDecLM, param_count
    cfg = get_config("whisper-small")
    cfg = cfg.replace(attn_impl="flash",
                      encoder=cfg.encoder.replace(attn_impl="flash"))
    t0 = time.perf_counter()
    params = EncDecLM.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                           mux)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    enc = cfg.encoder
    print(f"phase 7: whisper-small full width, {enc.n_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d {cfg.d_model}, {enc.frontend_len}"
          f" frames, {n_params / 1e9:.3f} B params ({param_count(cfg) / 1e9:.3f}"
          f" B backbone) in {time.perf_counter() - t0:.1f} s", flush=True)
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    frames = np.random.default_rng(7).standard_normal(
        (len(trace), enc.frontend_len, enc.d_model), np.float32)
    run = serve_whisper(params, cfg, mux, rows, trace, frames, new_tokens)
    compare_fill_drain_paths(params, cfg, mux, rows, trace, frames,
                             new_tokens, run, "encdec", "whisper")
    # the same weights in the reference's default compute dtype, bf16
    run_bf16 = serve_whisper(params, cfg, mux, rows, trace, frames,
                             new_tokens, dtype=torch.bfloat16)
    print("  whisper, bf16: greedy agreement with the fp32 run %d/%d"
          % agreement(run_bf16["outputs"], run["outputs"]), flush=True)
    bf16_whisper_vs_plain(params, cfg, mux, rows, trace, frames, new_tokens,
                          run_bf16)
    return {"fp32": run, "bf16": run_bf16}


def serve_whisper(params, cfg, mux, rows, trace, frames, new_tokens,
                  dtype=None):
    """Phase 7 on the kernel path in ``dtype`` (fp32 by default), the
    launch counts set to 0 just before the run and read just after.  A prefill runs the encoder (its entry
    through mux_combine, flash_attention once per layer) and the decoder
    (its entry through mux_combine, flash_attention for the self- and the
    cross-attention of each layer); a decode step runs decode_attention
    for the self- and the cross-attention of each layer, and the fused
    entry and exit; nothing else launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fill_drain
    from repro_torch.serve import engine
    from repro_torch.serve.telemetry import Telemetry
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=dtype or torch.float32,
                            capacity=len(trace[0][1]) + new_tokens + 8,
                            kind="encdec")
    label = "whisper" if sc.dtype == torch.float32 else "whisper, bf16"
    tele = Telemetry()
    ops.reset_counts()
    stats = fill_drain(params, sc, rows, [a[1] for a in trace], new_tokens,
                       frames=frames, telemetry=tele, device="cuda")
    launches = ops.counts("launches")
    dsteps, events = stats["decode_steps"], stats["prefill_events"]
    need(len(stats["completed"]) == len(trace),
         f"{label}: {len(stats['completed'])} of {len(trace)} requests "
         "completed")
    need(all(len(r.output) == new_tokens for r in stats["completed"]),
         f"{label}: a request stopped short of its new tokens")
    want = dict.fromkeys(launches, 0)
    want.update({
        "mux_combine": 2 * events,
        "flash_attention": (cfg.encoder.n_layers + 2 * cfg.n_layers) * events,
        "decode_attention": 2 * cfg.n_layers * dsteps,
        "mux_embed_combine": dsteps, "demux_rsa": dsteps})
    need(launches == want, f"{label}: launch counts {launches} != required "
         f"{want} ({dsteps} decode steps, {events} prefills)")
    spans = {}
    for ev in tele.tracer.events:
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[3] / 1e3)
    tok_s = stats["generated_tokens"] / stats["wall"]
    print(f"  {label} fill-drain: served {len(stats['completed'])} requests, "
          f"{stats['generated_tokens']} tokens in {stats['wall']:.3f} s: "
          f"{tok_s:.2f} tok/s; decode step p50 "
          f"{statistics.median(spans['decode']):.3f} ms over {dsteps} steps;"
          f" prefill p50 {statistics.median(spans['prefill']):.3f} ms over "
          f"{events} prefills of {rows} rows x {len(trace[0][1])} tokens and "
          f"{cfg.encoder.frontend_len} frames; launches {launches}",
          flush=True)
    return {"outputs": {r.uid: r.output for r in stats["completed"]},
            "launches": launches}


def bf16_whisper_vs_plain(params, cfg, mux, rows, trace, frames, new_tokens,
                          run):
    """Phase 7 in bf16: the prefill's logits (encoder and decoder) and one
    decode step's from identical caches, the kernel path against the same
    model with the wrappers at their plain versions
    (``bf16_logit_check``, the plain model path printed beside); the
    greedy agreement of the run with those plain versions printed."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import fill_drain
    from repro_torch.serve import engine
    sc = engine.ServeConfig(cfg=cfg, mux=mux,
                            capacity=len(trace[0][1]) + new_tokens + 8,
                            kind="encdec")
    nb = max(mux.n, 1) * rows
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    extra = torch.as_tensor(frames[:nb], device="cuda")
    caches = [engine.init_cache(sc, nb, device="cuda") for _ in range(3)]
    lk = engine.prefill(params, sc, caches[0], toks, extra=extra,
                        use_kernels=True)[0]
    with kernels_as_plain():
        lp = engine.prefill(params, sc, caches[1], toks, extra=extra,
                            use_kernels=True)[0]
    lm = engine.prefill(params, sc, caches[2], toks, extra=extra,
                        use_kernels=False)[0]
    bf16_logit_check("whisper, bf16", "prefill", lk.float(), lp.float(),
                     lm.float())
    for c in caches[1:]:
        for a, b in zip(caches[0]["layers"], c["layers"]):
            for key in ("k", "v", "pos", "xk", "xv"):
                b[key] = a[key].clone()
    dtok = lk.argmax(-1)[:, None]
    dk = engine.decode_step(params, sc, caches[0], dtok, toks.shape[1])[0]
    with kernels_as_plain():
        dp = engine.decode_step(params, sc, caches[1], dtok,
                                toks.shape[1])[0]
    dm = engine.decode_step(params, sc, caches[2], dtok, toks.shape[1],
                            use_kernels=False)[0]
    bf16_logit_check("whisper, bf16", "decode", dk.float(), dp.float(),
                     dm.float())
    with kernels_as_plain():
        plain = fill_drain(params, sc, rows, [a[1] for a in trace],
                           new_tokens, frames=frames, device="cuda")
    print("  whisper, bf16: greedy agreement of the kernel path with its "
          "plain versions %d/%d" % agreement(
              run["outputs"], {r.uid: r.output for r in plain["completed"]}),
          flush=True)


def compare_fill_drain_paths(params, cfg, mux, rows, trace, frames,
                             new_tokens, kernel_run, kind, label):
    """Phase 7 (kind 'encdec') and 16 (a) (kind 'vlm'), fill-drain at the
    reference CLI's capacity and positions: kernel path (flash
    attention, mux-combine, flash-decode, fused entry and exit) against
    plain path (naive attention, einsum entries, the plain model path):
    the logits of the prefill over ``frames`` (frame or patch embeddings)
    and of one decode step from identical caches, then the greedy tokens
    of the whole trace, which must be identical."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import fill_drain
    from repro_torch.serve import engine
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=len(trace[0][1]) + new_tokens + 8,
                            kind=kind)
    naive = cfg.replace(attn_impl="naive")
    if cfg.encoder is not None:
        naive = naive.replace(encoder=cfg.encoder.replace(attn_impl="naive"))
    sc_plain = dataclasses.replace(sc, cfg=naive)
    nb = max(mux.n, 1) * rows
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    extra = torch.as_tensor(frames[:nb], device="cuda")
    cache = engine.init_cache(sc, nb, device="cuda")
    plain_cache = engine.init_cache(sc_plain, nb, device="cuda")
    lk, _ = engine.prefill(params, sc, cache, toks, extra=extra,
                           use_kernels=True)
    lp, _ = engine.prefill(params, sc_plain, plain_cache, toks, extra=extra,
                           use_kernels=False)
    need(bool(torch.isfinite(lk).all() and torch.isfinite(lp).all()),
         f"{label}: prefill logits are not finite")
    err_pre = (lk - lp).abs().max().item()
    copy_ring(cache, plain_cache)
    dtok = lk.argmax(-1)[:, None]
    dk, _ = engine.decode_step(params, sc, cache, dtok, toks.shape[1],
                               use_kernels=True)
    dp, _ = engine.decode_step(params, sc_plain, plain_cache, dtok,
                               toks.shape[1], use_kernels=False)
    err_dec = (dk - dp).abs().max().item()
    print(f"  {label}: logits max_abs_err kernel vs plain path: prefill "
          f"{err_pre:.3e}, decode from identical caches {err_dec:.3e} (tol "
          f"{LOGIT_TOL:g}); |logits| max {lk.abs().max().item():.3f}",
          flush=True)
    need(err_pre <= LOGIT_TOL and err_dec <= LOGIT_TOL,
         f"{label}: kernel path disagrees with the plain path")
    plain = fill_drain(params, sc_plain, rows, [a[1] for a in trace],
                       new_tokens, frames=frames, use_kernels=False,
                       device="cuda")
    ko = kernel_run["outputs"]
    po = {r.uid: r.output for r in plain["completed"]}
    same = sum(a == b for u in ko for a, b in zip(ko[u], po[u]))
    total = sum(len(v) for v in ko.values())
    print(f"  {label}: greedy tokens identical, kernel vs plain path: "
          f"{same}/{total} ({same / total:.3f}); plain path "
          f"{plain['generated_tokens'] / plain['wall']:.2f} tok/s",
          flush=True)
    need(same == total, f"{label}: the kernel path's greedy tokens differ "
         "from the plain path's")


BERT_INSTANCES, BERT_LEN = 160, 128      # instances held fixed, tokens each
# phase 8's arms: (N, mux kind, demux kind)
BERT_ARMS = [(2, "gaussian", "rsa"), (2, "gaussian", "prefix"),
             (2, "contextual", "rsa"), (2, "contextual", "prefix"),
             (5, "gaussian", "rsa"), (10, "gaussian", "rsa")]
# launches of one ``hidden`` call on the kernel path (12 layers, flash), as
# the reference gates the fused entry and exit
# (repro/models/transformer.py:114-117, 215-216)
BERT_LAUNCHES = {"gaussian": {"rsa": {"mux_embed_combine": 1, "demux_rsa": 1},
                              "prefix": {"mux_combine": 1}},
                 "contextual": {"rsa": {"demux_rsa": 1}, "prefix": {}}}
# device time of the profiled N=2 call by kernel name (lower case)
BERT_GROUPS = {"matmul": ("gemm", "cutlass", "xmma"), "demux_rsa": ("demux",),
               "flash_attention": ("flash",), "mux entry": ("mux_",)}
ARGMAX_SHARE = 0.999        # mlm argmax identical, kernel vs plain path
# phase 3's rows at phase 8's shapes: the wrapper and the arm whose
# ``hidden`` launch counts the JSON reports
BERT_ROWS = {
    "mux_embed_combine[bert]": ("mux_embed_combine", (2, "gaussian", "rsa")),
    "mux_combine[bert]": ("mux_combine", (2, "gaussian", "prefix")),
    "flash_attention[bert L=128]": ("flash_attention",
                                    (2, "gaussian", "rsa")),
    "flash_attention[bert L=130]": ("flash_attention",
                                    (2, "gaussian", "prefix")),
    "demux_rsa[ln, bert N=2]": ("demux_rsa", (2, "gaussian", "rsa")),
    "demux_rsa[ln, bert N=10]": ("demux_rsa", (10, "gaussian", "rsa")),
}


def phase_bert(torch):
    """Phase 8: full-width mux-bert-base (seeded weights, ELECTRA head, a
    classifier and a token head, ``attn_impl='flash'``) on the paper's
    throughput mechanism: 160 instances of 128 tokens held fixed, so N
    shrinks the backbone batch.  For each arm, one ``hidden`` call with the
    launch counts set to 0 just before and read just after (exact), then
    the four heads on the kernel path against the plain path (naive
    attention, plain entry and exit); then instances per second of
    ``mlm_logits`` on the kernel path at N = 1, 2, 5 and 10.  Returns
    {arm: launches}."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import MuxEngine, MuxSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_step
    from repro_torch.models import MuxBERT, param_count
    cfg = get_config("mux-bert-base").replace(attn_impl="flash")
    plain_cfg = cfg.replace(attn_impl="naive")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    base = MuxBERT.init(gen, cfg, electra=True)
    base["cls"] = MuxBERT.init_classifier(gen, cfg, 3)
    base["tok"] = MuxBERT.init_token_classifier(gen, cfg, 9)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(base))
    print(f"phase 8: mux-bert-base full width, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.max_seq_len} positions, "
          f"{n_params / 1e6:.1f} M params ({param_count(cfg) / 1e6:.1f} M "
          f"backbone) in {time.perf_counter() - t0:.1f} s; "
          f"{BERT_INSTANCES} instances of {BERT_LEN} tokens", flush=True)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (BERT_INSTANCES, BERT_LEN)), device="cuda")

    def arm(n, mux_kind="gaussian", demux_kind="rsa"):
        """The model at N with its own mux engine (N=1: none)."""
        spec = MuxSpec(n=n, mux_kind=mux_kind, demux_kind=demux_kind)
        p = dict(base, backbone=dict(base["backbone"]))
        if spec.enabled:
            p["backbone"]["mux_engine"] = MuxEngine.init(gen, spec,
                                                         cfg.d_model)
        return p, spec

    launches = {}
    for key in [(1, "gaussian", "rsa")] + BERT_ARMS:
        n, mux_kind, demux_kind = key
        p, spec = arm(*key)
        ops.reset_counts()
        h = MuxBERT.hidden(p, cfg, toks, mux=spec)
        torch.cuda.synchronize()
        got = ops.counts("launches")
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = cfg.n_layers
        if spec.enabled:
            want.update(BERT_LAUNCHES[mux_kind][demux_kind])
        name = f"N={n}" if n == 1 else f"N={n} ({mux_kind}, {demux_kind})"
        need(got == want, f"bert {name}: launch counts per hidden {got} != "
             f"required {want}")
        need(h.shape == (BERT_INSTANCES, BERT_LEN, cfg.d_model)
             and bool(torch.isfinite(h).all()),
             f"bert {name}: hidden {tuple(h.shape)} or not finite")
        launches[key] = got
        del h
        if n > 1:
            compare_bert_heads(p, cfg, plain_cfg, spec, toks, name)
    print("  bert launches per hidden: " + "; ".join(
        f"N={k[0]} {k[1]}/{k[2]}: " + ", ".join(
            f"{w} {c}" for w, c in v.items() if c)
        for k, v in launches.items()), flush=True)

    rates, p50 = {}, {}
    for n in (1, 2, 5, 10):
        p, spec = arm(n)
        MuxBERT.mlm_logits(p, cfg, toks, mux=spec)          # warm
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            MuxBERT.mlm_logits(p, cfg, toks, mux=spec)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        p50[n] = statistics.median(times)
        rates[n] = BERT_INSTANCES / p50[n]
        print(f"  bert mlm_logits kernel path N={n}: backbone batch "
              f"{BERT_INSTANCES // n} x {BERT_LEN}, p50 "
              f"{statistics.median(times) * 1e3:.3f} ms of 5 "
              f"({', '.join(f'{x * 1e3:.3f}' for x in times)}): "
              f"{rates[n]:.1f} instances/s", flush=True)
    print("  bert throughput vs N=1 (instances/s ratio, mlm_logits kernel "
          "path): " + ", ".join(f"N={n} {rates[n] / rates[1]:.3f}x"
                                for n in (2, 5, 10))
          + f"; {smi_line()}", flush=True)
    # where the N=2 call's time goes: one more call under torch.profiler,
    # its idle share against the p50 above
    p, spec = arm(2)
    trace, prof_wall = profile_step.profile_calls(
        lambda: MuxBERT.mlm_logits(p, cfg, toks, mux=spec), 1)
    profile_step.summarize("  bert mlm_logits kernel path N=2, profiled",
                           trace, 1, p50[2], prof_wall, 8, BERT_GROUPS)
    launches["bf16"] = bert_bf16(torch, arm, cfg, toks, rates)
    return launches


def bert_bf16(torch, arm, cfg, toks, fp32_rates):
    """Phase 8 in bf16 (``dtype=torch.bfloat16``): one ``hidden`` at N=2
    with the Gaussian mux and the RSA demux, its launch counts exact; the
    four heads on the kernel path against the same model with the wrappers
    at their plain versions (``bf16_logit_check``, the plain model path
    printed beside) and the MLM argmax agreement printed; then instances
    per second of ``mlm_logits`` at N = 1, 2, 5, 10 beside fp32's.
    Returns the ``hidden`` call's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import MuxBERT
    bf = torch.bfloat16
    p, spec = arm(2)
    ops.reset_counts()
    h = MuxBERT.hidden(p, cfg, toks, mux=spec, dtype=bf)
    torch.cuda.synchronize()
    got = ops.counts("launches")
    want = dict.fromkeys(got, 0)
    want["flash_attention"] = cfg.n_layers
    want.update(BERT_LAUNCHES["gaussian"]["rsa"])
    need(got == want, f"bert N=2 bf16: launch counts per hidden {got} != "
         f"required {want}")
    need(h.dtype == bf and h.shape == (BERT_INSTANCES, BERT_LEN, cfg.d_model)
         and bool(torch.isfinite(h.float()).all()),
         f"bert N=2 bf16: hidden {h.dtype} {tuple(h.shape)} or not finite")
    del h
    plain_cfg = cfg.replace(attn_impl="naive")
    for head in ("mlm_logits", "rtd_logits", "classify", "classify_tokens"):
        fn = getattr(MuxBERT, head)
        args = (p, p["cls"] if head == "classify" else p["tok"]) \
            if head.startswith("classify") else (p,)
        k = fn(*args, cfg, toks, mux=spec, dtype=bf).float()
        with kernels_as_plain():
            pl = fn(*args, cfg, toks, mux=spec, dtype=bf).float()
        m = fn(*args, plain_cfg, toks, mux=spec, dtype=bf,
               use_kernels=False).float()
        bf16_logit_check("bert N=2, bf16", head, k, pl, m)
        if head == "mlm_logits":
            same = (k.argmax(-1) == pl.argmax(-1)).float().mean().item()
            print("  bert N=2, bf16: mlm argmax identical to the plain "
                  f"versions' {same:.5f}", flush=True)
        del k, pl, m
    rates = {}
    for n in (1, 2, 5, 10):
        p, spec = arm(n)
        MuxBERT.mlm_logits(p, cfg, toks, mux=spec, dtype=bf)      # warm
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            MuxBERT.mlm_logits(p, cfg, toks, mux=spec, dtype=bf)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        rates[n] = BERT_INSTANCES / statistics.median(times)
        print(f"  bert mlm_logits kernel path N={n}, bf16: p50 "
              f"{statistics.median(times) * 1e3:.3f} ms of 5: "
              f"{rates[n]:.1f} instances/s (fp32 {fp32_rates[n]:.1f})",
              flush=True)
    print("  bert throughput, bf16 vs N=1: " + ", ".join(
        f"N={n} {rates[n] / rates[1]:.3f}x" for n in (2, 5, 10))
        + f"; bf16 vs fp32 at N: " + ", ".join(
            f"N={n} {rates[n] / fp32_rates[n]:.3f}x" for n in (1, 2, 5, 10))
        + f"; {smi_line()}", flush=True)
    return got


def compare_bert_heads(p, cfg, plain_cfg, spec, toks, name):
    """Phase 8, kernel path (the arm's entry and exit kernels, flash
    attention) against plain path (plain entry and exit, naive attention)
    on the four heads, within LOGIT_TOL; the mlm argmax identical at
    ARGMAX_SHARE or more."""
    import torch
    from repro_torch.models import MuxBERT
    errs = {}
    for head in ("mlm_logits", "rtd_logits", "classify", "classify_tokens"):
        fn = getattr(MuxBERT, head)
        args = (p, p["cls"] if head == "classify" else p["tok"]) \
            if head.startswith("classify") else (p,)
        k = fn(*args, cfg, toks, mux=spec, use_kernels=True)
        pl = fn(*args, plain_cfg, toks, mux=spec, use_kernels=False)
        need(bool(torch.isfinite(k).all() and torch.isfinite(pl).all()),
             f"bert {name} {head}: not finite")
        errs[head] = (k - pl).abs().max().item()
        if head == "mlm_logits":
            share = (k.argmax(-1) == pl.argmax(-1)).float().mean().item()
            top = k.abs().max().item()
        del k, pl
    print(f"  bert {name}: max_abs_err kernel vs plain path "
          + ", ".join(f"{h} {e:.3e}" for h, e in errs.items())
          + f" (tol {LOGIT_TOL:g}); mlm argmax identical {share:.5f} (need "
          f">= {ARGMAX_SHARE}); |mlm logits| max {top:.3f}", flush=True)
    need(all(e <= LOGIT_TOL for e in errs.values()),
         f"bert {name}: kernel path disagrees with the plain path")
    need(share >= ARGMAX_SHARE, f"bert {name}: mlm argmax identical at "
         f"{share} < {ARGMAX_SHARE}")


# phase 9: the dense LMs of the registry beyond qwen2-1.5b, gemma-7b last
# (its fp32 weights take ~34 GB)
DENSE_ARCHS = ("gemma-2b", "h2o-danube-1.8b", "gemma-7b")
# h2o-danube-1.8b's long request: a prompt past its 4096-token window
LONG_PROMPT, LONG_NEW = 4200, 8
# gemma-2b's pressure arm: 22 allocatable blocks of the worst case's 32 (4
# rows of 8): three 100-token rows fit, a fourth admission rolls back, and
# the rows' growth past 112 tokens preempts
PRESSURE_BLOCKS = 23
# phase 3's rows at phase 9's shapes: the wrapper, the architecture and
# the page storage whose phase-9 launch counts the JSON reports
DENSE_ROWS = {
    **{f"{w}[h2o{'' if k == 'fp32' else ', ' + k}]":
       (w, "h2o-danube-1.8b", k)
       for w in ("paged_attention", "paged_prefill_attention")
       for k in KINDS},
    "paged_attention[gemma-7b]": ("paged_attention", "gemma-7b", "fp32"),
    "paged_prefill_attention[gemma-7b]": ("paged_prefill_attention",
                                          "gemma-7b", "fp32"),
    "mux_embed_combine[gemma-7b]": ("mux_embed_combine", "gemma-7b",
                                    "fp32"),
    "demux_rsa[gemma-7b]": ("demux_rsa", "gemma-7b", "fp32"),
}


def phase_dense(torch, mux, rows, prompt_len, new_tokens):
    """Phase 9: gemma-2b, h2o-danube-1.8b and gemma-7b at full width from
    seeded random weights, one at a time (each freed before the next),
    the phase-4 trace paged chunked (chunk 32, block 16) with exact launch
    counts per step and the pool's bytes per token on the card against
    ``ServeConfig.kv_bytes_per_token``, then the kernel path against the
    plain path (one chunk and one decode step from identical caches within
    2e-3, greedy tokens identical).  h2o-danube-1.8b also serves on bf16,
    int8 and fp8 pages, and its long request crosses its window;
    gemma-2b also serves the ring arm and paged blocking prefill with the
    flash prefill, and an undersized pool.  Returns {arch: {run: result}}.
    """
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, param_count
    from repro_torch.serve import engine
    torch.cuda.reset_peak_memory_stats()
    print("phase 9: gemma-2b, h2o-danube-1.8b, gemma-7b full width",
          flush=True)
    t_phase = time.perf_counter()
    out = {}
    for arch in DENSE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = TransformerLM.init(
            torch.Generator(device="cuda").manual_seed(0), cfg, mux)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in _leaves(params))
        print(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.head_dim}"
              f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, window "
              f"{cfg.window}; {n_params / 1e9:.3f} B params "
              f"({param_count(cfg) / 1e9:.3f} B backbone) in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
              flush=True)
        trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
        label = f"{arch} "
        runs = {}
        for kind in KINDS if arch == "h2o-danube-1.8b" else ("fp32",):
            sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                                    capacity=prompt_len + new_tokens + 8,
                                    cache_layout="paged", block_size=16,
                                    kv_dtype=kind)
            runs[kind] = serve_once(params, sc, rows, trace, new_tokens,
                                    ref_bytes=False, label=label)
        sc = dataclasses.replace(sc, kv_dtype="fp32")
        compare_paths(params, sc, rows, trace, prompt_len, runs["fp32"],
                      identical=True, label=label)
        if arch == "gemma-2b":
            cfg_flash = cfg.replace(attn_impl="flash")
            for mode in ("ring", "blocking"):
                runs[mode] = serve_dense(params, cfg_flash, mux, rows, trace,
                                         new_tokens, mode, label=label)
            runs["pressure"] = serve_pressure(params, sc, rows, trace,
                                              new_tokens, runs["fp32"])
        if arch == "h2o-danube-1.8b":
            runs["long"] = serve_long(params, cfg, mux)
        out[arch] = runs
        del params
    print(f"  phase 9: {time.perf_counter() - t_phase:.1f} s; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return out


def serve_pressure(params, sc_full, rows, trace, new_tokens, full_run):
    """Phase 9, gemma-2b's undersized pool (``PRESSURE_BLOCKS`` of the
    worst case's ``sc_full.pool_blocks``): every request completes with
    its full ``new_tokens``, admissions roll back and decoding rows are
    preempted (each at least once), the launch counts are exact per chunk
    and decode step, and the pool drains clean.  Greedy agreement with the
    worst-case pool's run is printed, not asserted: a preempted row is
    prefilled again, through the chunk kernel where it had decoded, so a
    near-tie may flip (token identity is asserted on the CPU against the
    reference, tests/test_torch_fuzz.py)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve.telemetry import Telemetry
    sc = dataclasses.replace(sc_full, num_blocks=PRESSURE_BLOCKS)
    worst = sc_full.pool_blocks(max(sc.mux.n, 1) * rows)
    need(PRESSURE_BLOCKS < worst, f"pressure: {PRESSURE_BLOCKS} blocks is "
         f"not under the worst case's {worst}")
    tele = Telemetry()
    ops.reset_counts()
    stats = run_continuous(params, sc, rows, trace, chunk=32,
                           telemetry=tele, device="cuda",
                           on_prefill=lambda *_: torch.cuda.synchronize())
    launches = ops.counts("launches")
    dsteps, chunks = stats["decode_steps"], stats["prefill_events"]
    need(len(stats["completed"]) == len(trace)
         and all(len(r.output) == new_tokens for r in stats["completed"]),
         "pressure: a request did not complete with its new tokens")
    want = paged_launches(launches, sc.cfg.n_layers, dsteps, chunks)
    need(launches == want, f"pressure: launch counts {launches} != "
         f"required {want} ({dsteps} decode steps, {chunks} chunks)")
    pool = stats["runtime"].pool
    need(pool.num_blocks == PRESSURE_BLOCKS and pool.n_used_blocks == 0,
         f"pressure: pool of {pool.num_blocks} blocks, "
         f"{pool.n_used_blocks} still used")
    pool.check_invariants()
    rollbacks = tele.registry.value("admit_rollbacks", lane=0, shard=0)
    preempts = tele.registry.value("preempts", lane=0, shard=0)
    need(rollbacks >= 1 and preempts >= 1, f"pressure: {rollbacks} "
         f"admission rollbacks and {preempts} preemptions; each path must "
         "run")
    full = full_run["outputs"]
    got = {r.uid: r.output for r in stats["completed"]}
    same = sum(a == b for u in got for a, b in zip(got[u], full[u]))
    total = sum(len(v) for v in got.values())
    print(f"  gemma-2b pressure: pool {PRESSURE_BLOCKS} of {worst} blocks; "
          f"{rollbacks} admission rollbacks, {preempts} preemptions; "
          f"{chunks} prefill chunks and {dsteps} decode steps (worst-case "
          f"pool: see above); pool drained, invariants hold; greedy tokens "
          f"identical to the worst-case pool's run {same}/{total} "
          f"({same / total:.3f}); "
          f"{stats['generated_tokens'] / stats['wall']:.2f} tok/s; launches "
          f"{launches}", flush=True)
    return {"launches": launches, "rollbacks": rollbacks,
            "preempts": preempts}


def serve_long(params, cfg, mux):
    """Phase 9, h2o-danube-1.8b's long request: one prompt of
    ``LONG_PROMPT`` tokens (past the 4096-token window) and ``LONG_NEW``
    new tokens, paged chunked on one row on the kernel path (exact launch
    counts) and on the plain path: greedy tokens identical; the logits of
    the last chunk and of a decode step from identical caches (both past
    the window) within 2e-3; each path's time printed."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    need(cfg.window is not None and LONG_PROMPT > cfg.window,
         f"h2o long request: {LONG_PROMPT} tokens do not cross the window "
         f"{cfg.window}")
    prompt = np.random.default_rng(9).integers(4, cfg.vocab_size,
                                               LONG_PROMPT)
    trace = [(0, prompt, LONG_NEW)]
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=LONG_PROMPT + LONG_NEW + 8,
                            cache_layout="paged", block_size=16,
                            kv_dtype="fp32")
    runs = {}
    for use_kernels in (True, False):
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run_continuous(params, sc, 1, trace, chunk=32,
                               use_kernels=use_kernels, device="cuda")
        torch.cuda.synchronize()
        runs[use_kernels] = (stats, time.perf_counter() - t0,
                             ops.counts("launches"))
    stats, wall, launches = runs[True]
    dsteps, chunks = stats["decode_steps"], stats["prefill_events"]
    want = paged_launches(launches, cfg.n_layers, dsteps, chunks)
    need(launches == want, f"h2o long: launch counts {launches} != "
         f"required {want}")
    ko = stats["completed"][0].output
    po = runs[False][0]["completed"][0].output
    need(len(ko) == LONG_NEW and ko == po, f"h2o long: greedy tokens kernel "
         f"{ko} vs plain {po}")
    # the last chunk and one decode step from identical caches
    cache = engine.init_cache(sc, max(mux.n, 1), device="cuda")
    pool = engine.make_pool(sc, max(mux.n, 1))
    pool.allocate(0, LONG_PROMPT + 1)
    engine.set_block_tables(cache, pool.table_array(range(1)))
    toks = torch.as_tensor(prompt, device="cuda").repeat(max(mux.n, 1), 1)
    last = (LONG_PROMPT - 1) // 32 * 32
    for start in range(0, last, 32):
        engine.prefill_chunk(params, sc, cache, toks[:, start:start + 32],
                             rows=[0], start=start, length=32)
    errs = []
    plain_cache = clone_pages(cache)
    lk, _ = engine.prefill_chunk(params, sc, cache, toks[:, last:],
                                 rows=[0], start=last,
                                 length=LONG_PROMPT - last)
    lp, _ = engine.prefill_chunk(params, sc, plain_cache, toks[:, last:],
                                 rows=[0], start=last,
                                 length=LONG_PROMPT - last,
                                 use_kernels=False)
    errs.append((lk - lp).abs().max().item())
    plain_cache = clone_pages(cache)
    dtok = lk.argmax(-1)[:, None]
    pos = torch.as_tensor([LONG_PROMPT], device="cuda")
    dk, _ = engine.decode_step(params, sc, cache, dtok, pos)
    dp, _ = engine.decode_step(params, sc, plain_cache, dtok, pos,
                               use_kernels=False)
    errs.append((dk - dp).abs().max().item())
    print(f"  h2o-danube-1.8b long request: {LONG_PROMPT}-token prompt "
          f"(window {cfg.window}), {LONG_NEW} new tokens, {chunks} chunks "
          f"and {dsteps} decode steps on one row: kernel path {wall:.3f} s, "
          f"plain path {runs[False][1]:.3f} s; greedy tokens identical "
          f"{LONG_NEW}/{LONG_NEW}; logits max_abs_err kernel vs plain path "
          f"from identical caches: last chunk {errs[0]:.3e}, decode at "
          f"{LONG_PROMPT} {errs[1]:.3e} (tol {LOGIT_TOL:g}); launches "
          f"{launches}", flush=True)
    need(max(errs) <= LOGIT_TOL, "h2o long: kernel path disagrees with the "
         "plain path")
    return {"launches": launches, "wall": wall}


# phase 10: the reference's bf16 compute dtype (ServeConfig.dtype's default)
BF16_ARCHS = ("qwen2-1.5b", "gemma-2b")
# phase 3's bf16 rows: the wrapper, and the phase-10 architecture and run
# (the page storage, or the ring arm) whose launches the JSON reports
BF16_ROWS = {
    **{f"{w}[{tag}bf16 q, {k}]": (w, arch, k)
       for arch, tag, kinds in BF16_SHAPES for k in kinds
       for w in ("paged_attention", "paged_prefill_attention")},
    **{f"decode_attention[{tag}bf16]": ("decode_attention", arch, "ring")
       for arch, tag, _ in BF16_SHAPES},
    **{f"demux_rsa[{tag}bf16]": ("demux_rsa", arch, "bf16")
       for arch, tag, _ in BF16_SHAPES},
}
# phase 3's bf16 rows at phases 6-8's shapes: the wrapper and the bf16 run
# whose launches the JSON reports (rwkv6-7b's ring arm, whisper-small's
# fill-drain, one mux-bert-base ``hidden`` at N=2)
BF16_REST_ROWS = {
    "flash_attention[bf16]": ("flash_attention", "whisper"),
    "flash_attention[bf16, bert]": ("flash_attention", "bert"),
    "decode_attention[bf16, whisper]": ("decode_attention", "whisper"),
    "rwkv6_chunked[bf16]": ("rwkv6_chunked", "rwkv"),
    "demux_rsa[ln, bf16]": ("demux_rsa", "rwkv"),
    "demux_rsa[ln, bf16, whisper]": ("demux_rsa", "whisper"),
    "demux_rsa[ln, bf16, bert N=2]": ("demux_rsa", "bert"),
}
# one wrapper call of each bf16 kernel under the profiler: the kernels it
# may launch (its own source's), by name
BF16_OWN = {"paged_attention": ("paged_decode_kernel", "paged_combine_kernel"),
            "paged_prefill_attention": ("paged_chunk_kernel",
                                        "paged_combine_kernel"),
            "decode_attention": ("decode_kernel",),
            "demux_rsa": ("demux_hidden_kernel", "demux_out_kernel",
                          "demux_exit_kernel"),
            "flash_attention": ("flash_attention_kernel",
                                "flash_combine_kernel"),
            "rwkv6_chunked": ("rwkv6_scan",)}


def agreement(a, b):
    """(positions where two runs' greedy tokens agree, all positions)."""
    same = sum(x == y for u in a for x, y in zip(a[u], b[u]))
    return same, sum(len(v) for v in a.values())


@contextlib.contextmanager
def kernels_as_plain():
    """The kernel path with every wrapper of ``kernels.ops`` taking its CPU
    branch, its kernel's plain version, on the card's tensors: the
    kernels' own rounding points without their launches (phase 10's
    yardstick; the launch counts do not move)."""
    from repro_torch.kernels import ops
    on_cpu = ops._on_cpu
    ops._on_cpu = lambda x: True
    try:
        yield
    finally:
        ops._on_cpu = on_cpu


def bf16_logit_check(kind, what, kernel, plain, model_plain, fp32=None,
                     routing=None):
    """Phase 10's gate on one set of logits (fp32 copies; phases 6-8 and
    14 use it too): the kernel path against the same model with the
    wrappers at their plain versions (``kernels_as_plain``), within
    ``BF16_LOGIT_ULPS`` bf16 ulps of the kernel path's |logits| max.  Also
    prints what the plain model path (``attention_core``'s and the
    oracle's rounding points) and, where given, fp32 compute read against
    the kernel path, and whether the argmax moved.  ``routing`` (an MoE
    model): the two runs' ``blocks.record_moe`` records.  A routing
    decision is a step function of the router's bf16 logits, so where the
    logits differ by more than the tolerance the two runs must have chosen
    differently (``routing_flip``), first where a token's router logits
    moved by at most ``BF16_LOGIT_ULPS`` bf16 ulps of their largest
    |value|: a near tie that the kernels' rounding tips."""
    err = (kernel - plain).abs().max().item()
    tol = BF16_LOGIT_ULPS * BF16_ULP * kernel.abs().max().item()
    am = kernel.argmax(-1)
    others = [model_plain] + ([] if fp32 is None else [fp32])
    print(f"  {kind}: {what} logits, kernel path vs its plain versions "
          f"from identical caches {err:.3e} (tol {tol:.3e}, "
          f"{BF16_LOGIT_ULPS} bf16 ulps of |logits| max "
          f"{kernel.abs().max().item():.3f}); vs the plain model path "
          f"{(kernel - model_plain).abs().max().item():.3e}"
          + ("" if fp32 is None else
             f"; vs fp32 compute {(kernel - fp32).abs().max().item():.3e}")
          + "; argmax moved in " + " / ".join(
              str(int((am != x.argmax(-1)).sum())) for x in [plain] + others)
          + f" of {am.numel()} rows", flush=True)
    if err > tol and routing is not None:
        flip = routing_flip(*routing)
        need(flip is not None, f"{kind}: the {what} logits differ by {err} "
             f"> {tol} with every MoE routing decision alike")
        call, n_tok, gap = flip
        print(f"  {kind}: {what}: the two runs route differently from "
              f"layer {call} on, {n_tok} token(s) there, whose router "
              f"logits moved by {gap:.2f} bf16 ulps of their largest |value| "
              f"(tol {BF16_LOGIT_ULPS}): a near tie tipped by rounding; past "
              f"it the logits are another routing's", flush=True)
        need(gap <= BF16_LOGIT_ULPS, f"{kind}: the {what} routing differs "
             f"where the router logits moved by {gap:.2f} bf16 ulps")
        return
    need(err <= tol, f"{kind}: the bf16 kernel path's {what} logits differ "
         f"from its plain versions' by {err} > {tol}")


def routing_flip(a, b):
    """The first MoE call at which two runs' ``blocks.record_moe`` records
    choose different experts (or the same in another order): (its index,
    the tokens whose choices differ, and how far those tokens' router
    logits moved between the runs: the largest |difference|, in bf16 ulps
    of the token's largest |router logit|); None if every call chose
    alike.  Every earlier call chose alike, so the router's inputs there
    differ by the kernels' rounding alone."""
    import torch
    for i, (x, y) in enumerate(zip(a, b)):
        if torch.equal(x["topi"], y["topi"]):
            continue
        diff = (x["topi"] != y["topi"]).any(-1)
        la, lb = x["logits"][diff], y["logits"][diff]
        moved = (la - lb).abs().amax(-1) / (BF16_ULP * la.abs().amax(-1))
        return i, int(diff.sum()), moved.max().item()
    return None


def bf16_vs_plain(params, sc, rows, trace, prompt_len, label):
    """Phase 10 for one page storage: from identical caches, one 32-token
    chunk's and then one decode step's logits on the kernel path against
    the same path with the wrappers at their plain versions
    (``bf16_logit_check``); the plain model path and fp32 compute on the
    same tokens and page storage are printed beside them."""
    import torch
    from repro_torch.serve import engine
    store = storage_name(sc)
    kind = f"{label}{store} pages"
    toks = torch.as_tensor(trace[0][1][:32], device="cuda").repeat(2, 1)
    dtok = torch.full((2 * rows, 1), int(trace[0][1][32]), device="cuda")
    pos = torch.as_tensor([32, -1, -1, -1], device="cuda")
    act = torch.as_tensor([0, rows], device="cuda")      # row 0's streams

    def fresh(s_):
        cache = engine.init_cache(s_, 2 * rows, device="cuda")
        pool = engine.make_pool(s_, 2 * rows)
        pool.allocate(0, prompt_len)
        engine.set_block_tables(cache, pool.table_array(range(rows)))
        return cache

    def chunk(s_, cache, uk=True):
        lc, _ = engine.prefill_chunk(params, s_, cache, toks, rows=[0],
                                     start=0, length=32, use_kernels=uk)
        return lc.float()

    def step(s_, cache, uk=True):
        ld, _ = engine.decode_step(params, s_, cache, dtok, pos,
                                   use_kernels=uk)
        return ld[act].float()

    def three(fn, cache):
        """The kernel path on ``cache``, its plain versions and the plain
        model path each on a copy of it as it was; an MoE model's records
        of the first two runs."""
        from repro_torch.models import blocks
        twins = clone_pages(cache), clone_pages(cache)
        with blocks.record_moe() as ks:
            got = fn(sc, cache)
        with kernels_as_plain(), blocks.record_moe() as ps:
            plain = fn(sc, twins[0])
        routing = (ks, ps) if sc.cfg.moe is not None else None
        return (got, plain, fn(sc, twins[1], False)), routing
    sc32 = dataclasses.replace(sc, dtype=torch.float32, kv_dtype=store)
    c32 = fresh(sc32)
    cache = fresh(sc)
    for what, fn in (("chunk", chunk), ("decode", step)):
        runs, routing = three(fn, cache)
        bf16_logit_check(kind, what, *runs, fn(sc32, c32), routing=routing)


def bf16_ring_vs_plain(params, cfg, mux, rows, trace, new_tokens, label):
    """Phase 10 for the ring: a blocking prefill into a bf16 ring, then
    one decode step held as ``bf16_vs_plain`` holds the pages (fp32
    compute steps from its own fp32 prefill)."""
    import numpy as np
    import torch
    from repro_torch.serve import engine
    nb = max(mux.n, 1) * rows
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    pos = toks.shape[1]

    def prefilled(dtype):
        sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=dtype,
                                capacity=len(trace[0][1]) + new_tokens + 8)
        cache = engine.init_cache(sc, nb, device="cuda")
        logits, _ = engine.prefill(params, sc, cache, toks)
        return sc, cache, logits

    def twin():
        c = engine.init_cache(sc, nb, device="cuda")
        copy_ring(cache, c)
        return c
    from repro_torch.models import blocks
    sc, cache, logits = prefilled(torch.bfloat16)
    dtok = logits.argmax(-1)[:, None]
    twins = twin(), twin()
    with blocks.record_moe() as ks:
        got = engine.decode_step(params, sc, cache, dtok, pos)[0]
    with kernels_as_plain(), blocks.record_moe() as ps:
        plain = engine.decode_step(params, sc, twins[0], dtok, pos)[0]
    model_plain = engine.decode_step(params, sc, twins[1], dtok, pos,
                                     use_kernels=False)[0]
    sc32, cache32, _ = prefilled(torch.float32)
    fp32 = engine.decode_step(params, sc32, cache32, dtok, pos)[0]
    bf16_logit_check(f"{label}ring", "decode", got.float(), plain.float(),
                     model_plain.float(), fp32,
                     routing=(ks, ps) if cfg.moe is not None else None)


def near_ties(params, cfg, mux, rows, trace, label):
    """The witness to phase 10's greedy agreements: teacher-forced over
    the trace's first N * rows prompts (no cache), each position's gap
    between the bf16 kernel path's two largest logits against what fp32
    compute moves that position's logits (max over the vocabulary), and
    how often the argmax moves under fp32 compute and under the kernels'
    plain versions."""
    import numpy as np
    import torch
    from repro_torch.models import TransformerLM
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:mux.n * rows]]),
                           device="cuda")

    def logits(dtype):
        with torch.no_grad():
            out = TransformerLM.apply(params, cfg, toks, mux=mux,
                                      dtype=dtype)["logits"]
        return out.reshape(-1, out.shape[-1])
    got = logits(torch.bfloat16)
    with kernels_as_plain():
        am_plain = logits(torch.bfloat16).argmax(-1)
    top2 = got.topk(2, -1).values.float()
    gap = top2[:, 0] - top2[:, 1]
    am = got.argmax(-1)
    got = got.float()
    f32 = logits(torch.float32)
    moved = (got - f32).abs().amax(-1)
    am32 = f32.argmax(-1)
    del got, f32
    print(f"  {label}near ties, teacher-forced over {gap.numel()} prompt "
          f"positions: top-2 logit gap median {gap.median().item():.4f}, "
          f"below 0.1 at {(gap < 0.1).float().mean().item():.3f} of them; "
          f"fp32 compute moves a position's logits by "
          f"{moved.median().item():.4f} (median of the max over the "
          f"vocabulary), more than its gap at "
          f"{(gap < moved).float().mean().item():.3f}; argmax moved at "
          f"{(am != am32).float().mean().item():.3f} (fp32 compute) and "
          f"{(am != am_plain).float().mean().item():.3f} (the kernels' plain "
          f"versions)", flush=True)


def profile_bf16_kernels(torch):
    """One wrapper call of each bf16 kernel under torch.profiler (after a
    warm-up call): only its own source's kernels may appear, as their
    bf16 instantiations, and no cast or copy, so the kernel itself reads
    the 16-bit operands and writes the 16-bit output.  Run in a process
    of its own (``--profile-bf16-kernels``): on the card, after phases
    3-9 in one process, the traces of such short windows held the calls'
    CUDA runtime events but not always their kernels, where a fresh
    process's held every one."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_step import profile_calls
    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(31)

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s).astype(
            np.float32), device=dev)

    def ints(*xs):
        return torch.tensor(xs, dtype=torch.int32, device=dev)
    bt = torch.arange(1, 33, dtype=torch.int32, device=dev).reshape(4, 8)
    pp = torch.arange(33 * 16, dtype=torch.int32, device=dev).reshape(
        33, 16) % 128
    kpg, vpg = r(33, 16, 2, 128).to(bf), r(33, 16, 2, 128).to(bf)
    q1, qc = r(4, 1, 12, 128).to(bf), r(1, 32, 12, 128).to(bf)
    kr, vr = r(4, 124, 2, 128).to(bf), r(4, 124, 2, 128).to(bf)
    rpos = torch.arange(124, dtype=torch.int32, device=dev)
    d, f = 1536, 3072
    h = r(4, d).to(bf)
    w = [x.to(bf) for x in (r(2, d), r(d, f, s=0.02), r(d, f, s=0.02),
                            r(f, s=0.02), r(f, d, s=0.02), r(d, s=0.02))]
    norms = {"entry_kind": "rms", "entry_scale": r(d, s=0.1),
             "exit_scale": 1.0 + r(d, s=0.1), "exit_bias": r(d, s=0.1)}
    qp, qs, ql = ints(116, 107, 100, 99), ints(64), ints(32)
    fq, fk = r(4, 100, 12, 64).to(bf), r(4, 1500, 12, 64).to(bf)
    rw = [r(4, 100, 64, 64).to(bf) for _ in range(3)] + [
        -torch.exp(r(4, 100, 64, 64, s=0.5)), r(64, 64, s=0.1),
        r(4, 64, 64, 64, s=0.1)]
    calls = {
        "paged_attention": lambda: ops.paged_attention(q1, kpg, vpg, bt, pp,
                                                       qp),
        "paged_prefill_attention": lambda: ops.paged_prefill_attention(
            qc, kpg, vpg, bt[:1], pp, qs, ql),
        "decode_attention": lambda: ops.decode_attention(q1, kr, vr, rpos,
                                                         q_pos=116),
        "demux_rsa": lambda: ops.demux_rsa(h, *w, **norms),
        "flash_attention": lambda: ops.flash_attention(fq, fk, fk,
                                                       causal=False),
        "rwkv6_chunked": lambda: ops.rwkv6_chunked(*rw, chunk=100)[0],
    }
    for wrapper, fn in calls.items():
        need(fn().dtype == bf, f"{wrapper}: bf16 output expected")
        # a single call's window now and then records no device activity
        # at all, even in this fresh process (PERF.md §7): up to three
        # windows, the first that records any is checked
        for _ in range(3):
            trace, _ = profile_calls(fn, 1)
            names = [e["name"] for e in trace["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") in
                     ("kernel", "gpu_memcpy", "gpu_memset")]
            if names:
                break
        print(f"  profiled {wrapper}(bf16): {len(names)} device "
              f"activities: {sorted(set(names))}", flush=True)
        need(names, f"{wrapper}(bf16): the profiler recorded no device "
             "activity")
        need(all(any(k in n for k in BF16_OWN[wrapper]) and "bfloat16" in n
                 for n in names),
             f"{wrapper}(bf16) launched something besides its own bf16 "
             f"kernels: {names}")


def phase_bf16(torch, mux, rows, prompt_len, new_tokens, fp32_runs):
    """Phase 10: full-width qwen2-1.5b and gemma-2b at
    ``ServeConfig.dtype=torch.bfloat16`` (the default) on the phase-4
    trace.  qwen2-1.5b: paged chunked on default (bf16), fp32, int8 and
    fp8 pages, paged blocking and the ring arm; gemma-2b (MQA 8 over 1 of
    256, an embedding scale bf16 rounds to 45.25): paged chunked and the
    ring arm.  Each arm with exact launch counts and, on pages, the pool's
    bytes per token on the card; the kernel path against its plain
    versions from identical caches (``bf16_vs_plain``); greedy agreement
    of the kernel path with its plain versions, the plain model path and
    phase 4's fp32 run, and the near ties behind them (``near_ties``);
    one profiled call of each bf16 kernel.  Returns each architecture's
    runs by page storage and arm."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_continuous
    from repro_torch.models import TransformerLM
    from repro_torch.serve import engine
    torch.cuda.reset_peak_memory_stats()
    print(f"phase 10: qwen2-1.5b and gemma-2b full width in bf16; "
          f"{smi_line()}", flush=True)
    t_phase = time.perf_counter()
    out = {}
    for arch in BF16_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        params = TransformerLM.init(
            torch.Generator(device="cuda").manual_seed(0), cfg, mux)
        trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
        label = f"{arch} bf16 "
        qwen = arch == "qwen2-1.5b"
        runs = {}
        for kv in (None, "fp32", "int8", "fp8") if qwen else (None,):
            sc = engine.ServeConfig(cfg=cfg, mux=mux,
                                    capacity=prompt_len + new_tokens + 8,
                                    cache_layout="paged", block_size=16,
                                    kv_dtype=kv)
            need(sc.dtype == torch.bfloat16, f"default dtype {sc.dtype}")
            store = storage_name(sc)
            runs[store] = serve_once(params, sc, rows, trace, new_tokens,
                                     ref_bytes=qwen, label=label)
            bf16_vs_plain(params, sc, rows, trace, prompt_len, label)
            if qwen:                # phase 4: fp32 compute, same storage
                same, total = agreement(runs[store]["outputs"],
                                        fp32_runs[store]["outputs"])
                print(f"  {label}{store} pages: greedy tokens identical to "
                      f"the fp32-compute run on {store} pages (phase 4): "
                      f"{same}/{total} ({same / total:.3f})", flush=True)
        sc = engine.ServeConfig(cfg=cfg, mux=mux,
                                capacity=prompt_len + new_tokens + 8,
                                cache_layout="paged", block_size=16)
        with kernels_as_plain():
            plain = run_continuous(params, sc, rows, trace, chunk=32,
                                   device="cuda")
        model_plain = run_continuous(params, sc, rows, trace, chunk=32,
                                     use_kernels=False, device="cuda")
        for what, run in (("its plain versions", plain),
                          ("the plain model path", model_plain)):
            same, total = agreement(runs["bf16"]["outputs"], {
                r.uid: r.output for r in run["completed"]})
            print(f"  {label}bf16 pages: greedy tokens identical, kernel "
                  f"path vs {what}: {same}/{total} ({same / total:.3f}); "
                  f"{run['generated_tokens'] / run['wall']:.2f} tok/s",
                  flush=True)
        near_ties(params, cfg, mux, rows, trace, label)
        modes = ("blocking", "ring") if qwen else ("ring",)
        for mode in modes:
            runs[mode] = serve_dense(params, cfg, mux, rows, trace,
                                     new_tokens, mode, label=label,
                                     dtype=torch.bfloat16)
        bf16_ring_vs_plain(params, cfg, mux, rows, trace, new_tokens, label)
        out[arch] = runs
        if qwen:
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--profile-bf16-kernels"], capture_output=True, text=True,
                timeout=600)
            print(proc.stdout, end="", flush=True)
            need(proc.returncode == 0, "the bf16 kernels' profile failed:\n"
                 + proc.stderr[-3000:])
        del params, plain, model_plain
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{smi_line()}", flush=True)
    return out


# phase 11: width lanes, disaggregated prefill / decode and the telemetry
# outputs, full-width qwen2-1.5b in fp32
LANE_WIDTHS = (1, 2, 4)
MAIN_PATH = ("mux_embed_combine", "paged_attention", "paged_prefill_attention",
             "demux_rsa")
LANE_REQUESTS = 24
BUDGET_SHARE = 0.8          # of the lanes' summed device ceilings
SLO_MIX = ("latency", "balanced", "throughput")     # weights 1, 1, 1


@contextlib.contextmanager
def launches_by_step():
    """Record each ``ServeRuntime.step``'s kernel launches: yields the list
    of (lane, {wrapper: launches}) per step, in step order.  A handoff
    runs between steps and launches no kernel wrapper."""
    from repro_torch.kernels import ops
    from repro_torch.serve import runtime
    log, orig = [], runtime.ServeRuntime.step

    def step(self):
        before = ops.counts("launches")
        orig(self)
        after = ops.counts("launches")
        log.append((self.lane, {k: after[k] - before[k] for k in after}))

    runtime.ServeRuntime.step = step
    try:
        yield log
    finally:
        runtime.ServeRuntime.step = orig


def _page_bits(x):
    import torch
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


@contextlib.contextmanager
def checked_handoffs():
    """Wrap ``ServeRuntime.handoff_to``: the source row's pages of every
    layer are copied just before the move, and after it the destination
    row's pages must equal that copy ``torch.equal``-wise (payload, scales
    and positions).  Yields the list of (blocks, bytes) per handoff; the
    copies and comparisons sit outside the runtime's ``handoff`` span."""
    import torch
    from repro_torch.serve import runtime
    moves, orig = [], runtime.ServeRuntime.handoff_to

    def handoff_to(self, dst, j, dst_row):
        bt = self.pool.block_table(j)
        src = torch.as_tensor(bt[bt >= 0], dtype=torch.long,
                              device=self.device)
        taken = [{k: x.index_select(0, src) for k, x in c.items()
                  if k != "bt"} for c in self.cache["layers"]]
        before = self.stats["migrated_bytes"]
        plan = orig(self, dst, j, dst_row)
        if plan is None:
            return plan
        bt = dst.pool.block_table(dst_row)
        dsts = torch.as_tensor(bt[bt >= 0], dtype=torch.long,
                               device=self.device)
        need(dsts.numel() == src.numel(), "handoff: block counts differ")
        for layer, (c, want) in enumerate(zip(dst.cache["layers"], taken)):
            for k, x in want.items():
                need(torch.equal(_page_bits(c[k].index_select(0, dsts)),
                                 _page_bits(x)),
                     f"handoff: layer {layer} {k} pages differ from their "
                     "source after the move")
        need(bool((self.cache["bt"][j] == -1).all()),
             "handoff: the source row still addresses pages")
        moves.append((src.numel(), self.stats["migrated_bytes"] - before))
        return plan

    runtime.ServeRuntime.handoff_to = handoff_to
    try:
        yield moves
    finally:
        runtime.ServeRuntime.handoff_to = orig


def lane_launches(n_layers, n_mux, dsteps, chunks, role="both"):
    """The launches one lane requires: each paged kernel once a layer per
    decode step or chunk, the fused entry and exit once a step or chunk
    when N > 1 (at N = 1 neither runs, as in the reference)."""
    muxed = n_mux > 1
    return {"paged_attention": n_layers * dsteps,
            "paged_prefill_attention": n_layers * chunks,
            "mux_embed_combine": (dsteps + chunks) * muxed,
            "demux_rsa": (dsteps + chunks) * muxed}


def _sum_launches(log, lane):
    got = {}
    for ln, d in log:
        if ln == lane:
            for k, v in d.items():
                got[k] = got.get(k, 0) + v
    return {k: v for k, v in got.items() if v}


def _span_ms(tele, name, pid):
    return [ev[3] / 1e3 for ev in tele.tracer.events
            if ev[0] == "X" and ev[1] == name and ev[4] == pid]


def lane_trace(cfg, prompt_len, new_tokens):
    """Phase 4's trace shape (pairs every 2 steps) at ``LANE_REQUESTS``
    requests, each with a seeded SLO class (weights 1, 1, 1)."""
    import numpy as np
    rng = np.random.default_rng(1)
    return [(*a, None, str(rng.choice(SLO_MIX)))
            for a in serve_trace(cfg, n_req=LANE_REQUESTS,
                                 prompt_len=prompt_len,
                                 new_tokens=new_tokens)]


def phase_lanes(torch, rows, prompt_len, new_tokens, fp32_runs):
    """Phase 11: full-width qwen2-1.5b in fp32, one backbone shared by
    reference across mux widths (phase 4's N=2 weights; N=1 drops its mux
    and demux, N=4 has its own), served (a) as width lanes at N = 1, 2, 4,
    (b) disaggregated (a prefill lane handing rows to a decode lane, N=2,
    fp32 and int8 pages) and (c) with the telemetry outputs on and off.
    Returns the N=2 weights (phase 12 serves them)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core import MuxEngine, MuxSpec
    from repro_torch.models import TransformerLM
    from repro_torch.serve import engine
    torch.cuda.reset_peak_memory_stats()
    print(f"phase 11: width lanes, disaggregated serving and telemetry, "
          f"qwen2-1.5b full width in fp32; {smi_line()}", flush=True)
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    p2 = TransformerLM.init(torch.Generator(device="cuda").manual_seed(0),
                            cfg, MuxSpec(n=2))      # phase 4's weights
    backbone = {k: v for k, v in p2.items() if k != "mux_engine"}
    params = {1: backbone, 2: p2,
              4: {**backbone, "mux_engine": MuxEngine.init(
                  torch.Generator(device="cuda").manual_seed(4),
                  MuxSpec(n=4), cfg.d_model)}}
    base = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=1), dtype=torch.float32,
                              capacity=prompt_len + new_tokens + 8,
                              cache_layout="paged", block_size=16)
    lanes_phase(torch, cfg, params, base, rows, prompt_len, new_tokens)
    disagg_phase(torch, cfg, params[2], base, rows, prompt_len, new_tokens,
                 fp32_runs)
    telemetry_phase(torch, cfg, params[2], base, rows, prompt_len,
                    new_tokens, tempfile)
    del params, backbone
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{smi_line()}", flush=True)
    return p2


def _check_lanes(kind, stats, trace, new_tokens, n_layers, log):
    """Every request complete, pools drained, step signatures one decode
    plus one per bucket per width, launches per lane exact."""
    need(len(stats["completed"]) == len(trace)
         and all(len(r.output) == new_tokens for r in stats["completed"]),
         f"{kind}: a request did not complete with its new tokens")
    for pool in stats["pools"]:
        need(pool.n_used_blocks == 0, f"{kind}: a pool did not drain")
        pool.check_invariants()
    for ls in stats["lanes"]:
        lane, n = ls["lane"], ls["n_mux"]
        sigs = ls["trace_counts"]
        if ls["completed"]:
            need(sigs == {"decode": 1, "prefill_4": 1, "prefill_32": 1},
                 f"{kind}: lane {lane} step signatures {sigs}")
        want = {k: v for k, v in lane_launches(
            n_layers, n, ls["decode_steps"], ls["prefill_events"]).items()
            if v}
        got = _sum_launches(log, lane)
        need(got == want, f"{kind}: lane {lane} (N={n}) launches {got} != "
             f"required {want}")


def lanes_phase(torch, cfg, params, base, rows, prompt_len, new_tokens):
    """(a) Lanes at N = 1, 2, 4, 4 rows each: without a budget every
    lane's routed sub-schedule replays token for token through a
    fixed-width run at its N; under a budget of ``BUDGET_SHARE`` of the
    ceilings ``rebalance`` moves quota, every request completes and the
    N=1 lane's requests keep their tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    from repro_torch.serve.telemetry import Telemetry
    trace = lane_trace(cfg, prompt_len, new_tokens)
    ceilings = sum(engine.lane_config(base, w).pool_blocks(rows * w) - 1
                   for w in LANE_WIDTHS)
    budget = int(BUDGET_SHARE * ceilings)
    runs = {}
    for kind, pool_budget in (("lanes", None), ("lanes+budget", budget)):
        tele = Telemetry()
        ops.reset_counts()
        with launches_by_step() as log:
            stats = run_continuous(params, base, rows, trace, chunk=32,
                                   lanes=LANE_WIDTHS, pool_budget=pool_budget,
                                   telemetry=tele, device="cuda")
        torch.cuda.synchronize()
        _check_lanes(kind, stats, trace, new_tokens, cfg.n_layers, log)
        total = ops.counts("launches")
        need(all(total[k] > 0 for k in MAIN_PATH),
             f"{kind}: a main-path kernel never launched: {total}")
        rc = stats["routing"]
        print(f"  {kind} (budget {pool_budget} of {ceilings} blocks): served "
              f"{len(stats['completed'])} requests, "
              f"{stats['generated_tokens']} tokens in {stats['wall']:.3f} s "
              f"({stats['generated_tokens'] / stats['wall']:.2f} tok/s); "
              f"routing {rc}", flush=True)
        for ls, lst in zip(stats["lanes"], stats["lane_stats"]):
            dec = _span_ms(tele, "decode", ls["lane"])
            chunk = _span_ms(tele, "prefill_chunk", ls["lane"])
            print(f"    lane {ls['lane']} N={ls['n_mux']}: "
                  f"{len(ls['completed'])} requests, {lst['tokens']} tokens, "
                  f"{ls['decode_steps']} decode steps (p50 "
                  f"{statistics.median(dec) if dec else 0:.3f} ms), "
                  f"{ls['prefill_events']} chunks (p50 "
                  f"{statistics.median(chunk) if chunk else 0:.3f} ms); "
                  f"TTFT-SLO attainment {lst['slo_attainment']:.2f}, "
                  f"goodput {lst['goodput_tok_s']:.2f} tok/s; launches "
                  f"{_sum_launches(log, ls['lane'])}", flush=True)
        runs[kind] = stats
    need(runs["lanes+budget"]["routing"]["rebalanced_blocks"] > 0,
         "lanes+budget: rebalance moved no quota")
    # (a) replay: each lane's routed sub-schedule at its own width
    for ls in runs["lanes"]["lanes"]:
        routed = sorted(ls["completed"], key=lambda r: r.uid)
        if not routed:
            continue
        n = ls["n_mux"]
        sub = [(r.routed_step, r.prompt, r.max_new) for r in routed]
        fixed = run_continuous(params[n], engine.lane_config(base, n), rows,
                               sub, chunk=32, device="cuda")
        got = sorted(fixed["completed"], key=lambda r: r.uid)
        need([r.output for r in got] == [r.output for r in routed],
             f"lanes: lane {ls['lane']} (N={n}) diverged from its "
             "fixed-width replay")
        print(f"    lane {ls['lane']} N={n}: {len(routed)} requests "
              "token-identical to a fixed-width run of its routed "
              "sub-schedule", flush=True)
    # under the budget, quota rollbacks may regroup N > 1 lanes; one
    # stream a row at N=1 keeps its tokens wherever it is admitted
    plain = {r.uid: r for r in runs["lanes"]["completed"]}
    same = total = 0
    for r in runs["lanes+budget"]["completed"]:
        p = plain[r.uid]
        total += len(r.output)
        same += sum(a == b for a, b in zip(r.output, p.output))
        if r.lane == p.lane == 0:
            need(r.output == p.output, f"lanes+budget: N=1 request {r.uid} "
                 "changed its tokens under the budget")
    print(f"    lanes+budget: greedy tokens identical to the unbudgeted "
          f"run {same}/{total} ({same / total:.3f})", flush=True)


def disagg_phase(torch, cfg, params, base, rows, prompt_len, new_tokens,
                 fp32_runs):
    """(b) A prefill-only and a decode-only lane at N=2, 4 rows each, on
    fp32 and int8 pages: phase 4's tokens, no decode on the prefill lane,
    no prefill on the decode lane, every migrated page equal to its source,
    handoffs counted on both sides; the handoff's host time and the
    device time of one row's page copy beside the byte bound."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    from repro_torch.serve.router import LaneSpec
    from repro_torch.serve.telemetry import Telemetry
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    lanes = (LaneSpec(n_mux=2, rows=rows, chunk=32, role="prefill"),
             LaneSpec(n_mux=2, rows=rows, chunk=32, role="decode"))
    for kv in ("fp32", "int8"):
        kind = f"disagg {kv} pages"
        sc = dataclasses.replace(base, kv_dtype=kv)
        tele = Telemetry()
        ops.reset_counts()
        with launches_by_step() as log, checked_handoffs() as moves:
            stats = run_continuous({2: params}, sc, rows, trace, chunk=32,
                                   lanes=lanes, telemetry=tele,
                                   device="cuda")
        torch.cuda.synchronize()
        got = {r.uid: r.output for r in stats["completed"]}
        need(got == fp32_runs[kv]["outputs"], f"{kind}: tokens differ from "
             f"phase 4's single-lane run on {kv} pages")
        pre, dec = stats["lanes"]
        rec = stats["recovery"]
        need(pre["decode_steps"] == 0 and dec["prefill_events"] == 0,
             f"{kind}: prefill lane decoded {pre['decode_steps']} steps, "
             f"decode lane prefilled {dec['prefill_events']} chunks")
        need(rec["handoffs"] == pre["handoffs_out"] == dec["handoffs_in"]
             == len(moves) > 0, f"{kind}: handoffs {rec['handoffs']}, out "
             f"{pre['handoffs_out']}, in {dec['handoffs_in']}, checked "
             f"{len(moves)}")
        need(rec["migrated_kv_bytes"] == pre["migrated_bytes"]
             == sum(b for _, b in moves), f"{kind}: migrated bytes")
        for ls, role_steps in ((pre, (0, pre["prefill_events"])),
                               (dec, (dec["decode_steps"], 0))):
            want = {k: v for k, v in lane_launches(
                cfg.n_layers, 2, *role_steps).items() if v}
            got_l = _sum_launches(log, ls["lane"])
            need(got_l == want, f"{kind}: lane {ls['lane']} "
                 f"({ls['role']}) launches {got_l} != required {want}")
        for pool in stats["pools"]:
            need(pool.n_used_blocks == 0, f"{kind}: a pool did not drain")
            pool.check_invariants()
        hs = sorted(ev[3] / 1e3 for ev in tele.tracer.events
                    if ev[0] == "X" and ev[1] == "handoff")
        blocks, nbytes = moves[0]
        src_rt, dst_rt = stats["runtimes"]
        si = torch.arange(1, blocks + 1, device="cuda")
        di = torch.arange(blocks + 1, 2 * blocks + 1, device="cuda")
        copy_ms = Timer(torch)(lambda: engine.copy_cache_pages(
            src_rt.cache, dst_rt.cache, si, di))
        bound_ms = 2 * nbytes / HBM_BYTES_S * 1e3
        print(f"  {kind}: {len(got)} requests token-identical to phase 4; "
              f"{rec['handoffs']} handoffs ({rec['handoff_streams']} "
              f"streams), every migrated page equal to its source; "
              f"{nbytes} bytes ({blocks} blocks) a handoff; handoff_s p50 "
              f"{statistics.median(hs):.3f} ms host; one row's page copy "
              f"{copy_ms:.4f} ms on the device against a byte bound of "
              f"{bound_ms:.4f} ms (read + write at 3.35 TB/s); lanes "
              f"{[_sum_launches(log, ls['lane']) for ls in (pre, dec)]}",
              flush=True)


def telemetry_phase(torch, cfg, params, base, rows, prompt_len, new_tokens,
                    tempfile):
    """(c) Phase 4's trace with ``Telemetry(snapshot_every=4,
    annotate=True)`` and with telemetry off: the same tokens and the same
    launches step by step; the metrics JSON, the Prometheus text and the
    Chrome trace written and parsed back; one profiled step shows the
    ``record_function`` ranges."""
    import dataclasses
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.runtime import ServeRuntime
    from repro_torch.serve.telemetry import Telemetry
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    sc = dataclasses.replace(base, mux=dataclasses.replace(base.mux, n=2))
    runs = {}
    for on in (True, False):
        tele = Telemetry(snapshot_every=4, annotate=True) if on else None
        with launches_by_step() as log:
            stats = run_continuous(params, sc, rows, trace, chunk=32,
                                   telemetry=tele, device="cuda")
        torch.cuda.synchronize()
        runs[on] = (stats, log, tele)
    (on, log_on, tele), (off, log_off, _) = runs[True], runs[False]
    need({r.uid: r.output for r in on["completed"]}
         == {r.uid: r.output for r in off["completed"]},
         "telemetry: tokens differ with telemetry on")
    need([d for _, d in log_on] == [d for _, d in log_off],
         "telemetry: launches per step differ with telemetry on")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "metrics.json"
        prom = tele.write_metrics(path)
        tele.write_trace(pathlib.Path(tmp) / "trace.json")
        doc = json.loads(path.read_text())
        text = prom.read_text()
        chrome = json.loads((pathlib.Path(tmp) / "trace.json").read_text())
    steps = on["runtime"].engine_steps
    need([s["step"] for s in doc["snapshots"]] == list(range(4, steps + 1, 4)),
         f"telemetry: snapshots at {[s['step'] for s in doc['snapshots']]}")
    samples = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
               for ln in text.splitlines() if not ln.startswith("#")}
    need(samples['repro_tokens_generated{lane="0"}']
         == on["generated_tokens"], "telemetry: .prom tokens_generated")
    spans = [e for e in chrome["traceEvents"]
             if e["ph"] == "X" and e["name"] == "engine_step"]
    need(len(spans) == steps and {e["pid"] for e in spans} == {0},
         f"telemetry: {len(spans)} engine_step spans over {steps} steps")
    need(any(e["ph"] == "M" and e["pid"] == 0 for e in chrome["traceEvents"]),
         "telemetry: no process_name row for lane 0")
    rt = ServeRuntime(params, sc, rows, chunk=32, device="cuda",
                      telemetry=Telemetry(annotate=True))
    rt.submit(Request(uid=0, prompt=list(trace[0][1]), max_new=2))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rt.step()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    need({"engine_step", "admit", "prefill_chunk"} <= names,
         f"telemetry: record_function ranges missing from the profile: "
         f"{sorted(n for n in names if not n.startswith('aten'))[:20]}")
    print(f"  telemetry: tokens and launches per step identical on and off; "
          f"{len(doc['snapshots'])} snapshots, {len(samples)} Prometheus "
          f"samples, {len(chrome['traceEvents'])} trace events "
          f"({len(spans)} engine_step spans = engine steps, pid = lane 0); "
          f"profiled step ranges {sorted(names & {'engine_step', 'admit', 'prefill_chunk', 'decode'})}; "
          f"host wall {on['wall']:.3f} s on, {off['wall']:.3f} s off",
          flush=True)


# ---------------------------------------------------------------------------
# phase 12: logical shards, kill-shard replay and hot snapshot / restore

SHARD_BLOCKS = 34          # 4 rows x 8 blocks of 16 + one trash block a shard
RESTART_KINDS = ("fp32", "bf16", "fp8")


@contextlib.contextmanager
def step_states():
    """Log each ``ServeRuntime.step``'s state as it starts: yields a list
    of (engine step, queued requests, {row: [filled, total]} mid-prefill,
    decoding rows) — the state an event applied before that step sees."""
    from repro_torch.serve import runtime
    log, orig = [], runtime.ServeRuntime.step

    def step(self):
        sched = self.sched
        log.append((self.engine_steps, len(sched.queue),
                    {j: list(v) for j, v in sched.prefill_progress.items()},
                    {j for j in self.row_len
                     if j not in sched.prefill_progress
                     and sched.row_active(j)}))
        orig(self)

    runtime.ServeRuntime.step = step
    try:
        yield log
    finally:
        runtime.ServeRuntime.step = orig


@contextlib.contextmanager
def checked_kill(shard):
    """Wrap ``ServeRuntime.kill_shard``: record the replayed requests'
    prompt plus generated tokens just before the kill, and clone every
    layer's pages of ``shard``'s segment just after it.  Yields a dict the
    caller reads after the run (``tokens``, ``uids``, ``pages``, ``rt``,
    ``blocks``)."""
    from repro_torch.serve import runtime
    got, orig = {}, runtime.ServeRuntime.kill_shard

    def kill_shard(self, s):
        rps = self.nrows // self.sc.n_shards
        reqs = [sl.request for j in range(s * rps, (s + 1) * rps)
                for sl in self.sched.slots[j] if sl.request is not None]
        got["tokens"] = sum(len(r.prompt) + len(r.output) for r in reqs)
        got["uids"] = {r.uid for r in reqs}
        out = orig(self, s)
        bps = self.pool.blocks_per_shard
        got["blocks"] = (s * bps, (s + 1) * bps)
        got["pages"] = [{k: _page_bits(c[k][s * bps:(s + 1) * bps]).clone()
                         for k in ("kp", "vp", "ppos")}
                        for c in self.cache["layers"]]
        got["rt"] = self
        return out

    runtime.ServeRuntime.kill_shard = kill_shard
    try:
        yield got
    finally:
        runtime.ServeRuntime.kill_shard = orig


def _served(kind, stats, trace, new_tokens, n_layers):
    """Every request complete with its tokens, the pool drained, launches
    exactly what chunked serving requires."""
    from repro_torch.kernels import ops
    need(len(stats["completed"]) == len(trace)
         and all(len(r.output) == new_tokens for r in stats["completed"]),
         f"{kind}: a request did not complete with its {new_tokens} tokens")
    pool = stats["runtime"].pool
    need(pool.n_used_blocks == 0, f"{kind}: the pool did not drain")
    pool.check_invariants()
    launches = ops.counts("launches")
    want = paged_launches(launches, n_layers, stats["decode_steps"],
                          stats["prefill_events"])
    need(launches == want, f"{kind}: launch counts {launches} != required "
         f"{want} ({stats['decode_steps']} decode steps, "
         f"{stats['prefill_events']} prefill chunks)")
    return {r.uid: r.output for r in stats["completed"]}, launches


def phase_shards(torch, params, rows, prompt_len, new_tokens, fp32_runs):
    """Phase 12: full-width qwen2-1.5b N=2 in fp32 on phase 4's trace, (a)
    over two logical shards, undisturbed with straggler fencing armed and
    with shard 1 killed at the first step both its rows decode, and (b)
    restarted (snapshot, a fresh runtime, restore) on fp32, bf16 and fp8
    pages, with nothing in flight and mid-prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core import MuxSpec
    from repro_torch.serve import engine
    print(f"phase 12: logical shards, kill-shard replay and hot restart, "
          f"qwen2-1.5b full width N=2 in fp32; {smi_line()}", flush=True)
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-1.5b")
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    base = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=2), dtype=torch.float32,
                              capacity=prompt_len + new_tokens + 8,
                              cache_layout="paged", block_size=16)
    states, chunks = shard_phase(torch, cfg, params, base, rows, trace,
                                 new_tokens, fp32_runs)
    restart_phase(torch, cfg, params, base, rows, trace, new_tokens,
                  fp32_runs, states, chunks)
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s; "
          f"{smi_line()}", flush=True)


def shard_phase(torch, cfg, params, base, rows, trace, new_tokens,
                fp32_runs):
    """(a) ``n_shards=2``: undisturbed (fencing armed, nothing fenced),
    then shard 1 killed: survivors token-identical, the replay's prefill
    tokens the replayed logs', shard 1's pages untouched but its trash
    block.  Returns the undisturbed run's step states and prefill
    chunks."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    sc = dataclasses.replace(base, n_shards=2)
    need(sc.pool_blocks(rows * 2) == SHARD_BLOCKS,
         f"shards: pool of {sc.pool_blocks(rows * 2)} blocks, want "
         f"{SHARD_BLOCKS}")
    ops.reset_counts()
    with step_states() as states:
        stats = run_continuous(params, sc, rows, trace, chunk=32,
                               device="cuda", fence_stragglers=True)
    torch.cuda.synchronize()
    undisturbed, launches = _served("shards", stats, trace, new_tokens,
                                    cfg.n_layers)
    rec = stats["recovery"]
    need(rec["stragglers_fenced"] == 0 and not stats["runtime"].pool.
         dead_shards, f"shards: a shard was fenced ({rec})")
    same = "{}/{}".format(*agreement(undisturbed,
                                     fp32_runs["fp32"]["outputs"]))
    chunks = stats["prefill_events"]
    print(f"  2 shards ({SHARD_BLOCKS} blocks, fencing armed): "
          f"{len(undisturbed)} requests in {stats['wall']:.3f} s, "
          f"{stats['decode_steps']} decode steps, {stats['prefill_events']} "
          f"chunks, launches {launches}; {rec['global_slow_steps']} global "
          f"slow steps, nothing fenced; greedy tokens identical to phase "
          f"4's one-shard fp32 run {same}", flush=True)
    rps = rows // 2
    dead_rows = set(range(rps, 2 * rps))
    kill = next((st for st, _, _, dec in states if dead_rows <= dec), None)
    need(kill is not None, "shards: shard 1's rows never decoded together")
    ops.reset_counts()
    with checked_kill(1) as got:
        stats = run_continuous(params, sc, rows, trace, chunk=32,
                               device="cuda", events=[
                                   {"step": kill, "op": "kill_shard",
                                    "shard": 1}])
    torch.cuda.synchronize()
    killed, launches = _served("kill-shard", stats, trace, new_tokens,
                               cfg.n_layers)
    rec = stats["recovery"]
    need(rec["shards_killed"] == 1 and rec["requests_replayed"]
         == len(got["uids"]) > 0, f"kill-shard: {rec}")
    need(rec["replay_prefill_tokens"] == got["tokens"],
         f"kill-shard: {rec['replay_prefill_tokens']} re-prefill tokens, "
         f"the replayed logs held {got['tokens']}")
    survivors = [u for u in killed if u not in got["uids"]]
    need(survivors and all(killed[u] == undisturbed[u] for u in survivors),
         "kill-shard: a surviving stream changed its tokens")
    rt = got["rt"]
    need(rt is stats["runtime"], "kill-shard: the run changed runtimes")
    lo, hi = got["blocks"]
    for layer, (c, want) in enumerate(zip(rt.cache["layers"], got["pages"])):
        for k, x in want.items():
            now = _page_bits(c[k][lo:hi])
            need(torch.equal(now[1:], x[1:]), f"kill-shard: layer {layer} "
                 f"{k} of the dead segment changed after the kill")
        need(bool((c["ppos"][lo] == -1).all()),
             f"kill-shard: layer {layer}'s trash block holds a position")
    replayed = {u: killed[u] for u in got["uids"]}
    lat = rec["recovery_latency_s"]
    print(f"  kill shard 1 at step {kill}: {len(killed)} requests complete; "
          f"{len(survivors)} survivors token-identical to the undisturbed "
          f"run; {rec['requests_replayed']} streams replayed "
          f"({rec['replay_prefill_tokens']} re-prefill tokens = their "
          f"prompts plus generated tokens), greedy agreement with the "
          f"undisturbed run {'{}/{}'.format(*agreement(replayed, undisturbed))}"
          f"; blocks "
          f"{lo + 1}..{hi - 1} of the dead segment unchanged after the "
          f"kill, its trash block {lo} at position -1; recovery latency "
          f"(host) max {max(lat) * 1e3:.1f} ms over {len(lat)} streams; "
          f"launches {launches}; {smi_line()}", flush=True)
    return states, chunks


@contextlib.contextmanager
def checked_restart(torch, mid_prefill):
    """Wrap ``RecoverySupervisor.snapshot`` / ``restore``: the snapshot is
    taken where asked (nothing queued or mid-prefill, or mid-prefill),
    its write is joined and timed, every cache leaf is cloned; after the
    restore every leaf must equal its clone.  Yields a dict (``bytes``,
    ``save_s``, ``restore_s``, ``prefill_before``, ``remaining``: the
    chunks left of the rows mid-prefill)."""
    from repro_torch.serve import recovery
    got = {}
    Sup = recovery.RecoverySupervisor
    orig_snap, orig_restore = Sup.snapshot, Sup.restore

    def leaves(rt):
        return [{k: _page_bits(x).clone() for k, x in c.items()}
                for c in rt.cache["layers"]]

    def snapshot(self, rt, step):
        sched = rt.sched
        if mid_prefill:
            need(sched.prefill_progress and all(
                0 < f < t for f, t in sched.prefill_progress.values()),
                f"restart: no row mid-prefill at step {step}")
            got["remaining"] = sum(-(-(t - f) // rt.chunk) for f, t in
                                   sched.prefill_progress.values())
        else:
            need(not sched.queue and not sched.prefill_progress,
                 f"restart: work in flight at step {step}")
            got["remaining"] = 0
        got["cache"] = leaves(rt)
        got["prefill_before"] = rt.stats["prefill_events"]
        t0 = time.perf_counter()
        orig_snap(self, rt, step)
        self.ckpt.wait()
        got["save_s"] = time.perf_counter() - t0
        d = pathlib.Path(self.ckpt.directory) / f"step_{step:09d}"
        got["bytes"] = sum(f.stat().st_size for f in d.iterdir())

    def restore(self, rt, step=None):
        out = orig_restore(self, rt, step=step)
        torch.cuda.synchronize()
        got["restore_s"] = self.stats["restore_latency_s"][-1]
        for layer, (c, want) in enumerate(zip(rt.cache["layers"],
                                              got["cache"])):
            for k, x in want.items():
                need(torch.equal(_page_bits(c[k]), x),
                     f"restart: layer {layer} {k} differs after restore")
        need(rt.stats["prefill_events"] == 0, "restart: the fresh runtime "
             "prefilled before serving")
        return out

    Sup.snapshot, Sup.restore = snapshot, restore
    try:
        yield got
    finally:
        Sup.snapshot, Sup.restore = orig_snap, orig_restore


def restart_phase(torch, cfg, params, base, rows, trace, new_tokens,
                  fp32_runs, states, chunks):
    """(b) ``n_shards=1``: a restart at the first step with nothing queued
    or mid-prefill (read from (a)'s undisturbed run, whose admissions
    follow the same timeline), on fp32, bf16 and fp8 pages: every
    restored leaf equal to the captured one, no prefill after the
    restore, phase 4's tokens on that storage; then one fp32 restart
    mid-prefill that finishes only the remaining chunks (the run's chunks
    those of an undisturbed run, ``chunks``)."""
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    idle = next((st for st, q, pre, dec in states if st and not q
                 and not pre and dec), None)
    mid = next((st for st, _, pre, _ in states
                if pre and all(0 < f < t for f, t in pre.values())), None)
    need(idle is not None and mid is not None,
         "restart: the trace never reached the snapshot points")
    cases = [(kind, idle, False) for kind in RESTART_KINDS] + [
        ("fp32", mid, True)]
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    for kind, step, mid_prefill in cases:
        sc = dataclasses.replace(base, kv_dtype=kind)
        label = f"restart {kind} pages at step {step}" + (
            " (mid-prefill)" if mid_prefill else "")
        ops.reset_counts()
        with tempfile.TemporaryDirectory(dir=build) as d, \
                checked_restart(torch, mid_prefill) as got:
            stats = run_continuous(params, sc, rows, trace, chunk=32,
                                   device="cuda", ckpt_dir=d, events=[
                                       {"step": step, "op": "restart"}])
            torch.cuda.synchronize()
        out, launches = _served(label, stats, trace, new_tokens,
                                cfg.n_layers)
        rec = stats["recovery"]
        need(rec["snapshots"] == rec["restarts"] == 1, f"{label}: {rec}")
        after = stats["prefill_events"] - got["prefill_before"]
        need(stats["prefill_events"] == chunks
             and (mid_prefill or after == 0),
             f"{label}: {after} prefill chunks after the restore, "
             f"{stats['prefill_events']} in all; an undisturbed run "
             f"prefills {chunks}")
        need(out == fp32_runs[kind]["outputs"], f"{label}: tokens differ "
             f"from phase 4's run on {kind} pages")
        print(f"  {label}: every restored leaf equal to the captured one, "
              f"{after} prefill chunks after the restore ({got['remaining']} "
              f"left of the rows mid-prefill), {chunks} in all as "
              f"undisturbed; tokens identical to phase 4's; snapshot {got['bytes']} bytes, save "
              f"{got['save_s'] * 1e3:.1f} ms (host, write joined), restore "
              f"{got['restore_s'] * 1e3:.1f} ms (host); launches "
              f"{launches}; {smi_line()}", flush=True)


# phase 13: training.  (a) the launcher: retrieval warm-up, then MLM for
# --steps; its one cosine schedule spans --steps while the optimizer's
# count runs on through both stages (the reference's launcher), so MLM
# learns over its first --steps - --warmup-steps steps and runs the rest
# at lr 0.  One step's MLM loss varies by ~0.05 from batch to batch at
# full width (measured on an H100), more than 20 steps move it: the
# check holds the mean of the last LOSS_WINDOW steps (the final weights,
# at lr 0) below the mean of the first LOSS_WINDOW
TRAIN_ARGS = ("--model", "mux-bert-base", "--mux-n", "2", "--batch", "32",
              "--seq", "128", "--warmup-steps", "20", "--steps", "100")
LOSS_WINDOW = 10
# (b) one retrieval step on the card against the same step on the CPU (fp32,
# TF32 off): loss and grad norm relative, every gradient against the
# tree's largest |grad|, every updated param absolute (1e-3 of the lr,
# 1e-3).  AdamW's first step moves an element by lr * g / (|g| + eps):
# where g is within the two devices' summation noise (a key bias's, zero
# in exact arithmetic) its sign, and so the move, may differ (by up to
# 2 lr).  Above GRAD_BAND of the largest |grad|, the gradient tolerance
# itself, the gradient check fixes each sign and the param tolerance
# holds; within the band the updates are held to NOISE_MOVE, the
# largest difference measured there on an H100 (8.5e-5, over the
# 19.75 M of 89.6 M elements within 1e-4 of the largest) with 3x margin
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-5, "grad": 1e-5, "param": 1e-6}
GRAD_BAND = STEP_TOL["grad"]
NOISE_MOVE = 2.5e-4
STEP_LR = 1e-3
# (c) full-width qwen2-1.5b causal LM: 4 x 256 instance tokens at N=2,
# three AdamW steps, remat on and off from the same seeded weights; the
# same kernels in the same order, so losses and grad norms agree to
# within LM_REMAT_TOL relative
LM_TRAIN = {"batch": 4, "seq": 256, "steps": 3, "lr": 1e-4}
LM_REMAT_TOL = 1e-6


def phase_train(torch):
    """Phase 13: training on the card, the plain model path (no kernel has
    a backward): (a) ``python -m repro_torch.launch.train`` at full-width
    mux-bert-base through ``main``, (b) one step against the CPU's, (c)
    full-width qwen2-1.5b with remat on and off, (d) the kernels refuse
    the trained weights under autograd and serve them under no_grad."""
    print(f"phase 13: training, the plain model path; {smi_line()}",
          flush=True)
    t0 = time.perf_counter()
    out = train_launcher(torch)
    train_step_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    train_lm_remat(torch)
    serve_trained(torch, out)
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s; {smi_line()}",
          flush=True)


def train_launcher(torch):
    """(a): the launcher's two stages at full width with launch counts set
    to 0 before and read after (training launches no kernel); retrieval
    accuracy must rise over the warm-up and the MLM loss fall (windows of
    LOSS_WINDOW steps).  Returns the launcher's ``out``."""
    import shutil
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = [*TRAIN_ARGS, "--ckpt", str(ckpt), "--device", "cuda"]
    print(f"  (a) python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    out = {}
    need(train_cli.main(argv, out=out) == 0, "the train launcher failed")
    torch.cuda.synchronize()
    launched = {k: v for k, v in ops.counts().items() if v}
    need(not launched, f"training launched kernels {launched}")
    peak = torch.cuda.max_memory_allocated()
    saved = sorted(p.name for p in ckpt.iterdir())
    shutil.rmtree(ckpt)
    batch = int(TRAIN_ARGS[TRAIN_ARGS.index("--batch") + 1])
    for st in out["stages"]:
        hist = [h for h in st["history"] if "loss" in h]
        need(len(hist) == st["steps"], f"{st['stage']}: {len(hist)} steps")
        loss = [float(h["loss"]) for h in hist]
        need(all(map(math.isfinite, loss)), f"{st['stage']}: loss not finite")
        ms = statistics.median(st["step_ms"][1:])
        extra = ""
        if st["stage"] == "retrieval-warmup":
            acc = [float(h["retrieval_acc"]) for h in hist]
            need(acc[-1] > acc[0], f"retrieval accuracy did not rise: {acc}")
            extra = f", retrieval accuracy {acc[0]:.4f} -> {acc[-1]:.4f}"
        else:
            first, last = (statistics.mean(loss[:LOSS_WINDOW]),
                           statistics.mean(loss[-LOSS_WINDOW:]))
            need(last < first, f"MLM loss did not fall: {loss}")
            extra = (f", mean of the first / last {LOSS_WINDOW} steps "
                     f"{first:.4f} / {last:.4f}")
        print(f"  {st['stage']}: {st['steps']} steps, loss {loss[0]:.4f} -> "
              f"{loss[-1]:.4f}{extra}; {ms:.2f} ms/step (median CUDA "
              f"events, first step {st['step_ms'][0]:.1f} ms), "
              f"{batch / ms * 1e3:.1f} trained instances/s; "
              f"{smi_line()}", flush=True)
    print(f"  (a) peak {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); checkpoints {saved}; no "
          f"kernel launched", flush=True)
    return out


class _Capture:
    """An optimizer that keeps the gradients it is handed."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, grads, state, params):
        self.grads = grads
        return self.opt.update(grads, state, params)


def train_step_vs_cpu(torch):
    """(b): full-width mux-bert-base (the launcher's vocabulary 512, seeded
    on the CPU and copied to the card), one retrieval-stage AdamW step on
    32 instances of 128 tokens on each device, held within STEP_TOL."""
    import numpy as np
    from repro_torch.core import MuxSpec
    from repro_torch.data import MarkovCorpus
    from repro_torch.models import MuxBERT, bert_config
    from repro_torch.optim import AdamW, reference_leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.mux_stages import retrieval_stage
    cfg = bert_config("base", vocab_size=512, max_seq_len=128)
    mux = MuxSpec(n=2)
    toks = MarkovCorpus(512, seed=0).sample(np.random.default_rng(0), 32, 128)
    cpu = MuxBERT.init(torch.Generator().manual_seed(0), cfg, mux)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = _to(cpu, dev)
        opt = _Capture(AdamW(lr=STEP_LR))
        step = make_train_step(retrieval_stage(cfg, mux), opt)
        t0 = time.perf_counter()
        p, state, m = step(p, opt.opt.init(p), {"tokens": torch.as_tensor(
            toks, device=dev)}, torch.Generator(dev).manual_seed(0))
        runs[dev] = {"loss": float(m["loss"]),
                     "norm": float(m["grad_norm"]), "params": p,
                     "grads": opt.grads, "state": state, "step": step,
                     "s": time.perf_counter() - t0}
    c, g = runs["cpu"], runs["cuda"]
    errs = {k: abs(g[k] - c[k]) / abs(c[k]) for k in ("loss", "norm")}
    pairs = reference_leaves(c["grads"], g["grads"])
    gmax = max(float(a.abs().max()) for _, _, a, _ in pairs)
    gerr = max(float((b.cpu() - a).abs().max()) for _, _, a, b in pairs)
    # the elements within 10 GRAD_BAND (the band this check had before,
    # 1e-4 of the largest) but above GRAD_BAND are read out on their own
    perr, nerr, serr, n_band, n_shell, n = 0.0, 0.0, 0.0, 0, 0, 0
    for (path, _, a, b), (_, _, ga, _) in zip(
            reference_leaves(c["params"], g["params"]), pairs):
        d = (b.detach().cpu() - a.detach()).abs()
        band = ga.abs() <= GRAD_BAND * gmax
        shell = ~band & (ga.abs() <= 10 * GRAD_BAND * gmax)
        if (~band).any():
            perr = max(perr, float(d[~band].max()))
        if band.any():
            nerr = max(nerr, float(d[band].max()))
        if shell.any():
            serr = max(serr, float(d[shell].max()))
        n_band += int(band.sum())
        n_shell += int(shell.sum())
        n += d.numel()
    print(f"  (b) one retrieval step, mux-bert-base N=2, 32 x 128, cuda vs "
          f"cpu: loss {c['loss']:.6f} rel err {errs['loss']:.2e}, grad norm "
          f"{c['norm']:.6f} rel err {errs['norm']:.2e}, grads max err "
          f"{gerr / gmax:.2e} of max |grad| {gmax:.3e}; updated params max "
          f"err {perr:.2e} (tol {STEP_TOL['param']:g}) where |grad| > "
          f"{GRAD_BAND:g} of the max ({serr:.2e} over the {n_shell} "
          f"elements up to {10 * GRAD_BAND:g}), {nerr:.2e} (tol "
          f"{NOISE_MOVE:g}, lr {STEP_LR:g}) over the {n_band} of {n} "
          f"elements within it (AdamW's first step takes the sign of "
          f"their noise); cpu {c['s']:.1f} s, cuda {g['s']:.2f} s; "
          f"{smi_line()}", flush=True)
    need(perr <= STEP_TOL["param"], "(b) an update differs where the "
         "gradient is resolved")
    need(nerr <= NOISE_MOVE, "(b) an update within the gradient's noise "
         "band differs by more than measured")
    need(errs["loss"] <= STEP_TOL["loss"], "(b) loss differs")
    need(errs["norm"] <= STEP_TOL["grad_norm"], "(b) grad norm differs")
    need(gerr <= STEP_TOL["grad"] * gmax, "(b) gradients differ")
    profile_train_step(torch, g, toks)


TRAIN_GROUPS = {"matmul": ("gemm", "cutlass", "xmma", "sm90_"),
                "softmax": ("softmax",), "reduce": ("reduce",),
                "elementwise": ("elementwise", "vectorized", "unrolled")}


def profile_train_step(torch, run, toks):
    """Where (b)'s card step spends its time: two more steps timed on the
    host (ending in a synchronize), then two under ``torch.profiler``:
    device busy, idle share and device time by kernel group."""
    from repro_torch.launch import profile_step
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}

    def one():
        run["step"](run["params"], run["state"], batch,
                    torch.Generator("cuda").manual_seed(1))
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace, prof_wall = profile_step.profile_calls(one, 2)
    profile_step.summarize("  (b) retrieval step on the card, profiled",
                           trace, 2, wall, prof_wall, 6, TRAIN_GROUPS)
    print(f"  {smi_line()}", flush=True)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.detach().to(dev, copy=True)


def train_lm_remat(torch):
    """(c): full-width qwen2-1.5b, seeded tokens straight to
    ``make_train_step`` (``MarkovCorpus`` cannot be built at its
    vocabulary), three AdamW steps with remat on and off from the same
    seeded weights: losses and grad norms within LM_REMAT_TOL, ms per step
    and the peak memory of each printed."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import MuxSpec
    from repro_torch.models import TransformerLM
    from repro_torch.optim import AdamW
    from repro_torch.train import causal_lm_loss, make_train_step
    cfg = get_config("qwen2-1.5b")
    mux = MuxSpec(n=2)
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        4, cfg.vocab_size, (LM_TRAIN["batch"], LM_TRAIN["seq"])),
        device="cuda")
    runs = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = TransformerLM.init(
            torch.Generator(device="cuda").manual_seed(0), c, mux)
        opt = AdamW(lr=LM_TRAIN["lr"])
        state = opt.init(params)

        def loss_fn(p, batch, generator, c=c):
            logits = TransformerLM.apply(p, c, batch["tokens"], mux=mux,
                                         dtype=torch.float32,
                                         use_kernels=False)["logits"]
            return causal_lm_loss(logits, batch["tokens"]), {}
        step = make_train_step(loss_fn, opt)
        r = {"loss": [], "norm": [], "ms": []}
        for i in range(LM_TRAIN["steps"]):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            params, state, m = step(params, state, {"tokens": toks},
                                    torch.Generator("cuda").manual_seed(i))
            b.record()
            b.synchronize()
            r["ms"].append(a.elapsed_time(b))
            r["loss"].append(float(m["loss"]))
            r["norm"].append(float(m["grad_norm"]))
        r["peak"] = torch.cuda.max_memory_allocated()
        need(all(map(math.isfinite, r["loss"] + r["norm"])),
             f"qwen2-1.5b remat={remat}: not finite")
        runs[remat] = r
        del params, state, step
        print(f"  (c) qwen2-1.5b full width, remat={remat}: "
              f"{LM_TRAIN['batch']} x {LM_TRAIN['seq']} at N=2, loss "
              + " -> ".join(f"{x:.6f}" for x in r["loss"])
              + ", grad norm " + ", ".join(f"{x:.4f}" for x in r["norm"])
              + ", ms/step " + ", ".join(f"{x:.1f}" for x in r["ms"])
              + f" (CUDA events); peak {r['peak'] / 2**30:.2f} GiB; "
              f"{smi_line()}", flush=True)
    on, off = runs[True], runs[False]
    err = max(abs(a - b) / abs(b) for k in ("loss", "norm")
              for a, b in zip(on[k], off[k]))
    print(f"  (c) remat on vs off: worst relative difference of losses and "
          f"grad norms {err:.2e} (tol {LM_REMAT_TOL:g}); peak "
          f"{on['peak'] / 2**30:.2f} vs {off['peak'] / 2**30:.2f} GiB",
          flush=True)
    need(err <= LM_REMAT_TOL, "(c) remat changes the training step")
    need(on["loss"][-1] < on["loss"][0], "(c) the LM loss did not fall")


def serve_trained(torch, out):
    """(d): the trained mux-bert-base of (a), whose params require grad:
    the kernel path refuses them under autograd; under ``torch.no_grad()``
    ``mlm_logits`` goes through the fused entry, flash attention (once a
    layer) and the fused exit, launch counts exact, within LOGIT_TOL of
    the plain path."""
    import numpy as np
    from repro_torch.data import MarkovCorpus
    from repro_torch.kernels import ops
    from repro_torch.models import MuxBERT
    p, cfg, mux = out["params"], out["cfg"], out["mux"]
    kcfg = cfg.replace(attn_impl="flash")
    toks = torch.as_tensor(MarkovCorpus(cfg.vocab_size, seed=1).sample(
        np.random.default_rng(1), 32, cfg.max_seq_len), device="cuda")
    need(all(t.requires_grad for t in _leaves(p)),
         "the trained params should require grad")
    ops.reset_counts()
    refused = None
    try:
        MuxBERT.mlm_logits(p, kcfg, toks, mux=mux, use_kernels=True)
    except RuntimeError as e:
        refused = str(e)
    need(refused is not None and "no backward" in refused,
         "the kernel path took params that require grad under autograd")
    need(not any(ops.counts().values()), "a refused call launched")
    with torch.no_grad():
        ops.reset_counts()
        k = MuxBERT.mlm_logits(p, kcfg, toks, mux=mux, use_kernels=True)
        torch.cuda.synchronize()
        got = ops.counts()
        pl = MuxBERT.mlm_logits(p, cfg, toks, mux=mux, use_kernels=False)
    want = {w: 0 for w in got}
    want.update(mux_embed_combine=1, flash_attention=cfg.n_layers,
                demux_rsa=1)
    need(got == want, f"(d) launches {got}, want {want}")
    err = (k - pl).abs().max().item()
    share = (k.argmax(-1) == pl.argmax(-1)).float().mean().item()
    print(f"  (d) under autograd the kernel path refuses the trained "
          f"weights ({refused.split(';')[0]}); under no_grad mlm_logits on "
          f"32 x {cfg.max_seq_len}: launches {got}; kernel vs plain path "
          f"max_abs_err {err:.3e} (tol {LOGIT_TOL:g}), argmax identical "
          f"{share:.5f}; {smi_line()}", flush=True)
    need(err <= LOGIT_TOL, "(d) kernel path disagrees with the plain path")
    need(share >= ARGMAX_SHARE, f"(d) argmax identical at {share}")


# phase 14: the MoE LMs at full width
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")
MOE_TAGS = {"granite-moe-3b-a800m": "granite", "qwen2-moe-a2.7b": "qwen2-moe"}
# phase 3's rows at phase 14's shapes: the wrapper, the architecture and
# the phase-14 run whose launches the JSON reports
MOE_ROWS = {
    **{f"{w}[{tag}{sfx}]": (w, arch, run)
       for arch, tag in MOE_TAGS.items()
       for sfx, run in (("", "fp32"), (", bf16 q, bf16", "bf16"))
       for w in ("paged_attention", "paged_prefill_attention")},
    "mux_embed_combine[granite]": ("mux_embed_combine",
                                   "granite-moe-3b-a800m", "fp32"),
}
# the MoE dispatch's kernels in a profiled step (lower-case name
# substrings): its sorts, gathers, scatters and searchsorted; the expert
# products are matmuls, as the attention projections are
MOE_DISPATCH = ("sort", "gather", "scatter", "searchsorted")
MOE_TRAIN = {"batch": 2, "seq": 128, "lr": 1e-4}


def moe_kernels(torch, timer, record, pool, sdpa, store, decode_case,
                prefill_case):
    """Phase 3's rows at phase 14's shapes, read from the configs: both
    paged kernels at granite-moe-3b-a800m's heads (24 over 8 of 64) and
    qwen2-moe-a2.7b's (16 over 16 of 128) at phase 4's decode rows and
    32-token chunk, in fp32 (within ATT_TOL of the plain version) and with
    a bf16 q over bf16 pages (within one bf16 ulp of the row max), and the
    fused entry at granite's vocabulary 49155 and d 1536 (T 4 and 32).
    Each timed beside its library call and its bound."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import mux_embed as km
    from repro_torch.kernels import paged_attention as kp
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rng = np.random.default_rng(37)     # phase 3's other rows keep theirs

    def t(x):
        return torch.as_tensor(x, device=dev)

    case, lens, qpos, mb, p = decode_case
    pcase, plens, qs, ql, lq, pmb, pp_ = prefill_case
    for arch, tag in MOE_TAGS.items():
        cfg = get_config(arch)
        h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        heads = f"{arch}: {h} over {hkv} of {dh}"
        for kind in ("fp32", "bf16"):
            sfx = "" if kind == "fp32" else ", bf16 q, bf16"
            dt = torch.float32 if kind == "fp32" else bf

            def check(name, what, got, want, timing):
                if kind == "fp32":
                    record(name, what, (got - want).abs().max().item(),
                           ATT_TOL, timing)
                else:
                    err, share = bf16_share(got, want, 1)
                    record(name, what, err, "1 bf16 ulp of the row max",
                           timing, share=share)
            k_p, v_p, bt, pp = pool(lens, P=p, MB=mb, hkv=hkv, dh=dh)
            kq, vq, _ = (k_p, v_p, {}) if kind == "fp32" else store(
                kind, k_p, v_p)
            q = t(rng.standard_normal((len(lens), 1, h, dh),
                                      np.float32)).to(dt)
            qp = t(np.asarray(qpos, np.int32))
            nb, fl, work = attn_bytes_flops(q, bt, pp, qp[:, None], hkv, dh,
                                            elem=kq.element_size())
            bms, by = (bound(nb, fl) if kind == "fp32"
                       else bound(nb, fl // 2, fl // 2))
            check(f"paged_attention[{tag}{sfx}]", f"{case}; {heads}",
                  kp.paged_attention_cuda(q, kq, vq, bt, pp, qp),
                  ref.paged_attention_ref(q, kq, vq, bt, pp, qp), {
                      "work": work,
                      "ms": timer(lambda: kp.paged_attention_cuda(
                          q, kq, vq, bt, pp, qp)),
                      "plain_ms": timer(lambda: ref.paged_attention_ref(
                          q, kq, vq, bt, pp, qp)),
                      "library_ms": timer(lambda: sdpa(q, kq, vq, bt, pp,
                                                       qp[:, None])),
                      "bound_ms": bms, "bound_by": by, "bytes": nb,
                      "flops": fl})

            k_p, v_p, bt, pp = pool(plens, P=pp_, MB=pmb, hkv=hkv, dh=dh)
            kq, vq, _ = (k_p, v_p, {}) if kind == "fp32" else store(
                kind, k_p, v_p)
            q = t(rng.standard_normal((len(plens), lq, h, dh),
                                      np.float32)).to(dt)
            qs_t = t(np.asarray(qs, np.int32))
            ql_t = t(np.asarray(ql, np.int32))
            li = torch.arange(lq, device=dev)[None]
            qrows = qs_t[:, None] + li
            masked = (li >= ql_t[:, None]) | (qs_t[:, None] < 0)
            nb, fl, work = attn_bytes_flops(
                q, bt, pp, torch.where(masked, -1, qrows), hkv, dh,
                elem=kq.element_size())
            bms, by = (bound(nb, fl) if kind == "fp32"
                       else bound(nb, fl // 2, fl // 2))
            check(f"paged_prefill_attention[{tag}{sfx}]", f"{pcase}; {heads}",
                  kp.paged_prefill_attention_cuda(q, kq, vq, bt, pp, qs_t,
                                                  ql_t),
                  ref.paged_prefill_attention_ref(q, kq, vq, bt, pp, qs_t,
                                                  ql_t), {
                      "work": work,
                      "ms": timer(lambda: kp.paged_prefill_attention_cuda(
                          q, kq, vq, bt, pp, qs_t, ql_t)),
                      "plain_ms": timer(
                          lambda: ref.paged_prefill_attention_ref(
                              q, kq, vq, bt, pp, qs_t, ql_t)),
                      "library_ms": timer(lambda: sdpa(q, kq, vq, bt, pp,
                                                       qrows)),
                      "bound_ms": bms, "bound_by": by, "bytes": nb,
                      "flops": fl})

    # granite's fused entry: vocabulary 49155, d 1536, no embedding scale
    g = get_config("granite-moe-3b-a800m")
    d, vocab = g.d_model, g.vocab_size
    emb = t(rng.standard_normal((vocab, d), np.float32) * 0.02)
    v = t(rng.standard_normal((2, d), np.float32))
    for tt in (4, 32):
        tok = t(rng.integers(0, vocab, (2, tt)).astype(np.int32))
        tl = tok.long()
        got = km.mux_embed_combine_cuda(tok, emb, v)
        nb = embed_bytes(tok, d, 4)
        bms, by = bound(nb, 3 * 2 * tt * d)
        record("mux_embed_combine[granite]", f"granite: T={tt} V {vocab} "
               f"d {d}", (got - ref.mux_embed_ref(tok, emb, v)).abs().max()
               .item(), MUX_TOL, {
                   "ms": timer(lambda: km.mux_embed_combine_cuda(tok, emb,
                                                                 v)),
                   "plain_ms": timer(lambda: ref.mux_embed_ref(tok, emb, v)),
                   "library_ms": timer(lambda: torch.einsum(
                       "ntd,nd->td", F.embedding(tl, emb), v) * 0.5),
                   "bound_ms": bms, "bound_by": by, "bytes": nb,
                   "flops": 3 * 2 * tt * d,
                   "work": f"{tok.unique().numel()} distinct table rows of "
                           f"{tok.numel()} gathers"})
    del emb


def moe_log(label, stats, cfg, forwards):
    """Check and print phase 14's MoE record of one run (``blocks.
    record_moe``): one MoE call a layer a forward; the assignments dropped
    past capacity in each prefill event (a forward of one row) and in the
    decode steps, and the load per expert summed over the run."""
    import torch
    need(len(stats) == cfg.n_layers * forwards,
         f"{label}: {len(stats)} MoE calls, want {cfg.n_layers} a forward "
         f"over {forwards} forwards")
    per_fwd = [stats[i:i + cfg.n_layers]
               for i in range(0, len(stats), cfg.n_layers)]
    drops = [int(torch.stack([s["dropped"] for s in f]).sum())
             for f in per_fwd]
    pre = [(f[0]["shape"], n) for f, n in zip(per_fwd, drops)
           if f[0]["shape"][1] > 1]
    dec = sum(n for f, n in zip(per_fwd, drops) if f[0]["shape"][1] == 1)
    load = torch.stack([s["load"] for s in stats]).sum(0).tolist()
    caps = sorted({(s["tokens"], s["cap"]) for s in stats})
    print(f"  {label}: {len(stats)} MoE calls ({cfg.n_layers} a forward, "
          f"{forwards} forwards); capacity by tokens {caps}; dropped "
          f"assignments per prefill event (all layers) "
          f"{[n for _, n in pre]} over shapes "
          f"{sorted({sh for sh, _ in pre})}, in the decode steps {dec}; "
          f"load per expert (assignments over the run) {load}",
          flush=True)


def phase_moe(torch, mux, rows, prompt_len, new_tokens):
    """Phase 14: granite-moe-3b-a800m, then qwen2-moe-a2.7b, full width
    from seeded random weights, on the phase-4 trace.  granite in fp32:
    paged chunked on fp32 and int8 pages, the ring arm, paged blocking
    with ``attn_impl='flash'`` and fill-drain, every request complete,
    launch counts exact and one MoE call a layer a forward (dropped
    assignments per prefill event and the per-expert load printed), then
    the kernel path against the plain path (a chunk's and a decode step's
    logits from identical caches within 2e-3, greedy tokens identical);
    at the default bf16 paged chunked and on the ring (launch counts
    exact, logits against ``kernels_as_plain`` within
    ``BF16_LOGIT_ULPS``, greedy agreement with fp32 printed); one decode
    step twice from the same cache (bit for bit), once under
    ``torch.cuda.set_sync_debug_mode("error")`` and once under the
    profiler; one AdamW step on the plain path (2 x 128 tokens, N=2,
    remat on).  qwen2-moe-a2.7b (53.3 GiB of fp32 weights) paged chunked
    in fp32 then bf16 with the same checks, and the peak memory.  Returns
    {arch: {run: result}}."""
    from repro_torch.configs import get_config
    from repro_torch.models import (TransformerLM, active_param_count,
                                    blocks, param_count)
    from repro_torch.serve import engine
    print(f"phase 14: granite-moe-3b-a800m and qwen2-moe-a2.7b full width; "
          f"{smi_line()}", flush=True)
    t_phase = time.perf_counter()
    out = {}
    for arch in MOE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        m = cfg.moe
        t0 = time.perf_counter()
        params = TransformerLM.init(
            torch.Generator(device="cuda").manual_seed(0), cfg, mux)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in _leaves(params))
        print(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} of "
              f"{cfg.head_dim}, {m.n_experts} experts top {m.top_k} of "
              f"{m.d_expert}, {m.n_shared} shared of {m.d_shared}, "
              f"capacity factor {m.capacity_factor}, vocab "
              f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params "
              f"({param_count(cfg) / 1e9:.3f} B backbone, "
              f"{active_param_count(cfg) / 1e9:.3f} B active) in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
              flush=True)
        trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
        label = f"{MOE_TAGS[arch]} "
        granite = arch == MOE_ARCHS[0]
        runs = {}
        sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                                capacity=prompt_len + new_tokens + 8,
                                cache_layout="paged", block_size=16)
        for kind in ("fp32", "int8") if granite else ("fp32",):
            with blocks.record_moe() as stats:
                runs[kind] = serve_once(
                    params, dataclasses.replace(sc, kv_dtype=kind), rows,
                    trace, new_tokens, ref_bytes=False, label=label)
            moe_log(f"{label}{kind} pages", stats, cfg,
                    runs[kind]["forwards"])
        compare_paths(params, dataclasses.replace(sc, kv_dtype="fp32"), rows,
                      trace, prompt_len, runs["fp32"], identical=True,
                      label=label)
        if granite:
            cfg_flash = cfg.replace(attn_impl="flash")
            for mode in ("ring", "blocking", "fill-drain"):
                with blocks.record_moe() as stats:
                    runs[mode] = serve_dense(params, cfg_flash, mux, rows,
                                             trace, new_tokens, mode,
                                             label=label)
                moe_log(f"{label}{mode}", stats, cfg, runs[mode]["forwards"])
        sc16 = dataclasses.replace(sc, dtype=torch.bfloat16)
        with blocks.record_moe() as stats:
            runs["bf16"] = serve_once(params, sc16, rows, trace, new_tokens,
                                      ref_bytes=False, label=f"{label}bf16 ")
        moe_log(f"{label}bf16 pages", stats, cfg, runs["bf16"]["forwards"])
        bf16_vs_plain(params, sc16, rows, trace, prompt_len, f"{label}bf16 ")
        same, total = agreement(runs["bf16"]["outputs"],
                                runs["fp32"]["outputs"])
        print(f"  {label}bf16 pages: greedy tokens identical to the fp32 "
              f"run: {same}/{total} ({same / total:.3f})", flush=True)
        if granite:
            runs["ring, bf16"] = serve_dense(params, cfg, mux, rows, trace,
                                             new_tokens, "ring",
                                             label=f"{label}bf16 ",
                                             dtype=torch.bfloat16)
            bf16_ring_vs_plain(params, cfg, mux, rows, trace, new_tokens,
                               f"{label}bf16 ")
            moe_decode_checks(torch, params, sc, rows, trace, label)
            moe_train_step(torch, params, cfg, mux)
        out[arch] = runs
        print(f"  {arch}: torch.cuda.max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{smi_line()}", flush=True)
        del params
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s; "
          f"{smi_line()}", flush=True)
    return out


def moe_decode_checks(torch, params, sc, rows, trace, label):
    """Phase 14 on one granite decode step of every row (each row's first
    32 prompt tokens prefilled): the step twice from copies of one cache,
    bit for bit; once more under ``set_sync_debug_mode("error")`` (the
    dispatch makes no host sync); then its host wall time over 5 steps and
    one step under ``torch.profiler``: device busy, idle share, kernels
    and device time by group (``profile_step.STEP_GROUPS`` and "moe
    dispatch", ``MOE_DISPATCH``)."""
    from repro_torch.launch import profile_step
    from repro_torch.serve import engine
    cache = engine.init_cache(sc, 2 * rows, device="cuda")
    pool = engine.make_pool(sc, 2 * rows)
    for j in range(rows):
        pool.allocate(j, 64)
    engine.set_block_tables(cache, pool.table_array(range(rows)))
    for j in range(rows):
        toks = torch.as_tensor(trace[2 * j][1][:32],
                               device="cuda").repeat(2, 1)
        engine.prefill_chunk(params, sc, cache, toks, rows=[j], start=0,
                             length=32)
    dtok = torch.as_tensor([[int(trace[j % len(trace)][1][32])]
                            for j in range(2 * rows)], device="cuda")
    pos = torch.full((rows,), 32, dtype=torch.int32, device="cuda")
    twins = [clone_pages(cache) for _ in range(3)]
    a = engine.decode_step(params, sc, twins[0], dtok, pos)[0]
    b = engine.decode_step(params, sc, twins[1], dtok, pos)[0]
    torch.cuda.synchronize()
    need(torch.equal(a, b), f"{label}decode step: a repeat from the same "
         "cache changed the logits' bits")
    torch.cuda.set_sync_debug_mode("error")
    try:
        c = engine.decode_step(params, sc, twins[2], dtok, pos)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    need(torch.equal(a, c), f"{label}decode step under sync debug differs")
    print(f"  {label}decode step ({rows} rows at 32): bit for bit over two "
          f"calls from one cache; a third under set_sync_debug_mode('error') "
          f"made no host sync and gave the same bits", flush=True)

    def step():
        engine.decode_step(params, sc, cache, dtok, pos)
    step()
    wall = profile_step.wall_time(step, 5)
    trace_, prof_wall = profile_step.profile_calls(step, 1)
    profile_step.summarize(f"  {label}fp32 decode step, profiled", trace_, 1,
                           wall / 5, prof_wall, 8,
                           {"moe dispatch": MOE_DISPATCH,
                            **profile_step.STEP_GROUPS})
    print(f"  {smi_line()}", flush=True)


def moe_train_step(torch, params, cfg, mux):
    """Phase 14: one AdamW step of full-width granite-moe on the plain
    model path from phase 14's weights: seeded 2 x 128 tokens at N=2,
    remat on, the causal-LM loss plus ``router_aux_weight * aux`` (the
    launcher's); loss, aux and grad norm finite; ms (CUDA events) and the
    peak memory (params, grads and both moments) printed."""
    import numpy as np
    from repro_torch.models import TransformerLM
    from repro_torch.optim import AdamW
    from repro_torch.train import causal_lm_loss, make_train_step
    c = cfg.replace(remat=True)
    toks = torch.as_tensor(np.random.default_rng(17).integers(
        4, c.vocab_size, (MOE_TRAIN["batch"], MOE_TRAIN["seq"])),
        device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(lr=MOE_TRAIN["lr"])
    state = opt.init(params)

    def loss_fn(p, batch, generator):
        out = TransformerLM.apply(p, c, batch["tokens"], mux=mux,
                                  dtype=torch.float32, use_kernels=False)
        xent = causal_lm_loss(out["logits"], batch["tokens"])
        return (xent + c.moe.router_aux_weight * out["aux"],
                {"xent": xent.detach(), "aux": out["aux"].detach()})
    step = make_train_step(loss_fn, opt)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    _, state, met = step(params, state, {"tokens": toks},
                         torch.Generator("cuda").manual_seed(0))
    b.record()
    b.synchronize()
    vals = {k: float(met[k]) for k in ("loss", "xent", "aux", "grad_norm")}
    peak = torch.cuda.max_memory_allocated()
    print(f"  {cfg.name} AdamW step on the plain path: "
          f"{MOE_TRAIN['batch']} x {MOE_TRAIN['seq']} at N=2, remat on: "
          + ", ".join(f"{k} {v:.6f}" for k, v in vals.items())
          + f"; {a.elapsed_time(b):.1f} ms (CUDA events); peak "
          f"{peak / 2**30:.2f} GiB; {smi_line()}", flush=True)
    need(all(map(math.isfinite, vals.values())),
         f"{cfg.name} training step: not finite {vals}")
    del state
    for t in _leaves(params):
        t.requires_grad_(False)


# ---------------------------------------------------------------------------
# phase 15: the hybrid family, recurrentgemma-9b at full width
HYBRID = "recurrentgemma-9b"
# the long request: a prompt past the local window of 2048, one backbone
# row (the prefill's logits at every position are 2.1 GiB a stream)
HYBRID_LONG_PROMPT, HYBRID_LONG_NEW = 2200, 16
# phase 3's rows at phase 15's shapes: the wrapper and the phase-15 run
# whose launches the JSON reports
HYBRID_ROWS = {
    "decode_attention[rg-9b]": ("decode_attention", "ring"),
    "decode_attention[rg-9b, C 2048]": ("decode_attention", "long"),
    "decode_attention[rg-9b, bf16]": ("decode_attention", "ring, bf16"),
    "decode_attention[rg-9b, C 2048, bf16]": ("decode_attention",
                                              "long, bf16"),
    "flash_attention[rg-9b]": ("flash_attention", "ring"),
    "flash_attention[rg-9b, L 2200]": ("flash_attention", "long"),
    "flash_attention[rg-9b, bf16]": ("flash_attention", "ring, bf16"),
    "flash_attention[rg-9b, L 2200, bf16]": ("flash_attention", "long, bf16"),
    "demux_rsa[rg-9b]": ("demux_rsa", "ring"),
    "demux_rsa[rg-9b, bf16]": ("demux_rsa", "ring, bf16"),
    "mux_embed_combine[rg-9b]": ("mux_embed_combine", "ring"),
    "mux_combine[rg-9b]": ("mux_combine", "ring"),
}
# a profiled decode step's kernels by group: first by name (matmuls and
# the main path's kernels; ``profile_groups``), then by the
# ``record_function`` range they were launched in (``rglru_ranges``), else
# "other"
HYBRID_RANGES = (("rg-lru conv", "rglru.conv"), ("rg-lru scan", "rglru.scan"),
                 ("rg-lru gates (elementwise)", "rglru"))


def hybrid_kernels(torch, timer, record, ring_pos, visible):
    """Phase 3's rows at phase 15's shapes (``HYBRID_ROWS``), read from
    recurrentgemma-9b's config (16 query heads over 1 KV head of 256, the
    decode kernel's limit; local window 2048; d 4096; vocab 256000), each
    in fp32 (within ATT_TOL / DEMUX_TOL / MUX_TOL of its plain version)
    and, for the attention and the demux, with bf16 operands (within one
    bf16 ulp of the row max, the demux two), bit for bit over two calls
    where a repeat is checked, timed beside its plain version and library
    call with its bound: ``decode_attention`` over the ring arm's B 4, C
    124 at 116 and over the long request's wrapped ring (B 1, C 2048,
    window 2048, at its last decode position); ``flash_attention`` at the
    grid re-prefill's B 4, causal L 116 and the long request's B 1, L 2200
    with window 2048; ``demux_rsa`` with the RMS entry at d 4096, F 8192,
    T 4; the fused entry at V 256000, d 4096, T 4, scaled by sqrt(d); the
    mux-combine entry at the re-prefill's (2, 4 * 116, 4096)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import demux_rsa as kd
    from repro_torch.kernels import flash_attention as kfl
    from repro_torch.kernels import mux_combine as kc
    from repro_torch.kernels import mux_embed as km
    from repro_torch.kernels import ref
    cfg = get_config(HYBRID)
    h, hkv, dh, win = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.local_window)
    d, vocab = cfg.d_model, cfg.vocab_size
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rng = np.random.default_rng(43)     # phase 3's other rows keep theirs
    heads = f"{h} over {hkv} of {dh}, window {win}"

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s).astype(
            np.float32), device=dev)

    def timed(kernel, plain, library, nb, fl, bf16_fl=0, work=None):
        bms, by = bound(nb, fl, bf16_fl)
        return {**({"work": work} if work else {}), "ms": timer(kernel),
                "plain_ms": timer(plain), "library_ms": timer(library),
                "bound_ms": bms, "bound_by": by, "bytes": nb,
                "flops": fl + bf16_fl}

    def check(name, case, got, want, tol, timing):
        if got.dtype == torch.float32:
            record(name, case, (got - want).abs().max().item(), tol, timing)
        else:
            err, share = bf16_share(got, want, 1)
            record(name, case, err, "1 bf16 ulp of the row max", timing,
                   share=share)

    last = HYBRID_LONG_PROMPT + HYBRID_LONG_NEW - 2  # the last decode's q_pos
    for sfx, dt in (("", torch.float32), (", bf16", bf)):
        # the ring decode: the ring arm's rows, the long request's row
        for tag, b, c, q_pos in (("", 4, 124, 116), (", C 2048", 1, win,
                                                     last)):
            q = r(b, 1, h, dh).to(dt)
            kc_, vc_ = r(b, c, hkv, dh).to(dt), r(b, c, hkv, dh).to(dt)
            pos = ring_pos(c, q_pos + 1)
            kw = dict(q_pos=q_pos, window=win)
            got = kdec.decode_attention_cuda(q, kc_, vc_, pos, **kw)
            need(torch.equal(kdec.decode_attention_cuda(q, kc_, vc_, pos,
                                                        **kw), got),
                 f"decode_attention[rg-9b{tag}{sfx}]: a repeat changed "
                 "the bits")
            vis = visible(torch.full((1,), q_pos, device=dev), pos.long(),
                          True, win, pos >= 0)
            nb, fl, work = dense_bound(q, kc_, vis)
            nb += c * 4                                   # slot positions
            split = (fl, 0) if dt == torch.float32 else (fl // 2, fl // 2)
            check(f"decode_attention[rg-9b{tag}{sfx}]",
                  f"B={b}, C={c} at {q_pos}; {heads}", got,
                  ref.decode_attention_ref(q, kc_, vc_, pos, **kw), ATT_TOL,
                  timed(lambda: kdec.decode_attention_cuda(q, kc_, vc_, pos,
                                                           **kw),
                        lambda: ref.decode_attention_ref(q, kc_, vc_, pos,
                                                         **kw),
                        lambda: sdpa_dense(q, kc_, vc_, vis), nb, *split,
                        work))
        del kc_, vc_
        # flash: the grid re-prefill's rows, the long request's row
        for tag, b, l in (("", 4, 116), (", L 2200", 1, HYBRID_LONG_PROMPT)):
            q = r(b, l, h, dh).to(dt)
            k, v = r(b, l, hkv, dh).to(dt), r(b, l, hkv, dh).to(dt)
            kw = dict(window=win)
            got = kfl.flash_attention_cuda(q, k, v, **kw)
            need(torch.equal(kfl.flash_attention_cuda(q, k, v, **kw), got),
                 f"flash_attention[rg-9b{tag}{sfx}]: a repeat changed the "
                 "bits")
            ar = torch.arange(l, device=dev)
            vis = visible(ar, ar, True, win, torch.ones(l, dtype=torch.bool,
                                                        device=dev))
            nb, fl, work = dense_bound(q, k, vis)
            split = (fl, 0) if dt == torch.float32 else (fl // 2, fl // 2)
            check(f"flash_attention[rg-9b{tag}{sfx}]",
                  f"B={b}, causal L={l}; {heads}", got,
                  ref.flash_attention_ref(q, k, v, **kw), ATT_TOL,
                  timed(lambda: kfl.flash_attention_cuda(q, k, v, **kw),
                        lambda: ref.flash_attention_ref(q, k, v, **kw),
                        lambda: sdpa_dense(q, k, v, vis), nb, *split, work))
        del q, k, v, vis

        # the fused exit: RMS entry, d 4096, F 8192, T 4
        f, n, tt = 2 * d, 2, 4
        w = tuple(x.to(dt) for x in (r(n, d), r(d, f, s=0.02),
                                     r(d, f, s=0.02), r(f, s=0.02),
                                     r(f, d, s=0.02), r(d, s=0.02)))
        norms = {"entry_kind": "rms", "entry_scale": r(d, s=0.1),
                 "exit_scale": 1.0 + r(d, s=0.1), "exit_bias": r(d, s=0.1)}
        x = r(tt, d).to(dt)
        got = kd.demux_rsa_cuda(x, *w, **norms)
        need(torch.equal(kd.demux_rsa_cuda(x, *w, **norms), got),
             f"demux_rsa[rg-9b{sfx}]: a repeat changed the bits")
        want = ref.demux_rsa_fused_ref(x, *w, **norms)
        el = x.element_size()
        nb = ((3 * d * f + f + d + n * d + tt * d + n * tt * d) * el
              + 3 * d * 4)
        fl = 2 * tt * d * f + 2 * n * tt * f * d      # fp32 activations
        kf = 2 * n * d * f                             # k @ W1k

        def library():
            x32 = x.float()
            hn = (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True)
                                    + 1e-6) * (1 + norms["entry_scale"]))
            z = F.gelu(torch.matmul(hn.to(dt), w[1])[None]
                       + (w[0] @ w[2] + w[3])[:, None], approximate="tanh")
            return F.layer_norm(torch.matmul(z, w[4]) + w[5], (d,),
                                norms["exit_scale"].to(dt),
                                norms["exit_bias"].to(dt), eps=1e-6)
        timing = timed(lambda: kd.demux_rsa_cuda(x, *w, **norms),
                       lambda: ref.demux_rsa_fused_ref(x, *w, **norms),
                       library, nb, *((fl + kf, 0) if dt == torch.float32
                                      else (fl, kf)))
        name, case = f"demux_rsa[rg-9b{sfx}]", f"T={tt} d {d} F {f}"
        if dt == torch.float32:
            record(name, case, (got - want).abs().max().item(), DEMUX_TOL,
                   timing)
        else:
            err, share = bf16_share(got, want, 2)
            record(name, case, err, "2 bf16 ulps of the row max", timing,
                   share=share)
        del w

    # the fused entry: vocabulary 256000, d 4096, scaled by sqrt(d), T 4;
    # the 1.05 G-entry table drawn on the card (numpy takes ~15 s for it)
    scale = d ** 0.5
    emb = torch.randn((vocab, d), device=dev, generator=torch.Generator(
        device=dev).manual_seed(43)) * 0.02
    v = r(2, d)
    tok = torch.as_tensor(rng.integers(0, vocab, (2, 4)).astype(np.int32),
                          device=dev)
    tl = tok.long()
    got = km.mux_embed_combine_cuda(tok, emb, v, scale=scale)
    record("mux_embed_combine[rg-9b]", f"T=4 V {vocab} d {d}, x sqrt(d)",
           (got - ref.mux_embed_ref(tok, emb, v, scale=scale)).abs().max()
           .item(), MUX_TOL,
           timed(lambda: km.mux_embed_combine_cuda(tok, emb, v, scale=scale),
                 lambda: ref.mux_embed_ref(tok, emb, v, scale=scale),
                 lambda: torch.einsum("ntd,nd->td",
                                      F.embedding(tl, emb) * scale, v) * 0.5,
                 embed_bytes(tok, d, 4), 3 * 2 * 4 * d,
                 work=f"{tok.unique().numel()} distinct table rows of "
                      f"{tok.numel()} gathers"))
    del emb
    # the mux-combine entry of a grid re-prefill: 4 rows of 116 tokens
    tt = 4 * 116
    x = r(2, tt, d)
    got = kc.mux_combine_cuda(x, v)
    need(torch.equal(got, kc.mux_combine_cuda(x, v)),
         "mux_combine[rg-9b]: a repeat changed the bits")
    record("mux_combine[rg-9b]", f"(2, {tt}, {d})",
           (got - ref.mux_combine_ref(x, v)).abs().max().item(),
           COMBINE_TOL["fp32"],
           timed(lambda: kc.mux_combine_cuda(x, v),
                 lambda: ref.mux_combine_ref(x, v),
                 lambda: torch.einsum("ntd,nd->td", x, v) / 2,
                 (3 * tt * d + 2 * d) * 4, 4 * tt * d))
    del x


def phase_hybrid(torch, mux, rows, prompt_len, new_tokens):
    """Phase 15: full-width recurrentgemma-9b from seeded random weights
    (38 layers: 12 periods of (rglru, rglru, local) and two RG-LRU tail
    layers; 16 query heads over 1 KV head of 256, local window 2048) on
    the phase-4 trace with ``attn_impl='flash'``: the ring arm in fp32,
    fill-drain, and the ring arm in bf16, every request complete and the
    launch counts exact (a ring decode step 12 ``decode_attention``, the
    fused entry and exit once; a grid re-prefill ``mux_combine`` once and
    12 ``flash_attention``; no paged kernel); the kernel path against the
    plain path from identical caches (fp32: the prefill's and a decode
    step's logits within 2e-3 and the ring arm's greedy tokens identical;
    bf16: within ``BF16_LOGIT_ULPS`` of ``kernels_as_plain``, greedy
    agreement with fp32 printed); one 2200-token request past the window
    (``hybrid_long``); one decode step repeated, under sync debug and
    profiled (``hybrid_decode_checks``); the peak memory.  Returns {run:
    serve_dense's result}."""
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, param_count
    print(f"phase 15: {HYBRID} full width; {smi_line()}", flush=True)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HYBRID)
    flash = cfg.replace(attn_impl="flash")
    t0 = time.perf_counter()
    params = TransformerLM.init(
        torch.Generator(device="cuda").manual_seed(0), cfg, mux)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    kinds, pat = cfg.pattern_layers, len(cfg.block_pattern)
    print(f"  {HYBRID}: {cfg.n_layers} layers ({kinds.count('rglru')} "
          f"RG-LRU, {kinds.count('local')} local attention; pattern "
          f"{cfg.block_pattern}, tail {kinds[len(kinds) // pat * pat:]}), d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
          f"{cfg.head_dim}, window {cfg.local_window}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B params "
          f"({param_count(cfg) / 1e9:.3f} B backbone) in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    runs = {mode: serve_dense(params, flash, mux, rows, trace, new_tokens,
                              mode, label="hybrid ")
            for mode in ("ring", "fill-drain")}
    compare_ring_paths(params, flash, mux, rows, trace, new_tokens,
                       runs["ring"], identical=True, label="hybrid ")
    runs["ring, bf16"] = serve_dense(params, flash, mux, rows, trace,
                                     new_tokens, "ring", label="hybrid bf16 ",
                                     dtype=torch.bfloat16)
    print("  hybrid ring, bf16: greedy agreement with the fp32 run %d/%d"
          % agreement(runs["ring, bf16"]["outputs"], runs["ring"]["outputs"]),
          flush=True)
    bf16_rwkv_vs_plain(params, flash, mux, rows, trace, new_tokens,
                       runs["ring, bf16"], label="hybrid")
    runs.update(hybrid_long(torch, params, cfg, mux))
    hybrid_decode_checks(torch, params, flash, mux, rows, trace)
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{smi_line()}", flush=True)
    return runs


def hybrid_long(torch, params, cfg, mux):
    """Phase 15's long request: one seeded prompt of
    ``HYBRID_LONG_PROMPT`` tokens and ``HYBRID_LONG_NEW`` new, one
    backbone row at N=2 (the spare stream duplicates it), in fill-drain
    through the kernels with ``attn_impl='flash'`` in fp32 and bf16
    (launch counts exact: flash over 2200 tokens with window 2048, the
    decode over a full, wrapped 2048-slot ring); the plain path's greedy
    tokens (chunked attention) identical to the fp32 kernel path's; from
    identical caches the prefill's and a decode step's logits within
    2e-3, every local ring wrapped.  Returns {"long": ..., "long, bf16":
    ...}."""
    import numpy as np
    from repro_torch.launch.serve import fill_drain
    from repro_torch.serve import engine
    prompt = np.random.default_rng(47).integers(4, cfg.vocab_size,
                                                HYBRID_LONG_PROMPT)
    new = HYBRID_LONG_NEW
    flash = cfg.replace(attn_impl="flash")
    trace = [(0, prompt, new)]
    out = {"long": serve_dense(params, flash, mux, 1, trace, new,
                               "fill-drain", label="hybrid long "),
           "long, bf16": serve_dense(params, flash, mux, 1, trace, new,
                                     "fill-drain", label="hybrid long bf16 ",
                                     dtype=torch.bfloat16)}
    print("  hybrid long, bf16: greedy agreement with the fp32 run %d/%d"
          % agreement(out["long, bf16"]["outputs"], out["long"]["outputs"]),
          flush=True)
    cap = HYBRID_LONG_PROMPT + new + 8
    sc = engine.ServeConfig(cfg=flash, mux=mux, dtype=torch.float32,
                            capacity=cap)
    sc_plain = dataclasses.replace(sc, cfg=cfg)      # 'auto': chunked here
    plain = fill_drain(params, sc_plain, 1, [prompt], new, use_kernels=False,
                       device="cuda")
    same, total = agreement({r.uid: r.output for r in plain["completed"]},
                            out["long"]["outputs"])
    print(f"  hybrid long: greedy tokens identical, kernel vs plain path "
          f"{same}/{total}", flush=True)
    need(same == total, "hybrid long: the kernel path's greedy tokens "
         "differ from the plain path's")
    toks = torch.as_tensor(prompt, device="cuda").repeat(mux.n, 1)
    cache = engine.init_cache(sc, mux.n, device="cuda")
    plain_cache = engine.init_cache(sc_plain, mux.n, device="cuda")
    lk, _ = engine.prefill(params, sc, cache, toks, use_kernels=True)
    lp, _ = engine.prefill(params, sc_plain, plain_cache, toks,
                           use_kernels=False)
    rings = [c for c, b in zip(cache["layers"], cfg.pattern_layers)
             if b == "local"]
    need(all(c["k"].shape[1] == cfg.local_window
             and int(c["pos"].min()) == HYBRID_LONG_PROMPT - cfg.local_window
             and int(c["pos"].max()) == HYBRID_LONG_PROMPT - 1
             for c in rings), "hybrid long: a local ring did not wrap")
    err_pre = (lk - lp).abs().max().item()
    copy_ring(cache, plain_cache)
    dtok = lk.argmax(-1)[:, None]
    dk, _ = engine.decode_step(params, sc, cache, dtok, HYBRID_LONG_PROMPT)
    dp, _ = engine.decode_step(params, sc_plain, plain_cache, dtok,
                               HYBRID_LONG_PROMPT, use_kernels=False)
    err_dec = (dk - dp).abs().max().item()
    print(f"  hybrid long: {len(rings)} local rings of {cfg.local_window} "
          f"slots wrapped (positions {HYBRID_LONG_PROMPT - cfg.local_window}"
          f"-{HYBRID_LONG_PROMPT - 1}); logits max_abs_err kernel vs plain "
          f"path: prefill {err_pre:.3e}, decode from identical caches "
          f"{err_dec:.3e} (tol {LOGIT_TOL:g}); |logits| max "
          f"{lk.abs().max().item():.3f}", flush=True)
    need(err_pre <= LOGIT_TOL and err_dec <= LOGIT_TOL,
         "hybrid long: kernel path disagrees with the plain path")
    return out


@contextlib.contextmanager
def rglru_ranges():
    """``torch.profiler.record_function`` ranges around every RG-LRU
    layer ("rglru"), its conv ("rglru.conv") and its scan ("rglru.scan"),
    so a profile can attribute their kernels."""
    import torch
    from repro_torch.models import blocks
    saved = (blocks._APPLY["rglru"], blocks._causal_depthwise_conv,
             blocks.linear_scan)

    def ranged(name, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call
    blocks._APPLY["rglru"] = ranged("rglru", saved[0])
    blocks._causal_depthwise_conv = ranged("rglru.conv", saved[1])
    blocks.linear_scan = ranged("rglru.scan", saved[2])
    try:
        yield
    finally:
        (blocks._APPLY["rglru"], blocks._causal_depthwise_conv,
         blocks.linear_scan) = saved


def profile_groups(trace, steps, ranges=()):
    """Device time and kernels per step of a profile by group: a kernel
    whose lower-case name holds a matmul's (``profile_step.STEP_GROUPS``)
    or one of the main path's kernels' substrings falls in that group;
    else in the innermost of ``ranges`` ((group, ``record_function``
    range) pairs, innermost first) that its launch (the runtime or driver
    call with its correlation id) lies in; else "other"."""
    from repro_torch.launch import profile_step
    named = {"matmul": profile_step.STEP_GROUPS["matmul"],
             "flash_attention": ("flash_",),
             "decode_attention": ("decode_kernel",), "demux_rsa": ("demux_",),
             "mux entry": ("mux_embed", "mux_combine")}
    evs = trace["traceEvents"]
    spans = {rng: [(e["ts"], e["ts"] + e["dur"]) for e in evs
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"] == rng] for _, rng in ranges}
    launched = {e["args"]["correlation"]: e["ts"] for e in evs
                if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    by, n, unmatched = {}, {}, 0
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        low = e["name"].lower()
        g = next((g for g, subs in named.items()
                  if any(x in low for x in subs)), None)
        if g is None:
            ts = launched.get(e.get("args", {}).get("correlation"))
            unmatched += ts is None
            g = next((g for g, rng in ranges if ts is not None
                      and any(a <= ts <= b for a, b in spans[rng])), "other")
        by[g] = by.get(g, 0.0) + e["dur"]
        n[g] = n.get(g, 0) + 1
    busy = sum(by.values())
    print("  by group: " + ", ".join(
        f"{g} {us / steps / 1e3:.3f} ms ({us / busy:.1%}, "
        f"{n[g] / steps:.0f} kernels)"
        for g, us in sorted(by.items(), key=lambda kv: -kv[1]))
        + f"; {unmatched} kernels without a matched launch", flush=True)


def hybrid_decode_checks(torch, params, cfg, mux, rows, trace):
    """Phase 15 on one fp32 ring decode step of the grid (the trace's
    first N * rows prompts prefilled): ``step_checks`` with the RG-LRU's
    ranges (``profile_groups``: matmuls, the four kernels, the RG-LRU's
    conv, scan and gate kernels, other)."""
    import numpy as np
    from repro_torch.serve import engine
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=len(trace[0][1]) + 24)
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:mux.n * rows]]),
                           device="cuda")
    step_checks(torch, params, sc, toks, toks.shape[1], "hybrid",
                ranges=HYBRID_RANGES, annotate=rglru_ranges)


def step_checks(torch, params, sc, toks, pos, label, *, extra=None,
                ranges=(), annotate=contextlib.nullcontext, prefill=False):
    """One fp32 ring decode step at ``pos`` after a prefill of ``toks``
    (and ``extra``, kind 'vlm' or 'encdec'): the step twice from copies of
    one cache, bit for bit; once more under ``set_sync_debug_mode
    ("error")``; then its host wall time over 5 steps and one step under
    ``torch.profiler`` inside ``annotate()``: device busy, idle share,
    kernels and device time by group (``profile_groups`` over
    ``ranges``).  ``prefill``: the same profile of one prefill (wall time
    over 2)."""
    from repro_torch.launch import profile_step
    from repro_torch.serve import engine
    nb = toks.shape[0]
    cache = engine.init_cache(sc, nb, device="cuda")
    logits, _ = engine.prefill(params, sc, cache, toks, extra=extra)
    dtok = logits.argmax(-1)[:, None]
    twins = [engine.init_cache(sc, nb, device="cuda") for _ in range(3)]
    for c in twins:
        copy_ring(cache, c)
    a = engine.decode_step(params, sc, twins[0], dtok, pos)[0]
    b = engine.decode_step(params, sc, twins[1], dtok, pos)[0]
    torch.cuda.synchronize()
    need(torch.equal(a, b), f"{label} decode step: a repeat from the same "
         "cache changed the logits' bits")
    torch.cuda.set_sync_debug_mode("error")
    try:
        c = engine.decode_step(params, sc, twins[2], dtok, pos)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    need(torch.equal(a, c), f"{label} decode step under sync debug differs")
    print(f"  {label} decode step ({nb // max(sc.mux.n, 1)} rows at {pos}): "
          "bit for bit over two calls from one cache; a third under "
          "set_sync_debug_mode('error') made no host sync and gave the same "
          "bits", flush=True)
    del twins

    def step():
        engine.decode_step(params, sc, cache, dtok, pos)

    def fill():
        engine.prefill(params, sc, twin, toks, extra=extra)
    twin = engine.init_cache(sc, nb, device="cuda")
    calls = [("decode step", step, 5)] + ([("prefill", fill, 2)]
                                          if prefill else [])
    for what, fn, n in calls:
        fn()
        wall = profile_step.wall_time(fn, n)
        with annotate():
            trace_, prof_wall = profile_step.profile_calls(fn, 1)
        profile_step.summarize(f"  {label} fp32 ring {what}, profiled",
                               trace_, 1, wall / n, prof_wall, 8)
        profile_groups(trace_, 1, ranges)
    print(f"  {smi_line()}", flush=True)


# ---------------------------------------------------------------------------
# phase 16: the VLM family, llava-next-mistral-7b at full width
VLM_ARCH = "llava-next-mistral-7b"
# phase 3's rows at phase 16's shapes: the wrapper and the phase-16 run
# whose launches the JSON reports ("cli": fill-drain at the reference
# CLI's positions, "true": the true positions)
LLAVA_ROWS = {
    "mux_combine[llava]": ("mux_combine", "cli"),
    "flash_attention[llava]": ("flash_attention", "cli"),
    "decode_attention[llava]": ("decode_attention", "true"),
    "mux_embed_combine[llava]": ("mux_embed_combine", "cli"),
}


def llava_kernels(torch, timer, record, ring_pos, visible):
    """Phase 3's rows at phase 16's shapes (``LLAVA_ROWS``), read from
    llava-next-mistral-7b's config (32 query heads over 8 KV heads of
    128, d 4096, vocab 32000, 576 patches) and phase 4's trace (4 rows, a
    100-token prompt, 16 new), fp32, each within ATT_TOL / MUX_TOL /
    COMBINE_TOL of its plain version, bit for bit over two calls, timed
    beside its plain version and library call with its bound: the
    mux-combine entry of a prefill over the patch-prefixed rows (2, 4 *
    676, 4096); ``flash_attention`` at B 4, causal L 676 (SDPA beside);
    ``decode_attention`` at B 4 over a 700-slot ring at 690, the last
    decode step of phase 16's run at the true positions; the fused entry
    at V 32000, d 4096, T 4."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kfl
    from repro_torch.kernels import mux_combine as kc
    from repro_torch.kernels import mux_embed as km
    from repro_torch.kernels import ref
    cfg = get_config(VLM_ARCH)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d, vocab = cfg.d_model, cfg.vocab_size
    rows, prompt, new = 4, 100, 16                 # phase 4's trace
    l = cfg.frontend_len + prompt                  # a prefill's row
    cap = l + new + 8                              # the true positions' ring
    dev = torch.device("cuda")
    rng = np.random.default_rng(53)     # phase 3's other rows keep theirs
    heads = f"{h} over {hkv} of {dh}"

    def r(*shape, s=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * s).astype(
            np.float32), device=dev)

    def timed(kernel, plain, library, nb, fl, work=None):
        bms, by = bound(nb, fl)
        return {**({"work": work} if work else {}), "ms": timer(kernel),
                "plain_ms": timer(plain), "library_ms": timer(library),
                "bound_ms": bms, "bound_by": by, "bytes": nb, "flops": fl}

    def repeat(name, fn, got):
        need(torch.equal(fn(), got), f"{name}: a repeat changed the bits")

    # the mux-combine entry of a prefill: 4 rows of 576 patches + 100 tokens
    tt = rows * l
    x, v = r(2, tt, d), r(2, d)
    got = kc.mux_combine_cuda(x, v)
    repeat("mux_combine[llava]", lambda: kc.mux_combine_cuda(x, v), got)
    record("mux_combine[llava]", f"(2, {tt}, {d})",
           (got - ref.mux_combine_ref(x, v)).abs().max().item(),
           COMBINE_TOL["fp32"],
           timed(lambda: kc.mux_combine_cuda(x, v),
                 lambda: ref.mux_combine_ref(x, v),
                 lambda: torch.einsum("ntd,nd->td", x, v) / 2,
                 (3 * tt * d + 2 * d) * 4, 4 * tt * d))
    del x

    # flash: the prefill's rows, causal over patches and prompt
    q, k, vv = r(rows, l, h, dh), r(rows, l, hkv, dh), r(rows, l, hkv, dh)
    got = kfl.flash_attention_cuda(q, k, vv)
    repeat("flash_attention[llava]",
           lambda: kfl.flash_attention_cuda(q, k, vv), got)
    ar = torch.arange(l, device=dev)
    vis = visible(ar, ar, True, None, torch.ones(l, dtype=torch.bool,
                                                 device=dev))
    nb, fl, work = dense_bound(q, k, vis)
    record("flash_attention[llava]", f"B={rows}, causal L={l}; {heads}", (
        got - ref.flash_attention_ref(q, k, vv)).abs().max().item(), ATT_TOL,
        timed(lambda: kfl.flash_attention_cuda(q, k, vv),
              lambda: ref.flash_attention_ref(q, k, vv),
              lambda: sdpa_dense(q, k, vv, vis), nb, fl, work))
    del q, k, vv, vis

    # the ring decode at the true positions' last step
    q_pos = l + new - 2
    q = r(rows, 1, h, dh)
    kc_, vc_ = r(rows, cap, hkv, dh), r(rows, cap, hkv, dh)
    pos = ring_pos(cap, q_pos + 1)
    got = kdec.decode_attention_cuda(q, kc_, vc_, pos, q_pos=q_pos)
    repeat("decode_attention[llava]", lambda: kdec.decode_attention_cuda(
        q, kc_, vc_, pos, q_pos=q_pos), got)
    vis = visible(torch.full((1,), q_pos, device=dev), pos.long(), True, None,
                  pos >= 0)
    nb, fl, work = dense_bound(q, kc_, vis)
    nb += cap * 4                                     # slot positions
    record("decode_attention[llava]", f"B={rows}, C={cap} at {q_pos}; "
           f"{heads}", (got - ref.decode_attention_ref(
               q, kc_, vc_, pos, q_pos=q_pos)).abs().max().item(), ATT_TOL,
           timed(lambda: kdec.decode_attention_cuda(q, kc_, vc_, pos,
                                                    q_pos=q_pos),
                 lambda: ref.decode_attention_ref(q, kc_, vc_, pos,
                                                  q_pos=q_pos),
                 lambda: sdpa_dense(q, kc_, vc_, vis), nb, fl, work))
    del kc_, vc_

    # the fused entry of a decode step: vocabulary 32000, d 4096, T 4
    emb = torch.randn((vocab, d), device=dev, generator=torch.Generator(
        device=dev).manual_seed(53)) * 0.02
    tok = torch.as_tensor(rng.integers(0, vocab, (2, rows)).astype(np.int32),
                          device=dev)
    tl = tok.long()
    got = km.mux_embed_combine_cuda(tok, emb, v)
    repeat("mux_embed_combine[llava]",
           lambda: km.mux_embed_combine_cuda(tok, emb, v), got)
    record("mux_embed_combine[llava]", f"T={rows} V {vocab} d {d}",
           (got - ref.mux_embed_ref(tok, emb, v)).abs().max().item(), MUX_TOL,
           timed(lambda: km.mux_embed_combine_cuda(tok, emb, v),
                 lambda: ref.mux_embed_ref(tok, emb, v),
                 lambda: torch.einsum("ntd,nd->td", F.embedding(tl, emb),
                                      v) * 0.5,
                 embed_bytes(tok, d, 4), 2 * 2 * rows * d,
                 work=f"{tok.unique().numel()} distinct table rows of "
                      f"{tok.numel()} gathers"))
    del emb


def phase_vlm(torch, mux, rows, prompt_len, new_tokens):
    """Phase 16: full-width llava-next-mistral-7b from seeded random
    weights (32 layers, d 4096, 32 query heads over 8 KV heads of 128, the
    multimodal projector 1024 -> 4096 -> 4096), phase 4's trace with 576
    seeded N(0, 1) patch embeddings a request and ``attn_impl='flash'``:
    (a) fill-drain at the reference CLI's capacity and decode positions
    (``serve_dense``, launch counts exact) and its kernel path against the
    plain path (``compare_fill_drain_paths``); (b) and (c) the true
    positions in fp32 and bf16 (``vlm_true_positions``); (d) one decode
    step and one prefill (``step_checks``), and the projector alone by
    CUDA events; (e) the peak memory.  Returns {run: launches}."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import VLM, param_count
    from repro_torch.models.vlm import D_VISION
    from repro_torch.serve import engine
    print(f"phase 16: {VLM_ARCH} full width; {smi_line()}", flush=True)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(VLM_ARCH)
    flash = cfg.replace(attn_impl="flash")
    t0 = time.perf_counter()
    params = VLM.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                      mux)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"  {VLM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, rope theta "
          f"{cfg.rope_theta:g}, {cfg.frontend_len} patches of {D_VISION}; "
          f"{n_params / 1e9:.3f} B params ({param_count(cfg) / 1e9:.3f} B "
          f"backbone) in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    patches = torch.randn(
        (len(trace), cfg.frontend_len, D_VISION), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(59)).cpu().numpy()
    # (a) the reference CLI's fill-drain: capacity prompt + new + 8,
    # decode step t at prompt_len + t
    cli = serve_dense(params, flash, mux, rows, trace, new_tokens,
                      "fill-drain", label="llava (CLI positions) ",
                      kind="vlm", frames=patches)
    compare_fill_drain_paths(params, flash, mux, rows, trace, patches,
                             new_tokens, cli, "vlm", "llava (CLI positions)")
    # (b), (c) the true positions, fp32 then bf16
    true = vlm_true_positions(torch, params, flash, mux, rows, trace,
                              patches, new_tokens)
    # (d) one decode step at the true position and one prefill, profiled
    nb = mux.n * rows
    sc = engine.ServeConfig(cfg=flash, mux=mux, dtype=torch.float32,
                            capacity=cfg.frontend_len + prompt_len
                            + new_tokens + 8, kind="vlm")
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    extra = torch.as_tensor(patches[:nb], device="cuda")
    step_checks(torch, params, sc, toks, cfg.frontend_len + prompt_len,
                "llava", extra=extra, prefill=True)
    # the projector alone, by CUDA events: a prefill's profile groups its
    # GEMMs with the backbone's
    ms = Timer(torch)(lambda: VLM.project(params, extra, torch.float32),
                      iters=10)
    print(f"  llava projector alone ({nb} x {cfg.frontend_len} patches, "
          f"{D_VISION} -> {cfg.d_model} -> {cfg.d_model}): {ms:.3f} ms "
          "(CUDA events, cold L2)", flush=True)
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{smi_line()}", flush=True)
    return {"cli": cli["launches"], "true": true}


def vlm_true_positions(torch, params, cfg, mux, rows, trace, patches,
                       new_tokens):
    """Phase 16 (b) and (c): the trace's first N * rows requests (one
    batch, no duplicate) through ``engine.prefill`` / ``decode_step`` at
    the true positions (capacity P + L + new + 8, decode step t at P + L +
    t), greedy.  (b) fp32: the kernel path's launches exact (a prefill's
    mux_combine once and flash_attention once a layer, no demux kernel; a
    decode step's decode_attention once a layer and the fused entry and
    exit once); the prefill's and every decode step's logits within
    LOGIT_TOL of one no-cache forward of the plain model path over
    [patches, prompt, the tokens fed] at their positions; the plain path's
    (naive attention, no kernel) greedy tokens identical.  (c) bf16
    (``ServeConfig.dtype``'s default): the prefill's and one decode step's
    logits from identical caches within ``BF16_LOGIT_ULPS`` of the
    wrappers' plain versions (``bf16_logit_check``), greedy agreement
    with fp32 printed.  Returns the fp32 kernel path's launches."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import VLM
    from repro_torch.serve import engine
    p, l = cfg.frontend_len, len(trace[0][1])
    nb = mux.n * rows
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=p + l + new_tokens + 8, kind="vlm")
    naive = cfg.replace(attn_impl="naive")
    toks = torch.as_tensor(np.stack([a[1] for a in trace[:nb]]),
                           device="cuda")
    extra = torch.as_tensor(patches[:nb], device="cuda")

    def generate(sc_, use_kernels=True):
        """(logits (nb, new, V): the prefill's, then each decode step's;
        the tokens fed to the decode steps (nb, new - 1))."""
        cache = engine.init_cache(sc_, nb, device="cuda")
        lg, _ = engine.prefill(params, sc_, cache, toks, extra=extra,
                               use_kernels=use_kernels)
        outs, fed = [lg], []
        for t in range(new_tokens - 1):
            fed.append(outs[-1].argmax(-1)[:, None])
            lg, _ = engine.decode_step(params, sc_, cache, fed[-1],
                                       p + l + t, use_kernels=use_kernels)
            outs.append(lg[:, 0])
        return torch.stack(outs, 1), torch.cat(fed, 1)

    t0 = time.perf_counter()
    ops.reset_counts()
    lk, fed = generate(sc)
    launches = ops.counts("launches")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = new_tokens - 1
    want = dict.fromkeys(launches, 0)
    want.update({"mux_combine": 1, "flash_attention": cfg.n_layers,
                 "decode_attention": cfg.n_layers * steps,
                 "mux_embed_combine": steps, "demux_rsa": steps})
    need(launches == want, f"llava (true positions): launch counts "
         f"{launches} != required {want}")
    need(bool(torch.isfinite(lk).all()), "llava (true positions): logits "
         "are not finite")
    full = VLM.apply(params, naive, torch.cat([toks, fed], 1), extra,
                     mux=mux, dtype=torch.float32,
                     use_kernels=False)["logits"][:, p + l - 1:]
    err = (lk - full).abs().amax((0, 2))
    print(f"  llava (true positions, capacity {sc.capacity}, decode at "
          f"{p + l}..{p + l + steps - 1}): {nb} streams x {new_tokens} "
          f"tokens in {wall:.3f} s; logits max_abs_err against the plain "
          f"path's no-cache forward over [patches, prompt, tokens so far]: "
          f"prefill {err[0].item():.3e}, decode steps max "
          f"{err[1:].max().item():.3e} (tol {LOGIT_TOL:g}); |logits| max "
          f"{lk.abs().max().item():.3f}; launches {launches}", flush=True)
    need(err.max().item() <= LOGIT_TOL, "llava (true positions): the "
         "decode steps disagree with the no-cache forward")
    del full
    lp, _ = generate(dataclasses.replace(sc, cfg=naive), use_kernels=False)
    same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"  llava (true positions): greedy tokens identical, kernel vs "
          f"plain path {same}/{lk.shape[0] * lk.shape[1]}", flush=True)
    need(same == lk.shape[0] * lk.shape[1], "llava (true positions): the "
         "kernel path's greedy tokens differ from the plain path's")
    del lp

    # (c) bf16 on the same path
    sc16 = dataclasses.replace(sc, dtype=torch.bfloat16)
    caches = [engine.init_cache(sc16, nb, device="cuda") for _ in range(3)]
    pre = engine.prefill(params, sc16, caches[0], toks, extra=extra,
                         use_kernels=True)[0]
    with kernels_as_plain():
        pre_p = engine.prefill(params, sc16, caches[1], toks, extra=extra,
                               use_kernels=True)[0]
    pre_m = engine.prefill(params, sc16, caches[2], toks, extra=extra,
                           use_kernels=False)[0]
    bf16_logit_check("llava, bf16", "prefill", pre.float(), pre_p.float(),
                     pre_m.float(), fp32=lk[:, 0])
    for c in caches[1:]:
        copy_ring(caches[0], c)
    dtok = pre.argmax(-1)[:, None]
    dk = engine.decode_step(params, sc16, caches[0], dtok, p + l)[0]
    with kernels_as_plain():
        dp = engine.decode_step(params, sc16, caches[1], dtok, p + l)[0]
    dm = engine.decode_step(params, sc16, caches[2], dtok, p + l,
                            use_kernels=False)[0]
    bf16_logit_check("llava, bf16", "decode", dk.float(), dp.float(),
                     dm.float())
    del caches
    ops.reset_counts()
    l16, _ = generate(sc16)
    need(ops.counts("launches") == want, f"llava bf16: launch counts "
         f"{ops.counts('launches')} != required {want}")
    same = int((l16.argmax(-1) == lk.argmax(-1)).sum())
    print(f"  llava (true positions), bf16: greedy agreement with the fp32 "
          f"run {same}/{lk.shape[0] * lk.shape[1]}", flush=True)
    return launches


MESH_TRACE_ARCHS = {"qwen2-1.5b": (2, 2), "granite-moe-3b-a800m": (1, 2)}
MESH_LANES_ARCH = "qwen2-1.5b"  # (d) runs in this arch's spawn
MESH_TIMEOUT = 540             # seconds a mesh spawn may take
# the shard-local wrappers' rows in the kernels line: (wrapper, the
# reference's shard_map wrapper over the paged Pallas kernel)
MESH_ROWS = {"sharded_paged_attention":
             "src/repro/kernels/paged_attention.py:337",
             "sharded_paged_prefill_attention":
             "src/repro/kernels/paged_attention.py:390"}


class ShardCoords:
    """One mesh position of the shard-local wrappers, in this process:
    what ``kernels.ops.sharded_paged_*`` read of a mesh."""

    def __init__(self, data, model, sizes):
        self.coords = {"data": data, "model": model}
        self.shape = dict(sizes)


def mesh_kernels(torch, timer, dev="cuda"):
    """Phase 17 (a): both shard-local wrappers at qwen2-1.5b's heads (12
    over 2 of 128): phase 4's decode rows (4 rows at 100-117) and its
    32-token chunk (2 rows at 64), over fp32 and int8 pages in
    ``ShardedKVPool``'s layout (2 data shards of 17 blocks of 16, a trash
    block each), split over 2 data shards and a model axis of 2 (6 query
    heads over 1 KV head a rank).  Each shard's call runs in this
    process, against the unsharded kernel's rows and heads on the whole
    pool and against the plain version on its own inputs, timed beside
    the unsharded call.  Returns the JSON rows' summaries (fp32)."""
    import numpy as np
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as kp
    rng = np.random.default_rng(17)
    sizes = {"data": 2, "model": 2}
    bs, mb, bps, h, hkv, dh = 16, 8, 17, 12, 2, 128

    def pool(lens):
        kk = rng.standard_normal((2 * bps, bs, hkv, dh), np.float32)
        vv = rng.standard_normal((2 * bps, bs, hkv, dh), np.float32)
        bt = np.full((len(lens), mb), -1, np.int32)
        pp = np.full((2 * bps, bs), -1, np.int32)
        rps = len(lens) // 2
        free = {s: list(range(s * bps + 1, (s + 1) * bps)) for s in (0, 1)}
        for r, n in enumerate(lens):
            blocks = [free[r // rps].pop(0) for _ in range(-(-n // bs))]
            bt[r, :len(blocks)] = blocks
            for i in range(n):
                pp[blocks[i // bs], i % bs] = i
        return [torch.as_tensor(x, device=dev) for x in (kk, vv, bt, pp)]

    cases = {"sharded_paged_attention": ([117, 108, 101, 100], 1,
                                         ([116, 107, 100, 99],)),
             "sharded_paged_prefill_attention": ([96, 96], 32,
                                                 ([64, 64], [32, 32]))}
    out = {}
    for name, (lens, lq, vecs) in cases.items():
        decode = name == "sharded_paged_attention"
        kpages, vpages, bt, pp = pool(lens)
        q = torch.as_tensor(rng.standard_normal((len(lens), lq, h, dh),
                                                np.float32), device=dev)
        vec = [torch.as_tensor(np.asarray(v, np.int32), device=dev)
               for v in vecs]
        for kind in ("fp32", "int8"):
            kw = {}
            k_p, v_p = kpages, vpages
            if kind == "int8":
                k_p, ks = quant.quantize_kv(kpages, "int8")
                v_p, vs = quant.quantize_kv(vpages, "int8")
                kw = {"k_scales": ks, "v_scales": vs}
            unsharded = kp.paged_attention_cuda if decode else \
                kp.paged_prefill_attention_cuda
            plain = ((kp.paged_attention_ref if decode else
                      kp.paged_prefill_attention_ref) if not kw else
                     (kp.paged_attention_quant_ref if decode else
                      kp.paged_prefill_attention_quant_ref))
            whole = unsharded(q, k_p, v_p, bt, pp, *vec, **kw)
            rows = len(lens) // 2
            err_k = err_p = 0.0
            shard_ms = []
            for d in (0, 1):
                for m in (0, 1):
                    r = slice(d * rows, (d + 1) * rows)
                    b = slice(d * bps, (d + 1) * bps)
                    hs = slice(m * h // 2, (m + 1) * h // 2)
                    ks_ = slice(m * hkv // 2, (m + 1) * hkv // 2)
                    at = ShardCoords(d, m, sizes)
                    sq = q[r, :, hs].contiguous()
                    sk = k_p[b, :, ks_].contiguous()
                    sv = v_p[b, :, ks_].contiguous()
                    skw = {k2: x[b, :, ks_].contiguous()
                           for k2, x in kw.items()}
                    sbt, spp = bt[r].contiguous(), pp[b].contiguous()
                    svec = [x[r].contiguous() for x in vec]
                    wrapper = getattr(ops, name)

                    def call():
                        return wrapper(at, sq, sk, sv, sbt, spp, *svec,
                                       **skw)
                    got = call()
                    local = kp._local_tables(sbt, d, bps)
                    scales = ([skw["k_scales"], skw["v_scales"]] if skw
                              else [])
                    want = plain(sq, sk, sv, *scales, local, spp, *svec)
                    err_k = max(err_k, (got - whole[r, :, hs]).abs().max()
                                .item())
                    err_p = max(err_p, (got - want).abs().max().item())
                    if d == 0 and m == 0:
                        if decode:
                            qrows = svec[0][:, None]
                        else:
                            li = torch.arange(lq, device=dev)[None]
                            qrows = torch.where(
                                li >= svec[1][:, None], -1,
                                svec[0][:, None] + li)
                        nb, fl, work = attn_bytes_flops(
                            sq, local, spp, qrows, hkv // 2, dh,
                            elem=sk.element_size(), scaled=bool(skw))
                        bms, by = bound(nb, fl)
                        timing = {
                            "ms": timer(call),
                            "plain_ms": timer(lambda: plain(
                                sq, sk, sv, *scales, local, spp, *svec)),
                            "library_ms": timer(lambda: mesh_sdpa(
                                torch, sq, sk, sv, local, spp, qrows,
                                skw)),
                            "bound_ms": bms, "bound_by": by,
                            "bytes": nb, "flops": fl, "work": work}
                    shard_ms.append(timer(call, iters=5))
            whole_ms = timer(lambda: unsharded(q, k_p, v_p, bt, pp, *vec,
                                               **kw))
            row = f"{name}[{kind}]" if kind != "fp32" else name
            print(f"  {row:<40} 2 x 2 shards: max_abs_err vs the unsharded "
                  f"kernel {err_k:.3e}, vs the plain version {err_p:.3e} "
                  f"(tol {ATT_TOL:g}); shard (0, 0) {timing['ms']:.5f} ms "
                  f"(shards {', '.join(f'{x:.5f}' for x in shard_ms)}) "
                  f"beside the unsharded call {whole_ms:.5f} ms; plain "
                  f"{timing['plain_ms']:.5f} ms, library "
                  f"{timing['library_ms']:.5f} ms, bound "
                  f"{timing['bound_ms']:.6f} ms ({timing['bound_by']}: "
                  f"{timing['bytes']} bytes, {timing['flops']} flops) "
                  f"[{timing['work']}]", flush=True)
            need(err_k <= ATT_TOL and err_p <= ATT_TOL,
                 f"{row}: a shard disagrees (unsharded {err_k}, plain "
                 f"{err_p})")
            if kind == "fp32":
                out[name] = {"max_abs_err": max(err_k, err_p),
                             "timing": timing}
    return out


def mesh_sdpa(torch, q, k_pages, v_pages, bt, pp, qrows, scales):
    """Library yardstick of a shard's call: its pages gathered (and
    dequantized), SDPA over them."""
    import torch.nn.functional as F
    b, lq, h, dh = q.shape
    btc = bt.long().clamp(min=0)
    k, v = k_pages[btc].float(), v_pages[btc].float()
    if scales:
        k = k * scales["k_scales"][btc][..., None]
        v = v * scales["v_scales"][btc][..., None]
    k = k.reshape(b, -1, *k_pages.shape[2:])
    v = v.reshape(b, -1, *v_pages.shape[2:])
    pos = torch.where(bt[..., None] >= 0, pp[btc], -1).reshape(b, -1)
    g = h // k.shape[2]
    k = k.repeat_interleave(g, 2).transpose(1, 2)
    v = v.repeat_interleave(g, 2).transpose(1, 2)
    mask = (pos[:, None, :] >= 0) & (pos[:, None, :] <= qrows[..., None])
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=mask[:, None])


@contextlib.contextmanager
def first_chunk_logits():
    """Record the logits of the first prefill chunk a runtime computes in
    this process (a list: empty where none ran here)."""
    from repro_torch.serve import runtime as rt_mod
    seen = []
    real = rt_mod.prefill_chunk

    def recording(*a, **kw):
        logits, cache = real(*a, **kw)
        if not seen:
            seen.append(logits.float().cpu().numpy())
        return logits, cache
    rt_mod.prefill_chunk = recording
    try:
        yield seen
    finally:
        rt_mod.prefill_chunk = real


def mesh_reference_chunk(torch, arch, mux, rows, trace, prompt_len,
                         new_tokens):
    """The single-device run's first prefill chunk (its logits), phase 4's
    weights (seed 0) and config; the weights are freed on return."""
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    from repro_torch.serve import engine
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.runtime import ServeRuntime
    cfg = get_config(arch)
    params = TransformerLM.init(
        torch.Generator(device="cuda").manual_seed(0), cfg, mux)
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=prompt_len + new_tokens + 8,
                            cache_layout="paged", block_size=16)
    rt = ServeRuntime(params, sc, rows, chunk=32, device="cuda")
    for uid, (t, p, m) in enumerate(trace):
        if t <= 0:
            rt.submit(Request(uid=uid, prompt=list(p), max_new=m))
    with first_chunk_logits() as seen:
        rt.step()
    del rt, params
    gc.collect()
    torch.cuda.empty_cache()
    return seen[0]


def _mesh_child(mesh, arch, n_mux, rows, trace, prompt_len, new_tokens,
                lanes=False):
    """One rank of phase 17 (b) / (c): the arch's full-width weights (seed
    0, phase 4's / 14's), cut to this rank's shards and the whole ones
    dropped, then ``run_continuous`` on the mesh with the launch counts
    set to 0 just before and read just after; with ``lanes``, (d) after
    it (``_mesh_lanes_child``).  Returns what the parent checks."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import MuxSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    from repro_torch.models import TransformerLM
    from repro_torch.runtime.sharding import shard_params
    from repro_torch.serve import engine
    from repro_torch.serve.telemetry import Telemetry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch)
    mux = MuxSpec(n=n_mux)
    t0 = time.perf_counter()
    params = shard_params(TransformerLM.init(
        torch.Generator(device="cuda").manual_seed(0), cfg, mux), mesh,
        pattern=len(cfg.block_pattern))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    sc = engine.ServeConfig(cfg=cfg, mux=mux, dtype=torch.float32,
                            capacity=prompt_len + new_tokens + 8,
                            cache_layout="paged", block_size=16,
                            n_shards=mesh.shape["data"])
    tele = Telemetry()
    with first_chunk_logits() as seen:
        ops.reset_counts()
        mesh.counts.clear()
        stats = run_continuous(params, sc, rows, trace, chunk=32,
                               telemetry=tele, device="cuda", mesh=mesh)
        launches = ops.counts("launches")
        sharded = {w.__name__: w.launches for w in ops.SHARDED}
    torch.cuda.synchronize()
    spans = _spans_by_name(tele)
    out = {"coords": dict(mesh.coords), "backend": mesh.backend,
           "reason": mesh.backend_reason,
           "outputs": {r.uid: list(r.output) for r in stats["completed"]},
           "trace_counts": dict(stats["trace_counts"]),
           "launches": launches, "sharded": sharded,
           "collectives": dict(mesh.counts),
           "decode_ms": statistics.median(spans["decode"]),
           "chunk_ms": statistics.median(spans["prefill_chunk"]),
           "wall": stats["wall"], "init_s": t_init,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "first_chunk": seen[0] if seen else None, "lanes": None}
    if lanes:
        del stats, params
        gc.collect()
        torch.cuda.empty_cache()
        out["lanes"] = _mesh_lanes_child(mesh, cfg, rows, trace, prompt_len,
                                         new_tokens)
    return out


def _spans_by_name(tele):
    """A telemetry trace's span durations in ms, by span name."""
    spans = {}
    for ev in tele.tracer.events:
        if ev[0] == "X":
            spans.setdefault(ev[1], []).append(ev[3] / 1e3)
    return spans


# phase 17 (d): width lanes and disaggregated serving on the (2, 2) mesh
MESH_LANE_WIDTHS = (1, 2)
MESH_LANE_SLO = ("latency", "throughput")     # the trace's requests in turn


def mesh_lane_runs(rows, trace):
    """(d)'s two runs: name -> (lane specs, arrivals, the widths' params
    they need)."""
    from repro_torch.serve.router import LaneSpec
    slo = [(*a, None, MESH_LANE_SLO[i % len(MESH_LANE_SLO)])
           for i, a in enumerate(trace)]
    return {"lanes": ([LaneSpec(n_mux=w, rows=rows, chunk=32)
                       for w in MESH_LANE_WIDTHS], slo),
            "disagg": ([LaneSpec(n_mux=2, rows=rows, chunk=32,
                                 role="prefill"),
                        LaneSpec(n_mux=2, rows=rows, chunk=32,
                                 role="decode")], trace)}


def mesh_lane_params(torch, cfg, mesh=None):
    """Width -> (d)'s full-width params, seed = width as the CLI's; on a
    mesh each cut to the rank's shards as soon as it is made."""
    from repro_torch.core import MuxSpec
    from repro_torch.models import TransformerLM
    from repro_torch.runtime.sharding import shard_params
    out = {}
    for w in MESH_LANE_WIDTHS:
        p = TransformerLM.init(torch.Generator(device="cuda").manual_seed(w),
                               cfg, MuxSpec(n=w))
        if mesh is not None:
            p = shard_params(p, mesh, pattern=len(cfg.block_pattern))
            gc.collect()
            torch.cuda.empty_cache()
        out[w] = p
    return out


def _lane_counts(stats):
    """What (d) holds the mesh runs to the unsharded runs on."""
    rec = stats["recovery"]
    return {"requests": len(stats["completed"]),
            "tokens": stats["generated_tokens"],
            "prefill": (stats["prefill_tokens"],
                        stats["prefill_compute_tokens"],
                        stats["prefill_events"]),
            "per_lane": [(ls["lane"], ls["n_mux"], len(ls["completed"]),
                          sum(len(r.output) for r in ls["completed"]))
                         for ls in stats["lanes"]],
            "routing": dict(stats["routing"]["routed"]),
            "handoffs": (rec["handoffs"], rec["handoff_streams"]),
            "migrated_bytes": rec["migrated_kv_bytes"]}


@contextlib.contextmanager
def watch_handoffs(moves):
    """Record each handoff of a mesh run in this process: the source and
    destination data shards and a sha256 of this rank's bytes of the
    row's pages before the move (on the source shard's ranks) and after
    it (on the destination's), None where this rank holds no part."""
    import hashlib
    from repro_torch.serve import runtime as rt_mod
    from repro_torch.serve.kvpool import pages_as_bytes, take_pages
    real = rt_mod.ServeRuntime.handoff_to

    def digest(rt, row):
        shard = rt.sched.shard_of(row)
        if rt.mesh.coords["data"] != shard:
            return None
        ids = rt._segment_ids([int(b) for b in rt.pool.block_table(row)
                               if b >= 0], shard)
        buf = pages_as_bytes([x for c in rt.cache["layers"] if "ppos" in c
                              for x in take_pages(c, ids)])
        return hashlib.sha256(buf.cpu().numpy().tobytes()).hexdigest()

    def watching(self, dst, j, dst_row):
        before = digest(self, j)
        plan = real(self, dst, j, dst_row)
        if plan is not None:
            moves.append((self.sched.shard_of(j), dst.sched.shard_of(dst_row),
                          before, digest(dst, dst_row)))
        return plan
    rt_mod.ServeRuntime.handoff_to = watching
    try:
        yield moves
    finally:
        rt_mod.ServeRuntime.handoff_to = real


def _mesh_lanes_child(mesh, cfg, rows, trace, prompt_len, new_tokens):
    """Phase 17 (d) on this rank: ``mesh_lane_runs`` on the mesh, each
    with the launch and collective counts set to 0 just before it and
    read just after."""
    import torch
    from repro_torch.core import MuxSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    from repro_torch.serve.telemetry import Telemetry
    t0 = time.perf_counter()
    params = mesh_lane_params(torch, cfg, mesh)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=1), dtype=torch.float32,
                            capacity=prompt_len + new_tokens + 8,
                            cache_layout="paged", block_size=16,
                            n_shards=mesh.shape["data"])
    out = {"init_s": t_init}
    for name, (lanes, arr) in mesh_lane_runs(rows, trace).items():
        tele = Telemetry()
        torch.cuda.reset_peak_memory_stats()
        with first_chunk_logits() as seen, watch_handoffs([]) as moves:
            ops.reset_counts()
            mesh.counts.clear()
            mesh.bytes.clear()
            stats = run_continuous(params, sc, rows, arr, chunk=32,
                                   telemetry=tele, device="cuda", mesh=mesh,
                                   lanes=lanes)
            launches = ops.counts("launches")
            sharded = {w.__name__: w.launches for w in ops.SHARDED}
        torch.cuda.synchronize()
        spans = _spans_by_name(tele)
        out[name] = {
            "outputs": {r.uid: list(r.output) for r in stats["completed"]},
            "counts": _lane_counts(stats),
            "trace_counts": [dict(ls["trace_counts"])
                             for ls in stats["lanes"]],
            "launches": launches, "sharded": sharded,
            "collectives": dict(mesh.counts),
            "page_move_bytes": mesh.bytes["page_move"],
            "decode_ms": statistics.median(spans["decode"]),
            "handoff_ms": spans.get("handoff", []),
            "wall": stats["wall"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "moves": moves, "first_chunk": seen[0] if seen else None}
        del stats
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_lanes_reference(torch, cfg, rows, trace, prompt_len, new_tokens):
    """(d)'s runs unsharded on the card (2 logical shards, the mesh's
    schedule) in this process: each run's tokens, counts and first
    chunk's logits; the weights are freed on return."""
    from repro_torch.core import MuxSpec
    from repro_torch.launch.serve import run_continuous
    from repro_torch.serve import engine
    params = mesh_lane_params(torch, cfg)
    sc = engine.ServeConfig(cfg=cfg, mux=MuxSpec(n=1), dtype=torch.float32,
                            capacity=prompt_len + new_tokens + 8,
                            cache_layout="paged", block_size=16, n_shards=2)
    out = {}
    for name, (lanes, arr) in mesh_lane_runs(rows, trace).items():
        with first_chunk_logits() as seen:
            stats = run_continuous(params, sc, rows, arr, chunk=32,
                                   device="cuda", lanes=lanes)
        out[name] = {"outputs": {r.uid: list(r.output)
                                 for r in stats["completed"]},
                     "counts": _lane_counts(stats), "first_chunk": seen[0],
                     "wall": stats["wall"]}
        del stats
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_lanes_check(res, want, new_tokens, n_req):
    """Phase 17 (d)'s checks and lines over the ranks' results ``res``
    against the unsharded runs ``want``."""
    for name, ref in want.items():
        tag = f"qwen2-1.5b {name} on mesh(2, 2)"
        runs = [r["lanes"][name] for r in res]
        for r, run in zip(res, runs):
            at = r["coords"]
            need(len(run["outputs"]) == n_req and all(
                len(o) == new_tokens for o in run["outputs"].values()),
                f"{tag}: rank {at} completed {len(run['outputs'])} of "
                f"{n_req} requests")
            need(run["outputs"] == runs[0]["outputs"],
                 f"{tag}: rank {at} disagrees with rank 0's tokens")
            need(run["counts"] == ref["counts"], f"{tag}: rank {at}'s "
                 f"counts {run['counts']} != the unsharded run's "
                 f"{ref['counts']}")
            need(all(set(tc) <= {"decode", "prefill_4", "prefill_32"}
                     and all(v == 1 for v in tc.values())
                     for tc in run["trace_counts"]),
                 f"{tag}: step signatures {run['trace_counts']}")
            for k in ("mux_embed_combine", "paged_attention",
                      "paged_prefill_attention", "demux_rsa"):
                need(run["launches"][k] > 0, f"{tag}: rank {at} never "
                     f"launched {k}")
            need(all(run["sharded"].values()), f"{tag}: rank {at}: the "
                 f"shard-local wrappers launched {run['sharded']}")
        chunks = [run["first_chunk"] for r, run in zip(res, runs)
                  if r["coords"]["data"] == 0]
        need(all(c is not None for c in chunks),
             f"{tag}: a rank of row 0's shard ran no prefill chunk")
        err = max(float(abs(c - ref["first_chunk"]).max()) for c in chunks)
        need(err <= LOGIT_TOL, f"{tag}: the first chunk's logits are {err} "
             f"from the unsharded run's (tol {LOGIT_TOL})")
        # each moved row's pages: the source rank's bytes before the move
        # equal the destination rank's after it, model rank by model rank
        moves = [run["moves"] for run in runs]
        need(len({len(m) for m in moves}) == 1
             and len(moves[0]) == ref["counts"]["handoffs"][0],
             f"{tag}: the ranks saw {[len(m) for m in moves]} handoffs")
        cross = 0
        for i, (a, b, _, _) in enumerate(moves[0]):
            cross += a != b
            for m in (0, 1):
                src = next(mv[i][2] for r, mv in zip(res, moves)
                           if r["coords"] == {"data": a, "model": m})
                dst = next(mv[i][3] for r, mv in zip(res, moves)
                           if r["coords"] == {"data": b, "model": m})
                need(src is not None and src == dst,
                     f"{tag}: handoff {i} (shard {a} -> {b}), model rank "
                     f"{m}: the pages' bytes changed in the move")
        if name == "disagg":
            need(cross >= 1, f"{tag}: no handoff crossed data shards")
        same, total = agreement(runs[0]["outputs"], ref["outputs"])
        c = ref["counts"]
        print(f"  {tag}: every request complete ({n_req} x {new_tokens} "
              f"tokens), ranks' tokens identical; counts equal to the "
              f"unsharded run's (per lane {c['per_lane']}, prefill "
              f"{c['prefill']}, handoffs {c['handoffs']}, "
              f"{c['migrated_bytes']} KV bytes migrated); first chunk's "
              f"logits within {err:.3e} of it (tol {LOGIT_TOL}); greedy "
              f"tokens identical to it {same}/{total} "
              f"({same / total:.3f}); {len(moves[0])} handoffs, {cross} "
              f"across ranks, every moved page equal as bytes", flush=True)
        for r, run in zip(res, runs):
            ho = run["handoff_ms"]
            print(f"    rank {r['coords']}: decode step p50 "
                  f"{run['decode_ms']:.3f} ms, handoffs "
                  f"{len(ho)} (p50 {statistics.median(ho) if ho else 0:.3f}"
                  f" ms host, page_move {run['page_move_bytes']} bytes), "
                  f"serve wall {run['wall']:.3f} s, peak "
                  f"{run['peak_gib']:.2f} GiB; launches {run['launches']}, "
                  f"shard-local {run['sharded']}; collectives "
                  f"{run['collectives']}", flush=True)


def mesh_serve(torch, arch, shape, mux, rows, prompt_len, new_tokens,
               single_outputs, single_run):
    """Phase 17 (b) / (c): ``arch`` at full width on a ``shape`` mesh of
    ranks sharing the card, with every check, and for ``MESH_LANES_ARCH``
    (d) in the same spawn against its unsharded runs, made here first;
    the parent holds no weights while the ranks run.  Returns rank 0's
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    cfg = get_config(arch)
    trace = serve_trace(cfg, prompt_len=prompt_len, new_tokens=new_tokens)
    want = mesh_reference_chunk(torch, arch, mux, rows, trace, prompt_len,
                                new_tokens)
    lanes = arch == MESH_LANES_ARCH
    want_lanes = None
    if lanes:                    # (d)'s unsharded runs, before the spawn
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        want_lanes = mesh_lanes_reference(torch, cfg, rows, trace,
                                          prompt_len, new_tokens)
        print(f"  (d) unsharded lanes / disagg runs: "
              f"{time.perf_counter() - t0:.1f} s (serve wall "
              + ", ".join(f"{k} {v['wall']:.3f} s"
                          for k, v in want_lanes.items()) + ")", flush=True)
    t0 = time.perf_counter()
    res = mesh_lib.spawn(_mesh_child, *shape, device="cuda",
                         args=(arch, mux.n, rows, trace, prompt_len,
                               new_tokens, lanes), timeout=MESH_TIMEOUT)
    dt = time.perf_counter() - t0
    tag = f"{arch} on mesh{shape}"
    for r in res:
        need(len(r["outputs"]) == len(trace) and all(
            len(o) == new_tokens for o in r["outputs"].values()),
            f"{tag}: rank {r['coords']} completed {len(r['outputs'])} of "
            f"{len(trace)} requests")
        need(r["outputs"] == res[0]["outputs"],
             f"{tag}: rank {r['coords']} disagrees with rank 0's tokens")
        need(set(r["trace_counts"]) == {"decode", "prefill_4", "prefill_32"}
             and all(v == 1 for v in r["trace_counts"].values()),
             f"{tag}: step signatures {r['trace_counts']}")
        for k in ("mux_embed_combine", "paged_attention",
                  "paged_prefill_attention", "demux_rsa"):
            need(r["launches"][k] > 0, f"{tag}: rank {r['coords']} never "
                 f"launched {k}")
        if shape[0] > 1:
            need(all(r["sharded"].values()), f"{tag}: rank {r['coords']}: "
                 f"the shard-local wrappers launched {r['sharded']}")
    # row 0's first chunk, on its data shard's ranks (the other shards'
    # first chunks are other rows')
    chunks = [r["first_chunk"] for r in res if r["coords"]["data"] == 0]
    need(all(c is not None for c in chunks),
         f"{tag}: a rank of row 0's shard ran no prefill chunk")
    err = max(float(abs(c - want).max()) for c in chunks)
    need(err <= LOGIT_TOL, f"{tag}: the first chunk's logits are {err} from "
         f"the single-device run's (tol {LOGIT_TOL})")
    same, total = agreement(res[0]["outputs"], single_outputs)
    r0 = res[0]
    print(f"  {tag}: {shape[0] * shape[1]} ranks on one card over "
          f"{r0['backend']} ({r0['reason']}); every request complete "
          f"({len(r0['outputs'])} x {new_tokens} tokens), step signatures "
          f"{', '.join(f'{k}×{v}' for k, v in sorted(r0['trace_counts'].items()))}"
          f"; first chunk's logits within {err:.3e} of the single-device "
          f"run's (tol {LOGIT_TOL}); greedy tokens identical to {single_run} "
          f"{same}/{total} ({same / total:.3f}); spawn {dt:.1f} s",
          flush=True)
    for r in res:
        print(f"    rank {r['coords']}: decode step p50 {r['decode_ms']:.3f} "
              f"ms, prefill chunk p50 {r['chunk_ms']:.3f} ms, serve wall "
              f"{r['wall']:.3f} s, weights {r['init_s']:.1f} s, peak "
              f"{r['peak_gib']:.2f} GiB; launches {r['launches']}, "
              f"shard-local {r['sharded']}; collectives "
              f"{r['collectives']}", flush=True)
    if lanes:
        print(f"  (d) width lanes and disagg in the same spawn: params "
              f"{max(r['lanes']['init_s'] for r in res):.1f} s a rank",
              flush=True)
        mesh_lanes_check(res, want_lanes, new_tokens, len(trace))
    print(f"    {smi_line()}", flush=True)
    return {"launches": r0["launches"],
            "sharded": {k: sum(r["sharded"][k] for r in res)
                        for k in r0["sharded"]}}


def phase_mesh(torch, timer, mux, rows, prompt_len, new_tokens, fp32_runs,
               moe_runs):
    """Phase 17: (a) the shard-local paged wrappers on the card; (b)
    full-width qwen2-1.5b on a (2, 2) mesh; (c) full-width
    granite-moe-3b-a800m on (1, 2); (d) width lanes and disaggregated
    serving in (b)'s spawn.  Returns (the wrappers' summaries, {arch: the
    mesh run's counts})."""
    t_phase = time.perf_counter()
    print(f"phase 17: mesh; {smi_line()}", flush=True)
    summary = mesh_kernels(torch, timer)
    runs = {}
    single = {"qwen2-1.5b": (fp32_runs["fp32"]["outputs"], "phase 4's"),
              "granite-moe-3b-a800m": (
                  moe_runs["granite-moe-3b-a800m"]["fp32"]["outputs"],
                  "phase 14's")}
    for arch, shape in MESH_TRACE_ARCHS.items():
        gc.collect()
        torch.cuda.empty_cache()
        runs[arch] = mesh_serve(torch, arch, shape, mux, rows, prompt_len,
                                new_tokens, *single[arch])
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s; "
          f"{smi_line()}", flush=True)
    return summary, runs


# phase 18: training on a device mesh, four ranks sharing the card
DIST_RANKS = 4
DIST_TIMEOUT = 600             # seconds the spawn may take
DP_STEPS = 3
DP_BATCH = {"batch": 32, "seq": 128, "vocab": 512}      # 8 rows a rank
# (a) the compressed mean against the plain one on the same gradients:
# gscale / 2 (each rank's int8 rounding), plus the fp32 rounding of two
# means of values up to 127 gscale (127 * 2^-23 < 2^-16 of gscale each)
COMPRESS_SLACK = 2.0 ** -15
# (a) the plain DP step against one device's: the first step from the
# same params within phase 13 (b)'s STEP_TOL; after it the params differ
# by AdamW's moves of elements whose gradient is fp32 noise (up to ~0.1
# lr, phase 13 (b)'s NOISE_MOVE band), which moves the later grad norms
# by ~1e-5 relative (2.35e-05 measured on an H100)
DP_LATER_NORM_TOL = 1e-4
# (b) the sharded step against one device's: the reference suite's bars
# (tests/test_distributed.py::test_pjit_train_step_matches_single_device)
SHARD_LOSS_TOL = 1e-4
SHARD_PSUM_RTOL = 1e-5
# (c) qwen2-1.5b's 28 blocks as 4 stages of 7, 8 microbatches of one
# 128-token row: the output against the blocks applied in turn (the
# reference suite's tolerance), the gradients of sum(y * r) against the
# sequential ones over the largest |grad|
PIPE = {"stages": 4, "micro": 8, "seq": 128}
PIPE_TOL = 1e-5
PIPE_GRAD_TOL = 1e-5


def _cuda_ms(torch, fn):
    """fn()'s result and its time in ms by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _replicas_equal(torch, mesh, params):
    """Whether every rank's params are rank 0's, bit for bit (rank 0's
    broadcast over ``data``, ``torch.equal`` on each rank)."""
    same = True
    for leaf in _leaves(params):
        buf = leaf.detach().clone()
        mesh.broadcast(buf, "data", kind="check")
        same = same and torch.equal(buf, leaf.detach())
    return bool(same)


def _compress_check(torch, mesh, loss_fn, params, batch):
    """On one step's gradients: each compressed leaf's int8 mean against
    the plain mean over ``data``, in units of gscale / 2 (the worst)."""
    from repro_torch.core.quant import int8_scale
    from repro_torch.optim import compressed_psum
    from repro_torch.train.step import value_and_grad
    _, _, grads = value_and_grad(loss_fn, params, batch,
                                 torch.Generator("cuda").manual_seed(0))
    n = mesh.shape["data"]
    worst, leaves = 0.0, 0
    for g in _leaves(grads):
        if g is None or g.ndim <= 1 or g.numel() < 4096:
            continue
        mean, _ = compressed_psum(g, torch.zeros_like(g), mesh, "data")
        plain = mesh.all_reduce(g.clone(), "data", kind="check") / n
        gscale = mesh.all_reduce(int8_scale(g).reshape(1), "data",
                                 kind="check", op="max")[0]
        worst = max(worst, float((mean - plain).abs().max() / (gscale / 2)))
        leaves += 1
    return {"worst": worst, "leaves": leaves}


def _dist_dp(torch, mesh, toks):
    """(a): full-width mux-bert-base N=2, the retrieval stage, on a data
    axis of 4: three steps of ``make_compressed_dp_step`` with and without
    compression, the replicas compared after each step; rank 0 also runs
    the same steps on one device on the whole batch."""
    from repro_torch.core import MuxSpec
    from repro_torch.models import MuxBERT, bert_config
    from repro_torch.optim import AdamW, reference_leaves
    from repro_torch.runtime import (init_dp_state, local_batch,
                                     make_compressed_dp_step)
    from repro_torch.train import make_train_step
    from repro_torch.train.mux_stages import retrieval_stage
    cfg = bert_config("base", vocab_size=DP_BATCH["vocab"],
                      max_seq_len=DP_BATCH["seq"])
    mux = MuxSpec(n=2)
    loss_fn = retrieval_stage(cfg, mux)
    batches = [local_batch({"tokens": torch.as_tensor(t, device="cuda")},
                           mesh, n_mux=2) for t in toks]

    def init():
        return MuxBERT.init(torch.Generator("cuda").manual_seed(0), cfg, mux)
    out = {"check": _compress_check(torch, mesh, loss_fn, init(),
                                    batches[0]),
           "rows": int(batches[0]["tokens"].shape[0])}
    for compress in (False, True):
        opt = _Capture(AdamW(lr=STEP_LR))
        state = init_dp_state(init(), opt.opt)
        step = make_compressed_dp_step(loss_fn, opt, mesh=mesh,
                                       compress=compress)
        run = {"loss": [], "norm": [], "ms": [], "bytes": [], "equal": []}
        for i, batch in enumerate(batches):
            mesh.bytes.clear()
            (state, m), ms = _cuda_ms(torch, lambda: step(
                state, batch, torch.Generator("cuda").manual_seed(i)))
            run["bytes"].append(dict(mesh.bytes))
            run["ms"].append(ms)
            run["loss"].append(float(m["loss"]))
            run["norm"].append(float(m["grad_norm"]))
            if i == 0:
                first = opt.grads
            run["equal"].append(_replicas_equal(torch, mesh,
                                                state["params"]))
        if not compress and not mesh.coords["data"]:
            # one device, the whole batch, the same three steps
            p1 = init()
            one = _Capture(AdamW(lr=STEP_LR))
            s1 = one.opt.init(p1)
            step1 = make_train_step(loss_fn, one)
            single = {"loss": [], "norm": []}
            for i, t in enumerate(toks):
                p1, s1, m1 = step1(p1, s1, {"tokens": torch.as_tensor(
                    t, device="cuda")}, torch.Generator("cuda").manual_seed(i))
                single["loss"].append(float(m1["loss"]))
                single["norm"].append(float(m1["grad_norm"]))
                if i == 0:
                    g1 = one.grads
            pairs = [(a, b) for _, _, a, b in reference_leaves(g1, first)
                     if a is not None]
            gmax = max(float(a.abs().max()) for a, _ in pairs)
            single["grad_err"] = max(float((a - b).abs().max())
                                     for a, b in pairs) / gmax
            diffs = [(a.detach() - b.detach()).abs() for _, _, a, b in
                     reference_leaves(p1, state["params"])]
            single["param_max"] = max(float(d.max()) for d in diffs)
            single["param_share"] = (sum(int((d <= 1e-5).sum())
                                         for d in diffs)
                                     / sum(d.numel() for d in diffs))
            run["single"] = single
            del p1, s1, step1, one, g1, pairs, diffs
        out[compress] = run
        del state, step, opt, first
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _lm_mesh_loss(torch, cfg, mux, mesh):
    from repro_torch.models import TransformerLM
    from repro_torch.train import causal_lm_loss
    ctx = None if mesh is None else {"mesh": mesh}

    def loss_fn(p, batch, generator):
        logits = TransformerLM.apply(p, cfg, batch["tokens"], mux=mux,
                                     dtype=torch.float32, use_kernels=False,
                                     extra_ctx=ctx)["logits"]
        return causal_lm_loss(logits, batch["tokens"]), {}
    return loss_fn


def _abs_sum(torch, mesh, params):
    """Σ|params| of the whole tree in fp64: the shards' sums (a vocab-split
    table's zero row left out) summed over ``model``, whole leaves once."""
    sums = torch.zeros(2, dtype=torch.float64, device="cuda")
    for p in _leaves(params):
        t = p.detach()
        if hasattr(p, "vocab_rows"):
            t = t[:p.vocab_rows]
        sums[int(getattr(p, "model_axis", None) is not None)] += \
            t.double().abs().sum()
    split = sums[1:].clone()
    if mesh is not None:
        split = mesh.all_reduce(split, "model", kind="check")
    return float(sums[0] + split[0])


def _lm_steps(torch, params, step, batch):
    """Three steps of ``step``: loss, grad norm and ms (CUDA events) of
    each; the mesh's collective counts and bytes of each when the step
    has one (``step.mesh``)."""
    run = {"loss": [], "norm": [], "ms": [], "counts": [], "bytes": []}
    state = step.opt.init(params)
    for i in range(LM_TRAIN["steps"]):
        if step.mesh is not None:
            step.mesh.counts.clear()
            step.mesh.bytes.clear()
        (params, state, m), ms = _cuda_ms(torch, lambda: step(
            params, state, batch, torch.Generator("cuda").manual_seed(i)))
        run["loss"].append(float(m["loss"]))
        run["norm"].append(float(m["grad_norm"]))
        run["ms"].append(ms)
        if step.mesh is not None:
            run["counts"].append(dict(step.mesh.counts))
            run["bytes"].append(sum(step.mesh.bytes.values()))
    return params, run


def _lm_step_fn(torch, cfg, mux, mesh):
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step
    opt = AdamW(lr=LM_TRAIN["lr"], pattern=len(cfg.block_pattern))
    step = make_train_step(_lm_mesh_loss(torch, cfg, mux, mesh), opt,
                           mesh=mesh)
    step.opt, step.mesh = opt, mesh
    return step


def dist_single_lm(torch, toks):
    """(b)'s single-device run, in the parent before the ranks start:
    full-width qwen2-1.5b (seed 0, remat off as the sharded run), three
    AdamW steps on the whole batch; the weights are freed on return."""
    from repro_torch.configs import get_config
    from repro_torch.core import MuxSpec
    from repro_torch.models import TransformerLM
    cfg = get_config("qwen2-1.5b").replace(remat=False)
    mux = MuxSpec(n=2)
    torch.cuda.reset_peak_memory_stats()
    params = TransformerLM.init(torch.Generator("cuda").manual_seed(0), cfg,
                                mux)
    params, run = _lm_steps(torch, params, _lm_step_fn(torch, cfg, mux,
                                                       None),
                            {"tokens": torch.as_tensor(toks, device="cuda")})
    run["psum"] = _abs_sum(torch, None, params)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return run


def _dist_sharded(torch, mesh, toks):
    """(b): full-width qwen2-1.5b N=2 on (data=2, model=2): this rank's
    shards of the seeded weights (the whole ones dropped) and its data
    slice of the batch, three sharded AdamW steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import MuxSpec
    from repro_torch.models import TransformerLM
    from repro_torch.runtime import local_batch
    from repro_torch.runtime.sharding import shard_params
    cfg = get_config("qwen2-1.5b").replace(remat=False)
    mux = MuxSpec(n=2)
    params = shard_params(TransformerLM.init(
        torch.Generator("cuda").manual_seed(0), cfg, mux), mesh,
        pattern=len(cfg.block_pattern))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = local_batch({"tokens": torch.as_tensor(toks, device="cuda")},
                        mesh, n_mux=2)
    params, run = _lm_steps(torch, params, _lm_step_fn(torch, cfg, mux,
                                                       mesh), batch)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run["psum"] = _abs_sum(torch, mesh, params)
    run["rows"] = int(batch["tokens"].shape[0])
    run["coords"] = dict(mesh.coords)
    return run


def _dist_pipe(torch, mesh):
    """(c): qwen2-1.5b's 28 blocks (seed 0, full width) as 4 stages of 7
    on ``('pipe',)`` 4, 8 microbatches of one 128-token row of seeded
    hidden states: ``pipeline_apply`` and the gradients of sum(y * r) on
    this rank's stage, against the blocks applied in turn in this
    process (per microbatch, as the stages take them)."""
    from repro_torch.configs import get_config
    from repro_torch.core import MuxSpec
    from repro_torch.models import TransformerLM
    from repro_torch.models.blocks import apply_block
    from repro_torch.nn import rope_frequencies
    from repro_torch.runtime import pipeline_apply, stack_stages
    cfg = get_config("qwen2-1.5b")
    n_stages, s = mesh.shape["pipe"], mesh.coords["pipe"]
    per = cfg.n_layers // n_stages
    blocks = cfg.pattern_layers
    layers = TransformerLM.init(torch.Generator("cuda").manual_seed(0), cfg,
                                MuxSpec(n=1))["layers"]
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator("cuda").manual_seed(1)
    shape = (PIPE["micro"], 1, PIPE["seq"], cfg.d_model)
    x = torch.randn(shape, generator=g, device="cuda")
    r = torch.randn(shape, generator=g, device="cuda")
    sin, cos = rope_frequencies(cfg.head_dim,
                                torch.arange(PIPE["seq"], device="cuda"),
                                theta=cfg.rope_theta)
    ctx = {"sin": sin[None], "cos": cos[None], "impl": "naive",
           "use_kernels": False}

    def run_blocks(ps, idx, h):
        for p, i in zip(ps, idx):
            h = apply_block(p, cfg, blocks[i], h, ctx, None)
        return h

    mine = range(s * per, (s + 1) * per)
    own = [t for i in mine for t in _leaves(layers[i])]
    for t in own:
        t.requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()

    def sequential():
        y = torch.stack([run_blocks(layers, range(cfg.n_layers), x[m])
                         for m in range(PIPE["micro"])])
        return y.detach(), torch.autograd.grad((y * r).sum(), own)
    (y_seq, g_seq), seq_ms = _cuda_ms(torch, sequential)
    for t in own:
        t.requires_grad_(False)
    stage = stack_stages([{"layers": [layers[i] for i in mine]}])
    local = list(_leaves(stage))
    for t in local:
        t.requires_grad_(True)
    del layers
    gc.collect()
    mesh.counts.clear()
    mesh.bytes.clear()

    def pipelined():
        y = pipeline_apply(lambda p, h: run_blocks(p["layers"], mine, h),
                           stage, x, mesh=mesh)
        return y.detach(), torch.autograd.grad((y * r).sum(), local)
    (y, g_pipe), pipe_ms = _cuda_ms(torch, pipelined)
    gmax = max(float(a.abs().max()) for a in g_seq)
    return {"stage": s, "n_layers": cfg.n_layers,
            "y_err": float((y - y_seq).abs().max()),
            "y_max": float(y_seq.abs().max()),
            "grad_err": max(float((a[0] - b).abs().max())
                            for a, b in zip(g_pipe, g_seq)) / gmax,
            "seq_ms": seq_ms, "pipe_ms": pipe_ms,
            "counts": dict(mesh.counts), "bytes": dict(mesh.bytes),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _dist_train_child(mesh, dp_tokens, lm_tokens):
    """One rank of phase 18: (a) on the spawn's data axis of 4, (b) on a
    (2, 2) mesh, (c) on a ``('pipe',)`` 4 mesh, all over one process
    group.  Returns what the parent checks."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"coords": dict(mesh.coords), "backend": mesh.backend,
           "reason": mesh.backend_reason}
    out["dp"] = _dist_dp(torch, mesh, dp_tokens)
    out["dp_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["sharded"] = _dist_sharded(torch, mesh_lib.make_serve_mesh(2, 2),
                                   lm_tokens)
    out["sharded_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["pipe"] = _dist_pipe(torch, mesh_lib.make_mesh(
        {"pipe": PIPE["stages"]}))
    out["pipe_s"] = time.perf_counter() - t0
    return out


def phase_dist_train(torch):
    """Phase 18: training on a device mesh, four ranks sharing the card
    over gloo (``launch.mesh.spawn``): (a) the compressed data-parallel
    step, (b) the sharded train step, (c) the GPipe pipeline."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import MarkovCorpus
    from repro_torch.launch import mesh as mesh_lib
    t_phase = time.perf_counter()
    print(f"phase 18: training on a device mesh; {smi_line()}", flush=True)
    corpus = MarkovCorpus(DP_BATCH["vocab"], seed=0)
    dp_tokens = [corpus.sample(np.random.default_rng(i), DP_BATCH["batch"],
                               DP_BATCH["seq"]) for i in range(DP_STEPS)]
    lm_tokens = np.random.default_rng(13).integers(
        4, get_config("qwen2-1.5b").vocab_size,
        (LM_TRAIN["batch"], LM_TRAIN["seq"]))
    single = dist_single_lm(torch, lm_tokens)
    t0 = time.perf_counter()
    res = mesh_lib.spawn(_dist_train_child, DIST_RANKS, 1, device="cuda",
                         args=(dp_tokens, lm_tokens), timeout=DIST_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    r0 = res[0]
    print(f"  {DIST_RANKS} ranks on one card over {r0['backend']} "
          f"({r0['reason']}); spawn {spawn_s:.1f} s (the ranks: (a) "
          f"{r0['dp_s']:.1f} s, (b) {r0['sharded_s']:.1f} s, (c) "
          f"{r0['pipe_s']:.1f} s)", flush=True)
    dist_check_dp(res)
    dist_check_sharded(res, single)
    dist_check_pipe(res)
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s; "
          f"{smi_line()}", flush=True)


def dist_check_dp(res):
    dp = [r["dp"] for r in res]
    check = max(d["check"]["worst"] for d in dp)
    print(f"  (a) mux-bert-base N=2 full width, retrieval stage, "
          f"{DP_BATCH['batch']} x {DP_BATCH['seq']} over data={DIST_RANKS} "
          f"({dp[0]['rows']} rows a rank): compressed mean - plain mean "
          f"<= {check:.4f} x gscale / 2 over {dp[0]['check']['leaves']} "
          f"compressed leaves (tol 1 + {COMPRESS_SLACK:g})", flush=True)
    need(check <= 1 + COMPRESS_SLACK, "(a) a compressed mean is more than "
         "gscale / 2 from the plain mean")
    for compress in (False, True):
        runs = [d[compress] for d in dp]
        tag = "compressed" if compress else "plain"
        for r in runs:
            need(all(r["equal"]), f"(a) {tag}: the replicas' params differ "
                 f"after a step: {r['equal']}")
            need(r["loss"] == runs[0]["loss"], f"(a) {tag}: the ranks' "
                 "averaged losses differ")
            need(all(map(math.isfinite, r["loss"] + r["norm"])),
                 f"(a) {tag}: not finite")
        b = runs[0]["bytes"][-1]
        print(f"  (a) {tag}: loss " + " -> ".join(
            f"{x:.6f}" for x in runs[0]["loss"]) + ", step ms "
            + ", ".join(f"{x:.1f}" for x in runs[0]["ms"])
            + " (rank 0, CUDA events); every rank's params torch.equal "
            f"after each step; bytes handed to all_reduce a step and rank: "
            + ", ".join(f"{k} {v}" for k, v in sorted(b.items())),
            flush=True)
    one = dp[0][False]["single"]
    loss_err = [abs(a - b) / abs(b) for a, b in
                zip(dp[0][False]["loss"], one["loss"])]
    norm_err = [abs(a - b) / abs(b) for a, b in
                zip(dp[0][False]["norm"], one["norm"])]
    print(f"  (a) plain DP against one device's full-batch steps: losses "
          f"within " + ", ".join(f"{x:.2e}" for x in loss_err)
          + f" relative (tol {STEP_TOL['loss']:g}), grad norms "
          + ", ".join(f"{x:.2e}" for x in norm_err)
          + f" (tol {STEP_TOL['grad_norm']:g} on the first step, "
          f"{DP_LATER_NORM_TOL:g} after), the first step's mean gradient "
          f"{one['grad_err']:.2e} of the largest (tol {STEP_TOL['grad']:g});"
          f" params after {DP_STEPS} steps: max diff {one['param_max']:.2e}"
          f", {one['param_share']:.6f} of them within 1e-5", flush=True)
    need(max(loss_err) <= STEP_TOL["loss"], "(a) plain DP loss differs "
         "from one device's")
    need(norm_err[0] <= STEP_TOL["grad_norm"]
         and max(norm_err) <= DP_LATER_NORM_TOL, "(a) plain DP grad norm "
         "differs from one device's")
    need(one["grad_err"] <= STEP_TOL["grad"], "(a) the plain DP mean "
         "gradient differs from one device's")


def dist_check_sharded(res, single):
    sh = [r["sharded"] for r in res]
    loss_err = max(abs(a - b) for r in sh
                   for a, b in zip(r["loss"], single["loss"]))
    psum_err = max(abs(r["psum"] - single["psum"]) / single["psum"]
                   for r in sh)
    # Adam's first step hardly sees a gradient's scale, so the loss and
    # Σ|params| cannot: the grad norm AdamW clips by (each step's, the
    # worst rank) must match one device's, as in (a)
    norm_err = [max(abs(r["norm"][i] - b) / b for r in sh)
                for i, b in enumerate(single["norm"])]
    print(f"  (b) qwen2-1.5b full width, {LM_TRAIN['batch']} x "
          f"{LM_TRAIN['seq']} at N=2 on (data=2, model=2) ({sh[0]['rows']} "
          f"rows a rank), {LM_TRAIN['steps']} AdamW steps: loss "
          + " -> ".join(f"{x:.6f}" for x in sh[0]["loss"])
          + f" (one device " + " -> ".join(f"{x:.6f}" for x in
                                          single["loss"])
          + f"; worst diff {loss_err:.2e}, tol {SHARD_LOSS_TOL:g}); "
          f"Σ|params| {sh[0]['psum']:.6f} vs {single['psum']:.6f} (rel "
          f"{psum_err:.2e}, tol {SHARD_PSUM_RTOL:g}); grad norm "
          + " -> ".join(f"{x:.6f}" for x in sh[0]["norm"])
          + ", relative to one device's " + ", ".join(f"{x:.2e}" for x in
                                                     norm_err)
          + f" (tol {STEP_TOL['grad_norm']:g} on the first step, "
          f"{DP_LATER_NORM_TOL:g} after); one device: ms/step "
          + ", ".join(f"{x:.1f}" for x in single["ms"])
          + f", peak {single['peak_gib']:.2f} GiB", flush=True)
    for r in sh:
        c = r["counts"][-1]
        print(f"    rank {r['coords']}: ms/step " + ", ".join(
            f"{x:.1f}" for x in r["ms"]) + f" (CUDA events), peak "
            f"{r['peak_gib']:.2f} GiB; a step's collectives: "
            + ", ".join(f"{k}×{v}" for k, v in sorted(c.items()))
            + f" ({r['bytes'][-1] / 2**20:.1f} MiB)", flush=True)
        need(c.get("weight_gather", 0) > 0 and c.get("backward", 0) > 0,
             f"(b) rank {r['coords']}: no weight_gather or backward "
             f"collective: {c}")
        need(all(map(math.isfinite, r["loss"] + r["norm"])),
             "(b) not finite")
    need(loss_err <= SHARD_LOSS_TOL, "(b) the sharded loss differs from one "
         "device's")
    need(psum_err <= SHARD_PSUM_RTOL, "(b) the sharded Σ|params| differs "
         "from one device's")
    need(norm_err[0] <= STEP_TOL["grad_norm"]
         and max(norm_err) <= DP_LATER_NORM_TOL, "(b) the sharded grad "
         "norm differs from one device's")


def dist_check_pipe(res):
    pp = sorted((r["pipe"] for r in res), key=lambda p: p["stage"])
    y_err = max(p["y_err"] for p in pp)
    g_err = max(p["grad_err"] for p in pp)
    print(f"  (c) qwen2-1.5b's {pp[0]['n_layers']} blocks as "
          f"{PIPE['stages']} stages on ('pipe',)={PIPE['stages']}, "
          f"{PIPE['micro']} microbatches of 1 x {PIPE['seq']}: output "
          f"within {y_err:.2e} of the blocks in turn (tol {PIPE_TOL:g}, "
          f"|y| max {pp[0]['y_max']:.3f}), gradients of sum(y * r) "
          f"{g_err:.2e} of the largest (tol {PIPE_GRAD_TOL:g})", flush=True)
    for p in pp:
        print(f"    stage {p['stage']}: pipeline forward + backward "
              f"{p['pipe_ms']:.1f} ms, the sequential blocks "
              f"{p['seq_ms']:.1f} ms (CUDA events); collectives "
              + ", ".join(f"{k}×{v}" for k, v in sorted(p["counts"].items()))
              + f", {sum(p['bytes'].values()) / 2**20:.1f} MiB; peak "
              f"{p['peak_gib']:.2f} GiB", flush=True)
    need(y_err <= PIPE_TOL, "(c) the pipeline's output differs from the "
         "sequential blocks'")
    need(g_err <= PIPE_GRAD_TOL, "(c) the pipeline's gradients differ from "
         "the sequential ones")


# phase 19 (a): the reference integration test's four cells, at full width
DRY_CELLS = (("gemma-2b", "train_4k", 1), ("granite-moe-3b-a800m",
                                          "train_4k", 2),
             ("rwkv6-7b", "decode_32k", 2), ("whisper-small", "train_4k", 1))
DRY_TIMEOUT = 400          # seconds the host processes of (a) may take
# phase 19 (b): qwen2-1.5b at N=2, each cell cut from the registry's shape
# to fit one card: (shape, seq_len, global batch)
DRY_CUTS = {"prefill": ("prefill_32k", 2048, 8),
            "decode": ("decode_32k", 8192, 128),
            "train": ("train_4k", 1024, 8)}
DRY_WARMUP, DRY_ITERS = 2, 5


def phase_dryrun(torch):
    """Phase 19: (a) the dry run of four full-width cells on the host,
    (b) three cells of qwen2-1.5b materialised on the card against their
    dry run, (c) two examples on the card."""
    import tempfile
    t_phase = time.perf_counter()
    print(f"phase 19: the dry run; {smi_line()}", flush=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}          # the host processes: no card
    procs = []
    for arch, shape, n in DRY_CELLS:
        out = tmp / f"{arch}_{shape}.jsonl"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mux-n", str(n), "--out", str(out)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)))
    serve_cpu = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "torch_serve_mux.py"),
         "--device", "cpu"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        cells = dry_materialised(torch)
        examples = dry_examples(torch)
        t0 = time.perf_counter()
        recs = []
        for out, p in procs:
            _, err = p.communicate(timeout=DRY_TIMEOUT)
            need(p.returncode == 0, f"(a) dry run of {out.name} exited "
                 f"{p.returncode}: {err[-2000:]}")
            recs += [json.loads(ln) for ln in out.read_text().splitlines()]
        cpu_out, err = serve_cpu.communicate(timeout=DRY_TIMEOUT)
        need(serve_cpu.returncode == 0, f"(c) the serve demo on the CPU "
             f"exited {serve_cpu.returncode}: {err[-2000:]}")
        waited = time.perf_counter() - t0
    finally:
        for _, p in procs + [(None, serve_cpu)]:
            if p.poll() is None:
                p.kill()
                p.wait()
    dry_report_host(recs, waited)
    dry_check_examples(examples, cpu_out)
    print(f"  phase 19: {time.perf_counter() - t_phase:.1f} s ((b) "
          f"{cells:.1f} s); {smi_line()}", flush=True)


def dry_report_host(recs, waited):
    from repro_torch.launch import dryrun, roofline
    print(f"  (a) {len(recs)} cells at full width on the (16, 16) mesh's "
          f"rank (0, 0), fake tensors, host processes (waited {waited:.1f} "
          f"s after (b) and (c)):", flush=True)
    for r in recs:
        print("    " + dryrun.fmt_row(r), flush=True)
    for r in recs:
        need(r["status"] == "ok", f"(a) {r['arch']} {r['shape']}: "
             f"{r['status']} {r.get('traceback', '')[-1500:]}")
        m = r["memory"]
        print(f"    {r['arch']} {r['shape']}: {r['cost']['flops']:.4e} FLOPs, "
              f"{r['cost']['bytes accessed']:.4e} B of eager traffic, "
              f"argument {m['argument_bytes'] / 2**30:.2f} GiB, peak "
              f"{m['peak_bytes'] / 2**30:.2f} GiB a rank; collectives "
              + ", ".join(f"{k}×{int(v)}" for k, v in
                          sorted(r["collectives"]["counts"].items())),
              flush=True)
    need(len(recs) == len(DRY_CELLS), "(a) a cell wrote no record")
    print(roofline.format_md(recs), flush=True)


def dry_materialised(torch):
    """Phase 19 (b); returns its seconds."""
    from repro_torch.configs import SHAPES, Shape, get_config
    from repro_torch.core import MuxSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as S
    from repro_torch.models import TransformerLM
    t0 = time.perf_counter()
    arch, mux = "qwen2-1.5b", MuxSpec(n=2)
    cfg = get_config(arch)
    for kind, (shape, seq, gb) in DRY_CUTS.items():
        full = SHAPES[shape]
        SHAPES[f"{kind}_cut"] = Shape(f"{kind}_cut", seq, gb, full.kind)
        print(f"  (b) {kind}: {arch} N=2 cut from {shape} ({full.global_batch}"
              f" x {full.seq_len}) to {gb} x {seq} to fit one card", flush=True)
    dev = "cuda"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = TransformerLM.init(torch.Generator(device=dev).manual_seed(0),
                                cfg, mux)
    torch.cuda.synchronize()
    held = {"params": (params, torch.cuda.memory_allocated() - base)}
    rng = torch.Generator(device=dev).manual_seed(1)
    try:
        for kind in DRY_CUTS:
            name = f"{kind}_cut"
            sh = SHAPES[name]
            rec = dryrun.run_cell(arch, name, mux_n=2,
                                  mesh_shape={"data": 1, "model": 1},
                                  use_kernels=(kind == "prefill"))
            need(rec["status"] == "ok", f"(b) {kind}: the dry run failed: "
                 f"{rec['status']} {rec.get('traceback', '')}")
            before = torch.cuda.memory_allocated()
            batch = {"tokens": torch.randint(4, cfg.vocab_size,
                                             (sh.global_batch, sh.seq_len
                                              if kind != "decode" else 1),
                                             generator=rng, device=dev)}
            state = {"batch": batch}
            if kind == "train":
                opt = S.make_optimizer(pattern=len(cfg.block_pattern))
                state["opt"] = opt.init(params)
                step = S.build_train_step(arch, mux=mux, optimizer=opt)
                args = (params, state["opt"], batch)
            else:
                state["cache"] = TransformerLM.init_cache(
                    cfg, sh.global_batch // mux.n, sh.seq_len, torch.bfloat16,
                    device=dev)
                step = (S.build_prefill(arch, mux=mux, use_kernels=True)
                        if kind == "prefill" else
                        S.build_decode_step(arch, mux=mux,
                                            seq_len=sh.seq_len))
                args = (params, state["cache"], batch)
            torch.cuda.synchronize()
            alloc = (torch.cuda.memory_allocated() - before
                     + held["params"][1])
            dry_one(torch, kind, rec, step, args, alloc, ops,
                    S.build_prefill(arch, mux=mux, use_kernels=False))
            del args, state, step, batch
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for kind in DRY_CUTS:
            SHAPES.pop(f"{kind}_cut", None)
    return time.perf_counter() - t0


def dry_one(torch, kind, rec, step, args, alloc, ops, plain_prefill):
    """One materialised cell of phase 19 (b) against its dry run;
    ``plain_prefill``: the prefill on the plain model path."""
    from repro_torch.launch.hlo_analysis import storage_bytes
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    exact = storage_bytes(args)
    n_tensors = sum(1 for t in _leaves(args) if isinstance(t, torch.Tensor))
    dry = rec["memory"]["argument_bytes"]
    print(f"  (b) {kind}: argument bytes: dry run {dry}, on the card "
          f"{exact} (the tensors' storages; the caching allocator holds "
          f"{alloc} for their {n_tensors} blocks, each rounded up to 512 B, "
          f"a large one with the unsplit rest of its segment)", flush=True)
    need(dry == exact, f"(b) {kind}: the dry run's argument bytes {dry} "
         f"differ from the card's {exact}")
    need(alloc >= exact, f"(b) {kind}: the allocator holds {alloc} bytes "
         f"for {exact} bytes of storage")
    with grad:
        if kind == "prefill":
            ops.reset_counts()
        for _ in range(DRY_WARMUP):
            out = step(*args)
        launches = ops.counts("launches")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(DRY_ITERS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = step(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times)
    rl = rec["roofline"]
    lb_ms = rl["step_time_lb_s"] * 1e3
    print(f"  (b) {kind}: median {ms:.3f} ms of {DRY_ITERS} (CUDA events; "
          + ", ".join(f"{t:.3f}" for t in times) + f"), the dry run's bound "
          f"{lb_ms:.3f} ms ({rl['bottleneck']}: compute "
          f"{rl['compute_s'] * 1e3:.3f} ms for {rl['flops']:.4e} FLOPs at "
          f"bf16 peak, memory {rl['memory_s'] * 1e3:.3f} ms for "
          f"{rl['bytes']:.4e} B of eager traffic); measured / bound "
          f"{ms / lb_ms:.3f}; peak: dry run {rec['memory']['peak_bytes']} B,"
          f" torch.cuda.max_memory_allocated {peak} B (ratio "
          f"{peak / rec['memory']['peak_bytes']:.3f})", flush=True)
    need(ms >= lb_ms, f"(b) {kind}: measured {ms} ms is under the dry run's "
         f"bound {lb_ms} ms: its count missed work")
    if kind != "prefill":
        return
    print(f"  (b) prefill launches in {DRY_WARMUP} warm-up calls: "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + "; the dry run traced the wrappers' plain versions: "
          + ", ".join(f"{k} {v}" for k, v in
                      sorted(rec["op_census"].items())
                      if k.startswith("kernel:")), flush=True)
    for w in ("mux_embed_combine", "demux_rsa"):
        need(launches[w] == DRY_WARMUP, f"(b) prefill: {w} launched "
             f"{launches[w]} times in {DRY_WARMUP} calls")
    with torch.no_grad():
        kernel = step(*args)[0].float()
        with kernels_as_plain():
            plain = step(*args)[0].float()
        model_plain = plain_prefill(*args)[0].float()
    bf16_logit_check("(b) prefill", "last-position", kernel, plain,
                     model_plain)


def dry_examples(torch):
    """Phase 19 (c): the quickstart and the serve demo on the card."""
    out = {}
    for name in ("torch_quickstart.py", "torch_serve_mux.py"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples" / name)],
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ,
                                "PYTHONPATH": str(ROOT / "src")})
        need(r.returncode == 0, f"(c) {name} on the card exited "
             f"{r.returncode}: {r.stderr[-2000:]}")
        out[name] = r.stdout
        print(f"  (c) {name} on the card: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for ln in r.stdout.splitlines():
            if not ln.startswith("request "):
                print("    " + ln, flush=True)
    return out


def dry_check_examples(out, cpu_out):
    def counts(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("prefill ", "step signatures"))]
    card, cpu = counts(out["torch_serve_mux.py"]), counts(cpu_out)
    print(f"  (c) serve demo count lines, card vs CPU: {card} / {cpu}",
          flush=True)
    need(len(card) == 2 and card == cpu, "(c) the serve demo's count lines "
         "differ between the card and the CPU")
    need("CUDA events" in out["torch_quickstart.py"], "(c) the quickstart "
         "did not time with CUDA events")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
