#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases, in order; any failure exits
non-zero before the result lines are printed:

1. environment: the card, its power limit, torch and nvcc versions, and the
   build of the port's CUDA sources and the L2 probe's (timed);
2. kernel ``cholesky_solve_batched`` against its plain PyTorch version at
   k=64: B=65,536 systems; both regimes and their boundary (B = 1, 255,
   256, 257, the latency kernel's resident count as the card reports it
   and that count +- 1, and 4,201), where each batch must take the kernel
   that ``latency_regime`` names and the other regime's kernel must agree
   too; the flat dense-block entry
   at the main path's dense width; identity-padded / all-zero systems in
   both regimes. Device time per call from ``torch.profiler`` (so host
   gaps do not count) at 256 rows, the dense width and 65,536, beside the
   host's µs per call (wall time over 200 calls) and the library solve's
   device time at the same batch;
3. kernel ``cholesky_solve_hot`` the same way at k=64, C=128, with rows of
   the ML-25M-shaped data's bf16 hot slab, explicit and alpha=2.0 weights
   at every boundary batch, a bitwise repeat, and device time and host cost
   at 256 rows and 65,536;
3b. the solve-variant kernels against their plain versions at k=64,
   B=65,536 and the 256-row block: ``cholesky_solve_2g`` (two grams summed
   on load), ``cholesky_solve_rank1`` in its three (fcols, srows)
   instantiations, ``cholesky_solve_panel``, ``cholesky_solve_schur``
   (srows 1 and 2) and ``cholesky_solve_dual``; ``cholesky_solve_2g`` also
   at B1's boundary batches, with exact zeros in both regimes and its
   device time and host cost at 256 rows; the kernels of
   ``csrc/cholesky_rank_panel.cu`` (``cholesky_solve_rank1``, each
   instantiation, ``cholesky_solve_panel``, ``cholesky_solve_schur``,
   both, and ``cholesky_solve_dual``) also at B = 1, 255, 256, 257, their
   own resident blocks (printed, with the blocks per SM) and that count
   +- 1, and 4,201 (the dual kernel, two systems a block, also at 2, 3
   and twice its resident blocks +- 1), each repeated bitwise, and with
   exact zeros for identity and zero systems inside one wave and past it.
   Then the solve-variant path
   as a user runs it, with the launch counts set to 0 just before and read
   just after: ``solve_spd_t(Gt2=)`` at k=64, B=65,536, and the variant
   probe (``probes/solve_variants.py``) at k=128, B=65,536 with pair, rank1,
   pair_s1, panel, schur, schur_s1 and dual. After the counts are read,
   every kernel and instantiation the probe ran is held against its plain
   version on the probe's own k=128 systems (the kernel on all 65,536, the
   first 4,096 compared) and timed there;
3c. the row gather-and-sum kernel ``gather_rows_sum`` (P1) against its
   plain version: at the gather probe's shape (62,423 x 128 f32 table,
   200,000 ids) with 4, 8 and 16 slots, with its device time
   (``torch.profiler``), host µs per call and one device kernel per call
   asserted, beside the L2 read rate (``probes.gather_latency``'s read
   kernel of ``csrc/l2_probe.cu``, or a faster library yardstick) and the
   L2 bound; at every k in {1, 7, 13, 16, 17, 64, 68, 128, 500, 512} with
   slots 1 and 32 (and 8 at k = 64, 128), at the id counts of
   ``probes.gather_latency.edge_counts`` (0, 1, and each warp step,
   pipeline, block, grid-rule and grid-cap count +- 1), each repeated
   bitwise, exact zeros for no ids; calls on two streams at once, bitwise
   one stream's; at the main path's gathers (one launch over all of the
   user half's bucket ids into the item table, one over the item half's
   into the user table, on the warm-start factors) and at a real row
   block of each half (device time, host µs, one kernel per call); at 0,
   1 and 7 ids, k=13 and k=512, and an unaligned table. Then the
   gather-rate path as a user runs it, with the
   launch count set to 0 just before and read just after: the probes
   ``probes.dma_gather``, ``probes.gather_rates`` (their defaults),
   ``probes.ablate_epoch.run`` on the ML-25M layouts (3 iterations) and
   ``probes.gather_budget.run`` on the item half, then the user half;
4. ML-1M-shaped rank-64 fits through ``ALS.fit``, 10 sweeps, against the
   JAX package's histories recorded on a CPU (rtol 1e-3 per sweep);
5. the main path as a user runs it: ``ALS(rank=64).fit(R)`` on ML-25M-shaped
   data (auto layout, 10 sweeps), train RMSE within 3% of the reference's
   0.3170; the kernels' launch counts come from this run. Then
   epoch_seconds as ``bench.py`` times it: the solver's whole-fit loop on
   uploaded layouts, which must reproduce the fit's history;
6. the ML-25M serving config (``probes/serving.py``, ``bench.py``'s
   ``serving_bench``): on phase 5's ratings, a leave-2-out split trains
   ``ALS(rank=64, alpha=1.0, reg=0.1, n_sweeps=8)`` through ``ALS.fit``
   (launch counts set to 0 before and read after: B1 and B2 launched,
   nothing routed; these counts stay out of the ``kernels`` line); then
   ``recommend(exclude_seen=True)`` for 20,000 users with 'auto' and with
   'exact' on the card (the cached catalog is a CUDA tensor; the two id
   arrays equal; recall@10 within 0.005 of 0.13385 and NDCG@10 within
   0.005 of 0.10337, the reference's TPU record; 512 users' ids equal to a
   float64 NumPy selector's but for near-ties), users/s of a 65,536-user
   query batch beside its bound, and the batch's device split;
7. the ML-1M IMC config (``probes/imc.py``, ``bench.py``'s ``imc_bench``):
   ``IMC(rank=32, reg=0.1, n_sweeps=8, cg_iters=30)`` fit through
   ``IMC.fit`` on the card on 90% of the users, its history within 2e-2 of
   the JAX package's CPU history and the f64 objective of its factors and
   the cold-start RMSE of the held-out users within 1e-3 of the JAX
   package's (the RMSE also under 0.7 std(r)); the timed fit (obs/s, and
   ``vs_baseline`` against one sweep of the port's NumPy oracle
   ``oracle.OracleIMC`` on 100,000 observations) and one profiled sweep
   (device ms, launches, idle share);
   ``recommend(exclude_seen=True)`` for 512 training users, ids equal to a
   float64 selector's but for near-ties; then a checkpoint round trip of
   ``ALS`` (ML-1M ratings, rank 64) and ``IMC``: 4 sweeps with
   ``checkpoint_every=2``, ``resume``, factors equal. No TPU kernel is on
   the IMC path, and its fit launches no kernel of the ``kernels`` line;
8. the training CLI (``train.py``) as a batch job runs it. ML-25M at full
   width: phase 5's ratings written as a real-format ``ratings.csv``
   (header, ids + 1, half stars, a fixed timestamp; ~465 MiB) under
   ``build/chip_smoke/``, then ``train.main(["--ratings", csv, "--rank",
   "64", "--n-sweeps", "10", "--metrics-jsonl", ...])`` in the process with
   the launch counts set to 0 just before and read just after: B1 and B2
   launched and nothing routed (these counts are printed and stay out of
   the ``kernels`` line), the native parser used (no fallback warning),
   the ``.rmtpu.npz`` cache written, the loaded ids (``vocab[ids] - 1``)
   and ratings equal to phase 5's, and the summary's train RMSE (default
   init) within 3% of 0.3170; the write, parse, remap and cache seconds,
   the parser's Mrows/s (with the host's CPU model) and the summary's
   ``fit_seconds`` and ``rows_per_sec`` are printed. Then ML-1M through
   ``python -m recommendation_models_tpu_torch.train`` in subprocesses (no
   ``--platform``): ``synthetic_ratings(6040, 3706, 1_000_209)`` written as
   ``ratings.dat`` and fit at rank 64 with ``--holdout 1 --sse-mode
   separate``, checkpoints every 5 sweeps, a ``torch.profiler`` trace and
   ``--top-n 10``: exit 0, 10 per-sweep records and a summary whose train
   and test RMSE are within 1e-3 of the JAX package's CLI on the same file
   (recorded on a CPU, ``REF_CLI_ML1M``) and recall@10 and NDCG@10 within
   0.005, and a trace with B1's kernel among its CUDA kernel events; again
   with ``--resume`` (10 more sweeps from sweep 10); again from the cache
   alone, the file deleted; and ``--synthetic ml1m --model imc --rank 32
   --side-features 64 --n-sweeps 8``, whose history must equal, bitwise, the
   history of ``IMC.fit`` on the same X, Y and R on the card;
9. the 1-D sharded ALS (``parallel/sharded_als.py``) on one card, S shards
   on ``Mesh((cuda:0,) * S)``. ML-25M at full width: phase 5's layouts
   sharded two ways (``shard_layout``), ``ShardedALSProgram`` with
   ``exchange='allgather'`` (dense block and hot columns kept) from phase
   5's warm start placed by ``place_factors``, 10 sweeps through
   ``make_fit`` with the launch counts set to 0 just before and read just
   after: B1 and B2 launched, nothing routed, the history within rtol
   1e-3 / atol 1e-4 of phase 5's (tests/test_sharded.py's shard-invariance
   tolerance) and train RMSE within 3% of 0.3170; the set-up (both
   ``shard_layout`` calls, the placement), the sweeps, one profiled
   sweep's device time and phase 5's epoch beside them. Then sharded
   serving on that fit: ``sharded_topk`` over the sharded V with each
   user's training items excluded (``grouped_exclusion_topk``, k=10), for
   20,000 users, whose ids must equal the exact float64 top-10 of the same
   factors but for near-ties (relative gap under 1e-6). Then ML-1M, rank
   64, on ``Mesh((cuda:0,) * 4)``: the program ``ALS(n_shards=4,
   exchange=...)`` builds (``probes.exchange.program_for``) for
   'allgather', 'all_to_all' and 'hybrid', explicit, and 'allgather'
   implicit (alpha 1.0), each from phase 4's warm start for 10 sweeps, its
   history within rtol 1e-3 / atol 1e-4 of the single-device ``ALS.fit``
   on the card, and its ``collective_bytes_per_sweep()`` equal to the JAX
   package's (``REF_SHARDED_BYTES_ML1M``); 'allgather' launches B1 and
   B2, 'all_to_all' B1 only, 'hybrid' B2 only (``SHARDED_ML1M_KERNELS``);
10. the 2-D observation-parallel ALS (``parallel/hybrid_als.py``) and the
   sharded IMC on one card. ML-25M at full width, rank 64, ``(D, S) = (2,
   2)`` on a 2-D mesh over ``(cuda:0,) * 4``: phase 5's ratings laid out
   with ``DataConfig(dense_whales=False, hot_cols=0)`` and the rank-64
   bucket growth (the 2-D program has neither block), ``shard_layout`` two
   ways, ``split_layout_slices`` two ways, ``HybridALSProgram`` from phase
   5's warm start placed by ``place_factors``, 5 sweeps through
   ``make_fit`` with the launch counts set to 0 just before and read just
   after: B1 launched (each position solves its row shard's summed
   systems), B2 not, nothing routed, the history within rtol 1e-3 / atol
   1e-4 of phase 5's first 5 sweeps; the set-up split (plain layouts,
   ``shard_layout``, ``split_layout_slices``, placement), seconds and
   device ms a sweep, and the peak device memory. Then ML-1M, rank 64,
   ``(2, 2)``, explicit and implicit (alpha 1.0), the program
   ``ALS(n_shards=4, num_slices=2, topology='obs_parallel')`` builds
   (``probes.exchange.program_for``), from phase 4's warm start for 10
   sweeps: its history within rtol 1e-3 / atol 1e-4 of the single-device
   ``ALS.fit`` on the card, its ``collective_bytes_per_sweep()`` equal to
   the JAX package's (``REF_HYBRID_BYTES_ML1M``). Then phase 7's IMC config
   sharded four ways on ``Mesh((cuda:0,) * 4)`` (``probes.imc.sharded_fit``):
   the history within 2e-2 of phase 7's, the f64 objective of its factors
   within 1e-3 of phase 7's, ``exchange_bytes_per_sweep_`` equal to the
   JAX package's (``REF_IMC_BYTES_ML1M``), the fit's seconds beside phase
   7's; and ``recommend(exclude_seen=True, method='exact')`` for phase 7's
   512 users through ``sharded_topk`` (the projected catalog row-sharded on
   the card), whose ids must equal single-device serving of the same
   factors but for near-ties (relative float64 gap under 1e-6);
11. the multi-process runtime (``parallel.mesh.initialize_distributed``,
   gloo on 127.0.0.1) on the one card: MP_P processes, one shard each on
   ``cuda:0``, each child with a time limit and killed by its PID past it
   (``probes.multiprocess.launch``). The training CLI at ML-25M, rank 64,
   ``--n-shards 2 --exchange allgather --n-sweeps 5`` (auto layout: dense
   block, hot columns) with ``--coordinator``, ``--num-processes`` and
   ``--process-id``: both processes exit 0, only process 0 prints and
   writes the JSONL, whose history equals (rtol 1e-6) the same sharded fit
   in this one process on ``Mesh((cuda:0,) * 2)`` from the same default
   sharded init and falls at every sweep; its sweep-5 RMSE is printed
   beside phase 8's single-device CLI (another init: not gated). Then
   ``python -m recommendation_models_tpu_torch.probes.multiprocess`` in
   MP_P processes: ML-25M 1-D allgather (each process launches B1 and B2
   and routes nothing; its set-up seconds, seconds a sweep beside phase
   9's one-process S = 2 sweep, and peak memory are printed; these launch
   counts, summed, are the ``multiprocess`` path of the ``kernels``
   line); ML-1M 'allgather', 'all_to_all', 'hybrid' explicit and
   'allgather' implicit (alpha 1.0), each history equal (rtol 1e-6) to the
   same program in one process and its ``collective_bytes_per_sweep()``
   equal to the JAX package's at S = 2 (``REF_MP_BYTES_ML1M``); the ML-1M
   2-D program, one slice a process, the same way; a fault injection at
   ML-1M (exit 17 after sweep 2 with checkpoints, then ``--resume``, whose
   finished history equals the uninterrupted run's); and phase 7's IMC
   config sharded over the processes (history within 2e-2 of phase 7's,
   f64 objective within 1e-3);
12. the port's bench (``recommendation_models_tpu_torch.bench``, the
   counterpart of ``bench.py``) in the process, one JSON line in
   ``bench.py``'s schema per run, each train line with the launch counts
   set to 0 just before and read just after: the default (ML-25M, rank 64,
   explicit) on phase 5's layouts, rank 128 on phase 5's ratings (its own
   layouts: no hot columns, dense threshold 2,048, growth 1.25, a 4,096 MB
   gather budget, the riding SSE), rank 64 implicit (alpha 1.0) on phase
   5's layouts; then, phase 5's data freed, synth-100M laid out at rank 64
   (a 2 MB budget, riding SSE), then at rank 128 (1,536 MB), each run for
   the bench's 10 sweeps (the ratings made once and both layouts built in
   a child process on the host beside phase 11, ``start_synth_data``, and
   loaded through the bench's layout cache). Each train line: ``nnz`` and
   ``gathered_rows_per_epoch`` equal to the JAX package's (``BENCH_LINES``,
   with the command that counted them), train RMSE within
   ``BENCH_RMSE_BAND`` x the JAX bench's TPU record (the implicit line:
   within 1e-3 of the JAX package's float32 value, recorded on a CPU by
   the command beside ``REF_IMPLICIT_ML25M``), the history's last value within 1e-3
   of a direct RMSE of the final factors, B1 launched (B2 too at rank 64),
   nothing routed, TF32 off, ``max_memory_allocated`` reported. Then the
   serving mode (ML-25M, rank 64: recall@10 and NDCG@10 within 0.005 of the
   anchors, 'auto' ids equal to 'exact') and the IMC mode (ML-1M, rank 64
   capped to 32: history within 2e-2 of ``REF_IMC_ML1M``, cold-start RMSE
   within 1e-3);
13. the solve kernels past k = 128, the rank-160 fit, the shape fuzz,
   the quality probes and the variants past k = 128. (a) B1, B2 (C = the
   reference's hot cap, 24 and 16) and B3 (both grams summed) at k = 136
   and 160, at 256 and 65,536 rows: each launched (nothing routed),
   against its plain version, repeated bitwise; device ms
   (``torch.profiler``), event ms, host µs and plain ms at 256 rows, the
   bound and ``torch.linalg.cholesky`` + ``cholesky_solve`` as the
   library's device ms, and the kernel's frame and blocks an SM (B1, B2
   and B3 past kp = 128 take the panel frame of
   ``csrc/cholesky_rank_panel.cu`` past two waves, at k = 160 past one:
   ``ops.cholesky.solve_frame``); where B3 takes it, bitwise equal to B1's
   panel-frame kernel on the f32 sum G + G2, and where B2 takes it, with
   an all-zero hot slab bitwise equal to that kernel on G; and B3's entry
   ``ops.solve.solve_spd_t(Gt2=)`` at k = 160, 65,536 rows, counted (one
   panel-frame launch), bitwise equal to the wrapper. (b) The one-block kernel
   ``cholesky_solve_large`` (``csrc/cholesky_large.cu``, a thread-block
   cluster a system, ``ops.cholesky.cluster_size`` CTAs) at k = 168, 256,
   512 and 656, B = 1 and ``block_batch(k)`` (with two grams: 1 and the
   halved block), through the batch wrappers: against the plain versions,
   bitwise, zero and identity systems exactly 0, event and device ms,
   host µs, plain ms, the bound, the library and the cluster size; at k =
   168 ``block_batch(k)`` systems past one wave of clusters
   (``multiwave_cluster``: 120 clusters of 2) against the plain version and
   bitwise equal to the rule's launch; then its paths with the
   launch counts set to 0 just before and read just after:
   ``ops.solve.solve_spd_t`` (and ``Gt2=``) at each order and one block,
   and ``ALS(rank=256).fit`` on ML-100K-shaped ratings (reg 1.0, exact
   SSE, 5 sweeps), whose blocks of at most 48 rows take the kernel and the
   larger ones are routed (the JAX package sends them to XLA), its history
   within 1e-3 of ``solver='xla'``. (c) The kernel shape fuzz
   (``probes/fuzz_kernel_shapes.py``), 25 trials of seed 0: all within 5e-3
   of the anchor, ``ROUTED`` counting exactly the trials that
   ``pallas_supported`` refuses. (d) ``ALS(rank=160).fit`` on phase 5's
   ratings (the auto policy: no hot columns, dense threshold 3,200, a
   4,096 MB gather budget, the riding SSE), 10 sweeps from the bench's warm
   start, the launch counts set to 0 just before and read just after: B1
   launched through its latency kernel (``LATENCY_LAUNCHES``) and, past one
   wave, the panel frame of csrc/cholesky_rank_panel.cu, nothing routed; peak
   memory; the same fit with ``solver='xla'`` (history within 1e-3); on the
   fit's layouts (its layout cache) the bench's timed fit (one warm-up
   sweep, 10 timed: the epoch, history equal to the fit's), a direct RMSE
   of its factors within 1e-3 of the riding history's last, one profiled
   sweep (device ms, B1's device ms, idle share), the dense rows and their
   TFLOP a sweep;
   and ML-1M at rank 160 (exact SSE) within 1e-3 a sweep of the JAX
   package's f32 CPU history (``REF_ML1M_R160``). (g, run after d)
   ``ALS(rank=160, hot_cols=16).fit`` on the same ratings and warm start
   (C = ``hot_cols_cap(160)``, the auto policy otherwise), 3 sweeps, the
   counts set to 0 just before and read just after: B2 launched in its
   panel frame (``PANEL_LAUNCHES``; its latency launches counted), nothing
   routed; the same fit with ``solver='xla'`` on the same layout cache
   (history within 1e-3); on those layouts one timed fit (the epoch) and
   B2's and B1's device ms a sweep from a trace of the last of three
   sweeps that recorded every launch of its sweep (else null). (e) The ALS quality probe
   (``probes/quality_parity.py``) at its 3 seeds: the oracle on the host,
   ``ALS`` on the card, test RMSE within max(1e-3, 0.1 x the oracle's
   band) and recall@10 / NDCG@10 within 0.01 per seed; then the IMC
   probe (``probes/quality_parity_imc.py``) at its 3 seeds, its oracle
   fitted by three child processes (one core each, started before phase
   12, so they share the host with phases 12 and 13) and ``IMC`` on the
   card: the history within 2e-2 of the oracle's from the second sweep
   (the first within 2e-2 of the JAX package's f32 history) and the test
   predictions within rtol 2e-2, atol 2e-2. (f) B4 (its three
   instantiations), B5a, B5b (srows 1 and 2) and B5c over the reference's
   Pallas range (``phase_variant_range``): each at k = 136, 157, 160 (B4
   and B5c also 129 and 153, whose last panel is four columns wide; Schur
   144, 160) and B = 1, 37, 4,096 (dual also 2 and 4,097) on its
   ``csrc/cholesky_rank_panel.cu`` kernel, and at the one-block orders k =
   161, 168, 256, 512, 656 (Schur 176, 256, 512, 656) at B = 1 and
   ``block_batch(k)`` (dual also 3 and ``block_batch(k) - 1``) on
   ``csrc/cholesky_large_variants.cu``'s: against its plain version,
   repeated bitwise, the launch, one-block and route counts equal to what
   ``kernel_supported`` predicts (nothing routed), zero and identity
   systems exactly 0 at k = 160 and 656, one batch past the block at k =
   168 (Schur 176) routed and counted, ``block_batch(k)`` systems there
   past one wave of clusters bitwise equal to the rule's launch; device
   ms (``torch.profiler``),
   event ms, host µs, plain ms (256 rows), the library's device ms and the
   bound at k = 136 and 160 (Schur 144, 160) at 256 and 65,536 rows, and
   event and device ms, host µs, plain ms, library ms and the bound at k =
   168 (Schur 176), 256, 512 and 656 at ``block_batch(k)``; then the
   variant probe at PSV_K = 160 (8,192 systems) and 656 (8) with every
   variant, the counts set to 0 just before each run and read just after:
   nothing routed, every variant kernel launched, past k = 160 through its
   one-block kernel;
14. the JAX package's last six scripts as the port's probes, and its four
   examples (``examples/torch_port/``). On phase 5's ML-25M layouts,
   before phase 12 frees them: (d) ``probes.profile_half`` on each side
   at rank 64 (one warm half-sweep, then one under ``torch.profiler``: the
   device ms by stream and kernel beside the CUDA-event ms of the same
   half-sweep, flagged past 10% apart; B2 launched in the user half, B1
   in the item half, nothing routed; the Chrome traces under
   ``build/chip_smoke/profile_half/``) and
   (f) ``probes.ablate_gram_layout`` on the user side (``gram_rhs_t``
   against ``gram_rhs`` over every gathered row block, their sums equal,
   their times and ``aten::copy_`` events). After phase 13: (g) the four
   examples started at once in subprocesses on the card (each exit 0,
   within ``EXAMPLE_TIMEOUT``); beside them (b) ``probes.sharded_hot``
   (a 1-shard ``ShardedALSProgram`` with 16 hot columns and
   ``solver='pallas'``, the counts set to 0 just before and read just
   after: B2 launched, nothing routed; its ``make_fit(2)`` history within
   rtol 1e-3 of ``ALS(solver='xla')``) and (c)
   ``probes.serving_quality`` at ML-1M (its 1,000,000 ratings), rank 64,
   8 sweeps, seeds 0, 1 and 2 (each model path within 5e-4 of its frozen
   f64 path and within 0.005 of the JAX package's CPU value,
   ``REF_SERVING_SEEDS_ML1M``; seed 0 again through ``NPZ_OUT`` ->
   ``NPZ_IN``, its record equal); then, timed, (a)
   ``probes.sharded_scan`` at ML-1M, rank 64, 10 sweeps, one shard, with
   ``FASTPATHS`` 0 and 1 (stepwise against scanned within the script's
   rtol; ``SCAN_WINDOWS`` timed windows a side, alternating, their
   seconds and ms a sweep; the probe's launch counts, some 35 s of
   profiling, are left to the probe alone) and (e) ``probes.split_gather`` at bf16
   and f32 (the three lines' ms a pass and M rows/s, the split pass's sum
   within 1e-4 of the baseline's);
15. one JSON line describing every kernel, then the result line. Each
   entry's numbers are at its ``k`` and ``batch``; B4, B5a, B5b and B5c
   have ``resident`` (their kernel's resident blocks at k=64; B4 and B5b
   per instantiation in ``resident_by_instantiation``); B1, B2 and B3 also have
   ``resident`` (the latency kernel's resident blocks), ``regime_by_batch``
   and ``by_batch`` (device ms, host µs, library device ms and bound ms at
   each timed batch); a kernel the probe runs also has ``at_probe_shape``,
   its numbers at the probe's k=128, and ``gather_rows_sum`` has
   ``device_ms``, ``host_us``, ``l2_bound_ms`` and ``l2_tb_s`` at the
   probe's shape, ``at_main_path`` (both halves' gathers) and
   ``at_row_block`` (a row block of each half). B1's and B2's ``launches``
   are the main path's, the sharded phase's, the multi-process phase's and
   the bench phase's five train lines (B1's also the 2-D phase's and the
   rank-160 fit's, B2's also the sharded hot smoke's), each in
   ``launches_by_path``; B1, B2 and B3 have
   ``wide_orders`` (phase 13a's numbers by k and batch, each with its
   kernel's ``frame`` and ``blocks_per_sm``), and
   ``cholesky_solve_large`` is at k = 656, B = 8 with ``by_order`` (phase
   13b's numbers, each with its ``cluster``), ``multiwave`` (the launch
   past one wave) and its launches from phase 13b's paths. B4, B5a, B5b
   and B5c have ``wide_orders`` (phase 13f's numbers by k and batch, each
   with its factor ``frame`` and ``blocks_per_sm``) and
   ``by_order`` (its one-block numbers by k, each with its ``cluster``),
   ``multiwave`` (k, batch and cluster of its launch past one wave), B4's
   and B5b's with each
   instantiation's event ms in ``instantiations``, ``large_source`` (the
   one-block kernel's source), ``max_abs_err_all``, and their launches by
   path in ``launches_by_path`` (the probe at k = 128, 160 and 656).

``--profile`` adds one profiled main-path sweep and prints its device time
by kernel and the device's idle share (not run by default).

Tolerances: a solve kernel agrees with its plain version when
|x - x_plain| <= 5e-4 * scale + 5e-4 * |x_plain|, scale = max(|x_plain|, 1)
(the reference's tests/test_pallas_cholesky.py tolerance). The gather
kernel agrees per column j when |x - x_plain| <= 2e-6 * sum_i
|table[idx_i, j]| + 1e-6: the two add the same f32 rows in different
orders.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s without
# tensor cores; bounds are stated against them at the card's power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ATOL_SCALE = 5e-4
RTOL = 5e-4

RANK = 64
SWEEPS = 10
RMSE_ANCHOR = 0.3170        # BENCH_r05.json train_rmse, ML-25M rank 64
RMSE_ANCHOR_RTOL = 0.03
# the serving config's recall@10 and NDCG@10 in the reference's record (TPU
# v5 lite, BASELINE.md "Round-5 serving-quality closure"; its band over 3
# fit seeds is 0.0018 and 0.0021): quality anchors, not speed targets
SERVING_RECALL_ANCHOR = 0.13385
SERVING_NDCG_ANCHOR = 0.10337
SERVING_BAND = 0.005
SERVING_CHECK_USERS = 512   # users held against a float64 NumPy selector
HISTORY_RTOL = 1e-3

# ML-1M-shaped rank-64 train-RMSE histories of the JAX package, recorded on
# a CPU with (MODE = "separate" and "auto"):
#   JAX_PLATFORMS=cpu python -c '
#   import numpy as np, scipy.sparse as sp
#   from recommendation_models_tpu.data.synthetic import synthetic_ratings
#   from recommendation_models_tpu import ALS
#   u, i, r = synthetic_ratings(6040, 3706, 1_000_209, rank=16, seed=0)
#   R = sp.csr_matrix((r, (u, i)), shape=(6040, 3706))
#   g = np.random.default_rng(0)
#   U0 = 0.01 * g.standard_normal((6040, 64)).astype(np.float32)
#   V0 = 0.01 * g.standard_normal((3706, 64)).astype(np.float32)
#   m = ALS(rank=64, reg=0.1, n_sweeps=10, solver="xla",
#           compute_dtype="float32", sse_mode=MODE,
#           platform="cpu").fit(R, U0=U0, V0=V0)
#   print([float(x) for x in m.history_])'
# Every sweep of the exact (separate masked_sse) history is checked. Of the
# auto (riding-identity) history only the first three sweeps are: its later
# sweeps carry the identity's own f32 cancellation error (sweep 10: 0.217656
# against a direct RMSE of the same factors of 0.217412), which differs
# between summation orders by about that much.
REF_ML1M_SEPARATE = [
    0.8559578061103821, 0.477059543132782, 0.3594265878200531,
    0.31086301803588867, 0.2821512818336487, 0.2622409462928772,
    0.24724319577217102, 0.23535947501659393, 0.22561043500900269,
    0.21741198003292084]
REF_ML1M_AUTO = [
    0.8559545874595642, 0.4769742488861084, 0.3592991530895233,
    0.3109422028064728, 0.2821660339832306, 0.26207029819488525,
    0.2472238838672638, 0.23537057638168335, 0.22535580396652222,
    0.21765612065792084]

# The ML-1M IMC config (bench.py::imc_bench, BASELINE config 4) of the JAX
# package, recorded on a CPU: the objective history, the f64 objective of
# the final factors over the training observations, and the cold-start RMSE:
#   JAX_PLATFORMS=cpu python -c '
#   import numpy as np
#   from recommendation_models_tpu.data.synthetic import (
#       synthetic_imc_ratings, synthetic_side_features)
#   from recommendation_models_tpu import IMC
#   X, Y = synthetic_side_features(6040, 3706, 64, 48, seed=0)
#   u, i, r, _, _ = synthetic_imc_ratings(X, Y, 1_000_209, rank=32,
#                                         noise=0.05, seed=0)
#   cold = u >= int(0.9 * 6040)
#   tr = ~cold
#   m = IMC(rank=32, reg=0.1, n_sweeps=8, cg_iters=30, seed=0,
#           platform="cpu").fit((u[tr], i[tr], r[tr]), X, Y)
#   W, H = np.float64(m.W_), np.float64(m.H_)
#   p = np.einsum("ok,ok->o", np.float64(m._X[u[tr]]) @ W,
#                 np.float64(m._Y[i[tr]]) @ H)
#   print([float(h) for h in m.history_])
#   print(0.5 * ((r[tr] - p) ** 2).sum()
#         + 0.05 * ((W ** 2).sum() + (H ** 2).sum()))
#   print(float(np.sqrt(np.mean((m.predict(u[cold], i[cold]) - r[cold])
#                               ** 2))))'
# The default init (seed 0) is W, then H, from default_rng(0) at 0.1 scale:
# the timed fit's W0/H0. The history is the f32 identity r2 - 2 b.M + quad
# (r2 = 2.87e7 here), whose cancellation the JAX package's own values carry:
# they sit up to 179 (6.9e-3) off the f64 objective of the same factors,
# while the port's CPU fit's f64 objectives agree with the JAX package's
# within 6.4e-6 at every sweep. So the history is held at 2e-2 (the
# reference's oracle tolerance, tests/test_imc.py), and the f64 objective
# of the final factors and the cold-start RMSE at HISTORY_RTOL.
REF_IMC_ML1M = [
    464696.84375, 47753.94140625, 29259.392578125, 26714.16796875,
    26307.580078125, 26087.482421875, 25746.619140625, 25736.861328125]
REF_IMC_ML1M_OBJECTIVE = 25718.831047005297
REF_IMC_ML1M_COLD_RMSE = 0.1114293709397316
IMC_HISTORY_RTOL = 2e-2
IMC_COLD_GATE = 0.7         # tests/test_imc.py: cold RMSE < 0.7 std(r)

# The JAX package's training CLI on the ML-1M-shaped ratings.dat that phase 8
# writes, recorded on a CPU (the summary's numbers; recall and NDCG as the
# CLI rounds them, to 4 places):
#   python -c '
#   from recommendation_models_tpu_torch.probes.parser import write_ratings
#   from recommendation_models_tpu_torch.data.synthetic import (
#       synthetic_ratings)
#   u, i, r = synthetic_ratings(6040, 3706, 1_000_209, rank=16, seed=0)
#   write_ratings("ml1m/ratings.dat", u + 1, i + 1, r, "dat")'
#   JAX_PLATFORMS=cpu python -m recommendation_models_tpu.train \
#       --ratings ml1m/ratings.dat --rank 64 --n-sweeps 10 --holdout 1 \
#       --sse-mode separate --platform cpu --metrics-jsonl ref.jsonl
# (646,100 ratings after the generator's dedupe; 6,040 users held out.)
REF_CLI_ML1M = {"train_rmse": 0.2151706963777542,
                "test_rmse": 1.2196555137634277,
                "recall_at_10": 0.0012, "ndcg_at_10": 0.0005}
CLI_RANKING_BAND = 0.005
# B1's kernel in a profiler trace: chol_solve_kernel<NTH, NT, HOT=false,
# TWO_G=false, LAT>, demangled or mangled
B1_SYMBOL = re.compile(r"chol_solve_kernel<\s*\d+,\s*\d+,\s*false,\s*false,"
                       r"|chol_solve_kernelILi\d+ELi\d+ELb0ELb0E")

# The sharded phase (9): S on one card at ML-25M, S at ML-1M, the users
# served, and tests/test_sharded.py's shard-invariance tolerance.
SHARDED_S = 2
SHARDED_ML1M_S = 4
SHARDED_SERVE_USERS = 20_000
SHARDED_RTOL, SHARDED_ATOL = 1e-3, 1e-4
# The kernels each ML-1M exchange launches: every bucket of a layout with
# hot columns takes B2, and B1 then serves only the dense block, which
# 'hybrid' turns off; 'all_to_all' has neither block, so B1 takes every
# bucket.
SHARDED_ML1M_KERNELS = {
    "allgather": ("cholesky_solve_batched", "cholesky_solve_hot"),
    "all_to_all": ("cholesky_solve_batched",),
    "hybrid": ("cholesky_solve_hot",),
}
# collective_bytes_per_sweep() of the JAX package's sharded programs at
# ML-1M, rank 64, S = 4, recorded on a CPU:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
#   python -c '
#   import scipy.sparse as sp
#   from recommendation_models_tpu import ALS
#   from recommendation_models_tpu.data.synthetic import synthetic_ratings
#   u, i, r = synthetic_ratings(6040, 3706, 1_000_209, rank=16, seed=0)
#   R = sp.csr_matrix((r, (u, i)), shape=(6040, 3706))
#   for ex, alpha in (("allgather", None), ("all_to_all", None),
#                     ("hybrid", None), ("allgather", 1.0)):
#       m = ALS(rank=64, reg=0.1, alpha=alpha, n_shards=4, exchange=ex,
#               n_sweeps=1, platform="cpu").fit(R)
#       print(ex, alpha, m.exchange_bytes_per_sweep_)'
REF_SHARDED_BYTES_ML1M = {
    ("allgather", None): {
        "user_half": 711936, "item_half": 1159680,
        "per_sweep_total": 1871616, "sse_extra": 711936,
        "per_sweep_with_sse": 2583552},
    ("all_to_all", None): {
        "user_half": 723840, "item_half": 1179360,
        "per_sweep_total": 1903200, "sse_extra": 723840,
        "per_sweep_with_sse": 2627040},
    ("hybrid", None): {
        "user_half": 1166208, "item_half": 1413728,
        "per_sweep_total": 2579936, "sse_extra": 1166208,
        "per_sweep_with_sse": 3746144},
    ("allgather", 1.0): {
        "user_half": 711936, "item_half": 1159680, "psum_gram": 49152,
        "per_sweep_total": 1920768, "sse_extra": 711936,
        "per_sweep_with_sse": 2632704},
}

# The 2-D phase (10): (D, S) at ML-25M and ML-1M, the ML-25M sweeps, and
# the sharded IMC's shard count.
HYBRID_D, HYBRID_S = 2, 2
HYBRID_SWEEPS = 5
IMC_SHARDED_S = 4
# collective_bytes_per_sweep() of the JAX package's 2-D program at ML-1M,
# rank 64, (D, S) = (2, 2), and exchange_bytes_per_sweep_ of its sharded IMC
# at phase 7's config, S = 4, recorded on a CPU (alpha does not enter the
# 2-D count, and both objectives printed the same dict):
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
#   python -c '
#   import scipy.sparse as sp
#   from recommendation_models_tpu import ALS, IMC
#   from recommendation_models_tpu.data.synthetic import (
#       synthetic_ratings, synthetic_imc_ratings, synthetic_side_features)
#   u, i, r = synthetic_ratings(6040, 3706, 1_000_209, rank=16, seed=0)
#   R = sp.csr_matrix((r, (u, i)), shape=(6040, 3706))
#   for alpha in (None, 1.0):
#       m = ALS(rank=64, reg=0.1, alpha=alpha, n_shards=4, num_slices=2,
#               topology="obs_parallel", n_sweeps=1, platform="cpu").fit(R)
#       print(alpha, m.exchange_bytes_per_sweep_)
#   X, Y = synthetic_side_features(6040, 3706, 64, 48, seed=0)
#   u, i, r, _, _ = synthetic_imc_ratings(X, Y, 1_000_209, rank=32,
#                                         noise=0.05, seed=0)
#   tr = u < int(0.9 * 6040)
#   m = IMC(rank=32, reg=0.1, n_sweeps=1, cg_iters=30, seed=0, n_shards=4,
#           platform="cpu").fit((u[tr], i[tr], r[tr]), X, Y)
#   print(m.exchange_bytes_per_sweep_)'
REF_HYBRID_BYTES_ML1M = {
    "ici": 1247488, "dcn": 81086720, "per_sweep_total": 82334208,
    "sse_extra": 474368, "per_sweep_with_sse": 82808576}
REF_IMC_BYTES_ML1M = {
    "w_step": 761484, "h_step": 883980, "per_sweep_total": 1645464}

# The multi-process phase (11): processes on the one card (one shard each),
# each child's time limit, and the tolerance of a
# history against the same program in one process (the gathers and the
# sums in shard order make it bit for bit; f32 RMSE rounding aside).
MP_P = 2
MP_TIMEOUT = 300
MP_RTOL = 1e-6
# collective_bytes_per_sweep() of the JAX package's sharded programs at
# ML-1M, rank 64, S = 2 (and of its 2-D program at (D, S) = (2, 1)),
# recorded on a CPU:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
#   python -c '
#   import scipy.sparse as sp
#   from recommendation_models_tpu import ALS
#   from recommendation_models_tpu.data.synthetic import synthetic_ratings
#   u, i, r = synthetic_ratings(6040, 3706, 1_000_209, rank=16, seed=0)
#   R = sp.csr_matrix((r, (u, i)), shape=(6040, 3706))
#   for ex, alpha in (("allgather", None), ("all_to_all", None),
#                     ("hybrid", None), ("allgather", 1.0)):
#       m = ALS(rank=64, reg=0.1, alpha=alpha, n_shards=2, exchange=ex,
#               n_sweeps=1, platform="cpu").fit(R)
#       print(ex, alpha, m.exchange_bytes_per_sweep_)
#   m = ALS(rank=64, reg=0.1, n_shards=2, num_slices=2,
#           topology="obs_parallel", n_sweeps=1, platform="cpu").fit(R)
#   print(m.exchange_bytes_per_sweep_)'
REF_MP_BYTES_ML1M = {
    ("allgather", None): {
        "user_half": 474368, "item_half": 773120,
        "per_sweep_total": 1247488, "sse_extra": 474368,
        "per_sweep_with_sse": 1721856},
    ("all_to_all", None): {
        "user_half": 482560, "item_half": 786240,
        "per_sweep_total": 1268800, "sse_extra": 482560,
        "per_sweep_with_sse": 1751360},
    ("hybrid", None): {
        "user_half": 777472, "item_half": 937632,
        "per_sweep_total": 1715104, "sse_extra": 777472,
        "per_sweep_with_sse": 2492576},
    ("allgather", 1.0): {
        "user_half": 474368, "item_half": 773120, "psum_gram": 32768,
        "per_sweep_total": 1280256, "sse_extra": 474368,
        "per_sweep_with_sse": 1754624},
    "obs_parallel": {
        "ici": 0, "dcn": 162173440, "per_sweep_total": 162173440,
        "sse_extra": 0, "per_sweep_with_sse": 162173440},
}

MAIN_KERNELS = ("cholesky_solve_batched", "cholesky_solve_hot")

# The bench phase (12): the port's bench (recommendation_models_tpu_torch.bench)
# in-process at the JAX package's recorded ALS configurations. Per line: its
# name, the BenchConfig, the train RMSE anchor and its band (a factor range),
# the gathered rows per epoch and the kernels it must launch. The explicit
# lines' anchors are the JAX bench's records on a TPU v5 lite (bf16 inputs;
# quality anchors, never speed targets): docs/measurements/r5/bench_r64.out,
# bench_r128.out, bench_100m.out and tune100m/final_auto.out, within
# BENCH_RMSE_BAND (f32 here may fit a little better). The implicit line's TPU
# record (bench_r64_imp.out, 2.47706) is no anchor for an f32 fit: the JAX
# package's own implicit RMSE on the TPU is 0.84x its float32 CPU value at
# ML-1M (bench_ml1m_imp.out 2.22046 against 2.63401, BENCH_SCALE=ml1m
# BENCH_ALPHA=1.0 BENCH_DTYPE=float32 python bench.py on a CPU). It is held
# within HISTORY_RTOL of the JAX package's float32 value at ML-25M, recorded
# on a CPU with bench.py's train path (its layouts, warm start and fit):
#   JAX_PLATFORMS=cpu python -c '
#   import numpy as np, jax.numpy as jnp
#   from recommendation_models_tpu.config import (
#       DataConfig, SolveConfig, bucket_growth_for_rank,
#       dense_min_degree_for_rank)
#   from recommendation_models_tpu.data.layout import layout_from_coo
#   from recommendation_models_tpu.data.synthetic import synthetic_ratings
#   from recommendation_models_tpu.ops.pallas.cholesky import (
#       block_batch, hot_cols_auto)
#   from recommendation_models_tpu.solver.als_sweep import (
#       device_buckets, make_scanned_fit)
#   n_u, n_i = 162_541, 62_423
#   u, i, r = synthetic_ratings(n_u, n_i, 25_000_000, rank=16, seed=0)
#   c = DataConfig(hot_cols=hot_cols_auto(64),
#                  dense_min_degree=dense_min_degree_for_rank(64),
#                  bucket_growth=bucket_growth_for_rank(64))
#   ub, ib = (device_buckets(layout_from_coo(u, i, r, n_u, n_i, config=c,
#                                            transpose=t), block_batch(64))
#             for t in (False, True))
#   fit = make_scanned_fit(ub, ib, n_u, n_i, SolveConfig(
#       rank=64, reg=0.1, solver="xla", alpha=1.0,
#       compute_dtype="float32"), 10, nnz=r.shape[0])
#   g = np.random.default_rng(0)
#   U0 = 0.01 * g.standard_normal((n_u, 64)).astype(np.float32)
#   V0 = 0.01 * g.standard_normal((n_i, 64)).astype(np.float32)
#   print(np.sqrt(np.asarray(fit(jnp.asarray(U0), jnp.asarray(V0))[2])
#                 / r.shape[0]))'
# (about 6 minutes and 13 GB of host memory). The nnz and
# gathered rows equal those records and the JAX package's own layouts,
# counted on a CPU (scale ml25m or synth100m, RANK 64 or 128):
#   JAX_PLATFORMS=cpu python -c '
#   from recommendation_models_tpu.config import (
#       DataConfig, bucket_growth_for_rank, dense_min_degree_for_rank)
#   from recommendation_models_tpu.data.layout import layout_from_coo
#   from recommendation_models_tpu.data.synthetic import synthetic_ratings
#   from recommendation_models_tpu.ops.pallas.cholesky import hot_cols_auto
#   n_u, n_i, n_o = 162_541, 62_423, 25_000_000  # synth100m: 500_000,
#   RANK = 64                                    #   200_000, 100_000_000
#   u, i, r = synthetic_ratings(n_u, n_i, n_o, rank=16, seed=0)
#   c = DataConfig(hot_cols=hot_cols_auto(RANK),
#                  dense_min_degree=dense_min_degree_for_rank(RANK),
#                  bucket_growth=bucket_growth_for_rank(RANK))
#   print(r.shape[0], sum(layout_from_coo(u, i, r, n_u, n_i, transpose=t,
#                                         config=c).padded_slots
#                         for t in (False, True)))'
# (ml25m: 19,027,200 obs, 20,625,664 at rank 64 and 31,246,464 at 128;
# synth100m: 77,037,080 obs, 98,788,736 and 126,940,352.) The dense block of
# synth100m is the 2,147 rows of DataConfig's 2,048 MB f16 budget at 500,000
# columns, at either rank.
BENCH_NNZ = {"ml25m": 19_027_200, "synth100m": 77_037_080}
BENCH_RMSE_BAND = (0.90, 1.03)     # x a TPU anchor: f32 may fit a little better
REF_IMPLICIT_ML25M = 2.819981813430786
B1_ONLY = ("cholesky_solve_batched",)
BENCH_LINES = (
    ("bench_default", dict(), 0.3171, BENCH_RMSE_BAND, 20_625_664,
     MAIN_KERNELS),
    ("bench_r128", dict(rank=128), 0.07945, BENCH_RMSE_BAND, 31_246_464,
     B1_ONLY),
    ("bench_implicit", dict(alpha=1.0), REF_IMPLICIT_ML25M,
     (1 - HISTORY_RTOL, 1 + HISTORY_RTOL), 20_625_664, MAIN_KERNELS),
    ("bench_100m_r64", dict(scale="synth100m"), 0.39427, BENCH_RMSE_BAND,
     98_788_736, MAIN_KERNELS),
    ("bench_100m_r128", dict(scale="synth100m", rank=128), 0.16008,
     BENCH_RMSE_BAND, 126_940_352, B1_ONLY),
)

_PALLAS = "recommendation_models_tpu/ops/pallas/cholesky.py"
TPU_KERNEL = {
    "cholesky_solve_batched": f"{_PALLAS}:226",
    "cholesky_solve_hot": f"{_PALLAS}:286",
    "cholesky_solve_2g": f"{_PALLAS}:239",
    "cholesky_solve_rank1": f"{_PALLAS}:198",
    "cholesky_solve_panel": f"{_PALLAS}:107",
    "cholesky_solve_schur": f"{_PALLAS}:697",
    "cholesky_solve_dual": f"{_PALLAS}:675",
    "gather_rows_sum": "scripts/probe_dma_gather.py:49",
    # the same TPU kernels at their one-block grid past kp = 160
    "cholesky_solve_large": f"{_PALLAS}:226",
}
_CSRC = "recommendation_models_tpu_torch/csrc/"
SOURCE = {
    "cholesky_solve_batched": _CSRC + "cholesky_solve.cu",
    "cholesky_solve_hot": _CSRC + "cholesky_solve.cu",
    "cholesky_solve_2g": _CSRC + "cholesky_solve.cu",
    "cholesky_solve_rank1": _CSRC + "cholesky_rank_panel.cu",
    "cholesky_solve_panel": _CSRC + "cholesky_rank_panel.cu",
    "cholesky_solve_schur": _CSRC + "cholesky_rank_panel.cu",
    "cholesky_solve_dual": _CSRC + "cholesky_rank_panel.cu",
    "gather_rows_sum": _CSRC + "gather.cu",
    "cholesky_solve_large": _CSRC + "cholesky_large.cu",
}
# B1-B3's C exports, each with its source: the throughput kernel, the
# latency kernel and past kp = 128 the panel frame (ops.cholesky._pick)
EXPORTS = {name: {name: SOURCE[name], name + "_lat": SOURCE[name],
                  name + "_panel": _CSRC + "cholesky_rank_panel.cu"}
           for name in ("cholesky_solve_batched", "cholesky_solve_hot",
                        "cholesky_solve_2g")}
MAIN_PATH = "ALS(rank=64).fit, ML-25M shape"
SHARDED_PATH = (f"ShardedALSProgram(S={SHARDED_S}, allgather).make_fit on "
                f"one card, ML-25M shape")
HYBRID_PATH = (f"HybridALSProgram(D={HYBRID_D}, S={HYBRID_S}).make_fit on "
               f"one card, ML-25M shape")
MP_PATH = (f"ShardedALSProgram(S={MP_P}, allgather) across {MP_P} processes "
           f"on one card (probes.multiprocess), ML-25M shape")
BENCH_PATH = ("recommendation_models_tpu_torch.bench train mode: ML-25M rank "
              "64 explicit and implicit, synth-100M rank 64")
BENCH_PATH_R128 = "and ML-25M and synth-100M rank 128"
SHARDED_HOT_PATH = ("ShardedALSProgram(S=1, hot_cols=16, solver='pallas')"
                    ".make_fit on one card, 4,000 x 3,000 "
                    "(probes.sharded_hot)")
PATH = {
    "cholesky_solve_batched": (f"{MAIN_PATH}; {SHARDED_PATH}; {HYBRID_PATH}; "
                               f"{MP_PATH}; {BENCH_PATH} {BENCH_PATH_R128}; "
                               f"ALS(rank=160).fit, ML-25M shape"),
    "cholesky_solve_hot": (f"{MAIN_PATH}; {SHARDED_PATH}; {MP_PATH}; "
                           f"{BENCH_PATH}; ALS(rank=160, hot_cols=16).fit, "
                           f"ML-25M shape; {SHARDED_HOT_PATH}"),
    "cholesky_solve_2g": ("ops.solve.solve_spd_t(Gt2=), k=64 and k=160, "
                          "B=65,536"),
    **dict.fromkeys(("cholesky_solve_rank1", "cholesky_solve_panel",
                     "cholesky_solve_schur", "cholesky_solve_dual"),
                    "probes.solve_variants at k=128, B=65,536; k=160, "
                    "B=8,192; k=656, B=8 (the one-block kernel)"),
    "gather_rows_sum": "probes.dma_gather / probes.ablate_epoch gather only",
    "cholesky_solve_large": ("ops.solve.solve_spd_t (and Gt2=) at k = 168, "
                             "256, 512, 656, one block; ALS(rank=256).fit, "
                             "ML-100K shape"),
}
PROBE_VARIANTS = "pair,rank1,pair_s1,panel,schur,schur_s1,dual"
PROBE_K, PROBE_B, PROBE_REG = 128, 65_536, 0.05   # the probe's defaults
N_CHECK = 4_096       # systems of the k=128 check held against plain
ABL_ITERS = 3         # iterations of each epoch-ablation line


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


# ---------------------------------------------------------------- helpers

def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls,
    after ``warm`` warm-up calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, x, ref):
    """(max abs error, within tolerance?) of x against the plain ref."""
    scale = max(float(ref.abs().max()), 1.0)
    err = (x - ref).abs()
    ok = bool(torch.isfinite(x).all()) and bool(
        (err <= ATOL_SCALE * scale + RTOL * ref.abs()).all())
    return float(err.max()), ok


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def solve_flops(b: int, k: int) -> float:
    # Cholesky factor k^3/3 + forward and back substitution 2 k^2
    return b * (k ** 3 / 3.0 + 2.0 * k * k)


def solve_bytes(b: int, k: int) -> float:
    # G is symmetric, so a solve must read its lower triangle, k(k+1)/2
    # floats, plus rhs (k) and reg (1), and write x (k)
    return 4.0 * b * (k * (k + 1) / 2.0 + 2 * k + 1)


# ----------------------------------------------------------------- phases

def phase_environment(torch):
    from recommendation_models_tpu_torch.ops import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    ver = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc: {ver.stdout.strip().splitlines()[-1]}")
    # the kernels' sources (the variants' one-block kernels' too), and the
    # L2 probe's that phase 3c measures with
    sources = sorted({os.path.basename(p)[:-3] for p in SOURCE.values()}
                     | {"cholesky_large_variants", "l2_probe"})
    t0 = time.perf_counter()
    build.build(*sources)        # one nvcc per source, all started together
    log(f"# build: {', '.join(f'csrc/{n}.cu' for n in sources)} in "
        f"{time.perf_counter() - t0:.1f}s")
    return card


def boundary_check(torch, name, fn, plain, args, k, c=0):
    """The kernel against its plain version at the batches of both regimes
    and their boundary: 1, 255, 256, 257, the latency kernel's resident
    count (as the card reports it) and that count +- 1, and 4,201 (the main
    path's dense width), each the first b systems of ``args`` (batch-major
    tensors; a 2-d tensor of C rows is passed whole), each repeated
    bitwise, and equal bitwise to the kernel of the regime that
    ``latency_regime`` names; the other regime's kernel is held against the
    plain version at the same batch. Returns (max abs error, resident,
    {batch: regime})."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    _, resident = ch.solve_regime(name, 1, k, c)
    batches = sorted(b for b in {1, 255, 256, 257, resident - 1, resident,
                                 resident + 1, 4_201} if b >= 1)
    err_all, regimes = 0.0, {}
    n = args[0].shape[0]
    for b in batches:
        lat, _ = ch.solve_regime(name, b, k, c)
        regimes[b] = "latency" if lat else "throughput"
        sl = tuple(a[:b].contiguous() if a.shape[0] == n else a
                   for a in args)
        x = fn(*sl)
        ref = plain(*sl)
        err, ok = compare(torch, x, ref)
        check(ok, f"{name} disagrees with its plain version at B={b} "
                  f"({regimes[b]}; max abs err {err:.3e})")
        check(torch.equal(x, fn(*sl)),
              f"{name} is not bitwise repeatable at B={b} ({regimes[b]})")
        with ch.forced_regime(lat):
            check(torch.equal(x, fn(*sl)),
                  f"{name} at B={b} did not take the {regimes[b]} kernel")
        with ch.forced_regime(not lat):
            err_o, ok_o = compare(torch, fn(*sl), ref)
        check(ok_o, f"{name}'s other-regime kernel disagrees at B={b} "
                    f"(max abs err {err_o:.3e})")
        err_all = max(err_all, err, err_o)
    check(set(regimes.values()) == {"latency", "throughput"},
          f"{name}: the boundary batches did not cover both regimes")
    return err_all, resident, regimes


def latency_numbers(torch, fn, library, b):
    """Device ms per call from torch.profiler (host gaps do not count),
    host µs per call (wall time over 200 calls, no sync inside) and the
    library call's device ms, at batch b."""
    from recommendation_models_tpu_torch.probes import host_us, profiled_ms
    from recommendation_models_tpu_torch.probes.solve_latency import reps_for
    reps = reps_for(b)
    return dict(device_ms=profiled_ms(fn, reps), host_us=host_us(fn),
                library_device_ms=profiled_ms(library, max(2, reps // 4)))


def phase_b1(torch, dev, flat_w, b=65_536, k=RANK):
    """B1 at B=65,536, at the batches of both regimes and their boundary,
    and through the flat entry at the main path's dense-block width; device
    time (profiler) and host cost at 256 rows, the dense width and
    65,536."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.solve import solve_spd_flat
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    gen = torch.Generator(device=dev).manual_seed(1)
    G, rhs, reg = random_systems(b, k, 48, gen, dev)
    x = ch.cholesky_solve_batched(G, rhs, reg)
    ref = ch.cholesky_solve_plain(G, rhs, reg)
    err, ok = compare(torch, x, ref)
    check(ok, f"cholesky_solve_batched disagrees with its plain version "
              f"(max abs err {err:.3e})")
    err_b, resident, regimes = boundary_check(
        torch, "cholesky_solve_batched", ch.cholesky_solve_batched,
        ch.cholesky_solve_plain, (G, rhs, reg), k)
    rb = ch.block_batch(k)
    Gb, rhsb, regb = G[:rb].contiguous(), rhs[:rb], reg[:rb]
    # the flat (W, k*k) dense-block entry with a per-row ridge
    Gf, rf, _ = random_systems(flat_w, k, 600, gen, dev)
    regf = 0.1 * (1.0 + torch.rand(flat_w, generator=gen, device=dev))
    xf = solve_spd_flat(Gf.reshape(flat_w, k * k), rf, k, "auto",
                        reg_vec=regf)
    err_f, ok_f = compare(torch, xf, ch.cholesky_solve_plain(Gf, rf, regf))
    check(ok_f, f"flat entry disagrees (max abs err {err_f:.3e})")
    # identity-padded and all-zero systems with rhs 0 solve to exactly 0,
    # in the latency regime (8 systems) and the throughput one
    for nz in (8, resident + 1):
        Gz = torch.zeros(nz, k, k, device=dev)
        Gz[nz // 2:] = torch.eye(k, device=dev)
        z = ch.cholesky_solve_batched(Gz, torch.zeros(nz, k, device=dev),
                                      torch.zeros(nz, device=dev))
        check(bool((z == 0).all()),
              f"zero / identity systems did not solve to 0 (B={nz})")
    eye = torch.eye(k, device=dev)

    def library_on(Gs, rs, gs):
        return lambda: torch.cholesky_solve(
            rs[:, :, None], torch.linalg.cholesky(
                Gs + gs[:, None, None] * eye))

    library = library_on(G, rhs, reg)
    ms = time_ms(torch, lambda: ch.cholesky_solve_batched(G, rhs, reg), 10)
    plain_ms = time_ms(torch, lambda: ch.cholesky_solve_plain(G, rhs, reg),
                       2, warm=1)
    lib_ms = time_ms(torch, library, 5)
    lib_err, _ = compare(torch, library()[:, :, 0], ref)
    lat = {rb: latency_numbers(
               torch, lambda: ch.cholesky_solve_batched(Gb, rhsb, regb),
               library_on(Gb, rhsb, regb), rb),
           flat_w: latency_numbers(
               torch, lambda: ch.cholesky_solve_batched(Gf, rf, regf),
               library_on(Gf, rf, regf), flat_w),
           b: latency_numbers(
               torch, lambda: ch.cholesky_solve_batched(G, rhs, reg),
               library, b)}
    bound_ms, bound_by = bound(solve_bytes(b, k), solve_flops(b, k))
    log(f"# B1 cholesky_solve_batched k={k} B={b}: max_abs_err={err:.3e} "
        f"(boundary B={sorted(regimes)}: {err_b:.3e}, resident {resident}; "
        f"flat W={flat_w}: {err_f:.3e}; library vs "
        f"plain {lib_err:.3e}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    by_batch = per_batch(lat, k)
    for n, v in by_batch.items():
        log(f"# B1 B={n} ({regimes.get(int(n), 'throughput')}): device_ms="
            f"{v['device_ms']:.5f} host_us={v['host_us']:.1f} "
            f"library_device_ms={v['library_device_ms']:.5f} "
            f"bound_ms={v['bound_ms']:.5f}")
    return dict(k=k, batch=b, max_abs_err=max(err, err_b, err_f), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, resident=resident,
                regime_by_batch=regimes, by_batch=by_batch)


def per_batch(lat, k, counts=None):
    """The latency numbers by batch, each with its bound; ``counts(n)``
    gives the (bytes, flops) of n systems (default: the plain solve's)."""
    counts = counts or (lambda n: (solve_bytes(n, k), solve_flops(n, k)))
    return {str(n): dict(v, bound_ms=bound(*counts(n))[0])
            for n, v in lat.items()}


def hot_slab_sample(torch, layout, b, dev):
    """``b`` real rows, drawn at random, of the layout's hot slabs (bf16,
    (b, C)): the main path's own hot sparsity."""
    import numpy as np
    hv = np.concatenate([bk.hot_vals[bk.row_ids < layout.n_rows]
                         for bk in layout.buckets])
    check(hv.shape[0] >= b, "not enough hot-slab rows")
    take = np.sort(np.random.default_rng(3).choice(hv.shape[0], b,
                                                   replace=False))
    return torch.from_numpy(hv[take].astype(np.float32)).to(
        dev, torch.bfloat16)


def phase_b2(torch, dev, hv, k=RANK):
    """B2 at B=65,536 on rows of the main path's hot slab, at the batches of
    both regimes and their boundary, with both weightings; device time
    (profiler) and host cost at 256 rows and 65,536."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    b, c = hv.shape
    gen = torch.Generator(device=dev).manual_seed(2)
    G, rhs, reg = random_systems(b, k, 40, gen, dev)
    vh = 0.3 * torch.randn(c, k, generator=gen, device=dev)
    x = ch.cholesky_solve_hot(G, rhs, reg, hv, vh)
    ref = ch.cholesky_solve_hot_plain(G, rhs, reg, hv, vh)
    err, ok = compare(torch, x, ref)
    check(ok, f"cholesky_solve_hot disagrees with its plain version "
              f"(max abs err {err:.3e})")
    xi = ch.cholesky_solve_hot(G, rhs, reg, hv, vh, alpha=2.0)
    err_i, ok_i = compare(torch, xi, ch.cholesky_solve_hot_plain(
        G, rhs, reg, hv, vh, alpha=2.0))
    check(ok_i, f"implicit hot solve disagrees (max abs err {err_i:.3e})")
    check(torch.equal(x, ch.cholesky_solve_hot(G, rhs, reg, hv, vh)),
          "cholesky_solve_hot is not bitwise repeatable")
    err_b, resident, regimes = boundary_check(
        torch, "cholesky_solve_hot", ch.cholesky_solve_hot,
        ch.cholesky_solve_hot_plain, (G, rhs, reg, hv, vh), k, c)
    err_bi, _, _ = boundary_check(
        torch, "cholesky_solve_hot",
        lambda *a: ch.cholesky_solve_hot(*a, alpha=2.0),
        lambda *a: ch.cholesky_solve_hot_plain(*a, alpha=2.0),
        (G, rhs, reg, hv, vh), k, c)
    # zero and identity systems with rhs 0 and no hot entries solve to
    # exactly 0 in both regimes
    for nz in (8, resident + 1):
        Gz = torch.zeros(nz, k, k, device=dev)
        Gz[nz // 2:] = torch.eye(k, device=dev)
        z = ch.cholesky_solve_hot(Gz, torch.zeros(nz, k, device=dev),
                                  torch.zeros(nz, device=dev),
                                  torch.zeros_like(hv[:nz]), vh)
        check(bool((z == 0).all()),
              f"zero / identity hot systems did not solve to 0 (B={nz})")
    rb = ch.block_batch(k)
    blk = (G[:rb].contiguous(), rhs[:rb], reg[:rb], hv[:rb].contiguous(), vh)
    xb = ch.cholesky_solve_hot(*blk)
    check(torch.equal(xb, ch.cholesky_solve_hot(*blk)),
          f"cholesky_solve_hot is not bitwise repeatable at B={rb}")
    eye = torch.eye(k, device=dev)

    def library_on(Gs, rs, gs, hs):
        def library():
            G2, rhs2 = ch.fold_hot(Gs, rs, hs, vh, None)
            return torch.cholesky_solve(
                rhs2[:, :, None], torch.linalg.cholesky(
                    G2 + gs[:, None, None] * eye))
        return library

    nnz = int((hv != 0).sum())
    ms = time_ms(torch, lambda: ch.cholesky_solve_hot(G, rhs, reg, hv, vh),
                 10)
    plain_ms = time_ms(
        torch, lambda: ch.cholesky_solve_hot_plain(G, rhs, reg, hv, vh), 2,
        warm=1)
    lib_ms = time_ms(torch, library_on(G, rhs, reg, hv), 5)
    lat = {rb: latency_numbers(torch, lambda: ch.cholesky_solve_hot(*blk),
                               library_on(*blk[:4]), rb),
           b: latency_numbers(
               torch, lambda: ch.cholesky_solve_hot(G, rhs, reg, hv, vh),
               library_on(G, rhs, reg, hv), b)}

    def hot_bound(n):
        # each nonzero hot entry adds a symmetric rank-1 term, k(k+1)
        # flops for its lower triangle, and 2k flops to the rhs
        nz = nnz if n == b else int((hv[:n] != 0).sum())
        return (solve_bytes(n, k) + 2.0 * n * c + 4.0 * c * k,
                solve_flops(n, k) + (k * (k + 1) + 2.0 * k) * nz)

    bound_ms, bound_by = bound(*hot_bound(b))
    by_batch = per_batch(lat, k, hot_bound)
    log(f"# B2 cholesky_solve_hot k={k} C={c} B={b} hot nnz={nnz} "
        f"({nnz / (b * c):.3f} dense): max_abs_err={err:.3e} "
        f"(implicit {err_i:.3e}; boundary B={sorted(regimes)}: "
        f"{max(err_b, err_bi):.3e}, resident {resident}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} library_ms={lib_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    for n, v in by_batch.items():
        log(f"# B2 B={n}: device_ms={v['device_ms']:.5f} "
            f"host_us={v['host_us']:.1f} library_device_ms="
            f"{v['library_device_ms']:.5f} bound_ms={v['bound_ms']:.5f}")
    return dict(k=k, batch=b, max_abs_err=max(err, err_i, err_b, err_bi),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, resident=resident,
                regime_by_batch=regimes, by_batch=by_batch)


def variant_systems(torch, dev, b=65_536, k=RANK):
    """The variant phase's inputs: k=64 systems as phase 2's, and a second
    gram (16 random factor rows a system) for the two-operand kernel."""
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    gen = torch.Generator(device=dev).manual_seed(4)
    G, rhs, reg = random_systems(b, k, 48, gen, dev)
    G2, _, _ = random_systems(b, k, 16, gen, dev)
    return G, G2, rhs, reg


def persistent_boundary(torch, name, fn, plain, args, extra, resident, dev):
    """A persistent-grid kernel against its plain version at B = 1, 255,
    256, 257, its resident blocks and that count +- 1, and 4,201 (the first
    b systems of ``args``; ``cholesky_solve_dual`` also at B = 2, 3 and its
    wave, the systems of its resident blocks (``variant_block_systems``:
    two a block to kp = 128), +- 1), each repeated bitwise; then identity
    and zero systems with rhs 0, inside one wave and past it, must give
    exactly 0. Returns the max abs error."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    k = args[0].shape[1]
    err_all = 0.0
    batches = {1, 255, 256, 257, resident - 1, resident, resident + 1,
               4_201}
    wave = resident * ch.variant_block_systems(name, k)
    if name == "cholesky_solve_dual":
        batches |= {2, 3, wave - 1, wave, wave + 1}
    for b in sorted(batches):
        sl = tuple(a[:b].contiguous() for a in args)
        x = fn(*sl, *extra)
        err, ok = compare(torch, x, plain(*sl, *extra))
        check(ok, f"{name} {extra} disagrees with its plain version at B={b}"
                  f" (max abs err {err:.3e})")
        check(torch.equal(x, fn(*sl, *extra)),
              f"{name} {extra} is not bitwise repeatable at B={b}")
        err_all = max(err_all, err)
    for nz in (8, wave + 1):
        Gz = torch.zeros(nz, k, k, device=dev)
        Gz[nz // 2:] = torch.eye(k, device=dev)
        z = fn(Gz, torch.zeros(nz, k, device=dev), torch.zeros(nz, device=dev),
               *extra)
        check(bool((z == 0).all()),
              f"zero / identity systems did not solve to 0 in {name} "
              f"{extra} (B={nz})")
    return err_all


def phase_variants(torch, dev, G, G2, rhs, reg):
    """Each solve-variant kernel (every instantiation) against its plain
    version at k=64, B=65,536 and at the 256-row block, with its time, its
    plain version's, the library solve's and its bound."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    b, k, _ = G.shape
    rb = ch.block_batch(k)
    eye = torch.eye(k, device=dev)

    def library(A):
        return lambda: torch.cholesky_solve(
            rhs[:, :, None], torch.linalg.cholesky(
                A + reg[:, None, None] * eye))

    lib_ms = {"one": time_ms(torch, library(G), 5)}
    G12 = G + G2
    lib_ms["two"] = time_ms(torch, library(G12), 5)
    del G12
    runs = [("cholesky_solve_2g", "", ch.cholesky_solve_2g,
             ch.cholesky_solve_2g_plain, (G, G2, rhs, reg), ())]
    runs += [("cholesky_solve_rank1", f"fcols={f},srows={r}",
              ch.cholesky_solve_rank1, ch.cholesky_solve_rank1_plain,
              (G, rhs, reg), (f, r)) for f, r in ch.RANK1_SCHEDULES]
    runs.append(("cholesky_solve_panel", "", ch.cholesky_solve_panel,
                 ch.cholesky_solve_panel_plain, (G, rhs, reg), ()))
    runs += [("cholesky_solve_schur", f"srows={r}", ch.cholesky_solve_schur,
              ch.cholesky_solve_schur_plain, (G, rhs, reg), (r,))
             for r in (1, 2)]
    runs.append(("cholesky_solve_dual", "", ch.cholesky_solve_dual,
                 ch.cholesky_solve_dual_plain, (G, rhs, reg), ()))
    # the entry reported per kernel: the TPU kernel's own default schedule
    # (rank1: pair=False, subs2=False; schur: subs2=True)
    reported = {"cholesky_solve_rank1": "fcols=1,srows=1",
                "cholesky_solve_schur": "srows=2"}
    results = {}
    for name, label, fn, plain, args, extra in runs:
        x = fn(*args, *extra)
        ref = plain(*args, *extra)
        err, ok = compare(torch, x, ref)
        check(ok, f"{name} {label} disagrees with its plain version "
                  f"(max abs err {err:.3e})")
        blk = tuple(a[:rb].contiguous() for a in args)
        err_b, ok_b = compare(torch, fn(*blk, *extra), plain(*blk, *extra))
        check(ok_b, f"{name} {label}: {rb}-row block disagrees "
                    f"(max abs err {err_b:.3e})")
        del x, ref
        extra_fields = {}
        if name in ("cholesky_solve_rank1", "cholesky_solve_panel",
                    "cholesky_solve_schur", "cholesky_solve_dual"):
            res = (ch.variant_resident(name, k, srows=extra[0])
                   if name == "cholesky_solve_schur"
                   else ch.variant_resident(name, k, *extra))
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            err_bd = persistent_boundary(torch, name, fn, plain, args, extra,
                                         res, dev)
            err_b = max(err_b, err_bd)
            by_inst = results.get(name, {}).get("resident_by_instantiation",
                                                {})
            by_inst[label or name.rsplit("_", 1)[1]] = res
            extra_fields = dict(resident_by_instantiation=by_inst)
            if reported.get(name, label) == label:
                extra_fields["resident"] = res
            log(f"# {' '.join(filter(None, (name, label)))} k={k}: resident "
                f"{res} blocks ({res / sms:g} per SM); boundary "
                f"max_abs_err={err_bd:.3e}")
        if name == "cholesky_solve_2g":
            # B3 takes B1's two regimes: its boundary, exact zeros in both,
            # and its device time and host cost at 256 rows
            err_bd, resident, regimes = boundary_check(
                torch, name, fn, plain, args, k)
            err_b = max(err_b, err_bd)
            for nz in (8, resident + 1):
                Gz = torch.zeros(nz, k, k, device=dev)
                Gz[nz // 2:] = torch.eye(k, device=dev)
                z = fn(Gz, torch.zeros_like(Gz),
                       torch.zeros(nz, k, device=dev),
                       torch.zeros(nz, device=dev))
                check(bool((z == 0).all()),
                      f"zero / identity B3 systems did not solve to 0 "
                      f"(B={nz})")
            A = blk[0] + blk[1]
            lat = {rb: latency_numbers(
                torch, lambda: fn(*blk), lambda: torch.cholesky_solve(
                    blk[2][:, :, None], torch.linalg.cholesky(
                        A + blk[3][:, None, None] * eye)), rb)}
            extra_fields = dict(
                resident=resident, regime_by_batch=regimes,
                by_batch=per_batch(lat, k, lambda n: (
                    solve_bytes(n, k) + 4.0 * n * k * (k + 1) / 2,
                    solve_flops(n, k) + n * k * (k + 1) / 2)))
            v = lat[rb]
            log(f"# B3 B={rb} ({regimes[rb]}): device_ms={v['device_ms']:.5f} "
                f"host_us={v['host_us']:.1f} library_device_ms="
                f"{v['library_device_ms']:.5f}; boundary B={sorted(regimes)}"
                f" max_abs_err={err_bd:.3e}, resident {resident}")
        ms = time_ms(torch, lambda: fn(*args, *extra), 10)
        plain_ms = time_ms(torch, lambda: plain(*args, *extra), 2, warm=1)
        block_ms = time_ms(torch, lambda: fn(*blk, *extra), 50)
        two = name == "cholesky_solve_2g"
        n_bytes = solve_bytes(b, k) + (4.0 * b * k * (k + 1) / 2 if two
                                       else 0.0)
        n_flops = solve_flops(b, k) + (b * k * (k + 1) / 2 if two else 0.0)
        bound_ms, bound_by = bound(n_bytes, n_flops)
        lms = lib_ms["two" if two else "one"]
        log(f"# {' '.join(filter(None, (name, label)))} k={k} B={b}: "
            f"max_abs_err={err:.3e} "
            f"(B={rb}: {err_b:.3e}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"library_ms={lms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); "
            f"B={rb} ms={block_ms:.4f}")
        r = results.setdefault(name, dict(k=k, batch=b, max_abs_err=0.0,
                                          instantiations={}))
        r["max_abs_err"] = max(r["max_abs_err"], err, err_b)
        r.update(extra_fields)
        if label:
            r["instantiations"][label] = ms
        if reported.get(name, label) == label:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lms,
                     bound_ms=bound_ms, bound_by=bound_by)
    for r in results.values():
        if not r["instantiations"]:
            del r["instantiations"]
    return results


def phase_variant_path(torch, dev, G, G2, rhs, reg):
    """The solve-variant path as a user runs it, counted: the public
    two-operand solve ``solve_spd_t(Gt2=)`` at k=64, B=65,536 (batch-minor
    views, as its callers hold them), then the variant probe at k=128,
    B=65,536 through its ``main``."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.solve import solve_spd_t
    from recommendation_models_tpu_torch.probes import solve_variants
    torch.cuda.synchronize()
    ch.reset_counts()
    x = solve_spd_t(G.permute(1, 2, 0), rhs.t(), "auto", reg_vec=reg,
                    Gt2=G2.permute(1, 2, 0))
    torch.cuda.synchronize()
    err, ok = compare(torch, x.t(), ch.cholesky_solve_2g_plain(G, G2, rhs,
                                                               reg))
    check(ok and tuple(x.shape) == (RANK, G.shape[0]),
          f"solve_spd_t(Gt2=) disagrees (max abs err {err:.3e})")
    del x
    t0 = time.perf_counter()
    rc = solve_variants.main(["--platform", "cuda"], env=dict(
        PSV_K=str(PROBE_K), PSV_B=str(PROBE_B), PSV_ITERS="10",
        PSV_VARIANTS=PROBE_VARIANTS))
    torch.cuda.synchronize()
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    log(f"# solve-variant path: solve_spd_t(Gt2=) max_abs_err={err:.3e}; "
        f"probe k={PROBE_K} in {time.perf_counter() - t0:.1f}s rc={rc}; "
        f"launches={launches} routed={routed}")
    check(rc == 0, "the solve-variant probe failed")
    check(not any(routed.values()), f"variant-path calls were routed: "
                                    f"{routed}")
    return launches


def phase_probe_shape(torch, dev):
    """Every kernel and instantiation the probe runs, on the probe's own
    k=128, B=65,536 systems (``make_systems``, ridge 0.05): the kernel
    solves all of them, and its first ``N_CHECK`` solutions are held
    against the plain version on those systems. Timed there, beside the
    bound and the library solve at that shape. Run after the path's counts
    are read, so these launches are not counted."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes.solve_variants import (
        make_systems)
    k, b = PROBE_K, PROBE_B
    G, rhs = make_systems(k, b, dev)
    reg = torch.full((b,), PROBE_REG, device=dev)
    n = N_CHECK
    Gc, rhsc, regc = G[:n].contiguous(), rhs[:n].contiguous(), reg[:n]
    runs = [("cholesky_solve_batched", "", ch.cholesky_solve_batched,
             ch.cholesky_solve_plain, ())]
    runs += [("cholesky_solve_rank1", f"fcols={f},srows={r}",
              ch.cholesky_solve_rank1, ch.cholesky_solve_rank1_plain, (f, r))
             for f, r in ch.RANK1_SCHEDULES]
    runs.append(("cholesky_solve_panel", "", ch.cholesky_solve_panel,
                 ch.cholesky_solve_panel_plain, ()))
    runs += [("cholesky_solve_schur", f"srows={r}", ch.cholesky_solve_schur,
              ch.cholesky_solve_schur_plain, (r,)) for r in (1, 2)]
    runs.append(("cholesky_solve_dual", "", ch.cholesky_solve_dual,
                 ch.cholesky_solve_dual_plain, ()))
    reported = {"cholesky_solve_rank1": "fcols=1,srows=1",
                "cholesky_solve_schur": "srows=2"}
    eye = torch.eye(k, device=dev)

    def library():
        return torch.cholesky_solve(rhs[:, :, None], torch.linalg.cholesky(
            G + reg[:, None, None] * eye))

    lib_ms = time_ms(torch, library, 2, warm=1)
    bound_ms, bound_by = bound(solve_bytes(b, k), solve_flops(b, k))
    results = {}
    for name, label, fn, plain, extra in runs:
        x = fn(G, rhs, reg, *extra)
        err, ok = compare(torch, x[:n], plain(Gc, rhsc, regc, *extra))
        check(ok, f"{name} {label} at k={k}, B={b} disagrees with its plain "
                  f"version on the first {n} systems (max abs err "
                  f"{err:.3e})")
        del x
        ms = time_ms(torch, lambda: fn(G, rhs, reg, *extra), 3, warm=1)
        log(f"# {' '.join(filter(None, (name, label)))} k={k} B={b}: "
            f"max_abs_err={err:.3e} (first {n} vs plain) ms={ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
        r = results.setdefault(name, dict(k=k, batch=b, checked=n,
                                          max_abs_err=0.0, bound_ms=bound_ms,
                                          bound_by=bound_by,
                                          library_ms=lib_ms,
                                          instantiations={}))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if label:
            r["instantiations"][label] = ms
        if reported.get(name, label) == label:
            r["ms"] = ms
    for r in results.values():
        if not r["instantiations"]:
            del r["instantiations"]
    return results


def gather_check(torch, table, idx, slots=None):
    """(out, max abs error, agrees?) of the gather kernel (``slots`` None:
    the wrapper's default) against its plain version, per column within
    2e-6 * sum |rows| + 1e-6."""
    from recommendation_models_tpu_torch.ops import gather as ga
    x = ga.gather_rows_sum(table, idx, slots or ga.DEFAULT_SLOTS)
    ref = ga.gather_rows_sum_plain(table, idx)
    err = (x - ref).abs()
    ok = (bool(torch.isfinite(x).all()) and tuple(x.shape) == (1, ref.shape[1])
          and bool((err <= ga.sum_tolerance(table, idx)).all()))
    return x, float(err.max()), ok


def gather_numbers(torch, table, idx, reps, slots=None):
    """The gather kernel's time, its plain version's, the library call's
    (``embedding_bag(mode="sum")``) and its bound on these inputs: every
    distinct row touched read once, the ids read once, the output written
    once; one add per gathered element."""
    import torch.nn.functional as F
    from recommendation_models_tpu_torch.ops import gather as ga
    n, k = idx.shape[0], table.shape[1]
    slots = slots or ga.DEFAULT_SLOTS
    offsets = torch.zeros(1, dtype=idx.dtype, device=idx.device)
    ms = time_ms(torch, lambda: ga.gather_rows_sum(table, idx, slots), reps)
    plain_ms = time_ms(torch, lambda: ga.gather_rows_sum_plain(table, idx),
                       max(2, reps // 4), warm=1)
    lib_ms = time_ms(torch, lambda: F.embedding_bag(idx, table, offsets,
                                                    mode="sum"),
                     max(2, reps // 4), warm=1)
    distinct = int(torch.unique(idx).numel())
    bound_ms, bound_by = bound(4.0 * (distinct * k + n + k), float(n * k))
    return dict(k=k, batch=n, distinct_rows=distinct, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_gather(torch, dev, ul, il):
    """P1 ``gather_rows_sum`` against its plain version and timed: at the
    gather probe's shape (slots 4, 8, 16), at both halves' gathers of the
    main path (every bucket id of the half, one launch, slots 8) on the
    warm-start factor tables, at ragged sizes, and bitwise repeated."""
    from recommendation_models_tpu_torch.ops import gather as ga
    from recommendation_models_tpu_torch.ops.cholesky import block_batch
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.probes import dma_gather
    from recommendation_models_tpu_torch.probes import gather_latency as gl
    from recommendation_models_tpu_torch.probes.ablate_epoch import (
        row_blocks)
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    from recommendation_models_tpu_torch.solver.als_sweep import (
        device_buckets)
    n_table, k, n = dma_gather.N_TABLE, dma_gather.K, dma_gather.N_GATHER
    table, idx = dma_gather.make_inputs(n_table, k, n, dev)
    res = {"instantiations": {}}
    err_all = 0.0
    l2_rate = gl.l2_read_rate(dev)
    log(f"# L2 read rate (probes.gather_latency.l2_read_rate: the read "
        f"kernel of csrc/l2_probe.cu or a library yardstick, the fastest, "
        f"over a warm 16 MB f32 tensor, device time): "
        f"{l2_rate / 1e12:.3f} TB/s")
    for slots in dma_gather.SLOTS:
        _, err, ok = gather_check(torch, table, idx, slots)
        check(ok, f"gather_rows_sum slots={slots} disagrees with its plain "
                  f"version at the probe's shape (max abs err {err:.3e})")
        num = gather_numbers(torch, table, idx, 20, slots)
        res["instantiations"][f"slots={slots}"] = num["ms"]
        err_all = max(err_all, err)
        if slots == ga.DEFAULT_SLOTS:
            res.update(num)
        log(f"# P1 gather_rows_sum n_table={n_table} k={k} ids={n} "
            f"slots={slots}: max_abs_err={err:.3e} ms={num['ms']:.4f} "
            f"({n / num['ms'] / 1e3:.1f} M rows/s) plain_ms="
            f"{num['plain_ms']:.4f} library_ms={num['library_ms']:.4f} "
            f"bound_ms={num['bound_ms']:.5f} ({num['bound_by']}, "
            f"{num['distinct_rows']} distinct rows)")
    # device time (profiler), host cost and device kernels per call at the
    # probe's shape, slots 8
    row = gl.measure("probe", table, idx, ga.DEFAULT_SLOTS, dev, l2_rate, 50,
                     lib_reps=5)
    check(row["kernels_per_call"] == 1,
          f"gather_rows_sum ran {row['kernels_per_call']} device kernels "
          f"per call at the probe's shape")
    res.update(device_ms=row["device_ms"], host_us=row["host_us"],
               l2_bound_ms=row["l2_bound_ms"], l2_tb_s=l2_rate / 1e12)
    log(f"# P1 gather_rows_sum probe shape, slots {ga.DEFAULT_SLOTS}: device "
        f"{row['device_ms']:.5f} ms ({row['tb_s']:.3f} TB/s), host "
        f"{row['host_us']:.1f} us/call, {row['kernels_per_call']:g} kernel "
        f"per call, l2_bound_ms={row['l2_bound_ms']:.5f}")
    # the design's edges: every width at slots 1 and 32 (and 8 at k = 64
    # and 128), at 0, 1 and each step, pipeline, block, grid-rule and
    # grid-cap count +- 1 (probes.gather_latency.edge_counts on this card)
    gen = torch.Generator(device=dev).manual_seed(7)
    n_edge = 0
    for ke in (1, 7, 13, 16, 17, 64, 68, 128, 500, 512):
        vec = 4 if ke % 4 == 0 else 1
        te = torch.randn(1000, ke, generator=gen, device=dev)
        for slots in ((1, 8, 32) if ke in (64, 128) else (1, 32)):
            cfg = ga.gather_config(ke, slots, vec)
            counts = gl.edge_counts(ke, slots, vec, cfg["resident"])
            pool = torch.randint(0, 1000, (counts[-1],), generator=gen,
                                 device=dev, dtype=torch.int32)
            for ne in counts:
                ids = pool[:ne]
                x, err, ok = gather_check(torch, te, ids, slots)
                check(ok, f"gather_rows_sum disagrees at k={ke}, {ne} ids, "
                          f"slots={slots} ({cfg}; max abs err {err:.3e})")
                check(torch.equal(x, ga.gather_rows_sum(te, ids, slots)),
                      f"gather_rows_sum is not bitwise repeatable at k={ke}, "
                      f"{ne} ids, slots={slots}")
                if ne == 0:
                    check(bool((x == 0).all()), "no ids did not give zeros")
                err_all = max(err_all, err)
                n_edge += 1
    log(f"# P1 gather_rows_sum edge cases: {n_edge} agree, repeat bitwise")
    # two streams at once give one stream's bits
    want = ga.gather_rows_sum(table, idx)
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    got = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                got.append(ga.gather_rows_sum(table, idx))
    torch.cuda.synchronize()
    check(all(torch.equal(g, want) for g in got),
          "gather_rows_sum on two streams at once differs from one stream")
    # ragged sizes: no ids, one, fewer than the slots; k=13 (4-byte
    # copies), k=512 with 32 slots, an unaligned table
    ragged = [(table, idx[:0], 8), (table, idx[:1], 8), (table, idx[:7], 8)]
    gen.manual_seed(5)
    t13 = torch.randn(1000, 13, generator=gen, device=dev)
    t512 = torch.randn(3000, 512, generator=gen, device=dev)
    flat = torch.randn(600 * 64 + 1, generator=gen, device=dev)
    t_off = flat[1:].view(600, 64)
    for t, slots in ((t13, 8), (t512, 32), (t_off, 8)):
        ids = torch.randint(0, t.shape[0], (5_000,), generator=gen,
                            device=dev, dtype=torch.int32)
        ragged.append((t, ids, slots))
    for t, ids, slots in ragged:
        x, err, ok = gather_check(torch, t, ids, slots)
        check(ok, f"gather_rows_sum disagrees at k={t.shape[1]}, "
                  f"{ids.shape[0]} ids, slots={slots} (max abs err "
                  f"{err:.3e})")
        if ids.shape[0] == 0:
            check(bool((x == 0).all()), "no ids did not give zeros")
        err_all = max(err_all, err)
    # the main path's gathers: all of a half's bucket ids at once
    U0, V0 = (torch.from_numpy(a).to(dev) for a in warm_start(ul.n_rows,
                                                              il.n_rows))
    at_main, at_row = {}, {}
    for tag, layout, tbl in (("user_half", ul, V0), ("item_half", il, U0)):
        bs = device_buckets(layout, block_batch(RANK), dev)
        ids = torch.cat([b["indices"].reshape(-1) for b in bs
                         if "indices" in b])
        del bs
        x, err, ok = gather_check(torch, tbl, ids)
        check(ok, f"gather_rows_sum disagrees at the main path's {tag} "
                  f"gather (max abs err {err:.3e})")
        check(torch.equal(x, ga.gather_rows_sum(tbl, ids)),
              f"gather_rows_sum is not bitwise repeatable ({tag})")
        num = gather_numbers(torch, tbl, ids, 5)
        # no profiler time here: it drops calls a millisecond long, some
        # runs all of them; `ms` (events, the stream kept full) is the
        # device time of such calls
        num.update(max_abs_err=err,
                   l2_bound_ms=gl.l2_bound_ms(ids.shape[0], RANK, l2_rate))
        at_main[tag] = num
        err_all = max(err_all, err)
        log(f"# P1 gather_rows_sum at the main path's {tag} gather: table "
            f"{tuple(tbl.shape)}, {ids.shape[0]} ids: max_abs_err={err:.3e} "
            f"ms={num['ms']:.4f} ({ids.shape[0] / num['ms'] / 1e3:.1f} M "
            f"rows/s) plain_ms={num['plain_ms']:.4f} library_ms="
            f"{num['library_ms']:.4f} bound_ms={num['bound_ms']:.5f} "
            f"({num['bound_by']}, {num['distinct_rows']} distinct rows) "
            f"l2_bound_ms={num['l2_bound_ms']:.4f}")
        del ids
        # a real row block of the half (the one of median id count)
        side = tag.split("_")[0]
        bs = device_buckets(layout, block_batch(RANK), dev)
        blocks = [b["indices"][s:e].reshape(-1) for b, s, e in
                  row_blocks(bs, SolveConfig(rank=RANK, reg=0.1), RANK)]
        ids = sorted(blocks, key=lambda i: i.shape[0])[len(blocks) // 2]
        x, err, ok = gather_check(torch, tbl, ids)
        check(ok and torch.equal(x, ga.gather_rows_sum(tbl, ids)),
              f"gather_rows_sum disagrees or does not repeat at a {side} "
              f"row block (max abs err {err:.3e})")
        row = gl.measure(f"{side}_block", tbl, ids, ga.DEFAULT_SLOTS, dev,
                         l2_rate, 200, lib_reps=5, blocks=len(blocks))
        check(row["kernels_per_call"] == 1,
              f"gather_rows_sum ran {row['kernels_per_call']} device kernels "
              f"per call at a {side} row block")
        at_row[side] = {f: row[f] for f in (
            "n_gather", "blocks", "device_ms", "host_us", "event_ms",
            "bytes_bound_ms", "l2_bound_ms", "plain_ms", "library_ms",
            "max_abs_err")}
        err_all = max(err_all, err)
        log(f"# P1 gather_rows_sum at a {side} row block ({ids.shape[0]} ids, "
            f"1 of {len(blocks)}): device {row['device_ms'] * 1e3:.2f} us, "
            f"host {row['host_us']:.1f} us/call, event {row['event_ms']:.5f} "
            f"ms, bound {row['bytes_bound_ms']:.5f} / L2 "
            f"{row['l2_bound_ms']:.5f} ms, plain {row['plain_ms']:.4f}, "
            f"library {row['library_ms']:.4f} ms")
        del bs, blocks, ids
    x1 = ga.gather_rows_sum(table, idx)
    check(torch.equal(x1, ga.gather_rows_sum(table, idx)),
          "gather_rows_sum is not bitwise repeatable at the probe's shape")
    res.update(max_abs_err=err_all, at_main_path=at_main,
               at_row_block=at_row)
    return res


def phase_gather_path(torch, dev, ul, il):
    """The gather-rate path as a user runs it, counted: the gather probe
    and the gather-rate probe through their ``main`` (defaults), the epoch
    ablation on the ML-25M layouts and the gather-budget sweep of the item
    half, then of the user half."""
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.ops import gather as ga
    from recommendation_models_tpu_torch.probes import (
        ablate_epoch, dma_gather, gather_budget, gather_rates)
    torch.cuda.synchronize()
    ga.reset_counts()
    t0 = time.perf_counter()
    rc = {"dma_gather": dma_gather.main(["--platform", "cuda"]),
          "gather_rates": gather_rates.main(["--platform", "cuda"], env={})}
    res = ablate_epoch.run(ul, il, SolveConfig(rank=RANK, reg=0.1),
                           ABL_ITERS, dev)
    rc["ablate_epoch"] = 0 if res["ok"] else 1
    for side, layout in (("item", il), ("user", ul)):
        gather_budget.run(layout, RANK, gather_budget.BUDGETS, ABL_ITERS,
                          side, dev)
    rc["gather_budget"] = 0
    torch.cuda.synchronize()
    launches = ga.LAUNCHES["gather_rows_sum"]
    log(f"# gather-rate path in {time.perf_counter() - t0:.1f}s: rc={rc} "
        f"launches={{'gather_rows_sum': {launches}}}")
    check(not any(rc.values()), f"a gather probe failed: {rc}")
    check(launches > 0, "gather_rows_sum was not launched on its path")
    return launches


def phase_ml1m(torch, dev):
    """ML-1M-shaped rank-64 fits through ``ALS.fit`` against the recorded
    JAX histories: the separate-SSE history sweep by sweep, and the first
    three sweeps of the auto (riding-identity) history."""
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    n_users, n_items, n_obs = SCALES["ml1m"]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items)
    for mode, ref, n_check in (("separate", REF_ML1M_SEPARATE, SWEEPS),
                               ("auto", REF_ML1M_AUTO, 3)):
        ch.reset_counts()
        t0 = time.perf_counter()
        m = ALS(rank=RANK, reg=0.1, n_sweeps=SWEEPS, sse_mode=mode,
                platform=dev.type).fit(R, U0=U0, V0=V0)
        secs = time.perf_counter() - t0
        launches = dict(ch.LAUNCHES)
        hist = [float(h) for h in m.history_]
        rel = [abs(a - b) / b for a, b in zip(hist, ref)]
        log(f"# ML-1M rank {RANK} sse_mode={mode}: nnz={R.nnz} fit "
            f"{secs:.2f}s history={hist} rel diff vs JAX CPU="
            f"{[float(f'{x:.2e}') for x in rel]} (checked: first "
            f"{n_check}) launches={launches}")
        check(len(hist) == SWEEPS, "ML-1M fit ran too few sweeps")
        check(max(rel[:n_check]) <= HISTORY_RTOL,
              f"ML-1M {mode} history differs from the reference: {rel}")
        check(all(launches[n] > 0 for n in MAIN_KERNELS),
              f"a kernel was not launched in the ML-1M fit: {launches}")


def build_main_path_data():
    """ML-25M-shaped data and both auto layouts (host side, as bench.py)."""
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        main_path_layouts)
    t0 = time.perf_counter()
    (u, i, r), ul, il = main_path_layouts("ml25m", RANK)
    log(f"# ML-25M data: {r.shape[0]} obs, layouts in "
        f"{time.perf_counter() - t0:.1f}s; user {len(ul.buckets)} buckets "
        f"waste {ul.padding_waste():.2%} dense "
        f"{0 if ul.dense_ids is None else ul.dense_ids.shape[0]}; item "
        f"{len(il.buckets)} buckets waste {il.padding_waste():.2%} dense "
        f"{0 if il.dense_ids is None else il.dense_ids.shape[0]}; hot C="
        f"{0 if ul.hot_ids is None else ul.hot_ids.shape[0]}")
    return (u, i, r), ul, il


def phase_main_path(torch, coo):
    """The main path as a user runs it: ``ALS(rank=64).fit(R)`` on the card
    (auto layout, 10 sweeps). The kernels' launch counts come from here."""
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    u, i, r = coo
    n_users, n_items = SCALES["ml25m"][:2]
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ch.reset_counts()
    t0 = time.perf_counter()
    m = ALS(rank=RANK, reg=0.1, n_sweeps=SWEEPS).fit(R, U0=U0, V0=V0)
    fit_s = time.perf_counter() - t0
    launches = dict(ch.LAUNCHES)
    routed = dict(ch.ROUTED)
    peak = torch.cuda.max_memory_allocated()
    hist = [float(h) for h in m.history_]
    rmse = hist[-1]
    log(f"# main path ALS(rank={RANK}).fit, ML-25M shape: fit_seconds="
        f"{fit_s:.2f} (layout build and upload included) history={hist} "
        f"train_rmse={rmse:.4f} max_memory_allocated={peak} "
        f"launches={launches} routed={routed}")
    check(len(hist) == SWEEPS, "main path ran too few sweeps")
    check(np.isfinite(m.U_).all() and np.isfinite(m.V_).all()
          and m.U_.shape == (n_users, RANK) and m.V_.shape == (n_items, RANK),
          "main path factors are not finite or have the wrong shape")
    check(abs(rmse - RMSE_ANCHOR) <= RMSE_ANCHOR_RTOL * RMSE_ANCHOR,
          f"train RMSE {rmse:.4f} is not within 3% of {RMSE_ANCHOR}")
    check(all(launches[n] > 0 for n in MAIN_KERNELS),
          f"a kernel was not launched on the main path: {launches}")
    check(not any(routed.values()), f"main-path calls were routed: {routed}")
    return launches, hist


def phase_epoch(torch, dev, nnz, ul, il, main_hist, profile=False):
    """epoch_seconds as bench.py times it: the solver's whole-fit loop on
    uploaded layouts, warmed up, clocked from the first sweep to the
    history readback (the fit's only sync); with ``profile``, one sweep's
    device time by kernel and the device's idle share of the epoch."""
    import numpy as np
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        profile_sweep, scanned_fits, time_fit)
    fits = scanned_fits(ul, il, nnz, dev, RANK, sweeps=SWEEPS)
    epoch_s, U, V, sse_h, n_done = time_fit(fits.fit, fits.U0, fits.V0)
    hist = [float(h) for h in np.sqrt(np.maximum(sse_h[:n_done], 0) / nnz)]
    rel = max(abs(a - b) / b for a, b in zip(hist, main_hist))
    log(f"# main path epoch_seconds={epoch_s:.4f} ({SWEEPS} sweeps in "
        f"{epoch_s * SWEEPS:.3f}s; history max rel diff vs ALS.fit "
        f"{rel:.2e})")
    check(n_done == SWEEPS and rel <= HISTORY_RTOL,
          "the timed fit does not reproduce ALS.fit's history")
    if profile:
        log(json.dumps({"profile": profile_sweep(fits.one, U, V,
                                                 epoch_s)}))
    return epoch_s


def exact_topk_gaps(U, V, users, train, got, k, chunk=1_000):
    """The positions where ``got`` (the served ids of ``users``) differ
    from the exact float64 top-k of U, V with each user's training items
    excluded, as relative score gaps: argpartition then a sort by (score
    descending, id ascending), ``chunk`` users at a time (NumPy,
    independent of ``ops.topk``)."""
    import numpy as np
    Vt = V.astype(np.float64).T
    gaps = []
    for c in range(0, len(users), chunk):
        us = users[c:c + chunk]
        sc = U[us].astype(np.float64) @ Vt
        for j, u in enumerate(us):
            sc[j, train.indices[train.indptr[u]:train.indptr[u + 1]]] = (
                -np.inf)
        cand = np.argpartition(-sc, k, axis=1)[:, :k + 1]
        rows = np.arange(len(us))[:, None]
        csc = sc[rows, cand]
        order = np.lexsort((cand, -csc), axis=1)[:, :k]
        want = cand[rows, order]
        g = got[c:c + chunk]
        for r_, c_ in zip(*np.nonzero(g != want)):
            a, b = sc[r_, g[r_, c_]], sc[r_, want[r_, c_]]
            gaps.append(abs(a - b) / max(abs(b), 1e-30))
    return gaps


def phase_sharded(torch, dev, coo, ul, il, main_hist, epoch_s):
    """The 1-D sharded ALS on one card: ML-25M at S=2 through
    ``make_fit`` (the launch counts of B1 and B2 come from here), sharded
    serving on that fit, and ML-1M at S=4 for each exchange against the
    single-device fit and the JAX package's bytes."""
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.config import SolveConfig
    from recommendation_models_tpu_torch.data.layout import shard_layout
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.topk import (
        grouped_exclusion_topk, sharded_topk)
    from recommendation_models_tpu_torch.parallel.mesh import (
        Mesh, take_rows, to_host)
    from recommendation_models_tpu_torch.parallel.sharded_als import (
        ShardedALSProgram)
    from recommendation_models_tpu_torch.probes import SCALES, device_rows
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    from recommendation_models_tpu_torch.probes.exchange import (
        fit_history, program_for)
    t_phase = time.perf_counter()
    u, i, r = coo
    n_users, n_items = ul.n_rows, il.n_rows
    nnz = r.shape[0]
    mesh = Mesh([dev] * SHARDED_S)
    t0 = time.perf_counter()
    block = ch.block_batch(RANK)
    uls = shard_layout(ul, SHARDED_S, row_multiple=block)
    ils = shard_layout(il, SHARDED_S, row_multiple=block)
    t_layout = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = ShardedALSProgram(uls, ils, mesh, SolveConfig(rank=RANK, reg=0.1))
    U, V = prog.place_factors(*warm_start(n_users, n_items, RANK))
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0
    del uls, ils
    fit = prog.make_fit(SWEEPS, nnz=nnz)
    ch.reset_counts()
    t0 = time.perf_counter()
    U, V, sse, n_done = fit(U, V)
    sse_h = sse.cpu().numpy()
    t_sweeps = time.perf_counter() - t0
    launches = {n: ch.LAUNCHES[n] for n in MAIN_KERNELS}
    routed = dict(ch.ROUTED)
    hist = [float(h) for h in np.sqrt(np.maximum(sse_h[:n_done], 0) / nnz)]
    rows = device_rows(lambda: prog.sweep_with_sse(U, V), reps=1, warm=0)
    device_ms = sum(x[0] for x in rows) / 1e3
    top = [(name, round(t / 1e3, 2), c) for t, c, name in rows[:5]]
    rel = max(abs(a - b) / b for a, b in zip(hist, main_hist))
    dense_w = next((b["dense_vals"].shape[0] for b in prog._ib[0]
                    if "dense_vals" in b), 0)
    log(f"# sharded ML-25M S={SHARDED_S} on one card (allgather, dense "
        f"block {dense_w} rows a shard, hot columns): set-up shard_layout "
        f"x2 {t_layout:.2f}s + placement {t_place:.2f}s; {SWEEPS} sweeps "
        f"{t_sweeps:.3f}s ({t_sweeps / SWEEPS:.4f} s a sweep; phase 5's "
        f"epoch {epoch_s:.4f} s, ratio {t_sweeps / SWEEPS / epoch_s:.2f}); "
        f"device ms a sweep (profiled) {device_ms:.1f}, top kernels "
        f"(name, ms, calls) {top}; history={hist} "
        f"max rel diff vs phase 5 {rel:.2e}; launches={launches} "
        f"routed={routed}")
    check(n_done == SWEEPS, "the sharded fit ran too few sweeps")
    check(np.allclose(hist, main_hist, rtol=SHARDED_RTOL, atol=SHARDED_ATOL),
          f"the sharded history differs from phase 5's: {hist}")
    check(abs(hist[-1] - RMSE_ANCHOR) <= RMSE_ANCHOR_RTOL * RMSE_ANCHOR,
          f"sharded train RMSE {hist[-1]:.4f} is not within 3% of "
          f"{RMSE_ANCHOR}")
    check(all(launches[n] > 0 for n in MAIN_KERNELS),
          f"a kernel was not launched by the sharded fit: {launches}")
    check(not any(routed.values()), f"sharded calls were routed: {routed}")
    check(all(b.device.type == dev.type for b in U + V),
          "the sharded tables left the card")

    # sharded serving on that fit
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    users = np.sort(np.random.default_rng(1).choice(
        n_users, SHARDED_SERVE_USERS, replace=False))
    t0 = time.perf_counter()
    sc, ids = grouped_exclusion_topk(
        users, 10, R.indptr, R.indices,
        lambda q: take_rows(U, q, dev),
        lambda Uq, k, excl: sharded_topk(Uq, V, k, mesh, exclude=excl,
                                         n_valid=n_items))
    t_serve = time.perf_counter() - t0
    U_h, V_h = to_host(U)[:n_users], to_host(V)[:n_items]
    gaps = exact_topk_gaps(U_h, V_h, users, R, ids, 10)
    log(f"# sharded serving: sharded_topk over the {SHARDED_S}-way V, "
        f"{len(users)} users with exclusion, k=10 in {t_serve:.2f}s; ids "
        f"against the exact float64 top-10: {len(gaps)} near-tie swaps, "
        f"largest relative gap {max(gaps, default=0.0):.2e}")
    check(ids.shape == (SHARDED_SERVE_USERS, 10) and (ids >= 0).all()
          and (ids < n_items).all(), "sharded serving ids out of the catalog")
    check(np.isfinite(sc).all(), "sharded serving scores are not finite")
    check(all(g < 1e-6 for g in gaps),
          f"sharded serving ids differ from the exact top-10: {gaps[:5]}")
    del prog, fit, U, V, R
    torch.cuda.empty_cache()

    # ML-1M at S=4: each exchange against the single-device fit
    n1, m1, o1 = SCALES["ml1m"]
    u1, i1, r1 = synthetic_ratings(n1, m1, o1, rank=16, seed=0)
    R1 = sp.csr_matrix((r1, (u1, i1)), shape=(n1, m1))
    U0, V0 = warm_start(n1, m1, RANK)
    mesh4 = Mesh([dev] * SHARDED_ML1M_S)
    for alpha in (None, 1.0):
        kw = dict(rank=RANK, reg=0.1, alpha=alpha, n_sweeps=SWEEPS,
                  sse_mode="separate")
        t0 = time.perf_counter()
        single = [float(h) for h in ALS(**kw, platform=dev.type).fit(
            R1, U0=U0, V0=V0).history_]
        log(f"# ML-1M alpha={alpha} on one device: ALS.fit (layouts "
            f"included) {time.perf_counter() - t0:.2f}s")
        for ex in (("allgather", "all_to_all", "hybrid") if alpha is None
                   else ("allgather",)):
            t0 = time.perf_counter()
            prog = program_for(ALS(**kw, n_shards=SHARDED_ML1M_S,
                                   exchange=ex), R1, mesh4)
            t_set = time.perf_counter() - t0
            got_bytes = prog.collective_bytes_per_sweep()
            ch.reset_counts()
            t0 = time.perf_counter()
            _, _, hist = fit_history(prog, U0, V0, SWEEPS, R1.nnz)
            t_fit = time.perf_counter() - t0
            lc = {n: ch.LAUNCHES[n] for n in MAIN_KERNELS}
            rel = max(abs(a - b) / b for a, b in zip(hist, single))
            log(f"# sharded ML-1M S={SHARDED_ML1M_S} exchange={ex} "
                f"alpha={alpha}: set-up (layouts, plan, placement) "
                f"{t_set:.2f}s, {SWEEPS} sweeps "
                f"{t_fit:.2f}s; history max rel diff vs one device "
                f"{rel:.2e}; bytes/shard/sweep {got_bytes['per_sweep_total']}"
                f" (JAX package: "
                f"{REF_SHARDED_BYTES_ML1M[ex, alpha]['per_sweep_total']}); "
                f"launches={lc} routed={dict(ch.ROUTED)}")
            check(got_bytes == REF_SHARDED_BYTES_ML1M[ex, alpha],
                  f"ML-1M {ex} bytes differ from the JAX package's: "
                  f"{got_bytes}")
            check(np.allclose(hist, single, rtol=SHARDED_RTOL,
                              atol=SHARDED_ATOL),
                  f"ML-1M {ex} alpha={alpha} history differs from one "
                  f"device's: {hist} vs {single}")
            check(all((lc[n] > 0) == (n in SHARDED_ML1M_KERNELS[ex])
                      for n in MAIN_KERNELS),
                  f"ML-1M {ex}: unexpected launches {lc}")
            check(not any(ch.ROUTED.values()), f"ML-1M {ex} calls routed")
            del prog
    log(f"# sharded phase: {time.perf_counter() - t_phase:.1f}s")
    return launches, t_sweeps / SWEEPS


def phase_hybrid(torch, dev, coo, main_hist, epoch_s, imc):
    """The 2-D observation-parallel ALS on one card: ML-25M at (D, S) =
    (2, 2) through ``make_fit`` (B1's launch count of this path comes from
    here), ML-1M (2, 2) explicit and implicit against the single-device fit
    and the JAX package's bytes; then phase 7's IMC sharded four ways,
    against phase 7's fit, and its sharded serving."""
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.config import (
        DataConfig, SolveConfig, bucket_growth_for_rank)
    from recommendation_models_tpu_torch.data.layout import (
        layout_from_coo, shard_layout)
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.parallel.hybrid_als import (
        HybridALSProgram, split_layout_slices)
    from recommendation_models_tpu_torch.parallel.mesh import (
        HybridMesh, Mesh)
    from recommendation_models_tpu_torch.probes import (
        SCALES, device_rows)
    from recommendation_models_tpu_torch.probes import imc as pi
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    from recommendation_models_tpu_torch.probes.exchange import (
        fit_history, program_for)
    t_phase = time.perf_counter()
    D, S = HYBRID_D, HYBRID_S
    mesh = HybridMesh([[dev] * S] * D)
    u, i, r = coo
    n_users, n_items = SCALES["ml25m"][:2]
    nnz = r.shape[0]
    t0 = time.perf_counter()
    plain = DataConfig(dense_whales=False, hot_cols=0,
                       bucket_growth=bucket_growth_for_rank(RANK))
    ul = layout_from_coo(u, i, r, n_users, n_items, config=plain)
    il = layout_from_coo(u, i, r, n_users, n_items, config=plain,
                         transpose=True)
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    uls, ils = shard_layout(ul, S), shard_layout(il, S)
    t_shard = time.perf_counter() - t0
    del ul, il
    t0 = time.perf_counter()
    split_layout_slices(uls, D)
    split_layout_slices(ils, D)
    t_split = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the program splits the layouts again, then uploads each position's
    prog = HybridALSProgram(uls, ils, mesh, SolveConfig(rank=RANK, reg=0.1))
    U, V = prog.place_factors(*warm_start(n_users, n_items, RANK))
    torch.cuda.synchronize()
    t_place = time.perf_counter() - t0 - t_split
    widest = max(b["indices"].shape[1] for b in prog._ib[0][0])
    del uls, ils
    fit = prog.make_fit(HYBRID_SWEEPS, nnz=nnz)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ch.reset_counts()
    t0 = time.perf_counter()
    U, V, sse, n_done = fit(U, V)
    sse_h = sse.cpu().numpy()
    t_sweeps = time.perf_counter() - t0
    launches = {n: ch.LAUNCHES[n] for n in MAIN_KERNELS}
    routed = dict(ch.ROUTED)
    peak = torch.cuda.max_memory_allocated()
    hist = [float(h) for h in np.sqrt(np.maximum(sse_h[:n_done], 0) / nnz)]
    ref = main_hist[:HYBRID_SWEEPS]
    rel = max(abs(a - b) / b for a, b in zip(hist, ref))
    rows = device_rows(lambda: prog.sweep_with_sse(U, V), reps=1, warm=0)
    device_ms = sum(x[0] for x in rows) / 1e3
    top = [(name, round(t / 1e3, 2), c) for t, c, name in rows[:5]]
    per_sweep = t_sweeps / HYBRID_SWEEPS
    log(f"# 2-D ML-25M (D, S) = ({D}, {S}) on one card (no dense block, no "
        f"hot columns; widest item bucket {widest}): set-up plain layouts "
        f"{t_plain:.2f}s + shard_layout x2 {t_shard:.2f}s + "
        f"split_layout_slices x2 {t_split:.2f}s + placement {t_place:.2f}s;"
        f" {HYBRID_SWEEPS} sweeps {t_sweeps:.3f}s ({per_sweep:.4f} s a "
        f"sweep; phase 5's epoch {epoch_s:.4f} s, ratio "
        f"{per_sweep / epoch_s:.2f}); device ms a sweep (profiled) "
        f"{device_ms:.1f}, top kernels (name, ms, calls) {top}; "
        f"max_memory_allocated={peak}; history={hist} max rel diff vs "
        f"phase 5 {rel:.2e}; launches={launches} (B1: "
        f"{2 * D * S} solves a sweep) routed={routed}; bytes/position/sweep "
        f"{prog.collective_bytes_per_sweep()}")
    check(n_done == HYBRID_SWEEPS, "the 2-D fit ran too few sweeps")
    check(np.allclose(hist, ref, rtol=SHARDED_RTOL, atol=SHARDED_ATOL),
          f"the 2-D history differs from phase 5's: {hist} vs {ref}")
    check(launches["cholesky_solve_batched"] > 0
          and launches["cholesky_solve_hot"] == 0,
          f"the 2-D fit should launch B1 and not B2: {launches}")
    check(not any(routed.values()), f"2-D calls were routed: {routed}")
    check(all(b.device.type == dev.type for row in U + V for b in row),
          "the 2-D tables left the card")
    del prog, fit, U, V
    torch.cuda.empty_cache()

    # ML-1M (2, 2), explicit and implicit, against one device
    n1, m1, o1 = SCALES["ml1m"]
    u1, i1, r1 = synthetic_ratings(n1, m1, o1, rank=16, seed=0)
    R1 = sp.csr_matrix((r1, (u1, i1)), shape=(n1, m1))
    U0, V0 = warm_start(n1, m1, RANK)
    for alpha in (None, 1.0):
        kw = dict(rank=RANK, reg=0.1, alpha=alpha, n_sweeps=SWEEPS,
                  sse_mode="separate")
        t0 = time.perf_counter()
        single = [float(h) for h in ALS(**kw, platform=dev.type).fit(
            R1, U0=U0, V0=V0).history_]
        t_single = time.perf_counter() - t0
        t0 = time.perf_counter()
        prog = program_for(ALS(**kw, n_shards=D * S, num_slices=D,
                               topology="obs_parallel"), R1, mesh)
        t_set = time.perf_counter() - t0
        got_bytes = prog.collective_bytes_per_sweep()
        ch.reset_counts()
        t0 = time.perf_counter()
        _, _, hist1 = fit_history(prog, U0, V0, SWEEPS, R1.nnz)
        t_fit = time.perf_counter() - t0
        lc = {n: ch.LAUNCHES[n] for n in MAIN_KERNELS}
        rel = max(abs(a - b) / b for a, b in zip(hist1, single))
        log(f"# 2-D ML-1M (D, S) = ({D}, {S}) alpha={alpha}: set-up "
            f"(layouts, split, placement) {t_set:.2f}s, {SWEEPS} sweeps "
            f"{t_fit:.2f}s (one device's ALS.fit, layouts included: "
            f"{t_single:.2f}s); history max rel diff vs one device "
            f"{rel:.2e}; bytes/position/sweep {got_bytes} (JAX package: "
            f"{REF_HYBRID_BYTES_ML1M}); launches={lc} "
            f"routed={dict(ch.ROUTED)}")
        check(got_bytes == REF_HYBRID_BYTES_ML1M,
              f"ML-1M 2-D bytes differ from the JAX package's: {got_bytes}")
        check(np.allclose(hist1, single, rtol=SHARDED_RTOL,
                          atol=SHARDED_ATOL),
              f"ML-1M 2-D alpha={alpha} history differs from one "
              f"device's: {hist1} vs {single}")
        check(lc["cholesky_solve_batched"] > 0
              and lc["cholesky_solve_hot"] == 0,
              f"ML-1M 2-D: unexpected launches {lc}")
        check(not any(ch.ROUTED.values()), "ML-1M 2-D calls routed")
        del prog
    torch.cuda.empty_cache()

    # phase 7's IMC config sharded four ways on the card
    X, Y, users, items, ratings, cold = imc["data"]
    tr = ~cold
    imesh = Mesh([dev] * IMC_SHARDED_S)
    model, secs = pi.sharded_fit(imc["data"], imesh)
    ihist = [float(h) for h in model.history_]
    irel = [abs(a - b) / b for a, b in zip(ihist, imc["history"])]
    obj = f64_objective(model, X, Y, users[tr], items[tr], ratings[tr],
                        pi.REG)
    obj_rel = abs(obj - imc["objective"]) / imc["objective"]
    xbytes = model.exchange_bytes_per_sweep_
    log(f"# sharded IMC ml1m S={IMC_SHARDED_S} on one card: fit "
        f"{secs:.2f}s on the host clock (phase 7's single-device fit "
        f"{imc['fit_seconds']:.2f}s, ratio {secs / imc['fit_seconds']:.2f});"
        f" history {ihist}, rel diff vs phase 7 "
        f"{[float(f'{x:.2e}') for x in irel]} (tolerance "
        f"{IMC_HISTORY_RTOL}); f64 objective {obj:.6f} against phase 7's "
        f"{imc['objective']:.6f} (rel {obj_rel:.2e}); bytes/shard/sweep "
        f"{xbytes} (JAX package: {REF_IMC_BYTES_ML1M})")
    check(len(ihist) == pi.SWEEPS and max(irel) <= IMC_HISTORY_RTOL,
          f"the sharded IMC history differs from phase 7's: {irel}")
    check(np.isfinite(model.W_).all() and np.isfinite(model.H_).all(),
          "the sharded IMC factors are not finite")
    check(obj_rel <= HISTORY_RTOL,
          f"the sharded IMC f64 objective {obj} differs from phase 7's")
    check(xbytes == REF_IMC_BYTES_ML1M,
          f"the sharded IMC bytes differ from the JAX package's: {xbytes}")
    check_users = np.unique(users[tr])[:SERVING_CHECK_USERS]
    t0 = time.perf_counter()
    _, got = model.recommend(check_users, n=10, exclude_seen=True,
                             method="exact")
    t_serve = time.perf_counter() - t0
    blocks = model._veff_dev_cache[2][0]
    check(len(blocks) == IMC_SHARDED_S
          and all(b.device.type == dev.type for b in blocks),
          "sharded IMC serving did not run on the card's mesh")
    model._fit_sharded_ = False         # the same factors, one device
    _, want = model.recommend(check_users, n=10, exclude_seen=True,
                              method="exact")
    model._fit_sharded_ = True
    Ueff = np.float64(np.float32(X)) @ np.float64(model.W_)
    Veff = np.float64(np.float32(Y)) @ np.float64(model.H_)
    rows_, cols_ = np.nonzero(got != want)
    gaps = []
    for a, b in zip(rows_, cols_):
        q = Ueff[check_users[a]]
        x, y = q @ Veff[got[a, b]], q @ Veff[want[a, b]]
        gaps.append(abs(x - y) / max(abs(y), 1e-30))
    log(f"# sharded IMC recommend ({len(check_users)} users, exclusion, "
        f"exact) through sharded_topk in {t_serve:.2f}s against "
        f"single-device serving of the same factors: {len(gaps)} near-tie "
        f"swaps, largest relative gap {max(gaps, default=0.0):.2e}")
    check(got.shape == (len(check_users), 10) and (got >= 0).all()
          and (got < Y.shape[0]).all(), "sharded IMC ids out of the catalog")
    check(all(g < 1e-6 for g in gaps),
          f"sharded IMC ids differ from single-device serving: {gaps[:5]}")
    log(f"# 2-D and sharded IMC phase: {time.perf_counter() - t_phase:.1f}s")
    return launches


def run_processes(argv_for, label, timeout, expect=0):
    """``argv_for(rank, coordinator)`` in MP_P processes at once
    (``probes.multiprocess.launch``: a fresh coordinator on 127.0.0.1, each
    process killed by its PID past ``timeout``), from the checkout's root;
    each process's stdout, after every exit code is checked."""
    from recommendation_models_tpu_torch.probes.multiprocess import launch
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = launch(argv_for, MP_P, timeout, env=env, cwd=root)
    secs = time.perf_counter() - t0
    log(f"# {MP_P} processes {label}: exit {[rc for rc, _, _ in res]} in "
        f"{secs:.1f}s")
    for rank, (rc, out, err) in enumerate(res):
        check(rc == expect, f"{label}: process {rank} exited {rc} (want "
              f"{expect}): {out[-2000:]} {err[-3000:]}")
    return [out for _, out, _ in res]


def run_probe(outdir, label, *extra, timeout=MP_TIMEOUT, expect=0):
    """``probes.multiprocess`` in MP_P processes on the card, one shard a
    process: each process's JSON line."""
    outs = run_processes(lambda rank, coord: [
        sys.executable, "-m",
        "recommendation_models_tpu_torch.probes.multiprocess", coord,
        str(MP_P), str(rank), outdir, *extra], label, timeout, expect)
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def same_history(got, want, label):
    rel = max(abs(a - b) / b for a, b in zip(got, want))
    check(len(got) == len(want) and rel <= MP_RTOL,
          f"{label}: the history differs from one process's: {got} vs "
          f"{want}")
    return rel


def phase_multiprocess(torch, dev, coo, cli_hist, sharded_sweep_s, imc):
    """The multi-process runtime on one card: MP_P processes, one shard
    each on ``cuda:0``, through gloo on 127.0.0.1. The CLI at ML-25M and
    the programs of ``probes.multiprocess`` (ML-25M 1-D allgather with its
    launch counts, ML-1M exchanges, the 2-D program, sharded IMC, a crash
    and its resume), each held against the same program in this one
    process on ``Mesh((cuda:0,) * MP_P)`` (``coo``: the main path's
    ratings, which ``probes.multiprocess`` makes alike in each process).
    ``cli_hist``: phase 8's single-device CLI history at ML-25M. The ML-1M
    launches, untimed, run at once. Returns B1's and B2's launches
    summed over the processes of the ML-25M run."""
    import concurrent.futures
    import types
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch.parallel.mesh import (
        HybridMesh, Mesh)
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes import imc as pi
    from recommendation_models_tpu_torch.probes import multiprocess as mp
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "multiprocess")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    mesh = Mesh([dev] * MP_P)
    sweeps = mp.SWEEPS["ml25m"]

    def one_process(model, scale, R, exchange="allgather", alpha=None,
                    scanned=False):
        m = (HybridMesh([[dev]] * MP_P) if model == "hybrid2d" else mesh)
        prog = mp.build_program(model, scale, R, m, exchange, alpha)
        res = mp.run_als(prog, scale, R.nnz, dev, scanned=scanned)
        del prog
        torch.cuda.empty_cache()
        return res

    # ML-25M through the CLI, one shard a process
    jsonl = os.path.join(root, "cli_ml25m.jsonl")
    outs = run_processes(lambda rank, coord: [
        sys.executable, "-m", "recommendation_models_tpu_torch.train",
        "--synthetic", "ml25m", "--rank", str(RANK), "--n-shards", str(MP_P),
        "--exchange", "allgather", "--n-sweeps", str(sweeps),
        "--metrics-jsonl", jsonl, "--coordinator", coord,
        "--num-processes", str(MP_P), "--process-id", str(rank)],
        "CLI ML-25M", MP_TIMEOUT)
    for line in outs[0].splitlines():
        if line.startswith("[train]"):
            log(f"#   CLI process 0: {line}")
    check(not any(line.startswith("[train]") for out in outs[1:]
                  for line in out.splitlines()),
          "a process other than 0 printed the CLI's summary")
    lines = read_jsonl(jsonl)
    mp_hist = [x["train_rmse"] for x in lines[:-1]]
    check(len(lines) == sweeps + 1,
          f"the CLI's JSONL has {len(lines)} records")
    u, i, r = coo
    R25 = sp.csr_matrix((r, (u, i)), shape=SCALES["ml25m"][:2])
    ref25 = one_process("als", "ml25m", R25, scanned=True)
    rel = same_history(mp_hist, ref25["history"], "CLI ML-25M")
    check(all(b < a for a, b in zip(mp_hist, mp_hist[1:])),
          f"the CLI's history does not fall at every sweep: {mp_hist}")
    log(f"# CLI ML-25M, {MP_P} processes: history {mp_hist}, max rel diff "
        f"vs one process on Mesh((cuda:0,) * {MP_P}) {rel:.2e}; sweep "
        f"{sweeps} RMSE {mp_hist[-1]:.6f} (sharded init) beside the "
        f"single-device CLI's {cli_hist[sweeps - 1]:.6f} (phase 8, default "
        f"init)")

    # ML-25M through the probe: the launch counts, set-up, sweeps, memory
    lines = run_probe(os.path.join(root, "ml25m"), "probe ML-25M allgather",
                      "--scale", "ml25m")
    launches = {n: 0 for n in MAIN_KERNELS}
    for ln in lines:
        run = ln["runs"][0]
        log(f"# multi-process ML-25M allgather, process {ln['process']} of "
            f"{ln['processes']} on {ln['device']}: data "
            f"{run['data_s']:.2f}s, set-up (layouts, shard, placement) "
            f"{run['setup_s']:.2f}s, {run['sweep_s']:.4f} s a sweep (phase "
            f"9's one-process S={SHARDED_S}: {sharded_sweep_s}), peak "
            f"{ln['peak_bytes']} bytes, launches={run['launches']} "
            f"routed={run['routed']}")
        same_history(run["history"], ref25["history"], "probe ML-25M")
        check(all(run["launches"][n] > 0 for n in MAIN_KERNELS),
              f"process {ln['process']} did not launch B1 and B2: "
              f"{run['launches']}")
        check(not any(run["routed"].values()),
              f"process {ln['process']} routed calls: {run['routed']}")
        for n in MAIN_KERNELS:
            launches[n] += run["launches"][n]
    del R25, ref25
    torch.cuda.empty_cache()

    # ML-1M, untimed, the launches at once: each exchange explicit, the
    # implicit allgather, the 2-D program, sharded IMC, a crash after sweep
    # 2 with checkpoints and then its resume
    crash = os.path.join(root, "crash")

    def crash_and_resume():
        run_probe(crash, "probe ML-1M crash after sweep 2", "--scale",
                  "ml1m", "--crash-after-sweep", "2", expect=mp.CRASH_EXIT)
        check(sorted(os.listdir(os.path.join(crash, "ckpt")))
              == ["step_00000001", "step_00000002"],
              "the crashed run left no checkpoints of sweeps 1 and 2")
        return run_probe(crash, "probe ML-1M --resume", "--scale", "ml1m",
                         "--resume")

    runs = {(None, "1d"): ("--exchange", "allgather,all_to_all,hybrid"),
            (1.0, "1d"): ("--exchange", "allgather", "--alpha", "1.0"),
            (None, "hybrid2d"): ("--model", "hybrid2d"),
            (None, "imc"): ("--model", "imc")}
    with concurrent.futures.ThreadPoolExecutor(len(runs) + 1) as pool:
        futs = {key: pool.submit(
            run_probe, os.path.join(root, f"ml1m_{key[1]}_{key[0]}"),
            f"probe ML-1M {key[1]} alpha={key[0]}", "--scale", "ml1m", *extra)
            for key, extra in runs.items()}
        futs["resume"] = pool.submit(crash_and_resume)
        out = {key: f.result() for key, f in futs.items()}
    R1 = mp.ratings("ml1m")
    for alpha, modes in ((None, ("allgather", "all_to_all", "hybrid")),
                         (1.0, ("allgather",))):
        lines = out[alpha, "1d"]
        for i, ex in enumerate(modes):
            want = one_process("als", "ml1m", R1, ex, alpha)["history"]
            for ln in lines:
                run = ln["runs"][i]
                rel = same_history(run["history"], want, f"ML-1M {ex}")
                check(run["bytes_per_sweep"] == REF_MP_BYTES_ML1M[ex, alpha],
                      f"ML-1M {ex} bytes differ from the JAX package's: "
                      f"{run['bytes_per_sweep']}")
            log(f"# multi-process ML-1M {ex} alpha={alpha}: history max rel "
                f"diff vs one process {rel:.2e}; bytes/shard/sweep "
                f"{run['bytes_per_sweep']['per_sweep_total']} (JAX package "
                f"S={MP_P}: "
                f"{REF_MP_BYTES_ML1M[ex, alpha]['per_sweep_total']}); "
                f"launches={[ln['runs'][i]['launches'] for ln in lines]}")
            if ex == "allgather" and alpha is None:
                uninterrupted = want
    want = one_process("hybrid2d", "ml1m", R1)["history"]
    for ln in out[None, "hybrid2d"]:
        run = ln["runs"][0]
        rel = same_history(run["history"], want, "ML-1M 2-D")
        check(run["bytes_per_sweep"] == REF_MP_BYTES_ML1M["obs_parallel"],
              f"ML-1M 2-D bytes differ from the JAX package's: "
              f"{run['bytes_per_sweep']}")
        check(run["launches"]["cholesky_solve_batched"] > 0,
              f"the 2-D process {ln['process']} did not launch B1")
    log(f"# multi-process ML-1M 2-D ({MP_P} slices of 1): history max rel "
        f"diff vs one process {rel:.2e}; bytes/position/sweep "
        f"{run['bytes_per_sweep']}; launches="
        f"{[ln['runs'][0]['launches'] for ln in out[None, 'hybrid2d']]}")
    rel = same_history(out["resume"][0]["runs"][0]["history"], uninterrupted,
                       "ML-1M resume")
    log(f"# multi-process ML-1M crash and resume: history max rel diff vs "
        f"the uninterrupted fit {rel:.2e}")

    # phase 7's IMC config sharded over the processes
    got = np.load(os.path.join(root, "ml1m_imc_None", "result.npz"))
    ihist = [float(h) for h in got["history"]]
    irel = max(abs(a - b) / b for a, b in zip(ihist, imc["history"]))
    X, Y, users, items, ratings, cold = imc["data"]
    tr = ~cold
    obj = f64_objective(types.SimpleNamespace(W_=got["W"], H_=got["H"]),
                        X, Y, users[tr], items[tr], ratings[tr], pi.REG)
    obj_rel = abs(obj - imc["objective"]) / imc["objective"]
    log(f"# multi-process IMC ml1m, {MP_P} shards: history rel diff vs "
        f"phase 7 {irel:.2e} (tolerance {IMC_HISTORY_RTOL}); f64 objective "
        f"{obj:.6f} against phase 7's {imc['objective']:.6f} (rel "
        f"{obj_rel:.2e})")
    check(len(ihist) == pi.SWEEPS and irel <= IMC_HISTORY_RTOL,
          f"the multi-process IMC history differs from phase 7's: {ihist}")
    check(obj_rel <= HISTORY_RTOL,
          f"the multi-process IMC f64 objective {obj} differs from phase 7's")
    log(f"# multi-process phase: {time.perf_counter() - t_phase:.1f}s")
    return launches


def frozen_exact_topk(U, V, users, train, k):
    """float64 scores, each user's training items excluded, exact top-k by
    a stable sort (NumPy, independent of ``ops.topk``)."""
    import numpy as np
    sc = U[users].astype(np.float64) @ V.astype(np.float64).T
    for j, u in enumerate(users):
        sc[j, train.indices[train.indptr[u]:train.indptr[u + 1]]] = -np.inf
    return np.argsort(-sc, axis=1, kind="stable")[:, :k], sc


def phase_serving(torch, coo):
    """The ML-25M serving config on the card through ``ALS.fit`` and
    ``ALS.recommend`` (``probes/serving.py``): B1 and B2 launched by the
    fit with nothing routed, the catalog on the card, quality against the
    reference's anchors and a float64 selector, and users/s of a
    65,536-user batch beside its bound and device split."""
    import numpy as np
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes import serving as sv
    n_users, n_items = SCALES["ml25m"][:2]
    t0 = time.perf_counter()
    train, train_obs, eval_users, rel_eval = sv.serving_split(
        coo, n_users, n_items)
    split_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ch.reset_counts()
    t0 = time.perf_counter()
    model = sv.fit_serving_model(train)
    fit_s = time.perf_counter() - t0
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    fit_peak = torch.cuda.max_memory_allocated()
    log(f"# serving fit ALS(rank={sv.RANK}, alpha=1.0, n_sweeps="
        f"{sv.SWEEPS}), ML-25M leave-2-out: train_obs={train_obs} split "
        f"{split_s:.1f}s fit_seconds={fit_s:.2f} (layout build included) "
        f"history={[float(h) for h in model.history_]} "
        f"max_memory_allocated={fit_peak} launches={launches} "
        f"routed={routed}")
    check(all(launches[n] > 0 for n in MAIN_KERNELS),
          f"a kernel was not launched in the serving fit: {launches}")
    check(not any(routed.values()), f"serving-fit calls were routed: {routed}")
    check(np.isfinite(model.U_).all() and np.isfinite(model.V_).all(),
          "the serving fit's factors are not finite")
    record, q = sv.measure(model, train_obs, eval_users, rel_eval,
                           torch.device("cuda"), "ml25m")
    print(json.dumps(record), flush=True)
    check(model._vdev_cache[1].is_cuda, "serving did not run on the card")
    ex = record["extra"]
    check(ex["eval_users"] == sv.EVAL_USERS, "too few eval users")
    check(ex["auto_ids_equal_exact"], "'auto' and 'exact' served other ids")
    ids = q["exact"]["ids"]
    check(ids.shape == (sv.EVAL_USERS, sv.K) and (ids >= 0).all()
          and (ids < n_items).all(), "served ids out of the catalog")
    users = eval_users[:SERVING_CHECK_USERS]
    want, sc = frozen_exact_topk(model.U_, model.V_, users, train, sv.K)
    got = ids[:SERVING_CHECK_USERS]
    rows, cols = np.nonzero(got != want)
    gaps = [abs(sc[r, got[r, c]] - sc[r, want[r, c]])
            / max(abs(sc[r, want[r, c]]), 1e-30) for r, c in zip(rows, cols)]
    log(f"# serving ids against a float64 selector ({len(users)} users): "
        f"{len(gaps)} near-tie swaps, largest relative gap "
        f"{max(gaps, default=0.0):.2e}")
    check(all(g < 1e-6 for g in gaps),
          f"served ids differ from the float64 selector: {gaps[:5]}")
    for key, anchor in (("recall_at_10", SERVING_RECALL_ANCHOR),
                        ("ndcg_at_10", SERVING_NDCG_ANCHOR),
                        ("recall_at_10_exact", SERVING_RECALL_ANCHOR),
                        ("ndcg_at_10_exact", SERVING_NDCG_ANCHOR)):
        check(abs(ex[key] - anchor) <= SERVING_BAND,
              f"serving {key} {ex[key]:.5f} is not within {SERVING_BAND} "
              f"of the reference's {anchor}")
    split = ex["device_split_ms"]
    log(f"# serving: recall@10={ex['recall_at_10']:.5f} (anchor "
        f"{SERVING_RECALL_ANCHOR}) ndcg@10={ex['ndcg_at_10']:.5f} (anchor "
        f"{SERVING_NDCG_ANCHOR}); recommend 20,000 users with exclusion "
        f"{ex['recommend_seconds']}; {record['value']:.0f} users/s at "
        f"B={ex['query_batch']} ({ex['batch_ms']:.3f} ms a batch; bound "
        f"{ex['bound_ms']:.3f} ms unfused = "
        f"{ex['query_batch'] / ex['bound_ms'] * 1e3:.0f} users/s, "
        f"{ex['bound_ms_fused']:.3f} fused); device split ms: product "
        f"{split['product']:.3f} selection {split['selection']:.3f} other "
        f"{split['other']:.3f} (every product call traced: "
        f"{split['complete']}); peak {ex['max_memory_allocated']} bytes; "
        f"oracle {ex['oracle_users_per_sec']:.1f} users/s")
    check(record["value"] > 0 and split["total"] > 0,
          "the throughput run measured nothing")
    return record


def f64_objective(model, X, Y, users, items, ratings, reg):
    """½ Σ (r - x W Hᵀ y)² + reg/2 (‖W‖² + ‖H‖²) in float64 on the host,
    over the f32 features the model trained with."""
    import numpy as np
    W, H = np.float64(model.W_), np.float64(model.H_)
    X32, Y32 = np.float32(X), np.float32(Y)
    p = np.einsum("ok,ok->o", np.float64(X32[users]) @ W,
                  np.float64(Y32[items]) @ H)
    return float(0.5 * ((ratings - p) ** 2).sum()
                 + 0.5 * reg * ((W ** 2).sum() + (H ** 2).sum()))


def phase_imc(torch, dev, platform=None):
    """The ML-1M IMC config on the card (``probes/imc.py``): the quality fit
    through ``IMC.fit`` against the JAX package's recorded history, f64
    objective and cold-start RMSE; the timed fit and one profiled sweep;
    ``recommend(exclude_seen=True)`` for 512 training users against a
    float64 selector; then a checkpoint round trip of each estimator.
    Returns the data, the history, the f64 objective and the quality fit's
    seconds, which phase 10 holds the sharded fit against."""
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch.probes import imc as pi
    data = pi.imc_data("ml1m")
    X, Y, users, items, ratings, cold = data
    tr = ~cold
    log(f"# IMC data ml1m: {X.shape[0]} users x {Y.shape[0]} items, "
        f"features {X.shape[1]}/{Y.shape[1]}, {users.shape[0]} obs, "
        f"{int(tr.sum())} in training")
    record, model = pi.measure(data, dev, "ml1m")
    print(json.dumps(record), flush=True)
    ex = record["extra"]
    hist = ex["history"]
    rel = [abs(a - b) / b for a, b in zip(hist, REF_IMC_ML1M)]
    obj = f64_objective(model, X, Y, users[tr], items[tr], ratings[tr],
                        pi.REG)
    obj_rel = abs(obj - REF_IMC_ML1M_OBJECTIVE) / REF_IMC_ML1M_OBJECTIVE
    cold_rmse = ex["cold_start_rmse"]
    cold_rel = abs(cold_rmse - REF_IMC_ML1M_COLD_RMSE) / \
        REF_IMC_ML1M_COLD_RMSE
    std = float(np.std(ratings))
    log(f"# IMC ml1m against the JAX package's CPU fit: history rel diff "
        f"{[float(f'{x:.2e}') for x in rel]} (tolerance "
        f"{IMC_HISTORY_RTOL}); f64 objective {obj:.6f} against "
        f"{REF_IMC_ML1M_OBJECTIVE} (rel {obj_rel:.2e}); cold-start RMSE "
        f"{cold_rmse:.8f} against {REF_IMC_ML1M_COLD_RMSE} (rel "
        f"{cold_rel:.2e}; gate {IMC_COLD_GATE} x std {std:.4f})")
    check(len(hist) == pi.SWEEPS, "the IMC fit ran too few sweeps")
    check(np.isfinite(model.W_).all() and np.isfinite(model.H_).all()
          and model.W_.shape == (X.shape[1], pi.RANK)
          and model.H_.shape == (Y.shape[1], pi.RANK),
          "IMC factors are not finite or have the wrong shape")
    check(max(rel) <= IMC_HISTORY_RTOL,
          f"IMC history differs from the reference: {rel}")
    check(obj_rel <= HISTORY_RTOL,
          f"IMC f64 objective {obj} differs from the reference's")
    check(cold_rel <= HISTORY_RTOL and cold_rmse < IMC_COLD_GATE * std,
          f"IMC cold-start RMSE {cold_rmse} fails")
    check(record["value"] > 0 and ex["sweep_split"]["device_ms"] > 0
          and record["vs_baseline"] > 0,
          "the IMC timed fit or its oracle baseline measured nothing")
    log(f"# IMC timed fit on {ex['card']}: fit_seconds "
        f"{ex['fit_seconds']:.4f}, {record['value']:.0f} obs/s, "
        f"vs_baseline {record['vs_baseline']:.2f}")

    # serving: 512 training users with exclusion, against float64
    n_users, n_items = X.shape[0], Y.shape[0]
    train = sp.csr_matrix((ratings[tr], (users[tr], items[tr])),
                          shape=(n_users, n_items))
    check_users = np.unique(users[tr])[:SERVING_CHECK_USERS]
    _, got = model.recommend(check_users, n=10, exclude_seen=True)
    check(model._veff_cache[2][0].device.type == dev.type,
          "IMC serving did not run on the card")
    Ueff = np.float64(np.float32(X)) @ np.float64(model.W_)
    Veff = np.float64(np.float32(Y)) @ np.float64(model.H_)
    want, sc = frozen_exact_topk(Ueff, Veff, check_users, train, 10)
    rows, cols = np.nonzero(got != want)
    gaps = [abs(sc[r, got[r, c]] - sc[r, want[r, c]])
            / max(abs(sc[r, want[r, c]]), 1e-30) for r, c in zip(rows, cols)]
    log(f"# IMC recommend against a float64 selector ({len(check_users)} "
        f"users, exclusion): {len(gaps)} near-tie swaps, largest relative "
        f"gap {max(gaps, default=0.0):.2e}")
    check(all(g < 1e-6 for g in gaps),
          f"IMC served ids differ from the float64 selector: {gaps[:5]}")
    phase_checkpoints(torch, data, platform)
    return dict(data=data, history=hist, objective=obj,
                fit_seconds=ex["quality_fit_seconds"])


def phase_checkpoints(torch, imc_data, platform=None):
    """A checkpoint round trip of each estimator on the card: a fit with
    ``checkpoint_every=2`` into a directory under ``build/``, then
    ``resume`` into a fresh estimator, whose factors must equal the fit's
    and whose history must match it; the checkpointed fit's factors are
    held against a fit without checkpoints (within 1e-5 of the largest
    entry), and the resumed ``recommend(exclude_seen=True)`` must warn."""
    import tempfile
    import warnings
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS, IMC
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes import imc as pi
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    X, Y, users, items, ratings, cold = imc_data
    tr = ~cold
    n_users, n_items, n_obs = SCALES["ml1m"]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items)
    cases = (
        ("ALS", lambda **kw: ALS(rank=RANK, reg=0.1, n_sweeps=4,
                                 platform=platform, **kw),
         lambda m: m.fit(R, U0=U0, V0=V0), ("U_", "V_")),
        ("IMC", lambda **kw: IMC(rank=pi.RANK, reg=pi.REG, n_sweeps=4,
                                 cg_iters=pi.CG_ITERS, seed=0,
                                 platform=platform, **kw),
         lambda m: m.fit((users[tr], items[tr], ratings[tr]), X, Y),
         ("W_", "H_")))
    for name, make, fit, tables in cases:
        with tempfile.TemporaryDirectory(dir=root) as d:
            t0 = time.perf_counter()
            full = fit(make(checkpoint_dir=d, checkpoint_every=2))
            secs = time.perf_counter() - t0
            plain = fit(make())
            steps = sorted(os.listdir(d))
            back = make(checkpoint_dir=d)
            step = back.resume()
            same = all(np.array_equal(getattr(back, t), getattr(full, t))
                       for t in tables)
            diff = max(float(np.abs(getattr(plain, t) - getattr(full, t)
                                    ).max() / np.abs(getattr(plain, t)).max())
                       for t in tables)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                back.recommend([0], n=5, exclude_seen=True,
                               **({"X": X, "Y": Y} if name == "IMC" else {}))
            log(f"# checkpoint round trip {name}: 4 sweeps with "
                f"checkpoint_every=2 in {secs:.2f}s, saved {steps}, resumed "
                f"step {step}, factors equal {same}; checkpointed against "
                f"plain fit: max abs diff / max abs {diff:.3e}")
            check(step == 4 and same, f"{name} resume differs from its fit")
            check(np.allclose(back.history_, full.history_, rtol=1e-6),
                  f"{name} resumed history differs")
            check(diff <= 1e-5, f"{name}: checkpoints changed the factors")
            check(any("canNOT be excluded" in str(w.message) for w in rec),
                  f"{name}: resumed recommend(exclude_seen=True) did not "
                  "warn")


class _Records(logging.Handler):
    """Collects the port logger's records (the loader's ingest record and
    any warning, such as the native parser's fallback)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def run_cli(args, label):
    """``python -m recommendation_models_tpu_torch.train`` with ``args`` in
    a subprocess from the checkout's root (on the card: no ``--platform``);
    its stdout, after the exit code is checked."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "recommendation_models_tpu_torch.train",
         *args], cwd=root, env=env, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        if line.startswith("[train]"):
            log(f"#   {label}: {line}")
    log(f"# CLI {label}: exit {res.returncode} in {secs:.1f}s")
    check(res.returncode == 0,
          f"the CLI ({label}) exited {res.returncode}: {res.stderr[-3000:]}")
    return res.stdout


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_ml1m_summary(summary, label):
    """The ML-1M CLI run's summary against the JAX package's CLI on a CPU:
    RMSEs within HISTORY_RTOL, recall@10 and NDCG@10 within
    CLI_RANKING_BAND."""
    rel = {k: abs(summary[k] - REF_CLI_ML1M[k]) / REF_CLI_ML1M[k]
           for k in ("train_rmse", "test_rmse")}
    gap = {k: abs(summary[k] - REF_CLI_ML1M[k])
           for k in ("recall_at_10", "ndcg_at_10")}
    log(f"# CLI {label} against the JAX CLI on a CPU: rel diff "
        f"{ {k: float(f'{v:.2e}') for k, v in rel.items()} }, ranking gap "
        f"{gap}")
    check(all(v <= HISTORY_RTOL for v in rel.values()),
          f"CLI {label}: RMSE differs from the JAX CLI's: {summary}")
    check(all(v <= CLI_RANKING_BAND for v in gap.values()),
          f"CLI {label}: recall/NDCG differ from the JAX CLI's: {summary}")


def trace_kernels(trace_dir):
    """Names of the CUDA kernel events of the Chrome traces in
    ``trace_dir``."""
    names = set()
    for name in os.listdir(trace_dir):
        if name.endswith(".pt.trace.json"):
            with open(os.path.join(trace_dir, name)) as f:
                events = json.load(f)["traceEvents"]
            names |= {ev.get("name", "") for ev in events
                      if ev.get("cat") == "kernel"}
    return names


def phase_cli(torch, coo, card):
    """The training CLI on the card (``train.py``): ML-25M through a
    real-format ratings.csv in the process, then ML-1M through the module
    entry point in subprocesses (holdout, checkpoints, trace, resume, the
    cache alone, IMC). The launch counts of this phase are printed here and
    stay out of the ``kernels`` line."""
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import IMC, train
    from recommendation_models_tpu_torch.data import movielens, native
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes.parser import (
        cpu_model, write_ratings)
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "ml1m"))

    # ML-25M: phase 5's ratings as a real-format ratings.csv
    u, i, r = coo
    csv = os.path.join(root, "ratings.csv")
    t0 = time.perf_counter()
    write_ratings(csv, u + 1, i + 1, r, "csv")
    write_s = time.perf_counter() - t0
    mib = os.path.getsize(csv) / 2**20
    log(f"# CLI ML-25M: wrote {csv}: {r.shape[0]} rows, {mib:.1f} MiB in "
        f"{write_s:.2f}s")
    check(native.available(), "the native ratings parser did not build")
    jsonl = os.path.join(root, "ml25m.jsonl")
    port_log = logging.getLogger("recommendation_models_tpu_torch")
    handler = _Records()
    port_log.addHandler(handler)
    level = port_log.level
    port_log.setLevel(logging.INFO)
    try:
        ch.reset_counts()
        rc = train.main(["--ratings", csv, "--rank", str(RANK),
                         "--n-sweeps", str(SWEEPS), "--metrics-jsonl", jsonl])
        launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    finally:
        port_log.removeHandler(handler)
        port_log.setLevel(level)
    check(rc == 0, f"train.main returned {rc}")
    warned = [rec.getMessage() for rec in handler.records
              if rec.levelno >= logging.WARNING]
    ingest = [rec.ingest for rec in handler.records
              if hasattr(rec, "ingest")]
    check(not warned, f"the CLI's load warned: {warned}")
    check(len(ingest) == 1 and ingest[0]["route"] == "native",
          f"the native parser did not parse the file: {ingest}")
    ing = ingest[0]
    check(os.path.exists(csv + ".rmtpu.npz"), "no .rmtpu.npz cache written")
    d = movielens.load_ratings_file(csv)
    check(np.array_equal(d["user_vocab"][d["users"]] - 1, u)
          and np.array_equal(d["item_vocab"][d["items"]] - 1, i)
          and np.array_equal(d["ratings"], r),
          "the loaded ids or ratings differ from phase 5's")
    lines = read_jsonl(jsonl)
    summary = lines[-1]
    rmse = summary["train_rmse"]
    log(f"# CLI ML-25M ingest on {cpu_model()}: parse {ing['parse_s']:.3f}s "
        f"({ing['rows'] / ing['parse_s'] / 1e6:.2f} Mrows/s, "
        f"{mib / ing['parse_s']:.0f} MiB/s, native), remap "
        f"{ing['remap_s']:.3f}s, cache write {ing['cache_s']:.3f}s")
    log(f"# CLI ML-25M fit on {card}: fit_seconds={summary['fit_seconds']} "
        f"rows_per_sec={summary['rows_per_sec']} train_rmse={rmse:.4f} "
        f"(anchor {RMSE_ANCHOR}, default init) launches={launches} "
        f"routed={routed}")
    check(len(lines) == SWEEPS + 1 and all(
        np.isfinite(x["train_rmse"]) for x in lines),
        f"the ML-25M JSONL has {len(lines)} records")
    check(abs(rmse - RMSE_ANCHOR) <= RMSE_ANCHOR_RTOL * RMSE_ANCHOR,
          f"CLI train RMSE {rmse:.4f} is not within 3% of {RMSE_ANCHOR}")
    check(all(launches[n] > 0 for n in MAIN_KERNELS),
          f"a kernel was not launched by the CLI: {launches}")
    check(not any(routed.values()), f"CLI calls were routed: {routed}")
    del d
    torch.cuda.empty_cache()

    # ML-1M through the module entry point, everything turned on
    n_users, n_items, n_obs = SCALES["ml1m"]
    u1, i1, r1 = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    dat = os.path.join(root, "ml1m", "ratings.dat")
    write_ratings(dat, u1 + 1, i1 + 1, r1, "dat")
    ckpt, trace = os.path.join(root, "ckpt"), os.path.join(root, "trace")
    j1, j2 = os.path.join(root, "ml1m.jsonl"), os.path.join(root, "cache.jsonl")
    base = ["--ratings", dat, "--rank", str(RANK), "--n-sweeps", str(SWEEPS),
            "--holdout", "1", "--sse-mode", "separate"]
    run_cli(base + ["--metrics-jsonl", j1, "--checkpoint-dir", ckpt,
                    "--checkpoint-every", "5", "--trace-dir", trace,
                    "--top-n", "10"], "ML-1M")
    lines = read_jsonl(j1)
    per_sweep = [x for x in lines if set(x) == {"step", "ts", "train_rmse"}]
    summary = lines[-1]
    check(len(lines) == SWEEPS + 1 and len(per_sweep) == SWEEPS
          and {"test_rmse", "recall_at_10", "ndcg_at_10"} <= set(summary),
          f"the ML-1M JSONL is not 10 sweeps and a summary: {lines}")
    check_ml1m_summary(summary, "ML-1M")
    kernels = trace_kernels(trace)
    b1 = sorted(n for n in kernels if B1_SYMBOL.search(n))
    log(f"# CLI ML-1M trace: {len(kernels)} distinct kernels, B1's: {b1}")
    check(b1, f"the trace holds no B1 kernel: {sorted(kernels)[:20]}")
    check(sorted(os.listdir(ckpt))[-2:] == ["step_00000010",
                                            "step_00000010.meta.json"],
          f"no checkpoint of sweep 10: {os.listdir(ckpt)}")

    out = run_cli(base + ["--metrics-jsonl", j1, "--checkpoint-dir", ckpt,
                          "--checkpoint-every", "5", "--resume"],
                  "ML-1M --resume")
    resumed = read_jsonl(j1)[len(lines):]
    check("resumed from sweep 10" in out and len(resumed) == SWEEPS + 1,
          "the resumed run did not continue from sweep 10 for 10 sweeps")
    check(resumed[-1]["train_rmse"] <= summary["train_rmse"],
          "the resumed fit's train RMSE rose")

    os.remove(dat)
    run_cli(base + ["--metrics-jsonl", j2], "ML-1M from the cache")
    check_ml1m_summary(read_jsonl(j2)[-1], "ML-1M from the cache")

    # IMC with synthesized side features, against the Python API
    j3 = os.path.join(root, "imc.jsonl")
    run_cli(["--synthetic", "ml1m", "--model", "imc", "--rank", "32",
             "--side-features", "64", "--n-sweeps", "8", "--metrics-jsonl",
             j3], "IMC")
    cli_hist = [x["train_rmse"] for x in read_jsonl(j3)[:-1]]
    R = sp.csr_matrix((r1, (u1, i1)), shape=(n_users, n_items))
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n_users, 64)).astype(np.float32)
    Y = rng.standard_normal((n_items, 64)).astype(np.float32)
    m = IMC(rank=32, reg=0.1, n_sweeps=8, seed=0).fit(R, X, Y)
    api_hist = [float(h) for h in m.history_]
    log(f"# CLI IMC history {cli_hist}; IMC.fit on the card equal: "
        f"{cli_hist == api_hist}")
    check(len(cli_hist) == 8 and all(np.isfinite(cli_hist)),
          f"the IMC CLI history is not 8 finite values: {cli_hist}")
    check(cli_hist == api_hist,
          f"the IMC CLI history differs from IMC.fit's: {api_hist}")
    log(f"# CLI phase: {time.perf_counter() - t_phase:.1f}s")
    return launches


def bench_train_line(torch, dev, name, cfg, anchor, band, gathered, kernels,
                     coo, ul, il):
    """One train line of the bench phase: ``bench.train_record`` on the
    built layouts with the launch counts set to 0 just before and read just
    after; the record printed and gated. Returns the launches."""
    import numpy as np
    from recommendation_models_tpu_torch import bench
    from recommendation_models_tpu_torch.ops import cholesky as ch
    ch.reset_counts()
    t0 = time.perf_counter()
    record = bench.train_record(cfg, coo, ul, il, dev)
    secs = time.perf_counter() - t0
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    print(json.dumps(record), flush=True)
    ex = record["extra"]
    rmse, direct = ex["train_rmse"], ex["direct_rmse"]
    lo, hi = (f * anchor for f in band)
    log(f"# {name}: {record['metric']} epoch_seconds="
        f"{ex['epoch_seconds']:.4f} rows/s={record['value']:.0f} "
        f"vs_baseline={record['vs_baseline']:.2f} train_rmse={rmse:.5f} "
        f"(anchor {anchor}, band [{lo:.5f}, {hi:.5f}]) direct_rmse="
        f"{direct:.5f} ({ex['sse_mode']}) gathered="
        f"{ex['gathered_rows_per_epoch']} roof_fraction="
        f"{ex['roof_fraction']:.5f} dense rows {ex['dense_rows']} "
        f"{ex['dense_tflop_per_sweep']:.3f} TFLOP a sweep "
        f"max_memory_allocated={ex['max_memory_allocated']} "
        f"launches={launches} routed={routed}; {secs:.1f}s (upload, "
        f"warm-up, timed fit, direct RMSE, oracle)")
    check(record["metric"] == cfg.metric() and record["value"] > 0,
          f"{name}: no rows/s measured")
    check(ex["nnz"] == BENCH_NNZ[cfg.scale],
          f"{name}: nnz {ex['nnz']} != {BENCH_NNZ[cfg.scale]}")
    check(ex["gathered_rows_per_epoch"] == gathered,
          f"{name}: gathered rows {ex['gathered_rows_per_epoch']} != "
          f"{gathered}")
    check(ex["sweeps"] == cfg.sweeps
          and all(np.isfinite(h) for h in ex["history"]),
          f"{name}: the fit ran short or is not finite: {ex['history']}")
    check(lo <= rmse <= hi, f"{name}: train RMSE {rmse} is outside "
          f"[{lo}, {hi}]")
    check(abs(rmse - direct) <= HISTORY_RTOL * direct,
          f"{name}: the history's last RMSE {rmse} differs from a direct "
          f"RMSE of the final factors {direct}")
    check(all(launches[n] > 0 for n in kernels),
          f"{name}: a kernel was not launched: {launches}")
    check(not any(routed.values()), f"{name}: calls were routed: {routed}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, f"{name}: TF32 is on")
    check(ex["max_memory_allocated"] > 0, f"{name}: no peak memory")
    return launches


def phase_bench(torch, dev, main_data, synth):
    """The port's bench (``recommendation_models_tpu_torch.bench``) in the
    process, one JSON line per run: ML-25M rank 64 explicit on phase 5's
    layouts, rank 128 on phase 5's ratings, rank 64 implicit on phase 5's
    layouts; synth-100M (made once) at rank 64, then 128; the serving mode
    (ML-25M, rank 64) and the IMC mode (ML-1M, rank 64 capped to 32).
    ``main_data`` is a list [coo, ul, il] of phase 5's ratings and layouts,
    emptied here so that they are freed before synth-100M is loaded;
    ``synth`` is ``start_synth_data``'s child, which made its ratings and
    layouts. Returns the launches of each train line."""
    import dataclasses
    import gc
    from recommendation_models_tpu_torch import bench
    t_phase = time.perf_counter()
    coo, ul, il = main_data
    main_data.clear()
    by_line = {}
    lines = {n: rest for n, *rest in BENCH_LINES}
    for name in ("bench_default", "bench_r128", "bench_implicit"):
        over, anchor, band, gathered, kernels = lines[name]
        cfg = bench.BenchConfig(**over)
        if cfg.rank == RANK:
            layouts = (ul, il)
        else:
            t0 = time.perf_counter()
            layouts = bench.train_layouts(cfg, coo)[1:]
            log(f"# {name}: layouts in {time.perf_counter() - t0:.1f}s")
        by_line[name] = bench_train_line(torch, dev, name, cfg, anchor,
                                         band, gathered, kernels, coo,
                                         *layouts)
        del layouts
        torch.cuda.empty_cache()
    del coo, ul, il
    gc.collect()
    coo = load_synth_data(synth)
    for name in ("bench_100m_r64", "bench_100m_r128"):
        over, anchor, band, gathered, kernels = lines[name]
        cfg = bench.BenchConfig(**over)
        t0 = time.perf_counter()
        cache = synth_layout_dir(synth[2], cfg)
        _, bul, bil = bench.train_layouts(
            dataclasses.replace(cfg, layout_cache=cache), coo)
        log(f"# {name}: layouts loaded from the child's cache in "
            f"{time.perf_counter() - t0:.1f}s")
        shutil.rmtree(cache)
        by_line[name] = bench_train_line(torch, dev, name, cfg, anchor,
                                         band, gathered, kernels, coo, bul,
                                         bil)
        del bul, bil
        gc.collect()
        torch.cuda.empty_cache()
    del coo
    gc.collect()
    record = bench.serving_record(bench.BenchConfig(mode="serving"), dev)
    print(json.dumps(record), flush=True)
    ex = record["extra"]
    check(record["metric"] == "topk_retrieval_users_per_sec_rank64_ml25m_"
          "synth" and record["value"] > 0 and ex["auto_ids_equal_exact"],
          f"the bench's serving line failed: {record}")
    for key, want in (("recall_at_10", SERVING_RECALL_ANCHOR),
                      ("ndcg_at_10", SERVING_NDCG_ANCHOR)):
        check(abs(ex[key] - want) <= SERVING_BAND,
              f"the bench's serving {key} {ex[key]} is not within "
              f"{SERVING_BAND} of {want}")
    torch.cuda.empty_cache()
    record = bench.imc_record(bench.BenchConfig(mode="imc", scale="ml1m"),
                              dev)
    print(json.dumps(record), flush=True)
    ex = record["extra"]
    rel = max(abs(a - b) / b for a, b in zip(ex["history"], REF_IMC_ML1M))
    check(record["metric"] == "imc_obs_per_sec_per_chip_rank32_ml1m_synth"
          and record["value"] > 0 and rel <= IMC_HISTORY_RTOL
          and abs(ex["cold_start_rmse"] - REF_IMC_ML1M_COLD_RMSE)
          <= HISTORY_RTOL * REF_IMC_ML1M_COLD_RMSE,
          f"the bench's IMC line failed (history rel diff {rel:.2e}): "
          f"{record}")
    log(f"# bench phase: {time.perf_counter() - t_phase:.1f}s")
    return by_line


# ------------------------------------------------- phase 13: past k = 128

WIDE_KS = (136, 160)            # B1-B3 past the old k = 128 cap
WIDE_BATCHES = (256, 65_536)
LARGE_KS = (168, 256, 512, 656)  # the one-block kernel's orders
MULTIWAVE_K = 168                 # block_batch(k) systems past one wave
FUZZ_TRIALS, FUZZ_SEED = 25, 0
R160 = 160
R160_HOT_SWEEPS = 3   # 13g's sweeps (B2 at rank 160 in the panel frame)
LARGE_FIT_RANK = 256            # the estimator path of the one-block kernel
QP_IMC_SEEDS = (0, 1, 2)
QP_TIMEOUT = 900                # seconds a child oracle may take
SYNTH_TIMEOUT = 900             # seconds the synth-100M data child may take

# ML-1M-shaped rank-160 train-RMSE history (the exact masked SSE) of the JAX
# package, recorded on a CPU (gather_budget_mb=256 bounds the host memory;
# it splits rows into blocks and changes no row's arithmetic):
#   JAX_PLATFORMS=cpu python -c '
#   import numpy as np, scipy.sparse as sp
#   from recommendation_models_tpu.data.synthetic import synthetic_ratings
#   from recommendation_models_tpu import ALS
#   u, i, r = synthetic_ratings(6040, 3706, 1_000_209, rank=16, seed=0)
#   R = sp.csr_matrix((r, (u, i)), shape=(6040, 3706))
#   g = np.random.default_rng(0)
#   U0 = 0.01 * g.standard_normal((6040, 160)).astype(np.float32)
#   V0 = 0.01 * g.standard_normal((3706, 160)).astype(np.float32)
#   m = ALS(rank=160, reg=0.1, n_sweeps=10, solver="xla",
#           compute_dtype="float32", sse_mode="separate",
#           gather_budget_mb=256, platform="cpu").fit(R, U0=U0, V0=V0)
#   print([float(x) for x in m.history_])'
REF_ML1M_R160 = [
    0.6028932332992554, 0.2509901225566864, 0.10480209439992905,
    0.0677432119846344, 0.052201442420482635, 0.04362676665186882,
    0.03809554874897003, 0.03416580706834793, 0.031185265630483627,
    0.028813518583774567]


def start_imc_oracles(seeds=QP_IMC_SEEDS):
    """One child process a seed fitting the IMC quality probe's oracle on the
    host (``--oracle-only``, one thread, no card): [(seed, process, file)]."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    children = []
    for s in seeds:
        path = os.path.join(out, f"qp_imc_oracle_{s}.npz")
        if os.path.exists(path):
            os.remove(path)
        with open(path + ".err", "w") as err:
            children.append((s, subprocess.Popen(
                [sys.executable, "-m",
                 "recommendation_models_tpu_torch.probes.quality_parity_imc",
                 "--oracle-only", "--seeds", str(s), "--out", path],
                cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err),
                path))
    return children


def synth_layout_dir(cache, cfg):
    """The layout cache directory of one bench configuration's lines."""
    return os.path.join(cache, f"rank{cfg.rank}")


def make_synth_data(path, scale, configs):
    """The work of ``start_synth_data``'s child: the ratings of ``scale``
    (``synthetic_ratings(*SCALES[scale], rank=16, seed=0)``) saved to
    ``path``, then both layouts of each bench configuration in ``configs``
    (``BenchConfig`` fields) built into the bench's layout cache,
    ``synth_layout_dir(<path without .npz>_layouts, cfg)``."""
    import dataclasses
    import numpy as np
    from recommendation_models_tpu_torch import bench
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.probes import SCALES
    coo = synthetic_ratings(*SCALES[scale], rank=16, seed=0)
    part = path[:-4] + ".part.npz"
    np.savez(part, u=coo[0], i=coo[1], r=coo[2])
    os.replace(part, path)
    for over in configs:
        cfg = bench.BenchConfig(**over)
        bench.train_layouts(dataclasses.replace(
            cfg, layout_cache=synth_layout_dir(path[:-4] + "_layouts", cfg)),
            coo)


def start_synth_data(scale="synth100m", configs=None):
    """Phase 12's synth-100M ratings and both layouts of its two lines
    (``configs``, by default theirs in ``BENCH_LINES``; about 160 s of one
    core) made in a child process on the host (one thread, no card,
    ``make_synth_data``) while the parent runs phase 11, into
    ``build/chip_smoke/<scale>.npz`` and ``<scale>_layouts/``: (process,
    data path, layout cache directory, start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "chip_smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{scale}.npz")
    cache = path[:-4] + "_layouts"
    shutil.rmtree(cache, ignore_errors=True)
    if os.path.exists(path):
        os.remove(path)
    if configs is None:
        configs = [over for name, over, *_ in BENCH_LINES
                   if over.get("scale") == scale]
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = ("import json, sys; import chip_smoke; "
            "chip_smoke.make_synth_data(sys.argv[1], sys.argv[2], "
            "json.loads(sys.argv[3]))")
    with open(path + ".err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, path, scale, json.dumps(configs)],
            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err)
    return proc, path, cache, time.perf_counter()


def load_synth_data(synth, timeout=SYNTH_TIMEOUT):
    """Waits for ``start_synth_data``'s child and loads its ratings:
    (users, items, ratings), its file removed. Its layouts load through
    the bench's cache (``BenchConfig(layout_cache=synth_layout_dir(
    synth[2], cfg))``)."""
    import numpy as np
    proc, path, _, t_start = synth
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, timeout - (t0 - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise Failed(f"the synth-100M data child ran past {timeout} s")
    waited = time.perf_counter() - t0
    if rc != 0:
        with open(path + ".err") as f:
            raise Failed(f"the synth-100M data child exited {rc}: "
                         f"{f.read()[-3000:]}")
    with np.load(path) as z:
        coo = (z["u"], z["i"], z["r"])
    os.remove(path)
    log(f"# synth-100M data and layouts: {coo[2].shape[0]} obs, made beside "
        f"phase 11 in {t0 + waited - t_start:.1f}s (waited {waited:.1f}s, "
        f"the data loaded in {time.perf_counter() - t0 - waited:.1f}s)")
    return coo


def stop_children(children):
    for _, proc, _ in children:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def profiled_or_none(fn, reps):
    """Device ms per call from ``torch.profiler``, or None when the profiler
    records no device time (it drops some ms-long calls on the card); the
    CUDA-event ms beside it is always measured."""
    from recommendation_models_tpu_torch.probes import profiled_ms
    try:
        return profiled_ms(fn, reps)
    except RuntimeError as exc:
        log(f"# {exc}: device ms not measured")
        return None


def wide_numbers(torch, fn, library, b, timed_host):
    """Device ms (profiler, or None), CUDA-event ms, library device ms and,
    at the 256-row batch, host µs per call of ``fn`` at batch b."""
    from recommendation_models_tpu_torch.probes import host_us
    from recommendation_models_tpu_torch.probes.solve_latency import reps_for
    reps = reps_for(b)
    return dict(device_ms=profiled_or_none(fn, reps),
                ms=time_ms(torch, fn, max(3, reps // 4), warm=1),
                host_us=host_us(fn) if timed_host else None,
                library_device_ms=profiled_or_none(library,
                                                   max(2, reps // 8)))


def regime_blocks_per_sm(torch, dev, ch, name, frame, resident, k, c=0):
    """Blocks an SM of the kernel of ``name`` that a launch in ``frame``
    (``ops.cholesky.solve_frame``) takes at order k (B2 at hot width c):
    the latency kernel's ``resident`` blocks, or the panel frame's
    (``panel_resident``), over the SM count; None for a throughput kernel,
    whose residency its library does not report."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if frame == "latency":
        return resident / sms
    if frame == "panel":
        return ch.panel_resident(name, k, c) / sms
    return None


def phase_wide_kernels(torch, dev):
    """13a: B1, B2 (C = the reference's cap, 24 and 16) and B3 (both grams
    summed) at k = 136 and 160, at 256 rows and 65,536: each against its
    plain version and repeated bitwise; device ms, event ms, host µs (256
    rows: the enqueue does not depend on the batch), the plain version's
    ms (256 rows), the bound and the library solve's device ms, with the
    kernel's ``frame`` (``ops.cholesky.solve_frame``: B1-B3 past kp = 128
    take the panel frame of csrc/cholesky_rank_panel.cu beyond two waves,
    and at k = 160 beyond one) and its ``blocks_per_sm``. Where B3 takes
    the panel frame its result equals B1's panel-frame kernel (B4 (1, 1)'s
    there) on the f32 sum G + G2, and where B2 does, its result with an
    all-zero hot slab equals that kernel on G, bit for bit
    (``bitwise_b1_panel``).
    Then B3's public entry ``solve_spd_t(Gt2=)`` at k = 160, 65,536 rows,
    counted: one panel-frame launch, bitwise equal to the wrapper's
    result. Returns ({kernel: {k: {batch: numbers}}}, B3's launches
    there)."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.solve import solve_spd_t
    from recommendation_models_tpu_torch.probes.solve_latency import (
        hot_slab, random_systems)
    out = {n: {} for n in ch.REGIME_KINDS}
    t0 = time.perf_counter()
    for k in WIDE_KS:
        gen = torch.Generator(device=dev).manual_seed(k)
        n = max(WIDE_BATCHES)
        G, rhs, reg = random_systems(n, k, 3 * k // 4, gen, dev)
        G2 = random_systems(n, k, 16, gen, dev)[0]
        c = ch.hot_cols_cap(k)
        hv = hot_slab(n, c, gen, dev)
        vh = 0.3 * torch.randn(c, k, generator=gen, device=dev)
        eye = torch.eye(k, device=dev)

        def library(A, rs, gs):
            return torch.cholesky_solve(rs[:, :, None], torch.linalg.cholesky(
                A + gs[:, None, None] * eye))

        def library_hot(Gs, rs, gs, hs, v):
            Gf, rf = ch.fold_hot(Gs, rs, hs, v, None)
            return library(Gf, rf, gs)

        cases = {
            "cholesky_solve_batched": (
                ch.cholesky_solve_batched, ch.cholesky_solve_plain,
                lambda b: (G[:b], rhs[:b], reg[:b]), library),
            "cholesky_solve_2g": (
                ch.cholesky_solve_2g, ch.cholesky_solve_2g_plain,
                lambda b: (G[:b], G2[:b], rhs[:b], reg[:b]),
                lambda Gs, G2s, rs, gs: library(Gs + G2s, rs, gs)),
            "cholesky_solve_hot": (
                ch.cholesky_solve_hot, ch.cholesky_solve_hot_plain,
                lambda b: (G[:b], rhs[:b], reg[:b], hv[:b], vh),
                library_hot),
        }
        for name, (fn, plain, args_of, lib) in cases.items():
            out[name][str(k)] = {}
            for b in WIDE_BATCHES:
                args = tuple(a.contiguous() for a in args_of(b))
                ch.reset_counts()
                x = fn(*args)
                check(ch.LAUNCHES[name] == 1 and not any(ch.ROUTED.values()),
                      f"{name} at k={k} B={b} did not take its kernel: "
                      f"{ch.LAUNCHES} {ch.ROUTED}")
                err, ok = compare(torch, x, plain(*args))
                check(ok, f"{name} disagrees with its plain version at k={k}"
                          f" B={b} (max abs err {err:.3e})")
                check(torch.equal(x, fn(*args)),
                      f"{name} is not bitwise repeatable at k={k} B={b}")
                hot_c = c if name == "cholesky_solve_hot" else 0
                _, resident = ch.solve_regime(name, b, k, hot_c)
                frame = ch.solve_frame(name, b, k, resident)
                bitwise = None
                if frame == "panel" and name != "cholesky_solve_batched":
                    # B3 on G + G2, and B2 with no hot entry, are B1's
                    # panel-frame kernel's solve, bit for bit
                    if name == "cholesky_solve_2g":
                        same = (args[0] + args[1], args[2], args[3])
                        got = x
                    else:
                        same = args[:3]
                        got = fn(*args[:3], torch.zeros_like(args[3]),
                                 args[4])
                    bitwise = torch.equal(got, ch.cholesky_solve_rank1(
                        *same, 1, 1))
                    check(bitwise, f"{name} at k={k} B={b} differs from "
                                   f"B1's panel frame (bitwise)")
                    del got, same
                nums = wide_numbers(torch, lambda: fn(*args),
                                    lambda: lib(*args), b,
                                    timed_host=b == min(WIDE_BATCHES))
                # the plain version's ms, at the 256-row batch (a Python
                # loop over k columns)
                nums["plain_ms"] = (time_ms(torch, lambda: plain(*args), 1,
                                            warm=1)
                                    if b == min(WIDE_BATCHES) else None)
                n_bytes, n_flops = solve_bytes(b, k), solve_flops(b, k)
                if name == "cholesky_solve_2g":
                    n_bytes += 4.0 * b * k * (k + 1) / 2
                    n_flops += b * k * (k + 1) / 2
                elif name == "cholesky_solve_hot":
                    nnz = int((hv[:b] != 0).sum())
                    n_bytes += 2.0 * b * c + 4.0 * c * k
                    n_flops += (k * (k + 1) + 2.0 * k) * nnz
                bound_ms, bound_by = bound(n_bytes, n_flops)
                nums.update(max_abs_err=err, bound_ms=bound_ms,
                            bound_by=bound_by, resident=resident,
                            frame=frame, bitwise_b1_panel=bitwise,
                            blocks_per_sm=regime_blocks_per_sm(
                                torch, dev, ch, name, frame, resident, k,
                                hot_c))
                out[name][str(k)][str(b)] = nums
                log(f"# 13a {name} k={k} B={b} ({frame}, bitwise to B1's "
                    f"panel frame {bitwise}, "
                    f"{nums['blocks_per_sm']} blocks an SM, resident "
                    f"{resident}{f', C={c}' if 'hot' in name else ''}): "
                    f"max_abs_err={err:.3e} device_ms={nums['device_ms']} "
                    f"ms={nums['ms']:.5f} host_us={nums['host_us']} "
                    f"plain_ms={nums['plain_ms']} "
                    f"library_device_ms={nums['library_device_ms']} "
                    f"bound_ms={bound_ms:.5f} ({bound_by})")
        if k == max(WIDE_KS):
            # B3's public entry, batch-minor views as its callers hold them
            n = max(WIDE_BATCHES)
            torch.cuda.synchronize()
            ch.reset_counts()
            x = solve_spd_t(G.permute(1, 2, 0), rhs.t(), "auto", reg_vec=reg,
                            Gt2=G2.permute(1, 2, 0)).t()
            torch.cuda.synchronize()
            path = dict(ch.LAUNCHES)
            check(path["cholesky_solve_2g"] == 1
                  and ch.PANEL_LAUNCHES["cholesky_solve_2g"] == 1
                  and not any(ch.ROUTED.values()),
                  f"solve_spd_t(Gt2=) at k={k} B={n} did not take B3's "
                  f"panel frame: {path} {ch.PANEL_LAUNCHES} {ch.ROUTED}")
            check(torch.equal(x, ch.cholesky_solve_2g(G, G2, rhs, reg)),
                  "solve_spd_t(Gt2=) differs from cholesky_solve_2g")
            log(f"# 13a solve_spd_t(Gt2=) k={k} B={n}: one panel-frame "
                f"launch of B3, bitwise equal to cholesky_solve_2g")
            del x
        del G, G2, rhs, reg, hv
        torch.cuda.empty_cache()
    log(f"# 13a: {time.perf_counter() - t0:.1f}s")
    return out, path["cholesky_solve_2g"]


def phase_large_kernel(torch, dev):
    """13b: the one-block kernel (``cholesky_solve_large``) at k = 168, 256,
    512 and 656, B = 1 and ``block_batch(k)`` (two grams: 1 and the halved
    block), through the batch wrappers: against the plain versions,
    repeated bitwise, zero and identity systems exactly 0; event ms, device
    ms, host µs, the bound and the library solve. Returns {k: {case:
    numbers}}."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import host_us
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    out = {}
    t0 = time.perf_counter()
    for k in LARGE_KS:
        gen = torch.Generator(device=dev).manual_seed(k)
        bb, b2 = ch.block_batch(k), ch.two_operand_block(k)
        G, rhs, reg = random_systems(bb, k, 3 * k // 4, gen, dev)
        G2 = random_systems(bb, k, 16, gen, dev)[0]
        eye = torch.eye(k, device=dev)
        out[str(k)] = {}
        for two, batches in ((False, (1, bb)), (True, (1, b2))):
            for b in batches:
                args = (G[:b], G2[:b], rhs[:b], reg[:b]) if two else (
                    G[:b], rhs[:b], reg[:b])
                fn = ch.cholesky_solve_2g if two else ch.cholesky_solve_batched
                plain = (ch.cholesky_solve_2g_plain if two
                         else ch.cholesky_solve_plain)
                ch.reset_counts()
                x = fn(*args)
                check(ch.LAUNCHES["cholesky_solve_large"] == 1
                      and not any(ch.ROUTED.values()),
                      f"k={k} B={b} did not take the one-block kernel: "
                      f"{ch.LAUNCHES} {ch.ROUTED}")
                t1 = time.perf_counter()
                ref = plain(*args)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t1) * 1e3
                err, ok = compare(torch, x, ref)
                check(ok, f"cholesky_solve_large k={k} B={b} two={two} "
                          f"disagrees with its plain version ({err:.3e})")
                check(torch.equal(x, fn(*args)),
                      f"cholesky_solve_large k={k} B={b} is not bitwise "
                      f"repeatable")
                A = (args[0] + args[1]) if two else args[0]
                gs = args[-1]

                def library(A=A, rs=args[-2], gs=gs):
                    return torch.cholesky_solve(rs[:, :, None],
                                                torch.linalg.cholesky(
                                                    A + gs[:, None, None]
                                                    * eye))

                n_bytes = solve_bytes(b, k) + (4.0 * b * k * (k + 1) / 2
                                               if two else 0.0)
                n_flops = solve_flops(b, k) + (b * k * (k + 1) / 2
                                               if two else 0.0)
                bound_ms, bound_by = bound(n_bytes, n_flops)
                nums = dict(
                    ms=time_ms(torch, lambda: fn(*args), 10),
                    device_ms=profiled_or_none(lambda: fn(*args), 10),
                    host_us=host_us(lambda: fn(*args)),
                    library_ms=time_ms(torch, library, 5),
                    plain_ms=plain_ms, max_abs_err=err, bound_ms=bound_ms,
                    bound_by=bound_by, cluster=ch.cluster_size(k, b))
                out[str(k)][f"{'2g' if two else 'g'}_{b}"] = nums
                log(f"# 13b cholesky_solve_large k={k} B={b} C="
                    f"{nums['cluster']} "
                    f"{'G+G2' if two else 'G'}: max_abs_err={err:.3e} ms="
                    f"{nums['ms']:.4f} device_ms={nums['device_ms']} "
                    f"host_us={nums['host_us']:.1f} plain_ms={plain_ms:.1f} "
                    f"library_ms={nums['library_ms']:.4f} bound_ms="
                    f"{bound_ms:.5f} ({bound_by})")
        Gz = torch.zeros(bb, k, k, device=dev)
        Gz[1::2] = eye
        z, zr = torch.zeros(bb, k, device=dev), torch.zeros(bb, device=dev)
        for x in (ch.cholesky_solve_batched(Gz, z, zr),
                  ch.cholesky_solve_2g(Gz[:b2], Gz[:b2], z[:b2], zr[:b2])):
            check(bool((x == 0).all()),
                  f"zero / identity systems did not solve to 0 at k={k}")
        if k == MULTIWAVE_K:
            out["multiwave"] = multiwave_case(torch, ch, G, rhs, reg, k, bb)
        del G, G2, rhs, reg
        torch.cuda.empty_cache()
    log(f"# 13b: {time.perf_counter() - t0:.1f}s")
    return out


def multiwave_case(torch, ch, G, rhs, reg, k, b):
    """13b's launch past one wave of clusters: b systems of order k at the
    smallest cluster size above the rule's that the card cannot hold at
    once (``ops.cholesky.multiwave_cluster``), against the plain version,
    repeated bitwise and bitwise equal to the rule's launch (no element's
    order of terms depends on the cluster), launched once a call."""
    x = ch.cholesky_solve_batched(G, rhs, reg)
    c = ch.multiwave_cluster(k, b)
    with ch.forced_cluster(c):
        ch.reset_counts()
        xw = ch.cholesky_solve_batched(G, rhs, reg)
        check(ch.LAUNCHES["cholesky_solve_large"] == 1
              and not any(ch.ROUTED.values()),
              f"the multi-wave launch at k={k} B={b} C={c} did not take "
              f"the one-block kernel: {ch.LAUNCHES} {ch.ROUTED}")
        err, ok = compare(torch, xw, ch.cholesky_solve_plain(G, rhs, reg))
        check(ok and torch.equal(xw, ch.cholesky_solve_batched(G, rhs, reg))
              and torch.equal(xw, x),
              f"the multi-wave launch at k={k} B={b} C={c} disagrees "
              f"({err:.3e}) or is not bitwise the rule's")
        ms = time_ms(torch, lambda: ch.cholesky_solve_batched(G, rhs, reg),
                     10)
    nums = dict(k=k, batch=b, cluster=c,
                active_clusters=ch.active_clusters(k, c), ms=ms,
                max_abs_err=err,
                rule_cluster=ch.cluster_size(k, b),
                rule_ms=time_ms(
                    torch, lambda: ch.cholesky_solve_batched(G, rhs, reg), 10))
    log(f"# 13b multi-wave k={k} B={b} C={c} (the card holds "
        f"{nums['active_clusters']} such clusters; {b * c} CTAs): "
        f"max_abs_err={err:.3e} ms={ms:.4f} against C="
        f"{nums['rule_cluster']}'s {nums['rule_ms']:.4f}")
    return nums


def phase_large_path(torch, dev):
    """13b, the one-block kernel on paths a user runs, with the launch counts
    set to 0 just before and read just after: ``ops.solve.solve_spd_t``
    (and with ``Gt2``) at each of its orders and one block, then
    ``ALS(rank=256).fit`` on ML-100K-shaped ratings (buckets padded to 48
    rows: the blocks of at most 48 take the kernel, the larger ones are
    routed, as the JAX package sends them to XLA), 5 sweeps, its history
    within 1e-3 of the same fit with ``solver='xla'``. Returns the
    launches."""
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.solve import solve_spd_t
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        warm_start)
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    gen = torch.Generator(device=dev).manual_seed(7)
    inputs = []
    for k in LARGE_KS:
        for b, two in ((ch.block_batch(k), False),
                       (ch.two_operand_block(k), True)):
            G, rhs, reg = random_systems(b, k, 3 * k // 4, gen, dev)
            G2 = random_systems(b, k, 16, gen, dev)[0] if two else None
            inputs.append((G.permute(1, 2, 0), rhs.t(), reg,
                           None if G2 is None else G2.permute(1, 2, 0)))
    n_users, n_items, n_obs = SCALES["ml100k"]
    u, i, r = synthetic_ratings(n_users, n_items, n_obs, rank=16, seed=0)
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items, LARGE_FIT_RANK)
    kw = dict(rank=LARGE_FIT_RANK, reg=1.0, n_sweeps=5, sse_mode="separate")
    ch.reset_counts()
    xs = [solve_spd_t(Gt, rt, "pallas", reg_vec=rv, Gt2=Gt2)
          for Gt, rt, rv, Gt2 in inputs]
    m = ALS(**kw).fit(R, U0=U0, V0=V0)
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    for (Gt, rt, rv, Gt2), x in zip(inputs, xs):
        ref = solve_spd_t(Gt, rt, "xla", reg_vec=rv, Gt2=Gt2)
        err = float((x - ref).abs().max()) / max(float(ref.abs().max()), 1)
        check(err < 5e-3, f"solve_spd_t at k={Gt.shape[0]} B={Gt.shape[2]} "
                          f"differs from the anchor ({err:.2e})")
    ref = ALS(solver="xla", **kw).fit(R, U0=U0, V0=V0)
    hist, want = ([float(h) for h in f.history_] for f in (m, ref))
    rel = max(abs(a - b) / b for a, b in zip(hist, want))
    log(f"# 13b path: solve_spd_t at k={list(LARGE_KS)} and "
        f"ALS(rank={LARGE_FIT_RANK}).fit ML-100K: launches={launches} "
        f"routed={routed}; history={hist} rel diff vs solver='xla' "
        f"{rel:.2e}")
    check(np.isfinite(m.U_).all() and rel <= HISTORY_RTOL,
          f"ALS(rank={LARGE_FIT_RANK}) differs from the anchor fit: {rel}")
    check(launches["cholesky_solve_large"] > 2 * len(LARGE_KS),
          f"the rank-{LARGE_FIT_RANK} fit did not launch the one-block "
          f"kernel: {launches}")
    check(routed["cholesky_solve_batched"] > 0,
          f"the rank-{LARGE_FIT_RANK} fit routed no block past 48 rows: "
          f"{routed}")
    return launches


def phase_fuzz(torch, dev):
    """13c: the kernel shape fuzz (``probes/fuzz_kernel_shapes.py``), 25
    trials of seed 0: every trial within 5e-3 of the anchor, and ``ROUTED``
    counting exactly the trials that ``pallas_supported`` refuses."""
    from recommendation_models_tpu_torch.probes import fuzz_kernel_shapes as fz
    t0 = time.perf_counter()
    try:
        out = fz.run(FUZZ_TRIALS, FUZZ_SEED, dev, log=log)
    except AssertionError as exc:
        raise Failed(f"kernel shape fuzz: {exc}") from exc
    refused = [r for r in out if not r["supported"]]
    check(len(out) == FUZZ_TRIALS
          and all(r["routed"] == ({} if r["supported"] else
                                  {("cholesky_solve_2g" if r["two_op"] else
                                    "cholesky_solve_batched"): 1})
                  for r in out),
          "the fuzz's routed calls do not match pallas_supported")
    log(f"# 13c fuzz: {len(out)}/{FUZZ_TRIALS} trials passed, "
        f"{len(refused)} routed (pallas_supported refuses "
        f"{len(refused)}), max err {max(r['err'] for r in out):.2e}; "
        f"{time.perf_counter() - t0:.1f}s")
    return out


def phase_rank160(torch, dev, coo):
    """13d: ``ALS(rank=160).fit`` on phase 5's ML-25M-shaped ratings (auto
    policy: no hot columns, dense threshold 3,200, growth 1.25, a 4,096 MB
    gather budget, the riding SSE), 10 sweeps from the bench's warm start,
    the launch counts set to 0 just before and read just after: B1 launched
    in both regimes (its latency kernel to one wave, the panel frame past
    it), nothing routed. The same fit with ``solver='xla'``
    (history within 1e-3); on the fit's layouts (its layout cache) the
    bench's timed fit, one warm-up sweep and 10 timed (epoch, history
    equal to the fit's), a direct RMSE of its factors against the riding
    history's last (1e-3), one profiled sweep after a warm-up sweep (its
    device ms, and B1's kernels' among them, from a trace that recorded
    every B1 launch of its sweep); then ML-1M at rank 160 (exact SSE)
    against the JAX package's CPU history (1e-3 a sweep).
    Returns (launches, record)."""
    import shutil as _shutil
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.bench import dense_tflop_per_sweep
    from recommendation_models_tpu_torch.data.layout import csr_arrays
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import (
        PROFILE_TRIES, SCALES, step_rows)
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        scanned_fits, time_fit, warm_start)
    from recommendation_models_tpu_torch.solver.als_sweep import masked_sse
    t_phase = time.perf_counter()
    u, i, r = coo
    n_users, n_items = SCALES["ml25m"][:2]
    nnz = r.shape[0]
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items, R160)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke", "r160_layouts")
    _shutil.rmtree(cache, ignore_errors=True)
    os.makedirs(cache)
    prefix = os.path.join(cache, "ml25m")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ch.reset_counts()
    t0 = time.perf_counter()
    m = ALS(rank=R160, reg=0.1, n_sweeps=SWEEPS,
            layout_cache=prefix).fit(R, U0=U0, V0=V0)
    fit_s = time.perf_counter() - t0
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    latency = dict(ch.LATENCY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    hist = [float(h) for h in m.history_]
    check(len(hist) == SWEEPS and np.isfinite(m.U_).all()
          and np.isfinite(m.V_).all() and m.U_.shape == (n_users, R160),
          "the rank-160 fit ran short or is not finite")
    check(launches["cholesky_solve_batched"] > 0
          and 0 < latency["cholesky_solve_batched"]
          < launches["cholesky_solve_batched"],
          f"the rank-160 fit did not launch B1 in both regimes: {launches}, "
          f"latency {latency}")
    check(not any(routed.values()), f"the rank-160 fit routed: {routed}")
    t0 = time.perf_counter()
    x = ALS(rank=R160, reg=0.1, n_sweeps=SWEEPS, solver="xla",
            layout_cache=prefix).fit(R, U0=U0, V0=V0)
    xla_s = time.perf_counter() - t0
    xhist = [float(h) for h in x.history_]
    rel_xla = max(abs(a - b) / b for a, b in zip(hist, xhist))
    check(rel_xla <= HISTORY_RTOL,
          f"the rank-160 history differs from solver='xla': {rel_xla}")
    del x
    indptr, indices, data, nu, ni = csr_arrays(R)
    ul, il = m._build_layouts(indptr, indices, data, nu, ni,
                              m._data_config())
    fits = scanned_fits(ul, il, nnz, dev, R160, sweeps=SWEEPS)
    epoch_s, U, V, sse_h, n_done = time_fit(fits.fit, fits.U0, fits.V0)
    thist = [float(h) for h in np.sqrt(np.maximum(sse_h[:n_done], 0) / nnz)]
    rel_fit = max(abs(a - b) / b for a, b in zip(thist, hist))
    direct = float(np.sqrt(max(float(masked_sse(
        U, V, fits.user_buckets, chunk=fits.cfg.chunk,
        gather_budget_mb=fits.cfg.gather_budget_mb)), 0.0) / nnz))
    # one profiled sweep, traced after a warm-up sweep (a trace begun at
    # the call loses its first kernels), taken again where its B1 rows
    # miss one of the sweep's B1 launches
    prof = {"device_ms_per_sweep": None, "idle_share": None, "top": []}
    b1_rows = []
    for _ in range(PROFILE_TRIES):
        ch.reset_counts()
        rows = step_rows(lambda: fits.one(U, V))
        if not rows:
            continue
        # step_rows runs three sweeps and traces the last
        per_sweep = ch.LAUNCHES["cholesky_solve_batched"] // 3
        device_ms = sum(r[0] for r in rows) / 1e3
        prof = {"device_ms_per_sweep": device_ms,
                "idle_share": 1.0 - device_ms / (epoch_s * 1e3),
                "top": [{"name": n, "ms": t / 1e3, "calls": c}
                        for t, c, n in rows]}
        # B1's kernels (the fit launches no other solve kernel): the
        # latency kernel of csrc/cholesky_solve.cu and past one wave the
        # panel frame of csrc/cholesky_rank_panel.cu
        b1_rows = [r for r in prof["top"]
                   if "chol_solve_kernel" in r["name"]
                   or "rank_panel_kernel" in r["name"]]
        recorded = sum(r["calls"] for r in b1_rows)
        if recorded == per_sweep:
            break
        log(f"# 13d profile: {recorded} of the sweep's {per_sweep} B1 "
            f"launches recorded")
        b1_rows = []
    # None where no profile recorded every B1 launch of its sweep
    b1_ms = sum(r["ms"] for r in b1_rows) if b1_rows else None
    check(n_done == SWEEPS and rel_fit <= HISTORY_RTOL,
          f"the timed rank-160 fit does not reproduce ALS.fit: {rel_fit}")
    check(abs(thist[-1] - direct) <= HISTORY_RTOL * direct,
          f"the rank-160 riding RMSE {thist[-1]} differs from a direct RMSE "
          f"{direct}")
    dense = {"user": 0 if ul.dense_ids is None else ul.dense_ids.shape[0],
             "item": 0 if il.dense_ids is None else il.dense_ids.shape[0]}
    record = dict(fit_seconds=fit_s, xla_fit_seconds=xla_s,
                  epoch_seconds=epoch_s,
                  device_ms_per_sweep=prof["device_ms_per_sweep"],
                  b1_device_ms_per_sweep=b1_ms,
                  b1_kernels=[(r["name"], r["ms"], r["calls"])
                              for r in b1_rows],
                  idle_share=prof["idle_share"], top=prof["top"][:8],
                  max_memory_allocated=peak, history=hist,
                  xla_history=xhist, rel_diff_xla=rel_xla,
                  direct_rmse=direct, dense_rows=dense,
                  dense_tflop_per_sweep=dense_tflop_per_sweep(ul, il, R160),
                  gathered_rows_per_epoch=int(ul.padded_slots
                                              + il.padded_slots),
                  launches=launches, latency_launches=latency, routed=routed)
    del fits, U, V, ul, il, m
    _shutil.rmtree(cache, ignore_errors=True)
    torch.cuda.empty_cache()
    # ML-1M at rank 160 against the JAX package's f32 CPU history
    n1u, n1i, n1o = SCALES["ml1m"]
    u1, i1, r1 = synthetic_ratings(n1u, n1i, n1o, rank=16, seed=0)
    R1 = sp.csr_matrix((r1, (u1, i1)), shape=(n1u, n1i))
    U1, V1 = warm_start(n1u, n1i, R160)
    h1 = [float(h) for h in ALS(rank=R160, reg=0.1, n_sweeps=SWEEPS,
                                sse_mode="separate").fit(
        R1, U0=U1, V0=V1).history_]
    rel1 = [abs(a - b) / b for a, b in zip(h1, REF_ML1M_R160)]
    record.update(ml1m_history=h1, ml1m_rel_diff=rel1)
    log(json.dumps({"rank160": record}))
    log(f"# 13d ALS(rank={R160}).fit ML-25M: fit {fit_s:.1f}s (layouts, "
        f"cache write, upload), epoch_seconds={epoch_s:.4f} device_ms/sweep="
        f"{prof['device_ms_per_sweep']} (B1 {b1_ms}) "
        f"idle={prof['idle_share']} peak={peak} dense={dense} "
        f"({record['dense_tflop_per_sweep']:.3f} TFLOP a sweep) B1 "
        f"launches={launches['cholesky_solve_batched']} (latency "
        f"{latency['cholesky_solve_batched']}) routed={routed}; history "
        f"{hist}; rel diff vs xla {rel_xla:.2e}, timed fit {rel_fit:.2e}, "
        f"direct {direct:.6f}; ML-1M rel diff vs JAX CPU max "
        f"{max(rel1):.2e}; {time.perf_counter() - t_phase:.1f}s")
    check(max(rel1) <= HISTORY_RTOL,
          f"the ML-1M rank-160 history differs from the JAX package's: "
          f"{rel1}")
    return launches, record


def phase_rank160_hot(torch, dev, coo):
    """13g: ``ALS(rank=160, hot_cols=16).fit`` on phase 5's ML-25M-shaped
    ratings and the bench's warm start (C = ``hot_cols_cap(160)``; the auto
    policy otherwise), ``R160_HOT_SWEEPS`` sweeps, the launch counts set to
    0 just before and read just after: B2 launched in its panel frame
    (``PANEL_LAUNCHES``, latency launches counted), nothing routed. The
    same fit with ``solver='xla'`` on the same layout cache (history within
    1e-3); on those layouts one timed fit (the epoch, its history within
    1e-3 of the fit's) and B2's and B1's device ms a sweep, from a trace of
    the last of three sweeps that recorded every launch of its sweep (else
    null). Returns (launches, record)."""
    import shutil as _shutil
    import numpy as np
    import scipy.sparse as sp
    from recommendation_models_tpu_torch import ALS
    from recommendation_models_tpu_torch.data.layout import csr_arrays
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import PROFILE_TRIES, SCALES
    from recommendation_models_tpu_torch.probes.epoch_profile import (
        scanned_fits, solve_ms_per_sweep, time_fit, warm_start)
    t_phase = time.perf_counter()
    u, i, r = coo
    n_users, n_items = SCALES["ml25m"][:2]
    nnz = r.shape[0]
    c = ch.hot_cols_cap(R160)
    R = sp.csr_matrix((r, (u, i)), shape=(n_users, n_items))
    U0, V0 = warm_start(n_users, n_items, R160)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke", "r160_hot_layouts")
    _shutil.rmtree(cache, ignore_errors=True)
    os.makedirs(cache)
    prefix = os.path.join(cache, "ml25m")
    kw = dict(rank=R160, reg=0.1, n_sweeps=R160_HOT_SWEEPS, hot_cols=c,
              layout_cache=prefix)
    torch.cuda.synchronize()
    ch.reset_counts()
    t0 = time.perf_counter()
    m = ALS(**kw).fit(R, U0=U0, V0=V0)
    fit_s = time.perf_counter() - t0
    launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
    latency, panel = dict(ch.LATENCY_LAUNCHES), dict(ch.PANEL_LAUNCHES)
    hist = [float(h) for h in m.history_]
    check(len(hist) == R160_HOT_SWEEPS and np.isfinite(m.U_).all()
          and np.isfinite(m.V_).all(),
          "the rank-160 hot fit ran short or is not finite")
    check(panel["cholesky_solve_hot"] > 0,
          f"the rank-160 hot fit did not launch B2 in its panel frame: "
          f"{launches}, panel {panel}, latency {latency}")
    check(not any(routed.values()), f"the rank-160 hot fit routed: {routed}")
    x = ALS(**kw, solver="xla").fit(R, U0=U0, V0=V0)
    xhist = [float(h) for h in x.history_]
    rel_xla = max(abs(a - b) / b for a, b in zip(hist, xhist))
    check(rel_xla <= HISTORY_RTOL,
          f"the rank-160 hot history differs from solver='xla': {rel_xla}")
    del x
    indptr, indices, data, nu, ni = csr_arrays(R)
    ul, il = m._build_layouts(indptr, indices, data, nu, ni,
                              m._data_config())
    # the hot block's width on each side (at ML-25M the user side's: the
    # item side's heavy columns go to its dense block)
    hot = [0 if lay.hot_ids is None else int(lay.hot_ids.shape[0])
           for lay in (ul, il)]
    check(c in hot, f"no hot block {c} wide: {hot}")
    fits = scanned_fits(ul, il, nnz, dev, R160, sweeps=R160_HOT_SWEEPS)
    epoch_s, U, V, sse_h, n_done = time_fit(fits.fit, fits.U0, fits.V0)
    thist = [float(h) for h in np.sqrt(np.maximum(sse_h[:n_done], 0) / nnz)]
    rel_fit = max(abs(a - b) / b for a, b in zip(thist, hist))
    check(n_done == R160_HOT_SWEEPS and rel_fit <= HISTORY_RTOL,
          f"the timed rank-160 hot fit does not reproduce ALS.fit: "
          f"{rel_fit}")
    solves = {}
    for _ in range(PROFILE_TRIES):
        solves = solve_ms_per_sweep(fits.one, U, V)
        if all(v["ms"] is not None for v in solves.values()
               if v["launches"]):
            break
        log(f"# 13g profile: {solves}")
    record = dict(fit_seconds=fit_s, epoch_seconds=epoch_s, hot_cols=c,
                  hot_widths=hot, history=hist, xla_history=xhist,
                  rel_diff_xla=rel_xla,
                  launches=launches, latency_launches=latency,
                  panel_launches=panel, routed=routed,
                  solve_device_ms_per_sweep=solves)
    del fits, U, V, ul, il, m
    _shutil.rmtree(cache, ignore_errors=True)
    torch.cuda.empty_cache()
    log(json.dumps({"rank160_hot": record}))
    b2 = solves.get("cholesky_solve_hot", {})
    log(f"# 13g ALS(rank={R160}, hot_cols={c}).fit ML-25M: fit {fit_s:.1f}s "
        f"(layouts, cache write, upload), epoch_seconds={epoch_s:.4f}, B2 "
        f"device_ms/sweep={b2.get('ms')} in {b2.get('launches')} launches "
        f"(B1 {solves.get('cholesky_solve_batched')}); B2 launches="
        f"{launches['cholesky_solve_hot']} (latency "
        f"{latency['cholesky_solve_hot']}, panel "
        f"{panel['cholesky_solve_hot']}) routed={routed}; history {hist}; "
        f"rel diff vs xla {rel_xla:.2e}, timed fit {rel_fit:.2e}; "
        f"{time.perf_counter() - t_phase:.1f}s")
    return launches, record


def phase_quality(torch, dev, children):
    """13e: the ALS quality probe at its three seeds (the oracle on the
    host, ``ALS`` on the card), then the IMC probe at the seeds whose oracle
    the child processes fitted (the estimator on the card), each held to its
    gate. Returns (ALS line, IMC line)."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import quality_parity as qp
    from recommendation_models_tpu_torch.probes import quality_parity_imc as qi
    t0 = time.perf_counter()
    ch.reset_counts()
    out = qp.run(qp.SEEDS)
    launches = dict(ch.LAUNCHES)
    bad = qp.check(out)
    line = dict(qp.rounded(out), unrounded=out, launches=launches)
    log(f"# 13e ALS quality parity ({len(qp.SEEDS)} seeds, "
        f"{time.perf_counter() - t0:.1f}s): {json.dumps(qp.rounded(out))} "
        f"launches={launches}")
    check(not bad, f"ALS quality parity failed: {bad}")
    check(launches["cholesky_solve_batched"] > 0,
          "the quality fits launched no solve kernel")
    t1 = time.perf_counter()
    oracles = {}
    for seed, proc, path in children:
        try:
            proc.wait(timeout=max(1, QP_TIMEOUT - (time.perf_counter() - t1)))
        except subprocess.TimeoutExpired:
            stop_children(children)
            raise Failed(f"the IMC oracle of seed {seed} ran past "
                         f"{QP_TIMEOUT}s")
        if proc.returncode != 0:
            with open(path + ".err") as err:
                raise Failed(f"the IMC oracle of seed {seed} failed: "
                             f"{err.read()[-2000:]}")
        oracles.update(qi.load_oracles(path))
    log(f"# 13e IMC oracles: waited {time.perf_counter() - t1:.1f}s")
    imc = qi.run(sorted(oracles), oracles=oracles)
    # the first sweep against the JAX package's f32 history (at ML-1M both
    # packages' f32 first sweeps are 4.8% off the f64 oracle's; see the
    # probe), every later one against the oracle's
    bad = qi.check(imc, qi.JAX_HISTORY)
    imc_line = qi.rounded(imc)
    log(f"# 13e IMC quality parity ({len(oracles)} seeds): "
        f"{json.dumps(imc_line)}; {time.perf_counter() - t0:.1f}s")
    check(not bad, f"IMC quality parity failed: {bad}")
    return line, imc_line


# --------------------------------- phase 13f: the variants past k = 128

VARIANT_WIDE_KS = (136, 157, 160)       # past the old k = 128 cap, any batch
# B4 and B5c also at orders whose last panel is four columns wide
VARIANT_NARROW_KS = (129, 153)
VARIANT_NARROW_KINDS = ("cholesky_solve_rank1", "cholesky_solve_dual")
VARIANT_WIDE_BATCHES = (1, 37, 4_096)
VARIANT_ONE_BLOCK_KS = (161, 168, 256, 512, 656)
VARIANT_TIMED_KS = (136, 160)           # at WIDE_BATCHES' 256 and 65,536 rows
VARIANT_TIMED_ONE_BLOCK = (168, 256, 512, 656)   # at block_batch(k)
VARIANT_ZERO_KS = (160, 656)            # zero / identity, each kernel
# the variant probe's runs: (PSV_K, PSV_B; None: the probe's default, the
# one-block batch past k = 160)
VARIANT_PROBES = ((160, 8_192), (656, None))
VARIANT_REPORTED = {"cholesky_solve_rank1": "fcols=1,srows=1",
                    "cholesky_solve_schur": "srows=2"}
LARGE_VARIANT_SOURCE = _CSRC + "cholesky_large_variants.cu"


def variant_instantiations(ch):
    """(label, wrapper name, kernel call, plain call) of each instantiation
    of B4-B5c, the calls of (G, rhs, reg)."""
    out = [(f"fcols={f},srows={s}", "cholesky_solve_rank1",
            lambda G, r, g, f=f, s=s: ch.cholesky_solve_rank1(G, r, g, f, s),
            lambda G, r, g, f=f, s=s: ch.cholesky_solve_rank1_plain(
                G, r, g, f, s)) for f, s in ch.RANK1_SCHEDULES]
    out.append(("", "cholesky_solve_panel", ch.cholesky_solve_panel,
                ch.cholesky_solve_panel_plain))
    out += [(f"srows={s}", "cholesky_solve_schur",
             lambda G, r, g, s=s: ch.cholesky_solve_schur(G, r, g, s),
             lambda G, r, g, s=s: ch.cholesky_solve_schur_plain(G, r, g, s))
            for s in (1, 2)]
    out.append(("", "cholesky_solve_dual", ch.cholesky_solve_dual,
                ch.cholesky_solve_dual_plain))
    return out


def variant_orders(name, ks):
    """The orders of ``ks`` a variant runs at: Schur (k % 16 == 0) takes
    each order's next multiple of 16; B4 and B5c add ``VARIANT_NARROW_KS``
    where ``ks`` holds ``VARIANT_WIDE_KS``."""
    if name in VARIANT_NARROW_KINDS and set(VARIANT_WIDE_KS) <= set(ks):
        ks = tuple(sorted(set(ks) | set(VARIANT_NARROW_KS)))
    if name != "cholesky_solve_schur":
        return tuple(ks)
    return tuple(sorted({-(-k // 16) * 16 for k in ks}))


def variant_batches(name, k, ch):
    """The checked batches: 1, 37 and 4,096 to k = 160 (dual also 2 and
    4,097: odd, past one wave); past it 1 and ``block_batch(k)`` (dual also
    3 and ``block_batch(k) - 1``: an odd pair count)."""
    if k <= ch.VARIANT_KMAX:
        extra = (2, 4_097) if name == "cholesky_solve_dual" else ()
        return tuple(sorted(VARIANT_WIDE_BATCHES + extra))
    bb = ch.block_batch(k)
    extra = (3, bb - 1) if name == "cholesky_solve_dual" else ()
    return tuple(sorted((1, bb) + extra))


def variant_blocks_per_sm(torch, dev, ch, name, label, k):
    """Resident blocks an SM of the instantiation ``label`` of ``name``
    at order k <= 160 (``variant_resident`` over the SM count)."""
    kw = dict(kv.split("=") for kv in label.split(",")) if label else {}
    res = ch.variant_resident(name, k, int(kw.get("fcols", 1)),
                              int(kw.get("srows", 1)))
    return res / torch.cuda.get_device_properties(dev).multi_processor_count


def solve_library(torch, G, rhs, reg):
    """The library's solve of the same systems: ``torch.linalg.cholesky``
    and ``cholesky_solve`` on G + diag(reg)."""
    eye = torch.eye(G.shape[1], device=G.device)
    return torch.cholesky_solve(rhs[:, :, None], torch.linalg.cholesky(
        G + reg[:, None, None] * eye))


def phase_variant_range(torch, dev):
    """13f: B4 (three instantiations), B5a, B5b (srows 1 and 2) and B5c over
    the reference's Pallas range. (1) Each instantiation at k = 136, 157,
    160 (B4 and B5c also 129 and 153; Schur 144, 160) and B = 1, 37, 4,096
    (dual also 2 and 4,097), then at the
    one-block orders k = 161, 168, 256, 512, 656 (Schur 176, 256, 512, 656)
    at B = 1 and ``block_batch(k)`` (dual also 3 and ``block_batch(k) -
    1``): against its plain version, repeated bitwise, with the launch
    and route counts equal to what ``kernel_supported`` predicts (the
    one-block kernel, ``LARGE_LAUNCHES``, past k = 160; nothing routed);
    zero and identity systems exactly 0 at k = 160 and 656; past kp = 128
    B4's three forms and B5c bitwise equal, and B5b's two srows (the panel
    frame in Schur's order); a batch one past
    the block at k = 168 (Schur 176) routed and counted; ``block_batch(k)``
    systems there past one wave of clusters (``multiwave_cluster``),
    bitwise equal to the rule's launch. (2) Times: at k =
    136 and 160 (Schur 144, 160) at 256 and 65,536 rows, device ms
    (profiler), event ms, host µs and plain ms (256 rows), the library's
    device ms and the bound, with the kernel's frame and blocks an SM; at
    k = 168 (Schur 176), 256, 512, 656 and
    ``block_batch(k)``, event and device ms, host µs, plain ms, the library
    and the bound. (3) The variant probe at PSV_K = 160 (8,192 systems)
    and 656 (its one-block default) with every variant, the counts set to 0
    just before each run and read just after: nothing routed, every
    variant kernel launched (past k = 160 through its one-block kernel).
    Returns ({kernel: numbers}, {kernel: {path: launches}})."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import host_us
    from recommendation_models_tpu_torch.probes import solve_variants
    from recommendation_models_tpu_torch.probes.solve_latency import (
        random_systems)
    t0 = time.perf_counter()
    insts = variant_instantiations(ch)
    out = {n: dict(wide_orders={}, by_order={}, max_abs_err=0.0)
           for n in ch.VARIANT_KINDS}

    def checked(label, name, fn, plain, args):
        b, k = args[0].shape[:2]
        ch.reset_counts()
        x = fn(*args)
        large = k > ch.VARIANT_KMAX
        routed = not ch.kernel_supported(k, b)
        what = f"{name} {label} k={k} B={b}"
        check(ch.LAUNCHES[name] == (not routed)
              and ch.LARGE_LAUNCHES[name] == (large and not routed)
              and ch.ROUTED[name] == routed
              and sum(ch.LAUNCHES.values()) + sum(ch.ROUTED.values()) == 1,
              f"{what}: launches {ch.LAUNCHES} one-block "
              f"{ch.LARGE_LAUNCHES} routed {ch.ROUTED}, not the rule's")
        err, ok = compare(torch, x, plain(*args))
        check(ok, f"{what} disagrees with its plain version ({err:.3e})")
        if not routed:
            check(torch.equal(x, fn(*args)),
                  f"{what} is not bitwise repeatable")
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        return err

    # (1) every instantiation at every order, against its plain version
    ks = sorted({k for _, n, _, _ in insts for k in variant_orders(
        n, VARIANT_WIDE_KS + VARIANT_ONE_BLOCK_KS)})
    n_checked = 0
    for k in ks:
        n = max(b for _, name, _, _ in insts
                for b in variant_batches(name, k, ch))
        gen = torch.Generator(device=dev).manual_seed(1000 + k)
        G, rhs, reg = random_systems(n, k, 3 * k // 4, gen, dev)
        for label, name, fn, plain in insts:
            if k not in variant_orders(
                    name, VARIANT_WIDE_KS + VARIANT_ONE_BLOCK_KS):
                continue
            for b in variant_batches(name, k, ch):
                checked(label, name, fn, plain,
                        (G[:b].contiguous(), rhs[:b].contiguous(),
                         reg[:b].contiguous()))
                n_checked += 1
            if k in VARIANT_ZERO_KS:
                nz = 9 if k <= ch.VARIANT_KMAX else 5
                Gz = torch.zeros(nz, k, k, device=dev)
                Gz[nz // 2:] = torch.eye(k, device=dev)
                z = fn(Gz, torch.zeros(nz, k, device=dev),
                       torch.zeros(nz, device=dev))
                check(bool((z == 0).all()),
                      f"zero / identity systems did not solve to 0 in "
                      f"{name} {label} at k={k}")
        if (k <= ch.VARIANT_KMAX
                and ch.variant_frame(VARIANT_NARROW_KINDS[0], k) == "panel"):
            # in the panel frame B4's three forms and B5c give each element
            # its terms in one order: one result, bit for bit
            xs = [fn(G, rhs, reg) for _, name, fn, _ in insts
                  if name in VARIANT_NARROW_KINDS]
            check(all(torch.equal(xs[0], x) for x in xs[1:]),
                  f"B4's forms and B5c differ bitwise at k={k}")
        if (k <= ch.VARIANT_KMAX and k % 16 == 0
                and ch.variant_frame("cholesky_solve_schur", k) == "panel"):
            # B5b in the panel frame: a two-row round's arithmetic is two
            # one-row rounds', so both srows give one result
            xs = [ch.cholesky_solve_schur(G, rhs, reg, s) for s in (1, 2)]
            check(torch.equal(*xs), f"B5b's srows differ bitwise at k={k}")
        del G, rhs, reg
    for label, name, fn, plain in insts:
        k = variant_orders(name, (168,))[0]
        b = ch.block_batch(k) + 1
        gen = torch.Generator(device=dev).manual_seed(7)
        checked(label, name, fn, plain, random_systems(b, k, 3 * k // 4,
                                                       gen, dev))
    # block_batch(k) systems past one wave of clusters (13b's case), each
    # instantiation bitwise equal to its launch on the rule's cluster
    for label, name, fn, plain in insts:
        k = variant_orders(name, (MULTIWAVE_K,))[0]
        b = ch.block_batch(k)
        gen = torch.Generator(device=dev).manual_seed(11)
        args = random_systems(b, k, 3 * k // 4, gen, dev)
        x = fn(*args)
        c = ch.multiwave_cluster(k, b)
        with ch.forced_cluster(c):
            checked(f"{label} C={c}".strip(), name, fn, plain, args)
            check(torch.equal(fn(*args), x),
                  f"{name} {label} k={k} B={b} on {c} CTAs a system is not "
                  f"bitwise its launch on {ch.cluster_size(k, b)}")
        out[name]["multiwave"] = dict(k=k, batch=b, cluster=c)
        n_checked += 1
    log(f"# 13f checks: {n_checked} shapes and the routed batch of each "
        f"instantiation in {time.perf_counter() - t0:.1f}s; max_abs_err "
        + ", ".join(f"{n} {v['max_abs_err']:.3e}" for n, v in out.items()))

    def record(where, name, label, nums):
        entry = where.setdefault("instantiations", {})
        if label:
            entry[label] = nums["ms"]
        else:
            del where["instantiations"]
        if VARIANT_REPORTED.get(name, label) == label:
            where.update(nums)

    # (2) times
    t1 = time.perf_counter()
    for k in sorted({k for n in ch.VARIANT_KINDS
                     for k in variant_orders(n, VARIANT_TIMED_KS)}):
        gen = torch.Generator(device=dev).manual_seed(k)
        n = max(WIDE_BATCHES)
        G, rhs, reg = random_systems(n, k, 3 * k // 4, gen, dev)
        for label, name, fn, plain in insts:
            if k not in variant_orders(name, VARIANT_TIMED_KS):
                continue
            for b in WIDE_BATCHES:
                args = (G[:b].contiguous(), rhs[:b].contiguous(),
                        reg[:b].contiguous())
                small = b == min(WIDE_BATCHES)
                nums = wide_numbers(torch, lambda: fn(*args),
                                    lambda: solve_library(torch, *args), b,
                                    timed_host=small)
                err, _ = compare(torch, fn(*args), plain(*args))
                nums["plain_ms"] = (time_ms(torch, lambda: plain(*args), 1,
                                            warm=1) if small else None)
                bound_ms, bound_by = bound(solve_bytes(b, k),
                                           solve_flops(b, k))
                nums.update(max_abs_err=err, bound_ms=bound_ms,
                            bound_by=bound_by,
                            frame=ch.variant_frame(name, k),
                            blocks_per_sm=variant_blocks_per_sm(
                                torch, dev, ch, name, label, k))
                record(out[name]["wide_orders"].setdefault(
                    str(k), {}).setdefault(str(b), {}), name, label, nums)
                log(f"# 13f {' '.join(filter(None, (name, label)))} k={k} "
                    f"B={b} ({nums['frame']} frame, "
                    f"{nums['blocks_per_sm']:g} blocks an SM): "
                    f"max_abs_err={err:.3e} device_ms="
                    f"{nums['device_ms']} ms={nums['ms']:.5f} host_us="
                    f"{nums['host_us']} plain_ms={nums['plain_ms']} "
                    f"library_device_ms={nums['library_device_ms']} "
                    f"bound_ms={bound_ms:.5f} ({bound_by})")
        del G, rhs, reg
        torch.cuda.empty_cache()
    for k in sorted({k for n in ch.VARIANT_KINDS
                     for k in variant_orders(n, VARIANT_TIMED_ONE_BLOCK)}):
        b = ch.block_batch(k)
        gen = torch.Generator(device=dev).manual_seed(k)
        args = random_systems(b, k, 3 * k // 4, gen, dev)
        for label, name, fn, plain in insts:
            if k not in variant_orders(name, VARIANT_TIMED_ONE_BLOCK):
                continue
            x = fn(*args)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            ref = plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t2) * 1e3
            err, _ = compare(torch, x, ref)
            bound_ms, bound_by = bound(solve_bytes(b, k), solve_flops(b, k))
            nums = dict(ms=time_ms(torch, lambda: fn(*args), 10),
                        device_ms=profiled_or_none(lambda: fn(*args), 10),
                        host_us=host_us(lambda: fn(*args)),
                        library_ms=time_ms(
                            torch, lambda: solve_library(torch, *args), 5),
                        plain_ms=plain_ms, max_abs_err=err,
                        bound_ms=bound_ms, bound_by=bound_by,
                        cluster=ch.cluster_size(k, b))
            record(out[name]["by_order"].setdefault(str(k), {}).setdefault(
                f"g_{b}", {}), name, label, nums)
            log(f"# 13f {' '.join(filter(None, (name, label)))} k={k} "
                f"B={b} C={nums['cluster']}: max_abs_err={err:.3e} "
                f"ms={nums['ms']:.4f} "
                f"device_ms={nums['device_ms']} host_us="
                f"{nums['host_us']:.1f} plain_ms={plain_ms:.1f} library_ms="
                f"{nums['library_ms']:.4f} bound_ms={bound_ms:.5f} "
                f"({bound_by})")
        del args
    log(f"# 13f times: {time.perf_counter() - t1:.1f}s")

    # (3) the variant probe on the card, counted
    by_path = {n: {} for n in ch.VARIANT_KINDS}
    for k, b in VARIANT_PROBES:
        env = dict(PSV_K=str(k), PSV_ITERS="3", PSV_VARIANTS=PROBE_VARIANTS)
        if b:
            env["PSV_B"] = str(b)
        torch.cuda.synchronize()
        ch.reset_counts()
        rc = solve_variants.main(["--platform", "cuda"], env=env)
        torch.cuda.synchronize()
        launches, routed = dict(ch.LAUNCHES), dict(ch.ROUTED)
        large = dict(ch.LARGE_LAUNCHES)
        log(f"# 13f probe PSV_K={k} PSV_B={b or ch.block_batch(k)}: rc={rc} "
            f"launches={launches} one-block={large} routed={routed}")
        check(rc == 0, f"the variant probe failed at PSV_K={k}")
        check(not any(routed.values()),
              f"the variant probe at PSV_K={k} routed calls: {routed}")
        for n in ch.VARIANT_KINDS:
            check(launches[n] > 0 and (large[n] == launches[n]
                                       if k > ch.VARIANT_KMAX
                                       else large[n] == 0),
                  f"the variant probe at PSV_K={k} did not launch {n}'s "
                  f"kernel: {launches} {large}")
            by_path[n][f"probe_k{k}"] = launches[n]
    log(f"# 13f: {time.perf_counter() - t0:.1f}s")
    return out, by_path


# ------------------------------------- phase 14: the scripts' probes and
# the examples (the JAX package's last six scripts and its four examples)

SCAN_SCALE, SCAN_SWEEPS = "ml1m", 10
SCAN_WINDOWS = 5             # timed windows a side, alternating
SQ_SCALE, SQ_SWEEPS, SQ_SEEDS = "ml1m", 8, (0, 1, 2)
SQ_FROZEN_BAND = 5e-4        # the model path against the frozen path
SQ_REF_BAND = 0.005          # against the JAX package, as phase 6's band
# recall@10 and NDCG@10 of the JAX package's scripts/serving_quality_probe.py
# at ML-1M (its 1,000,000 ratings), rank 64, 8 sweeps, on a CPU, by seed:
#   JAX_PLATFORMS=cpu SEED=<seed> SCALE=ml1m RANK=64 \
#       python scripts/serving_quality_probe.py
# (seed 0 is also docs/measurements/r5/serving_probe_head_cpu_ml1m.txt:1)
REF_SERVING_SEEDS_ML1M = {0: (0.18783, 0.12502), 1: (0.18891, 0.12533),
                          2: (0.18891, 0.12745)}
SPLIT_GATHER_RTOL = 1e-4     # the split pass's sum against the baseline's
EXAMPLES = ("als_quickstart", "imc_cold_start", "serving_quality",
            "als_implicit_sharded")
EXAMPLE_TIMEOUT = 300


def phase_layout_probes(torch, dev, ul, il):
    """14d and 14f, on phase 5's ML-25M layouts at rank 64: ``profile_half``
    on each side (the table beside the CUDA-event time; B2 launched in
    the user half, B1 in the item half, nothing routed) and
    ``ablate_gram_layout`` on the user side (both layouts' sums equal,
    their times and ``aten::copy_`` events)."""
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.probes import (
        ablate_gram_layout, profile_half)
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    prof_dir = os.path.join(root, "build", "chip_smoke", "profile_half")
    # the main path's solves by half: the user buckets all carry hot
    # columns (B2); the item half has the dense block and no hot columns
    for side, lay, n_opp, kinds in (
            ("user", ul, il.n_rows, ("cholesky_solve_hot",)),
            ("item", il, ul.n_rows, ("cholesky_solve_batched",))):
        rec = profile_half.run(lay, side, n_opp, RANK, dev, prof_dir)
        routed = {n: v for n, v in ch.ROUTED.items() if v}
        log(f"# 14d profile_half {side}: table {rec['total_ms']:.3f} device "
            f"ms against {rec['event_ms']:.3f} event ms (share "
            f"{rec['table_share']:.3f}, flagged {rec['flagged']}); solve "
            f"launches {rec['solve_launches']} recorded "
            f"{rec['solve_recorded']}; routed {routed}; lanes "
            f"{[(x['lane'], round(x['ms'], 3)) for x in rec['lanes']]}")
        check(rec["total_ms"] > 0 and rec["event_ms"] > 0,
              f"14d: no device time for the {side} half-sweep")
        check(all(rec["solve_launches"].get(n, 0) > 0 for n in kinds)
              and not routed,
              f"14d: the {side} half-sweep did not launch {kinds}: "
              f"{rec['solve_launches']} routed {routed}")
    rec = ablate_gram_layout.run(ul, "user", il.n_rows, RANK, ABL_ITERS, dev)
    log(f"# 14f ablate_gram_layout user: {json.dumps(rec)}")
    check(rec["klb"]["sum"] == rec["bkl"]["sum"]
          and rec["klb"]["ms"] > 0 and rec["bkl"]["ms"] > 0,
          f"14f: the two gram layouts disagree or were not timed: {rec}")
    log(f"# 14d + 14f: {time.perf_counter() - t0:.1f}s")


def start_examples(torch):
    """14g: the port's four examples (``examples/torch_port/``) started at
    once in subprocesses on the card (no ``--platform``), their temporary
    files under ``build/chip_smoke/``: [(name, process, log path)]."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", "chip_smoke", "examples")
    os.makedirs(os.path.join(out, "tmp"), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=root, TMPDIR=os.path.join(out, "tmp"))
    procs = []
    for name in EXAMPLES:
        path = os.path.join(out, f"{name}.log")
        with open(path, "w") as f:
            procs.append((name, subprocess.Popen(
                [sys.executable, os.path.join(root, "examples", "torch_port",
                                              f"{name}.py")],
                cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT),
                path))
    return procs


def finish_examples(procs, t0):
    """Waits for ``start_examples``' processes (each killed past
    ``EXAMPLE_TIMEOUT`` s from ``t0``); each must exit 0."""
    for name, proc, path in procs:
        try:
            rc = proc.wait(timeout=max(1.0, EXAMPLE_TIMEOUT
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the time limit"
        with open(path) as f:
            text = f.read()
        tail = " | ".join(text.strip().splitlines()[-3:])
        log(f"# 14g example {name}: exit {rc}; {tail[:600]}")
        check(rc == 0, f"14g: the example {name} exited {rc}: {text[-3000:]}")
    log(f"# 14g: the four examples in {time.perf_counter() - t0:.1f}s")


def phase_probes(torch, dev):
    """14a, 14b, 14c, 14e and 14g. The examples (14g) run in subprocesses
    beside the untimed 14b and 14c; 14a and 14e, which time, run after
    them. Returns the sharded hot smoke's launches."""
    import numpy as np
    from recommendation_models_tpu_torch.data.synthetic import (
        synthetic_ratings)
    from recommendation_models_tpu_torch.probes import SCALES
    from recommendation_models_tpu_torch.probes import serving_quality as sq
    from recommendation_models_tpu_torch.probes import (
        sharded_hot, sharded_scan, split_gather)
    t_phase = time.perf_counter()
    procs = start_examples(torch)
    try:
        # 14b: the sharded hot smoke, counted
        t0 = time.perf_counter()
        try:
            hot = sharded_hot.run()
        except AssertionError as exc:
            raise Failed(f"14b: the sharded hot smoke failed: {exc}")
        log(f"# 14b sharded hot smoke: {json.dumps(hot)}; "
            f"{time.perf_counter() - t0:.1f}s")
        check(hot["launches"]["cholesky_solve_hot"] > 0 and not hot["routed"],
              f"14b: B2 not launched or calls routed: {hot}")
        hot_launches = dict(hot["launches"])

        # 14c: serving quality at three seeds, and an NPZ round trip
        t0 = time.perf_counter()
        data = sq.serving_data(SQ_SCALE)
        npz = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke", "serving_quality_seed0.npz")
        recs = {}
        for seed in SQ_SEEDS:
            rec = sq.run(SQ_SCALE, RANK, SQ_SWEEPS, seed, data=data,
                         npz_out=npz if seed == 0 else None)
            recs[seed] = rec
            log(f"# 14c serving quality seed {seed}: {json.dumps(rec)}")
            check(rec["platform"] == "cuda", f"14c: not on the card: {rec}")
            for m, want in zip(("recall", "ndcg"),
                               REF_SERVING_SEEDS_ML1M[seed]):
                got = rec[f"{m}_model_path"]
                check(abs(got - rec[f"{m}_frozen_path"]) <= SQ_FROZEN_BAND,
                      f"14c seed {seed}: the model path's {m} {got} is not "
                      f"within {SQ_FROZEN_BAND} of the frozen path's")
                check(abs(got - want) <= SQ_REF_BAND,
                      f"14c seed {seed}: {m} {got} is not within "
                      f"{SQ_REF_BAND} of the JAX package's {want}")
        again = sq.run(SQ_SCALE, RANK, SQ_SWEEPS, 0, npz_in=npz, data=data)
        log(f"# 14c NPZ_OUT -> NPZ_IN seed 0: {json.dumps(again)}")
        check(again == {**recs[0], "fit": "loaded"},
              f"14c: the NPZ round trip changed the record: {again}")
        log(f"# 14c: {time.perf_counter() - t0:.1f}s")
    finally:
        finish_examples(procs, t_phase)

    # 14a: the sharded scan, stepwise against scanned, both layouts
    t0 = time.perf_counter()
    coo = synthetic_ratings(*SCALES[SCAN_SCALE], rank=16, seed=0)
    for fastpaths in (False, True):
        try:
            rec = sharded_scan.run(SCAN_SCALE, RANK, SCAN_SWEEPS, 1,
                                   fastpaths, coo=coo, windows=SCAN_WINDOWS,
                                   counts=False)
        except AssertionError as exc:
            raise Failed(f"14a: stepwise and scanned histories disagree "
                         f"(FASTPATHS={int(fastpaths)}): {exc}")
        log(f"# 14a sharded scan FASTPATHS={int(fastpaths)}: "
            f"{json.dumps(rec)}")
        check(all(s > 0 for side in rec["windows_s"].values() for s in side)
              and all(np.isfinite(rec["history_scanned"])),
              f"14a: no time measured or a history not finite: {rec}")
    del coo
    log(f"# 14a: {time.perf_counter() - t0:.1f}s")

    # 14e: the split gather at bf16 and f32
    t0 = time.perf_counter()
    for dtype in ("bfloat16", "float32"):
        rec = split_gather.run(dtype)
        log(f"# 14e split gather {dtype}: {json.dumps(rec)}")
        lines = [rec[k] for k in ("baseline", "split", "reference")]
        check(all(x["ms_per_pass"] > 0 and np.isfinite(x["sum"])
                  for x in lines),
              f"14e: a line was not timed or is not finite: {rec}")
        check(abs(rec["split"]["sum"] - rec["baseline"]["sum"])
              <= SPLIT_GATHER_RTOL * abs(rec["baseline"]["sum"]),
              f"14e: the split pass's sum is not the baseline's: {rec}")
        torch.cuda.empty_cache()
    log(f"# 14e: {time.perf_counter() - t0:.1f}s")
    log(f"# 14a-c, e, g: {time.perf_counter() - t_phase:.1f}s")
    return hot_launches


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import recommendation_models_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    from recommendation_models_tpu_torch.ops import cholesky as ch
    from recommendation_models_tpu_torch.ops.gram import full_f32
    dev = torch.device("cuda")
    full_f32()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    t_start = time.perf_counter()
    card = phase_environment(torch)
    coo, ul, il = build_main_path_data()
    results = {"cholesky_solve_batched": phase_b1(
        torch, dev, flat_w=il.dense_ids.shape[0])}
    results["cholesky_solve_hot"] = phase_b2(
        torch, dev, hot_slab_sample(torch, ul, 65_536, dev))
    torch.cuda.empty_cache()
    systems = variant_systems(torch, dev)
    results.update(phase_variants(torch, dev, *systems))
    launches = phase_variant_path(torch, dev, *systems)
    del systems
    torch.cuda.empty_cache()
    at_probe = phase_probe_shape(torch, dev)
    torch.cuda.empty_cache()
    results["gather_rows_sum"] = phase_gather(torch, dev, ul, il)
    torch.cuda.empty_cache()
    launches["gather_rows_sum"] = phase_gather_path(torch, dev, ul, il)
    torch.cuda.empty_cache()
    phase_ml1m(torch, dev)
    main_launches, hist = phase_main_path(torch, coo)
    launches.update({n: main_launches[n] for n in MAIN_KERNELS})
    by_path = {n: {"main": main_launches[n]} for n in MAIN_KERNELS}
    torch.cuda.empty_cache()
    epoch_s = phase_epoch(torch, dev, coo[2].shape[0], ul, il, hist,
                          profile="--profile" in argv)
    torch.cuda.empty_cache()
    phase_serving(torch, coo)
    torch.cuda.empty_cache()
    imc = phase_imc(torch, dev)
    torch.cuda.empty_cache()
    phase_cli(torch, coo, card)
    torch.cuda.empty_cache()
    sharded_launches, sharded_sweep_s = phase_sharded(torch, dev, coo, ul, il,
                                                      hist, epoch_s)
    for n in MAIN_KERNELS:
        by_path[n]["sharded"] = sharded_launches[n]
        launches[n] += sharded_launches[n]
    torch.cuda.empty_cache()
    hybrid_launches = phase_hybrid(torch, dev, coo, hist, epoch_s, imc)
    by_path["cholesky_solve_batched"]["hybrid_2d"] = hybrid_launches[
        "cholesky_solve_batched"]
    launches["cholesky_solve_batched"] += hybrid_launches[
        "cholesky_solve_batched"]
    torch.cuda.empty_cache()
    cli_hist = [x["train_rmse"] for x in read_jsonl(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke",
        "ml25m.jsonl"))[:-1]]
    # phase 12's synth-100M ratings and layouts are made in a child
    # process on the host beside phase 11, whose own processes leave cores
    # idle
    synth = start_synth_data()
    children = [(None, synth[0], synth[1])]
    try:
        mp_launches = phase_multiprocess(torch, dev, coo, cli_hist,
                                         sharded_sweep_s, imc)
        for n in MAIN_KERNELS:
            by_path[n]["multiprocess"] = mp_launches[n]
            launches[n] += mp_launches[n]
        torch.cuda.empty_cache()
        t14 = time.perf_counter()
        phase_layout_probes(torch, dev, ul, il)
        t14 = time.perf_counter() - t14
        torch.cuda.empty_cache()
        main_data = [coo, ul, il]
        del ul, il          # phase 13 keeps the ratings (about 400 MB)
        # phase 13's IMC quality probe: its oracle fits (host only, one
        # core each, about 150 s) run in child processes beside phases 12
        # and 13
        oracles = start_imc_oracles()
        children += oracles
        for line, counts in phase_bench(torch, dev, main_data,
                                        synth).items():
            for n in MAIN_KERNELS:
                by_path[n][line] = counts[n]
                launches[n] += counts[n]
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        wide, b3_entry = phase_wide_kernels(torch, dev)
        by_order = phase_large_kernel(torch, dev)
        results["cholesky_solve_large"] = large = dict(
            multiwave=by_order.pop("multiwave"), by_order=by_order)
        launches["cholesky_solve_large"] = phase_large_path(
            torch, dev)["cholesky_solve_large"]
        torch.cuda.empty_cache()
        phase_fuzz(torch, dev)
        torch.cuda.empty_cache()
        r160_launches, _ = phase_rank160(torch, dev, coo)
        by_path["cholesky_solve_batched"]["rank160"] = r160_launches[
            "cholesky_solve_batched"]
        launches["cholesky_solve_batched"] += r160_launches[
            "cholesky_solve_batched"]
        torch.cuda.empty_cache()
        hot_launches, _ = phase_rank160_hot(torch, dev, coo)
        del coo
        for n in MAIN_KERNELS:
            by_path[n]["rank160_hot"] = hot_launches[n]
            launches[n] += hot_launches[n]
        torch.cuda.empty_cache()
        phase_quality(torch, dev, oracles)
    finally:
        stop_children(children)
    torch.cuda.empty_cache()
    by_path["cholesky_solve_2g"] = {"solve_spd_t_k64": launches[
        "cholesky_solve_2g"], "solve_spd_t_k160": b3_entry}
    launches["cholesky_solve_2g"] += b3_entry
    variant_range, variant_paths = phase_variant_range(torch, dev)
    for n, r in variant_range.items():
        results[n]["max_abs_err_all"] = max(results[n]["max_abs_err"],
                                            r.pop("max_abs_err"))
        results[n].update(r, large_source=LARGE_VARIANT_SOURCE)
        by_path[n] = {"probe_k128": launches[n], **variant_paths[n]}
        launches[n] += sum(variant_paths[n].values())
    log(f"# phase 13: {time.perf_counter() - t13:.1f}s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hot_launches = phase_probes(torch, dev)
    for n in MAIN_KERNELS:
        by_path[n]["sharded_hot"] = hot_launches[n]
        launches[n] += hot_launches[n]
    log(f"# phase 14: {t14 + time.perf_counter() - t0:.1f}s")
    head = large["by_order"][str(max(LARGE_KS))][
        f"g_{ch.block_batch(max(LARGE_KS))}"]
    large.update({f: head[f] for f in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "cluster")},
                 k=max(LARGE_KS), batch=ch.block_batch(max(LARGE_KS)),
                 max_abs_err_all=max(v["max_abs_err"] for o in
                                     large["by_order"].values()
                                     for v in o.values()))
    kernels = []
    for name in TPU_KERNEL:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "path": PATH[name],
            "launches": launches[name],
            **({"launches_by_path": by_path[name]} if name in by_path
               else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "k": r["k"], "batch": r["batch"],
            **({"exports": EXPORTS[name]} if name in EXPORTS else {}),
            **{f: r[f] for f in ("resident", "resident_by_instantiation",
                                 "regime_by_batch", "by_batch") if f in r},
            **({"instantiations": r["instantiations"]}
               if "instantiations" in r else {}),
            **({"at_probe_shape": at_probe[name]} if name in at_probe
               else {}),
            **{f: r[f] for f in ("device_ms", "host_us", "l2_bound_ms",
                                 "l2_tb_s", "at_main_path", "at_row_block",
                                 "large_source", "wide_orders", "by_order",
                                 "multiwave", "max_abs_err_all")
               if f in r},
            **({"wide_orders": wide[name]} if name in wide else {})})
    check(all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    log(f"# total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
