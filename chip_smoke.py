#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero and prints no result):

1. Build the CUDA kernels from ``neural_ode_features_tpu_torch/csrc``, one
   ``nvcc`` per source, all at once.
2. Hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (B = 256 for inference, B = 128 for training,
   7×7×64, and B = 64 for one rank's rows of ``[parallel]``'s batch), the
   fused step and the backward kernel also at a ragged B = 5;
   the fused step takes its tolerances as ``(B,)`` arrays, checked at mixed
   values against the plain version and, row by row, bit-identical to
   launches at one float.  The ODEfunc kernel and the fused step (at the
   sweep's four tolerances, a quarter of the rows each) also at the other
   shapes the paths below give them: 1,024 stacked rows of 7×7×64 (the
   fused sweep's launch) and the MNIST block's 6×6×64 at B = 128, 256 and
   1,024; the backward kernel at 7×7×64 also at B = 16 (the event
   adjoint's) and 1, and at 6×6×64, B = 128 (``[examples]`` adds its
   B = 64).  At these shapes the f32 backward's per-sample pass is the
   two-CTA cluster (``kernels.odefunc_bwd.sample_pass``); each check reads
   which pass one call launches from the call captured into a CUDA graph.
   The backward kernel is held against its plain version in float64 (the
   f32 plain version's cuDNN weight gradients are less exact than the
   kernel), its f output against the ODEfunc kernel's; two backward
   launches must give bit-identical dθ.  Both builds' weight gradients
   (the tensor-core weight-gradient kernel) are held against
   ``weight_grad_emulated`` on the residuals each launch contracted
   (B = 128, 64 and 5).  The backward call's device time is split by
   kernel name, each kernel beside its bound, and the per-sample pass's
   launch (kernel, grid, block, dynamic shared memory, as the driver
   records it in a captured call) beside its device ms and bound.  The
   five conv probe kernels (``tap9``, ``im2col`` and the tensor-core
   ``mma3``, ``mma1`` and ``wgmma3``) are held against ``conv3x3_plain`` at B = 256, a ragged
   B = 5 and a 6×6 map, in f32 and in float64 (``mma1``, plain TF32, at
   its own looser tolerance), and ``wgmma3``'s error against the f64 plain
   version is printed beside ``mma3``'s (at most ``WGMMA_BAR``, 1.5, times
   it) and ``tap9``'s.  Then the probe's own path,
   ``probes.conv_probe.main``, the five-strategy race at B = 256 and B =
   128, with the conv counter set to 0 just before (its three bf16 twins
   race in ``[bf16]``).
3. The inference path, ``entry(device="cuda", batch=256)`` (CIFAR-10
   ODE-Net, per-sample dopri5 at tol 1e-3, full width, random weights),
   with the launch counters set to 0 just before: the ODEfunc kernel must
   launch twice (f0 and the initial-step probe), the fused step once per
   attempt.  TF32 must be off.  The plain path (no kernels) runs on the
   same card and inputs; per-sample NFE and logits must agree.
4. Training-path parity: the adjoint loss and parameter gradients through
   the kernels against the plain path (``odefunc_plain`` under autograd) on
   the card, B = 16, tol 1e-5, global control, augment off.
5. The training path, ``train_entry(device="cuda", batch=128)`` (the JAX
   ``TrainConfig`` defaults on ``synthetic-cifar10``, augment on): 5
   ``train_batch`` steps, the counters set to 0 before each.  Per step the
   ODEfunc kernel must launch 2 + 6·(forward attempts) + 1 times (the last
   for the observation-time gradient), the backward kernel nfe_b − 1 times
   (one call per augmented evaluation: it writes f itself), the fused step
   never; loss and every gradient finite.
6. The extraction path: the trained parameters → ``save_checkpoint`` →
   ``load_checkpoint`` → ``extract_features`` over the whole
   ``synthetic-cifar10`` test split (10,000 images, B = 256, T = 11) with
   the counters set to 0 just before: two ODEfunc launches per batch, one
   fused step per attempt, the backward kernel never.  The features' ends
   against the pooled stem output and the pooled state of the T = 2 solve,
   the first batch against the plain path, the ragged last batch against
   the same images in a full batch, ``nfe_sort`` against the unsorted run,
   ``odeint_dense`` at a small step budget against the trajectory; then
   ``save_features`` (.npz) → ``evaluate_features`` per t on the card.
   Then, each with the counters set to 0 just before and its seconds
   printed: ``[adams]``, the same model and inputs with ``method='adams'``
   (one ODEfunc launch per evaluation, 2 + 2·attempts; no fused step),
   per-sample NFE and logits against the plain path, img/s beside dopri5's;
   ``[event]``, ``odeint_event`` on the ODE-Net block per sample, each row
   stopping where mean(h²) crosses the midpoint of its values at t = 0 and 1
   (2 + 6·attempts ODEfunc launches; ``fired``, ``t_event`` against the
   plain path), timed beside ``odeint`` over the same span;
   ``[event-adjoint]``, d(Σ t_event)/dθ at B = 16, tol 1e-5, through the
   kernel pair against the plain path in float64.
7. The experiment CLIs at full width (hidden 64, groups 32), each through
   its ``main``.  ``[train-cli]``: ``train`` on ``synthetic-cifar10``
   (ODE-Net, adjoint, B = 128, ``--limit`` 1,280) for 2 epochs, then the
   same run stopped there and launched with ``--epochs 3``, which must
   resume at epoch 2 (``--epochs`` is part of the run identity, as in the
   JAX CLI, so the 2-epoch directory is given the 3-epoch run's identity:
   the state a stopped 3-epoch run is in); the run directory's name, the
   nine-column ``log.csv``, the checkpoints, and per train step the launch
   counts 2 + 6·attempts + 1 of the ODEfunc kernel and nfe_b − 1 of the
   backward kernel, per evaluation batch 2 and one fused step per attempt;
   the same one-epoch command twice into two directories (equal
   ``log.csv`` rows but ``time_s``, bit-identical weights: training is
   reproducible); one epoch each with ``--adjoint-seminorm`` and
   ``--adjoint-mode interpolated`` (their gradients on one fixed batch
   against the reintegrating adjoint's at a loss scaled by 1,000, where the
   seminorm must also take no more backward evaluations than the full norm;
   so must its epoch's first step, which sees the plain run's weights and
   batch); ``[adams-train]``, one epoch of ``--solver adams`` (per step
   2 + 2·attempts + 1 ODEfunc and nfe_b − 1 backward launches; six steps on
   one batch lower its loss and time the step; one fixed batch's Adams
   adjoint at tol 1e-5 against the plain path in float64) and ``[adams-sweep]`` on its run directory (``--method
   adams`` at two tolerances, per tolerance and ``--fused``: equal rows); a
   ResNet and a
   fixed-grid (rk4, direct backprop) ODE-Net on ``synthetic-mnist``, and
   that rk4 step's loss and gradients on one fixed batch through the
   kernels against the plain path in float64.  ``[pipeline]``: ``extract``
   and ``evaluate`` on that run directory.  ``[sweep]``: ``sweep`` on it at
   four tolerances, B = 256, per tolerance and ``--fused`` (the grid stacked
   on the batch axis, one fused step per attempt for all tolerances): equal
   ``top1`` and NFE columns, NFE non-decreasing as the tolerance tightens;
   one stacked batch of the run directory's model (7×7×64) and one of the
   random ``synthetic-mnist`` model (6×6×64), each tolerance's rows against
   the loop's solve (equal NFE, logits at 1e-5) and against the plain path
   (logits at 1e-3); one tolerance on the CPU plain path against the card;
   the random-init modes (32×32×3 noise, and ``synthetic-mnist``).
   ``[convert]``: the run directory's checkpoint through
   ``convert_checkpoint to-torch`` and ``from-torch``: config, extra and
   weights bit for bit, the same logits on the card.  ``[parity]``:
   ``parity_eval`` (the kernels on the card against the plain path on the
   CPU, 512 images) on the committed JAX run directory and on the train
   CLI's, exit 0.
   ``[width]``: the three fused kernels at hidden 32, 128 and 256 on the
   7×7 and 6×6 maps, at 7×7×96, 7×7×192 (the tensor-core stage's padded
   and whole blocks beyond the powers of two), 7×7×512 and 6×6×512 (the
   state in global scratch) against their plain versions (the backward in
   float64, dθ bit-identical across two launches, its dθ error beside the
   f32 plain version's; both builds' weight gradients against
   ``weight_grad_emulated`` on the residuals they contracted, within
   WEIGHT_GRAD_BAR; the bf16 build under ``bf16_distances.BARS``, as at
   7×7×64, B = 128, 64 and 5 in ``[check]``; ``[weights]`` lines: the
   weight kernel the path runs there, ``bwd_weight_kernel`` on ``wgmma``
   where C % 64 == 0, and in both builds dθ and the row chunks of
   ``bwd_weight_kernel`` and of the ``mma.sync`` kernel it replaced bit for
   bit, the two launched alone in turns beside the bound; at 7×7×64 too,
   with ``[split]``, whose machine code must hold HGMMA and no HMMA), an
   inference solve
   (B = 256) and a train step (B = 128) through the entry points at each
   with the launch rules of phases 3 and 5 and per-sample NFE against the
   plain path; at 7×7×128, 256 and 512 the adjoint gradients against the
   plain path (B = 128, tol 1e-5) and at 7×7×128, 256, 96 and 512 the
   probe's ``mma3``/``mma1`` against the f64 conv beside ``F.conv2d``
   (``mma3`` within 1e-6 at 96 and 512), the probe's ``mma_bf16`` beside
   ``F.conv2d`` on bf16 tensors by device time at every C from 96 to 512
   (B = 256, 7×7); at every shape with C ≥ 96 the bf16 ``odefunc``, which
   runs the rows build there (``stage`` ``'rows_bf16'``, each conv one
   bf16 ``wgmma`` GEMM over the rows of every sample,
   ``csrc/rows_conv.cuh``): one launch counted a call, bit for bit the
   per-sample build it replaced (``probes/timing_aids.py``
   ``odefunc_cta_bf16``) and the bf16 backward's f, at B = 128, 5 and 1
   the per-sample build's bits and the B = 256 batch's rows, its three
   GroupNorm launches as launched (a captured call: a slice of whole groups
   a CTA, ``rows_slices`` a sample, no cluster) with their device ms and
   bytes bound, the plain bf16 f within ``BARS``, a bf16
   solve through ``odenet_logits`` by the launch rule (at 7×7×512 on the
   graph cache and the host loop, bit-identical), device ms of the rows
   build and the per-sample build in turns beside ``F.group_norm`` +
   ``F.conv2d`` on bf16 tensors; at 7×7 and the probe's widths
   ``tap9_bf16`` and ``im2col_bf16`` against the plain bf16 conv, bit for
   bit ``mma_bf16`` (``im2col_bf16`` where C % 64 == 0), raced beside it
   and ``F.conv2d`` bf16 in turns; at every shape with C ≥ 96 the bf16
   backward, which runs the rows backward there (``sample_pass``
   ``'rows'``, read from a captured call: its recompute and both
   input-gradient convs on the rows conv, the last two on its transposed
   packing): one launch counted a call, dθ, dt, dh and f bit for bit the
   one-CTA pass it replaced (``probes/timing_aids.py``
   ``odefunc_bwd_cta_bf16``) at B = 128, 5 and 1 and a second launch's,
   its five GroupNorm launches on the slices' grid, the plain bf16 VJP
   within ``BARS``; at 7×7×96 and 7×7×512 their device ms and bytes bound
   and a bf16 adjoint
   train step by the launch rule (NFE-b − 1 ``odefunc_bwd_bf16``) and the
   call's device ms in turns beside the one-CTA pass and autograd through
   ``F.group_norm`` + ``F.conv2d`` on bf16 tensors; one epoch each of
   ``train --hidden 128``, ``--hidden 512`` and ``--bf16 --hidden 512``
   (each step by its launch rule); C = 544 and C = 48 refused before
   any launch, naming the JAX kernels' gate.  ``[foreign]``: CIFAR-10 binary
   batches and MNIST IDX files (labels gzipped) written from the synthetic
   twins read back through ``load_dataset``; the JAX run directory
   committed under ``tests/fixtures_torch/`` loaded on the card; ``python -m
   neural_ode_features_tpu_torch.eval_ckpt`` on it must give the JAX tool's
   top-1 (stored beside it) and mean NFE within 1%.  ``[population]``:
   ``train --seeds 5,6`` for one epoch at the train CLI's size: two run
   directories, member 0's name, weights, training state and ``log.csv``
   rows (but ``time_s``) bit-identical to the solo ``--seed 5`` run's.
   ``[parallel]`` (``parallel_phase``): training across devices on the one
   card: ``dryrun_multichip(1)`` and three steps at one NCCL rank; two gloo
   ranks sharing the card (``devices=['cuda:0', 'cuda:0']``): two data
   parallel steps and an evaluation, two steps on a (1, 2) FSDP mesh, a
   population of seeds 5 and 6 over the ranks, against the solo
   ``Trainer`` on the card at the JAX bars (members bit-identical); ``train
   --num-devices 2`` refused, naming the card count; each rank's launches
   per step by the training rule and ``rk_step`` in its evaluation; the
   step's time solo, at one NCCL rank and with two ranks on one card, and
   the bytes summed per backward attempt and per step.
   ``[serve]``: the deployment path.  The ``entry`` model (seed 7) through
   ``export_model export-compiled`` at B = 256 (``rowwise`` must be true),
   then the serving host in its own process (``python -m
   neural_ode_features_tpu_torch.serve``, a cache hit of this script's
   build): ``--selftest`` (bit-equal) and ``--bench 20``, then ``--listen``
   on a unix socket, driven through the port's ``serving.SocketClient``:
   one full batch (the first request after ``READY``), then 256
   sequential full batches (latency p50 and p99) and 400 in depth-2
   streams, in alternating turns, a burst of 64 ragged requests of 1..32
   rows over one connection and over four, a bad length and a good request
   after it, the shutdown frame; the host's totals read between the parts
   (``SIGUSR1``).  Every ragged answer must equal the same rows of
   the full batch's answer bit for bit, the full batch the plain path on
   the CPU at 1e-3 (argmax equal); the host must exit 0, and its shutdown
   line must show 2 ``odefunc`` launches per dispatch and one ``rk_step``
   per attempt.  Prints img/s, dispatches, requests per dispatch and the
   attempts of the ragged dispatches beside a full batch's.
8. Time each kernel, its plain version and the library yardstick (one f
   through cuDNN: ``F.group_norm``/``F.conv2d`` on NCHW with the t channel
   concatenated; for the backward, ``torch.autograd.grad`` through it; for
   the conv probe, ``F.conv2d``), the whole inference solve in img/s, the
   train step in img/s split into the forward and the backward solve, and
   one extraction batch through ``extract_entry`` at T = 11 beside T = 2;
   one train step, one extraction batch, one Adams solve and one event
   solve under ``torch.profiler`` (device kernels counted);
   ``[determinism]``: one batch's gradients twice through the trainer's
   step, bit-identical, and the step's time with cuDNN's deterministic
   algorithms and with its default ones, in turns.
9. ``[graph]``: every ``'while'`` RK solve above ran its attempts as a
   replayed CUDA graph (``solver/attempt_graph.py``; the inference solves
   of ``models.odenet_solve`` through the cache, one capture per shape,
   the others with a capture per solve); this phase holds that
   route against the private host loop (``runge_kutta._host_loop``) on the
   card (from an empty cache): the entry model at B = 256 and 5, the fused sweep's 4·256 stacked
   rows with their (B,) tolerances, one extraction batch at T = 11,
   ``extract_features`` over two full batches and a padded one with
   ``nfe_sort``, and one adjoint train step at B = 128 (loss, NFE-f, NFE-b,
   dθ), each bit-identical with equal launch counts and at least one
   capture; then in alternating turns (median of 5) the solve and the
   extraction batch on the host loop, a capture per solve and the cache
   (the cache's median must not be slower than the host loop's), the train
   step's forward and backward on the host loop and the graph; one
   capture over 20 same-shape solves; an in-place weight change and another
   tolerance each a new capture, bit-identical to the host loop (never a
   stale replay); the
   captures' own host time, the device's busy share under
   ``torch.profiler`` on each route (its kernel counts equal to the launch
   counters, which the graph route takes from the captured graph's kernel
   nodes), the straggler bench (``--reps 1``) on each, the graph pool's
   bytes and the reserved memory against the host loop after an extraction
   batch and a train step, the extraction batch with a pool per solve
   against the thread's pool (a capture per solve), and the reserved
   memory after 10 and after 100 solves (within 1%), with the cache's
   entries and each one's pool bytes after them.
   ``[export]``: the code-free program, ``export_model export`` of the
   entry model at B = 256 on the card and ``run`` against the live model
   (argmax agreement 1.0, max|diff| <= 1e-3); the program's call with the
   counters from 0 just before (2 ``odefunc``, one ``rk_step`` per attempt,
   held against ``torch.profiler``), its img/s beside the live fwd's in
   alternating turns, its bytes; ``export-mock`` and ``serve --selftest``
   on the mock artifact.
10. The slice-11 paths, after the timings (so that their hundreds of
   thousands of small launches come after the profiler's windows).
   ``[bf16]``: bf16 on the card.  The kernels' bf16 builds against their
   plain versions: the ODEfunc kernel's ``compute_dtype='bfloat16'`` build
   at every shape the bf16 paths give it (7×7×64 at B = 256, 768 and 5,
   6×6×64 at B = 256; bf16 values, within 4 u of the plain f's max-norm per
   row), the fused step's ``conv_precision='bf16'`` (B = 256 and 5, relative
   L2 per output within 4 times the plain step's own move under one-ulp
   GroupNorm perturbations, and its error ratio more than 4 u from the f32
   step's), the backward's bf16 build (``odefunc_backward_bf16``: 7×7×64
   at B = 128, 64, 16 and 5, 6×6×64 and 7×7×32 at B = 128, 7×7×512 at
   B = 32, and at B = 32 at the five shapes of the card tests; each output
   within its bar in u of the plain bf16 VJP, dh, dt and the early leaves
   below the f32 build's distance; its f bit-equal to the bf16 ODEfunc
   kernel's; dθ bit-identical over two launches; the per-sample pass each
   call launched read from the call captured into a CUDA graph, the gate's
   and, at 7×7×64 B = 128 and 16 and 6×6×64 B = 128, the two-CTA cluster's
   bf16 build), the bf16 ODEfunc kernel's and the fused step's bf16 conv
   stage at 7×7×64 and 6×6×64 from the gate (``'wgmma_bf16'``) and from
   the build (the machine code, ``cuobjdump -sass``, of the bf16 ODEfunc
   kernel, of the bf16 cluster pass and of the fused step's ``kBf16Conv``
   build holds bf16 warpgroup products), the probe's ``mma_bf16``,
   ``tap9_bf16``, ``im2col_bf16`` and ``wgmma_bf16`` (f32 reassociation);
   ``im2col_bf16`` and ``tap9_bf16`` (one bf16 ``wgmma`` template over the
   rows of every sample, both operands from shared memory; a stage 64 k of
   the patch matrix or one tap's 64 channels; from C = 72 at C % 8 == 0
   the rows kernel of ``csrc/rows_conv.cuh``) also at every C from 4 to
   128 their gate takes on 7×7 (B = 5) and at 7×7×64, 6×6×64, 5×5×128, 9×8×64, 7×7×128,
   32×32×4, 7×7×36, 14×14×16, 7×7×100, 7×7×32, 8×8×64 and 4×4×128 at
   B = 256, 128 and 5, each error against the f64 conv of the rounded
   operands beside ``mma_bf16``'s (at most ``WGMMA_BAR`` times), the two
   bit-identical at C = 64 and 128, their 64- and 128-row tiles
   bit-identical and timed, bf16 ``HGMMA`` in their build and none in the
   f32 ``im2col``'s (``cuobjdump -sass``); the fused bf16 builds' FFMA
   stage alone (``probes/timing_aids.py`` ``tap9_ffma_bf16``, what
   ``tap9_bf16`` was before) against the plain bf16 conv and timed.  The entry
   model's bf16 inference
   (``odenet_logits``, ``odenet_trajectory``) at B = 256 on the host loop
   and on the cache, bit-identical, 2 + 6·attempts ``odefunc`` launches and
   no ``rk_step``, against the plain bf16 dynamics on the card (per-sample
   NFE equal on at least the share the CPU emulation measured, top-1 on at
   least 99%), its warm time beside the f32 solve's; a bf16 and an f32 solve of one model two cache entries; one
   solve with the bf16 fused step beside one with the f32 step (per-sample
   NFE, accepts, rejects side by side).  bf16 training at
   ``train_entry(batch=128)``'s configuration: the ``Trainer``'s step twice
   on the graph route and once on the host loop from one set of weights
   (the weights after it bit-identical; 2 + 6·attempts + 1 ``odefunc_bf16``
   and NFE-b − 1 ``odefunc_bwd_bf16`` launches, no f32 launch), its time
   and device busy time beside the f32 step's; the gradient step under the
   reintegrating, seminorm and interpolated adjoints, direct backprop and
   an Adams adjoint against the plain bf16 path on the card (per-sample
   NFE-f equal on at least 99% of rows, Adams 95%, gradients nearer it
   than the f32 step's; the plain path's own move when its stem output
   moves one ulp beside them) and beside the f32 step; ``sweep --bf16`` at 1e-1..1e-3, loop
   and ``--fused``; ``train --bf16`` for one epoch at the train CLI's size
   (every step and evaluation batch by its launch rule in the bf16 builds)
   and its resume to a second epoch; the bf16 run through
   ``export-compiled`` and ``serve --selftest`` (2 + 6·attempts
   ``odefunc_bf16``, no ``rk_step``) and ``export`` and ``run`` against the
   live model; the bf16 probe race at B = 256 and 128 (four strategies,
   ``F.conv2d`` on bf16 tensors by its call and its device time); each
   bf16 build timed, the backward by kernel beside the f32 build.
   ``[straggler]``: ``python -m neural_ode_features_tpu_torch.straggler_bench``
   at the JAX tool's defaults (its JSON line: host and CUDA-event clocks,
   lane work, error units) and ``tests/test_straggler.py``'s bars; one
   batch of each mode under ``torch.profiler`` (the device's busy share);
   at ``--pool 512 --dim 8`` the lane work equal to the ``--cpu`` run's.
   ``[examples]``: ``examples.solver_playground`` (γ within 1e-3, no fused
   kernel launched) and ``examples.continuous_features`` (32 adjoint steps
   at B = 64 on 6×6×64 maps, then 512 test images at 9 times from one
   solve: per step 2 + 6·attempts + 1 ``odefunc`` and NFE-b − 1
   ``odefunc_bwd``, per features solve 2 ``odefunc`` and one ``rk_step``
   per attempt, 9 finite mAPs), the three kernels held against their plain
   versions at 6×6×64, B = 64 and 512.  ``[protocol]``:
   ``reference_protocol`` on fabricated MNIST files, 1 epoch of 512 images,
   its three steps in their own processes: the JAX tool's verdict keys (of
   its committed ``runs_protocol/mnist_verdict.json``), ``data:
   fabricated``, the parity clause held; then the same steps in this
   process with the launches watched (the rules of ``[train-cli]``; 2
   ``odefunc`` and one ``rk_step`` per attempt per ``eval_ckpt`` and
   ``parity_eval`` batch) and the same top-1; the kernels held at
   ``parity_eval``'s B = 100 and 12 and at B = 512.
11. ``[bench]``: the headline bench as a user types it, ``python -m
   neural_ode_features_tpu_torch.bench --iters 8 --repeats 3 --cpu-batches
   2``, then with ``--pool 2048 --nfe-sort`` and with ``--bf16``, each in
   its own process; each record printed, rc 0 and complete, ``backend``
   "cuda", ``fused_rk`` true (false for ``--bf16``), ``mean_nfe`` that of
   this process's solves of the same weights and input ([main]'s for the
   default), ``tflops`` and ``mfu`` (``mfu`` = ``tflops``·1e12 over the bf16
   peak), ``vs_baseline`` or a ``baseline_note``, the CUDA-event figure
   within 10% of the host clock's, the launches its stderr line reports
   held exactly to the inference rule over the attempts that line reports
   (f32: 2 ``odefunc`` per solve and one ``rk_step`` per attempt; bf16:
   2 + 6·attempts ``odefunc_bf16`` per solve); ``value`` printed beside
   ``[time]``'s whole solve.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(per kernel and shape, the bf16 builds as ``odefunc_bf16``,
``rk_step_bf16``, ``odefunc_bwd_bf16``, ``conv_probe_bf16``,
``conv_probe_im2col_bf16`` and ``conv_probe_tap9_bf16`` with their
bounds at the bf16 tensor-core rate: the conv stage it ran; ``ms``, its device time per
call, CUDA events around calls queued behind a spin kernel (``device_ms``);
``profiler_ms``, the mean of the launches ``torch.profiler`` recorded, by
kernel name; ``call_ms``, CUDA events around back-to-back calls of its
wrapper, which the host's cost of a launch bounds from below; ``bound_ms``
with the tensor cores and ``ffma_bound_ms`` on the CUDA cores), and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
import dataclasses
import gzip
import importlib
import io
import itertools
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np

from neural_ode_features_tpu_torch.utils.flops import (
    H100_BF16_FLOPS,
    H100_TF32_FLOPS,
    bounds,
    bwd_kernel_bounds,
    rows_sample_bounds,
)

B, HH, WW, C, G = 256, 7, 7, 64, 32
B_TRAIN = 128                            # the JAX TrainConfig batch size
TOL = 1e-3
STATE_TOL = dict(rtol=2e-4, atol=2e-5)   # kernel vs plain: f32 reassociation
RATIO_TOL = dict(rtol=2e-3, atol=1e-6)   # error ratio: a sum of squares
DP_TOL = dict(rtol=3e-4, atol=3e-4)      # dθ: sums over B·H·W products
# The weight-gradient kernel against weight_grad_emulated on its own
# residuals, in units of the sum of |products| per entry: 3×TF32 and the
# emulation each within 2.1e-7 of the f64 sum, plus the tensor core's
# truncating accumulation over a 32-row step (tests/test_torch_cuda.py);
# bf16 beyond one bf16 ulp of the larger.
WEIGHT_GRAD_BAR = 2e-6
CONV_TOL = dict(rtol=1e-4, atol=1e-5)    # one conv: sums of 576 products
TF32_TOL = dict(rtol=2e-3, atol=2e-4)    # mma1 alone: plain TF32, 11-bit operands
T_OUT = 11                               # extract's default --timestamps
LOSS_SCALE = 1e3                         # adjoint variants: |a_y| well above atol
SWEEP_TOLS = (1e-1, 1e-2, 1e-3, 1e-4)    # sweep's default --tols
# [width]: the shapes beside 7×7×64 and 6×6×64 (H, W, C), the adjoint's
# and the probe's widths at 7×7.  Every width the JAX kernels take runs on
# the card; these are the powers of two, a padded and a whole-block width
# beyond them, and the widest.
WIDTH_SHAPES = ((7, 7, 32), (6, 6, 32), (7, 7, 128), (6, 6, 128), (7, 7, 256),
                (6, 6, 256), (7, 7, 96), (7, 7, 192), (7, 7, 512), (6, 6, 512))
ADJOINT_WIDTHS = (128, 256, 512)
PROBE_WIDTHS = (128, 256, 96, 512)
F64_CONV_BAR = 1e-6                      # mma3 vs the f64 conv at 96 and 512
# [bf16]: the bf16 builds against their plain versions in units of u = 2^-8
# of the compared value's size, each bar held beside the f32 build's
# distance (neural_ode_features_tpu_torch/probes/bf16_distances.py BARS).
BF16_NFE_SHARE = 1.0                     # the CPU emulation's measured share
FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures_torch" / (
    "jax_run_mnist")                     # [foreign]: a JAX run directory
FIXTURE_EVAL = FIXTURE.with_name("jax_run_mnist.eval.json")
REPLACES = {
    "odefunc": "neural_ode_features_tpu/kernels/odefunc_pallas.py:219",
    "rk_step": "neural_ode_features_tpu/kernels/rk_step_pallas.py:586",
    "odefunc_bwd": "neural_ode_features_tpu/kernels/odefunc_bwd_rows.py:305",
    "conv_probe": "probes/conv_probe.py:254",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def close(name, got, want, rtol, atol):
    """Assert allclose; return the max absolute error."""
    import torch

    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: kernel vs plain max abs err {err:.3e} "
             f"(rtol {rtol}, atol {atol})")
    return err


def time_ms(fn, reps: int = 10, blocks: int = 5) -> float:
    """Median over ``blocks`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def device_ms(fn, reps: int = 20) -> float:
    """Device ms per call of ``fn``: ``reps`` calls enqueued behind a spin
    kernel, timed by CUDA events around them (``probes.conv_probe.
    queued_us``).  Needs no profiler: ``torch.profiler`` drops some
    windows' kernels."""
    from neural_ode_features_tpu_torch.probes.conv_probe import queued_us

    return queued_us(fn, reps) / 1e3


def kernel_sass(source: str, fragment: str) -> str:
    """The machine code (``cuobjdump -sass``) of the kernels of the built
    ``csrc/<source>.cu`` whose mangled name holds ``fragment``; fails where
    the toolkit's ``cuobjdump`` is missing or no kernel matches."""
    import shutil

    from neural_ode_features_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        fail("cuobjdump not found: the build's machine code cannot be read")
    text = subprocess.run([tool, "-sass", str(_build._lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    blocks = re.split(r"\n\s*Function : ", text)[1:]
    hits = [b for b in blocks if fragment in b.split("\n", 1)[0]]
    if not hits:
        fail(f"no kernel {fragment!r} in the build of csrc/{source}.cu")
    return "\n".join(hits)


@contextlib.contextmanager
def host_loop():
    """Every 'while' solve on the private host loop."""
    from neural_ode_features_tpu_torch.solver import runge_kutta

    saved = runge_kutta._while_loop
    runge_kutta._while_loop = (
        lambda body, carry, n, capturable, key=None:
        runge_kutta._host_loop(body, carry, n))
    try:
        yield
    finally:
        runge_kutta._while_loop = saved


def leaves(tree) -> list:
    """A param tree's leaves in a fixed (sorted-key) order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def flat(tree):
    """A param tree's leaves, concatenated."""
    import torch

    return torch.cat([x.reshape(-1) for x in leaves(tree)])


def gradient_bar(name, got, want):
    """tests/test_pallas.py:142-145: rel-L2 < 1e-2 and cosine > 0.9999."""
    got, want = got.double(), want.double()
    rel = float((got - want).norm() / want.norm())
    cos = float(got @ want / (got.norm() * want.norm()))
    if not (rel < 1e-2 and cos > 0.9999):
        fail(f"{name}: rel-L2 {rel:.3e}, cosine {cos:.7f}")
    return rel, cos


def library_f(h, t, wt):
    """One f through PyTorch's library calls (``F.group_norm``,
    ``F.conv2d`` on NCHW with the t channel concatenated): the yardstick of
    the ODEfunc kernel, which the port itself never calls
    (``probes.conv_probe.library_f``).  ``wt``: the raw ODEfunc params,
    ``h`` (B, H, W, C), ``t`` (B,)."""
    from neural_ode_features_tpu_torch.probes.conv_probe import (
        library_f as lib_f,
    )

    return lib_f(h, t, wt, G)


def library_bwd(h, t, wt, g):
    """The backward yardstick: ``torch.autograd.grad`` through
    :func:`library_f` w.r.t. h, t and the raw weights (its forward
    included, as the backward kernel recomputes it;
    ``probes.conv_probe.library_bwd``)."""
    from neural_ode_features_tpu_torch.probes.conv_probe import (
        library_bwd as lib_bwd,
    )

    return lib_bwd(h, t, wt, g, G)


def fused_bounds(hw, c, b, b_bwd, tensor_peak=H100_TF32_FLOPS):
    """The fused kernels' bounds at H×W×C = (*hw, c): ``odefunc`` and
    ``rk_step`` at batch ``b``, the backward at ``b_bwd`` (``bounds``)."""
    n = hw[0] * hw[1] * c
    conv = 2 * hw[0] * hw[1] * 9 * c * c             # one 3×3 conv, a sample
    weight_bytes = 4 * (2 * 9 * c * c + 2 * n + 8 * c)
    return {
        # Two convs per f; h and t in, f out.
        "odefunc": bounds(2 * conv * b, 4 * (2 * b * n + b) + weight_bytes,
                          tensor_peak),
        # Six f; t0, dt, rtol, atol in; y0, f0 in; y1, f1, y_mid, ratio out.
        "rk_step": bounds(12 * conv * b,
                          4 * (5 * b * n + 5 * b) + weight_bytes,
                          tensor_peak),
        # Six 3×3-conv equivalents per sample (forward recompute, input
        # gradients, weight gradients); reads h, g, t, the laid-out
        # weights, writes f, dh, dt and the raw dθ once each.
        "odefunc_bwd": bounds(6 * conv * b_bwd,
                              4 * (4 * b_bwd * n + 2 * b_bwd) + weight_bytes
                              + 4 * (2 * 9 * (c + 1) * c + 8 * c),
                              tensor_peak),
    }


def parallel_phase(smi: str) -> dict:
    """[parallel]: training across devices on the one card.  (a)
    ``dryrun_multichip(1)``, one NCCL rank (beside (b)), and three steps
    at one NCCL rank alone at the JAX ``TrainConfig`` defaults on
    ``synthetic-cifar10`` (hidden 64, B = 128, tol 1e-3 per sample,
    augment on); (b) two ranks sharing
    the card through gloo (``devices=['cuda:0', 'cuda:0']``): two data
    parallel steps and an evaluation, two FSDP steps on a (1, 2) mesh, and a
    population of two seeds over the ranks, the steps against the solo
    ``Trainer`` on the card at the JAX bars (step-1 loss rtol 1e-6 with NFE
    equal, step-2 loss rtol 3e-4 with NFE equal and nfe_b within 1), each
    member's weights bit-identical to its solo epoch; (c) ``train
    --num-devices 2`` on one card exits, naming the count; (d) every rank's
    launches per step, ``odefunc`` 2 + 6·attempts + 1 with its own forward
    attempts and ``odefunc_bwd`` NFE-b − 1, and ``rk_step`` in each rank's
    share of the evaluation.  Prints the step's time solo, at one NCCL rank
    and with two ranks on one card (which says nothing of scaling), and the
    bytes summed across ranks per backward attempt and per step.  Returns
    the ranks' launches by path (summed over the ranks), for the script's
    check that every kernel of a path ran."""
    import torch

    from neural_ode_features_tpu_torch import train as train_cli
    from neural_ode_features_tpu_torch._device import strict_f32
    from neural_ode_features_tpu_torch.data import load_dataset
    from neural_ode_features_tpu_torch.entry import (
        TRAIN_CONFIG,
        dryrun_multichip,
    )
    from neural_ode_features_tpu_torch.parallel import launch
    from neural_ode_features_tpu_torch.parallel.tasks import (
        in_turn,
        population_epoch,
        train_steps,
    )
    from neural_ode_features_tpu_torch.training import Trainer
    from neural_ode_features_tpu_torch.utils import count_parameters

    t_ph = time.perf_counter()
    strict_f32("cuda")  # the solo runs here compute as the ranks do
    card = f"({smi})"
    cfg = dataclasses.replace(TRAIN_CONFIG, batch_size=B_TRAIN)
    x, y = load_dataset(cfg.dataset, "train", limit=2 * B_TRAIN)
    y = y.astype(np.int64)
    xt, yt = load_dataset(cfg.dataset, "test", limit=2 * B_TRAIN)
    batches = [(x[:B_TRAIN], y[:B_TRAIN]), (x[B_TRAIN:], y[B_TRAIN:])]
    timing = batches + batches[:1]

    # (a) One NCCL rank: the step's time, alone on the card.
    nccl = launch(train_steps, 1, cfg, timing, devices=["cuda:0"],
                  device="cuda", timeout=300)[0]
    print(f"[parallel] one NCCL rank: 3 steps at B={B_TRAIN} by "
          f"{time.perf_counter() - t_ph:.1f} s")

    # (b) Two ranks on the one card (gloo), while dryrun_multichip(1) runs
    # its one NCCL rank beside them (neither's time is read).
    shared = ["cuda:0", "cuda:0"]
    dp_cfg = dataclasses.replace(cfg, num_devices=2)
    jobs = [(train_steps, (dp_cfg, batches),
             {"device": "cuda", "evaluate": (xt, yt)}),
            (train_steps, (dataclasses.replace(dp_cfg, model_shards=2),
                           batches), {"device": "cuda"}),
            (population_epoch, (dp_cfg, [5, 6], x, y), {"device": "cuda"})]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        dry_f = pool.submit(dryrun_multichip, 1)
        ranks = launch(in_turn, 2, jobs, devices=shared, timeout=300)
        dry = dry_f.result()
    if not np.isfinite(dry["loss"]):
        fail("[parallel] dryrun_multichip(1) loss is not finite")
    dp, fsdp, pop = ([r[i] for r in ranks] for i in range(3))
    print(f"[parallel] two gloo ranks on the card (data parallel, FSDP, the "
          f"population) and dryrun_multichip(1) by "
          f"{time.perf_counter() - t_ph:.1f} s")

    solo = Trainer(cfg, steps_per_epoch=4, device="cuda")
    want, solo_s = [], []
    for b in timing:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want.append(solo.train_batch(*b))
        torch.cuda.synchronize()
        solo_s.append(time.perf_counter() - t0)
    want = want[:2]

    def bars(got):
        return (abs(got[0]["loss"] - want[0]["loss"])
                <= 1e-6 * abs(want[0]["loss"])
                and got[0]["nfe"] == want[0]["nfe"]
                and abs(got[1]["loss"] - want[1]["loss"])
                <= 3e-4 * abs(want[1]["loss"])
                and got[1]["nfe"] == want[1]["nfe"]
                and abs(got[1]["nfe_b"] - want[1]["nfe_b"]) <= 1.0)

    for name, rs in (("2 ranks data parallel", dp),
                     ("(1, 2) FSDP", fsdp)):
        print(f"[parallel] {name} on one card (gloo): " + " | ".join(
            f"step {i}: loss {m['loss']:.7f} nfe {m['nfe']} nfe_b "
            f"{m['nfe_b']}" for i, m in enumerate(rs[0]["metrics"]))
            + f"; solo: " + " | ".join(
                f"loss {m['loss']:.7f} nfe {m['nfe']} nfe_b {m['nfe_b']}"
                for m in want))
        if not all(r["metrics"] == rs[0]["metrics"] for r in rs):
            fail(f"[parallel] {name}: the ranks report other metrics")
        if not bars(rs[0]["metrics"]):
            fail(f"[parallel] {name} misses the JAX bars against the solo "
                 "Trainer on the card")
    if not any(tuple(loc) != tuple(whole)
               for loc, whole in fsdp[0]["shapes"]):
        fail("[parallel] FSDP: no parameter leaf is sharded")

    seeds_same = []
    for i, seed in enumerate((5, 6)):
        member = Trainer(dataclasses.replace(cfg, seed=seed),
                         steps_per_epoch=2, device="cuda")
        member.train_epoch(x, y, 0)
        got = {j: p for r in pop for j, p in r["params"].items()}[i]
        seeds_same.append(max(
            float((a.detach().cpu() - b).abs().max()) for a, b in zip(
                leaves(member.params), leaves(got))) == 0.0)
    print(f"[parallel] population of seeds 5, 6 over 2 ranks (owned "
          f"{[r['owned'] for r in pop]}): each member's weights after one "
          f"epoch bit-identical to its solo run on the card: {seeds_same}")
    if not all(seeds_same):
        fail("[parallel] a population member differs from its solo run")

    # (c) More ranks than cards.
    with tempfile.TemporaryDirectory() as runs_tmp:
        try:
            train_cli.main(["--dataset", "synthetic-cifar10",
                            "--num-devices", "2", "--epochs", "1",
                            "--limit", "256", "--runs-dir", runs_tmp])
            fail("[parallel] train --num-devices 2 ran on one card")
        except SystemExit as e:
            msg = str(e)
            print(f"[parallel] train --num-devices 2 on one card exits: "
                  f"{msg}")
            if "--num-devices 2: 1 CUDA device" not in msg:
                fail("[parallel] the exit does not name the card count")

    # (d) Each rank's launches.
    for name, rs in (("dp", dp), ("fsdp", fsdp)):
        for r in rs:
            for i, (got, att, m) in enumerate(zip(
                    r["launches"], r["attempts"], r["metrics"])):
                exp = {"odefunc": 2 + 6 * att + 1,
                       "odefunc_bwd": int(m["nfe_b"]) - 1, "rk_step": 0}
                if got != exp:
                    fail(f"[parallel] {name} rank {r['rank']} step {i}: "
                         f"launches {got}, expected {exp}")
            print(f"[parallel] {name} rank {r['rank']}: launches per step "
                  f"{r['launches']}, own forward attempts {r['attempts']}")
    for r in dp:
        ev = r["eval_launches"]
        print(f"[parallel] dp rank {r['rank']}: evaluation launches {ev}; "
              f"test top-1 {r['eval']['acc']:.4f}")
        if ev["rk_step"] < 1 or ev["odefunc_bwd"] != 0:
            fail(f"[parallel] dp rank {r['rank']} evaluation launches {ev}")

    # Times and bytes.
    med = statistics.median
    odefunc_n = count_parameters(solo.full_params()["odefunc"])
    n_all = count_parameters(solo.full_params())
    per_attempt = 4 * (3 * (odefunc_n + 1) + 1)
    per_step = 4 * (n_all + 3)
    print(f"[parallel] train step B={B_TRAIN} {card}: solo "
          f"{1e3 * med(solo_s[1:]):.2f} ms (median of {solo_s[1:]}); one "
          f"NCCL rank {1e3 * med(nccl['step_s'][1:]):.2f} ms (median of "
          f"{nccl['step_s'][1:]}); two ranks on one card through gloo "
          f"{1e3 * dp[0]['step_s'][1]:.2f} ms (step 2; step 1, with the "
          f"first launches, {1e3 * dp[0]['step_s'][0]:.2f} ms; two processes "
          f"share one card and sum through the host: this says nothing of "
          f"scaling)")
    print(f"[parallel] bytes summed across the data ranks {card}: per "
          f"backward attempt {per_attempt:,} (y0, y1, err of a_theta and "
          f"a_t, {odefunc_n + 1:,} floats each, and the row terms), per "
          f"step {per_step:,} (the gradient of {n_all:,} parameters and 3 "
          f"metrics), plus 16 bytes per solve for the counts and "
          f"{4 * (2 * (odefunc_n + 1) + 2) + 4 * (odefunc_n + 2):,} for the "
          f"initial step; FSDP gathers {4 * n_all:,} bytes of weights per "
          f"step over 'model'")
    total = {k: sum(r["launches"][i][k] for r in dp + fsdp
                    for i in range(2)) for k in ("odefunc", "odefunc_bwd",
                                                 "rk_step")}
    ev_total = {k: sum(r["eval_launches"][k] for r in dp)
                for k in total}
    print(f"[parallel] phase took {time.perf_counter() - t_ph:.1f} s")
    return {"parallel": total, "parallel_eval": ev_total}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from torch.utils import _pytree as pytree

    from neural_ode_features_tpu_torch import (
        convert_checkpoint as convert_cli,
    )
    from neural_ode_features_tpu_torch import evaluate as evaluate_cli
    from neural_ode_features_tpu_torch import export_model
    from neural_ode_features_tpu_torch import extract as extract_cli
    from neural_ode_features_tpu_torch import parity_eval as parity_cli
    from neural_ode_features_tpu_torch import (
        reference_protocol,
        straggler_bench,
    )
    from neural_ode_features_tpu_torch import sweep as sweep_cli
    from neural_ode_features_tpu_torch import train as train_cli
    from neural_ode_features_tpu_torch import training as training_mod
    from neural_ode_features_tpu_torch._device import tree_to
    from neural_ode_features_tpu_torch.data import load_dataset
    from neural_ode_features_tpu_torch.entry import (
        ENTRY_CONFIG,
        TRAIN_CONFIG,
        entry,
        extract_entry,
        train_entry,
    )
    from neural_ode_features_tpu_torch.evaluation import evaluate_features
    from neural_ode_features_tpu_torch.examples import (
        continuous_features,
        solver_playground,
    )
    from neural_ode_features_tpu_torch.extract import extract_features
    from neural_ode_features_tpu_torch.features_io import (
        load_features,
        save_features,
    )
    from neural_ode_features_tpu_torch.kernels import _build
    from neural_ode_features_tpu_torch.kernels.conv3x3 import (
        STRATEGIES,
        conv3x3,
        conv3x3_plain,
        conv_bytes,
        conv_flops,
    )
    from neural_ode_features_tpu_torch.kernels.odefunc import (
        odefunc,
        odefunc_plain,
        odefunc_vjp,
        prepare,
        rows_slice_threads,
        rows_slices,
        stage,
    )
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        odefunc_bwd,
        odefunc_bwd_plain,
        sample_pass,
        weight_grad_emulated,
        weight_grad_f64,
        weight_splits,
    )
    from neural_ode_features_tpu_torch.kernels.rk_step import (
        dopri5_step,
        dopri5_step_plain,
    )
    from neural_ode_features_tpu_torch.models import (
        ModelConfig,
        ODENet,
        block_dynamics,
        head_apply,
        init_odenet,
        odenet_logits,
        odenet_trajectory,
        pool_features,
        stem_apply,
    )
    from neural_ode_features_tpu_torch.ops import normalize
    from neural_ode_features_tpu_torch.probes import conv_probe, serve_probe
    from neural_ode_features_tpu_torch.serving import SocketClient
    from neural_ode_features_tpu_torch.solver import (
        DOPRI5,
        odeint,
        odeint_adjoint,
        odeint_dense,
        odeint_event,
        odeint_event_adjoint,
    )
    from neural_ode_features_tpu_torch.training import TrainConfig, Trainer
    from neural_ode_features_tpu_torch.utils import (
        Experiment,
        load_checkpoint,
        peak_flops_per_chip,
        resolve_checkpoint,
        save_checkpoint,
    )

    def device_ms_by_kernel(fn, keys, reps: int = 20) -> dict:
        """Mean device ms per launch of each kernel named by one of
        ``keys`` (``torch.profiler`` over ``reps`` warm calls,
        ``conv_probe.device_us``)."""
        return {k: v / 1e3
                for k, v in conv_probe.device_us(fn, keys, reps).items()}

    def captured_launches(fn):
        """The kernels one call ``fn`` launches, as launched: the call
        captured into a CUDA graph (not run) and the graph's kernel nodes
        read back through libcuda (``attempt_graph.kernel_launches``):
        ``[(name, grid, block, shared, cluster)]``.  The launch counters
        are left as they were."""
        from neural_ode_features_tpu_torch.solver import attempt_graph

        before = (odefunc.launches, odefunc.launches_bf16,
                  odefunc_bwd.launches, odefunc_bwd.launches_bf16)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    fn()
                finally:
                    graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
            return attempt_graph.kernel_launches(graph.raw_cuda_graph(),
                                                 cluster=True)
        finally:
            graph.reset()
            (odefunc.launches, odefunc.launches_bf16, odefunc_bwd.launches,
             odefunc_bwd.launches_bf16) = before

    def ran_sample_pass(fn):
        """Which per-sample pass one backward call ``fn`` launches, and
        how, read from the call's captured kernel nodes
        (``captured_launches``).  Returns ``(pass, grid, block,
        shared, name)``, pass ``'cluster'`` (``bwd_sample_kernel_cluster``),
        ``'cta'`` (``bwd_sample_kernel``) or ``'rows'`` (the bf16 rows
        backward, read from its last per-sample kernel,
        ``rows_bwd_dh_kernel``), name the kernel's mangled
        name (its build: ``Li0EE`` f32, ``Li2EE`` bf16; the rows backward
        is bf16 only); fails unless the call launched
        exactly one of them, in clusters of two CTAs for the cluster pass
        and of one otherwise."""
        ran = [k for k in captured_launches(fn) if "bwd_sample_kernel" in k[0]
               or "rows_bwd_dh_kernel" in k[0]]
        if len(ran) != 1:
            fail(f"odefunc_bwd: one call launched the per-sample kernels "
                 f"{[k[0] for k in ran]}, not one")
        name, grid, block, shared, cluster = ran[0]
        pass_ = ("cluster" if "bwd_sample_kernel_cluster" in name
                 else "rows" if "rows_bwd_dh_kernel" in name else "cta")
        if cluster != ((2, 1, 1) if pass_ == "cluster" else (1, 1, 1)):
            fail(f"odefunc_bwd: the {pass_} pass {name} launched in "
                 f"clusters of {cluster}")
        return pass_, grid, block, shared, name

    def per_sample(fn, hw, c, b, key):
        """The rows builds' per-sample GroupNorm launches of one call
        ``fn`` (``key`` 'fwd': the bf16 ``odefunc``'s three, 'bwd': the
        bf16 backward's five), as launched (``captured_launches``): each a
        slice of whole groups a CTA, so the grid is ``b`` times
        ``rows_slices`` and a CTA ``rows_slice_threads`` threads, each
        launch read in clusters of one CTA (no cluster); fails otherwise.
        With their device ms a call (each kernel's mean per launch under
        ``torch.profiler`` times its
        launches; None where the profiler recorded none) and bytes bound
        (``utils/flops.py`` ``rows_sample_bounds``)."""
        from neural_ode_features_tpu_torch.probes.kernel_times import (
            ROWS_GN_BWD,
            ROWS_GN_FWD,
        )

        counts = ROWS_GN_FWD if key == "fwd" else ROWS_GN_BWD
        ran = [k for k in captured_launches(fn)
               if any(n in k[0] for n in counts)]
        grid = {n: b * rows_slices(G) for n in counts}
        name_of = {k[0]: next(n for n in counts if n in k[0]) for k in ran}
        if (len(ran) != sum(counts.values()) or any(
                (k[1], k[2], k[4]) != ((grid[name_of[k[0]]], 1, 1),
                                       (rows_slice_threads(G), 1, 1),
                                       (1, 1, 1))
                for k in ran)):
            fail(f"the rows {key} per-sample launches: "
                 f"{[(k[0], k[1], k[2], k[4]) for k in ran]}, not "
                 f"{sum(counts.values())} on grids {grid} of "
                 f"{rows_slice_threads(G)} threads, no cluster")
        try:
            us = conv_probe.device_us(fn, tuple(counts), 20)
            ms_ = sum(us[k] * n for k, n in counts.items()) / 1e3
        except RuntimeError as e:
            print(f"[width] torch.profiler: {e}; not measured")
            ms_ = None
        bd = rows_sample_bounds(hw, c, b, G)[key]
        shared = {name_of[k[0]]: k[3] for k in ran}
        cluster = {name_of[k[0]]: list(k[4]) for k in ran}
        return {"kernels": sorted(shared), "grid": grid,
                "block": [rows_slice_threads(G), 1, 1], "cluster": cluster,
                "slices": rows_slices(G), "shared_bytes": shared, "ms": ms_,
                "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                "bytes": bd["bytes"]}

    def profiled_ms(fn, keys):
        """``device_ms_by_kernel``, or None where torch.profiler recorded no
        launch of one of the kernels in three windows (it drops launches on
        this card, the more the later in the script): a reading beside the
        CUDA-event times, printed as not measured."""
        try:
            return device_ms_by_kernel(fn, keys)
        except RuntimeError as e:
            print(f"[time] torch.profiler: {e}; not measured")
            return None

    def read_counts():
        """The launch counters: the f32 builds' always, a bf16 build's
        where it launched (so an f32 path's launch rule fails on a bf16
        launch)."""
        bf16 = {"odefunc_bf16": odefunc.launches_bf16,
                "odefunc_bwd_bf16": odefunc_bwd.launches_bf16,
                "rk_step_bf16": dopri5_step.launches_bf16}
        return {"odefunc": odefunc.launches,
                "odefunc_bwd": odefunc_bwd.launches,
                "rk_step": dopri5_step.launches,
                **{k: v for k, v in bf16.items() if v}}

    def zero_counts():
        odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
        odefunc.launches_bf16 = dopri5_step.launches_bf16 = 0
        odefunc_bwd.launches_bf16 = 0

    def counted(fn):
        """``fn()`` with every launch counter set to 0 just before and read
        just after: ``(result, seconds, counts)``."""
        zero_counts()
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t_s, read_counts()

    def batch_attempts(nfe, evals: int = 6):
        """The attempts of a per-sample solve: f0 and the initial-step probe,
        then ``evals`` evaluations per attempt (dopri5 6, adams 2)."""
        return int(((nfe - 2) // evals).max())

    t_script = time.perf_counter()

    def phase_done(tag, t_start):
        now = time.perf_counter()
        print(f"[{tag}] phase took {now - t_start:.1f} s (script at "
              f"{now - t_script:.1f} s)")

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {torch.cuda.get_device_name(0)}")

    # 1. Build.
    t_build = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {len(logs)} kernel(s) built in "
          f"{time.perf_counter() - t_build:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 2. Kernel checks at the main path's shapes.
    fwd, (params, x) = entry(device="cuda", batch=B)
    w = prepare(params["odefunc"], (HH, WW))
    rng = np.random.default_rng(1)
    h = torch.from_numpy((rng.normal(size=(B, HH, WW, C)) * 0.3)
                         .astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.uniform(0, 1, B).astype(np.float32)).to(dev)
    err_k1 = close("odefunc", odefunc(w, t, h, groups=G),
                   odefunc_plain(w, t, h, G), **STATE_TOL)
    # The training batch, and one rank's rows of it under [parallel]'s two
    # data ranks.
    for nb in (B_TRAIN, B_TRAIN // 2):
        hn, tn = h[:nb].contiguous(), t[:nb].contiguous()
        err_k1 = max(err_k1, close(f"odefunc B={nb}",
                                   odefunc(w, tn, hn, groups=G),
                                   odefunc_plain(w, tn, hn, G), **STATE_TOL))

    t0 = torch.from_numpy(rng.uniform(0, 0.5, B).astype(np.float32)).to(dev)
    dt = torch.from_numpy(rng.uniform(0.05, 0.2, B).astype(np.float32)).to(dev)
    y0 = h.reshape(B, -1)
    f0 = odefunc_plain(w, t0, h, G).reshape(B, -1)
    # The tolerances as the kernel reads them: (B,) arrays.
    tol_rows = torch.full((B,), TOL, device=dev)
    step_kw = dict(hw=(HH, WW), groups=G, rtol=tol_rows, atol=tol_rows)
    err_k2 = 0.0
    # B_TRAIN // 2: one rank's rows of an evaluation batch under
    # [parallel]'s two data ranks; 5: a ragged batch.
    for nb in (B, B_TRAIN // 2, 5):
        kw_nb = dict(step_kw, rtol=tol_rows[:nb], atol=tol_rows[:nb])
        got = dopri5_step(w, DOPRI5, t0[:nb], dt[:nb], y0[:nb].contiguous(),
                          f0[:nb].contiguous(), **kw_nb)
        want = dopri5_step_plain(w, DOPRI5, t0[:nb], dt[:nb], y0[:nb],
                                 f0[:nb], **kw_nb)
        for name, g, r in zip(("y1", "f1", "y_mid"), got[:3], want[:3]):
            err_k2 = max(err_k2, close(f"rk_step {name} B={nb}", g, r,
                                       **STATE_TOL))
        close(f"rk_step ratio B={nb}", got[3], want[3], **RATIO_TOL)
    # Mixed per-row tolerances (the sweep's grid stacked on the batch axis):
    # against the plain version, and every row bit-identical to a launch at
    # that row's tolerance as one float.
    mixed = torch.tensor(SWEEP_TOLS, device=dev).repeat_interleave(
        B // len(SWEEP_TOLS))
    kw_mixed = dict(step_kw, rtol=mixed, atol=mixed)
    got = dopri5_step(w, DOPRI5, t0, dt, y0, f0, **kw_mixed)
    want = dopri5_step_plain(w, DOPRI5, t0, dt, y0, f0, **kw_mixed)
    for name, g, r in zip(("y1", "f1", "y_mid"), got[:3], want[:3]):
        close(f"rk_step {name} mixed tolerances", g, r, **STATE_TOL)
    close("rk_step ratio mixed tolerances", got[3], want[3], **RATIO_TOL)
    for tol in SWEEP_TOLS:
        one = dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                          **dict(step_kw, rtol=tol, atol=tol))
        sel = mixed == torch.tensor(tol, device=dev)
        if not all(torch.equal(a[sel], b[sel]) for a, b in zip(got, one)):
            fail(f"rk_step: rows at tolerance {tol} of a mixed launch differ "
                 "from a launch at that tolerance")
    torch.cuda.synchronize()
    print(f"[check] rk_step with (B,) tolerances {SWEEP_TOLS}: within "
          f"tolerance of the plain version; rows bit-identical to launches "
          f"at one float")
    print(f"[check] odefunc max abs err {err_k1:.3e} (B={B}, {B_TRAIN} and "
          f"{B_TRAIN // 2}); rk_step max abs err {err_k2:.3e} (B={B}, "
          f"{B_TRAIN // 2} and 5)")

    # The backward kernel against its plain version evaluated in float64 on
    # the same (upcast) inputs: in f32 the plain version's cuDNN
    # weight-gradient convs are themselves up to ~1e-2 off at B = 128, an
    # order of magnitude further from the f64 result than the kernel.
    hb = h[:B_TRAIN].contiguous()
    tb = t[:B_TRAIN].contiguous()
    gb = torch.from_numpy((rng.normal(size=hb.shape)).astype(np.float32)).to(dev)

    def check_bwd(w_, args, tag):
        """Hold one backward call against the f64 plain version; return dh's
        max abs err."""
        w64 = type(w_)(*(x.double() for x in w_))
        dp, dtk, dh, f_b = odefunc_bwd(w_, *args, groups=G, with_f=True)
        dp2 = odefunc_bwd(w_, *args, groups=G)[0]
        if not torch.equal(f_b, odefunc(w_, args[0], args[1], groups=G)):
            fail(f"odefunc_bwd f {tag}: differs from the ODEfunc kernel's")
        dp_p, dt_p, dh_p = odefunc_bwd_plain(w64, *(a.double() for a in args),
                                             G)
        dp_32 = odefunc_bwd_plain(w_, *args, G)[0]
        err_dh = close(f"odefunc_bwd dh {tag}", dh.double(), dh_p, **STATE_TOL)
        close(f"odefunc_bwd dt {tag}", dtk.double(), dt_p, **STATE_TOL)
        err_dp = close(f"odefunc_bwd dθ {tag}", flat(dp).double(),
                       flat(dp_p), **DP_TOL)
        err_32 = float((flat(dp_32).double() - flat(dp_p)).abs().max())
        if not torch.equal(flat(dp), flat(dp2)):
            fail(f"odefunc_bwd dθ {tag}: two launches differ")
        gate = sample_pass(tuple(args[1].shape[1:3]), args[1].shape[-1], G)
        pass_, grid, block, *_ = ran_sample_pass(
            lambda: odefunc_bwd(w_, *args, groups=G))
        if pass_ != gate:
            fail(f"odefunc_bwd {tag}: the {pass_} pass launched, the gate "
                 f"(sample_pass) says {gate}")
        print(f"[check] odefunc_bwd {tag} ({pass_} pass: {grid[0]} CTAs of "
              f"{block[0]} threads) vs the f64 plain "
              f"version: dθ max abs err {err_dp:.3e} (the f32 plain "
              f"version's: {err_32:.3e})")
        return err_dh

    err_k4 = 0.0
    # B_TRAIN // 2: one rank's rows under [parallel]'s two data ranks; 16:
    # [event-adjoint]'s batch; 5: a ragged batch; 1: one sample.
    bwd_batches = (B_TRAIN, B_TRAIN // 2, 16, 5, 1)
    for nb in bwd_batches:
        err_k4 = max(err_k4, check_bwd(
            w, (tb[:nb].contiguous(), hb[:nb].contiguous(),
                gb[:nb].contiguous()), f"B={nb}"))
    torch.cuda.synchronize()
    print(f"[check] odefunc_bwd dh max abs err {err_k4:.3e}; dt and dθ "
          f"within tolerance; f bit-identical to the ODEfunc kernel's; dθ "
          f"bit-identical across two launches (B={bwd_batches})")

    def check_weight_grads(w_, t_, h_, g_, tag):
        """Both builds' weight gradients (the tensor-core kernel) against
        ``weight_grad_emulated`` on the residuals each launch contracted:
        the largest excess over the build's own allowance (bf16: one bf16
        ulp of the larger), in units of the sum of |products| per entry,
        held to WEIGHT_GRAD_BAR."""
        out = {}
        for prec in ("f32", "bf16"):
            res = {}
            dp = odefunc_bwd(w_, t_, h_, g_, groups=G, precision=prec,
                             residuals=res)[0]
            worst = 0.0
            for conv, (r_, g2) in enumerate(((res["r1"], res["gu"]),
                                             (res["r2"], res["gv"]))):
                got = dp[f"conv{conv + 1}"]["kernel"][:, :, 1:, :]
                if not bool(torch.isfinite(got).all()):
                    fail(f"odefunc_bwd {prec} weight gradients {tag}: conv"
                         f"{conv + 1} holds values that are not finite")
                want = weight_grad_emulated(r_, g2, prec)
                diff = (got - want).abs()
                if prec == "bf16":
                    diff = (diff - 2.0 ** -7 * torch.maximum(
                        got.abs(), want.abs())).clamp_min(0.0)
                # An entry with no products (a zero scale) is held to its
                # difference itself; a NaN counts as the worst reading.
                scale = weight_grad_f64(r_, g2, True)
                diff = diff.double()
                ratio = torch.where(scale > 0, diff / scale, diff)
                worst = max(worst, float(torch.nan_to_num(
                    ratio, nan=float("inf")).max()))
            if worst > WEIGHT_GRAD_BAR:
                fail(f"odefunc_bwd {prec} weight gradients {tag}: "
                     f"{worst:.3e} of the sum of |products| from "
                     f"weight_grad_emulated, bar {WEIGHT_GRAD_BAR}")
            out[prec] = worst
        print(f"[check] odefunc_bwd weight gradients {tag} (tensor cores, "
              f"{weight_splits(h_.shape[0], h_.shape[-1])} chunks) against "
              f"weight_grad_emulated, in sums of |products|: f32 "
              f"{out['f32']:.3e}, bf16 beyond one ulp {out['bf16']:.3e} "
              f"(bar {WEIGHT_GRAD_BAR})")

    for nb in (B_TRAIN, B_TRAIN // 2, 5):
        check_weight_grads(w, tb[:nb].contiguous(), hb[:nb].contiguous(),
                           gb[:nb].contiguous(), f"{HH}x{WW}x{C} B={nb}")

    # The other shapes that the paths below give the fused kernels: the
    # fused sweep's launch (its grid of tolerances stacked on the batch axis,
    # 1,024 rows) at 7×7×64, and the MNIST block's 6×6×64 at B = 128
    # (training and its evaluation batches), B = 256 and 1,024 stacked rows
    # (the sweep).  The fused step takes the grid's tolerances, a quarter of
    # the rows each, as the stacked launch does; the backward kernel runs at
    # the training batch only.
    n_grid = len(SWEEP_TOLS)
    for hw_, nb in (((HH, WW), n_grid * B), ((6, 6), B_TRAIN), ((6, 6), B),
                    ((6, 6), n_grid * B)):
        tag = f"{hw_[0]}x{hw_[1]}x{C} B={nb}"
        w_ = prepare(params["odefunc"], hw_)
        h_ = torch.from_numpy((rng.normal(size=(nb, *hw_, C)) * 0.3)
                              .astype(np.float32)).to(dev)
        t_ = torch.from_numpy(rng.uniform(0, 0.5, nb)
                              .astype(np.float32)).to(dev)
        dt_ = torch.from_numpy(rng.uniform(0.05, 0.2, nb)
                               .astype(np.float32)).to(dev)
        f_ = odefunc_plain(w_, t_, h_, G)
        err_f = close(f"odefunc {tag}", odefunc(w_, t_, h_, groups=G), f_,
                      **STATE_TOL)
        tol_ = torch.tensor(SWEEP_TOLS, device=dev).repeat_interleave(
            nb // n_grid)
        kw_ = dict(hw=hw_, groups=G, rtol=tol_, atol=tol_)
        y_, f0_ = h_.reshape(nb, -1), f_.reshape(nb, -1)
        got = dopri5_step(w_, DOPRI5, t_, dt_, y_, f0_, **kw_)
        want = dopri5_step_plain(w_, DOPRI5, t_, dt_, y_, f0_, **kw_)
        err_s = max(close(f"rk_step {name} {tag}", g, r, **STATE_TOL)
                    for name, g, r in zip(("y1", "f1", "y_mid"), got[:3],
                                          want[:3]))
        close(f"rk_step ratio {tag}", got[3], want[3], **RATIO_TOL)
        print(f"[check] {tag}: odefunc max abs err {err_f:.3e}; rk_step at "
              f"tolerances {SWEEP_TOLS} max abs err {err_s:.3e}, ratio within "
              f"tolerance")
        if nb == B_TRAIN:
            g_ = torch.from_numpy(rng.normal(size=h_.shape)
                                  .astype(np.float32)).to(dev)
            check_bwd(w_, (t_, h_, g_), tag)
    torch.cuda.synchronize()

    # One augmented evaluation of the adjoint is one backward call.
    odefunc.launches = odefunc_bwd.launches = 0
    f_v = odefunc_vjp(w, tb, hb, gb, groups=G)[0]
    if (odefunc.launches, odefunc_bwd.launches) != (0, 1):
        fail(f"odefunc_vjp launched odefunc {odefunc.launches} and "
             f"odefunc_bwd {odefunc_bwd.launches} times, not 0 and 1")
    close("odefunc_vjp f", f_v, odefunc_plain(w, tb, hb, G), **STATE_TOL)

    # Where the backward call's time goes, by kernel (device time).
    bwd_keys = ("bwd_sample_kernel", "bwd_weight_kernel", "bwd_reduce_kernel")
    bwd_split = device_ms_by_kernel(
        lambda: odefunc_bwd(w, tb, hb, gb, groups=G), bwd_keys)
    bwd_dev = sum(bwd_split.values())
    bwd_kb = bwd_kernel_bounds((HH, WW), C, B_TRAIN,
                               weight_splits(B_TRAIN, C))
    print(f"[split] odefunc_bwd B={B_TRAIN}: device ms by kernel "
          + ", ".join(f"{k} {v:.4f} ({100 * v / bwd_dev:.0f}%; bound "
                      f"{bwd_kb[k]['bound_ms']:.4f} by {bwd_kb[k]['bound_by']},"
                      f" f32 FFMA {bwd_kb[k]['ffma_bound_ms']:.4f})"
                      for k, v in bwd_split.items())
          + f"; sum {bwd_dev:.4f}")
    # The per-sample pass: which one launched here, how (the driver's
    # record of the launch in a captured call) and its device ms beside its
    # bound.
    bwd_pass, grid, block, shared, _ = ran_sample_pass(
        lambda: odefunc_bwd(w, tb, hb, gb, groups=G))
    if bwd_pass != "cluster":
        fail(f"odefunc_bwd at {HH}x{WW}x{C}: the f32 per-sample pass that "
             f"launched is {bwd_pass!r}, not the cluster")
    sample_pass_info = {
        "pass": bwd_pass, "grid": grid[0], "block": block[0],
        "smem_bytes": shared, "ms": bwd_split["bwd_sample_kernel"],
        "bound_ms": bwd_kb["bwd_sample_kernel"]["bound_ms"]}
    print(f"[split] the per-sample pass at B={B_TRAIN}: "
          f"bwd_sample_kernel_cluster launched {grid[0]} CTAs of {block[0]} "
          f"threads and {shared} B of dynamic shared memory (clusters of two "
          f"as read from the captured node, its convs on wgmma): "
          f"{sample_pass_info['ms']:.4f} ms, bound "
          f"{sample_pass_info['bound_ms']:.4f} ms "
          f"({sample_pass_info['ms'] / sample_pass_info['bound_ms']:.1f}×)")

    # The weight gradients' kernel on its own (the path's at C >= 64,
    # bwd_weight_kernel on wgmma): its machine code holds warpgroup products
    # and no mma.sync, and weight_reading below.
    from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
        weight_kernel,
        wgmma_weights_ok,
    )
    from neural_ode_features_tpu_torch.probes.timing_aids import (
        bwd_weight_partials,
        odefunc_bwd_mma_weights,
    )

    wsass = kernel_sass("odefunc_bwd", "17bwd_weight_kernel")
    if "HGMMA" not in wsass or "HMMA" in wsass:
        fail("bwd_weight_kernel's machine code: expected HGMMA and no HMMA")

    def weight_reading(w_, t_, h_, g_, tag, reps):
        """The path's weight kernel at this shape (``weight_kernel``:
        ``route``) and bwd_weight_kernel (wgmma) against the mma.sync
        kernel (``bwd_weight_kernel_mma``, what bwd_weight_kernel replaced
        where C % 64 == 0): in both builds dθ of the call and of the
        reading with the mma.sync kernel (``odefunc_bwd_mma_weights``) bit
        for bit, the row chunks of the two kernels launched alone on the
        same residuals bit for bit, and their device ms in turns
        (mma.sync, wgmma, wgmma, mma.sync) beside the bound.  Returns the
        reading."""
        hw_, c_, nb_ = tuple(h_.shape[1:3]), h_.shape[-1], h_.shape[0]
        info = {"name": "bwd_weight_kernel", "route": weight_kernel(hw_, c_),
                "mma_kernel": "bwd_weight_kernel_mma"}
        # bwd_weight_kernel takes C >= 64; at C = 32 the mma.sync kernel
        # alone, in all four turns.
        wg_ = "wgmma" if wgmma_weights_ok(hw_, c_) else "mma"
        for prec in ("f32", "bf16"):
            res_w = {}
            dp_w = odefunc_bwd(w_, t_, h_, g_, groups=G, precision=prec,
                               residuals=res_w)[0]
            dm_w = odefunc_bwd_mma_weights(w_, t_, h_, g_, G, prec)[0]
            part_w = bwd_weight_partials(res_w, prec, wg_)
            if not (torch.equal(flat(dp_w), flat(dm_w)) and torch.equal(
                    part_w, bwd_weight_partials(res_w, prec, "mma"))):
                fail(f"bwd_weight_kernel {prec} {tag}: dθ or the row chunks "
                     "differ from the mma.sync kernel's")
            turns_w = [device_ms(lambda k=k: bwd_weight_partials(
                res_w, prec, k, out=part_w), reps=reps)
                for k in ("mma", wg_, wg_, "mma")]
            kbw = bwd_kernel_bounds(
                hw_, c_, nb_, weight_splits(nb_, c_),
                H100_BF16_FLOPS if prec == "bf16" else H100_TF32_FLOPS)[
                    "bwd_weight_kernel"]
            key = "" if prec == "f32" else "bf16_"
            info.update({f"{key}ms": (turns_w[1] + turns_w[2]) / 2,
                         f"{key}mma_ms": (turns_w[0] + turns_w[3]) / 2,
                         f"{key}turns_ms": turns_w,
                         f"{key}bound_ms": kbw["bound_ms"],
                         f"{key}bound_by": kbw["bound_by"]})
            print(f"[weights] {tag} bwd_weight_kernel {prec} ({info['route']}"
                  f" on the path) alone, device ms in turns (mma.sync, "
                  f"wgmma, wgmma, mma.sync): " + ", ".join(f"{v:.4f}" for v in turns_w)
                  + f"; bound {kbw['bound_ms']:.4f} by {kbw['bound_by']}; dθ"
                  " and row chunks bit for bit the mma.sync kernel's")
        return info

    if weight_kernel((HH, WW), C) != "wgmma":
        fail(f"the weight gradients at {HH}x{WW}x{C} do not run "
             "bwd_weight_kernel (wgmma)")
    weight_info = weight_reading(w, tb, hb, gb, f"{HH}x{WW}x{C} B={B_TRAIN}",
                                 reps=50)
    print("[split] bwd_weight_kernel: HGMMA in its machine code, no HMMA; "
          f"{weight_info['ms']:.4f} ms f32, {weight_info['bf16_ms']:.4f} "
          f"bf16 alone (the mma.sync kernel {weight_info['mma_ms']:.4f}, "
          f"{weight_info['bf16_mma_ms']:.4f}); bound "
          f"{weight_info['bound_ms']:.4f}, {weight_info['bf16_bound_ms']:.4f}")

    # The conv probe kernels against the plain version, in f32 and in
    # float64 on the same inputs (upcast).
    err_k5 = 0.0
    for nb, hw in ((B, (HH, WW)), (5, (HH, WW)), (B, (6, 6))):
        xc, wc = conv_probe.probe_inputs(nb, dev, hw)
        plain = conv3x3_plain(xc, wc)
        plain64 = conv3x3_plain(xc.double(), wc.double())
        errs64 = {}
        for strategy in STRATEGIES:
            tol = TF32_TOL if strategy == "mma1" else CONV_TOL
            got = conv3x3(xc, wc, strategy)
            tag = f"conv_probe {strategy} B={nb} {hw[0]}x{hw[1]}"
            err = close(tag, got, plain, **tol)
            errs64[strategy] = close(f"{tag} (f64 plain)", got.double(),
                                     plain64, **tol)
            if strategy != "mma1":
                err_k5 = max(err_k5, err)
            print(f"[check] {tag}: max abs err {err:.3e} vs plain, "
                  f"{errs64[strategy]:.3e} vs the f64 plain version (the f32 "
                  f"plain version's: "
                  f"{float((plain.double() - plain64).abs().max()):.3e})")
        print(f"[check] conv B={nb} {hw[0]}x{hw[1]} vs the f64 plain version: "
              f"wgmma3 {errs64['wgmma3']:.3e} beside mma3 {errs64['mma3']:.3e} "
              f"(bar {conv_probe.WGMMA_BAR}x mma3's) and tap9 "
              f"{errs64['tap9']:.3e} (each within rtol {CONV_TOL['rtol']}, "
              f"atol {CONV_TOL['atol']}); mma1 {errs64['mma1']:.3e} (plain "
              f"TF32, rtol {TF32_TOL['rtol']}, atol {TF32_TOL['atol']})")
        if errs64["wgmma3"] > conv_probe.WGMMA_BAR * errs64["mma3"]:
            fail(f"conv_probe wgmma3 B={nb} {hw[0]}x{hw[1]}: "
                 f"{errs64['wgmma3']:.3e} against the f64 conv, over "
                 f"{conv_probe.WGMMA_BAR} x mma3's {errs64['mma3']:.3e}")
    torch.cuda.synchronize()

    # The probe's own path, the five-strategy race at B = 256 and B = 128,
    # counter from 0 (the bf16 twins race in [bf16]).
    conv3x3.launches = 0
    probe = conv_probe.main([*STRATEGIES, "--batch", f"{B},{B_TRAIN}"])
    probe_launches = conv3x3.launches
    print(f"[probe] conv3x3 launches {probe_launches}")
    if probe_launches < 2 * 2 * len(STRATEGIES):
        fail(f"the probe launched the conv kernels {probe_launches} times")
    for nb, res in probe["batches"].items():
        if not (res["mma3"]["device_us"] < res["tap9"]["device_us"]
                and res["mma3"]["device_us"] < res["library_us"]):
            fail(f"the probe at B={nb}: mma3 {res['mma3']['device_us']:.1f} us "
                 f"is not below tap9 {res['tap9']['device_us']:.1f} us and "
                 f"F.conv2d {res['library_us']:.1f} us")

    print(f"[checks] done at {time.perf_counter() - t_script:.1f} s")
    # 3. Main path, counters from 0.
    (logits, nfe), t_main, launches = counted(lambda: fwd(params, x))
    attempts = batch_attempts(nfe)
    print(f"[main] B={B}: {t_main:.3f} s (first call), launches {launches}, "
          f"attempts {attempts}, NFE mean {float(nfe.float().mean()):.2f} "
          f"min {int(nfe.min())} max {int(nfe.max())}")
    if launches["odefunc"] != 2:
        fail(f"odefunc kernel launched {launches['odefunc']} times, not 2")
    if launches["rk_step"] != attempts or attempts < 1:
        fail(f"rk_step kernel launched {launches['rk_step']} times for "
             f"{attempts} attempts")
    if launches["odefunc_bwd"] != 0:
        fail(f"odefunc_bwd launched {launches['odefunc_bwd']} times in an "
             "inference solve")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on")
    if tuple(logits.shape) != (B, 10) or not bool(torch.isfinite(logits).all()):
        fail(f"logits {tuple(logits.shape)} not finite (B, 10)")

    cfg = ENTRY_CONFIG
    ts = torch.tensor([0.0, 1.0], device=dev)

    def plain_forward():
        h0 = stem_apply(params["stem"], x, cfg)
        traj, stats = odeint(
            lambda tt, y: odefunc_plain(w, tt, y, G), h0, ts, rtol=TOL,
            atol=TOL, method="dopri5", error_control="per_sample",
            max_steps=cfg.max_steps)
        return head_apply(params["head"], traj[-1], cfg), stats.nfe

    logits_p, nfe_p = plain_forward()
    same = nfe == nfe_p
    share = float(same.float().mean())
    mean_k, mean_p = float(nfe.float().mean()), float(nfe_p.float().mean())
    print(f"[main] plain path: NFE equal on {share:.4f} of samples, mean "
          f"{mean_k:.3f} (kernels) vs {mean_p:.3f} (plain)")
    if share < 0.99 or abs(mean_k - mean_p) > 0.01 * mean_p:
        fail("per-sample NFE differs from the plain path")
    logit_err = float((logits[same] - logits_p[same]).abs().max())
    if not torch.allclose(logits[same], logits_p[same], rtol=1e-3, atol=1e-3):
        fail(f"logits differ from the plain path: max abs err {logit_err:.3e}")
    print(f"[main] logits vs plain path: max abs err {logit_err:.3e}")
    main_mean_nfe = mean_k  # [bench]'s default record must report it

    # [adams]: the entry model with the adaptive Adams solver, counters from
    # 0: one ODEfunc launch per dynamics evaluation (f0, the initial-step
    # probe, then a predict and a correct per attempt), no fused step.
    t_ph = time.perf_counter()
    acfg = dataclasses.replace(cfg, method="adams")
    with torch.no_grad():
        (logits_a, stats_a), t_a, got = counted(
            lambda: odenet_logits(params, x, acfg))
        traj_pa, stats_pa = odeint(
            lambda tt, y: odefunc_plain(w, tt, y, G),
            stem_apply(params["stem"], x, cfg), ts, rtol=TOL, atol=TOL,
            method="adams", error_control="per_sample",
            max_steps=cfg.max_steps)
        logits_pa = head_apply(params["head"], traj_pa[-1], cfg)
    adams_launches = got
    att_a = batch_attempts(stats_a.nfe, 2)
    want = {"odefunc": 2 + 2 * att_a, "odefunc_bwd": 0, "rk_step": 0}
    same_a = stats_a.nfe == stats_pa.nfe
    share_a = float(same_a.float().mean())
    err_a = float((logits_a[same_a] - logits_pa[same_a]).abs().max())
    print(f"[adams] B={B} tol {TOL}: {t_a:.3f} s (first call), launches "
          f"{got}, attempts {att_a}, NFE mean "
          f"{float(stats_a.nfe.float().mean()):.2f} min "
          f"{int(stats_a.nfe.min())} max {int(stats_a.nfe.max())}; vs the "
          f"plain path: NFE equal on {share_a:.4f} of samples, logits max "
          f"abs err {err_a:.3e}")
    if got != want:
        fail(f"[adams] launches {got}, expected {want}")
    if not bool(stats_a.success.all()) or share_a < 0.99 or not (
            torch.allclose(logits_a[same_a], logits_pa[same_a], rtol=1e-3,
                           atol=1e-3)):
        fail("[adams] the solve disagrees with the plain path")
    # The Adams solve beside dopri5's (the fused step), in turns, warm.
    solve_t = {"dopri5": [], "adams": []}
    with torch.no_grad():
        for _ in range(3):
            for tag, fn in (("dopri5", lambda: fwd(params, x)),
                            ("adams", lambda: odenet_logits(params, x,
                                                            acfg))):
                torch.cuda.synchronize()
                t_s = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                solve_t[tag].append(time.perf_counter() - t_s)
    print(f"[adams] whole solve B={B} tol {TOL}, in turns: adams "
          f"{B / statistics.median(solve_t['adams']):.1f} img/s (median of "
          f"{solve_t['adams']}), NFE mean "
          f"{float(stats_a.nfe.float().mean()):.2f}; dopri5 "
          f"{B / statistics.median(solve_t['dopri5']):.1f} img/s (median of "
          f"{solve_t['dopri5']}), NFE mean {float(nfe.float().mean()):.2f}")
    phase_done("adams", t_ph)

    # [event]: odeint_event on the ODE-Net block, per sample, B = 256: each
    # row stops where mean(h²) crosses the midpoint m_b of its values at
    # t = 0 and t = 1 on a plain solve, so every row brackets a crossing.
    # The ODEfunc kernel once per stage evaluation (no fused step: the event
    # test needs the step's interpolant), against the plain dynamics.
    t_ph = time.perf_counter()

    def energy(hh):
        return (hh * hh).mean(dim=(1, 2, 3))

    with torch.no_grad():
        h0_e = stem_apply(params["stem"], x, cfg)
        traj_e, _ = odeint(lambda tt, y: odefunc_plain(w, tt, y, G), h0_e,
                           ts, rtol=TOL, atol=TOL, error_control="per_sample",
                           max_steps=cfg.max_steps)
        mid_e = 0.5 * (energy(traj_e[0]) + energy(traj_e[-1]))
        ev_kw = dict(t_max=1.0, rtol=TOL, atol=TOL,
                     error_control="per_sample", max_steps=cfg.max_steps)

        def event_solve(dyn):
            return odeint_event(dyn, h0_e, 0.0,
                                lambda tt, hh: energy(hh) - mid_e, **ev_kw)

        sol_k, t_ev, got = counted(lambda: event_solve(
            lambda tt, y: odefunc(w, tt, y, groups=G)))
        sol_p = event_solve(lambda tt, y: odefunc_plain(w, tt, y, G))
    event_launches = got
    att_e = batch_attempts(sol_k.stats.nfe)
    want = {"odefunc": 2 + 6 * att_e, "odefunc_bwd": 0, "rk_step": 0}
    fired_share = float(sol_k.fired.float().mean())
    same_e = (sol_k.stats.nfe == sol_p.stats.nfe) & sol_k.fired & sol_p.fired
    err_te = float((sol_k.t_event[same_e] - sol_p.t_event[same_e]).abs().max())
    print(f"[event] B={B} tol {TOL}: {t_ev:.3f} s (first call), launches "
          f"{got}, attempts {att_e}; fired on {fired_share:.4f} of rows, "
          f"t_event {float(sol_k.t_event.min()):.4f}..."
          f"{float(sol_k.t_event.max()):.4f}; vs the plain path: NFE equal on "
          f"{float(same_e.float().mean()):.4f} of rows, t_event max abs err "
          f"{err_te:.3e}")
    if got != want:
        fail(f"[event] launches {got}, expected {want}")
    if (fired_share < 0.99 or float(same_e.float().mean()) < 0.99
            or err_te > 1e-4):
        fail("[event] the event solve disagrees with the plain path")
    # The event solve beside an odeint over the same span and dynamics.
    ev_t, ode_t = [], []
    with torch.no_grad():
        for _ in range(3):
            for acc, fn in ((ev_t, lambda: event_solve(
                    lambda tt, y: odefunc(w, tt, y, groups=G))),
                            (ode_t, lambda: odeint(
                                lambda tt, y: odefunc(w, tt, y, groups=G),
                                h0_e, ts, rtol=TOL, atol=TOL,
                                error_control="per_sample",
                                max_steps=cfg.max_steps))):
                torch.cuda.synchronize()
                t_s = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                acc.append(time.perf_counter() - t_s)
    print(f"[event] in turns: odeint_event {1e3 * statistics.median(ev_t):.2f}"
          f" ms (median of {ev_t}) against odeint over [0, 1] with the same "
          f"dynamics {1e3 * statistics.median(ode_t):.2f} ms (median of "
          f"{ode_t})")
    phase_done("event", t_ph)

    # [event-adjoint]: d(Σ t_event)/dθ through the kernel pair (the re-solve's
    # vjp= from models.block_dynamics), B = 16, tol 1e-5, against the plain
    # path in float64 (autograd through odefunc_plain).
    t_ph = time.perf_counter()
    with torch.no_grad():
        h16 = stem_apply(params["stem"], x[:16], cfg)
        traj16, _ = odeint(lambda tt, y: odefunc_plain(w, tt, y, G), h16, ts,
                           rtol=1e-5, atol=1e-5, error_control="per_sample",
                           max_steps=cfg.max_steps)
        mid16 = 0.5 * (energy(traj16[0]) + energy(traj16[-1]))

    def tstar_grads(dtype, kernels):
        ps = {k: {kk: v.detach().to(dtype).requires_grad_()
                  for kk, v in d.items()}
              for k, d in params["odefunc"].items()}
        if kernels:
            dyn_, vjp_ = block_dynamics(ps, h16, cfg)
        else:
            vjp_ = None

            def dyn_(p, tt, y):
                return odefunc_plain(prepare(p, (HH, WW)), tt, y, G)
        sol = odeint_event_adjoint(
            dyn_, ps, h16.to(dtype), 0.0,
            lambda tt, hh: energy(hh) - mid16.to(dtype), t_max=1.0,
            rtol=1e-5, atol=1e-5, error_control="per_sample",
            max_steps=cfg.max_steps, vjp=vjp_)
        grads = torch.autograd.grad(sol.t_event.sum(), leaves(ps))
        return sol, torch.cat([g_.reshape(-1) for g_ in grads])

    (sol_ka, g_ka), t_ea, got = counted(lambda: tstar_grads(torch.float32,
                                                            True))
    event_adjoint_launches = got
    sol_pa, g_pa = tstar_grads(torch.float64, False)
    err_ta = float((sol_ka.t_event.double() - sol_pa.t_event).abs().max())
    rel, cos = gradient_bar("[event-adjoint] dΣt*/dθ vs the f64 plain path",
                            g_ka, g_pa)
    print(f"[event-adjoint] B=16 tol 1e-5: {t_ea:.3f} s, launches {got}; "
          f"fired {int(sol_ka.fired.sum())}/16, t_event vs the f64 plain path "
          f"max abs err {err_ta:.3e}; gradients rel-L2 {rel:.3e}, cosine "
          f"{cos:.8f}")
    if (got["odefunc"] < 1 or got["odefunc_bwd"] < 1 or got["rk_step"]
            or not bool(sol_ka.fired.all()) or err_ta > 1e-4):
        fail(f"[event-adjoint] launches {got} or t_event off")
    phase_done("event-adjoint", t_ph)

    print(f"[main] done at {time.perf_counter() - t_script:.1f} s")
    # 4. Training-path parity: kernels against the plain path on the card.
    trainer, (images, labels) = train_entry(device="cuda", batch=B_TRAIN)
    tp = trainer.params
    mcfg = dataclasses.replace(trainer.model_cfg, tol=1e-5,
                               error_control="global", max_steps=512)
    xs = normalize(torch.from_numpy(images[:16]).to(dev), trainer.cfg.dataset)
    ys = torch.from_numpy(labels[:16]).to(dev)
    def adjoint_grads(logits, scale=1.0):
        loss = scale * F.cross_entropy(logits, ys)
        grads = torch.autograd.grad(loss, leaves(tp))
        return float(loss.detach()), torch.cat([g.reshape(-1) for g in grads])

    logits_k, stats_k = odenet_logits(tp, xs, mcfg, adjoint=True)
    loss_k, grads_k = adjoint_grads(logits_k)
    nfe_b_k = int(stats_k.nfe_b)
    h0 = stem_apply(tp["stem"], xs, mcfg)
    traj, _ = odeint_adjoint(
        lambda p, tt, y: odefunc_plain(prepare(p, (HH, WW)), tt, y, G),
        tp["odefunc"], h0, torch.tensor([0.0, 1.0], device=dev),
        rtol=mcfg.tol, atol=mcfg.tol, error_control="global",
        max_steps=mcfg.max_steps)
    loss_p, grads_p = adjoint_grads(head_apply(tp["head"], traj[-1], mcfg))
    if not np.isclose(loss_k, loss_p, rtol=1e-5, atol=0):
        fail(f"adjoint loss {loss_k} (kernels) vs {loss_p} (plain)")
    rel, cos = gradient_bar("adjoint gradients vs plain", grads_k, grads_p)
    print(f"[train] parity B=16 tol 1e-5 global: loss {loss_k:.7f} vs "
          f"{loss_p:.7f} plain; gradients rel-L2 {rel:.3e}, cosine {cos:.8f}")

    # The other adjoint variants on the same batch against the
    # reintegrating adjoint's gradients (before the weights are trained).
    # Both change what the backward solve's error norm sees: the seminorm
    # leaves a_θ out and the interpolated adjoint leaves y out, so what is
    # left is held to atol + rtol·|a|, and at the mean loss's scale (|a_y|
    # about 1e-4) atol = 1e-5 resolves it to a few percent only (a property
    # of the methods at rtol = atol, the same in the JAX package).  So they
    # are held to the bar at a loss scaled by LOSS_SCALE, where rtol
    # governs, and the readings at the mean loss's scale are printed.
    def variant_grads(change, scale):
        odefunc_bwd.launches = 0
        logits_v, stats_v = odenet_logits(
            tp, xs, dataclasses.replace(mcfg, **change), adjoint=True)
        loss_v, grads_v = adjoint_grads(logits_v, scale)
        if odefunc_bwd.launches != int(stats_v.nfe_b) - 1:
            fail(f"[train-cli] {change}: odefunc_bwd launched "
                 f"{odefunc_bwd.launches} times for nfe_b "
                 f"{int(stats_v.nfe_b)}")
        return loss_v, grads_v, int(stats_v.nfe_b)

    scaled = variant_grads({}, LOSS_SCALE)
    for scale, (loss_r, grads_r, nfe_b_r) in (
            (1.0, (loss_k, grads_k, nfe_b_k)), (LOSS_SCALE, scaled)):
        for tag, change in (("seminorm", dict(adjoint_seminorm=True)),
                            ("interpolated",
                             dict(adjoint_mode="interpolated"))):
            loss_v, grads_v, nfe_b_v = variant_grads(change, scale)
            if scale == 1.0:
                rel = float((grads_v - grads_r).double().norm()
                            / grads_r.double().norm())
                verdict = f"rel-L2 {rel:.3e} (a reading)"
            else:
                rel, cos = gradient_bar(f"{tag} adjoint gradients", grads_v,
                                        grads_r)
                verdict = f"rel-L2 {rel:.3e}, cosine {cos:.8f}"
                if tag == "seminorm" and nfe_b_v > nfe_b_r:
                    fail(f"seminorm nfe_b {nfe_b_v} above the full norm's "
                         f"{nfe_b_r} on the fixed batch, loss x{scale:g}")
            print(f"[train-cli] {tag} vs reintegrating adjoint, B=16 tol "
                  f"1e-5 global, loss x{scale:g}: loss {loss_v:.7f} vs "
                  f"{loss_r:.7f}; gradients {verdict}; nfe_b {nfe_b_v} vs "
                  f"{nfe_b_r}")

    print(f"[train parity] done at {time.perf_counter() - t_script:.1f} s")
    # 5. The training path at full width, counters from 0 before each step.
    train_launches, nfe_f, nfe_b = [], [], []
    for step in range(5):
        odefunc.launches = odefunc_bwd.launches = dopri5_step.launches = 0
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        m = trainer.train_batch(images, labels)
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t_s
        got = {"odefunc": odefunc.launches, "odefunc_bwd": odefunc_bwd.launches,
               "rk_step": dopri5_step.launches}
        attempts = int(((trainer.last_stats.nfe - 2) // 6).max())
        nb_ = int(m["nfe_b"])
        print(f"[train] step {step}: {t_s:.3f} s, loss {m['loss']:.5f}, "
              f"NFE-f mean {m['nfe']:.2f}, NFE-b {nb_}, attempts {attempts}, "
              f"launches {got}")
        want = {"odefunc": 2 + 6 * attempts + 1, "odefunc_bwd": nb_ - 1,
                "rk_step": 0}
        if got != want or nb_ < 2:
            fail(f"train step {step}: launches {got}, expected {want}")
        if not np.isfinite(m["loss"]):
            fail(f"train step {step}: loss {m['loss']}")
        if not all(bool(torch.isfinite(p.grad).all())
                   for p in trainer._leaves):
            fail(f"train step {step}: a gradient is not finite")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail("TF32 is on")
        train_launches.append(got)
        nfe_f.append(m["nfe"])
        nfe_b.append(nb_)

    print(f"[train] done at {time.perf_counter() - t_script:.1f} s")
    # 6. The extraction path on the trained parameters, counters from 0.
    dataset = trainer.cfg.dataset
    ecfg = trainer.model_cfg
    t_s = time.perf_counter()
    test_images, test_labels = load_dataset(dataset, "test")
    print(f"[extract] {dataset} test split: {len(test_images)} images "
          f"generated in {time.perf_counter() - t_s:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ckpt_best.pt"
        save_checkpoint(ckpt, trainer.params, ecfg,
                        {"model": "odenet", "train": {"dataset": dataset}})
        eparams, ecfg_l, extra = load_checkpoint(ckpt)
    if ecfg_l != ecfg or extra["train"]["dataset"] != dataset:
        fail("the checkpoint's sidecar did not round-trip")
    for a, b_ in zip(leaves(eparams), leaves(trainer.params)):
        if a.device.type != "cuda" or not torch.equal(a, b_.detach()):
            fail("the checkpoint's parameters did not round-trip")
    ekw = dict(dataset=dataset, timestamps=T_OUT, batch_size=B)

    # One full batch: the counters exactly.
    first, _, got = counted(lambda: extract_features(
        eparams, ecfg, test_images[:B], test_labels[:B], **ekw))
    want = {"odefunc": 2, "odefunc_bwd": 0,
            "rk_step": batch_attempts(first["nfe"])}
    print(f"[extract] first batch B={B} T={T_OUT}: launches {got}")
    if got != want or want["rk_step"] < 1:
        fail(f"extraction batch: launches {got}, expected {want}")

    # The whole split.
    feats, t_all, got = counted(lambda: extract_features(
        eparams, ecfg, test_images, test_labels, **ekw))
    extract_launches = got
    n_img = len(test_images)
    n_batches = -(-n_img // B)
    n_full = n_img // B
    full_attempts = sum(batch_attempts(feats["nfe"][i * B:(i + 1) * B])
                        for i in range(n_full))
    last_attempts = got["rk_step"] - full_attempts
    print(f"[extract] {n_img} images, {n_batches} batches of {B} (last: "
          f"{n_img - n_full * B} valid), T={T_OUT}: {t_all:.2f} s, "
          f"{n_img / t_all:.1f} img/s with loading and copies; launches "
          f"{got}; NFE mean {feats['nfe'].mean():.2f} min "
          f"{feats['nfe'].min()} max {feats['nfe'].max()}")
    if got["odefunc"] != 2 * n_batches or got["odefunc_bwd"] != 0:
        fail(f"extraction: launches {got} over {n_batches} batches")
    if n_full < n_batches and last_attempts < batch_attempts(
            feats["nfe"][n_full * B:]):
        fail(f"extraction: {got['rk_step']} fused steps, of which "
             f"{full_attempts} in the full batches")
    if n_full == n_batches and last_attempts != 0:
        fail(f"extraction: {got['rk_step']} fused steps for "
             f"{full_attempts} attempts")
    if (feats["features"].shape != (T_OUT, n_img, C)
            or not np.isfinite(feats["features"]).all()
            or not np.array_equal(feats["labels"], test_labels)
            or not np.array_equal(feats["features"][:, :B],
                                  first["features"])):
        fail("extraction: features are not finite (T, N, C) in dataset order")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on")

    # The ends of the trajectory, and the plain path, on the first batch.
    with torch.no_grad():
        x0 = normalize(torch.from_numpy(test_images[:B]).to(dev), dataset)
        h0 = stem_apply(eparams["stem"], x0, ecfg)
        ends, _ = odenet_trajectory(eparams, x0, [0.0, 1.0], ecfg)
        we = prepare(eparams["odefunc"], (HH, WW))
        traj_p, stats_p = odeint(
            lambda tt, y: odefunc_plain(we, tt, y, G), h0,
            torch.from_numpy(feats["t"]).to(dev), rtol=ecfg.tol,
            atol=ecfg.tol, method="dopri5", error_control="per_sample",
            max_steps=ecfg.max_steps)
        feats_p = pool_features(traj_p).cpu().numpy()
    fb = feats["features"][:, :B]
    err_0 = float(np.abs(fb[0] - pool_features(h0).cpu().numpy()).max())
    err_1 = float(np.abs(fb[-1] - pool_features(ends[-1]).cpu().numpy()).max())
    same = feats["nfe"][:B] == stats_p.nfe.cpu().numpy()
    err_p = float(np.abs(fb[:, same] - feats_p[:, same]).max())
    print(f"[extract] features[0] vs pooled stem output: max abs err "
          f"{err_0:.3e}; features[-1] vs the pooled T=2 state: {err_1:.3e}; "
          f"vs the plain path: NFE equal on {same.mean():.4f} of samples, "
          f"features max abs err {err_p:.3e}")
    if err_0 > 1e-5 or err_1 > 1e-5:
        fail("extraction: the trajectory's ends are off")
    if same.mean() < 0.99 or not np.allclose(fb[:, same], feats_p[:, same],
                                             rtol=1e-3, atol=1e-3):
        fail("extraction: features differ from the plain path")

    # The ragged last batch against the same images inside a full batch.
    tail = n_img - n_full * B
    if tail:
        full = extract_features(eparams, ecfg, test_images[-B:],
                                test_labels[-B:], **ekw)
        err_t = float(np.abs(full["features"][:, -tail:]
                             - feats["features"][:, -tail:]).max())
        print(f"[extract] last batch ({tail} valid of {B}) vs the same "
              f"images in a full batch: max abs err {err_t:.3e}")
        if err_t > 1e-6 or not np.array_equal(full["nfe"][-tail:],
                                              feats["nfe"][-tail:]):
            fail("extraction: a padded batch changes its valid rows")

    # nfe_sort gives the same file in the dataset's order.
    sorted_, t_sort, _ = counted(lambda: extract_features(
        eparams, ecfg, test_images, test_labels, nfe_sort=True, **ekw))
    err_s = float(np.abs(sorted_["features"] - feats["features"]).max())
    print(f"[extract] nfe_sort: {t_sort:.2f} s, max abs err {err_s:.3e} "
          f"against the unsorted run")
    if (err_s > 1e-6 or not np.array_equal(sorted_["nfe"], feats["nfe"])
            or not np.array_equal(sorted_["labels"], feats["labels"])):
        fail("extraction: nfe_sort changes the file")

    # The solve-once, query-any-t API on the card at a small step budget
    # (the coefficient buffer is 16 MB per step slot at B = 256): the
    # ODEfunc kernel per stage, no fused step; y(t) against the trajectory.
    with torch.no_grad():
        odefunc.launches = dopri5_step.launches = 0
        y_at, dstats = odeint_dense(
            lambda tt, y: odefunc(we, tt, y, groups=G), h0, 0.0, 1.0,
            rtol=ecfg.tol, atol=ecfg.tol, error_control="per_sample",
            max_steps=16)
        feats_d = pool_features(
            y_at(torch.from_numpy(feats["t"]).to(dev))).cpu().numpy()
    sol = y_at.__wrapped_sol__
    err_d = float(np.abs(feats_d - fb).max())
    print(f"[dense] odeint_dense B={B} max_steps=16: coefficient buffer "
          f"{sol.coeffs.numel() * 4 / 1e6:.0f} MB, accepted steps "
          f"{int(dstats.naccept.min())}..{int(dstats.naccept.max())}, "
          f"launches odefunc {odefunc.launches} rk_step "
          f"{dopri5_step.launches}; features at {T_OUT} times vs the "
          f"trajectory: max abs err {err_d:.3e}")
    if (not bool(dstats.success.all()) or dopri5_step.launches != 0
            or odefunc.launches != 2 + 6 * int((dstats.naccept
                                                + dstats.nreject).max())
            or not np.allclose(feats_d, fb, rtol=1e-3, atol=1e-3)):
        fail("odeint_dense on the card disagrees with the trajectory")

    # The feature file, and the metrics per t on the card.
    with tempfile.TemporaryDirectory() as tmp:
        path = save_features(Path(tmp) / "features_test.npz", **feats,
                             dataset=dataset, model="odenet", tol=ecfg.tol)
        size = path.stat().st_size
        loaded = load_features(path)
    if (not np.array_equal(loaded["features"], feats["features"])
            or loaded["attrs"]["dataset"] != dataset):
        fail("the feature file did not round-trip")
    t_s = time.perf_counter()
    for i, t_i in enumerate(loaded["t"]):
        m = evaluate_features(None, None, loaded["features"][i],
                              loaded["labels"])
        print(f"[extract] t={float(t_i):.1f} | " + " | ".join(
            f"{k}={v:.4f}" for k, v in m.items()))
        if set(m) != {"linear_acc", "knn_acc", "retrieval_map"} or not all(
                0.0 <= v <= 1.0 for v in m.values()):
            fail(f"evaluate_features at t={t_i}: {m}")
    print(f"[extract] feature file {size / 1e6:.1f} MB; metrics at "
          f"{len(loaded['t'])} times over {n_img} samples in "
          f"{time.perf_counter() - t_s:.1f} s")

    print(f"[extract] done at {time.perf_counter() - t_script:.1f} s")
    # 7. The experiment CLIs at full width.
    def log_rows(run_dir):
        with open(Path(run_dir) / "log.csv", newline="") as f:
            return list(csv.DictReader(f))

    # Every train step and evaluation batch of a CLI run, with the launches
    # it made: the trainer's two methods are watched from here.
    steps, evals = [], []
    plain_train, plain_eval = Trainer.train_batch, Trainer.eval_batch

    def watched_train(self, *a, **k):
        before = read_counts()
        m = plain_train(self, *a, **k)
        after = read_counts()
        stats = self.last_stats
        evals = {"dopri5": 6, "adams": 2}.get(self.cfg.solver)
        steps.append({
            "launches": {n: after[n] - before.get(n, 0) for n in after},
            "attempts": (None if stats is None or evals is None
                         else batch_attempts(stats.nfe, evals)),
            "nfe_b": int(m["nfe_b"]), "loss": m["loss"]})
        return m

    def watched_eval(self, *a, **k):
        before = read_counts()
        m = plain_eval(self, *a, **k)
        after = read_counts()
        evals.append({n: after[n] - before.get(n, 0) for n in after})
        return m

    def run_train(argv):
        """``train.main(argv)`` with the counters from 0; returns the run
        directory, the counts, the steps and the evaluation batches."""
        steps.clear()
        evals.clear()
        Trainer.train_batch, Trainer.eval_batch = watched_train, watched_eval
        try:
            run, t_run, got = counted(lambda: Path(train_cli.main(argv)))
        finally:
            Trainer.train_batch, Trainer.eval_batch = plain_train, plain_eval
        return run, t_run, got, list(steps), list(evals)

    columns = ["epoch", "train_loss", "train_acc", "nfe_f", "nfe_b", "time_s",
               "test_loss", "test_acc", "test_nfe"]
    cli_launches = {}
    with tempfile.TemporaryDirectory() as runs:
        base = ["--dataset", "synthetic-cifar10", "--batch-size",
                str(B_TRAIN), "--limit", "1280", "--runs-dir", runs]
        argv2, argv3 = [*base, "--epochs", "2"], [*base, "--epochs", "3"]
        run2, t_run, got, st, ev = run_train(argv2)
        cli_launches["train"] = got
        ident2 = train_cli.run_identity(train_cli.parse_args(argv2))
        if run2.name != Experiment.name_from_params(ident2):
            fail(f"[train-cli] run directory {run2.name}")
        rows = log_rows(run2)
        print(f"[train-cli] 2 epochs, {len(st)} steps, {len(ev)} evaluation "
              f"batches in {t_run:.1f} s; launches {got}")
        for r in rows:
            print("[train-cli]   " + " | ".join(f"{k}={v}"
                                                for k, v in r.items()))
        if len(rows) != 2 or list(rows[0]) != columns:
            fail(f"[train-cli] log.csv: {rows}")
        if not all(float(r["nfe_f"]) > 0 and float(r["nfe_b"]) > 0
                   for r in rows):
            fail("[train-cli] nfe_f or nfe_b is 0")
        for i, s_ in enumerate(st):
            want = {"odefunc": 2 + 6 * s_["attempts"] + 1,
                    "odefunc_bwd": s_["nfe_b"] - 1, "rk_step": 0}
            if s_["launches"] != want or s_["nfe_b"] < 2:
                fail(f"[train-cli] step {i}: launches {s_['launches']}, "
                     f"expected {want}")
        for i, e_ in enumerate(ev):
            if (e_["odefunc"] != 2 or e_["odefunc_bwd"] != 0
                    or e_["rk_step"] < 1):
                fail(f"[train-cli] evaluation batch {i}: launches {e_}")
        if len(st) != 2 * 10 or len(ev) != 2 * 10:
            fail(f"[train-cli] {len(st)} steps and {len(ev)} evaluation "
                 f"batches, not 20 and 20")
        total = {n: sum(x["launches"][n] for x in st) + sum(x[n] for x in ev)
                 for n in got}
        if total != got:
            fail(f"[train-cli] launches {got}, the steps' sum {total}")
        for name in ("ckpt_best.pt", "ckpt_best.pt.json", "ckpt_last.pt",
                     "ckpt_last.pt.json", "train_state.pt", "params.json"):
            if not (run2 / name).exists():
                fail(f"[train-cli] {name} is missing")

        # The same run stopped after its second epoch of three: --epochs is
        # part of the identity, so the directory takes the 3-epoch identity.
        ident3 = train_cli.run_identity(train_cli.parse_args(argv3))
        run3 = Path(runs) / Experiment.name_from_params(ident3)
        run2.rename(run3)
        for name in ("params.json", "ckpt_last.pt", "ckpt_last.pt.json"):
            (run3 / name).unlink()
        Experiment(runs, ident3).create()
        run, t_run, got, st, ev = run_train(argv3)
        rows = log_rows(run)
        print(f"[train-cli] launched again with --epochs 3: {len(st)} steps "
              f"in {t_run:.1f} s; epochs logged "
              f"{[r['epoch'] for r in rows]}; train_loss "
              f"{[r['train_loss'] for r in rows]}")
        if (run != run3 or [r["epoch"] for r in rows] != ["0", "1", "2"]
                or len(st) != 10):
            fail("[train-cli] the run did not resume at epoch 2")
        if not float(rows[2]["train_loss"]) < float(rows[0]["train_loss"]):
            fail("[train-cli] the loss of epoch 2 is not below epoch 0's")
        if not (run / "ckpt_last.pt").exists():
            fail("[train-cli] ckpt_last.pt is missing after the resume")

        # Reproducible training: the same one-epoch command twice, into two
        # directories, logs the same rows (but time_s) and writes the same
        # weights.
        t_ph = time.perf_counter()
        one = ["--dataset", "synthetic-cifar10", "--batch-size",
               str(B_TRAIN), "--limit", "1280", "--epochs", "1"]
        twice = [run_train([*one, "--runs-dir", str(Path(runs) / tag)])
                 for tag in ("again-a", "again-b")]
        rows_ab = [[{k: v for k, v in r.items() if k != "time_s"}
                    for r in log_rows(r_[0])] for r_ in twice]
        ck_ab = [torch.load(r_[0] / "ckpt_last.pt", weights_only=True)
                 for r_ in twice]
        same_w = ck_ab[0].keys() == ck_ab[1].keys() and all(
            torch.equal(ck_ab[0][k], ck_ab[1][k]) for k in ck_ab[0])
        print(f"[train-cli] the same 1-epoch command twice: rows "
              f"{rows_ab[0]} and {rows_ab[1]}; weights bit-identical: "
              f"{same_w}; time_s {[log_rows(r_[0])[0]['time_s'] for r_ in twice]}")
        if rows_ab[0] != rows_ab[1] or not same_w:
            fail("[train-cli] two runs of the same command differ")
        steps_plain = twice[0][3]
        phase_done("train-cli determinism", t_ph)

        # One epoch with each adjoint variant.
        for tag, flags in (("seminorm", ["--adjoint-seminorm"]),
                           ("interpolated",
                            ["--adjoint-mode", "interpolated"])):
            run_v, t_run, got, st, ev = run_train([*base, "--epochs", "1",
                                                   *flags])
            cli_launches[f"train_{tag}"] = got
            (row,) = log_rows(run_v)
            print(f"[train-cli] {tag}: 1 epoch in {t_run:.1f} s, launches "
                  f"{got}; " + " | ".join(f"{k}={v}" for k, v in row.items()))
            if not (np.isfinite(float(row["train_loss"]))
                    and float(row["nfe_b"]) > 0):
                fail(f"[train-cli] {tag}: {row}")
            if any(s_["launches"]["odefunc_bwd"] != s_["nfe_b"] - 1
                   or s_["launches"]["rk_step"] != 0 for s_ in st):
                fail(f"[train-cli] {tag}: a step's backward launches are "
                     "not nfe_b - 1")
            # Like with like: the first step of this epoch and of the plain
            # 1-epoch run above see the same weights and the same batch
            # (training is reproducible), so the seminorm may not take more
            # backward evaluations there; later steps' weights differ.
            if tag == "seminorm":
                print(f"[train-cli] seminorm nfe_b, step 0: {st[0]['nfe_b']} "
                      f"against {steps_plain[0]['nfe_b']} for the full norm; "
                      f"epoch means {row['nfe_b']} against "
                      f"{rows_ab[0][0]['nfe_b']}")
                if st[0]["nfe_b"] > steps_plain[0]["nfe_b"]:
                    fail("[train-cli] the seminorm took more backward "
                         "evaluations than the full norm on the same step")

        # A ResNet (cuDNN convs, no hand-written kernel) and a fixed-grid
        # ODE-Net by direct backprop, on synthetic-mnist (6×6×64).
        mnist = ["--dataset", "synthetic-mnist", "--batch-size", str(B_TRAIN),
                 "--limit", "1280", "--runs-dir", runs, "--epochs", "1"]
        for tag, flags in (("resnet", ["--model", "resnet"]),
                           ("rk4 direct", ["--model", "odenet", "--solver",
                                           "rk4", "--no-adjoint"])):
            run_v, t_run, got, st, ev = run_train([*mnist, *flags])
            cli_launches[f"train_{tag.split()[0]}"] = got
            (row,) = log_rows(run_v)
            print(f"[train-cli] {tag}: 1 epoch in {t_run:.1f} s, launches "
                  f"{got}; " + " | ".join(f"{k}={v}" for k, v in row.items()))
            if not (np.isfinite(float(row["train_loss"]))
                    and np.isfinite(float(row["test_loss"]))
                    and float(row["nfe_b"]) == 0):
                fail(f"[train-cli] {tag}: {row}")
            want = ({"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0}
                    if tag == "resnet" else
                    {"odefunc": 4 * (len(st) + len(ev)),
                     "odefunc_bwd": 4 * len(st), "rk_step": 0})
            if got != want:
                fail(f"[train-cli] {tag}: launches {got}, expected {want}")
        # That rk4 step's kernels at 6×6×64 against the plain path: the loss
        # and the gradients of one fixed batch by direct backprop (4 ODEfunc
        # launches forward, 4 backward launches), random weights.  Held
        # against the plain path in float64 (in f32 its cuDNN weight
        # gradients are the less exact side, as for the backward kernel);
        # the f32 plain path's own distance from it is printed beside.
        rk4 = Trainer(TrainConfig(dataset="synthetic-mnist", solver="rk4",
                                  adjoint=False, batch_size=B_TRAIN),
                      steps_per_epoch=10, device=dev)
        mimg, mlab = load_dataset("synthetic-mnist", "train", limit=B_TRAIN)
        xm, ym = rk4._preprocess(mimg, train=False), rk4._labels(mlab)
        rcfg = rk4.model_cfg

        def loss_and_grads(loss, wrt):
            return float(loss.detach()), torch.cat(
                [g.reshape(-1) for g in torch.autograd.grad(loss, wrt)])

        def rk4_plain(dtype):
            wrt = [p.detach().to(dtype).requires_grad_() for p in rk4._leaves]
            rp = pytree.tree_unflatten(wrt, pytree.tree_structure(rk4.params))
            h0m = stem_apply(rp["stem"], xm.to(dtype), rcfg)
            if tuple(h0m.shape[1:]) != (6, 6, C):
                fail(f"[train-cli] the MNIST block's state is "
                     f"{tuple(h0m.shape)}")
            traj, _ = odeint(
                lambda tt, y: odefunc_plain(prepare(rp["odefunc"], (6, 6)),
                                            tt, y, G),
                h0m, torch.tensor([0.0, 1.0], device=dev, dtype=dtype),
                method="rk4", error_control=rcfg.error_control)
            return loss_and_grads(F.cross_entropy(
                head_apply(rp["head"], traj[-1], rcfg), ym), wrt)

        (loss_k4, grads_k4), _, got = counted(lambda: loss_and_grads(
            rk4._loss_and_logits(rk4.params, xm, ym)[0], rk4._leaves))
        loss_64, grads_64 = rk4_plain(torch.float64)
        grads_32 = rk4_plain(torch.float32)[1]
        if got != {"odefunc": 4, "odefunc_bwd": 4, "rk_step": 0}:
            fail(f"[train-cli] rk4 direct, one batch: launches {got}")
        if not np.isclose(loss_k4, loss_64, rtol=1e-5, atol=0):
            fail(f"[train-cli] rk4 direct: loss {loss_k4} (kernels) vs "
                 f"{loss_64} (f64 plain)")
        rel, cos = gradient_bar("rk4 direct gradients vs the f64 plain path",
                                grads_k4, grads_64)
        rel_32 = float((grads_32.double() - grads_64).norm()
                       / grads_64.norm())
        print(f"[train-cli] rk4 direct, 6x6x{C} B={B_TRAIN}, kernels against "
              f"the f64 plain path: loss {loss_k4:.7f} vs {loss_64:.7f}; "
              f"gradients rel-L2 {rel:.3e}, cosine {cos:.8f} (the f32 plain "
              f"path's rel-L2: {rel_32:.3e}); launches {got}")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            fail("TF32 is on")

        # [adams-train]: train --solver adams, 1 epoch, counters from 0: per
        # step 2 + 2·attempts + 1 ODEfunc launches (the last for the
        # observation-time gradient) and nfe_b − 1 backward launches (one
        # per augmented evaluation of the Adams backward solve), per
        # evaluation batch two evaluations per attempt and no fused step.
        t_ph = time.perf_counter()
        run_ad, t_run, got, st, ev = run_train(
            [*one, "--solver", "adams", "--runs-dir", runs])
        cli_launches["train_adams"] = got
        rows_ad = log_rows(run_ad)
        print(f"[adams-train] 1 epoch, {len(st)} steps, {len(ev)} evaluation "
              f"batches in {t_run:.1f} s; launches {got}")
        for r in rows_ad:
            print("[adams-train]   " + " | ".join(f"{k}={v}"
                                                  for k, v in r.items()))
        ident_ad = train_cli.run_identity(train_cli.parse_args(
            [*one, "--solver", "adams"]))
        if (run_ad.name != Experiment.name_from_params(ident_ad)
                or ident_ad["solver"] != "adams"):
            fail(f"[adams-train] run directory {run_ad.name}")
        for i, s_ in enumerate(st):
            want = {"odefunc": 2 + 2 * s_["attempts"] + 1,
                    "odefunc_bwd": s_["nfe_b"] - 1, "rk_step": 0}
            if s_["launches"] != want or s_["nfe_b"] < 2:
                fail(f"[adams-train] step {i}: launches {s_['launches']}, "
                     f"expected {want}")
        if any(e_["rk_step"] or e_["odefunc_bwd"] or e_["odefunc"] < 4
               or e_["odefunc"] % 2 for e_ in ev):
            fail(f"[adams-train] evaluation launches {ev}")
        if len(rows_ad) != 1 or not np.isfinite(float(
                rows_ad[0]["train_loss"])):
            fail(f"[adams-train] log.csv: {rows_ad}")
        # The loss falls: six steps on one fixed batch (the JAX
        # tests/test_training.py:60 check) from the trainer's weights,
        # B = 128, augment on; the last five time the Adams train step.
        adams_trainer = Trainer(
            dataclasses.replace(trainer.cfg, solver="adams"),
            steps_per_epoch=10, device=dev, params=trainer.params)
        ad_losses, adams_step_s = [], []
        for i in range(6):
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            m_ad = adams_trainer.train_batch(images, labels)
            torch.cuda.synchronize()
            if i:
                adams_step_s.append(time.perf_counter() - t_s)
            ad_losses.append(m_ad["loss"])
        print(f"[adams-train] six steps on one batch B={B_TRAIN}: losses "
              f"{[round(v, 5) for v in ad_losses]}; a step "
              f"{B_TRAIN / statistics.median(adams_step_s):.1f} img/s "
              f"({1e3 * statistics.median(adams_step_s):.1f} ms, median of "
              f"{adams_step_s}); NFE-f {m_ad['nfe']:.1f}, NFE-b "
              f"{m_ad['nfe_b']:.0f}")
        if not (np.isfinite(ad_losses).all() and ad_losses[-1] < ad_losses[0]):
            fail(f"[adams-train] the loss does not fall: {ad_losses}")
        # One fixed batch at tol 1e-5, global control: the Adams adjoint's
        # loss and gradients through the kernels against the plain path in
        # float64 (autograd-free plain VJP: odefunc_plain under autograd).
        acfg_t = dataclasses.replace(trainer.model_cfg, method="adams",
                                     tol=1e-5, error_control="global",
                                     max_steps=512)
        logits_k, stats_k = odenet_logits(tp, xs, acfg_t, adjoint=True)
        loss_k, grads_k = adjoint_grads(logits_k)
        rp = pytree.tree_map(lambda p_: p_.detach().double()
                             .requires_grad_(), tp)
        h064 = stem_apply(rp["stem"], xs.double(), acfg_t)
        traj64, _ = odeint_adjoint(
            lambda p_, tt, y: odefunc_plain(prepare(p_, (HH, WW)), tt, y, G),
            rp["odefunc"], h064,
            torch.tensor([0.0, 1.0], device=dev, dtype=torch.float64),
            rtol=1e-5, atol=1e-5, method="adams", error_control="global",
            max_steps=512)
        loss64 = F.cross_entropy(head_apply(rp["head"], traj64[-1], acfg_t),
                                 ys)
        grads64 = torch.cat([g_.reshape(-1) for g_ in torch.autograd.grad(
            loss64, leaves(rp))])
        rel, cos = gradient_bar("[adams-train] adjoint gradients vs the f64 "
                                "plain path", grads_k, grads64)
        print(f"[adams-train] fixed batch B=16 tol 1e-5 global: loss "
              f"{loss_k:.7f} vs {float(loss64):.7f} (f64 plain); gradients "
              f"rel-L2 {rel:.3e}, cosine {cos:.8f}; nfe {int(stats_k.nfe[0])}"
              f", nfe_b {int(stats_k.nfe_b)}")
        if not np.isclose(loss_k, float(loss64), rtol=1e-4, atol=0):
            fail(f"[adams-train] loss {loss_k} vs {float(loss64)}")
        phase_done("adams-train", t_ph)

        # [adams-sweep]: sweep --method adams on that run directory, per
        # tolerance and stacked on the batch axis (--fused): equal rows.
        t_ph = time.perf_counter()
        ad_common = ["--run", str(run_ad), "--tols", "1e-2,1e-3",
                     "--batch-size", str(B), "--limit", "1024", "--method",
                     "adams", "--output", str(Path(runs) / "sweep_adams.csv")]
        ad_loop, t_l, got_l = counted(lambda: sweep_cli.main(ad_common))
        ad_fused, t_f, got_f = counted(lambda: sweep_cli.main(
            [*ad_common, "--fused"]))
        cli_launches["sweep_adams"] = got_l
        cli_launches["sweep_adams_fused"] = got_f
        print(f"[adams-sweep] per tolerance {t_l:.2f} s, launches {got_l}; "
              f"--fused {t_f:.2f} s, launches {got_f}")
        for l_, f_ in zip(ad_loop, ad_fused):
            print(f"[adams-sweep] loop {l_}; fused {f_}")
            if any(l_[k] != f_[k] for k in ("tol", "top1", "nfe_mean",
                                            "nfe_min", "nfe_max")):
                fail(f"[adams-sweep] --fused {f_} differs from the loop {l_}")
        if (got_l["rk_step"] or got_f["rk_step"] or got_l["odefunc_bwd"]
                or got_f["odefunc_bwd"] or not 0 < got_f["odefunc"]
                < got_l["odefunc"]
                or not ad_loop[1]["nfe_mean"] > ad_loop[0]["nfe_mean"]):
            fail(f"[adams-sweep] launches {got_l}, {got_f} or NFE")
        phase_done("adams-sweep", t_ph)

        # [pipeline]: extract and evaluate on the run directory, no further
        # argument but the cut of the split.
        feats_path, t_run, got = counted(lambda: extract_cli.main(
            ["--run", str(run), "--limit", "2560"]))
        cli_launches["extract_cli"] = got
        loaded = load_features(feats_path)
        metrics_path = evaluate_cli.main(["--features", str(feats_path)])
        with open(metrics_path, newline="") as f:
            metric_rows = list(csv.DictReader(f))
        print(f"[pipeline] extract: {loaded['features'].shape} features in "
              f"{t_run:.1f} s, launches {got}; evaluate: {len(metric_rows)} "
              f"rows, last {metric_rows[-1]}")
        if (feats_path != run / "features_test.npz"
                or loaded["features"].shape != (T_OUT, 2560, C)
                or not np.isfinite(loaded["features"]).all()
                or got["odefunc"] != 2 * 10 or got["rk_step"] < 10
                or got["odefunc_bwd"] != 0 or len(metric_rows) != T_OUT):
            fail("[pipeline] extract or evaluate on the run directory")

        # [sweep]: the tolerance grid on the run directory, per tolerance
        # and stacked on the batch axis.
        tols_arg = ",".join(f"{t_:g}" for t_ in SWEEP_TOLS)
        common = ["--run", str(run), "--tols", tols_arg, "--batch-size",
                  str(B), "--limit", "1024"]
        out = Path(runs) / "sweep.csv"
        loop_rows, t_loop, got_loop = counted(lambda: sweep_cli.main(
            [*common, "--output", str(out)]))
        fused_rows, t_fused, got_fused = counted(lambda: sweep_cli.main(
            [*common, "--fused", "--output", str(out)]))
        cli_launches["sweep"], cli_launches["sweep_fused"] = got_loop, got_fused
        exact = ("tol", "top1", "nfe_mean", "nfe_min", "nfe_max")
        for l_, f_ in zip(loop_rows, fused_rows):
            if any(l_[k] != f_[k] for k in exact):
                fail(f"[sweep] --fused {f_} differs from the loop {l_}")
        nfe_means = [r["nfe_mean"] for r in loop_rows]
        if nfe_means != sorted(nfe_means):
            fail(f"[sweep] NFE {nfe_means} falls as the tolerance tightens")
        n_b = 1024 // B
        print(f"[sweep] per tolerance: {t_loop:.2f} s with warm-ups, launches "
              f"{got_loop}; --fused: {t_fused:.2f} s, sweep_s "
              f"{fused_rows[0]['sweep_s']}, launches {got_fused}; loop's "
              f"timed seconds {sum(1024 / r['ips'] for r in loop_rows):.3f}")
        # Per batch and warm-up: 2 ODEfunc launches, once for the whole grid
        # when fused.
        if (got_loop["odefunc"] != 2 * (n_b + 1) * len(SWEEP_TOLS)
                or got_fused["odefunc"] != 2 * (n_b + 1)
                or not 0 < got_fused["rk_step"] <= got_loop["rk_step"]
                or got_loop["odefunc_bwd"] or got_fused["odefunc_bwd"]):
            fail(f"[sweep] launches: loop {got_loop}, fused {got_fused}")

        # One stacked batch by hand: one fused step per attempt of the
        # slowest row, for all tolerances together; each tolerance's block
        # of rows against the loop's solve at that tolerance (NFE equal on
        # every sample, logits at rtol = atol = 1e-5: the rows of a launch
        # are independent, the solver's per-row sums may be ordered another
        # way at another batch size) and against the plain path (no
        # kernels) at rtol = atol = 1e-3 where the NFE agree, on at least
        # 95% of the samples.
        @torch.no_grad()
        def check_stacked(tag, params_, cfg_, x_):
            tol_grid = torch.tensor(SWEEP_TOLS, device=dev).repeat_interleave(
                len(x_))
            h0_ = stem_apply(params_["stem"], x_, cfg_)
            hw_ = tuple(h0_.shape[1:3])
            (logits_s, nfe_s), _, got = counted(
                lambda: sweep_cli.stacked_logits(
                    params_, h0_.repeat(n_grid, 1, 1, 1), cfg_, tol_grid,
                    n_grid))
            per_tol = [batch_attempts(n_) for n_ in nfe_s]
            print(f"[sweep] {tag}: one stacked batch, {n_grid}·{len(x_)} rows "
                  f"of {hw_[0]}x{hw_[1]}x{C}: launches {got}; attempts per "
                  f"tolerance {per_tol}")
            if got != {"odefunc": 2, "odefunc_bwd": 0,
                       "rk_step": max(per_tol)}:
                fail(f"[sweep] {tag}: the stacked batch's fused steps are not "
                     "one per attempt")
            w_ = prepare(params_["odefunc"], hw_)
            for i, tol in enumerate(SWEEP_TOLS):
                logits_l, stats_l = odenet_logits(params_, x_, cfg_, tol=tol)
                err_l = float((logits_l - logits_s[i]).abs().max())
                if not (torch.equal(stats_l.nfe, nfe_s[i]) and torch.allclose(
                        logits_l, logits_s[i], rtol=1e-5, atol=1e-5)):
                    fail(f"[sweep] {tag} tol {tol:g}: the stacked rows differ "
                         f"from the loop's solve (logits max abs err "
                         f"{err_l:.3e})")
                traj_p, stats_p = odeint(
                    lambda tt, y: odefunc_plain(w_, tt, y, G), h0_,
                    torch.tensor([0.0, 1.0], device=dev), rtol=tol, atol=tol,
                    method="dopri5", error_control="per_sample",
                    max_steps=cfg_.max_steps)
                logits_p = head_apply(params_["head"], traj_p[-1], cfg_)
                same = stats_p.nfe == nfe_s[i]
                share = float(same.float().mean())
                err_p = float((logits_s[i][same] - logits_p[same]).abs().max())
                print(f"[sweep] {tag} tol {tol:g}: stacked rows vs the loop's "
                      f"solve: NFE equal, logits max abs err {err_l:.3e} "
                      f"(bit-identical: "
                      f"{torch.equal(logits_l, logits_s[i])}); vs the plain "
                      f"path: NFE equal on {share:.4f} of samples, logits "
                      f"max abs err {err_p:.3e}")
                if share < 0.95 or not torch.allclose(
                        logits_s[i][same], logits_p[same], rtol=1e-3,
                        atol=1e-3):
                    fail(f"[sweep] {tag} tol {tol:g}: the stacked rows "
                         "disagree with the plain path")

        sparams, scfg, sextra = load_checkpoint(resolve_checkpoint(run))
        scfg = dataclasses.replace(scfg, adjoint=False)
        simg, _ = load_dataset(sextra["train"]["dataset"], "test", limit=B)
        sx = normalize(torch.from_numpy(simg).to(dev),
                       sextra["train"]["dataset"])
        check_stacked("the run directory", sparams, scfg, sx)
        # ... and the random-init synthetic-mnist model of the last sweep
        # below (seed 7, one input channel): the same at 6×6×64.
        mcfg_s = dataclasses.replace(ModelConfig(in_channels=1),
                                     error_control="per_sample",
                                     adjoint=False)
        mimg_s, _ = load_dataset("synthetic-mnist", "test", limit=B)
        check_stacked("synthetic-mnist, random weights",
                      init_odenet(7, mcfg_s, device=dev), mcfg_s,
                      normalize(torch.from_numpy(mimg_s).to(dev),
                                "synthetic-mnist"))

        # One tolerance on the CPU plain path against the card, B = 16.
        cparams, ccfg, _ = load_checkpoint(resolve_checkpoint(run),
                                           device="cpu")
        ccfg = dataclasses.replace(ccfg, tol=TOL, adjoint=False)
        with torch.no_grad():
            logits_c, stats_c = odenet_logits(cparams, sx[:16].cpu(), ccfg)
            logits_g, stats_g = odenet_logits(sparams, sx[:16], ccfg)
        same = stats_c.nfe == stats_g.nfe.cpu()
        err_c = float((logits_c[same] - logits_g.cpu()[same]).abs().max())
        print(f"[sweep] tol {TOL} B=16, the CPU plain path against the card: "
              f"NFE equal on {float(same.float().mean()):.4f} of samples, "
              f"logits max abs err {err_c:.3e}")
        if float(same.float().mean()) < 0.9 or not torch.allclose(
                logits_c[same], logits_g.cpu()[same], rtol=1e-3, atol=1e-3):
            fail("[sweep] the CPU plain path disagrees with the card")

        # Random init, speed only; then on synthetic-mnist (6×6×64).
        speed = ["--tols", tols_arg, "--batch-size", str(B), "--output",
                 str(out)]
        speed_rows, _, got_speed = counted(lambda: sweep_cli.main(speed))
        speed_fused, _, got_sf = counted(lambda: sweep_cli.main(
            [*speed, "--fused"]))
        mnist_rows, _, got_m = counted(lambda: sweep_cli.main(
            [*speed, "--dataset", "synthetic-mnist", "--limit", "1024",
             "--fused"]))
        cli_launches.update(sweep_speed=got_speed, sweep_speed_fused=got_sf,
                            sweep_mnist_fused=got_m)
        print(f"[sweep] random init: launches loop {got_speed}, fused "
              f"{got_sf}, synthetic-mnist fused {got_m}")
        # (Its stem runs on the stacked inputs, so cuDNN may round another
        # way than at B rows: NFE means within half an evaluation.)
        if (any(abs(a_["nfe_mean"] - b_["nfe_mean"]) > 0.5
                for a_, b_ in zip(speed_rows, speed_fused))
                or min(g_["rk_step"] for g_ in (got_speed, got_sf, got_m)) < 1
                or not all(0.0 <= r["top1"] <= 1.0 for r in mnist_rows)):
            fail("[sweep] the random-init modes")
        sweep_report = {"loop": loop_rows, "fused": fused_rows,
                        "speed": speed_rows, "speed_fused": speed_fused,
                        "mnist_fused": mnist_rows}

        # [convert]: the run directory's checkpoint through `to-torch` (the
        # JAX converter's pickle) and back through `from-torch`: the same
        # config, extra and weights bit for bit, and the same logits on the
        # card.
        t_ph = time.perf_counter()
        src = resolve_checkpoint(run)
        pickle_ = Path(runs) / "converted.pt"
        back = Path(runs) / "back" / "ckpt_best.pt"
        with contextlib.redirect_stdout(sys.stderr):
            convert_cli.main(["to-torch", str(src), str(pickle_)])
            convert_cli.main(["from-torch", str(pickle_), str(back)])
        pa, ca, ea = load_checkpoint(src)
        pb, cb, eb = load_checkpoint(back)
        same_w = all(torch.equal(a_, b_) for a_, b_ in zip(leaves(pa),
                                                           leaves(pb)))
        ccfg_ = dataclasses.replace(ca, adjoint=False)
        with torch.no_grad():
            same_l = torch.equal(odenet_logits(pa, sx, ccfg_)[0],
                                 odenet_logits(pb, sx, ccfg_)[0])
        n_sd = len(torch.load(pickle_, weights_only=True)["state_dict"])
        print(f"[convert] {src.name} -> to-torch ({n_sd} tensors) -> "
              f"from-torch: config equal {ca == cb}, extra equal {ea == eb}, "
              f"weights bit-identical {same_w}, logits on the card "
              f"bit-identical {same_l}")
        if not (ca == cb and ea == eb and same_w and same_l):
            fail("[convert] the round trip of the run directory changed it")
        phase_done("convert", t_ph)

        # [parity]: parity_eval on the committed JAX run directory and on the
        # train CLI's run directory: the kernels on the card against the
        # plain path on the CPU, exit 0 (|Δtop-1| <= 0.2%).
        t_ph = time.perf_counter()
        for tag, rdir in (("fixture", FIXTURE), ("run", run)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc_p, _, got = counted(lambda: parity_cli.main([
                    "--run", str(rdir), "--limit", "512", "--batch-size",
                    str(B)]))
            res_p = json.loads(buf.getvalue().strip().splitlines()[-1])
            cli_launches[f"parity_{tag}"] = got
            print(f"[parity] {tag} ({rdir.name}): exit {rc_p}; {res_p}; "
                  f"launches {got}")
            if (rc_p != 0 or res_p["n"] != 512 or got["odefunc"] != 2 * 2
                    or got["rk_step"] < 2 or got["odefunc_bwd"]):
                fail(f"[parity] {tag}: exit {rc_p}, launches {got}")
        phase_done("parity", t_ph)

    print(f"[CLIs] done at {time.perf_counter() - t_script:.1f} s")

    # [width]: the fused kernels and the probe at the WIDTH_SHAPES on the
    # CIFAR-10 (7×7) and MNIST (6×6) maps.  Per shape: the three kernels
    # against their plain versions (the backward in float64, dθ
    # bit-identical across two launches), an inference solve at B = 256 and
    # one train step at B = 128 through the entry points, counters from 0
    # (the launch rules of [main] and [train]), per-sample NFE against the
    # plain path; at 7×7 and the ADJOINT_WIDTHS the adjoint gradients of
    # that trainer's weights against the plain path (B = 128, tol 1e-5,
    # global control), and mma3/mma1 against the f64 conv at the
    # PROBE_WIDTHS.  At C >= 96 the bf16 odefunc's rows build
    # (width_bf16): bit for bit the per-sample build, row-independent, within
    # BARS, a bf16 solve by the launch rule (graph cache and host loop
    # bit-identical at 7×7×512), timed in turns beside the per-sample build
    # and F.group_norm + F.conv2d in bf16; at the PROBE_WIDTHS the probe's
    # tap9_bf16 and im2col_bf16 raced beside mma_bf16 and F.conv2d bf16.
    # Then one epoch of `train --hidden 128` and of
    # `--hidden 512`, and C = 544 and C = 48 refused before any launch,
    # naming the JAX kernels' gate.  Times with few repetitions: each case
    # is one entry of the kernels line.
    # The backward kernel's reference at a ReLU tie.  Where a GroupNorm
    # output lies within TIE of 0 in float64, f32 arithmetic (the kernel's
    # or cuDNN's) cannot resolve its side of the ReLU, and the VJP jumps
    # there: at 6×6×512, B = 128, one sample's GN2 output at 2.9e-7 moves
    # dh by 0.42 (the f32 plain version on the card is 0.088 off too).  So
    # the float64 plain version is the reference at the activation pattern
    # of the f64 forward, except that a sample the kernel misses may take
    # the other side at up to 4 of its tie elements: the first subset of
    # them (by size) under which the kernel's dh is within STATE_TOL is
    # taken, and the whole batch's (dθ, dt, dh) is then held to that
    # reference at the unchanged tolerances.  A miss anywhere else fails.
    TIE = 1e-5

    def masked_f(w_, t_, h_, masks):
        """``odefunc_plain`` with each ReLU as a product by its 0/1 mask
        (relu(y) is y·[y > 0]; no masks: the ReLUs); also returns the two
        GN outputs."""
        from neural_ode_features_tpu_torch.ops.layers import conv2d, group_norm

        def act(y_, k_):
            return torch.relu(y_) if masks is None else y_ * masks[k_]

        tt = t_.reshape(-1, 1, 1, 1)
        y1 = group_norm({"scale": w_.n1s, "bias": w_.n1b}, h_, groups=G)
        out = conv2d({"kernel": w_.w1, "bias": w_.b1}, act(y1, 0),
                     padding=1) + tt * w_.m1
        y2 = group_norm({"scale": w_.n2s, "bias": w_.n2b}, out, groups=G)
        out = conv2d({"kernel": w_.w2, "bias": w_.b2}, act(y2, 1),
                     padding=1) + tt * w_.m2
        return group_norm({"scale": w_.n3s, "bias": w_.n3b}, out,
                          groups=G), (y1, y2)

    def masked_bwd(w_, t_, h_, g_, masks):
        """(dθ raw, dt (B,), dh) of :func:`masked_f`, as
        ``odefunc_bwd_plain`` gives them for ``odefunc_plain``."""
        from neural_ode_features_tpu_torch.kernels.odefunc_bwd import (
            _raw_grads,
        )

        with torch.enable_grad():
            lv = [a_.detach().requires_grad_() for a_ in w_]
            tl = t_.detach().clone().requires_grad_()
            hl = h_.detach().requires_grad_()
            out, _ = masked_f(type(w_)(*lv), tl, hl, masks)
            grads = torch.autograd.grad(out, [*lv, tl, hl], g_)
        return _raw_grads(type(w_)(*grads[:-2])), grads[-2], grads[-1]

    def tie_aware_reference(tag, w64_, t64, h64, g64, dh_k):
        ref = odefunc_bwd_plain(w64_, t64, h64, g64, G)
        ok = torch.isclose(dh_k.double(), ref[2], **STATE_TOL).flatten(
            1).all(1)
        if bool(ok.all()):
            return ref
        with torch.no_grad():
            _, ys = masked_f(w64_, t64, h64, None)
        masks = [(y_ > 0).double() for y_ in ys]
        for b_ in torch.nonzero(~ok).flatten().tolist():
            ties = [(k_, tuple(i_)) for k_, y_ in enumerate(ys)
                    for i_ in torch.nonzero(y_[b_].abs() < TIE).tolist()]
            if not 1 <= len(ties) <= 4:
                fail(f"odefunc_bwd dh {tag}: sample {b_} misses the f64 "
                     f"plain version with {len(ties)} ReLU ties")
            chosen = None
            for k_ in range(1, len(ties) + 1):
                for sub_ in itertools.combinations(ties, k_):
                    m_b = [m_[b_:b_ + 1].clone() for m_ in masks]
                    for gn_, idx in sub_:
                        m_b[gn_][(0, *idx)] = 1.0 - m_b[gn_][(0, *idx)]
                    dh_b = masked_bwd(w64_, t64[b_:b_ + 1], h64[b_:b_ + 1],
                                      g64[b_:b_ + 1], m_b)[2]
                    if bool(torch.isclose(dh_k[b_:b_ + 1].double(), dh_b,
                                          **STATE_TOL).all()):
                        chosen = sub_
                        break
                if chosen:
                    break
            if chosen is None:
                fail(f"odefunc_bwd dh {tag}: sample {b_} misses the f64 "
                     f"plain version at every side of its ReLU ties {ties}")
            for gn_, idx in chosen:
                masks[gn_][(b_, *idx)] = 1.0 - masks[gn_][(b_, *idx)]
                print(f"[width] {tag}: sample {b_}, GN{gn_ + 1} output at "
                      f"{idx} is {float(ys[gn_][(b_, *idx)]):.3e} in f64: a "
                      "ReLU tie, the kernel on its other side")
        return masked_bwd(w64_, t64, h64, g64, masks)

    def width_phase():
        from neural_ode_features_tpu_torch.probes import bf16_distances

        t_ph = time.perf_counter()
        entries = []
        mnist_x = normalize(torch.from_numpy(load_dataset(
            "synthetic-mnist", "test", limit=B)[0]).to(dev), "synthetic-mnist")
        quick = dict(reps=3, blocks=3)

        def width_bf16(hw, c, tag, wcfg, wparams, ww_, hx, tx, xin, hbx,
                       tbx, gx, bwd_err):
            """The bf16 dynamics at a width of the rows build (C >= 96):
            the stage's name; one call counted (one odefunc_bf16 launch);
            bit for bit the per-sample build's (timing aid
            odefunc_cta_bf16) and, at B = 128, the bf16 backward's f; at
            B = 128, 5 and 1 the per-sample build's bits and the B = 256
            batch's rows; the three GroupNorm launches as launched, their
            device ms and bytes bound (per_sample); the plain bf16
            f within BARS; a bf16 solve through the entry points, counters
            from 0, by the launch rule (2 + 6 attempts), and at 7x7x512 on
            the graph cache and on the host loop, bit-identical; device ms
            of the rows build and the per-sample build in turns, beside
            F.group_norm and F.conv2d on bf16 tensors.  Then the bf16
            backward there, the rows backward (width_bwd_bf16).  Returns
            the kernels-line entries."""
            from neural_ode_features_tpu_torch.probes.timing_aids import (
                odefunc_cta_bf16,
            )

            bf = torch.bfloat16
            if stage(hw, c, "bf16") != "rows_bf16":
                fail(f"[width] {tag}: the bf16 stage is "
                     f"{stage(hw, c, 'bf16')!r}, not the rows build")
            f16, _, n1 = counted(lambda: odefunc(ww_, tx, hx, groups=G,
                                                 compute_dtype=bf))
            if n1 != {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                      "odefunc_bf16": 1}:
                fail(f"[width] {tag} bf16 odefunc: launches {n1}")
            same = {"per-sample build": torch.equal(
                f16, odefunc_cta_bf16(ww_, tx, hx, G))}
            for nb in (B_TRAIN, 5, 1):  # the one-CTA build and the rows
                args_ = (tx[:nb].contiguous(), hx[:nb].contiguous())
                f_nb = odefunc(ww_, *args_, groups=G, compute_dtype=bf)
                same[f"B={nb} per-sample build"] = torch.equal(
                    f_nb, odefunc_cta_bf16(ww_, *args_, G))
                same[f"B={nb} rows"] = torch.equal(f_nb, f16[:nb])
            same.update({
                "backward's f": torch.equal(odefunc_bwd(
                    ww_, tbx, hbx, gx, groups=G, with_f=True,
                    precision="bf16")[3], odefunc(ww_, tbx, hbx, groups=G,
                                                  compute_dtype=bf))})
            ps = per_sample(lambda: odefunc(ww_, tx, hx, groups=G,
                                            compute_dtype=bf), hw, c, B,
                            "fwd")
            r16 = bf16_distances.odefunc_readings(ww_, tx, hx, G)
            bad16 = bf16_distances.check(r16)
            print(f"[width] {tag} bf16 odefunc (rows_bf16) B={B}: bit for "
                  f"bit {same}; vs the plain bf16 f: "
                  f"{r16['kernel_u_per_row']:.3f} u per row, rel-L2 "
                  f"{r16['kernel_rel_u']:.3f} u (the f32 build "
                  f"{r16['f32_rel_u']:.3f})")
            if not all(same.values()) or bad16:
                fail(f"[width] {tag} bf16 odefunc: {same} {bad16}")
            cfg16 = dataclasses.replace(wcfg, compute_dtype="bfloat16")
            routes = [("cache", contextlib.nullcontext)]
            if hw == (HH, WW) and c == 512:
                routes.append(("host", host_loop))
            solves = {}
            for route, ctx in routes:
                with ctx(), torch.no_grad():
                    solves[route] = counted(
                        lambda: odenet_logits(wparams, xin, cfg16))
            (lg16, st16), t16, n16 = solves["cache"]
            att16 = batch_attempts(st16.nfe)
            for route, ((lg_, st_), _, n_) in solves.items():
                if n_ != {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                          "odefunc_bf16": 2 + 6 * att16}:
                    fail(f"[width] {tag} bf16 solve on the {route} route: "
                         f"launches {n_}, not 2 + 6·{att16}")
                if not (torch.equal(lg_, lg16)
                        and torch.equal(st_.nfe, st16.nfe)):
                    fail(f"[width] {tag} bf16 solve: the {route} route is "
                         "not the cache's bit for bit")
            if not bool(torch.isfinite(lg16).all()):
                fail(f"[width] {tag} bf16 solve: logits not finite")
            print(f"[width] {tag} bf16 solve B={B} on "
                  f"{[r for r, _ in routes]}: launches {n16}, attempts "
                  f"{att16}, NFE mean {float(st16.nfe.float().mean()):.2f}"
                  + (", bit-identical" if len(routes) > 1 else ""))
            hx16, tx16 = hx.to(bf), tx.to(bf)
            raw16 = {k: {kk: v.to(bf) for kk, v in d.items()}
                     for k, d in wparams["odefunc"].items()}
            turns = [device_ms(fn, reps=10) for fn in (
                lambda: odefunc_cta_bf16(ww_, tx, hx, G),
                lambda: odefunc(ww_, tx, hx, groups=G, compute_dtype=bf),
                lambda: odefunc(ww_, tx, hx, groups=G, compute_dtype=bf),
                lambda: odefunc_cta_bf16(ww_, tx, hx, G))]
            lib16 = device_ms(lambda: library_f(hx16, tx16, raw16), reps=10)
            entry = {
                "name": "odefunc_bf16", "shape": tag, "route": "cuda",
                "source": "neural_ode_features_tpu_torch/csrc/odefunc.cu",
                "replaces": REPLACES["odefunc"],
                "launches": n16["odefunc_bf16"],
                "max_abs_err": r16["max_abs_err"],
                "ms": (turns[1] + turns[2]) / 2,
                "plain_ms": time_ms(lambda: odefunc_plain(ww_, tx, hx, G,
                                                          "bf16"), **quick),
                **fused_bounds(hw, c, B, B_TRAIN, H100_BF16_FLOPS)[
                    "odefunc"],
                "library_ms": lib16, "stage": "rows_bf16",
                "precision": "bf16", "per_sample_ms": (turns[0]
                                                       + turns[3]) / 2,
                "turns_ms": turns, "per_sample_launches": ps}
            print(f"[width] {tag} bf16 odefunc device ms in turns "
                  f"(per-sample, rows, rows, per-sample): " + ", ".join(
                      f"{v:.4f}" for v in turns) + f"; F.group_norm + "
                  f"F.conv2d on bf16 tensors {lib16:.4f}; bound "
                  f"{entry['bound_ms']:.4f} ({entry['bound_by']})")
            print(f"[width] {tag} bf16 odefunc per-sample GroupNorms B={B}: "
                  + rows_gn_line(ps))
            return [entry, *width_bwd_bf16(hw, c, tag, ww_, wparams, hbx,
                                           tbx, gx, bwd_err)]

        def rows_gn_line(ps):
            ms_ = "not measured" if ps["ms"] is None else f"{ps['ms']:.4f} ms"
            return (f"{len(ps['kernels'])} kernels on grids {ps['grid']} of "
                    f"{ps['block'][0]} threads ({ps['slices']} slices a "
                    f"sample), clusters {ps['cluster']}, shared bytes "
                    f"{ps['shared_bytes']}; {ms_} a "
                    f"call, bytes bound {ps['bound_ms']:.4f} ms "
                    f"({ps['bytes'] / 1e6:.1f} MB)")

        def width_bwd_bf16(hw, c, tag, ww_, wparams, hbx, tbx, gx, bwd_err):
            """The bf16 backward at a width of the rows backward (C >= 96):
            the gate's pass and the one launched ('rows', read from a
            captured call); its GroupNorm launches' grid (per_sample); at
            B = 128, 5 and 1, one call counted (one
            odefunc_bwd_bf16 launch), every output (dθ, dt, dh, f) bit for
            bit the one-CTA pass's (timing aid odefunc_bwd_cta_bf16) and a
            second launch's (BARS: the width's bwd_readings, bwd_err its
            max abs err).  At 7x7x96 and 7x7x512 a bf16 adjoint train step
            through the Trainer, counters from 0, by the launch rule
            (NFE-b - 1 odefunc_bwd_bf16), the GroupNorm launches' device
            ms and bytes bound, and the call's device ms in
            turns (one-CTA, rows, rows, one-CTA) beside autograd through
            F.group_norm + F.conv2d on bf16 tensors: a kernels-line entry.
            Returns the entries."""
            from neural_ode_features_tpu_torch.probes.timing_aids import (
                odefunc_bwd_cta_bf16,
            )

            bf = torch.bfloat16
            gate = sample_pass(hw, c, G, "bf16")
            pass_, grid, block, shared, _ = ran_sample_pass(
                lambda: odefunc_bwd(ww_, tbx, hbx, gx, groups=G,
                                    precision="bf16"))
            if gate != "rows" or pass_ != "rows":
                fail(f"[width] {tag} odefunc_bwd bf16: the gate says "
                     f"{gate!r}, the {pass_} pass launched, not the rows "
                     "backward")

            def outs(res):
                dp_, *rest = res
                return [*(dp_[a][b] for a in sorted(dp_)
                          for b in sorted(dp_[a])), *rest]

            same = {}
            for nb in (B_TRAIN, 5, 1):
                args = (tbx[:nb].contiguous(), hbx[:nb].contiguous(),
                        gx[:nb].contiguous())
                got_, _, n_b = counted(lambda: odefunc_bwd(
                    ww_, *args, groups=G, with_f=True, precision="bf16"))
                if n_b != {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                           "odefunc_bwd_bf16": 1}:
                    fail(f"[width] {tag} odefunc_bwd bf16 B={nb}: launches "
                         f"{n_b}")
                cta_ = odefunc_bwd_cta_bf16(ww_, *args, G, with_f=True)
                again_ = odefunc_bwd(ww_, *args, groups=G, with_f=True,
                                     precision="bf16")
                same[f"B={nb} one-CTA pass"] = all(
                    torch.equal(a_, b_) for a_, b_ in zip(outs(got_),
                                                          outs(cta_)))
                same[f"B={nb} two launches"] = all(
                    torch.equal(a_, b_) for a_, b_ in zip(outs(got_),
                                                          outs(again_)))
            print(f"[width] {tag} odefunc_bwd bf16 (the rows backward: "
                  f"{grid[0]} CTAs of {block[0]} threads, {shared} B in its "
                  f"last per-sample launch): dθ, dt, dh, f bit for bit "
                  f"{same}; BARS held (max abs err {bwd_err:.3e})")
            if not all(same.values()):
                fail(f"[width] {tag} odefunc_bwd bf16: {same}")
            if hw != (HH, WW) or c not in (96, 512):
                per_sample(lambda: odefunc_bwd(ww_, tbx, hbx, gx, groups=G,
                                               precision="bf16"), hw, c,
                           B_TRAIN, "bwd")
                return []
            ps = per_sample(lambda: odefunc_bwd(ww_, tbx, hbx, gx, groups=G,
                                                precision="bf16"), hw, c,
                            B_TRAIN, "bwd")
            print(f"[width] {tag} bf16 odefunc_bwd per-sample GroupNorms "
                  f"B={B_TRAIN}: " + rows_gn_line(ps))
            tr16 = Trainer(dataclasses.replace(
                TRAIN_CONFIG, hidden=c, batch_size=B_TRAIN,
                compute_dtype="bfloat16", dataset="synthetic-cifar10"),
                steps_per_epoch=10, device=dev)
            timg, tlab = load_dataset(tr16.cfg.dataset, "train",
                                      limit=B_TRAIN)
            m16, t16s, n16t = counted(lambda: tr16.train_batch(
                timg, tlab.astype(np.int64)))
            att16 = batch_attempts(tr16.last_stats.nfe)
            want16 = {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                      "odefunc_bf16": 2 + 6 * att16 + 1,
                      "odefunc_bwd_bf16": int(m16["nfe_b"]) - 1}
            print(f"[width] {tag} bf16 adjoint train step B={B_TRAIN}: "
                  f"{t16s:.3f} s (first), loss {m16['loss']:.5f}, NFE-b "
                  f"{int(m16['nfe_b'])}, launches {n16t}")
            if n16t != want16 or not np.isfinite(m16["loss"]):
                fail(f"[width] {tag} bf16 train step: launches {n16t}, "
                     f"want {want16}, or the loss is not finite")
            raw16 = {k: {kk: v.to(bf) for kk, v in d.items()}
                     for k, d in wparams["odefunc"].items()}
            hb16, tb16, gb16 = hbx.to(bf), tbx.to(bf), gx.to(bf)

            def rows_():
                return odefunc_bwd(ww_, tbx, hbx, gx, groups=G,
                                   precision="bf16")

            def cta_():
                return odefunc_bwd_cta_bf16(ww_, tbx, hbx, gx, G)

            turns = [device_ms(fn, reps=10) for fn in (cta_, rows_, rows_,
                                                       cta_)]
            lib_b = device_ms(lambda: library_bwd(hb16, tb16, raw16, gb16),
                              reps=10)
            entry = {
                "name": "odefunc_bwd_bf16", "shape": tag, "route": "cuda",
                "source": "neural_ode_features_tpu_torch/csrc/odefunc_bwd.cu",
                "replaces": REPLACES["odefunc_bwd"],
                "launches": n16t["odefunc_bwd_bf16"],
                "max_abs_err": bwd_err, "ms": (turns[1] + turns[2]) / 2,
                "plain_ms": time_ms(lambda: odefunc_bwd_plain(
                    ww_, tbx, hbx, gx, G, precision="bf16"), **quick),
                **fused_bounds(hw, c, B, B_TRAIN, H100_BF16_FLOPS)[
                    "odefunc_bwd"],
                "library_ms": lib_b, "stage": "rows backward",
                "precision": "bf16", "cta_ms": (turns[0] + turns[3]) / 2,
                "turns_ms": turns, "per_sample_launches": ps}
            print(f"[width] {tag} bf16 odefunc_bwd device ms in turns "
                  f"(one-CTA, rows, rows, one-CTA): " + ", ".join(
                      f"{v:.4f}" for v in turns) + f"; autograd through "
                  f"F.group_norm + F.conv2d on bf16 tensors {lib_b:.4f}; "
                  f"bound {entry['bound_ms']:.4f} ({entry['bound_by']})")
            return [entry]

        for hw_h, hw_w, c in WIDTH_SHAPES:
            t_shape = time.perf_counter()
            hw = (hw_h, hw_w)
            cifar = hw == (HH, WW)
            tag = f"{hw[0]}x{hw[1]}x{c}"
            wcfg = dataclasses.replace(ENTRY_CONFIG, hidden=c,
                                       in_channels=3 if cifar else 1)
            wparams = init_odenet(7, wcfg, device=dev)
            ww_ = prepare(wparams["odefunc"], hw)
            rng_w = np.random.default_rng(c + hw[0])

            def arr(a):
                return torch.from_numpy(a.astype(np.float32)).to(dev)

            hx = arr(rng_w.normal(size=(B, *hw, c)) * 0.3)
            tx, t0x = arr(rng_w.uniform(0, 1, B)), arr(rng_w.uniform(
                0, 0.5, B))
            dtx = arr(rng_w.uniform(0.05, 0.2, B))
            gx = arr(rng_w.normal(size=(B_TRAIN, *hw, c)))
            hbx, tbx = hx[:B_TRAIN].contiguous(), tx[:B_TRAIN].contiguous()
            err_f = close(f"odefunc {tag}", odefunc(ww_, tx, hx, groups=G),
                          odefunc_plain(ww_, tx, hx, G), **STATE_TOL)
            yx = hx.reshape(B, -1)
            f0x = odefunc_plain(ww_, t0x, hx, G).reshape(B, -1)
            skw = dict(hw=hw, groups=G, rtol=TOL, atol=TOL)
            got = dopri5_step(ww_, DOPRI5, t0x, dtx, yx, f0x, **skw)
            want = dopri5_step_plain(ww_, DOPRI5, t0x, dtx, yx, f0x, **skw)
            err_s = max(close(f"rk_step {n_} {tag}", g_, r_, **STATE_TOL)
                        for n_, g_, r_ in zip(("y1", "f1", "y_mid"),
                                              got[:3], want[:3]))
            close(f"rk_step ratio {tag}", got[3], want[3], **RATIO_TOL)
            w64 = type(ww_)(*(a_.double() for a_ in ww_))
            dp, dtk, dh, f_b = odefunc_bwd(ww_, tbx, hbx, gx, groups=G,
                                           with_f=True)
            if not torch.equal(f_b, odefunc(ww_, tbx, hbx, groups=G)):
                fail(f"odefunc_bwd f {tag}: differs from the ODEfunc "
                     "kernel's")
            dp_p, dt_p, dh_p = tie_aware_reference(
                tag, w64, tbx.double(), hbx.double(), gx.double(), dh)
            err_b = close(f"odefunc_bwd dh {tag}", dh.double(), dh_p,
                          **STATE_TOL)
            close(f"odefunc_bwd dt {tag}", dtk.double(), dt_p, **STATE_TOL)
            worst = max(((float((dp[k1][k2].double() - dp_p[k1][k2]).abs()
                                .max()), f"{k1}/{k2}") for k1 in dp
                         for k2 in dp[k1]))
            print(f"[width] {tag} dθ: largest error {worst[0]:.3e} in "
                  f"{worst[1]}")
            err_dp = close(f"odefunc_bwd dθ {tag}", flat(dp).double(),
                           flat(dp_p), **DP_TOL)
            if not torch.equal(flat(dp), flat(odefunc_bwd(
                    ww_, tbx, hbx, gx, groups=G)[0])):
                fail(f"odefunc_bwd dθ {tag}: two launches differ")
            # Both builds' weight gradients at this width: against their
            # emulation, the f32 build's dθ beside the f32 plain version's
            # distance from f64, the bf16 build under BARS.
            check_weight_grads(ww_, tbx, hbx, gx, f"{tag} B={B_TRAIN}")
            err_32 = float((flat(odefunc_bwd_plain(ww_, tbx, hbx, gx, G)[0])
                            .double() - flat(dp_p)).abs().max())
            print(f"[width] {tag} odefunc_bwd vs the f64 plain version: dθ "
                  f"max abs err {err_dp:.3e} (the f32 plain version's: "
                  f"{err_32:.3e})")
            r16 = bf16_distances.bwd_readings(ww_, tbx, hbx, gx, G)
            bad16 = bf16_distances.check(r16)
            print(f"[width] {tag} odefunc_bwd bf16 B={B_TRAIN} (u of the "
                  "plain bf16 VJP; bf16 build / f32 build): " + ", ".join(
                      f"{k} {v['kernel']:.3f} / {v['f32']:.3f}"
                      for k, v in r16["outputs"].items())
                  + f"; f_equal {r16['f_equal']}, repeatable "
                  f"{r16['repeatable']}")
            if bad16:
                fail(f"[width] {tag} odefunc_bwd bf16: " + "; ".join(bad16))
            print(f"[width] {tag} ({stage(hw, c)}): odefunc max abs err "
                  f"{err_f:.3e}, rk_step {err_s:.3e} (B={B}); odefunc_bwd "
                  f"B={B_TRAIN} vs the f64 plain version: dh {err_b:.3e}, "
                  f"dθ {err_dp:.3e}, dθ bit-identical across two launches")

            # The inference path at this width, counters from 0.
            xin = x if cifar else mnist_x
            with torch.no_grad():
                (lg, st), _, got_inf = counted(
                    lambda: odenet_logits(wparams, xin, wcfg))
                traj_w, st_p = odeint(
                    lambda tt, y: odefunc_plain(ww_, tt, y, G),
                    stem_apply(wparams["stem"], xin, wcfg), ts, rtol=TOL,
                    atol=TOL, error_control="per_sample",
                    max_steps=wcfg.max_steps)
                lg_p = head_apply(wparams["head"], traj_w[-1], wcfg)
            att = batch_attempts(st.nfe)
            same_w = st.nfe == st_p.nfe
            share_w = float(same_w.float().mean())
            err_l = float((lg[same_w] - lg_p[same_w]).abs().max())
            want = {"odefunc": 2, "odefunc_bwd": 0, "rk_step": att}
            print(f"[width] {tag} inference B={B}: launches {got_inf}, "
                  f"attempts {att}, NFE mean "
                  f"{float(st.nfe.float().mean()):.2f}; vs the plain "
                  f"path: NFE equal on {share_w:.4f} of samples, logits "
                  f"max abs err {err_l:.3e}")
            if got_inf != want or share_w < 0.99 or not torch.allclose(
                    lg[same_w], lg_p[same_w], rtol=1e-3, atol=1e-3):
                fail(f"[width] {tag}: the inference solve (launches "
                     f"{got_inf}, expected {want}) or its NFE and logits")

            # One train step at this width, counters from 0.
            wtr = Trainer(dataclasses.replace(
                TRAIN_CONFIG, hidden=c, batch_size=B_TRAIN,
                dataset="synthetic-cifar10" if cifar else "synthetic-mnist"),
                steps_per_epoch=10, device=dev)
            timg, tlab = load_dataset(wtr.cfg.dataset, "train",
                                      limit=B_TRAIN)
            m_w, t_step, got_tr = counted(lambda: wtr.train_batch(
                timg, tlab.astype(np.int64)))
            att_t = batch_attempts(wtr.last_stats.nfe)
            nfe_b_w = int(m_w["nfe_b"])
            want = {"odefunc": 2 + 6 * att_t + 1,
                    "odefunc_bwd": nfe_b_w - 1, "rk_step": 0}
            print(f"[width] {tag} train step B={B_TRAIN}: {t_step:.3f} s "
                  f"(first), loss {m_w['loss']:.5f}, NFE-f "
                  f"{m_w['nfe']:.2f}, NFE-b {nfe_b_w}, launches {got_tr}")
            if got_tr != want or not np.isfinite(m_w["loss"]) or not all(
                    bool(torch.isfinite(p_.grad).all())
                    for p_ in wtr._leaves):
                fail(f"[width] {tag}: train step launches {got_tr}, "
                     f"expected {want}, or not finite")
            if cifar and c in ADJOINT_WIDTHS:
                # The adjoint gradients against the plain path.
                wp = wtr.params
                xs_w = wtr._preprocess(timg, train=False)
                ys_w = wtr._labels(tlab)
                gcfg = dataclasses.replace(wtr.model_cfg, tol=1e-5,
                                           error_control="global",
                                           max_steps=512)

                def grads_of(logits_):
                    loss_ = F.cross_entropy(logits_, ys_w)
                    return float(loss_.detach()), torch.cat([
                        g_.reshape(-1) for g_ in torch.autograd.grad(
                            loss_, leaves(wp))])

                loss_k, grads_k = grads_of(
                    odenet_logits(wp, xs_w, gcfg, adjoint=True)[0])
                traj_a, _ = odeint_adjoint(
                    lambda p_, tt, y: odefunc_plain(prepare(p_, hw), tt,
                                                    y, G),
                    wp["odefunc"], stem_apply(wp["stem"], xs_w, gcfg), ts,
                    rtol=1e-5, atol=1e-5, error_control="global",
                    max_steps=512)
                loss_p, grads_p = grads_of(head_apply(wp["head"],
                                                      traj_a[-1], gcfg))
                rel, cos = gradient_bar(f"[width] {tag} adjoint gradients "
                                        "vs the plain path", grads_k,
                                        grads_p)
                print(f"[width] {tag} adjoint B={B_TRAIN} tol 1e-5 "
                      f"global: loss {loss_k:.7f} vs {loss_p:.7f} plain; "
                      f"gradients rel-L2 {rel:.3e}, cosine {cos:.8f}")
                if not np.isclose(loss_k, loss_p, rtol=1e-5, atol=0):
                    fail(f"[width] {tag}: adjoint loss {loss_k} vs "
                         f"{loss_p}")

            # Times, bounds and the kernels line.
            fbw = fused_bounds(hw, c, B, B_TRAIN)
            wraw = wparams["odefunc"]
            cases = (
                ("odefunc", "odefunc.cu",
                 lambda: odefunc(ww_, tx, hx, groups=G),
                 lambda: odefunc_plain(ww_, tx, hx, G),
                 lambda: library_f(hx, tx, wraw), got_inf, err_f),
                ("rk_step", "rk_step.cu",
                 lambda: dopri5_step(ww_, DOPRI5, t0x, dtx, yx, f0x,
                                     **skw),
                 lambda: dopri5_step_plain(ww_, DOPRI5, t0x, dtx, yx,
                                           f0x, **skw),
                 None, got_inf, err_s),
                ("odefunc_bwd", "odefunc_bwd.cu",
                 lambda: odefunc_bwd(ww_, tbx, hbx, gx, groups=G),
                 lambda: odefunc_bwd_plain(ww_, tbx, hbx, gx, G),
                 lambda: library_bwd(hbx, tbx, wraw, gx), got_tr, err_b))
            for name, src, run_k, run_p, run_l, got_, err in cases:
                entries.append({
                    "name": name, "shape": tag, "route": "cuda",
                    "source": f"neural_ode_features_tpu_torch/csrc/{src}",
                    "replaces": REPLACES[name],
                    "launches": got_[name], "max_abs_err": err,
                    "ms": device_ms(run_k, reps=10),
                    "plain_ms": time_ms(run_p, **quick), **fbw[name],
                    "library_ms": (None if run_l is None
                                   else time_ms(run_l, **quick)),
                    "stage": stage(hw, c)})
            print(f"[width] {tag} device ms: " + ", ".join(
                f"{e_['name']} {e_['ms']:.4f} (bound {e_['bound_ms']:.4f},"
                f" f32 FFMA {e_['ffma_bound_ms']:.4f}; plain "
                f"{e_['plain_ms']:.3f}, library {e_['library_ms']})"
                for e_ in entries[-3:]))
            entries[-1]["weight_kernel"] = weight_reading(
                ww_, tbx, hbx, gx, f"{tag} B={B_TRAIN}", reps=10)
            if c >= 96:
                entries.extend(width_bf16(hw, c, tag, wcfg, wparams, ww_, hx,
                                          tx, xin, hbx, tbx, gx,
                                          r16["max_abs_err"]))
            print(f"[width] {tag} took {time.perf_counter() - t_shape:.1f} s")

        # The probe's tensor-core kernels at the PROBE_WIDTHS against the
        # f64 conv, beside F.conv2d, the conv counter from 0: at 96 the
        # direct check of the padded last block, at 512 of eight blocks'
        # sums (f32-grade: within F64_CONV_BAR).
        for c in PROBE_WIDTHS:
            conv3x3.launches = 0
            xc_w, wc_w = conv_probe.probe_inputs(B, dev, (HH, WW), c)
            conv64 = conv3x3_plain(xc_w.double(), wc_w.double())
            grow = (c / C) ** 0.5  # TF32's error: the root of 9·C products
            errs = {}
            for strategy, tol in (("mma3", CONV_TOL), ("mma1", {
                    k_: v_ * grow for k_, v_ in TF32_TOL.items()})):
                errs[strategy] = close(
                    f"conv_probe {strategy} {HH}x{WW}x{c} (f64 conv)",
                    conv3x3(xc_w, wc_w, strategy).double(), conv64, **tol)
            if c in (96, 512) and errs["mma3"] > F64_CONV_BAR:
                fail(f"conv_probe mma3 {HH}x{WW}x{c}: {errs['mma3']:.3e} "
                     f"against the f64 conv, over {F64_CONV_BAR}")
            lib_err_w = float((conv_probe.library_conv(xc_w, wc_w).double()
                               - conv64).abs().max())
            probe_ms = {s_: device_ms(lambda s_=s_: conv3x3(xc_w, wc_w, s_))
                        for s_ in ("mma3", "mma1")}
            lib_ms = time_ms(lambda: conv_probe.library_conv(xc_w, wc_w),
                             reps=20)
            print(f"[width] conv_probe B={B} {HH}x{WW}x{c} vs the f64 conv: "
                  f"mma3 max abs err {errs['mma3']:.3e}, mma1 "
                  f"{errs['mma1']:.3e}, F.conv2d {lib_err_w:.3e}; device ms "
                  f"mma3 {probe_ms['mma3']:.4f}, mma1 {probe_ms['mma1']:.4f}; "
                  f"F.conv2d {lib_ms:.4f} ms per call")
            # The rows strategies at this width (the rows kernel, the bf16
            # odefunc's conv stage): each against the plain bf16 conv,
            # tap9_bf16 bit for bit mma_bf16 (im2col_bf16 too at C % 64 ==
            # 0), raced beside mma_bf16 and F.conv2d on bf16 tensors by
            # device time, in turns.
            plain16 = conv3x3_plain(xc_w, wc_w, passes="bf16")
            m16 = conv3x3(xc_w, wc_w, "mma_bf16")
            err16 = {}
            for s_ in ("tap9_bf16", "im2col_bf16"):
                got_ = conv3x3(xc_w, wc_w, s_)
                err16[s_] = close(f"conv_probe {s_} {HH}x{WW}x{c}", got_,
                                  plain16, **CONV_TOL)
                if (s_ == "tap9_bf16" or c % 64 == 0) and not torch.equal(
                        got_, m16):
                    fail(f"[width] conv_probe {s_} {HH}x{WW}x{c}: not "
                         "mma_bf16's bits")
            x16_w, w16_w = xc_w.bfloat16(), wc_w.bfloat16()
            race = {}
            for s_ in ("mma_bf16", "tap9_bf16", "im2col_bf16", "F.conv2d",
                       "F.conv2d", "im2col_bf16", "tap9_bf16", "mma_bf16"):
                fn_ = ((lambda: conv_probe.library_conv(x16_w, w16_w))
                       if s_ == "F.conv2d"
                       else (lambda s_=s_: conv3x3(xc_w, wc_w, s_)))
                race.setdefault(s_, []).append(device_ms(fn_))
            race = {k: sum(v) / len(v) for k, v in race.items()}
            print(f"[width] conv_probe bf16 race B={B} {HH}x{WW}x{c}, device "
                  "ms (in turns, mean of two): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in race.items())
                  + f"; tap9_bf16 / F.conv2d "
                  f"{race['tap9_bf16'] / race['F.conv2d']:.2f}x")
            entries.append({
                "name": "conv_probe_tap9_bf16", "shape": f"{HH}x{WW}x{c}",
                "route": "cuda", "precision": "bf16",
                "source": "neural_ode_features_tpu_torch/csrc/rows_conv.cuh",
                "replaces": "probes/conv_probe.py:282",
                "launches": conv3x3.launches, "max_abs_err": err16["tap9_bf16"],
                "ms": race["tap9_bf16"],
                "plain_ms": time_ms(lambda: conv3x3_plain(
                    xc_w, wc_w, passes="bf16"), **quick),
                **bounds(conv_flops(B, (HH, WW), c),
                         conv_bytes(B, (HH, WW), c), H100_BF16_FLOPS),
                "library_ms": race["F.conv2d"],
                "stage": "tap9_bf16 (the rows kernel)",
                "strategy_ms": race})
            entries.append({
                "name": "conv_probe", "shape": f"{HH}x{WW}x{c}", "route": "cuda",
                "source": "neural_ode_features_tpu_torch/csrc/conv_probe.cu",
                "replaces": REPLACES["conv_probe"],
                "launches": conv3x3.launches, "max_abs_err": errs["mma3"],
                "ms": probe_ms["mma3"],
                "plain_ms": time_ms(lambda: conv3x3_plain(xc_w, wc_w),
                                    **quick),
                **bounds(conv_flops(B, (HH, WW), c),
                         conv_bytes(B, (HH, WW), c)),
                "library_ms": lib_ms, "stage": "mma3",
                "mma1_ms": probe_ms["mma1"]})

        # The probe's mma_bf16, the bf16 builds' conv stage at C = 96 to 512
        # on these maps (mma.sync bf16), beside F.conv2d on bf16 tensors:
        # device ms by the same clock at every width from 96 to 512, each
        # checked against the plain bf16 conv first.
        mma16 = {}
        for c in range(96, 513, 32):
            xc_w, wc_w = conv_probe.probe_inputs(B, dev, (HH, WW), c)
            close(f"conv_probe mma_bf16 {HH}x{WW}x{c}",
                  conv3x3(xc_w, wc_w, "mma_bf16"),
                  conv3x3_plain(xc_w, wc_w, passes="bf16"), **CONV_TOL)
            x16_w, w16_w = xc_w.bfloat16(), wc_w.bfloat16()
            mma16[c] = (device_ms(lambda: conv3x3(xc_w, wc_w, "mma_bf16")),
                        device_ms(lambda: conv_probe.library_conv(
                            x16_w, w16_w)))
        print(f"[width] conv_probe mma_bf16 B={B} {HH}x{WW}xC device ms "
              f"beside F.conv2d on bf16 tensors (ratio): " + ", ".join(
                  f"{c} {m_:.4f} / {l_:.4f} ({m_ / l_:.2f}x)"
                  for c, (m_, l_) in mma16.items()))

        # One epoch of `train --hidden 128`, of `--hidden 512` and of
        # `--bf16 --hidden 512` (the rows build and the rows backward) at
        # the [train-cli] size, the launch rule on every step.
        for hidden, bf16_ in ((128, False), (512, False), (512, True)):
            flag = " --bf16" if bf16_ else ""
            with tempfile.TemporaryDirectory() as runs_w:
                run_w, t_run, got, st_, ev_ = run_train([
                    "--dataset", "synthetic-cifar10", "--batch-size",
                    str(B_TRAIN), "--limit", "1280", "--epochs", "1",
                    "--hidden", str(hidden), "--runs-dir", runs_w,
                    *flag.split()])
                (row,) = log_rows(run_w)
            cli_launches[f"train_hidden{hidden}"
                         + ("_bf16" if bf16_ else "")] = got
            print(f"[width] train{flag} --hidden {hidden}: 1 epoch, "
                  f"{len(st_)} steps, {len(ev_)} evaluation batches in "
                  f"{t_run:.1f} s; launches {got}; " + " | ".join(
                      f"{k}={v}" for k, v in row.items()))
            rule = all(s_["launches"] == ({
                "odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                "odefunc_bf16": 2 + 6 * s_["attempts"] + 1,
                "odefunc_bwd_bf16": s_["nfe_b"] - 1} if bf16_ else {
                "odefunc": 2 + 6 * s_["attempts"] + 1,
                "odefunc_bwd": s_["nfe_b"] - 1, "rk_step": 0}) for s_ in st_)
            if (len(st_) != 10 or not rule
                    or not np.isfinite(float(row["train_loss"]))):
                fail(f"[width] train{flag} --hidden {hidden}: the epoch or "
                     "its launches")

        # Widths the JAX kernels refuse (C > 512; C % groups != 0) are
        # refused before any launch, naming that gate.
        for c_bad, clause in ((544, "C > 512"), (48, "C % groups != 0")):
            p_bad = init_odenet(0, dataclasses.replace(ENTRY_CONFIG,
                                                       hidden=c_bad),
                                device=dev)["odefunc"]
            h_bad = torch.zeros((2, HH, WW, c_bad), device=dev)
            odefunc.launches = odefunc_bwd.launches = 0
            for fn in (lambda: odefunc(p_bad, 0.5, h_bad),
                       lambda: odefunc_bwd(p_bad, 0.5, h_bad, h_bad)):
                try:
                    fn()
                except ValueError as e:
                    if clause not in str(e):
                        fail(f"[width] 7x7x{c_bad} refused without naming "
                             f"{clause!r}: {e}")
                else:
                    fail(f"[width] 7x7x{c_bad} was not refused")
            if odefunc.launches or odefunc_bwd.launches:
                fail(f"[width] 7x7x{c_bad}: a kernel launched before the "
                     "refusal")
            print(f"[width] 7x7x{c_bad}: refused before any launch ({clause})")
        phase_done("width", t_ph)
        return entries

    # [foreign]: what users bring.  CIFAR-10 binary batches and MNIST IDX
    # files (the labels gzipped) written with numpy from the synthetic
    # twins, read back through load_dataset; the JAX run directory
    # committed under tests/fixtures_torch/ read through load_checkpoint on
    # the card; and `python -m ...eval_ckpt` on it and the MNIST files, on
    # the card, which must give the JAX tool's top-1 (stored beside the
    # fixture) and its mean NFE within 1%.
    def foreign_phase():
        t_ph = time.perf_counter()
        stored = json.loads(FIXTURE_EVAL.read_text())
        n_eval = stored["result"]["n"]
        with tempfile.TemporaryDirectory() as data:
            data = Path(data)
            (data / "mnist").mkdir()
            for split, prefix in (("train", "train"), ("test", "t10k")):
                xm_, ym_ = load_dataset("synthetic-mnist", split, limit=n_eval)
                (data / "mnist" / f"{prefix}-images-idx3-ubyte").write_bytes(
                    np.array([2051, *xm_.shape[:3]], ">i4").tobytes()
                    + xm_.tobytes())
                with gzip.open(data / "mnist" / f"{prefix}-labels-idx1-ubyte.gz",
                               "wb") as f:
                    f.write(np.array([2049, len(ym_)], ">i4").tobytes()
                            + ym_.tobytes())
            bindir = data / "cifar-10-batches-bin"
            bindir.mkdir()
            for split, names in (("train", [f"data_batch_{i}.bin"
                                            for i in range(1, 6)]),
                                 ("test", ["test_batch.bin"])):
                xc_, yc_ = load_dataset("synthetic-cifar10", split, limit=50)
                rec = np.concatenate([yc_[:, None], xc_.transpose(
                    0, 3, 1, 2).reshape(len(xc_), -1)], axis=1)
                for name_, part in zip(names, np.array_split(rec, len(names))):
                    (bindir / name_).write_bytes(part.tobytes())
            for name_, twin in (("mnist", "synthetic-mnist"),
                                ("cifar10", "synthetic-cifar10")):
                for split in ("train", "test"):
                    got = load_dataset(name_, split, str(data))
                    want = load_dataset(twin, split, limit=len(got[0]))
                    if not all(np.array_equal(a_, b_)
                               for a_, b_ in zip(got, want)):
                        fail(f"[foreign] the raw {name_} {split} files do not "
                             "read back as the twin they were written from")
            print(f"[foreign] raw files: MNIST IDX ({n_eval} images a split, "
                  "labels .gz) and CIFAR-10 binary batches read back equal "
                  "to the synthetic twins")
            fparams, fcfg, fextra = load_checkpoint(resolve_checkpoint(FIXTURE))
            if (fcfg.hidden != C or fextra.get("model") != "odenet"
                    or not all(a_.device.type == "cuda"
                               and bool(torch.isfinite(a_).all())
                               for a_ in leaves(fparams))):
                fail("[foreign] the JAX run directory did not load")
            argv = ["--run", str(FIXTURE), "--data-dir", str(data),
                    *stored["argv"]]
            proc = subprocess.run(
                [sys.executable, "-m", "neural_ode_features_tpu_torch.eval_ckpt",
                 *argv], capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                fail(f"[foreign] eval_ckpt exited {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
        want = stored["result"]
        print(f"[foreign] eval_ckpt {' '.join(stored['argv'])} on the card: "
              f"{got}; the JAX tool on the CPU: {want}")
        if (got["top1"] != want["top1"] or got["n"] != want["n"]
                or abs(got["mean_nfe"] - want["mean_nfe"])
                > 0.01 * want["mean_nfe"]):
            fail("[foreign] eval_ckpt disagrees with the JAX tool's numbers")
        phase_done("foreign", t_ph)

    # [population]: `train --seeds` with two seeds at the [train-cli] size,
    # one epoch, counters from 0: two run directories, member 0's weights,
    # training state and log rows (but time_s) bit-identical to the solo
    # run of its seed on the card.
    def population_phase():
        t_ph = time.perf_counter()
        with tempfile.TemporaryDirectory() as runs_p:
            one = ["--dataset", "synthetic-cifar10", "--batch-size",
                   str(B_TRAIN), "--limit", "1280", "--epochs", "1"]
            (runs_pop, t_pop, got_pop) = counted(lambda: train_cli.main(
                [*one, "--seeds", "5,6", "--runs-dir", f"{runs_p}/pop"]))
            solo, t_solo, _ = counted(lambda: Path(train_cli.main(
                [*one, "--seed", "5", "--runs-dir", f"{runs_p}/solo"])))
            member = Path(runs_pop[0])
            same = {"name": member.name == solo.name}
            for name in ("ckpt_last.pt", "train_state.pt"):
                a_, b_ = (torch.load(d_ / name, weights_only=True)
                          for d_ in (member, solo))
                same[name] = a_.keys() == b_.keys() and all(
                    torch.equal(a_[k], b_[k]) for k in a_)
            rows_m, rows_s = ([{k: v for k, v in r.items() if k != "time_s"}
                               for r in log_rows(d_)] for d_ in (member,
                                                                 solo))
            same["log.csv"] = rows_m == rows_s
            n_dirs = len(runs_pop)
        cli_launches["population"] = got_pop
        print(f"[population] train --seeds 5,6: {n_dirs} run directories in "
              f"{t_pop:.1f} s (the solo --seed 5 run {t_solo:.1f} s); "
              f"launches {got_pop}; member 0 against the solo run: {same}")
        if n_dirs != 2 or not all(same.values()):
            fail("[population] member 0 differs from its solo run")
        phase_done("population", t_ph)

    # [serve]: the deployment path.  The entry() model (seed 7) through
    # export_model export-compiled at B = 256 (rowwise must be true), then
    # the serving host in its own process: --selftest and --bench 20, then
    # --listen on a unix socket, driven through the port's SocketClient: one
    # full batch (the first request after READY), sequential full batches
    # and depth-2 streams of them in alternating turns (serve_probe.turns:
    # 256 sequential, 400 streamed), a burst of 64 ragged requests of 1..32
    # rows over one connection and over four, a bad length and a good
    # request after it, the shutdown frame.  The host's totals are read
    # between the parts (SIGUSR1).  Every ragged answer must equal the same
    # rows of the full batch's answer bit for bit; the full batch must agree
    # with the plain path on the CPU; the host's shutdown line gives its
    # launches.
    def serve_phase():
        t_ph = time.perf_counter()
        cpu = torch.device("cpu")
        sparams = init_odenet(7, ENTRY_CONFIG, device=dev)
        with tempfile.TemporaryDirectory(prefix="srv") as tmp:
            tmp = Path(tmp)
            save_checkpoint(tmp / "run" / "ckpt_best.pt", sparams,
                            ENTRY_CONFIG, {"model": "odenet"})
            t_e = time.perf_counter()
            art = export_model.main(
                ["export-compiled", "--run", str(tmp / "run"), "--batch",
                 str(B), "--out", str(tmp / "entry.npexec")])
            t_export = time.perf_counter() - t_e
            meta = json.loads((art / "meta.json").read_text())
            if not meta["rowwise"] or meta["platform"] != "cuda":
                fail(f"[serve] export-compiled: rowwise {meta['rowwise']} on "
                     f"{meta['platform']}")
            X = np.load(art / "sample_input.npy")
            expected = np.load(art / "expected_logits.npy")
            sock = serve_probe.short_addr(tmp)
            err_path = tmp / "host.err"
            with open(err_path, "w+b") as err_f:
                t_h = time.perf_counter()
                host = serve_probe.spawn_host(
                    art, sock, "--selftest", "--bench", "20", "--deadline",
                    "300", err_file=err_f)

                def snap():
                    return serve_probe.host_stats(host, err_path)

                try:
                    selftest = serve_probe.readline_within(host, 300)
                    bench = json.loads(serve_probe.readline_within(host, 120))
                    ready = serve_probe.readline_within(host, 120)
                    t_ready = time.perf_counter() - t_h
                    if (not selftest.startswith("SELFTEST OK max_diff=0.000e+00")
                            or ready != f"READY {sock}"):
                        fail(f"[serve] host: {selftest!r}, {ready!r}")
                    client = SocketClient(sock)
                    s_first = snap()
                    t_r = time.perf_counter()
                    Y = client.infer(X)
                    first_ms = 1e3 * (time.perf_counter() - t_r)
                    s_turns = snap()
                    d_first = serve_probe.delta(s_first, s_turns)
                    res = serve_probe.turns(client, X, Y, snap)
                    offs, sizes, reqs = serve_probe.ragged_burst(X)
                    s_b1 = snap()
                    t_r = time.perf_counter()
                    burst1 = client.infer_burst(reqs)
                    t_burst1 = time.perf_counter() - t_r
                    s_b4 = snap()
                    clients4 = [SocketClient(sock) for _ in range(4)]
                    burst4 = [None] * 4
                    gate = threading.Barrier(4)

                    def one(ci):
                        gate.wait(timeout=60)
                        burst4[ci] = clients4[ci].infer_burst(reqs[ci::4])

                    threads = [threading.Thread(target=one, args=(ci,))
                               for ci in range(4)]
                    t_r = time.perf_counter()
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(timeout=120)
                    t_burst4 = time.perf_counter() - t_r
                    if any(b_ is None for b_ in burst4):
                        fail("[serve] a connection of the 4-way burst failed")
                    s_end = snap()
                    for c_ in clients4:
                        c_.close()
                    client._conn.sendall(struct.pack("<I", 12) + bytes(12))
                    status = client._recv(1)[0]
                    (n_err,) = struct.unpack("<I", client._recv(4))
                    err_msg = client._recv(n_err)
                    after_err = client.infer(X[5:8])
                    client.close(shutdown_server=True)
                    rc = host.wait(timeout=120)
                except TimeoutError as e:
                    err_f.seek(0)
                    fail(f"[serve] {e}; the host's stderr ends: "
                         f"{err_f.read().decode(errors='replace')[-3000:]}")
                finally:
                    if host.poll() is None:
                        host.kill()
                        host.wait(timeout=30)
                err_f.seek(0)
                host_err = err_f.read().decode(errors="replace")
        stats_line = [ln for ln in host_err.splitlines()
                      if "listen: loop ended" in ln]
        if rc != 0 or not stats_line:
            fail(f"[serve] host exit {rc}: {host_err[-3000:]}")
        stats = json.loads(stats_line[-1].split(" stats ", 1)[1])
        got_s = stats["launches"]
        cli_launches["serve"] = got_s

        d_b1 = serve_probe.delta(s_b1, s_b4)
        d_b4 = serve_probe.delta(s_b4, s_end)
        d_full = serve_probe.delta(s_first, s_b1)
        ragged_ok = (all(np.array_equal(y_, Y[o:o + r])
                         for y_, o, r in zip(burst1, offs, sizes))
                     and all(np.array_equal(y_, Y[o:o + r])
                             for ci in range(4)
                             for y_, o, r in zip(burst4[ci], offs[ci::4],
                                                 sizes[ci::4])))
        expected_ok = np.array_equal(Y, expected)
        err_ok = status == 1 and b"expected" in err_msg and np.array_equal(
            after_err, Y[5:8])
        with torch.no_grad():
            want, _ = odenet_logits(tree_to(sparams, cpu), torch.from_numpy(X),
                                    ENTRY_CONFIG)
        want = want.numpy()
        plain_err = float(np.abs(Y - want).max())
        plain_ok = (np.allclose(Y, want, rtol=TOL, atol=TOL)
                    and np.array_equal(Y.argmax(-1), want.argmax(-1)))

        sm = serve_probe.summary(res)
        n_burst = int(sizes.sum())
        print(f"[serve] export-compiled B={B}: rowwise {meta['rowwise']}, "
              f"{t_export:.1f} s; host READY in {t_ready:.1f} s "
              f"(selftest, bench 20, warm-up); {selftest}; bench "
              f"{bench['native_serve_img_per_s_median']:.1f} img/s median "
              f"({1e3 * bench['median_s']:.2f} ms per batch, best "
              f"{bench['img_per_s_best']:.1f} img/s)")
        print(f"[serve] {sock.split(':')[0] if sock.startswith('tcp') else 'unix'}"
              f" socket: the first request after READY {first_ms:.2f} ms "
              f"(solve {d_first['solve_ms']:.2f} ms); {sm['requests']} "
              f"sequential full batches: latency p50 {sm['p50_ms']:.2f} ms, "
              f"p99 {sm['p99_ms']:.2f} ms, max {sm['max_ms']:.2f} ms")
        for t_ in res["turns"]:
            print(f"[serve] turn {t_['kind']:>6}: {t_['requests']} requests, "
                  f"{t_['img_s']:.1f} img/s, {t_['dispatches']} dispatches, "
                  f"attempts {t_['attempts']}, solve {t_['solve_ms']:.2f} ms "
                  "per dispatch (compute thread)")
        print(f"[serve] img/s per turn: sequential "
              f"{[round(v, 1) for v in sm['seq_img_s']]}, stream "
              f"{[round(v, 1) for v in sm['stream_img_s']]}; every stream "
              f"turn above every sequential turn: "
              f"{sm['stream_above_seq_every_turn']}")
        print(f"[serve] burst of 64 ragged requests ({n_burst} rows, 1..32 "
              f"each): one connection {n_burst / t_burst1:.1f} img/s in "
              f"{d_b1['flights']} dispatches ({64 / d_b1['flights']:.2f} "
              f"requests per dispatch, attempts {d_b1['attempts']}); four "
              f"connections {n_burst / t_burst4:.1f} img/s in "
              f"{d_b4['flights']} dispatches ({64 / d_b4['flights']:.2f} "
              f"requests per dispatch, attempts {d_b4['attempts']})")
        print(f"[serve] host totals: {stats['requests']} requests, "
              f"{stats['rows']} rows, {stats['flights']} dispatches, attempts "
              f"{stats['attempts']}; launches {got_s}; ragged answers equal "
              f"to the full batch's rows: {ragged_ok}; turns {res['equal']}; "
              f"full batch = expected_logits.npy: {expected_ok}; bad length "
              f"-> status {status}, next request right: {err_ok}; against "
              f"the plain path on the CPU: max abs err {plain_err:.3e} (tol "
              f"{TOL}), argmax equal {plain_ok}; host exit {rc}")
        print(f"[serve] card: {smi}")
        if not (ragged_ok and res["equal"] and expected_ok and err_ok
                and plain_ok):
            fail("[serve] an answer of the serving host is wrong")
        n_att = sum(int(k) * v for k, v in stats["attempts"].items())
        if (got_s["rk_step"] < 1 or got_s["odefunc"] != 2 * stats["flights"]
                or got_s["rk_step"] != n_att
                or sum(stats["attempts"].values()) != stats["flights"]
                or d_full["requests"] != 1 + len(res["seq_latency_s"]) + sum(
                    t_["requests"] for t_ in res["turns"]
                    if t_["kind"] == "stream")):
            fail(f"[serve] launches {got_s} for {stats['flights']} dispatches")
        print("[serve] summary " + json.dumps({
            "export_s": t_export, "ready_s": t_ready,
            "bench_img_s": bench["native_serve_img_per_s_median"],
            "first_ms": first_ms, **sm,
            "burst1_img_s": n_burst / t_burst1,
            "burst4_img_s": n_burst / t_burst4, "burst_rows": n_burst,
            "burst1_dispatches": d_b1["flights"],
            "burst4_dispatches": d_b4["flights"],
            "attempts_full": d_full["attempts"],
            "attempts_burst1": d_b1["attempts"],
            "attempts_burst4": d_b4["attempts"]}))
        phase_done("serve", t_ph)

    # [bf16]: bf16 on the card.  The kernels' bf16 builds against their
    # plain versions at the shapes the bf16 paths give them and at the card
    # tests' five, each bar beside the f32 build's distance; the entry
    # model's bf16 inference on the host loop and on the cache, against the
    # plain bf16 path on the card; the fused step's conv_precision='bf16'
    # beside the f32 step in one solve each; bf16 training (the Trainer's
    # step, every adjoint variant, direct backprop, Adams) against the
    # plain bf16 path and beside the f32 step; sweep --bf16; train --bf16
    # and its resume; export and serving of the bf16 run; the bf16 probe
    # race; each bf16 build timed.  Returns the kernels line's entries.
    # The probe's two strategies over the rows of every sample (one bf16
    # wgmma template: im2col_bf16, 64 k of the patch matrix a stage, and
    # tap9_bf16, one tap's 64 channels a stage) at the shapes of their
    # gate: every C it takes (multiples of 4 to 128) on 7x7 at B = 5, and
    # at B = 256, 128 and 5 the main shapes, the widest, maps beyond the
    # old per-sample patch (5x5x128, 9x8x64, 32x32x4), a C % 16 != 0, a
    # C % 8 != 0 and the old FFMA gate's 7x7x32, 8x8x64 and 4x4x128; each
    # within CONV_TOL of the plain bf16 conv and outside it of the f32
    # conv; its error against the f64 conv of the rounded operands beside
    # mma_bf16's (at most WGMMA_BAR times); its tile heights bit-identical
    # and timed; its machine code (bf16 HGMMA, none in the f32 im2col);
    # the two bit-identical at C = 64 and 128 (the same stages, summed
    # alike).  Then the fused
    # bf16 builds' FFMA stage alone (what tap9_bf16 was before; timing aid
    # tap9_ffma_bf16) against the plain bf16 conv, and timed.  Returns the
    # max abs error and the FFMA stage's device ms at B = 256.
    def rows_bf16_phase():
        from neural_ode_features_tpu_torch.kernels.conv3x3 import (
            ROWS_STRATEGIES,
            im2col_tile_rows,
        )
        from neural_ode_features_tpu_torch.kernels.conv3x3 import (
            supported as conv_supported,
        )
        from neural_ode_features_tpu_torch.kernels.odefunc import bf16_round
        from neural_ode_features_tpu_torch.probes.timing_aids import (
            tap9_ffma_bf16,
        )

        t_i = time.perf_counter()
        shapes = [(5, (HH, WW), c) for c in range(4, 129, 4)] + [
            (nb, hw_, c) for nb in (B, B_TRAIN, 5) for hw_, c in (
                ((HH, WW), C), ((6, 6), C), ((5, 5), 128), ((9, 8), C),
                ((HH, WW), 128), ((32, 32), 4), ((HH, WW), 36),
                ((14, 14), 16), ((HH, WW), 100), ((HH, WW), 32),
                ((8, 8), C), ((4, 4), 128))]
        err, ratios, same = 0.0, {}, {}
        for nb, hw_, c in shapes:
            xc_, wc_ = conv_probe.probe_inputs(nb, dev, hw_, c)
            plain16_ = conv3x3_plain(xc_, wc_, passes="bf16")
            plain32_ = conv3x3_plain(xc_, wc_)
            exact = e_m = None
            if nb != 5 and conv_supported(hw_, c, "mma_bf16"):
                exact = conv3x3_plain(bf16_round(xc_).double(),
                                      bf16_round(wc_).double())
                e_m = float((conv3x3(xc_, wc_, "mma_bf16").double()
                             - exact).abs().max())
            outs_ = {}
            for strategy in ROWS_STRATEGIES:
                if not conv_supported(hw_, c, strategy):
                    fail(f"[bf16] the {strategy} gate refuses {hw_} x {c}")
                tag = (f"conv_probe {strategy} B={nb} "
                       f"{hw_[0]}x{hw_[1]}x{c}")
                got_ = outs_[strategy] = conv3x3(xc_, wc_, strategy)
                err = max(err, close(tag, got_, plain16_, **CONV_TOL))
                if torch.allclose(got_, plain32_, **CONV_TOL):
                    fail(f"[bf16] {tag}: within the tolerance of the f32 "
                         "conv")
                if exact is not None:
                    e_i = float((got_.double() - exact).abs().max())
                    ratios[tag] = e_i / e_m
                    print(f"[check] {tag} vs the f64 conv of the rounded "
                          f"operands: {e_i:.3e} beside mma_bf16's {e_m:.3e} "
                          f"({e_i / e_m:.2f}x; bar {conv_probe.WGMMA_BAR}x)")
                    if e_i > conv_probe.WGMMA_BAR * e_m:
                        fail(f"[bf16] {tag}: {e_i:.3e} against the f64 conv,"
                             f" over {conv_probe.WGMMA_BAR} x mma_bf16's")
            if c % 64 == 0:
                same[f"B={nb} {hw_[0]}x{hw_[1]}x{c}"] = torch.equal(
                    *outs_.values())
        print(f"[check] conv_probe {' and '.join(ROWS_STRATEGIES)} at "
              f"{len(shapes)} shapes and batches: within rtol "
              f"{CONV_TOL['rtol']}, atol {CONV_TOL['atol']} of "
              f"conv3x3_plain(passes='bf16'), outside it of the f32 conv, "
              f"max abs err {err:.3e}; the two bit-identical at C % 64 == 0: "
              f"{same}")
        if not all(same.values()):
            fail("[bf16] tap9_bf16 and im2col_bf16 sum a stage alike, yet "
                 f"differ where C % 64 == 0: {same}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for strategy in ROWS_STRATEGIES:
            for nb in (B, B_TRAIN):
                xc_, wc_ = conv_probe.probe_inputs(nb, dev)
                outs = {r: conv3x3(xc_, wc_, strategy, tile_rows=r)
                        for r in (64, 128)}
                if not torch.equal(outs[64], outs[128]):
                    fail(f"[bf16] {strategy} B={nb}: 64- and 128-row tiles "
                         "differ")
                tiles = {r: device_ms(lambda r=r: conv3x3(
                    xc_, wc_, strategy, tile_rows=r), reps=100)
                    for r in (64, 128, 64, 128)}
                print(f"[bf16] {strategy} B={nb} {HH}x{WW}x{C}: device ms "
                      f"with 64-row tiles {tiles[64]:.4f}, 128-row "
                      f"{tiles[128]:.4f} (bit-identical; the wrapper takes "
                      f"{im2col_tile_rows(nb * HH * WW, sms, C, WW)} on "
                      f"{sms} SMs)")
        sass = {"im2col_bf16": kernel_sass("conv_probe", "im2col_wgmma_kernel"),
                "tap9_bf16": kernel_sass("conv_probe", "tap9_wgmma_kernel"),
                "im2col": kernel_sass("conv_probe", "13im2col_kernel"),
                "rows": kernel_sass("conv_probe", "16rows_conv_kernel"),
                "odefunc rows": kernel_sass("odefunc", "16rows_conv_kernel")}
        hgmma = {k: sum(1 for ln in v.splitlines()
                        if "HGMMA" in ln and "BF16" in ln)
                 for k, v in sass.items()}
        print(f"[bf16] im2col_bf16 and tap9_bf16 builds: bf16 HGMMA "
              f"instructions {hgmma}")
        if (not hgmma["im2col_bf16"] or not hgmma["tap9_bf16"]
                or not hgmma["rows"] or not hgmma["odefunc rows"]
                or hgmma["im2col"]):
            fail(f"[bf16] bf16 warpgroup products {hgmma}: the im2col_bf16 "
                 "and tap9_bf16 builds and the rows kernel (the probe's and "
                 "the bf16 odefunc's) must hold them, the f32 im2col none")
        ffma_ms = {}
        for nb, c in ((B, C), (B_TRAIN, C), (B, 32)):
            xc_, wc_ = conv_probe.probe_inputs(nb, dev, (HH, WW), c)
            err = max(err, close(
                f"tap9_ffma_bf16 B={nb} {HH}x{WW}x{c}", tap9_ffma_bf16(
                    xc_, wc_), conv3x3_plain(xc_, wc_, passes="bf16"),
                **CONV_TOL))
            ffma_ms[f"B={nb} {HH}x{WW}x{c}"] = device_ms(
                lambda: tap9_ffma_bf16(xc_, wc_), reps=100)
        print(f"[bf16] the fused bf16 builds' FFMA stage alone "
              f"(tap9_kernel<true>, what tap9_bf16 was before): device ms "
              f"{ffma_ms}; {time.perf_counter() - t_i:.1f} s")
        return err, ffma_ms[f"B={B} {HH}x{WW}x{C}"]

    def bf16_phase():
        from neural_ode_features_tpu_torch import serve as serve_cli
        from neural_ode_features_tpu_torch.kernels.conv3x3 import (
            BF16_STRATEGIES,
        )
        from neural_ode_features_tpu_torch.kernels.rk_step import (
            make_fused_dopri5_step,
        )
        from neural_ode_features_tpu_torch.models import odenet_solve
        from neural_ode_features_tpu_torch.probes import bf16_distances
        from neural_ode_features_tpu_torch.solver import attempt_graph
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        t_ph = time.perf_counter()
        cfg16 = dataclasses.replace(ENTRY_CONFIG, compute_dtype="bfloat16")
        rng16 = np.random.default_rng(16)

        def arr(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)

        def rel(got, want):
            return float((got.double() - want.double()).norm()
                         / want.double().norm())

        def held(label, readings):
            """Print ``readings`` (probes/bf16_distances.py) and fail if a
            bar or its f32 control breaks."""
            print(f"[check] {label}: {json.dumps(readings)}")
            bad = bf16_distances.check(readings)
            if bad:
                fail(f"[bf16] {label}: " + "; ".join(bad))
            return readings["max_abs_err"]

        # The kernels against their plain versions, beside the f32 builds.
        # odefunc: the solve's B = 256, the fused sweep's 3·256 rows (three
        # tolerances), a ragged 5, the MNIST block's 6×6×64; rk_step: the
        # main path's step inputs at B = 256 and 5.  Then both at B = 32 at
        # the five shapes of the card tests (7×7×32 to 7×7×512, 6×6×64).
        err_f16 = err_s16 = err_c16 = 0.0
        for hw_, nb in (((HH, WW), B), ((HH, WW), 3 * B), ((HH, WW), 5),
                        ((6, 6), B)):
            h_ = arr(rng16.normal(size=(nb, *hw_, C)) * 0.3)
            t_ = arr(rng16.uniform(0, 1, nb))
            err_f16 = max(err_f16, held(
                f"odefunc bf16 {hw_[0]}x{hw_[1]}x{C} B={nb}",
                bf16_distances.odefunc_readings(
                    prepare(params["odefunc"], hw_), t_, h_, G)))
        for nb in (B, 5):
            err_s16 = max(err_s16, held(
                f"rk_step bf16 {HH}x{WW}x{C} B={nb}",
                bf16_distances.step_readings(
                    w, t0[:nb], dt[:nb], y0[:nb].contiguous(),
                    f0[:nb].contiguous(), hw=(HH, WW), groups=G,
                    rtol=tol_rows[:nb], atol=tol_rows[:nb])))
        for hh_, ww_, c_ in ((7, 7, 32), (7, 7, 64), (7, 7, 128), (7, 7, 512),
                             (6, 6, 64)):
            r_ = bf16_distances.readings_at(hh_, ww_, c_, 32, dev)
            held(f"odefunc bf16 {r_['shape']} B=32", r_["odefunc"])
            held(f"rk_step bf16 {r_['shape']} B=32", r_["rk_step"])
            held(f"odefunc_bwd bf16 {r_['shape']} B=32", r_["odefunc_bwd"])
        # The backward's bf16 build against the plain bf16 VJP (autograd
        # through odefunc_plain in bf16, cuDNN's convs) at the shapes the
        # paths give it: the train step's B = 128, one rank's 64 and a
        # ragged 5 at 7×7×64, the MNIST block's 6×6×64, the FFMA stage's
        # 7×7×32 and the scratch layout's 7×7×512; each output beside the
        # f32 build's distance, f bit-equal to the bf16 forward kernel's,
        # dθ bit-identical over two launches (bf16_distances.bwd_readings).
        # Which per-sample pass each call launched, read from the call
        # captured into a CUDA graph (its kernel node's name, grid, block
        # and shared memory): the gate's (sample_pass), the cluster's
        # kBf16 build at 7×7×64, B = 128 and 16, and 6×6×64, B = 128, and
        # the rows backward at 7×7×512.
        t_b = time.perf_counter()
        err_b16 = 0.0
        bf16_passes = {}
        for hh_, ww_, c_, nb in ((HH, WW, C, B_TRAIN), (HH, WW, C, B_TRAIN // 2),
                                 (HH, WW, C, 16), (HH, WW, C, 5),
                                 (6, 6, C, B_TRAIN), (7, 7, 32, B_TRAIN),
                                 (7, 7, 512, 32)):
            if (hh_, ww_, c_) == (HH, WW, C):
                w_, h_, t_ = w, hb[:nb].contiguous(), tb[:nb].contiguous()
                g_ = gb[:nb].contiguous()
            else:
                w_, h_, t_, _ = bf16_distances.shape_inputs(hh_, ww_, c_, nb,
                                                            dev)
                g_ = arr(rng16.normal(size=tuple(h_.shape)))
            tag = f"{hh_}x{ww_}x{c_} B={nb}"
            err_b16 = max(err_b16, held(
                f"odefunc_bwd bf16 {tag}",
                bf16_distances.bwd_readings(w_, t_, h_, g_, G)))
            gate = sample_pass((hh_, ww_), c_, G, "bf16")
            pass_, grid, block, shared, name = ran_sample_pass(
                lambda: odefunc_bwd(w_, t_, h_, g_, groups=G,
                                    precision="bf16"))
            must = (hh_, ww_, c_, nb) in ((HH, WW, C, B_TRAIN),
                                          (HH, WW, C, 16), (6, 6, C, B_TRAIN))
            if (pass_ != gate or (pass_ != "rows" and "Li2EE" not in name)
                    or (must and pass_ != "cluster")):
                fail(f"[bf16] odefunc_bwd bf16 {tag}: launched {name} (the "
                     f"{pass_} pass); the gate says {gate}"
                     + (", the cluster's bf16 build required" if must else ""))
            bf16_passes[tag] = {"pass": pass_, "grid": grid[0],
                                "block": block[0], "smem_bytes": shared}
            print(f"[check] odefunc_bwd bf16 {tag}: the {pass_} pass "
                  f"({name.split('Ev')[0]}: {grid[0]} CTAs of {block[0]} "
                  f"threads, {shared} B of dynamic shared memory), as the "
                  f"gate says")
        print(f"[bf16] odefunc_bwd bf16 held at seven shapes and batches in "
              f"{time.perf_counter() - t_b:.1f} s; max abs err {err_b16:.3e}")
        # The bf16 ODEfunc kernel's and the fused step's bf16 conv stage at
        # the bf16 paths' maps, from the gate and from the build: the
        # machine code of the kBf16 build and of the fused step's kBf16Conv
        # build holds bf16 warpgroup products (HGMMA ... BF16).
        for hw_ in ((HH, WW), (6, 6)):
            for prec_ in ("bf16", "bf16_conv"):
                if stage(hw_, C, prec_) != "wgmma_bf16":
                    fail(f"[bf16] the gate gives the {prec_} build at {hw_} "
                         f"{stage(hw_, C, prec_)!r}, not 'wgmma_bf16'")
        sass16 = {
            "odefunc kBf16": kernel_sass("odefunc", "odefunc_kernelILb0ELb0ELi2EE"),
            "odefunc_bwd cluster kBf16": kernel_sass(
                "odefunc_bwd", "bwd_sample_kernel_clusterILi2EE"),
            "odefunc_bwd rows conv": kernel_sass(
                "odefunc_bwd", "rows_conv_kernel"),
            "rk_step kBf16Conv": kernel_sass(
                "rk_step", "rk_step_kernelILb0ELb0ELi1EE")}
        hgmma = {k: sum(1 for ln in v.splitlines()
                        if "HGMMA" in ln and "BF16" in ln)
                 for k, v in sass16.items()}
        print(f"[bf16] conv stage: the gate gives 'wgmma_bf16' to the bf16 "
              f"odefunc and the fused step's bf16 convs at {HH}x{WW}x{C} and "
              f"6x6x{C}; bf16 HGMMA instructions in the build: {hgmma}")
        if not all(hgmma.values()):
            fail(f"[bf16] the builds' bf16 warpgroup products {hgmma}: the "
                 "kBf16 odefunc, the cluster pass, the rows backward's conv "
                 "and the fused step's kBf16Conv build must hold them")
        # The probe's bf16 twins: their operands round alike, f32
        # reassociation; the f32 conv lies outside that tolerance.
        for nb, hw_ in ((B, (HH, WW)), (5, (HH, WW)), (B, (6, 6))):
            xc_, wc_ = conv_probe.probe_inputs(nb, dev, hw_)
            plain16 = conv3x3_plain(xc_, wc_, passes="bf16")
            plain32 = conv3x3_plain(xc_, wc_)
            for strategy in BF16_STRATEGIES:
                got_ = conv3x3(xc_, wc_, strategy)
                e_ = close(f"conv_probe {strategy} B={nb} {hw_}", got_,
                           plain16, **CONV_TOL)
                err_c16 = max(err_c16, e_)
                if torch.allclose(got_, plain32, **CONV_TOL):
                    fail(f"[bf16] conv_probe {strategy} B={nb} {hw_}: within "
                         "the tolerance of the f32 conv too")
            print(f"[check] conv_probe {', '.join(BF16_STRATEGIES)} B={nb} "
                  f"{hw_[0]}x{hw_[1]}: within rtol {CONV_TOL['rtol']}, atol "
                  f"{CONV_TOL['atol']} of conv3x3_plain(passes='bf16'), "
                  f"outside it of the f32 conv, max abs err {err_c16:.3e}")
        err_rows, ffma16_ms = rows_bf16_phase()
        err_c16 = max(err_c16, err_rows)

        # The entry model's bf16 inference: on the host loop and on the
        # cache (bit-identical, equal launches: 2 + 6·attempts odefunc, no
        # rk_step), against the plain bf16 dynamics on the card.
        paths16 = {}
        results = {}
        for route, ctx in (("host", host_loop), ("cache",
                                                 contextlib.nullcontext)):
            with ctx(), torch.no_grad():
                results[route] = counted(
                    lambda: odenet_logits(params, x, cfg16))
                results[route + " trajectory"] = counted(
                    lambda: odenet_trajectory(params, x, [0.0, 0.5, 1.0],
                                              cfg16))
        (lg16, st16), t16, n16 = results["cache"]
        att16 = batch_attempts(st16.nfe)
        for key, ((out_, st_), _, n_) in results.items():
            if n_ != {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                      "odefunc_bf16": 2 + 6 * att16}:
                fail(f"[bf16] solve {key}: launches {n_}, not 2 + 6·"
                     f"{att16} of the bf16 odefunc and nothing else")
            ref = results[key.replace("host", "cache")][0]
            if not (torch.equal(out_, ref[0])
                    and torch.equal(st_.nfe, ref[1].nfe)):
                fail(f"[bf16] solve {key}: not bit-identical to the cache")
        paths16 = {"bf16_solve": n16,
                   "bf16_trajectory": results["cache trajectory"][2]}
        with torch.no_grad():
            h016 = stem_apply(params["stem"], x, cfg16)
            ts01 = torch.tensor([0.0, 1.0], device=dev)
            traj_p, st_p = odeint(
                lambda tt, yy: odefunc_plain(w, tt, yy, G, "bf16"),
                h016, ts01, rtol=TOL, atol=TOL, method="dopri5",
                error_control="per_sample", max_steps=cfg16.max_steps)
            lg_p = head_apply(params["head"], traj_p[-1], cfg16)
        with torch.no_grad():
            lg32, st32 = odenet_logits(params, x, ENTRY_CONFIG)
        nfe_share = float((st16.nfe == st_p.nfe).float().mean())
        top1 = float((lg16.argmax(1) == lg_p.argmax(1)).float().mean())
        near = {"plain bf16": rel(lg16, lg_p), "f32": rel(lg16, lg32)}
        print(f"[bf16] solve B={B} tol {TOL} (its first call, a capture): "
              f"{1e3 * t16:.2f} ms, attempts "
              f"{att16}, NFE mean {st16.nfe.float().mean():.2f} (f32 entry "
              f"{st32.nfe.float().mean():.2f}); host loop and cache "
              f"bit-identical;"
              f" launches {n16}; against the plain bf16 path: per-sample NFE "
              f"equal on {nfe_share:.4f} (bar {BF16_NFE_SHARE}), top-1 equal "
              f"on {top1:.4f}, logits max|diff| "
              f"{float((lg16 - lg_p).abs().max()):.3e}, rel-L2 "
              f"{near['plain bf16']:.3e}; against the f32 logits max|diff| "
              f"{float((lg16 - lg32).abs().max()):.3e}, rel-L2 "
              f"{near['f32']:.3e}, top-1 equal on "
              f"{float((lg16.argmax(1) == lg32.argmax(1)).float().mean()):.4f}")
        # Warm solves on the cache, bf16 and f32 dynamics in turns.
        warm = {"bf16": [], "f32": []}
        for _ in range(6):
            for tag, cfg_ in (("bf16", cfg16), ("f32", ENTRY_CONFIG)):
                with torch.no_grad():
                    warm[tag].append(counted(
                        lambda: odenet_logits(params, x, cfg_))[1])
        warm = {k: statistics.median(v[1:]) for k, v in warm.items()}
        print(f"[bf16] warm solve B={B} on the cache, in turns (median of "
              f"5): bf16 {1e3 * warm['bf16']:.2f} ms ({B / warm['bf16']:.1f} "
              f"img/s), f32 with the fused step {1e3 * warm['f32']:.2f} ms "
              f"({B / warm['f32']:.1f} img/s)")
        if (nfe_share < BF16_NFE_SHARE or top1 < 0.99
                or not bool(st16.success.all())
                or near["plain bf16"] >= near["f32"]):
            fail(f"[bf16] solve: NFE share {nfe_share}, top-1 {top1}, "
                 f"logits rel-L2 {near} (want nearer the plain bf16 path)")
        # One cache entry per configuration: a bf16 and an f32 solve of the
        # same weights are two.
        attempt_graph.clear_cache()
        with torch.no_grad():
            for cfg_ in (cfg16, ENTRY_CONFIG, cfg16, ENTRY_CONFIG):
                odenet_solve(params, h016, ts01, cfg_)
        entries = attempt_graph.cache_info(dev)
        print(f"[bf16] cache after bf16, f32, bf16, f32 solves of one model: "
              f"{len(entries)} entries")
        if len(entries) != 2:
            fail("[bf16] a bf16 and an f32 solve did not get two entries")

        # The fused step's conv_precision='bf16' beside the f32 step: one
        # solve each of the entry model (f32 dynamics), per-sample NFE,
        # accepts and rejects side by side.
        steps = {}
        for prec in ("f32", "bf16"):
            step = make_fused_dopri5_step(
                params["odefunc"], DOPRI5, (HH, WW), groups=G, rtol=TOL,
                atol=TOL, conv_precision=prec)
            with torch.no_grad():
                steps[prec] = counted(lambda: odeint(
                    lambda tt, yy: odefunc(w, tt, yy, groups=G), h016, ts01,
                    rtol=TOL, atol=TOL, method="dopri5",
                    error_control="per_sample",
                    max_steps=ENTRY_CONFIG.max_steps, fused_step=step))
        (tr32, s32), _, n32 = steps["f32"]
        (tr_b, s_b), _, n_b = steps["bf16"]
        paths16["bf16_step_solve"] = n_b
        lg_b = head_apply(params["head"], tr_b[-1], ENTRY_CONFIG)
        lg_32 = head_apply(params["head"], tr32[-1], ENTRY_CONFIG)
        for prec, st_, n_ in (("f32", s32, n32), ("bf16", s_b, n_b)):
            print(f"[bf16] {prec} step: NFE mean {st_.nfe.float().mean():.3f}"
                  f" max {int(st_.nfe.max())}, accepts mean "
                  f"{st_.naccept.float().mean():.3f}, rejects mean "
                  f"{st_.nreject.float().mean():.3f} (max "
                  f"{int(st_.nreject.max())}), all reached t = 1: "
                  f"{bool(st_.success.all())}; launches {n_}")
        print(f"[bf16] bf16 step against the f32 step: per-sample NFE equal "
              f"on {float((s_b.nfe == s32.nfe).float().mean()):.4f}, accepts "
              f"{float((s_b.naccept == s32.naccept).float().mean()):.4f}, "
              f"rejects {float((s_b.nreject == s32.nreject).float().mean()):.4f}"
              f"; logits max|diff| {float((lg_b - lg_32).abs().max()):.3e}, "
              f"top-1 equal on "
              f"{float((lg_b.argmax(1) == lg_32.argmax(1)).float().mean()):.4f}")
        want_b = {"odefunc": 2, "odefunc_bwd": 0, "rk_step": 0,
                  "rk_step_bf16": batch_attempts(s_b.nfe)}
        want_32 = {"odefunc": 2, "odefunc_bwd": 0,
                   "rk_step": batch_attempts(s32.nfe)}
        if n_b != want_b or n32 != want_32:
            fail(f"[bf16] the step solves launched {n_b} (bf16 step; want "
                 f"{want_b}) and {n32} (f32 step; want {want_32})")

        # The bf16 train step at train_entry(batch=128)'s configuration,
        # from one set of weights: the Trainer's step twice on the graph
        # route and once on the host loop (the same weights after it, bit
        # for bit: dθ is), each with the launch rule of training in the
        # bf16 builds alone; its time and device busy time beside the f32
        # step's.
        t_b = time.perf_counter()
        trainer32, (images16, labels16) = train_entry(device="cuda",
                                                      batch=B_TRAIN)
        p0 = pytree.tree_map(lambda v: v.detach().clone(), trainer32.params)
        x16 = normalize(torch.from_numpy(images16).to(dev),
                        trainer32.cfg.dataset)
        y16 = torch.from_numpy(labels16).to(dev)

        def trainer_of(**change):
            return Trainer(dataclasses.replace(trainer32.cfg, **change),
                           steps_per_epoch=trainer32.steps_per_epoch,
                           device=dev, params=p0)

        def train_rule(st_, nfe_b_, evals=6):
            return {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                    "odefunc_bf16": 2 + evals * batch_attempts(st_.nfe, evals)
                    + 1, "odefunc_bwd_bf16": int(nfe_b_) - 1}

        stepped = []
        for route_, ctx in (("graph", contextlib.nullcontext),
                            ("graph", contextlib.nullcontext),
                            ("host", host_loop)):
            tr_ = trainer_of(compute_dtype="bfloat16")
            with ctx():
                m_, t_s, n_ = counted(lambda: tr_.train_batch(images16,
                                                              labels16))
            want_ = train_rule(tr_.last_stats, m_["nfe_b"])
            print(f"[bf16] train step B={B_TRAIN} ({route_}): {t_s:.3f} s, "
                  f"loss {m_['loss']:.6f}, NFE-f mean {m_['nfe']:.2f}, "
                  f"NFE-b {int(m_['nfe_b'])}; launches {n_}")
            if n_ != want_:
                fail(f"[bf16] train step ({route_}): launches {n_}, want "
                     f"{want_}")
            stepped.append((flat(tr_.params), n_, m_))
        paths16["bf16_train"] = stepped[0][1]
        if not all(torch.equal(stepped[0][0], s_[0]) for s_ in stepped[1:]):
            fail("[bf16] two bf16 train steps from one set of weights, or the "
                 "graph route and the host loop, gave other weights")
        print("[bf16] train step: the weights after two steps on the graph "
              "route and one on the host loop bit-identical (so is dθ)")
        # The step's time and the device's busy time, bf16 and f32 in turns
        # (median of 3), then one step of each under torch.profiler.
        tr16, tr32 = trainer_of(compute_dtype="bfloat16"), trainer_of()
        step_t = {"bf16": [], "f32": []}
        for _ in range(4):
            for tag, tr_ in (("bf16", tr16), ("f32", tr32)):
                step_t[tag].append(counted(
                    lambda: tr_._grads(tr_.params, x16, y16))[1])
        step_t = {k: statistics.median(v[1:]) for k, v in step_t.items()}
        step_busy = {}
        for tag, tr_ in (("bf16", tr16), ("f32", tr32)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, wall, _ = counted(lambda: tr_._grads(tr_.params, x16, y16))
            step_busy[tag] = (sum(ev.self_device_time_total
                                  for ev in prof.key_averages()
                                  if ev.device_type == DeviceType.CUDA)
                              / 1e3, 1e3 * wall)
        print(f"[bf16] train step B={B_TRAIN} (the Trainer's gradient step, "
              f"graph route), in turns, median of 3: bf16 "
              f"{1e3 * step_t['bf16']:.2f} ms, f32 {1e3 * step_t['f32']:.2f} "
              f"ms; under torch.profiler device busy bf16 "
              f"{step_busy['bf16'][0]:.2f} of {step_busy['bf16'][1]:.2f} ms "
              f"({100 * step_busy['bf16'][0] / step_busy['bf16'][1]:.1f}%), "
              f"f32 {step_busy['f32'][0]:.2f} of {step_busy['f32'][1]:.2f} ms "
              f"({100 * step_busy['f32'][0] / step_busy['f32'][1]:.1f}%)")

        # Each training variant's gradients on the fixed batch (the
        # Trainer's own gradient step) against the plain bf16 path
        # (odefunc_plain in bf16 under autograd, cuDNN) and beside the f32
        # step's: per-sample NFE-f equal to the plain path's on at least
        # 99% of rows (Adams: 95%, below), the gradients nearer the plain
        # bf16 path than the f32 step's; the launches of the training rule
        # in the bf16 builds (direct backprop: bf16 builds only, one
        # backward per recorded evaluation).  Beside them the plain path's
        # own floor: the same path with the stem's output moved by one f32
        # ulp, which flips bf16 roundings as f32 reassociation does.  At
        # random weights the batch's gradient is a small sum of large
        # per-sample terms, so a few flipped roundings move it by tens of
        # percent; Adams' step decisions (Milne ratios of bf16 stages)
        # follow the flips on a few rows, so its bar is the one the sweep
        # holds where rounding decides steps.
        def plain16_grads(cfg_, nudge=False):
            pp = pytree.tree_map(lambda v: v.detach().requires_grad_(), p0)
            h0_ = stem_apply(pp["stem"], x16, cfg_)
            if nudge:
                h0_ = h0_ + (torch.nextafter(
                    h0_, torch.full_like(h0_, float("inf"))) - h0_).detach()
            ts_ = torch.tensor([0.0, 1.0], device=dev)

            def dyn_p(p_, tt, y):
                return odefunc_plain(prepare(p_, (HH, WW)), tt, y, G, "bf16")
            kw_ = dict(rtol=cfg_.tol, atol=cfg_.tol, method=cfg_.method,
                       error_control=cfg_.error_control,
                       max_steps=cfg_.max_steps, controller=cfg_.controller)
            with training_mod._deterministic_cudnn():
                if cfg_.adjoint:
                    traj_, st_ = odeint_adjoint(
                        dyn_p, pp["odefunc"], h0_, ts_,
                        adjoint_seminorm=cfg_.adjoint_seminorm,
                        adjoint_mode=cfg_.adjoint_mode,
                        dense_max_steps=min(cfg_.max_steps, 256), **kw_)
                else:
                    traj_, st_ = odeint(
                        lambda tt, y: dyn_p(pp["odefunc"], tt, y), h0_, ts_,
                        **kw_)
                loss_ = F.cross_entropy(head_apply(pp["head"], traj_[-1],
                                                   cfg_), y16)
                g_ = torch.autograd.grad(loss_, leaves(pp))
            return (float(loss_), torch.cat([a.reshape(-1) for a in g_]),
                    st_)

        variants = (("reintegrate", {}), ("seminorm",
                                          {"adjoint_seminorm": True}),
                    ("interpolated", {"adjoint_mode": "interpolated"}),
                    ("direct", {"adjoint": False}),
                    ("adams", {"solver": "adams"}))
        for tag, change in variants:
            tr_ = trainer_of(compute_dtype="bfloat16", **change)
            (loss_k, _, _, g_k, nfe_b_k), t_k, n_k = counted(
                lambda: tr_._grads(tr_.params, x16, y16))
            st_k = tr_.last_stats
            tr32_ = trainer_of(**change)
            loss_32, _, _, g_32, _ = tr32_._grads(tr32_.params, x16, y16)
            loss_p, g_p, st_p = plain16_grads(tr_.model_cfg)
            _, g_n, st_n = plain16_grads(tr_.model_cfg, nudge=True)
            g_k, g_32 = flat(g_k), flat(g_32)
            share = float((st_k.nfe == st_p.nfe).float().mean())
            floor = (float((st_n.nfe == st_p.nfe).float().mean()),
                     rel(g_n, g_p))
            near = {"plain bf16": rel(g_k, g_p), "f32": rel(g_k, g_32)}
            evals = 2 if tag == "adams" else 6
            if tag == "direct":
                ok_n = (n_k.get("odefunc_bf16", 0) >= 1
                        and n_k.get("odefunc_bwd_bf16", 0) >= 1
                        and not any(n_k[k] for k in ("odefunc", "odefunc_bwd",
                                                     "rk_step")))
            else:
                ok_n = n_k == train_rule(st_k, nfe_b_k, evals)
            nb_p = int(getattr(st_p, "nfe_b", torch.zeros(())))
            print(f"[bf16] {tag} B={B_TRAIN}: {t_k:.3f} s; loss "
                  f"{float(loss_k):.6f} (plain bf16 {loss_p:.6f}, f32 "
                  f"{float(loss_32):.6f}); per-sample NFE-f equal to the "
                  f"plain path's on {share:.4f}, NFE-b {int(nfe_b_k)} (plain "
                  f"{nb_p}); gradients rel-L2 to the plain bf16 path "
                  f"{near['plain bf16']:.3e}, to the f32 step's "
                  f"{near['f32']:.3e}; the plain path with its stem output "
                  f"one ulp up: NFE-f equal on {floor[0]:.4f}, gradients "
                  f"rel-L2 {floor[1]:.3e}; launches {n_k}")
            bar = 0.95 if tag == "adams" else 0.99
            if not ok_n or share < bar or near["plain bf16"] >= near["f32"]:
                fail(f"[bf16] {tag}: launches {n_k}, NFE share {share}, "
                     f"gradients {near} (want nearer the plain bf16 path)")
            paths16[f"bf16_{tag}"] = n_k
        print(f"[bf16] the bf16 train step took {time.perf_counter() - t_b:.1f}"
              f" s")

        with tempfile.TemporaryDirectory() as tmp_b:
            # sweep --bf16 on the card at 1e-1..1e-3, loop and --fused.
            for mode, extra in (("loop", []), ("fused", ["--fused"])):
                rows_, _, n_ = counted(lambda: sweep_cli.main(
                    ["--bf16", "--tols", "1e-1,1e-2,1e-3", *extra,
                     "--output", f"{tmp_b}/sweep_{mode}.csv"]))
                paths16[f"bf16_sweep_{mode}"] = n_
                if (n_.get("odefunc_bf16", 0) < 1 or n_["odefunc"]
                        or n_["rk_step"] or n_["odefunc_bwd"]):
                    fail(f"[bf16] sweep --bf16 {mode}: launches {n_}")
                for r in rows_:
                    print(f"[bf16] sweep --bf16 {mode}: " + " | ".join(
                        f"{k}={v}" for k, v in r.items()) + f"; launches {n_}")

            # train --bf16: one epoch at the train CLI's size (each step by
            # the training rule in the bf16 builds, each evaluation batch
            # 2 + 6·attempts bf16 odefunc and nothing else), then the same
            # run stopped there and launched with --epochs 2 (the 2-epoch
            # identity, as [train-cli] does): it resumes at epoch 1.
            t_b = time.perf_counter()
            base16 = ["--dataset", "synthetic-cifar10", "--bf16",
                      "--batch-size", str(B_TRAIN), "--limit", "1280",
                      "--runs-dir", f"{tmp_b}/runs"]
            run1, t_run, got, st, ev = run_train([*base16, "--epochs", "1"])
            paths16["bf16_train_cli"] = got
            print(f"[bf16] train --bf16 1 epoch: {len(st)} steps, {len(ev)} "
                  f"evaluation batches in {t_run:.1f} s; launches {got}; "
                  f"{run1.name}")
            for i, s_ in enumerate(st):
                want_ = {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                         "odefunc_bf16": 2 + 6 * s_["attempts"] + 1,
                         "odefunc_bwd_bf16": s_["nfe_b"] - 1}
                if s_["launches"] != want_:
                    fail(f"[bf16] train --bf16 step {i}: launches "
                         f"{s_['launches']}, want {want_}")
            for i, e_ in enumerate(ev):
                n16_ = e_.get("odefunc_bf16", 0)
                if (set(k for k, v in e_.items() if v) != {"odefunc_bf16"}
                        or n16_ < 8 or (n16_ - 2) % 6):
                    fail(f"[bf16] train --bf16 evaluation batch {i}: "
                         f"launches {e_}")
            if (len(st), len(ev)) != (10, 10) or "bf16_True" not in run1.name:
                fail(f"[bf16] train --bf16: {len(st)} steps, {len(ev)} "
                     f"evaluation batches, {run1.name}")
            argv2_16 = [*base16, "--epochs", "2"]
            ident2 = train_cli.run_identity(train_cli.parse_args(argv2_16))
            run2 = Path(tmp_b) / "runs" / Experiment.name_from_params(ident2)
            run1.rename(run2)
            for name in ("params.json", "ckpt_last.pt", "ckpt_last.pt.json"):
                (run2 / name).unlink()
            Experiment(f"{tmp_b}/runs", ident2).create()
            run, t_run, got, st, ev = run_train(argv2_16)
            rows = log_rows(run)
            print(f"[bf16] train --bf16 launched again with --epochs 2: "
                  f"{len(st)} steps in {t_run:.1f} s; epochs logged "
                  f"{[r['epoch'] for r in rows]}; train_loss "
                  f"{[r['train_loss'] for r in rows]}; launches {got}")
            if (run != run2 or [r["epoch"] for r in rows] != ["0", "1"]
                    or len(st) != 10 or got.get("odefunc", 0)
                    or got.get("odefunc_bwd", 0) or got.get("rk_step", 0)):
                fail("[bf16] train --bf16 did not resume at epoch 1 in the "
                     "bf16 builds")
            print(f"[bf16] train --bf16 and its resume took "
                  f"{time.perf_counter() - t_b:.1f} s")

            # The bf16 run exported and served on the card: export-compiled
            # and serve --selftest (a dispatch: 2 + 6·attempts bf16 odefunc,
            # no rk_step), then export (the traced program, the bf16
            # operator inside the attempt loop) and run against the live
            # model.
            t_b = time.perf_counter()
            art16, t_e, n_e = counted(lambda: export_model.main([
                "export-compiled", "--run", str(run), "--batch", str(B),
                "--out", f"{tmp_b}/b16.npexec"]))
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc, t_sv, n_sv = counted(lambda: serve_cli.main(
                    [str(art16), "--selftest"]))
            print(f"[bf16] export-compiled B={B}: {t_e:.1f} s, launches "
                  f"{n_e}; serve --selftest: rc {rc}, {t_sv:.1f} s, launches "
                  f"{n_sv}; " + " / ".join(
                      ln.strip() for ln in err.getvalue().splitlines()
                      if "selftest" in ln or "first execute" in ln))
            n16_ = n_sv.get("odefunc_bf16", 0)
            if (rc != 0 or set(k for k, v in n_sv.items() if v)
                    != {"odefunc_bf16"} or (n16_ - 2) % 6 or n16_ < 8):
                fail(f"[bf16] serve --selftest of the bf16 run: rc {rc}, "
                     f"launches {n_sv}")
            paths16["bf16_serve"] = n_sv
            prog16 = f"{tmp_b}/p16.nodeexport"
            _, t_x, n_x = counted(lambda: export_model.main([
                "export", "--run", str(run), "--batch", str(B),
                "--out", prog16]))
            out_r = io.StringIO()
            with contextlib.redirect_stdout(out_r):
                res16, t_r, n_r = counted(lambda: export_model.main([
                    "run", "--artifact", prog16, "--run", str(run)]))
            print(f"[bf16] export B={B}: {t_x:.1f} s, launches {n_x}; run "
                  f"against the live model: {t_r:.1f} s, launches {n_r}; "
                  + " / ".join(out_r.getvalue().split("\n")[-3:]).strip())
            if (res16["agreement"] != 1.0 or res16["max_diff"] > 1e-3
                    or set(k for k, v in n_r.items() if v)
                    != {"odefunc_bf16"}):
                fail(f"[bf16] run of the bf16 program: agreement "
                     f"{res16['agreement']}, max|diff| {res16['max_diff']}, "
                     f"launches {n_r}")
            # One call of the program, and the live bf16 solve of the same
            # run on the same input: 2 + 6·attempts bf16 odefunc each.
            module16, _ = export_model.load_program(Path(prog16), dev)
            params_r, cfg_r, _ = load_checkpoint(resolve_checkpoint(run),
                                                 device=dev)
            with torch.no_grad():
                got_p, _, n_p = counted(lambda: module16(x))
                (want_p, st_l), _, n_l = counted(
                    lambda: odenet_logits(params_r, x, cfg_r))
            rule16 = {"odefunc": 0, "odefunc_bwd": 0, "rk_step": 0,
                      "odefunc_bf16": 2 + 6 * batch_attempts(st_l.nfe)}
            diff_p = float((got_p - want_p).abs().max())
            print(f"[bf16] the bf16 program on the entry input: launches "
                  f"{n_p}, the live bf16 solve {n_l} (rule {rule16}); "
                  f"max|diff| {diff_p:.3e}")
            if (n_p != rule16 or n_l != rule16 or diff_p > 1e-3
                    or not torch.equal(got_p.argmax(-1), want_p.argmax(-1))):
                fail("[bf16] the bf16 program's launches or logits")
            paths16["bf16_export_run"] = n_p
            print(f"[bf16] export and serving took "
                  f"{time.perf_counter() - t_b:.1f} s")

        # The bf16 probe race at B = 256 and 128, the counter from 0.
        conv3x3.launches = 0
        probe16 = conv_probe.main([*BF16_STRATEGIES, "--batch",
                                   f"{B},{B_TRAIN}"])
        paths16["bf16_probe"] = {"conv3x3": conv3x3.launches}
        print(f"[probe] bf16 twins: conv3x3 launches {conv3x3.launches}")
        if conv3x3.launches < 2 * 2 * len(BF16_STRATEGIES):
            fail(f"the bf16 probe launched the conv kernels "
                 f"{conv3x3.launches} times")

        # Times: device ms (spin-queued), the wrapper's call, the plain
        # version, the library call in bf16.
        wt16 = pytree.tree_map(lambda a: a.bfloat16(), params["odefunc"])
        h16, t16_ = h.bfloat16(), t.bfloat16()
        xc, wc = conv_probe.probe_inputs(B, dev)
        xc16, wc16 = xc.bfloat16(), wc.bfloat16()
        fn16 = {
            "odefunc": lambda: odefunc(w, t, h, groups=G,
                                       compute_dtype=torch.bfloat16),
            "rk_step": lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                           conv_precision="bf16", **step_kw),
            "conv": lambda: conv3x3(xc, wc, "mma_bf16"),
            "odefunc_bwd": lambda: odefunc_bwd(w, tb, hb, gb, groups=G,
                                               precision="bf16"),
        }
        ms16 = {k: device_ms(fn) for k, fn in fn16.items()}
        call16 = {k: time_ms(fn) for k, fn in fn16.items()}
        plain16 = {
            "odefunc": time_ms(lambda: odefunc_plain(w, t, h, G, "bf16")),
            "rk_step": time_ms(lambda: dopri5_step_plain(
                w, DOPRI5, t0, dt, y0, f0, conv_precision="bf16",
                **step_kw)),
            "conv": time_ms(lambda: conv3x3_plain(xc, wc, passes="bf16")),
            "odefunc_bwd": time_ms(lambda: odefunc_bwd_plain(
                w, tb, hb, gb, G, precision="bf16")),
        }
        hb16, tb16, gb16 = hb.bfloat16(), tb.bfloat16(), gb.bfloat16()
        lib16 = {"odefunc": time_ms(lambda: library_f(h16, t16_, wt16)),
                 "rk_step": None,
                 "conv": time_ms(lambda: conv_probe.library_conv(xc16, wc16),
                                 reps=100),
                 "odefunc_bwd": time_ms(lambda: library_bwd(hb16, tb16, wt16,
                                                            gb16))}
        # The backward's device time by kernel, beside the f32 build's.
        split16 = {prec: profiled_ms(
            lambda prec=prec: odefunc_bwd(w, tb, hb, gb, groups=G,
                                          precision=prec), bwd_keys)
            for prec in ("bf16", "f32")}
        if None not in split16.values():
            kb16 = bwd_kernel_bounds((HH, WW), C, B_TRAIN,
                                     weight_splits(B_TRAIN, C),
                                     H100_BF16_FLOPS)
            print(f"[split] odefunc_bwd B={B_TRAIN} device ms by kernel, "
                  "bf16 build against the f32 build: " + ", ".join(
                      f"{k} {split16['bf16'][k]:.4f} / "
                      f"{split16['f32'][k]:.4f} (bf16 bound "
                      f"{kb16[k]['bound_ms']:.4f})" for k in bwd_keys)
                  + f"; sum {sum(split16['bf16'].values()):.4f} / "
                  f"{sum(split16['f32'].values()):.4f}")
        twin_ms = {s_: device_ms(lambda s_=s_: conv3x3(xc, wc, s_), reps=100)
                   for s_ in BF16_STRATEGIES}
        lib16_dev = device_ms(lambda: conv_probe.library_conv(xc16, wc16),
                              reps=100)
        print("[time] bf16 builds, ms: " + ", ".join(
            f"{k} device {ms16[k]:.4f} (call {call16[k]:.4f}, plain "
            f"{plain16[k]:.4f}, library "
            f"{'none' if lib16[k] is None else f'{lib16[k]:.4f}'})"
            for k in ms16) + "; probe twins device ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in twin_ms.items())
            + f"; F.conv2d on bf16 tensors device {lib16_dev:.4f}")
        phase_done("bf16", t_ph)

        fb16 = fused_bounds((HH, WW), C, B, B_TRAIN, H100_BF16_FLOPS)
        common = {"shape": f"{HH}x{WW}x{C}", "route": "cuda",
                  "precision": "bf16"}
        return [
            {"name": "odefunc_bf16", **common,
             "source": "neural_ode_features_tpu_torch/csrc/odefunc.cu",
             "replaces": REPLACES["odefunc"],
             "launches": paths16["bf16_solve"]["odefunc_bf16"],
             "max_abs_err": err_f16, "ms": ms16["odefunc"],
             "plain_ms": plain16["odefunc"], **fb16["odefunc"],
             "library_ms": lib16["odefunc"],
             "stage": stage((HH, WW), C, "bf16"),
             "call_ms": call16["odefunc"],
             "launches_by_path": {k: v["odefunc_bf16"]
                                  for k, v in paths16.items()
                                  if "odefunc_bf16" in v}},
            {"name": "rk_step_bf16", **common,
             "source": "neural_ode_features_tpu_torch/csrc/rk_step.cu",
             "replaces": REPLACES["rk_step"],
             "launches": paths16["bf16_step_solve"]["rk_step_bf16"],
             "max_abs_err": err_s16, "ms": ms16["rk_step"],
             "plain_ms": plain16["rk_step"], **fb16["rk_step"],
             "library_ms": None, "stage": stage((HH, WW), C, "bf16_conv"),
             "call_ms": call16["rk_step"]},
            {"name": "odefunc_bwd_bf16", **common,
             "source": "neural_ode_features_tpu_torch/csrc/odefunc_bwd.cu",
             "replaces": REPLACES["odefunc_bwd"],
             "launches": paths16["bf16_train"]["odefunc_bwd_bf16"],
             "max_abs_err": err_b16, "ms": ms16["odefunc_bwd"],
             "plain_ms": plain16["odefunc_bwd"], **fb16["odefunc_bwd"],
             "library_ms": lib16["odefunc_bwd"],
             "stage": stage((HH, WW), C, "bf16"),
             "call_ms": call16["odefunc_bwd"],
             "sample_pass": {**bf16_passes[f"{HH}x{WW}x{C} B={B_TRAIN}"],
                             "ms": (split16["bf16"] or {}).get(
                                 "bwd_sample_kernel"),
                             "bound_ms": bwd_kernel_bounds(
                                 (HH, WW), C, B_TRAIN,
                                 weight_splits(B_TRAIN, C), H100_BF16_FLOPS)[
                                 "bwd_sample_kernel"]["bound_ms"]},
             "ms_by_kernel": split16["bf16"],
             "f32_ms_by_kernel": split16["f32"],
             "launches_by_path": {k: v["odefunc_bwd_bf16"]
                                  for k, v in paths16.items()
                                  if "odefunc_bwd_bf16" in v}},
            {"name": "conv_probe_bf16", **common,
             "source": "neural_ode_features_tpu_torch/csrc/conv_probe.cu",
             "replaces": REPLACES["conv_probe"],
             "launches": paths16["bf16_probe"]["conv3x3"],
             "max_abs_err": err_c16, "ms": ms16["conv"],
             "plain_ms": plain16["conv"],
             **bounds(conv_flops(B, (HH, WW), C), conv_bytes(B, (HH, WW), C),
                      H100_BF16_FLOPS),
             "library_ms": lib16["conv"], "stage": "mma_bf16",
             "call_ms": call16["conv"], "strategy_ms": twin_ms,
             "probe_device_us": {s_: probe16[s_]["device_us"]
                                 for s_ in BF16_STRATEGIES},
             "probe_library_bf16_us": probe16["library_bf16_us"],
             "probe_library_bf16_device_us":
                 probe16["library_bf16_device_us"]},
            {"name": "conv_probe_im2col_bf16", **common,
             "source": "neural_ode_features_tpu_torch/csrc/conv_probe.cu",
             "replaces": REPLACES["conv_probe"],
             "launches": paths16["bf16_probe"]["conv3x3"],
             "max_abs_err": err_c16, "ms": twin_ms["im2col_bf16"],
             "plain_ms": plain16["conv"],
             **bounds(conv_flops(B, (HH, WW), C), conv_bytes(B, (HH, WW), C),
                      H100_BF16_FLOPS),
             "library_ms": lib16_dev, "library_call_ms": lib16["conv"],
             "stage": "im2col_bf16 (wgmma, both operands from shared "
                      "memory)"},
            {"name": "conv_probe_tap9_bf16", **common,
             "source": "neural_ode_features_tpu_torch/csrc/conv_probe.cu",
             "replaces": "probes/conv_probe.py:282",
             "launches": paths16["bf16_probe"]["conv3x3"],
             "max_abs_err": err_c16, "ms": twin_ms["tap9_bf16"],
             "plain_ms": plain16["conv"],
             **bounds(conv_flops(B, (HH, WW), C), conv_bytes(B, (HH, WW), C),
                      H100_BF16_FLOPS),
             "library_ms": lib16_dev, "library_call_ms": lib16["conv"],
             "stage": "tap9_bf16 (per-tap wgmma over the rows of every "
                      "sample)", "ffma_stage_ms": ffma16_ms},
        ]

    # [straggler]: the straggler bench at the JAX tool's defaults on the
    # card (pool 4,096, B = 256, dim 64, tol 1e-6, 3 repeats): its JSON
    # line, tests/test_straggler.py's bars; at --pool 512 --dim 8 the lane
    # work equal to the port's own --cpu run.
    def straggler_phase():
        t_ph = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res, t_b, got = counted(lambda: straggler_bench.main([]))
        print(f"[straggler] ({smi}) {buf.getvalue().strip()}")
        print(f"[straggler] the bench took {t_b:.1f} s; launches {got}")
        if (res["backend"] != "cuda" or any(got.values())
                or res["device_time_shuffled_ms"] is None):
            fail(f"[straggler] backend {res['backend']}, launches {got}")
        if not (res["lane_work_sorted"] < res["lane_work_shuffled"]
                and res["err_units_global"] > 2 * res["err_units_sorted"]):
            fail("[straggler] misses tests/test_straggler.py's bars")
        # The card against the CPU at --pool 512 --dim 8.
        small = ["--pool", "512", "--dim", "8", "--reps", "1"]
        lanes = ("nfe_spread", "lane_work_shuffled", "lane_work_sorted",
                 "lane_work_global", "lane_work_useful")
        with contextlib.redirect_stdout(io.StringIO()):
            on_card = straggler_bench.main(small)
            on_cpu = straggler_bench.main([*small, "--cpu"])
        both = {k: (on_card[k], on_cpu[k]) for k in lanes}
        print(f"[straggler] --pool 512 --dim 8, the card against --cpu: "
              f"{both}")
        if any(a != b for a, b in both.values()):
            fail("[straggler] the lane work on the card differs from the "
                 "CPU's")
        phase_done("straggler", t_ph)
        return res

    # The straggler bench's device busy share: the first batch of each
    # mode's order under torch.profiler, device activity only.
    def straggler_busy():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        lam_np, y0_np, rng_s = straggler_bench.make_pool(4096, 256, 64,
                                                         200.0)
        lam_s = torch.from_numpy(lam_np).to(dev)
        y0_s = torch.from_numpy(y0_np).to(dev)
        shuffled = rng_s.permutation(len(lam_np))
        probe_nfe = straggler_bench.solve_pool(
            lam_s, y0_s, np.arange(len(lam_np)), 256, tol=1e-5,
            error_control="per_sample", controller="i")[0]
        sorted_ = np.argsort(probe_nfe, kind="stable")
        for mode, order, control in (("shuffled", shuffled, "per_sample"),
                                     ("nfe_sorted", sorted_, "per_sample"),
                                     ("global_shuffled", shuffled, "global")):
            def one_batch():
                return straggler_bench.solve_pool(
                    lam_s, y0_s, order[:256], 256, tol=1e-6,
                    error_control=control, controller="i")
            one_batch()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t_s = time.perf_counter()
                nfe_b = one_batch()[0]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t_s
            evs = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
            busy = sum(ev.self_device_time_total for ev in evs) / 1e3
            print(f"[straggler] {mode}, one batch of 256 (largest NFE "
                  f"{int(nfe_b.max())}) under torch.profiler: wall "
                  f"{1e3 * wall:.2f} ms, {sum(ev.count for ev in evs)} device "
                  f"kernels, device busy {busy:.2f} ms "
                  f"({100 * busy / (1e3 * wall):.1f}%)")

    def hold_kernels(w_, hw_, tag, odefunc_rows, step_rows, bwd_rows):
        """The three fused kernels against their plain versions at ``hw_``
        and these batch sizes (the backward against the f64 plain
        version)."""
        for nb in sorted(set(odefunc_rows) | set(step_rows) | set(bwd_rows)):
            h_ = torch.from_numpy((rng.normal(size=(nb, *hw_, C)) * 0.3)
                                  .astype(np.float32)).to(dev)
            t_ = torch.from_numpy(rng.uniform(0, 1, nb)
                                  .astype(np.float32)).to(dev)
            shape = f"{hw_[0]}x{hw_[1]}x{C} B={nb}"
            f_ = odefunc_plain(w_, t_, h_, G)
            if nb in odefunc_rows:
                err = close(f"{tag} odefunc {shape}",
                            odefunc(w_, t_, h_, groups=G), f_, **STATE_TOL)
                print(f"[check] {tag} odefunc {shape}: max abs err {err:.3e}")
            if nb in step_rows:
                dt_ = torch.from_numpy(rng.uniform(0.05, 0.2, nb)
                                       .astype(np.float32)).to(dev)
                tol_ = torch.full((nb,), TOL, device=dev)
                kw_ = dict(hw=hw_, groups=G, rtol=tol_, atol=tol_)
                y_, f0_ = h_.reshape(nb, -1), f_.reshape(nb, -1)
                got = dopri5_step(w_, DOPRI5, t_, dt_, y_, f0_, **kw_)
                want = dopri5_step_plain(w_, DOPRI5, t_, dt_, y_, f0_, **kw_)
                err = max(close(f"{tag} rk_step {n_} {shape}", g_, r_,
                                **STATE_TOL)
                          for n_, g_, r_ in zip(("y1", "f1", "y_mid"),
                                                got[:3], want[:3]))
                close(f"{tag} rk_step ratio {shape}", got[3], want[3],
                      **RATIO_TOL)
                print(f"[check] {tag} rk_step {shape}: max abs err "
                      f"{err:.3e}, ratio within tolerance")
            if nb in bwd_rows:
                g_ = torch.from_numpy(rng.normal(size=h_.shape)
                                      .astype(np.float32)).to(dev)
                check_bwd(w_, (t_, h_, g_), f"{tag} {shape}")
        torch.cuda.synchronize()

    # [graph]: the 'while' attempt loop replayed as a CUDA graph (every
    # phase above ran through it) against the private host loop on the
    # card: bit-identical results and equal launch counts on every path,
    # then the times of both in alternating turns, the capture on its own,
    # the device's busy share, the straggler bench's modes and the reserved
    # memory over 100 solves.
    def graph_phase():
        from neural_ode_features_tpu_torch.solver import (
            attempt_graph,
            runge_kutta,
        )
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        t_ph = time.perf_counter()
        captures = []  # host seconds of each capture
        real_capture = attempt_graph._capture

        def timed_capture(*args):
            t_s = time.perf_counter()
            real_capture(*args)
            captures.append(time.perf_counter() - t_s)

        attempt_graph._capture = timed_capture

        @contextlib.contextmanager
        def capture_per_solve():
            """Every 'while' solve on the graph route without the cache:
            one capture per solve (no cache key)."""
            saved = runge_kutta._while_loop
            runge_kutta._while_loop = (
                lambda body, carry, n, capturable, key=None:
                saved(body, carry, n, capturable, None))
            try:
                yield
            finally:
                runge_kutta._while_loop = saved

        def route(name):
            return {"host": host_loop, "solve": capture_per_solve,
                    "graph": contextlib.nullcontext}[name]()

        def equal(a, b):
            if isinstance(a, torch.Tensor):
                return torch.equal(a, b)
            if isinstance(a, np.ndarray):
                return np.array_equal(a, b)
            if isinstance(a, dict):
                return a.keys() == b.keys() and all(equal(a[k], b[k])
                                                    for k in a)
            if isinstance(a, (tuple, list)):
                return len(a) == len(b) and all(map(equal, a, b))
            return a == b

        def both(tag, fn, want=None):
            """``fn()`` through the graph route (from an empty cache) and
            the host loop, counters from 0 before each: bit-identical
            results, equal launches (and ``want(result)``'s, where given),
            at least one capture."""
            attempt_graph.clear_cache()
            n_cap = len(captures)
            got_g, t_g, n_g = counted(fn)
            n_cap = len(captures) - n_cap
            with host_loop():
                got_h, t_h, n_h = counted(fn)
            rule = n_g if want is None else want(got_g)
            print(f"[graph] {tag}: graph {t_g:.3f} s ({n_cap} capture(s)), "
                  f"host loop {t_h:.3f} s; launches {n_g} (host loop {n_h}); "
                  f"bit-identical: {equal(got_g, got_h)}")
            if not equal(got_g, got_h):
                fail(f"[graph] {tag}: the graph route differs from the host "
                     "loop")
            if n_g != n_h or n_g != rule:
                fail(f"[graph] {tag}: launches {n_g}, host loop {n_h}, rule "
                     f"{rule}")
            if n_cap < 1:
                fail(f"[graph] {tag}: no capture: the graph route was not "
                     "taken")
            return got_g

        def solve_rule(res):
            st = res[1]
            return {"odefunc": 2, "odefunc_bwd": 0,
                    "rk_step": int((st.naccept + st.nreject).max())}

        with torch.no_grad():
            both(f"entry model B={B}", lambda: odenet_logits(params, x, cfg),
                 solve_rule)
            both("entry model B=5",
                 lambda: odenet_logits(params, x[:5].contiguous(), cfg),
                 solve_rule)
            mixed_g = torch.tensor(SWEEP_TOLS, device=dev).repeat_interleave(B)
            both(f"fused sweep {n_grid}x{B} stacked rows, tolerances "
                 f"{SWEEP_TOLS}",
                 lambda: odenet_logits(params, x.repeat(n_grid, 1, 1, 1), cfg,
                                       tol=mixed_g), solve_rule)
            efwd, ep, ex = handles[T_OUT]
            both(f"extraction batch B={B} T={T_OUT}", lambda: efwd(ep, ex),
                 solve_rule)
        n_pad = 2 * B + 88  # two full batches and a padded one
        both(f"extract_features {n_pad} images (last batch padded), "
             "nfe_sort", lambda: extract_features(
                 eparams, ecfg, test_images[:n_pad], test_labels[:n_pad],
                 nfe_sort=True, **ekw))
        x_g = trainer._preprocess(images, train=False)
        y_g = trainer._labels(labels)

        def train_grads():
            loss_, _, nfe_, grads_, nfe_b_ = trainer._grads(
                trainer.params, x_g, y_g)
            return loss_, nfe_, nfe_b_, grads_, tuple(trainer.last_stats)

        def train_rule(res):
            att = int((res[4][1] + res[4][2]).max())
            return {"odefunc": 2 + 6 * att + 1,
                    "odefunc_bwd": int(res[4][4]) - 1, "rk_step": 0}

        both(f"adjoint train step B={B_TRAIN} (loss, NFE-f, NFE-b, dθ)",
             train_grads, train_rule)

        # Times, in alternating turns of the host loop and the graph
        # (median of 5 after a warm turn), and the captures alone.
        def clock(fn):
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t_s, out

        def train_split():
            x_t = trainer._preprocess(images, train=True)
            y_t = trainer._labels(labels)
            t_f, (loss_, *_) = clock(lambda: trainer._loss_and_logits(
                trainer.params, x_t, y_t))
            t_b, _ = clock(lambda: torch.autograd.grad(loss_,
                                                       trainer._leaves))
            return t_f, t_b

        # The solve and the extraction batch on three routes: the host
        # loop, a capture per solve (no cache key) and the cache
        # ("graph": every attempt a replay of the shape's cached graph);
        # the train step (no cache: its weights change every step) on two.
        solve_k = f"solve B={B}"
        train_k = f"train step B={B_TRAIN} (forward, backward)"
        ext_k = f"extraction batch B={B} T={T_OUT}"
        runs = {
            solve_k: lambda: (clock(lambda: fwd(params, x))[0],),
            train_k: train_split,
            ext_k: lambda: (clock(
                lambda: handles[T_OUT][0](*handles[T_OUT][1:]))[0],),
        }
        routes_of = {solve_k: ("host", "solve", "graph"),
                     train_k: ("host", "graph"),
                     ext_k: ("host", "solve", "graph")}
        times = {k: {r: [] for r in routes_of[k]} for k in runs}
        cap_ms = {k: {r: [] for r in routes_of[k]} for k in runs}
        for rep in range(6):
            for r in ("host", "solve", "graph"):
                for k, fn in runs.items():
                    if r not in routes_of[k]:
                        continue
                    n_cap = len(captures)
                    with route(r):
                        ts_ = fn()
                    if rep:
                        times[k][r].append(ts_)
                        cap_ms[k][r].extend(1e3 * c
                                            for c in captures[n_cap:])
        names = {"host": "host loop", "solve": "a capture per solve",
                 "graph": "the cache"}
        graph_times = {}
        for k, v in times.items():
            med_ = {r: [1e3 * statistics.median(part) for part in zip(*v[r])]
                    for r in v}
            graph_times[k] = med_
            print(f"[graph] {k}, ms (median of 5, in turns): " + "; ".join(
                f"{names[r] if k != train_k or r == 'host' else 'graph'} "
                f"{', '.join(f'{m:.2f}' for m in med_[r])} "
                f"({len(cap_ms[k][r]) / 5:g} captures per call"
                + (f", {statistics.median(cap_ms[k][r]):.2f} ms each"
                   if cap_ms[k][r] else "") + ")" for r in v))
        for k in (solve_k, ext_k):
            if graph_times[k]["graph"][0] > graph_times[k]["host"][0]:
                fail(f"[graph] {k}: the cached route's median "
                     f"{graph_times[k]['graph'][0]:.2f} ms is slower than "
                     f"the host loop's {graph_times[k]['host'][0]:.2f} ms")

        # The cache: one capture over 20 solves of one shape; a weight
        # changed in place (its version counter moves) or another tolerance
        # misses and captures anew, bit-identical to the host loop.
        attempt_graph.clear_cache()
        n_cap = len(captures)
        with torch.no_grad():
            for _ in range(20):
                fwd(params, x)
        n_20 = len(captures) - n_cap
        print(f"[graph] cache: {n_20} capture(s) over 20 solves B={B}")
        if n_20 != 1:
            fail(f"[graph] {n_20} captures over 20 same-shape solves, not 1")
        bias = params["odefunc"]["conv2"]["bias"]
        for tag, change, undo, tol_ in (
                ("in-place weight change", lambda: bias.add_(0.05),
                 lambda: bias.sub_(0.05), None),
                ("tolerance 3e-4", lambda: None, lambda: None, 3e-4)):
            with torch.no_grad():
                change()
                n_cap = len(captures)
                got_c = odenet_logits(params, x, cfg, tol=tol_)
                n_miss = len(captures) - n_cap
                with host_loop():
                    want_c = odenet_logits(params, x, cfg, tol=tol_)
                undo()
            same = (torch.equal(got_c[0], want_c[0])
                    and torch.equal(got_c[1].nfe, want_c[1].nfe))
            print(f"[graph] cache after a {tag}: {n_miss} new capture(s), "
                  f"bit-identical to the host loop: {same}")
            if n_miss != 1 or not same:
                fail(f"[graph] the cache after a {tag}: {n_miss} captures, "
                     f"bit-identical {same}: a stale replay")

        # The kernel each launch counter counts, by its name on the device.
        prof_names = {"odefunc": "odefunc_kernel",
                      "odefunc_bwd": "bwd_sample_kernel",
                      "rk_step": "rk_step_kernel"}

        def busy(label, fn):
            """``fn()`` under torch.profiler: the device's busy share, and
            the kernels the profiler saw held against the launch counters
            (on the graph route, the replays' kernels)."""
            fn()
            zero_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall, _ = clock(fn)
            counters = read_counts()
            evs = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
            seen = {k: sum(ev.count for ev in evs if name in ev.key)
                    for k, name in prof_names.items()}
            dev_busy = sum(ev.self_device_time_total for ev in evs) / 1e3
            print(f"[graph] {label} under torch.profiler: wall "
                  f"{1e3 * wall:.2f} ms, {sum(ev.count for ev in evs)} device "
                  f"kernels, device busy {dev_busy:.2f} ms "
                  f"({100 * dev_busy / (1e3 * wall):.1f}%); kernels seen "
                  f"{seen}, counters {counters}")
            if seen != counters:
                fail(f"[graph] {label}: the profiler saw {seen} launches, "
                     f"the counters say {counters}")
            return dev_busy

        # The busy share also against the unprofiled medians above (the
        # profiler slows the capture more than the host loop).
        for r in ("host", "graph"):
            with route(r):
                b_solve = busy(f"{r}: one solve B={B}",
                               lambda: fwd(params, x))
                b_train = busy(f"{r}: one train step B={B_TRAIN}",
                               lambda: trainer._grads(trainer.params, x_g,
                                                      y_g))
            print(f"[graph] {r}: device busy against the unprofiled "
                  f"medians: solve "
                  f"{100 * b_solve / graph_times[solve_k][r][0]:.1f}%, "
                  f"train step "
                  f"{100 * b_train / sum(graph_times[train_k][r]):.1f}%")

        # The straggler bench's three modes, one repetition each, on the
        # host loop and through the graph (the [straggler] phase below runs
        # the bench at its defaults through the graph).
        lanes = {}
        for r in ("host", "graph"):
            with route(r):
                with contextlib.redirect_stdout(io.StringIO()):
                    res_s = straggler_bench.main(["--reps", "1"])
            lanes[r] = [res_s[k] for k in res_s if k.startswith("lane_")]
            print(f"[graph] straggler bench --reps 1, {r}: " + ", ".join(
                f"{k} {res_s[k]}" for k in (
                    "time_shuffled_s", "time_nfe_sorted_s",
                    "time_global_shuffled_s", "probe_s",
                    "lane_work_shuffled", "lane_work_sorted",
                    "lane_work_global")))
        if lanes["host"] != lanes["graph"]:
            fail("[graph] the straggler bench's lane work differs between "
                 "the routes")

        # The graph pools' bytes (the cache entry's own pool on the
        # extraction batch; the thread's pool on the train step, made anew)
        # and the reserved memory after one call and at its peak, against
        # the host loop.
        def pool_bytes(k):
            if k.startswith("extraction"):
                return sum(e["pool_bytes"] for e in attempt_graph.cache_info())
            pool = attempt_graph._local.pools[
                torch.device("cuda", torch.cuda.current_device())][0]
            return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                       if tuple(seg["segment_pool_id"]) == tuple(pool))

        mem_runs = {
            ext_k: runs[ext_k],
            f"train step B={B_TRAIN}": lambda: trainer._grads(
                trainer.params, x_g, y_g),
        }
        for k, fn in mem_runs.items():
            mem = {}
            for r in ("host", "graph"):
                attempt_graph._local.pools.clear()
                attempt_graph.clear_cache()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                with route(r):
                    fn()
                torch.cuda.synchronize()
                mem[r] = (torch.cuda.memory_reserved(),
                          torch.cuda.max_memory_reserved())
            print(f"[graph] memory, {k}: the graph pool holds "
                  f"{pool_bytes(k)} B after it; reserved after it "
                  f"{mem['host'][0]} B on the "
                  f"host loop, {mem['graph'][0]} B on the graph route "
                  f"({mem['graph'][0] - mem['host'][0]:+d} B); peak "
                  f"{mem['host'][1]} B and {mem['graph'][1]} B "
                  f"({mem['graph'][1] - mem['host'][1]:+d} B)")

        # The route without the cache (a capture per solve): a pool per
        # solve, given back at its end (a MemPool, whose memory goes back to
        # the device when it is dropped), against the thread's pool: the
        # extraction batch, median of 5 in turns.
        thread_pool = attempt_graph._pool
        held = []

        def pool_per_solve(device):
            held.append(torch.cuda.MemPool())
            return held[-1].id

        per_solve = {"thread": [], "solve": []}
        for rep in range(6):
            for kind in ("thread", "solve"):
                if kind == "solve":
                    attempt_graph._pool = pool_per_solve
                torch.cuda.synchronize()
                t_s = time.perf_counter()
                try:
                    with capture_per_solve():
                        handles[T_OUT][0](*handles[T_OUT][1:])
                    held.clear()  # the pool's memory goes back
                    torch.cuda.synchronize()
                finally:
                    attempt_graph._pool = thread_pool
                if rep:
                    per_solve[kind].append(1e3 * (time.perf_counter() - t_s))
        print(f"[graph] {ext_k}, ms (median of 5, in turns): the thread's "
              f"pool {statistics.median(per_solve['thread']):.2f}, a pool per "
              f"solve released at its end "
              f"{statistics.median(per_solve['solve']):.2f}")

        # No graph pool leaks: the reserved memory after 100 solves within
        # 1% of its value after 10 (the allocator's cache emptied first, so
        # that the earlier phases' blocks do not hide a leak); the cache's
        # entries after them, each with its pool's bytes.
        attempt_graph.clear_cache()
        torch.cuda.empty_cache()
        with torch.no_grad():
            for i in range(100):
                fwd(params, x)
                if i == 9:
                    torch.cuda.synchronize()
                    reserved_10 = torch.cuda.memory_reserved()
        torch.cuda.synchronize()
        reserved_100 = torch.cuda.memory_reserved()
        print(f"[graph] reserved memory after 10 solves {reserved_10} B, "
              f"after 100 {reserved_100} B ({reserved_100 - reserved_10:+d} "
              f"B)")
        if abs(reserved_100 - reserved_10) > 0.01 * reserved_10:
            fail("[graph] the reserved memory grows with the solves")
        entries = attempt_graph.cache_info()
        print(f"[graph] cache after them: {len(entries)} entr"
              f"{'y' if len(entries) == 1 else 'ies'} (bound "
              f"{attempt_graph.CACHE_ENTRIES} per thread and device): "
              + "; ".join(f"B={e['batch']}: {e['pool_bytes']} B of pool, "
                          f"{e['replayed_solves']} solves replayed"
                          for e in entries))
        if len(entries) != 1 or entries[0]["replayed_solves"] != 99:
            fail(f"[graph] the cache after 100 solves of one shape: "
                 f"{entries}")

        # Misses past the bound: CACHE_ENTRIES + 2 keys (tolerances near
        # the entry model's, one shape) in turn for 4 rounds, so that every
        # solve misses, evicts the oldest entry and captures into its pool.
        # The reserved memory after the last round within 1% of its value
        # after the first; the ms of a miss (eager first attempt, capture,
        # replays) beside the routes' medians above.
        attempt_graph.clear_cache()
        torch.cuda.empty_cache()
        n_keys = attempt_graph.CACHE_ENTRIES + 2
        miss_tols = [1e-3 * (1 + 0.02 * k) for k in range(n_keys)]
        n_cap = len(captures)
        miss_ms, reserved_rounds = [], []
        with torch.no_grad():
            for _ in range(4):
                for tol_ in miss_tols:
                    miss_ms.append(1e3 * clock(lambda: odenet_logits(
                        params, x, cfg, tol=tol_))[0])
                reserved_rounds.append(torch.cuda.memory_reserved())
        n_miss = len(captures) - n_cap
        print(f"[graph] cache misses: {n_keys} keys in turn, 4 rounds, "
              f"{n_miss} captures; reserved after round 1 "
              f"{reserved_rounds[0]} B, after round 4 {reserved_rounds[-1]} "
              f"B ({reserved_rounds[-1] - reserved_rounds[0]:+d} B); a miss "
              f"{statistics.median(miss_ms):.2f} ms (median of "
              f"{len(miss_ms)}) against the solve's host loop "
              f"{graph_times[solve_k]['host'][0]:.2f}, a capture per solve "
              f"{graph_times[solve_k]['solve'][0]:.2f} and a hit "
              f"{graph_times[solve_k]['graph'][0]:.2f}; pools "
              + ", ".join(str(e["pool_bytes"])
                          for e in attempt_graph.cache_info()) + " B")
        if n_miss != 4 * n_keys:
            fail(f"[graph] {n_miss} captures over {4 * n_keys} solves of "
                 f"{n_keys} keys in turn, not one each")
        if (abs(reserved_rounds[-1] - reserved_rounds[0])
                > 0.01 * reserved_rounds[0]):
            fail("[graph] the reserved memory grows with the cache's misses")
        attempt_graph._capture = real_capture
        phase_done("graph", t_ph)
        return graph_times

    # [export]: the code-free program.  The entry model (seed 7) through
    # ``export_model export`` at B = 256 on the card (torch.export: the
    # kernels as the operators nodef::odefunc and nodef::dopri5_step, the
    # attempt loop as while_loop), then ``run`` against the live model
    # (argmax agreement 1.0, max|diff| <= 1e-3).  The program's own call on
    # the entry input with the counters from 0 just before and read just
    # after: 2 odefunc and one rk_step per attempt of the live solve, held
    # against torch.profiler's kernel counts; its logits against the live
    # fwd's; img/s of the artifact and of the live fwd in alternating turns
    # (median of 5); the artifact's bytes.  Then ``export-mock`` and the
    # port's host on it (``serve --selftest`` on the card).
    def export_phase():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        t_ph = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="exp") as tmp:
            tmp = Path(tmp)
            save_checkpoint(tmp / "run" / "ckpt_best.pt", params, cfg,
                            {"model": "odenet"})
            buf = io.StringIO()
            t_s = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                art = export_model.main(["export", "--run", str(tmp / "run"),
                                         "--batch", str(B)])
            t_export = time.perf_counter() - t_s
            meta = json.loads(Path(f"{art}.json").read_text())
            if (meta["platforms"] != ["cuda"]
                    or meta["input_shape"] != [B, 32, 32, 3]
                    or meta["bytes"] != art.stat().st_size):
                fail(f"[export] sidecar {meta}")
            with contextlib.redirect_stdout(buf):
                res = export_model.main(["run", "--artifact", str(art),
                                         "--run", str(tmp / "run"), "--reps",
                                         "3"])
            for line in buf.getvalue().splitlines():
                if line.startswith(("exported", "artifact runs", "parity")):
                    print(f"[export] {line}")
            if res["agreement"] != 1.0 or res["max_diff"] > 1e-3:
                fail(f"[export] run: agreement {res['agreement']}, "
                     f"max|diff| {res['max_diff']}")
            module, _ = export_model.load_program(art, dev)
            with torch.no_grad():
                got_x, _, n_x = counted(lambda: module(x))
                want_x, nfe_x = fwd(params, x)
            rule = {"odefunc": 2, "odefunc_bwd": 0,
                    "rk_step": batch_attempts(nfe_x)}
            diff_x = float((got_x - want_x).abs().max())
            agree_x = bool(torch.equal(got_x.argmax(-1), want_x.argmax(-1)))
            print(f"[export] the program on the entry input: launches {n_x} "
                  f"(rule {rule}), max|diff| against the live fwd "
                  f"{diff_x:.3e}, argmax equal {agree_x}; traced and saved "
                  f"in {t_export:.1f} s, {meta['bytes']} bytes")
            if n_x != rule or diff_x > 1e-3 or not agree_x:
                fail("[export] the program's launches or logits")
            prof_names = {"odefunc": "odefunc_kernel",
                          "odefunc_bwd": "bwd_sample_kernel",
                          "rk_step": "rk_step_kernel"}
            zero_counts()
            with torch.no_grad(), profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                module(x)
                torch.cuda.synchronize()
            evs = [ev for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA]
            seen = {k: sum(ev.count for ev in evs if name in ev.key)
                    for k, name in prof_names.items()}
            print(f"[export] under torch.profiler: kernels seen {seen}, "
                  f"counters {read_counts()}")
            if seen != read_counts():
                fail("[export] the profiler's kernel counts differ from the "
                     "launch counters")
            turns = {"artifact": [], "live": []}
            for rep in range(6):
                for k, fn_ in (("artifact", lambda: module(x)),
                               ("live", lambda: fwd(params, x))):
                    torch.cuda.synchronize()
                    t_s = time.perf_counter()
                    with torch.no_grad():
                        fn_()
                    torch.cuda.synchronize()
                    if rep:
                        turns[k].append(time.perf_counter() - t_s)
            med_x = {k: statistics.median(v) for k, v in turns.items()}
            print(f"[export] B={B} in turns (median of 5): the artifact "
                  f"{B / med_x['artifact']:.1f} img/s "
                  f"({1e3 * med_x['artifact']:.2f} ms), the live fwd "
                  f"{B / med_x['live']:.1f} img/s "
                  f"({1e3 * med_x['live']:.2f} ms)")
            with contextlib.redirect_stdout(io.StringIO()):
                mock = export_model.main(["export-mock", "--out",
                                          str(tmp / "mock.npexec")])
            host = subprocess.run(
                [sys.executable, "-m", "neural_ode_features_tpu_torch.serve",
                 str(mock), "--selftest"], capture_output=True, text=True,
                timeout=300, cwd=Path(__file__).resolve().parent)
            print(f"[export] export-mock, the port's host on it: rc "
                  f"{host.returncode}, {host.stdout.strip()}")
            if (host.returncode != 0
                    or "SELFTEST OK" not in host.stdout):
                fail(f"[export] serve --selftest on the mock artifact: "
                     f"{host.stderr[-2000:]}")
        phase_done("export", t_ph)
        return {"export": n_x}

    # [examples]: both examples on the card.  solver_playground (no fused
    # kernel: it must launch none) fits γ within 1e-3; continuous_features
    # trains 32 adjoint steps at B = 64 on 6×6×64 maps and extracts 512
    # test images at 9 times from one solve: per step 2 + 6·attempts + 1
    # odefunc and NFE-b − 1 odefunc_bwd launches, per features solve 2
    # odefunc and one rk_step per attempt; 9 finite mAPs.  The kernels are
    # held against their plain versions at these shapes.
    def examples_phase():
        t_ph = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gamma, t_pg, got_pg = counted(lambda: solver_playground.main([]))
        for line in buf.getvalue().strip().splitlines():
            print(f"[examples] solver_playground: {line}")
        print(f"[examples] solver_playground took {t_pg:.1f} s; launches "
              f"{got_pg}")
        if abs(gamma - solver_playground.TRUE_GAMMA) >= 1e-3 or any(
                got_pg.values()):
            fail(f"[examples] solver_playground: γ {gamma}, launches {got_pg}")

        steps.clear()
        solves = []
        plain_features = ODENet.features

        def watched_features(self, *a, **k):
            before = read_counts()
            out = plain_features(self, *a, **k)
            after = read_counts()
            solves.append({"launches": {n: after[n] - before[n]
                                        for n in after},
                           "attempts": batch_attempts(out[1].nfe)})
            return out

        Trainer.train_batch, ODENet.features = watched_train, watched_features
        lines = []
        try:
            res, t_cf, got_cf = counted(
                lambda: continuous_features.run(log=lines.append))
        finally:
            Trainer.train_batch, ODENet.features = plain_train, plain_features
        for line in lines:
            if line.strip():
                print(f"[examples] continuous_features: {line.strip()}")
        print(f"[examples] continuous_features took {t_cf:.1f} s; launches "
              f"{got_cf}; {len(steps)} steps, features solve {solves}")
        maps = res["maps"]
        if len(maps) != 9 or not np.all(np.isfinite(maps)):
            fail(f"[examples] continuous_features mAPs {maps}")
        if len(steps) != 32 or len(solves) != 1:
            fail(f"[examples] {len(steps)} steps, {len(solves)} solves")
        for i, s_ in enumerate(steps):
            want = {"odefunc": 2 + 6 * s_["attempts"] + 1,
                    "odefunc_bwd": s_["nfe_b"] - 1, "rk_step": 0}
            if s_["launches"] != want:
                fail(f"[examples] step {i}: launches {s_['launches']}, "
                     f"expected {want}")
        sv = solves[0]
        if sv["launches"] != {"odefunc": 2, "odefunc_bwd": 0,
                              "rk_step": sv["attempts"]}:
            fail(f"[examples] features solve launches {sv}")
        total = {n: sum(s_["launches"][n] for s_ in steps)
                 + sv["launches"][n] for n in got_cf}
        if total != got_cf:
            fail(f"[examples] launches {got_cf}, the steps' and the solve's "
                 f"sum {total}")
        w_ex = prepare(res["trainer"].full_params()["odefunc"], (6, 6))
        hold_kernels(w_ex, (6, 6), "[examples]", (64, 512), (512,), (64,))
        phase_done("examples", t_ph)
        return {"examples": got_cf}

    # [protocol]: reference_protocol --dataset mnist --fabricate on the
    # card, 1 epoch of 512 images: the fabricated files, then train,
    # eval_ckpt and parity_eval each in its own process.  The verdict must
    # have the JAX tool's keys (those of its committed
    # runs_protocol/mnist_verdict.json), say data: fabricated and hold the
    # parity clause.  Then the same protocol with each step's main run in
    # this process, the launches watched: per train step and evaluation
    # batch the rules of [train-cli], per eval_ckpt and parity_eval batch 2
    # odefunc and one rk_step per attempt; its verdict equal to the
    # subprocesses'.  The kernels are held at the protocol's other shapes
    # (6×6×64 at B = 512, parity_eval's 100 and 12).
    def protocol_phase():
        t_ph = time.perf_counter()
        jax_keys = list(json.loads((Path(__file__).resolve().parent
                                    / "runs_protocol" / "mnist_verdict.json")
                                   .read_text()))
        args = dict(epochs=1, limit=512, cpu=False, fabricated=True)
        with tempfile.TemporaryDirectory(prefix="proto") as tmp_p:
            tmp_p = Path(tmp_p)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                reference_protocol.fabricate("mnist", tmp_p / "data", 512)
                t_s = time.perf_counter()
                verdict = reference_protocol.run_protocol(
                    "mnist", tmp_p / "data", runs_root=tmp_p / "runs",
                    **args)
                t_sub = time.perf_counter() - t_s
            for line in buf.getvalue().strip().splitlines():
                print(f"[protocol] {line.removeprefix('[protocol] ')}")
            print(f"[protocol] the three steps in their own processes took "
                  f"{t_sub:.1f} s")
            if list(verdict) != jax_keys:
                fail(f"[protocol] verdict keys {list(verdict)}, the JAX "
                     f"tool's {jax_keys}")
            if (verdict["data"] != "fabricated"
                    or verdict["parity_within_0.2pct"] is not True
                    or verdict["parity"].get("device") != "cuda"):
                fail(f"[protocol] verdict {verdict}")

            # The same steps in this process, the launches watched.
            by_tool = {}

            def in_process(cmd, timeout):
                tool = cmd[2].rsplit(".", 1)[1]
                if tool == "train":
                    run, _, got, st, ev = run_train(cmd[3:])
                    by_tool[tool] = (got, st, ev)
                    return types.SimpleNamespace(stdout=f"run dir: {run}\n")
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc_, _, got = counted(lambda: importlib.import_module(
                        cmd[2]).main(cmd[3:]))
                if rc_ not in (None, 0) and isinstance(rc_, int):
                    raise RuntimeError(f"{tool} exited {rc_}")
                by_tool[tool] = (got, out.getvalue())
                return types.SimpleNamespace(stdout=out.getvalue())

            sub = reference_protocol._sub
            reference_protocol._sub = in_process
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    again = reference_protocol.run_protocol(
                        "mnist", tmp_p / "data", runs_root=tmp_p / "again",
                        **args)
            finally:
                reference_protocol._sub = sub
        got_t, st, ev = by_tool["train"]
        for i, s_ in enumerate(st):
            want = {"odefunc": 2 + 6 * s_["attempts"] + 1,
                    "odefunc_bwd": s_["nfe_b"] - 1, "rk_step": 0}
            if s_["launches"] != want:
                fail(f"[protocol] train step {i}: launches "
                     f"{s_['launches']}, expected {want}")
        for i, e_ in enumerate(ev):
            if (e_["odefunc"] != 2 or e_["odefunc_bwd"] != 0
                    or e_["rk_step"] < 1):
                fail(f"[protocol] evaluation batch {i}: launches {e_}")
        for tool, n_batches in (("eval_ckpt", 1), ("parity_eval", 6)):
            got_, _ = by_tool[tool]
            if (got_["odefunc"] != 2 * n_batches or got_["odefunc_bwd"]
                    or got_["rk_step"] < n_batches):
                fail(f"[protocol] {tool}: launches {got_} over {n_batches} "
                     "batches")
        print(f"[protocol] in this process: train {len(st)} steps and "
              f"{len(ev)} evaluation batches, launches {got_t}; eval_ckpt "
              f"{by_tool['eval_ckpt'][0]}; parity_eval "
              f"{by_tool['parity_eval'][0]}; top-1 {again['top1']} against "
              f"the subprocesses' {verdict['top1']}; parity "
              f"{again['parity_within_0.2pct']}")
        if (len(st) != 4 or again["top1"] != verdict["top1"]
                or again["parity_within_0.2pct"] is not True):
            fail("[protocol] the in-process run differs from the "
                 "subprocesses'")
        hold_kernels(prepare(params["odefunc"], (6, 6)), (6, 6), "[protocol]", (512, 100, 12),
                     (512, 100, 12), ())
        phase_done("protocol", t_ph)
        return {"protocol": {n: got_t[n] + by_tool["eval_ckpt"][0][n]
                             + by_tool["parity_eval"][0][n]
                             for n in got_t}}

    def bench_phase(main_nfe, solve_ips):
        """[bench]: the headline bench as a user types it, three records
        (default, ``--pool 2048 --nfe-sort``, ``--bf16``), each in its own
        process; per record rc 0 and complete, the card's backend, the
        fused step where it runs, the mean NFE of this process's solves of
        the same weights and input, the FLOP figures, the baseline, the
        CUDA-event figure within 10% of the host clock's, and the launches
        its stderr line reports by the inference rule."""
        t_ph = time.perf_counter()
        base = ["--iters", "8", "--repeats", "3", "--cpu-batches", "2"]
        runs = {"bench": base,
                "bench_pool": [*base, "--pool", "2048", "--nfe-sort"],
                "bench_bf16": [*base, "--bf16"]}
        # The NFE each record must report: [main]'s solve (the same
        # weights, seed 7, and input, numpy seed 0), and this process's
        # solves of the bench's pool (drawn next from that generator) and
        # of the bf16 dynamics.
        rng_b = np.random.default_rng(0)
        x_b = torch.from_numpy(rng_b.normal(size=(B, 32, 32, 3))
                               .astype(np.float32)).to(dev)
        x_pool = torch.from_numpy(rng_b.normal(size=(2048, 32, 32, 3))
                                  .astype(np.float32)).to(dev)
        bcfg = ModelConfig(in_channels=3, tol=TOL,
                           error_control="per_sample")
        bparams = init_odenet(7, bcfg, device=dev)
        with torch.no_grad():
            pool_nfe = torch.cat([
                odenet_logits(bparams, xb, bcfg)[1].nfe
                for xb in x_pool.split(B)]).float().mean()
            bf16_nfe = odenet_logits(
                bparams, x_b, dataclasses.replace(
                    bcfg, compute_dtype="bfloat16"))[1].nfe.float().mean()
        want_nfe = {"bench": main_nfe, "bench_pool": float(pool_nfe),
                    "bench_bf16": float(bf16_nfe)}
        peak = peak_flops_per_chip(torch.cuda.get_device_name(0))
        out = {}
        for name, argv in runs.items():
            t_s = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "neural_ode_features_tpu_torch.bench",
                 *argv], cwd=str(Path(__file__).resolve().parent),
                capture_output=True, text=True, timeout=300)
            took = time.perf_counter() - t_s
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("{")]
            rec = json.loads(lines[-1]) if lines else {}
            print(f"[bench] {name} ({' '.join(argv)}): rc {proc.returncode} "
                  f"in {took:.1f} s: {json.dumps(rec)}")
            if proc.returncode != 0 or not rec or rec.get("incomplete"):
                fail(f"[bench] {name}: rc {proc.returncode}, record {rec}; "
                     f"stderr: {proc.stderr[-3000:]}")
            bf16 = name == "bench_bf16"
            if (rec["backend"] != "cuda" or rec["fused_rk"] is bf16
                    or rec["pallas"] is not True):
                fail(f"[bench] {name}: backend {rec['backend']}, fused_rk "
                     f"{rec['fused_rk']}, pallas {rec['pallas']}")
            if rec["mean_nfe"] != round(want_nfe[name], 1):
                fail(f"[bench] {name}: mean_nfe {rec['mean_nfe']}, this "
                     f"process's solves {want_nfe[name]:.3f}")
            if rec["tflops"] is None or rec["mfu"] is None or peak is None:
                fail(f"[bench] {name}: tflops {rec['tflops']}, mfu "
                     f"{rec['mfu']}, peak {peak}")
            if abs(rec["mfu"] - rec["tflops"] * 1e12 / peak) > 1e-6 + (
                    5e-4 * 1e12 / peak):  # tflops has 3 decimals
                fail(f"[bench] {name}: mfu {rec['mfu']} is not tflops "
                     f"{rec['tflops']} over {peak:.3e}")
            if rec["vs_baseline"] is None and not rec.get("baseline_note"):
                fail(f"[bench] {name}: no vs_baseline and no baseline_note")
            ratio = rec["value_cuda_events"] / rec["value"]
            if abs(ratio - 1) > 0.10:
                fail(f"[bench] {name}: CUDA events {rec['value_cuda_events']}"
                     f" img/s against the host clock's {rec['value']}")
            if name == "bench_pool" and "pool_ips_sorted_with_probe" not in rec:
                fail(f"[bench] {name}: no pool keys")
            # "[bench +  t s] launches in N solves, A attempts: {json}"
            line = next(ln for ln in proc.stderr.splitlines()
                        if "launches in" in ln)
            head, counts = line.split(" attempts: ", 1)
            solves, attempts = (int(v) for v in re.findall(
                r"launches in (\d+) solves, (\d+)$", head)[0])
            got = json.loads(counts)
            f32, b16 = (("odefunc_bf16", "odefunc") if bf16
                        else ("odefunc", "odefunc_bf16"))
            # The inference rule over the record's solves: f32, 2 odefunc
            # per solve and one rk_step per attempt; bf16, 2 + 6·attempts
            # odefunc_bf16 per solve and no rk_step; no backward, no
            # launch of the other precision.
            ok = (got[b16] == 0 and got["rk_step_bf16"] == 0
                  and got["odefunc_bwd"] == got["odefunc_bwd_bf16"] == 0
                  and attempts >= solves
                  and (got[f32] == 2 * solves + 6 * attempts
                       and got["rk_step"] == 0
                       if bf16 else
                       got[f32] == 2 * solves
                       and got["rk_step"] == attempts))
            print(f"[bench] {name}: value {rec['value']} img/s (CUDA events "
                  f"{rec['value_cuda_events']}, ratio {ratio:.4f}) beside "
                  f"[time]'s whole solve {solve_ips:.1f} img/s; mean_nfe "
                  f"{rec['mean_nfe']} (this process: {want_nfe[name]:.3f}); "
                  f"tflops {rec['tflops']}, mfu {rec['mfu']}, vs_baseline "
                  f"{rec['vs_baseline']}; launches in {solves} solves, "
                  f"{attempts} attempts {got}")
            if not ok:
                fail(f"[bench] {name}: launches {got} in {solves} solves, "
                     f"{attempts} attempts")
            out[name] = got
        phase_done("bench", t_ph)
        return out

    width_kernels = width_phase()
    foreign_phase()
    population_phase()
    cli_launches.update(parallel_phase(smi))
    serve_phase()
    # 8. Times.
    wt = params["odefunc"]
    lib_err = float((library_f(h, t, wt) - odefunc_plain(w, t, h, G))
                    .abs().max())
    print(f"[time] library f vs plain f: max abs err {lib_err:.3e}")

    lib_dh = library_bwd(hb, tb, wt, gb)[0]
    print(f"[time] library f backward vs plain backward: dh max abs err "
          f"{float((lib_dh - odefunc_bwd_plain(w, tb, hb, gb, G)[2]).abs().max()):.3e}")
    ms = {
        "odefunc": time_ms(lambda: odefunc(w, t, h, groups=G)),
        "odefunc_plain": time_ms(lambda: odefunc_plain(w, t, h, G)),
        "odefunc_library": time_ms(lambda: library_f(h, t, wt)),
        "rk_step": time_ms(lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                               **step_kw)),
        "rk_step_plain": time_ms(lambda: dopri5_step_plain(
            w, DOPRI5, t0, dt, y0, f0, **step_kw)),
        "odefunc_bwd": time_ms(lambda: odefunc_bwd(w, tb, hb, gb, groups=G)),
        "odefunc_bwd_plain": time_ms(lambda: odefunc_bwd_plain(w, tb, hb,
                                                               gb, G)),
        "odefunc_bwd_library": time_ms(lambda: library_bwd(hb, tb, wt, gb)),
    }
    # The operators' dispatch on the host: one wrapper call (the layout,
    # the gate, torch.ops.nodef.*, then the launch) against the launch
    # alone, host µs per call over 200 calls queued with no sync.
    from neural_ode_features_tpu_torch.kernels import odefunc as odefunc_mod
    from neural_ode_features_tpu_torch.kernels import rk_step as rk_step_mod

    def host_us(fn, n: int = 200) -> float:
        fn()
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        for _ in range(n):
            fn()
        us = 1e6 * (time.perf_counter() - t_s) / n
        torch.cuda.synchronize()
        return us

    t_rows = t.contiguous()
    dispatch_us = {
        "odefunc": host_us(lambda: odefunc(w, t, h, groups=G)),
        "odefunc launch": host_us(
            lambda: odefunc_mod.launch(w, t_rows, h, G)),
        "rk_step": host_us(lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0,
                                               **step_kw)),
        "rk_step launch": host_us(lambda: rk_step_mod.launch(
            w, t0, dt, y0, f0, tol_rows, tol_rows, (HH, WW), G)),
    }
    print("[time] host µs per call (200 queued, no sync): " + ", ".join(
        f"{k} {v:.1f}" for k, v in dispatch_us.items()) + "; the wrapper "
        "and its operator cost "
        f"{dispatch_us['odefunc'] - dispatch_us['odefunc launch']:.1f} and "
        f"{dispatch_us['rk_step'] - dispatch_us['rk_step launch']:.1f} µs "
        "above the launch")
    # Device time of each kernel (the events above time the wrapper's
    # calls, which cannot go below the host's cost of a launch): calls
    # queued behind a spin (device_ms), and beside it the mean of the
    # launches torch.profiler recorded, by kernel name.
    runs_k = {
        "odefunc": (lambda: odefunc(w, t, h, groups=G), ("odefunc_kernel",)),
        "rk_step": (lambda: dopri5_step(w, DOPRI5, t0, dt, y0, f0, **step_kw),
                    ("rk_step_kernel",)),
        "odefunc_bwd": (lambda: odefunc_bwd(w, tb, hb, gb, groups=G),
                        bwd_keys),
    }
    dev_ms = {k: device_ms(fn) for k, (fn, _) in runs_k.items()}
    prof_ms = {k: profiled_ms(fn, keys) for k, (fn, keys) in runs_k.items()}
    prof_ms = {k: None if v is None else sum(v.values())
               for k, v in prof_ms.items()}
    # The fused step at the fused sweep's size: the grid of len(SWEEP_TOLS)
    # tolerances stacked on the batch axis (every row computes its attempt
    # whether or not its solve is done).
    stacked_args = [a.repeat(n_grid, *([1] * (a.ndim - 1)))
                    for a in (t0, dt, y0, f0)]
    stacked_tol = torch.tensor(SWEEP_TOLS, device=dev).repeat_interleave(B)
    stacked_ms = device_ms(
        lambda: dopri5_step(w, DOPRI5, *stacked_args, **dict(
            step_kw, rtol=stacked_tol, atol=stacked_tol)))
    print(f"[time] rk_step at {n_grid}·{B} = {n_grid * B} rows (the fused "
          f"sweep's launch): device {stacked_ms:.4f} ms, "
          f"{stacked_ms / n_grid:.4f} per {B} rows against "
          f"{dev_ms['rk_step']:.4f} at B={B}")
    print("[time] kernels, ms: " + ", ".join(
        f"{k} device {dev_ms[k]:.4f} (profiler "
        f"{'not measured' if prof_ms[k] is None else f'{prof_ms[k]:.4f}'}; "
        f"call {ms[k]:.4f})" for k in dev_ms))
    xc, wc = conv_probe.probe_inputs(B, dev)
    conv_dev_ms = {}
    for strategy in STRATEGIES:
        ms[f"conv_{strategy}"] = time_ms(
            lambda s_=strategy: conv3x3(xc, wc, s_), reps=100)
        conv_dev_ms[strategy] = device_ms(
            lambda s_=strategy: conv3x3(xc, wc, s_), reps=100)
    ms["conv_plain"] = time_ms(lambda: conv3x3_plain(xc, wc), reps=100)
    ms["conv_library"] = time_ms(lambda: conv_probe.library_conv(xc, wc),
                                 reps=100)
    print("[time] one 3x3 conv B=%d, calls: " % B + ", ".join(
        f"{k[5:]} {1e3 * ms[k]:.1f} us" for k in ms if k.startswith("conv_"))
        + "; device: " + ", ".join(
            f"{k} {1e3 * v:.1f} us" for k, v in conv_dev_ms.items())
        + " (the probe's own device readings: " + ", ".join(
            f"{k} {probe[k]['device_us']:.1f}" for k in STRATEGIES)
        + f", F.conv2d {probe['library_us']:.1f} us)")

    # One extraction batch through extract_entry, warm: T = 11 beside T = 2
    # in turns (the same solve; the difference is the dense write and the
    # pooling).
    handles = {n_t: extract_entry(device="cuda", batch=B, timestamps=n_t)
               for n_t in (T_OUT, 2)}
    extract_s = {n_t: [] for n_t in handles}
    for rep in range(6):  # the first turn warms up and is dropped
        for n_t, (efwd, ep, ex) in handles.items():
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            efeats, estats = efwd(ep, ex)
            torch.cuda.synchronize()
            if rep:
                extract_s[n_t].append(time.perf_counter() - t_s)
            if tuple(efeats.shape) != (n_t, B, C):
                fail(f"extract_entry: features {tuple(efeats.shape)}")
    med_e = {k: statistics.median(v) for k, v in extract_s.items()}
    print(f"[time] extraction batch B={B}: T={T_OUT} "
          f"{B / med_e[T_OUT]:.1f} img/s ({1e3 * med_e[T_OUT]:.2f} ms, "
          f"median of {extract_s[T_OUT]}); T=2 {B / med_e[2]:.1f} img/s "
          f"({1e3 * med_e[2]:.2f} ms, median of {extract_s[2]}); attempts "
          f"{int(((estats.nfe - 2) // 6).max())}")
    solve_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        fwd(params, x)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t_s)
    plain_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        plain_forward()
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t_s)
    solve_ips = B / statistics.median(solve_s)  # printed beside [bench]
    print(f"[time] whole solve B={B}: {B / statistics.median(solve_s):.1f} "
          f"img/s with the kernels (median of {solve_s}), "
          f"{B / statistics.median(plain_s):.1f} img/s plain "
          f"(median of {plain_s})")

    # The train step, warm: whole steps, then the forward and the backward
    # solve apart (the same work as train_batch, without the update).
    step_s, fwd_s, bwd_s = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        trainer.train_batch(images, labels)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_s)
    for _ in range(5):
        x_t = trainer._preprocess(images, train=True)
        y_t = trainer._labels(labels)
        torch.cuda.synchronize()
        t_s = time.perf_counter()
        loss, _, _, _ = trainer._loss_and_logits(trainer.params, x_t, y_t)
        torch.cuda.synchronize()
        t_m = time.perf_counter()
        torch.autograd.grad(loss, trainer._leaves)
        torch.cuda.synchronize()
        fwd_s.append(t_m - t_s)
        bwd_s.append(time.perf_counter() - t_m)
    # Where the time goes: one warm train step and one warm extraction batch
    # under torch.profiler, device time by kernel (the profiler's own cost
    # is in the wall time).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_profile(label, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_s = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t_s
        groups = {"odefunc": "odefunc_kernel", "odefunc_bwd": "bwd_",
                  "rk_step": "rk_step_kernel"}
        dev_ms = dict.fromkeys([*groups, "other"], 0.0)
        others = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:  # a host op: its kernels
                continue                           # are entries of their own
            ms_ = ev.self_device_time_total / 1e3
            name = next((g for g, key in groups.items() if key in ev.key),
                        "other")
            dev_ms[name] += ms_
            if name == "other" and ms_ > 0:
                others.append((ms_, ev.count, ev.key[:60]))
        busy = sum(dev_ms.values())
        n_kernels = sum(ev.count for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA)
        print(f"[profile] {label} under torch.profiler: {n_kernels} device "
              f"kernels, wall "
              f"{1e3 * prof_wall:.2f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / (1e3 * prof_wall):.1f}%), idle "
              f"{100 * (1 - busy / (1e3 * prof_wall)):.1f}%; device ms by "
              f"kernel "
              f"{json.dumps({k: round(v, 3) for k, v in dev_ms.items()})}")
        for ms_, count, key in sorted(others, reverse=True)[:8]:
            print(f"[profile]   other: {ms_:.3f} ms in {count} calls: {key}")

    device_profile(f"one train step B={B_TRAIN}",
                   lambda: trainer.train_batch(images, labels))
    device_profile(f"one extraction batch B={B} T={T_OUT}",
                   lambda: handles[T_OUT][0](*handles[T_OUT][1:]))
    with torch.no_grad():
        device_profile(f"one adams solve B={B} tol {TOL}",
                       lambda: odenet_logits(params, x, acfg))
        device_profile(f"one event solve B={B} tol {TOL}",
                       lambda: event_solve(
                           lambda tt, y: odefunc(w, tt, y, groups=G)))

    # [determinism]: one fixed batch's gradients (augment off) twice through
    # the trainer's step, which runs cuDNN's deterministic algorithms: they
    # must be bit-identical (cuDNN's default stem weight gradients were not).
    x_d = trainer._preprocess(images, train=False)
    y_d = trainer._labels(labels)
    g_two = [flat(trainer._grads(trainer.params, x_d, y_d)[3])
             for _ in range(2)]
    print(f"[determinism] one batch's gradients twice through the step, "
          f"bit-identical: {torch.equal(*g_two)}")
    if not torch.equal(*g_two):
        fail("[determinism] the step's gradients differ from call to call")
    # What the deterministic algorithms cost a dopri5 train step: the step
    # with the trainer's cuDNN context and with none (the process's default
    # algorithms), in turns.
    det_cudnn = training_mod._deterministic_cudnn
    step_det = {True: [], False: []}
    for _ in range(3):
        for det in (True, False):
            training_mod._deterministic_cudnn = (
                det_cudnn if det else contextlib.nullcontext)
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            trainer.train_batch(images, labels)
            torch.cuda.synchronize()
            step_det[det].append(time.perf_counter() - t_s)
    training_mod._deterministic_cudnn = det_cudnn
    print(f"[determinism] train step B={B_TRAIN} in turns: deterministic "
          f"{1e3 * statistics.median(step_det[True]):.2f} ms (median of "
          f"{step_det[True]}), cuDNN default "
          f"{1e3 * statistics.median(step_det[False]):.2f} ms (median of "
          f"{step_det[False]})")

    med = statistics.median
    print(f"[time] train step B={B_TRAIN}: {B_TRAIN / med(step_s):.1f} img/s "
          f"(median of {step_s}); forward solve {1e3 * med(fwd_s):.2f} ms "
          f"(median of {fwd_s}), backward solve {1e3 * med(bwd_s):.2f} ms "
          f"(median of {bwd_s}); over the 5 checked steps NFE-f mean "
          f"{statistics.mean(nfe_f):.2f}, NFE-b mean {statistics.mean(nfe_b):.1f}")

    graph_phase()
    cli_launches.update(export_phase())
    # This slice's paths run last: after their hundreds of thousands of
    # small launches and their subprocesses, torch.profiler missed every
    # rk_step launch of the timing windows above in two of three runs.
    bf16_kernels = bf16_phase()
    straggler_phase()
    straggler_busy()
    cli_launches.update(examples_phase())
    cli_launches.update(protocol_phase())
    cli_launches.update(bench_phase(main_mean_nfe, solve_ips))

    fb = fused_bounds((HH, WW), C, B, B_TRAIN)
    fused_stage = stage((HH, WW), C)
    kernels = [
        {"name": "odefunc", "shape": f"{HH}x{WW}x{C}", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/odefunc.cu",
         "replaces": REPLACES["odefunc"],
         "launches": launches["odefunc"], "max_abs_err": err_k1,
         "ms": dev_ms["odefunc"], "profiler_ms": prof_ms["odefunc"],
         "plain_ms": ms["odefunc_plain"],
         **fb["odefunc"],
         "library_ms": ms["odefunc_library"], "stage": fused_stage,
         "call_ms": ms["odefunc"]},
        {"name": "rk_step", "shape": f"{HH}x{WW}x{C}", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/rk_step.cu",
         "replaces": REPLACES["rk_step"],
         "launches": launches["rk_step"], "max_abs_err": err_k2,
         "ms": dev_ms["rk_step"], "profiler_ms": prof_ms["rk_step"],
         "plain_ms": ms["rk_step_plain"],
         **fb["rk_step"],
         "library_ms": None, "stage": fused_stage,
         "call_ms": ms["rk_step"], "tolerances": "(B,) arrays",
         "stacked_rows": n_grid * B, "stacked_ms": stacked_ms},
        {"name": "odefunc_bwd", "shape": f"{HH}x{WW}x{C}", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/odefunc_bwd.cu",
         "replaces": REPLACES["odefunc_bwd"],
         "launches": train_launches[-1]["odefunc_bwd"], "max_abs_err": err_k4,
         "ms": dev_ms["odefunc_bwd"], "profiler_ms": prof_ms["odefunc_bwd"],
         "plain_ms": ms["odefunc_bwd_plain"],
         **fb["odefunc_bwd"],
         "library_ms": ms["odefunc_bwd_library"], "stage": fused_stage,
         "call_ms": ms["odefunc_bwd"], "ms_by_kernel": bwd_split,
         "sample_pass": sample_pass_info,
         "bound_ms_by_kernel": {k: v["bound_ms"] for k, v in bwd_kb.items()},
         "weight_kernel": weight_info},
        {"name": "conv_probe", "shape": f"{HH}x{WW}x{C}", "route": "cuda",
         "source": "neural_ode_features_tpu_torch/csrc/conv_probe.cu",
         "replaces": REPLACES["conv_probe"],
         "launches": probe_launches, "max_abs_err": err_k5,
         "ms": conv_dev_ms["mma3"], "plain_ms": ms["conv_plain"],
         **bounds(conv_flops(B, (HH, WW), C), conv_bytes(B, (HH, WW), C)),
         "library_ms": ms["conv_library"], "stage": "mma3",
         "call_ms": ms["conv_mma3"], "strategy_ms": conv_dev_ms,
         "strategy_call_ms": {s_: ms[f"conv_{s_}"] for s_ in STRATEGIES}},
    ]
    # The launches of every path this script drove, counters from 0 before
    # each: the three earlier paths and this slice's CLIs.
    by_path = {"inference": launches, "train_step": train_launches[-1],
               "extract": extract_launches, "adams": adams_launches,
               "event": event_launches,
               "event_adjoint": event_adjoint_launches, **cli_launches}
    for k in kernels[:3]:
        k["launches_by_path"] = {path: got_[k["name"]]
                                 for path, got_ in by_path.items()}
    for name, path in (("odefunc", "train"), ("odefunc_bwd", "train"),
                       ("rk_step", "sweep_fused"), ("odefunc", "adams"),
                       ("odefunc", "event"), ("odefunc_bwd", "event_adjoint"),
                       ("odefunc_bwd", "train_adams"),
                       ("odefunc", "sweep_adams_fused"),
                       ("odefunc_bwd", "train_hidden128"),
                       ("odefunc_bwd", "train_hidden512"),
                       ("odefunc_bwd_bf16", "train_hidden512_bf16"),
                       ("rk_step", "parity_run"),
                       ("odefunc_bwd", "population"),
                       ("odefunc", "parallel"), ("odefunc_bwd", "parallel"),
                       ("rk_step", "parallel_eval"),
                       ("odefunc", "serve"), ("rk_step", "serve"),
                       ("odefunc", "examples"), ("odefunc_bwd", "examples"),
                       ("rk_step", "examples"), ("odefunc", "protocol"),
                       ("odefunc_bwd", "protocol"), ("rk_step", "protocol"),
                       ("odefunc", "export"), ("rk_step", "export"),
                       ("odefunc", "bench"), ("rk_step", "bench"),
                       ("odefunc", "bench_pool"), ("rk_step", "bench_pool"),
                       ("odefunc_bf16", "bench_bf16")):
        if by_path[path][name] < 1:
            fail(f"{name} was not launched on the {path} path")
    for mode, rows_ in sweep_report.items():
        for r in rows_:
            print(f"[sweep] {mode}: " + " | ".join(f"{k}={v}"
                                                  for k, v in r.items()))
    print(f"[times] done at {time.perf_counter() - t_script:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels + width_kernels + bf16_kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
