"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: requires CUDA (no CPU fallback); prints the card's name and
   power limit as nvidia-smi reports them. TF32 is off for matmuls and cuDNN.
2. build: compiles ``sake_tpu_torch/csrc/*.cu`` with nvcc (one process per
   source, in parallel; #11's and #12's sources a second time with the clock
   probe) and prints the build time and ptxas's register and spill lines.
3. kernels vs plain, MD17: at full width (hidden 64, C 256, R 50, 4 heads),
   aspirin's N = 21 and B = 37, K1 against ``resid_fwd_plain`` (boundary
   states and all 17 residuals), K2 against ``resid_bwd_plain`` (dh, dx,
   dv) and one_ef (#3, ``csrc/fused_ef.cu``) against ``one_ef_plain`` (E, dx),
   unmasked and with random edge masks; max relative error =
   max|kernel - plain| / max|plain| per tensor, limit 1e-4 (masked, K1's att
   residual in two parts: on receiver rows with a live sender against plain; on
   rows with none, where plain's own att moves by about 1e-3 when its logits move
   by 1e-7, against plain's formula on K1's own sem_pre residual,
   ``tools/probe_resid.k1_pairs``). K1 and K2 run
   through their wrappers on the route the shape takes (aspirin: their
   tensor-core kernels; the phase fails on a launch off it), forced on their
   CUDA-core kernels, and at hidden 8 and 16 (the CUDA-core route); each
   launched twice, the second bitwise equal to the first. Then the routes'
   tensor-core products alone against float64 (SERVING TC PRODUCTS line,
   ``tools/probe_resid.check_tc_products``, limit 1e-6).
4. MD17 slice: ``SAKEModel(64, depth=6, n_heads=4)`` from a seeded init
   serves aspirin E + F requests of B in {1, 37, 512, 2048} through
   ``tasks/md17.make_energy_force_fn`` -> dispatch (K1 + K2 below
   ``ONE_EF_MIN_BATCH``, #3 from it), checked against the plain f32 autograd
   path (chunks of 256): ``f_err = max|dF| / max|F|`` <= 1e-4 and ``e_err =
   max|dE| / max|E|`` on raw (uncolored) energies <= 1e-5. The launch
   counters of the routed kernels must move, and every K1 and K2 launch must
   be on the tensor-core route (SERVING ROUTES line). Then both paths are timed
   at B = 2048 in chunks of 512 with CUDA events, in turns, K1 and K2 at B =
   512 beside their CUDA-core kernels and plain versions, and the kernel path's
   time is split into K1 + K2 and the rest. Then #3 against K1 + K2 at B in
   {2048, 4096, 8192}, in turns, and the dispatch threshold that implies;
   then #3's own path, a request of 2048 molecules through
   ``one_ef.one_energy_forces``, counted and held to the same limits.
5. kernels vs plain, QM9: a ``synthesize_qm9`` training batch at the
   ``qm9_kernel`` widths (B = 64, N = 29, hidden 64, depth 6) with its real
   masks: the masked K1 on the route ``make_hidden_fn`` takes there, #4's
   cluster kernel (one molecule per two-CTA cluster; boundaries and all 17
   residuals), and on the one-block route; the forward without residuals (#6:
   h_fin, x_fin) on the cluster kernel without streams (the phase fails unless
   both launches counted); the training pullback's rows kernel on both routes
   (#5's
   cluster kernel and the one-block kernel: dh, dx, dv and all 20 rows) and
   the parameter-gradient kernel (each of the 29 leaves of each layer),
   limit 1e-4 relative per tensor; a second launch of each cluster kernel (#4,
   #6, #5) bitwise equal to the first; whether #6's h_fin and x_fin equal #4's
   bit for bit (printed); the clusters the card holds at once
   (OCCUPANCY line, ``cudaOccupancyMaxActiveClusters``).
6. QM9 slice: ``tasks/qm9.run`` at the ``qm9_kernel`` settings (kernel
   backbone, one device, batch 64, 4096 synthetic molecules) for 2 epochs
   of 53 steps and the valid/test evaluation through the forward without
   residuals. Every kernel of the path must launch, #4's and #5's cluster
   kernels once a step each (106 times) and their one-block route never,
   every step's loss must be finite and the last below the first.
7. QM9 step parity and timing: from one seeded init, step 1's loss and
   every parameter gradient of the kernel branch against the plain branch
   (1e-4 relative per leaf), the first 5 steps' losses (1e-3 relative);
   then the train step of both branches timed in turns (every run
   printed), a BREAKDOWN of the kernel branch's step inside 5 more steps
   (CUDA events before each step, before its optimizer update and after
   it, so the forward + backward and the update add up to the step), and
   each kernel timed at the slice's shapes beside its plain
   version and its bound (#4's, #6's and #5's cluster kernels' 3xTF32 products
   at 3 passes over the TF32 tensor-core peak), with #4 and #5 also on their
   one-block route.
8. MD17 second-order training kernels vs plain: aspirin at full width (N =
   21, hidden 64, depth 6), B = 300 (three waves of one block per SM), the
   training path's inputs (embedded species, v = 0, every layer updating)
   and random cotangents: the shared primal's K1 (#7, boundaries and all 17
   residuals) and K2 (#8, dx), the tangent forward (#9, every tangent
   boundary and residual), the tangent pullback (its cotangents, Hessian
   terms, rows and row tangents), the primal chain with the Hessian terms
   (cotangents and rows), the augmented contraction and the whole
   augmented pullback (#10: dh0, dx, dth and each of the 29 leaves of each
   layer); the fused primal (#11: E plane, dx, boundaries, residuals; and its
   E plane against the torch readout the loss reads) and the fused backward
   (#12: dh0, dx0, the four readout and every leaf gradient) against their
   plain versions and #12 against the shared backward on one FwdOut; then
   the resid and retrace modes' kernels: #18 (``csrc/aug_fwd.cu``: every
   primal and tangent boundary, final state and residual), #16 (its
   instantiation without streams: boundaries and final states), #17
   (``csrc/retrace_bwd.cu`` per layer + the augmented contraction: dh0, dx0,
   dth0 and every leaf of every layer) and #19 (#10's launches on #18's
   streams) against their plain versions (``torch.func`` jvp / vjp of the
   layers for #16-#18), and #17 against #19; then #16-#18 on small models of
   hidden 8 (50 rbf channels > H*K = 32) and 16; limit 1e-4 relative per
   tensor.
9. MD17 step parity: ``tasks/md17`` kernel branch (``make_ef_train2``) in
   each of its four modes (fused, shared, resid, retrace) against the plain
   branch (double autograd through the functional model) from one seeded
   init at B = 4: E and F of each kernel primal against the functional path
   (as phase 4's limits), step 1's loss and every gradient (1e-4 relative
   per leaf), the first 5 losses (1e-3 relative).
10. MD17 slices: ``registry.get_workload("md17_kernel")`` (``MD17Config(
   use_kernel_ef=True)``, fused mode) with n_valid 200 and 2 epochs of 250
   steps (cut from 1000 and 100), then with ``aug_mode`` shared and resid
   for 1 epoch (250 steps) and retrace for 100 steps (n_train 400): each run
   must launch every kernel of its mode and none of another's, the loss
   must stay finite and fall, and the E and F MAE (kcal/mol) are printed.
   Then the train step of the plain branch and the four kernel modes at B =
   4 and B = 512 in turns (every run printed), a BREAKDOWN of each kernel
   mode's step, and each kernel timed at both batches beside its plain
   version and its bound (#11's and #12's block's 3xTF32 products at 3 passes over
   the 495 TFLOP/s TF32 tensor-core peak, their other products at the f32
   peak). Then one launch each of #11 and #12's block at both batches on a
   build with the clock probe (``tools/probe_fused.py``, ``-DSAKE_PROBE``,
   built beside the library in phase 2): each phase's share of the block's
   cycles (PROBE lines).

11. Sparse edge kernels vs plain, MD: ``SparseMDConfig()``'s box (4096
   atoms, hidden 64, depth 6, 4 heads, cutoff 5 + skin 0.5, K = 64) and its
   first neighbour list; at layer 0, #13 (``csrc/sparse_fwd.cu``) and #14
   (``csrc/sparse_bwd.cu``, input cotangents, random output cotangents), whose
   x-mixing product and its transpose run on ``wgmma`` in 3xTF32
   (``csrc/wgmma_tf32.cuh``), against their plain versions, limit 1e-4
   relative per tensor, and a second launch of each bitwise equal to the
   first; #13, #14 and #14 with the leaf gradients on seeded inputs at K = 80,
   96, 128 (two and three 64-slot tiles) and K = 37 (not a multiple of 8)
   (``tools/probe_sparse.check_on_card``: the same limit, two launches bitwise
   equal), and at the most slots the route takes, one more raising
   (``check_slot_limit``); the clock probe of #13, #14 and #14's rows
   instantiation (``tools/probe_sparse.py``, built beside the library in phase
   2): each phase's share of the block's cycles (PROBE lines); then the
   kernel E + F against the plain sparse model: f_err <= 1e-4 and per-atom
   energies within 1e-5 of max |e_atom| (a random box's total cancels).
12. A periodic box: the cell list (capacity 48) equals the all-pairs list
   with the minimum image on the card, and ``sparse_md_kernel`` runs 20
   periodic steps on cell lists, finite, with no dropped neighbour.
13. The sparse MD slice: ``registry.get_workload("sparse_md_kernel")`` at
   its defaults (100 steps, run twice as the task does), which must launch
   #13 and #14 only, stay finite and drop no neighbour; then one E + F
   timed against the plain one, each kernel timed, and a BREAKDOWN of the
   rollout step (edge kernels, neighbour build, torch glue).
14. Sparse training kernels vs plain: ``SparseTrainConfig()``'s box (1024
   atoms, K = 48) at layer 0: #13, #14 with the 11 edge-leaf gradients
   (the rows instantiation and ``csrc/sparse_contract.cu``) and #15
   (``csrc/sparse_bwd2.cu``, forward-over-reverse on dual numbers, its
   x-mixing and its transpose on ``wgmma`` in 3xTF32 with a slot's value and
   tangent rows in the two halves of one 64-row tile, and the contraction)
   against their plain versions (``torch.func.vjp`` for #15), 1e-4 relative
   per tensor, and a second launch of #15 bitwise equal to the first; #15 on
   seeded inputs at K = 48, 37 and 16 and at the most slots it takes, one more
   raising (``tools/probe_sparse.check_bwd2_on_card``,
   ``check_bwd2_slot_limit``); the clock probe of #13, #14 and #15 at this box.
15. Sparse step parity: the kernel branch against the plain double-autograd
   branch from one seeded init: step 1's loss and every gradient per leaf
   (1e-4), the energy loss's gradients (1e-4), the first 5 losses (1e-3).
16. The sparse training slice: ``registry.get_workload("sparse_train_kernel")``
   for its 100 steps, which must launch #13, #14 (both) and #15 and no
   dense kernel, with a falling loss; then the train step of both branches
   in turns, each kernel timed, and a BREAKDOWN that splits #14 with dW and
   #15 into their edge kernel and their contraction. The two contraction
   kernels, on the f64 tensor cores (``csrc/dmma_f64.cuh``), against their
   plain versions (``tools/probe_contract.check_contractions``: each leaf of
   ``csrc/sparse_contract.cu`` within 1e-6 of the largest value of the f64
   ``contract_plain`` on #14's and #15's rows of this box, each leaf of
   ``csrc/param_grads.cu`` within 1e-4 of its plain version at full width,
   and two launches of each bitwise equal; CONTRACT line), then each alone
   beside its yardsticks (LIBRARY lines): ``torch.matmul`` over materialised
   operands, the whole function (one product per term in f64, their times
   summed) and its w_xmix term in f64 and in f32 (TF32 off): the sparse
   kernel on layer 0's rows of this box under #14's and #15's terms,
   ``csrc/param_grads.cu`` over all six layers (QM9's B = 64, N = 29 for #5;
   MD17's B = 4 and 512, N = 21, augmented, for #12).

17. Remat kernels vs plain: at aspirin's full width, B = 300 (the serving
   path's inputs: embedded species, v = 0, every layer updating, a random
   cotangent of the final h), #21 and #23 (``csrc/remat_ef.cu``: the
   boundaries and the final h) against ``fori_fwd_plain`` and
   ``depthgrid_fwd_plain``, #22 and #24 (dh0, dx, dv) against
   ``fori_bwd_plain`` and ``depthgrid_bwd_plain`` (``torch.func.vjp`` of the
   wide layer), #23 against #21 and #24 against #22; then the four at aspirin's
   widths with one atom more (N = 22, B = 37), and on seeded models of hidden 8
   (50 rbf channels > H*K = 32) and 16, depth 2, gates [1, 0.4]; limit 1e-4
   relative per tensor. #21-#24 count their launches by route (REMAT ROUTES
   lines): aspirin's on the tensor cores (3xTF32 on ``mma.sync``); at N = 22
   #21 and #23 on the CUDA cores (two tensor-core blocks no longer fit an SM)
   and #22 and #24 on the tensor cores; the narrow models' on the CUDA cores;
   else the phase fails. Whether #21 gives K1's tensor-core kernel's boundaries
   bit for bit at aspirin (printed).
   The re-forward's residual scratch of the last layer against
   ``layer_fwd_resid`` at aspirin B = 300 (``tools/probe_fused.resid_err``;
   dh0, dx and dv barely feel the x-mixing at random weights, coeff does),
   limit 1e-5 relative per residual.
18. The E + F slice of the kernel API: aspirin requests of B in {37, 512,
   2048} through ``fori_energy_forces`` and ``depthgrid_energy_forces``
   against the plain f32 autograd path with phase 4's limits; #21-#24 must
   launch and K1 and K2 must not. Then at B = 2048 fori, depthgrid, K1 + K2
   (``resid_energy_forces``) and plain in turns, each path's peak device
   memory, #21 and #23 at the path's chunk (B = 512) against their plain
   versions (1e-4 relative per tensor, every launch on the tensor cores), each
   kernel at the path's shapes (chunks of 512) beside its plain
   version and its bound (on the tensor-core route the products in 3xTF32 at 3
   passes over the TF32 peak), and a BREAKDOWN of both paths.
19. Force-loss training through ``make_trainable_energy_forces`` on
   ``synthesize_md17`` aspirin at B = 512: step 1's loss and every gradient
   of the primals fori, resid and depthgrid against plain double autograd
   (1e-4 relative per leaf), the first 5 losses (1e-3), 50 adam steps of the
   fori primal (lr 1e-3) with a finite, falling loss and #21 and #22
   launched; then the train step of the three primals and plain in turns and
   a BREAKDOWN of each (primal kernels, readout seed, the rest of the primal,
   the torch pullback, adam).
20. Dense MD: ``md.velocity_verlet_rollout`` (B = 512 aspirin, atomic
   masses, dt 1e-3, 20 steps) on ``fori_energy_forces`` forces against the
   same rollout on plain forces, positions within rtol 1e-4 / atol 1e-5 and
   velocities within rtol 1e-3 / atol 1e-4 (``tests/test_md.py:89-90``); the
   fori rollout launches #21 and #22 only; molecule-steps/s of fori, the
   dispatch (K1 + K2) and plain, in turns.

21. Split kernels vs plain: at aspirin's full width, B = 300, on the layer-0
   inputs of the serving path (embedded species, the node projections in
   torch) and random cotangents: #25's edge_att body (h_e, att) and
   coeff_pool body (pooled x 3, hatt_sum), #26's two pullbacks with and
   without the weight cotangents (every batched and every weight cotangent;
   the rows and ``csrc/sparse_contract.cu``), #27 against #25's two kernels
   composed and against ``merged_body``, and #28 against its plain version
   (``torch.func.vjp`` of the bodies); then the same on seeded models of
   hidden 8 (50 rbf channels > H*K = 32) and 16, depth 2; limit 1e-4
   relative per tensor. Each forward and pullback launch is counted by route
   (``split_ef``'s ``.routes``): aspirin's on the tensor cores (``64 // N``
   receiver rows a tile, ``csrc/split_edge.cuh``'s ``split_tc_fwd_kernel`` and
   ``split_tc_kernel``), the narrow models' on the CUDA cores. Then
   ``tools/probe_split.check_forwards`` and ``check_pullbacks``: the three
   forwards and the three pullbacks at aspirin's widths with N = 21, 22 (two rows
   a tile) and 17 (a last group of two rows), and at hidden 8 and 16 (N = 7),
   against the plain bodies and ``vjp_plain`` within 1e-4, two launches bit for
   bit, each on its route.
22. The split E + F slice: aspirin requests of B in {37, 512, 2048} through
   ``split_energy_forces`` (which must launch #25 and #26 only) and
   ``merged_energy_forces`` (#27 and #28 only), neither launching a dense
   kernel, every forward and pullback on the tensor cores, against the plain f32
   autograd path with phase 4's limits. Then at B = 2048 split, merged, K1 + K2
   and plain in turns with each path's peak device memory, each new kernel at the
   path's shapes beside its plain version and its bound (the x-mixing and edge
   products on the tensor-core route in 3xTF32 at 3 passes over 495 TFLOP/s,
   ``split_tc_fma``), and a BREAKDOWN of both paths.
23. The weight cotangents on the card: at B = 512 the gradient of the summed
   energy with respect to every edge weight of every layer (the CFConv
   tensors, w_sem, b_sem, w_xmix) and x through ``split_ef.model_energy``
   (split ops and merged op, every launch on the tensor cores) against plain
   autograd of the same model, 1e-4 relative per leaf.

24. #20 (``csrc/fused_remat_ef.cu``, ``kernels.fused_energy_forces``) in f32
   and in its bf16 default: against its plain version (``fused_ef_plain``) at
   aspirin's full width, B = 37 (the tensor-core route), and on seeded models
   of hidden 8 and 16 (depth 2, gates [1, 0.4]; the CUDA-core route): f32
   within phase 4's limits, bf16 no farther from plain bf16 than plain bf16 is
   from plain f32, and within a limit of plain bf16 in E and F: 1e-3 relative
   on the narrow models (a kernel that skips a rounding lies about 2e-3 to
   1e-2 away there), at aspirin 1.5 times the distance of the parent's
   CUDA-core kernel (``FUSED_ASPIRIN_BF16_TOL``, from ``tools/tc_ab.py``); each
   case's route must be the one its shape selects. At B = 37 the plain
   version on the host CPU against the same on the card (the same function,
   its sums in another order: the spread a bf16 comparison has to allow for).
   Then aspirin requests of B in {37, 512, 2048} through
   ``kernels.fused_energy_forces`` in each mode, each one launch of #20 on the
   tensor cores and no other dense kernel (route and peak device memory
   printed per request), against the plain f32 autograd path: f32 with phase
   4's limits; bf16 with f_err <= max(2e-3, 2 x the plain bf16 version's
   f_err) (``bench.py:164``'s rule) and no farther from plain bf16 than plain
   bf16's f_err. Then at B = 2048 #20 f32, #20 bf16, fori, K1 + K2 and plain
   in turns with each path's peak device memory, and the kernel alone beside
   its plain version and its bound (one forward and one pullback over depth;
   f32: the tensor-core products in 3xTF32 at 3 passes over the 495 TFLOP/s
   TF32 peak, the rest at 67 TFLOP/s, the bound before this route, every
   product at 67, beside it; bf16: every product at the 989 TFLOP/s dense bf16
   peak in one pass, and beside it, as a note on the route, the time its
   tensor-core products take at their TF32 passes, 1 or 2, over 495 TFLOP/s).
   First, #20's bf16 tensor-core products alone (``fused_ef.tc_product``: the
   x-mixing at 2 passes, the edge products at 1 and 2, at the bodies' shapes)
   within 1e-6 of a float64 product (``tools/probe_fused.check_tc_products``),
   the limit the CPU tests hold the plain models to: a pass too few misses by
   about 2e-4.

25. resid_ef's bf16 tier (bf16 edge products and bf16 residual streams, all
   but r and t: the JAX package's production setting), on K1, K2, #4, #5 and
   #6. At aspirin's full width B = 37 (K1 and K2 on the tensor cores, and
   forced on their CUDA-core kernels) and at hidden 8 and 16 (the CUDA cores),
   unmasked and masked: the kernels against the plain bf16 version on the card,
   each f32 output (boundaries, final state, r, t; K2's dh, dx, dv, on the
   plain streams and on K1's) within ``BF16_TOL`` and no farther from plain
   bf16 than plain bf16 is from plain f32 (K2 on the plain streams: than plain
   bf16 is from f32 products on the same streams), the bf16 streams bf16 tensors within
   ``BF16_STREAM_TOL`` of plain (att on receiver rows with a live sender: no
   output reads the others), each twice bit for bit. Then aspirin requests of B
   in {37, 512, 2048} through ``dispatch_energy_forces`` with the JAX dispatch's
   keywords (``edge_matmul_dtype`` and ``resid_dtype`` bf16, ``resid_lowp=
   LOWP_X``), launches counted from 0 (BF16 SERVING ROUTES: the tensor cores),
   against the plain f32 oracle: f_err <= max(2e-3, 2 x the plain bf16
   version's f_err) (``bench.py:164``) and |kernel - plain bf16| <= plain
   bf16's f_err. K1 and K2 timed in both tiers at B = 512, the served path and
   its peak device memory at B = 2048 in both tiers. Then QM9 (B = 64, N = 29,
   masked, ``qm9_kernel``'s model): #4, #6 and #5's rows kernel on their
   cluster routes against plain bf16 (as above; #5 against the f32 products'
   distance on the same streams), the contraction within ``BF16_CONTRACT_TOL``
   of the plain one on the same streams and rows with its sums in float64
   (``f64_sums``); each twice bit for bit. Then ``make_hidden_fn`` in the tier
   (launches counted from 0):
   h_fin within ``BF16_TOL`` and every leaf's gradient of a weighted readout
   loss within ``BF16_GRAD_TOL`` of the plain bf16 version and no farther from
   it than plain bf16 is from plain f32; each timed in both tiers. Bounds count
   every edge product (o_f, o1, the semantic logits, the x-mixing, their
   pullbacks and weight contractions) at the 989 TFLOP/s dense bf16 peak in
   one pass, the rest at 67 TFLOP/s, and the bf16 streams at 2 bytes an
   element.
26. ``make_ef_train2``'s fused mode in that tier (MD17 training: #11
   ``csrc/fused_ef16.cu``, #12's block ``csrc/fused_bwd16.cu`` and #12's contraction
   ``sake_param_grads_aug16``) on ``MD17Config``'s model (aspirin, hidden 64,
   depth 6, 4 heads, seed-0 weights) at B = 4 and 512: #11 against the plain bf16
   primal (F within max(2e-3, 2 x the plain bf16 primal's f_err from the plain f32
   one), ``bench.py:164``; boundaries, final state, r, t and the E plane no farther
   from plain bf16, in the root-mean-square norm, than plain bf16 lies from f32,
   floor ``TRAIN_TOL``, and no element beyond ``BF16_STREAM_TOL`` of the tensor's
   max (``gate_widened``: a flipped rounding moves a few elements by about the
   tier's own rounding, so their maximum can exceed the tier's distance); the bf16
   streams within ``BF16_STREAM_TOL``); #12's block on the plain bf16 primal's
   streams against the plain bf16 block (dh0, dx0, the readout partials, the
   tangent streams and every row, each as ``gate_widened`` against the f32 tier on
   the same streams, the share of moved elements printed); the contraction on the
   block's streams and rows against plain with f64 sums within
   ``BF16_CONTRACT_TOL``, the four edge leaves within ``BF16_FLIP_SHARE`` of the
   tier's own distance there where that is larger; each twice bit for bit. Then
   one step of the tier's fused branch (``tasks/md17.make_branch``'s colouring and
   parameters) against its plain bf16 path (#11 and #12 swapped for their plain
   versions), loss and every leaf within ``STEP16_SHARE`` times plain bf16's
   distance from the f32 fused branch in the root-mean-square norm (a flip
   cascades through depth 6; that distance and the kernel's own printed);
   a training run of ``TRAIN16_STEPS`` steps at B = 4 with the task's optimizer
   (launches counted from 0: only the three tier kernels, a falling loss); each
   kernel and the fused step timed in both tiers in turns (means and spreads),
   the step's peak device memory, the plain bf16 times and the bounds (as phase
   25's).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

K1_TOL = K2_TOL = 1e-4
F_TOL, E_TOL = 1e-4, 1e-5
QM9_TOL = 1e-4  # kernels and step-1 gradients, relative per tensor
LOSS_TOL = 1e-3  # the first steps' losses, relative
FULL = dict(hidden=64, depth=6, heads=4)
REQUESTS = (1, 37, 512, 2048)
ONE_EF_BATCHES = (2048, 4096, 8192)  # #3 against K1 + K2; the dispatch's candidates
SEED = 0
CHECK_CHUNK = 256  # molecules per autograd pass of the plain reference in the checks
PATH_CHUNK = 512  # resid_energy_forces' chunk; the plain path is timed at it too
QM9_EPOCHS = 2
PARITY_STEPS = 5
TRAIN_TOL = 1e-4  # MD17 training kernels and step-1 gradients, relative per tensor
TRAIN_CHECK_B = 300  # three waves of one block per SM on 132 SMs
TRAIN_BATCHES = (4, 512)  # MD17Config's batch, and bench_md17_train.py's
# the slice's cut: MD17Config() validates on 1000 molecules and trains 100 epochs
MD17_RUN = dict(n_valid=200, n_epochs=2, epochs_per_block=1)
MD17_SHARED_RUN = dict(n_valid=200, n_epochs=1, epochs_per_block=1)  # shared, resid: 250 steps
# retrace mode, cut further to fit the time budget: 100 steps on 400 molecules
MD17_RETRACE_RUN = dict(n_train=400, n_valid=200, n_epochs=1, epochs_per_block=1)
SPARSE_TOL = 1e-4  # the sparse edge kernels and the sparse training step, relative per tensor
SPARSE_CELL_CAPACITY = 48  # the periodic run's cell list (about 12 atoms a cell at 0.05 / A^3)
SPARSE_PERIODIC_STEPS = 20
REMAT_REQUESTS = (37, 512, 2048)  # phase 18's E + F requests through #21-#24
REMAT_TRAIN_B = 512  # phase 19's batch (bench_md17_train.py's)
REMAT_TRAIN_STEPS = 50
REMAT_TRAIN_LR = 1e-3  # the 50-step run's constant adam rate
MD_B, MD_STEPS, MD_DT = 512, 20, 1e-3  # phase 20's rollout
SPLIT_TOL = 1e-4  # the split kernels and the weight cotangents, relative per tensor
SPLIT_REQUESTS = (37, 512, 2048)  # phase 22's E + F requests through #25-#28
SPLIT_GRAD_B = 512  # phase 23's batch
FUSED_REQUESTS = (37, 512, 2048)  # phase 24's E + F requests through #20
BF16_REQUESTS = (37, 512, 2048)  # phase 25's aspirin requests in resid_ef's bf16 tier
# phase 25: the bf16 tier's kernels against its plain version on the card, relative per
# output: the f32 outputs, K2's cotangents, E and F, h_fin (and no farther than plain
# bf16 lies from plain f32; K2 and #5 on plain's streams no farther than plain bf16 lies
# from the f32 products on the same streams); the gradients of every leaf through
# make_hidden_fn (a flipped bf16 rounding spreads over depth 6; and no farther than plain
# bf16 lies from plain f32, leaf by leaf); the bf16 residual streams, relative to a
# stream's max (a flipped rounding moves an element by one bf16 step, at most 2^-7 of
# its size); the contraction against the plain one on the same streams and rows with its
# sums in float64 (f64_sums), as the kernel's are: what is left is the f32 rounding of
# the result and of the operands the two form alike
BF16_TOL = 1e-3
BF16_GRAD_TOL = 1e-2
BF16_STREAM_TOL = 2.0**-7
BF16_CONTRACT_TOL = 1e-6
# phase 26: an edge leaf's augmented contraction in the tier, as a share of the tier's
# own distance there (plain bf16 from f32 products on the same rows). The kernel forms
# the tangent of silu(e0) (w_o1's operand) as silu'(e0) t_e0, torch's jvp in another
# float order, so a few of that operand's bf16 roundings flip: each moves one term by
# a bf16 step, where every term of the tier's distance carries its operands'
# roundings; a skipped or misplaced rounding would show at a share near 1
BF16_FLIP_SHARE = 0.1
# phase 26: #11's and #12's block outputs against plain bf16, in the norm, as a share of
# plain bf16's distance from the f32 tier on the same inputs. Sound kernels read 0.04 to
# 0.27 (an H100); a kernel that skipped the tier's roundings would read about 1. Below
# 0.5 the kernel also lies at least half the tier's distance from f32 (the triangle
# inequality), so the gate holds from both sides
TIER16_SHARE = 0.5
# phase 26: step 1 of the tier's fused branch against its plain bf16 path, in the norm,
# as a share of plain bf16's distance from the f32 branch (see train16_phases); and the
# median over the tensors of the kernel step's distance from the f32 branch, as a share
# of plain bf16's, at least STEP16_FAR_MIN (a step that ran f32 reads about 0)
STEP16_SHARE = 2.0
STEP16_FAR_MIN = 0.5
TRAIN16_STEPS = 250  # phase 26's training run in the tier: one epoch of MD17Config's 1000 at B = 4
TRAIN16_ROUNDS = 3  # phase 26's timing rounds, each f32, bf16, bf16, f32
# #20 bf16 against plain bf16 on the narrow models, relative per output (the CPU
# test's limit; plain bf16 lies about 2e-3 to 1e-2 from plain f32 there)
FUSED_NARROW_BF16_TOL = 1e-3
# and at aspirin B = 37 on the tensor cores: 1.5 times the distance of the CUDA-core
# kernel before that route, which lies beyond 1e-3 there (a flipped bf16 rounding
# spreads over depth 6): e 2.196e-3, f 3.070e-3 (tools/tc_ab.py's OUTPUTS phase on an
# NVIDIA H100 80GB HBM3 at 700 W, at this phase's model and inputs)
FUSED_ASPIRIN_BF16_TOL = {"e": 1.5 * 2.196e-3, "f": 1.5 * 3.070e-3}
ATOM_MASS = {1: 1.008, 6: 12.011, 8: 15.999}  # u, by atomic number (aspirin: H, C, O)
# H100 SXM peaks (NVIDIA's data sheet): f32 outside the tensor cores, HBM3, and
# the dense bf16 tensor-core rate (#20's bf16 products are bf16 operations)
PEAK_F32_FLOPS, PEAK_BYTES, PEAK_BF16_FLOPS = 67e12, 3.35e12, 989e12
# the dense TF32 tensor-core rate: #11's and #12's 3xTF32 products take 3 passes
PEAK_TF32_FLOPS, TF32_PASSES = 495e12, 3
PROBE_LIB = None  # the clock-probe build of #11 and #12 (tools/probe_fused.py), set by main
SPARSE_PROBE_LIB = None  # and of #13-#15 (tools/probe_sparse.py)
# the K of the extra checks of #13 and #14: two and three 64-slot tiles, not a
# multiple of 8 (and the route's limit, tools/probe_sparse.check_slot_limit)
SPARSE_EXTRA_K = ((80, 128), (96, 128), (128, 128), (37, 128))  # (K, receiver rows)
# the cases of param_grads.cu whose yardsticks are timed: (the kernel, B, N,
# augmented)
# the cases of tools/probe_contract.py (by the start of their labels) whose kernel
# and yardsticks phase 16 times
LIBRARY_CASES = ("sparse #14 with dW", "sparse #15", "#5 (qm9_kernel)",
                 "#12 augmented (md17_kernel) B=4 ", "#12 augmented (md17_kernel) B=512 ")

def _load(name: str, *path):
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(name, os.path.join(here, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def probe_module():
    """``tools/probe_fused.py`` (the clock probe of #11 and #12)."""
    return _load("probe_fused", "tools", "probe_fused.py")


@functools.lru_cache(maxsize=None)
def contract_probe_module():
    """``tools/probe_contract.py`` (the contractions' probe, their seeded
    inputs and their checks against plain on the card)."""
    return _load("probe_contract", "tools", "probe_contract.py")


@functools.lru_cache(maxsize=None)
def resid_probe_module():
    """``tools/probe_resid.py`` (K1's and K2's serving checks and their
    tensor-core products against float64)."""
    return _load("probe_resid", "tools", "probe_resid.py")


@functools.lru_cache(maxsize=None)
def split_probe_module():
    """``tools/probe_split.py`` (the split kernels' inputs and their checks
    against plain on the card)."""
    return _load("probe_split", "tools", "probe_split.py")


@functools.lru_cache(maxsize=None)
def sparse_probe_module():
    """``tools/probe_sparse.py`` (the clock probe of #13 and #14, and their
    checks against plain on seeded inputs)."""
    return _load("probe_sparse", "tools", "probe_sparse.py")


def fail(msg: str):
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def abs_err(got, want) -> float:
    return float((got - want).abs().max())


def cuda_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*trees) -> int:
    """Bytes of every tensor in nested tuples, lists and dicts."""
    import torch

    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += nbytes(*t)
    return total


# The residual streams the weight-gradient contraction reads (csrc/param_grads.cu's
# load_a and its staged operands): it never reads sem_pre, att, coeff or g1
GRADS_STREAMS = ("r", "t", "rbf", "e0", "h_e", "ps0", "ps1", "node_pre", "pool0", "pool1",
                 "pool2", "uv", "g0")


def grads_streams(resid: dict) -> dict:
    """The streams of ``resid`` that the contraction reads (``GRADS_STREAMS``)."""
    return {n: resid[n] for n in GRADS_STREAMS}


def layer_fma(N, F, H, R, K, C):
    """Multiply-adds of the matrix products of one molecule and layer, for
    the forward, the input pullback and the parameter-gradient contractions.
    Elementwise work (exp, tanh, sigmoid, sums) is not counted, so bounds
    built on these counts are lower bounds."""
    HK, E = H * K, N * N
    fwd = (E * (R * H + H * H + H * K + HK * C + 3 * C)  # o_f, o1, sem, x_mixing, pooled
           + N * (F * (2 * R + 2 * H) + C * H + 2 * H * H + 2 * F * H + HK * H + H * F
                  + 3 * C + H))  # projections, post MLP, node MLP, gate, v_mixing
    bwd = (E * (C * HK + 2 * HK + K * H + H * H + H * R + 6 * C)
           + N * (2 * F * R + 2 * R * F + 2 * H * F + 3 * H * F + HK * H + 2 * H * H
                  + C * H + 3 * C + H))
    grads = (E * (R * H + H * H + H * K + HK * C)
             + N * (2 * F * R + 2 * F * H + C * H + H * H + F * H + HK * H + H * H
                    + H * F + 3 * C + F * H + H))
    # the tangent forward: the forward's products on the tangents, plus the
    # recomputed a_j, a_i and the pooled sum's second term
    jvp = fwd + N * 2 * F * R + E * 3 * C
    # the tangent pullback: every product of the pullback on values and on
    # tangents; the augmented contraction: a (g_p + t_g) and t_a g_t
    return dict(fwd=fwd, bwd=bwd, grads=grads, jvp=jvp, tbwd=2 * bwd, grads_aug=2 * grads)


def tc_fma(N, H, R, K, C):
    """Of ``layer_fma``'s multiply-adds, those #11 and #12's block run on the
    tensor cores in 3xTF32 (``csrc/mma_tf32x3.cuh``): the x-mixing product and
    the edge products o_f and o1 in every body."""
    E, HK = N * N, H * K
    fwd = E * (HK * C + R * H + H * H)
    return dict(fwd=fwd, bwd=fwd, jvp=fwd, tbwd=2 * fwd)


def bound(fma: float, moved: int, peak: float = PEAK_F32_FLOPS, tc: float = 0.0):
    """``(bound_ms, bound_by)``: the larger of the operations (2 per
    multiply-add) over the card's peak for their type (f32 unless given; the
    ``tc`` of them that run in 3xTF32 at TF32_PASSES passes over the TF32
    tensor-core peak) and the bytes over its memory rate."""
    t_ops = (2 * (fma - tc) / peak + 2 * TF32_PASSES * tc / PEAK_TF32_FLOPS) * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_entry(name, source, replaces, launches, max_abs_err, ms, plain_ms, fma, moved,
                 peak: float = PEAK_F32_FLOPS, tc: float = 0.0):
    bound_ms, bound_by = bound(fma, moved, peak, tc)
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)  # no one PyTorch call runs a layer stack
    # or the sparse edge chain


def report_checks(checks: dict, abs_errs: dict, label: str, prefix: str = "MD17 TRAIN"):
    """Print each kernel check (a list of (name, kernel, reference)) and
    fail on a relative error per tensor beyond TRAIN_TOL or a non-finite
    kernel value; record each check's max absolute error."""
    import torch

    for name, pairs in checks.items():
        errs = {n: rel_err(a, b) for n, a, b in pairs}
        abs_errs[name] = max(abs_err(a, b) for _, a, b in pairs)
        w = max(errs, key=errs.get)
        finite = all(bool(torch.isfinite(a).all()) for _, a, _ in pairs)
        print(f"{prefix} {name} {label}: max rel err {errs[w]:.3e} ({w}), max abs err "
              f"{abs_errs[name]:.3e}, finite {finite} "
              + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()}), flush=True)
        if errs[w] > TRAIN_TOL or not finite:
            fail(f"{prefix} kernel {name} beyond {TRAIN_TOL}")


def narrow_aug_checks(dev, hid: int) -> dict:
    """#18, #16 and #17 against their plain versions on a small seeded model
    of hidden width ``hid`` (depth 2, 4 heads, 50 rbf channels), B = 4, N = 7."""
    import torch

    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES, wide_stack
    from sake_tpu_torch.models import SAKEModel

    model = SAKEModel(hid, 1, 2, in_features=5, device=dev,
                      generator=torch.Generator().manual_seed(hid))
    leaves = wide_stack(model_params_from_linen(linen_tree(model), device=dev), 4)
    gen = torch.Generator(dev).manual_seed(hid)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    h0, xs, tx0, dh, dth = rnd(4, 7, hid), 1.5 * rnd(3, 4, 7), rnd(3, 4, 7), rnd(4, 7, hid), \
        rnd(4, 7, hid)
    upd = [1.0, 0.4]
    names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
    with torch.no_grad():
        checks = {}
        for name, kf, pf in (("aug_fwd", t2.aug_fwd, t2.aug_fwd_plain),
                             ("retrace_fwd", t2.retrace_fwd, t2.retrace_fwd_plain)):
            k, p = kf(leaves, h0, xs, upd, tx0), pf(leaves, h0, xs, upd, tx0)
            checks[name] = [(f"{lab}.{n}", a, b) for lab, kk, pp in (("p", k[0], p[0]),
                                                                     ("t", k[1], p[1]))
                            for n, a, b in zip(names, kk[:6], pp[:6])]
        k = t2.retrace_bwd(leaves, *p, upd, dh, dth)
        q = t2.retrace_bwd_plain(leaves, *p, upd, dh, dth)
        torch.cuda.synchronize()
    checks["retrace_bwd"] = [*zip(("dh0", "dx0", "dth0"), k[:3], q[:3]),
                             *((n, k[3][n], q[3][n]) for n in LEAF_NAMES)]
    return checks


def chunked_plain_ef(params, species, x, n_heads: int, chunk: int):
    """The plain f32 autograd E + F of requests ``x (B, N, 3)`` of one molecule
    with one-hot ``species (N, S)``, in chunks of ``chunk`` molecules."""
    import torch

    from sake_tpu_torch.kernels.functional import energy_and_forces_fn

    es, fs = [], []
    for s in range(0, x.shape[0], chunk):
        xc = x[s : s + chunk]
        h = species.to(x.device).expand(xc.shape[0], *species.shape)
        e, f = energy_and_forces_fn(params, h, xc, n_heads=n_heads)
        es.append(e)
        fs.append(f)
    return torch.cat(es), torch.cat(fs)


def md17_loss_and_grads(br: dict, batch: dict, energy_loss_weight: float):
    """The loss of ``tasks/md17.make_step_fn`` on ``batch`` through the branch
    ``br`` (its ``params`` and ``ef``) and the gradient of every parameter
    (zeros for one the branch does not use)."""
    import torch

    from sake_tpu_torch.train import tree_leaves

    leaves_ = tree_leaves(br["params"])
    with torch.enable_grad():
        e, f = br["ef"](br["params"], batch["x"])
        loss = ((f - batch["f"]).abs().mean()
                + energy_loss_weight * (e - batch["e"]).abs().mean())
        grads = torch.autograd.grad(loss, leaves_, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves_, grads)]


def dense_counters() -> tuple:
    """The launch counts of every dense-layer kernel (K1, K2, #3-#12, #16-#19,
    #21-#24) but #20: a sparse path must leave them all where they were."""
    from sake_tpu_torch.kernels import depthgrid_ef, fori_ef, one_ef, resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2

    return (resid_ef.resid_fwd, resid_ef.resid_infer, resid_ef.resid_bwd,
            resid_ef.resid_bwd_rows, resid_ef.param_grads, one_ef.one_energy_forces,
            t2.resid_jvp, t2.resid_tbwd, t2.resid_bwd_aug, t2.param_grads_aug, t2.shared_fwd,
            t2.shared_bwd, t2.fused_primal, t2.fused_bwd_block, t2.fused_bwd_grads, t2.aug_fwd,
            t2.aug_bwd, t2.retrace_fwd, t2.retrace_bwd, fori_ef.fori_fwd, fori_ef.fori_bwd,
            depthgrid_ef.depthgrid_fwd, depthgrid_ef.depthgrid_bwd)


def remat_checks(leaves: dict, h0, xs, upd, dh) -> dict:
    """#21-#24 against their plain versions on one input (``h0 (B, N, F)``,
    ``xs (3, B, N)``, v = 0, the gates ``upd``, ``dh`` the cotangent of the
    final h), and #23 against #21, #24 against #22; the pullbacks run on
    the plain forward's boundaries. Checks as :func:`report_checks` takes
    them."""
    import torch

    from sake_tpu_torch.kernels import depthgrid_ef as dg
    from sake_tpu_torch.kernels import fori_ef as fe

    with torch.no_grad():
        pf, pg = fe.fori_fwd_plain(leaves, h0, xs, upd), dg.depthgrid_fwd_plain(leaves, h0, xs, upd)
        pb, pd = fe.fori_bwd_plain(leaves, pf, upd, dh), dg.depthgrid_bwd_plain(leaves, pf, upd, dh)
        k21, k23 = fe.fori_fwd(leaves, h0, xs, upd), dg.depthgrid_fwd(leaves, h0, xs, upd)
        k22, k24 = fe.fori_bwd(leaves, pf, upd, dh), dg.depthgrid_bwd(leaves, pf, upd, dh)
        torch.cuda.synchronize()
    fn, bn = ("bh", "bx", "bv", "h_fin"), ("dh0", "dx", "dv")
    return {"fori_fwd": [*zip(fn, k21, pf)], "fori_bwd": [*zip(bn, k22, pb)],
            "depthgrid_fwd": [*zip(fn, k23, pg)], "depthgrid_bwd": [*zip(bn, k24, pd)],
            "depthgrid_fwd_vs_fori_fwd": [*zip(fn, k23, k21)],
            "depthgrid_bwd_vs_fori_bwd": [*zip(bn, k24, k22)]}


def main() -> int:
    import torch

    # -- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only", file=sys.stderr)
        return 1
    # the port itself: without it beside this script, fail before printing anything
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sake_tpu_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"DEVICE {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)

    # -- 2. build ---------------------------------------------------------------
    # beside the library, #11 and #12, and #13 and #14, with the clock probe
    # compiled in
    global PROBE_LIB, SPARSE_PROBE_LIB
    t0 = time.perf_counter()
    probe_box = {}

    def build_probe(key, module):
        try:
            probe_box[key] = module().build_probe()
        except Exception as e:  # re-raised below, in this thread
            probe_box["error"] = e

    workers = [threading.Thread(target=build_probe, args=a)
               for a in (("dense", probe_module), ("sparse", sparse_probe_module))]
    for w in workers:
        w.start()
    lib_path = build.build()
    for w in workers:
        w.join()
    if "error" in probe_box:
        raise probe_box["error"]
    PROBE_LIB, SPARSE_PROBE_LIB = probe_box["dense"], probe_box["sparse"]
    build.load()
    print(f"BUILD ok {time.perf_counter() - t0:.2f} s -> {lib_path.parent.name}", flush=True)
    for line in (lib_path.parent / "ptxas.txt").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"PTXAS {line.strip()}", flush=True)

    kernels = md17_serving_phases(dev, smi)
    kernels += qm9_phases(dev, smi)
    kernels += md17_train_phases(dev, smi)
    kernels += sparse_md_phases(dev, smi)
    kernels += sparse_train_phases(dev, smi)
    kernels += remat_phases(dev, smi)
    kernels += split_phases(dev, smi)
    kernels += fused_phases(dev, smi)
    kernels += bf16_phases(dev, smi)
    kernels += train16_phases(dev, smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def md17_serving_phases(dev, smi) -> list:
    """Phases 3-4 (see the module docstring); returns their kernel entries."""
    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.kernels import dispatch, one_ef, resid_ef
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack
    from sake_tpu_torch.tasks.md17 import (
        MD17Config,
        make_energy_force_fn,
        make_model,
        species_onehot,
    )

    data = synthesize_md17(n_samples=max(REQUESTS), seed=SEED)
    species = species_onehot(data.z, int(data.z.max()))
    e_mean, e_std = float(data.e.mean()), float(data.e.std())
    cfg = MD17Config(hidden_features=FULL["hidden"], depth=FULL["depth"],
                     n_heads=FULL["heads"])
    gen = torch.Generator().manual_seed(SEED)
    model = make_model(cfg, species.shape[-1], device=dev, generator=gen)
    model.requires_grad_(False)
    params = model.functional_params()
    leaves = wide_stack(params, cfg.n_heads)
    N = len(data.z)

    # -- 3. kernels vs plain at full width, B = 37, unmasked and masked ---------
    rng = np.random.RandomState(SEED + 1)
    Bk = 37
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    x37 = tdev(data.x[:Bk].transpose(2, 0, 1))
    h37 = embed(params, species.to(dev).expand(Bk, N, -1)).contiguous()
    v37 = tdev(0.1 * rng.randn(3, Bk, N))
    upd = [1.0, 0.3, 0.0, 1.0, 1.0, 1.0]  # exercises the gate at 0 < upd < 1
    nm37 = (np.arange(N)[None] < rng.randint(3, N + 1, size=Bk)[:, None]).astype(np.float32)
    nm37[0] = 0.0  # one fully padded molecule
    masks = {"unmasked": None, "masked": tdev((nm37[:, :, None] * nm37[:, None, :])[..., None])}
    abs_md17 = {"resid_fwd": 0.0, "resid_bwd": 0.0, "one_ef": 0.0}
    leaves_t = transposed(leaves)
    # K1 and K2 on the route each shape takes (aspirin's: the tensor cores) and,
    # forced, on the CUDA-core kernels; the narrow models' take the CUDA cores
    narrow = {}
    for hid in (8, 16):
        mcfg = MD17Config(hidden_features=hid, depth=FULL["depth"], n_heads=FULL["heads"])
        nmod = make_model(mcfg, species.shape[-1], device=dev,
                          generator=torch.Generator().manual_seed(SEED + hid))
        nmod.requires_grad_(False)
        np_ = nmod.functional_params()
        narrow[hid] = (wide_stack(np_, FULL["heads"]),
                       embed(np_, species.to(dev).expand(Bk, N, -1)).contiguous())
    for label, m4 in masks.items():
        seeds = (tdev(rng.randn(Bk, N, FULL["hidden"])), tdev(rng.randn(3, Bk, N)),
                 tdev(rng.randn(3, Bk, N)))
        cases = [("aspirin", "tensor cores", leaves, leaves_t, h37, seeds, None),
                 ("aspirin", "CUDA cores", leaves, leaves_t, h37, seeds, "CUDA cores")]
        for hid, (nl, nh) in narrow.items():
            cases.append((f"hidden {hid}", "CUDA cores", nl, transposed(nl), nh,
                          (tdev(rng.randn(Bk, N, hid)), *seeds[1:]), None))
        for model_label, route, lv, lv_t, h_in, sd, forced in cases:
            before = {c.__name__: dict(c.routes) for c in (resid_ef.resid_fwd, resid_ef.resid_bwd)}
            with torch.no_grad():
                p1 = resid_ef.resid_fwd_plain(lv, h_in, x37, v37, upd, mask=m4)
                p2 = resid_ef.resid_bwd_plain(lv, p1, upd, *sd, mask=m4)
                if forced:  # the parent's kernels, not counted
                    k1 = [resid_ef._launch_fwd(lv, h_in, x37, v37, upd, m4, forced)
                          for _ in range(2)]
                    k2 = [resid_ef._bwd_launch("resid_bwd", lv, p1, upd, *sd, m4, lv_t, False,
                                               route=forced)[:3] for _ in range(2)]
                else:  # the wrappers, on the route the shape takes
                    k1 = [resid_ef.resid_fwd(lv, h_in, x37, v37, upd, mask=m4) for _ in range(2)]
                    k2 = [resid_ef.resid_bwd(lv, p1, upd, *sd, mask=m4, leaves_t=lv_t)
                          for _ in range(2)]
                torch.cuda.synchronize()
            took = {c.__name__: {r: c.routes[r] - before[c.__name__][r] for r in c.routes}
                    for c in (resid_ef.resid_fwd, resid_ef.resid_bwd)}
            if not forced and any(n != (2 if r == route else 0)
                                  for t in took.values() for r, n in t.items()):
                fail(f"K1 / K2 {model_label} {label}: launches off the {route} route: {took}")
            # the boundaries, the final state and the 17 residuals (masked: att in two
            # parts, tools/probe_resid.k1_pairs)
            pairs1 = resid_probe_module().k1_pairs(k1[0], p1, m4)
            pairs2 = [*zip(("dh", "dx", "dv"), k2[0], p2)]
            out1 = lambda k: [*k[:6], *(k.resid[n] for n in resid_ef.RESIDS)]
            bitwise = (all(torch.equal(a, b) for a, b in zip(out1(k1[0]), out1(k1[1])))
                       and all(torch.equal(a, b) for a, b in zip(k2[0], k2[1])))
            k1_err = {n: rel_err(a, b) for n, a, b in pairs1}
            k2_err = {n: rel_err(a, b) for n, a, b in pairs2}
            if model_label == "aspirin" and not forced:
                abs_md17["resid_fwd"] = max(abs_md17["resid_fwd"],
                                            *(abs_err(a, b) for _, a, b in pairs1))
                abs_md17["resid_bwd"] = max(abs_md17["resid_bwd"],
                                            *(abs_err(a, b) for _, a, b in pairs2))
            worst1, worst2 = max(k1_err, key=k1_err.get), max(k2_err, key=k2_err.get)
            finite = all(bool(torch.isfinite(a).all()) for _, a, _ in pairs1 + pairs2)
            print(f"K1 vs plain {label} {model_label} on the {route}"
                  f"{' (forced)' if forced else ''} (B={Bk}, N={N}, depth 6): max rel err "
                  f"{k1_err[worst1]:.3e} ({worst1}), second launch bitwise {bitwise}, finite "
                  f"{finite} " + json.dumps({k: float(f"{v:.3e}") for k, v in k1_err.items()}),
                  flush=True)
            print(f"K2 vs plain {label} {model_label} on the {route}: max rel err "
                  f"{k2_err[worst2]:.3e} ({worst2}) "
                  + json.dumps({k: float(f"{v:.3e}") for k, v in k2_err.items()}), flush=True)
            if not (k1_err[worst1] <= K1_TOL and k2_err[worst2] <= K2_TOL and bitwise
                    and finite):
                fail(f"{label} {model_label} K1 / K2 on the {route} vs plain beyond {K1_TOL}, "
                     "or a second launch not bitwise equal")
            del k1, k2, p1, p2
        # #3 from (h37, x37, v = 0): the energy (node-masked readout) and dx
        m3 = m4[..., 0].contiguous() if m4 is not None else None
        with torch.no_grad():
            k3 = one_ef._launch_one_ef(params, leaves, h37, x37, upd, m3, leaves_t)
            p3 = one_ef.one_ef_plain(params, leaves, h37, x37, upd, m3)
            torch.cuda.synchronize()
        k3_err = {n: rel_err(a, b) for n, a, b in zip(("e", "dx"), k3, p3)}
        abs_md17["one_ef"] = max(abs_md17["one_ef"], *(abs_err(a, b) for a, b in zip(k3, p3)))
        print(f"#3 one_ef vs plain {label} (B={Bk}, N={N}, depth 6): "
              + json.dumps({k: float(f"{v:.3e}") for k, v in k3_err.items()}), flush=True)
        if max(k3_err.values()) > K1_TOL or not all(bool(torch.isfinite(a).all()) for a in k3):
            fail(f"{label} one_ef vs plain beyond {K1_TOL}")
    # the products of K1's and K2's tensor-core route alone against float64: K2's
    # dh, dx and dv barely feel its x-mixing (a copy with 3xTF32's lo passes
    # dropped stays within K2_TOL of plain in the CPU emulator), so its products
    # are held here
    prod_err = resid_probe_module().check_tc_products(dev)
    print(f"SERVING TC PRODUCTS vs float64 (limit {resid_probe_module().TC_PRODUCT_TOL:.0e}): "
          + json.dumps({k: float(f"{v:.3e}") for k, v in prod_err.items()}), flush=True)
    if max(prod_err.values()) > resid_probe_module().TC_PRODUCT_TOL:
        fail("K1's or K2's tensor-core products beyond their limit")

    # -- 4. the MD17 slice: serve aspirin E + F through K1 + K2 -----------------
    serve = make_energy_force_fn(model, species, e_mean, e_std)

    def plain_ef(x, chunk=CHECK_CHUNK):
        return chunked_plain_ef(params, species, x, cfg.n_heads, chunk)

    xs_all = torch.as_tensor(data.x, device=dev)
    serving = (resid_ef.resid_fwd, resid_ef.resid_bwd, one_ef.one_energy_forces)
    for c in serving:
        c.launches = 0
    for c in serving[:2]:
        c.routes = dict.fromkeys(resid_ef.ROUTES, 0)
    answers = {B: serve(xs_all[:B]) for B in REQUESTS}
    torch.cuda.synchronize()
    md17_launches = {c.__name__: c.launches for c in serving}
    serving_routes = {c.__name__: dict(c.routes) for c in serving[:2]}
    print(f"SLICE launches {json.dumps(md17_launches)} (dispatch: one_ef from B >= "
          f"{dispatch.ONE_EF_MIN_BATCH})", flush=True)
    # every K1 and K2 launch of aspirin's requests on the tensor-core route
    print(f"SERVING ROUTES B in {list(REQUESTS)}: {json.dumps(serving_routes)}", flush=True)
    if any(n != (md17_launches[k] if r == "tensor cores" else 0)
           for k, rs in serving_routes.items() for r, n in rs.items()):
        fail(f"a serving launch off its shape's route (aspirin: tensor cores): {serving_routes}")
    routed = [n for n, c in zip(md17_launches, serving)
              if dispatch.ONE_EF_MIN_BATCH is not None or c is not one_ef.one_energy_forces]
    if min(md17_launches[n] for n in routed) == 0:
        fail("the MD17 path did not launch every kernel")
    worst = {"f_err": 0.0, "e_err": 0.0}
    for B, (e, f) in answers.items():
        if e.shape != (B, 1) or f.shape != (B, N, 3):
            fail(f"B={B}: shapes {tuple(e.shape)} {tuple(f.shape)}")
        if not (torch.isfinite(e).all() and torch.isfinite(f).all()):
            fail(f"B={B}: non-finite output")
        e_raw = (e[:, 0] - e_mean) / e_std
        e_ref, f_ref = plain_ef(xs_all[:B])
        f_err = rel_err(f / e_std, f_ref)
        e_err = rel_err(e_raw, e_ref)
        worst = {"f_err": max(worst["f_err"], f_err), "e_err": max(worst["e_err"], e_err)}
        print(f"SLICE B={B}: f_err {f_err:.3e} e_err {e_err:.3e} "
              f"|F|max {float(f.abs().max()):.4g}", flush=True)
    if not (worst["f_err"] <= F_TOL and worst["e_err"] <= E_TOL):
        fail(f"slice beyond f_err {F_TOL} / e_err {E_TOL}: {worst}")

    # timing at B = 2048: the served path vs the plain f32 autograd path, both
    # in chunks of 512, in turns; every run is printed beside each side's mean
    Bt = 2048
    xb = xs_all[:Bt]
    runs = {"plain": [], "kernel": []}
    for side in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        fn = serve if side == "kernel" else lambda x: plain_ef(x, PATH_CHUNK)
        runs[side].append(cuda_ms(lambda: fn(xb)))
    ms_kernel, ms_plain = (sum(runs[k]) / len(runs[k]) for k in ("kernel", "plain"))
    print(f"TIMING B={Bt}: kernel path {ms_kernel:.2f} ms = {Bt * 1e3 / ms_kernel:.1f} evals/s; "
          f"plain f32 autograd (chunk {PATH_CHUNK}) {ms_plain:.2f} ms = "
          f"{Bt * 1e3 / ms_plain:.1f} evals/s (runs {json.dumps(runs)}; {smi})", flush=True)
    # per kernel at the shapes the main path gives it (chunk 512, depth 6)
    xc = xs_all[:PATH_CHUNK].permute(2, 0, 1).contiguous()
    hc = embed(params, species.to(dev).expand(PATH_CHUNK, N, -1)).contiguous()
    zc = torch.zeros_like(xc)
    u6 = [1.0] * cfg.depth
    with torch.no_grad():
        leaves_t = transposed(leaves)
        fwd = resid_ef.resid_fwd(leaves, hc, xc, zc, u6)
        dh = torch.randn(hc.shape, device=dev, generator=torch.Generator(dev).manual_seed(2))
        t_k1 = cuda_ms(lambda: resid_ef.resid_fwd(leaves, hc, xc, zc, u6))
        t_p1 = cuda_ms(lambda: resid_ef.resid_fwd_plain(leaves, hc, xc, zc, u6))
        t_k2 = cuda_ms(lambda: resid_ef.resid_bwd(leaves, fwd, u6, dh, zc, zc,
                                                  leaves_t=leaves_t))
        t_p2 = cuda_ms(lambda: resid_ef.resid_bwd_plain(leaves, fwd, u6, dh, zc, zc))
        # the parent's CUDA-core kernels at the same shapes, forced
        t_k1c = cuda_ms(lambda: resid_ef._launch_fwd(leaves, hc, xc, zc, u6, None, "CUDA cores"))
        t_k2c = cuda_ms(lambda: resid_ef._bwd_launch("resid_bwd", leaves, fwd, u6, dh, zc, zc,
                                                     None, leaves_t, False, route="CUDA cores"))
    r1, r2 = (resid_ef.ROUTES[f(resid_ef._dims(leaves, hc))]
              for f in (resid_ef.fwd_tensor_core_route, resid_ef.bwd_tensor_core_route))
    print(f"TIMING per kernel at B={PATH_CHUNK} depth 6: K1 {t_k1:.2f} ms on the {r1} (CUDA-core "
          f"kernel {t_k1c:.2f}, plain {t_p1:.2f}), K2 {t_k2:.2f} ms on the {r2} (CUDA-core kernel "
          f"{t_k2c:.2f}, plain {t_p2:.2f}) ({smi})", flush=True)

    # where the B = 2048 path's time goes: K1 + K2 per chunk against the rest
    # (leaf restaging, embed, the readout seed, layout copies, host gaps)
    n_chunks = -(-Bt // PATH_CHUNK)
    with torch.no_grad():
        t_stage = cuda_ms(lambda: transposed(wide_stack(model.functional_params(), cfg.n_heads)))
        hb = species.to(dev).expand(Bt, N, -1)
        t_embed = cuda_ms(lambda: embed(params, hb))
    t_seed = cuda_ms(lambda: resid_ef._readout_seed(params, fwd.h_fin, None))
    inside = n_chunks * (t_k1 + t_k2)
    outside = ms_kernel - inside
    print(f"BREAKDOWN B={Bt}: K1+K2 {n_chunks}x({t_k1:.3f}+{t_k2:.3f}) = {inside:.3f} ms of the "
          f"path's {ms_kernel:.3f} ms; outside {outside:.3f} ms "
          f"({100 * outside / ms_kernel:.2f}%): leaf restaging {t_stage:.3f} ms, "
          f"embed {t_embed:.3f} ms, readout seed {n_chunks}x{t_seed:.3f} ms", flush=True)
    print("SLICE " + json.dumps({"evals_per_s_kernel": 2048e3 / ms_kernel,
                                 "evals_per_s_plain": 2048e3 / ms_plain, **worst}), flush=True)

    # #3 against K1 + K2 (chunks of 512) in turns, and the dispatch threshold
    # it implies: the smallest measured batch where #3 is within 5% of K1 + K2
    # (the JAX threshold 2048 first), or none
    h_all = species.to(dev).expand(max(ONE_EF_BATCHES), N, -1)
    x_big = torch.as_tensor(np.concatenate([data.x] * -(-max(ONE_EF_BATCHES) // len(data.x))),
                            device=dev)
    t_one, t_pair = {}, {}
    with torch.no_grad():
        for Bo in ONE_EF_BATCHES:
            hb_, xb_ = h_all[:Bo], x_big[:Bo]
            runs = {"one_ef": [], "resid": []}
            for side in ("resid", "one_ef", "one_ef", "resid"):
                fn = one_ef.one_energy_forces if side == "one_ef" else resid_ef.resid_energy_forces
                runs[side].append(cuda_ms(lambda: fn(params, hb_, xb_, n_heads=cfg.n_heads),
                                          reps=2))
            t_one[Bo], t_pair[Bo] = (sum(runs[k]) / 2 for k in ("one_ef", "resid"))
            print(f"TIMING #3 one_ef vs K1 + K2 at B={Bo}: {t_one[Bo]:.2f} ms "
                  f"({Bo * 1e3 / t_one[Bo]:.1f} evals/s) vs {t_pair[Bo]:.2f} ms "
                  f"({Bo * 1e3 / t_pair[Bo]:.1f} evals/s), ratio {t_one[Bo] / t_pair[Bo]:.4f} "
                  f"(runs {json.dumps(runs)}; {smi})", flush=True)
    wins = [Bo for Bo in ONE_EF_BATCHES if t_one[Bo] <= 1.05 * t_pair[Bo]]
    print(f"DISPATCH measured threshold {wins[0] if wins else None}; configured "
          f"{dispatch.ONE_EF_MIN_BATCH}", flush=True)
    B3 = ONE_EF_BATCHES[0]  # the JAX threshold; the kernel entry's batch
    # #3's own path, whatever the dispatch does: a request of B3 molecules
    # through one_ef.one_energy_forces (the JAX large-batch entry point)
    one_ef.one_energy_forces.launches = 0
    with torch.no_grad():
        e3, f3 = one_ef.one_energy_forces(params, h_all[:B3], x_big[:B3], n_heads=cfg.n_heads)
        torch.cuda.synchronize()
    md17_launches["one_energy_forces"] = one_ef.one_energy_forces.launches
    e_ref3, f_ref3 = plain_ef(x_big[:B3])
    one_err = {"f_err": rel_err(f3, f_ref3), "e_err": rel_err(e3, e_ref3)}
    print(f"ONE_EF path B={B3}: launches {md17_launches['one_energy_forces']}, "
          + json.dumps({k: float(f"{v:.3e}") for k, v in one_err.items()}), flush=True)
    if (md17_launches["one_energy_forces"] == 0 or one_err["f_err"] > F_TOL
            or one_err["e_err"] > E_TOL):
        fail("the one_ef path did not launch #3 or is beyond its limits")
    del e3, f3, e_ref3, f_ref3
    with torch.no_grad():
        h3, x3 = embed(params, h_all[:B3]).contiguous(), x_big[:B3].permute(2, 0, 1).contiguous()
        t_p3 = cuda_ms(lambda: one_ef.one_ef_plain(params, leaves, h3, x3, u6), reps=1)
    fma_one = sum(v for k, v in layer_fma(N, FULL["hidden"], FULL["hidden"], 50, FULL["heads"],
                                          256).items() if k in ("fwd", "bwd")) * B3 * cfg.depth
    one_entry = kernel_entry("one_ef", "sake_tpu_torch/csrc/fused_ef.cu",
                             "sake_tpu/kernels/one_ef.py:177",
                             md17_launches["one_energy_forces"], abs_md17["one_ef"], t_one[B3],
                             t_p3, fma_one, nbytes(leaves, leaves_t, h3, x3) + B3 * 4 * (1 + 3 * N))
    del h3, x3, h_all, x_big
    dims21 = (N, FULL["hidden"], FULL["hidden"], 50, FULL["heads"], 256)
    fma21 = {k: v * PATH_CHUNK * cfg.depth for k, v in layer_fma(*dims21).items()}
    # the tensor-core routes' products (the x-mixing, o_f, o1 and their pullbacks)
    # at 3xTF32's 3 passes over the TF32 peak
    tc21 = {k: v * PATH_CHUNK * cfg.depth for k, v in tc_fma(*dims21[:1], *dims21[2:]).items()}
    moved1 = nbytes(leaves, hc, xc, zc, fwd)
    moved2 = nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, dh, zc, zc, dh, zc, zc)
    print(f"BOUND per kernel at B={PATH_CHUNK}: K1 {bound(fma21['fwd'], moved1, tc=tc21['fwd'])} "
          f"(all f32 {bound(fma21['fwd'], moved1)}), K2 "
          f"{bound(fma21['bwd'], moved2, tc=tc21['bwd'])} (all f32 {bound(fma21['bwd'], moved2)})",
          flush=True)
    kernels = [
        kernel_entry("resid_fwd", "sake_tpu_torch/csrc/resid_fwd.cu",
                     "sake_tpu/kernels/resid_ef.py:1099", md17_launches["resid_fwd"],
                     abs_md17["resid_fwd"], t_k1, t_p1, fma21["fwd"], moved1,
                     tc=tc21["fwd"] if r1 == "tensor cores" else 0.0),
        kernel_entry("resid_bwd", "sake_tpu_torch/csrc/resid_bwd.cu",
                     "sake_tpu/kernels/resid_ef.py:1211", md17_launches["resid_bwd"],
                     abs_md17["resid_bwd"], t_k2, t_p2, fma21["bwd"], moved2,
                     tc=tc21["bwd"] if r2 == "tensor cores" else 0.0),
        one_entry,
    ]
    del fwd, answers
    return kernels


def qm9_phases(dev, smi) -> list:
    """Phases 5-7 (see the module docstring); returns their kernel entries."""
    import torch

    from sake_tpu_torch.data.qm9 import dimenet_split, load_qm9
    from sake_tpu_torch.kernels import build, resid_ef
    from sake_tpu_torch.kernels.adapter import model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
    from sake_tpu_torch.tasks import qm9 as task
    from sake_tpu_torch.train import (
        TrainState,
        make_optimizer,
        run_epoch,
        shuffle_batches,
        tree_leaves,
    )
    from sake_tpu_torch.train.metrics import MetricLogger

    cfg = task.QM9Config(use_kernel_backbone=True, data_parallel=False, n_epochs=QM9_EPOCHS)
    plain_cfg = task.QM9Config(data_parallel=False)
    data = load_qm9(None, cfg.n_samples, seed=cfg.seed)
    tr_idx, _, _ = dimenet_split(len(data.x))
    n_classes = int(data.charges.max()) + 1
    y_mean, y_std = float(data.y[tr_idx].mean()), float(data.y[tr_idx].std())
    train = task.prepare_split(data, tr_idx, n_classes, y_mean, y_std, dev)
    new_model = lambda: task.QM9Model(cfg, n_classes, device=dev,
                                      generator=torch.Generator().manual_seed(cfg.seed))
    batches = shuffle_batches(np.random.RandomState(cfg.seed), train, cfg.batch_size)
    batch = batches[0]
    B, N = batch["x"].shape[:2]
    F, depth = cfg.hidden_features, cfg.depth

    # -- 5. kernels vs plain at the QM9 shapes ----------------------------------
    params, _ = task.make_forward(cfg, new_model())
    upd = [1.0] * depth
    with torch.no_grad():
        kp = params["kp"]
        leaves = wide_stack(kp, cfg.n_heads)
        leaves_t = transposed(leaves)
        h0 = embed(kp, batch["species"]).contiguous()
        xs = batch["x"].permute(2, 0, 1).contiguous()
        zs = torch.zeros_like(xs)
        m4 = batch["edge_mask"][..., None].contiguous()
        dh = torch.randn(B, N, F, device=dev, generator=torch.Generator(dev).manual_seed(3))
        cl0 = (resid_ef.resid_fwd.cluster_launches, resid_ef.resid_bwd_rows.cluster_launches)
        n6 = resid_ef.resid_infer.launches
        k4 = resid_ef.resid_fwd(leaves, h0, xs, zs, upd, mask=m4, cluster=True)
        k4_again = resid_ef.resid_fwd(leaves, h0, xs, zs, upd, mask=m4, cluster=True)
        k4_block = resid_ef.resid_fwd(leaves, h0, xs, zs, upd, mask=m4)
        p4 = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, mask=m4)
        k6 = resid_ef.resid_infer(leaves, h0, xs, zs, upd, mask=m4)
        k6_again = resid_ef.resid_infer(leaves, h0, xs, zs, upd, mask=m4)
        p6 = resid_ef.resid_infer_plain(leaves, h0, xs, zs, upd, mask=m4)
        k5 = resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, mask=m4, leaves_t=leaves_t,
                                     cluster=True)
        k5_again = resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, mask=m4,
                                           leaves_t=leaves_t, cluster=True)
        k5_block = resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, mask=m4,
                                           leaves_t=leaves_t)
        p5 = resid_ef.resid_bwd_rows_plain(leaves, p4, upd, dh, zs, zs, mask=m4)
        kg = resid_ef.param_grads(leaves, p4, k5[3])
        pg = resid_ef.param_grads_plain(leaves, p4, p5[3])
        pg_same = resid_ef.param_grads_plain(leaves, p4, k5[3])
        torch.cuda.synchronize()
    if (resid_ef.resid_fwd.cluster_launches - cl0[0],
            resid_ef.resid_bwd_rows.cluster_launches - cl0[1]) != (2, 2):
        fail("QM9: #4 and #5 did not take their cluster route at the slice's shapes")
    if resid_ef.resid_infer.launches - n6 != 2:
        fail("QM9: #6 did not launch its cluster kernel at the slice's shapes")
    fwd_pairs = lambda k: [*zip(("bh", "bx", "bv", "h_fin", "x_fin", "v_fin"), k[:6], p4[:6]),
                           *((n, k.resid[n], p4.resid[n]) for n in resid_ef.RESIDS)]
    rows_pairs = lambda k: [*zip(("dh", "dx", "dv"), k[:3], p5[:3]),
                            *((n, k[3][n], p5[3][n]) for n in resid_ef.ROWS)]
    bitwise = {
        "resid_fwd_masked (cluster)": all(torch.equal(a, b) for (_, a, _), (_, b, _) in zip(
            fwd_pairs(k4), fwd_pairs(k4_again))),
        "resid_bwd_rows (cluster)": all(torch.equal(a, b) for (_, a, _), (_, b, _) in zip(
            rows_pairs(k5), rows_pairs(k5_again))),
        "resid_infer (cluster)": all(torch.equal(a, b) for a, b in zip(k6, k6_again)),
    }
    print(f"QM9 BITWISE second launch of each cluster kernel: {json.dumps(bitwise)}", flush=True)
    if not all(bitwise.values()):
        fail("QM9: a cluster kernel's second launch differs from its first")
    same = {n: torch.equal(a, b) for n, a, b in zip(("h_fin", "x_fin"), k6, (k4.h_fin, k4.x_fin))}
    print(f"QM9 #6 against #4's cluster kernel (the same body with its streams), bit for bit: "
          f"{json.dumps(same)}", flush=True)
    occ = {name: getattr(build.load(), entry)(*resid_ef._dims(leaves, h0))
           for name, entry in (("#4 cluster", "sake_resid_fwd_cluster_max_active"),
                               ("#5 cluster", "sake_resid_bwd_cluster_max_active"))}
    print(f"QM9 OCCUPANCY clusters the card holds at once (B={B}, N={N}): {json.dumps(occ)}; "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs", flush=True)
    checks = {
        "resid_fwd_masked": fwd_pairs(k4),
        "resid_fwd_masked_block": fwd_pairs(k4_block),
        "resid_infer": [("h_fin", k6[0], p6[0]), ("x_fin", k6[1], p6[1])],
        "resid_bwd_rows": rows_pairs(k5),
        "resid_bwd_rows_block": rows_pairs(k5_block),
        "param_grads": [(f"{n}[{l}]", kg[n][l], pg[n][l]) for n in LEAF_NAMES
                        for l in range(depth)],
        "param_grads_same_rows": [(f"{n}[{l}]", kg[n][l], pg_same[n][l]) for n in LEAF_NAMES
                                  for l in range(depth)],
    }
    abs_qm9 = {}
    for name, pairs in checks.items():
        errs = {n: rel_err(a, b) for n, a, b in pairs}
        abs_qm9[name] = max(abs_err(a, b) for _, a, b in pairs)
        w = max(errs, key=errs.get)
        print(f"QM9 {name} vs plain (B={B}, N={N}, depth {depth}, masked): max rel err "
              f"{errs[w]:.3e} ({w}), max abs err {abs_qm9[name]:.3e} "
              + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()}), flush=True)
        if errs[w] > QM9_TOL:
            fail(f"QM9 {name} beyond {QM9_TOL}")
    del k4, k4_again, k4_block, k6, k6_again, k5, k5_again, k5_block, p5, kg, pg, pg_same
    del checks

    # -- 6. the QM9 slice through tasks/qm9.run -----------------------------------
    counters = (resid_ef.resid_fwd, resid_ef.resid_infer, resid_ef.resid_bwd_rows,
                resid_ef.param_grads, resid_ef.resid_bwd)
    step_losses = []

    def recording_epoch(step_fn, state, batches_):
        state, losses = run_epoch(step_fn, state, batches_)
        step_losses.append(losses)
        return state, losses

    task.run_epoch = recording_epoch  # keeps every step's loss of the run
    for c in counters:
        c.launches = 0
    for c in (resid_ef.resid_fwd, resid_ef.resid_bwd_rows):
        c.cluster_launches = 0
    logger = MetricLogger(stream=sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, results = task.run(cfg, logger, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    task.run_epoch = run_epoch
    qm9_launches = {c.__name__: c.launches for c in counters}
    qm9_launches.update({f"{c.__name__} (cluster)": c.cluster_launches
                         for c in (resid_ef.resid_fwd, resid_ef.resid_bwd_rows)})
    losses = torch.cat(step_losses).cpu()
    print(f"QM9 SLICE launches {json.dumps(qm9_launches)}; {len(losses)} steps in "
          f"{wall:.2f} s with the evaluation; loss first {float(losses[0]):.6f} last "
          f"{float(losses[-1]):.6f}; valid MAE {results['valid_mae']:.6f} "
          f"(CI {[float(v) for v in results['valid_mae_ci']]}), test MAE "
          f"{results['test_mae']:.6f}", flush=True)
    print("QM9 SLICE losses " + json.dumps([float(f"{v:.6f}") for v in losses]), flush=True)
    if min(qm9_launches[k] for k in ("resid_infer", "param_grads")) == 0:
        fail("the QM9 path did not launch every kernel")
    # each step: one forward and one rows pullback, on the cluster route
    if (qm9_launches["resid_fwd (cluster)"] != len(losses)
            or qm9_launches["resid_bwd_rows (cluster)"] != len(losses)
            or qm9_launches["resid_fwd"] or qm9_launches["resid_bwd_rows"]):
        fail(f"the QM9 path did not launch #4's and #5's cluster kernels once a step "
             f"({len(losses)} steps)")
    if not (torch.isfinite(losses).all() and losses[-1] < losses[0]
            and losses[-10:].mean() < losses[:10].mean()):
        fail("the QM9 training loss is not finite or did not fall")
    if not all(np.isfinite(results[k]) for k in ("valid_mae", "test_mae")):
        fail("non-finite QM9 evaluation")

    # -- 7. step parity against the plain branch, and timing --------------------
    branches = {}
    for name, c in (("kernel", cfg), ("plain", plain_cfg)):
        prm, fwd_fn = task.make_forward(c, new_model())
        branches[name] = dict(params=prm, forward=fwd_fn, step=task.make_train_step(fwd_fn),
                              state=TrainState.create(params=prm, tx=make_optimizer(
                                  c.learning_rate, weight_decay=c.weight_decay)))

    def loss_and_grads(br):
        leaves_ = tree_leaves(br["params"])
        pred = br["forward"](br["params"], batch["species"], batch["x"], batch["edge_mask"],
                             batch["node_mask"])
        loss = ((pred - batch["y"]) ** 2).mean()
        return loss.detach(), dict(zip(map(id, leaves_), torch.autograd.grad(
            loss, leaves_, allow_unused=True)))

    head_names = [(d, w) for d in ("dense_0", "dense_1") for w in ("kernel", "bias")]
    lk, gk = loss_and_grads(branches["kernel"])
    lp, gp = loss_and_grads(branches["plain"])
    pk = branches["kernel"]["params"]
    got = resid_ef.flat_params(pk["kp"]) + [pk["head"][d][w] for d, w in head_names]
    got = [gk[id(t)] for t in got]
    tree = {}  # the plain branch's gradients by linen name
    for name, prm in branches["plain"]["params"].items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        g = gp[id(prm)]
        node[leaf] = torch.zeros_like(prm) if g is None else g
    want = (resid_ef.flat_params(model_params_from_linen(tree["backbone"], dev))
            + [tree["head"]["head"][d][w] for d, w in head_names])
    grad_err = [rel_err(a, b) for a, b in zip(got, want)]
    loss_err = abs(float(lk - lp)) / abs(float(lp))
    print(f"QM9 STEP 1 kernel vs plain branch: loss {float(lk):.7f} vs {float(lp):.7f} "
          f"(rel {loss_err:.2e}); gradients of {len(got)} leaves, max rel err "
          f"{max(grad_err):.3e} (leaf {int(np.argmax(grad_err))})", flush=True)
    if loss_err > QM9_TOL or max(grad_err) > QM9_TOL:
        fail(f"QM9 step 1 beyond {QM9_TOL}")
    traj = {}
    for name, br in branches.items():
        traj[name] = []
        for b_ in batches[:PARITY_STEPS]:
            br["state"], loss = br["step"](br["state"], b_)
            traj[name].append(float(loss))
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj["kernel"], traj["plain"]))
    print(f"QM9 STEPS 1-{PARITY_STEPS} losses kernel {json.dumps(traj['kernel'])} plain "
          f"{json.dumps(traj['plain'])}: max rel diff {traj_err:.2e}", flush=True)
    if traj_err > LOSS_TOL:
        fail(f"QM9 step losses differ beyond {LOSS_TOL}")

    # train step time, kernel and plain branches in turns, 5 steps a run
    runs = {"plain": [], "kernel": []}
    timed = batches[PARITY_STEPS : PARITY_STEPS + 5]
    for side in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        br = branches[side]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b_ in timed:
            br["state"], _ = br["step"](br["state"], b_)
        torch.cuda.synchronize()
        runs[side].append((time.perf_counter() - t0) * 1e3 / len(timed))
    step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    # where the kernel branch's step goes, inside 5 more steps: CUDA events
    # before each step, before its optimizer update and after the step, so the
    # two parts are spans of the stream's timeline that add up to the step
    br = branches["kernel"]
    marks = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append(e)

    apply = TrainState.apply_gradients

    def marked_apply(self, grads):
        mark()
        return apply(self, grads)

    TrainState.apply_gradients = marked_apply
    try:
        for b_ in timed:
            mark()
            br["state"], _ = br["step"](br["state"], b_)
            mark()
    finally:
        TrainState.apply_gradients = apply
    torch.cuda.synchronize()
    span = lambda k: sum(a.elapsed_time(b) for a, b in zip(marks[k::3], marks[k + 1::3]))
    t_fb, t_opt = span(0) / len(timed), span(1) / len(timed)
    n_tensors = len(tree_leaves(br["params"]))
    print(f"QM9 TIMING train step at B={B}: kernel {step_ms['kernel']:.2f} ms = "
          f"{B * 1e3 / step_ms['kernel']:.1f} samples/s; plain {step_ms['plain']:.2f} ms = "
          f"{B * 1e3 / step_ms['plain']:.1f} samples/s (ms per step, runs {json.dumps(runs)}; "
          f"{smi})", flush=True)
    print(f"QM9 BREAKDOWN kernel-branch step, inside {len(timed)} more steps (CUDA events): "
          f"{t_fb + t_opt:.2f} ms a step = forward + backward {t_fb:.2f} ms + optimizer update "
          f"{t_opt:.2f} ms ({t_opt / (t_fb + t_opt):.1%}, {n_tensors} tensors); the timed "
          f"runs' step {step_ms['kernel']:.2f} ms", flush=True)

    # per kernel at the slice's shapes
    with torch.no_grad():
        rows = resid_ef.resid_bwd_rows(leaves, p4, upd, dh, zs, zs, mask=m4,
                                       leaves_t=leaves_t, cluster=True)[3]
        grads = resid_ef.param_grads(leaves, p4, rows)
        t_fwd_plain = cuda_ms(lambda: resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd, m4))
        t_rows_plain = cuda_ms(lambda: resid_ef.resid_bwd_rows_plain(leaves, p4, upd, dh, zs,
                                                                     zs, m4))
        t = dict(
            resid_fwd_masked=(cuda_ms(lambda: resid_ef.resid_fwd(leaves, h0, xs, zs, upd, m4,
                                                                 cluster=True)), t_fwd_plain),
            resid_fwd_masked_block=(cuda_ms(lambda: resid_ef.resid_fwd(leaves, h0, xs, zs, upd,
                                                                       m4)), t_fwd_plain),
            resid_infer=(cuda_ms(lambda: resid_ef.resid_infer(leaves, h0, xs, zs, upd, m4)),
                         cuda_ms(lambda: resid_ef.resid_infer_plain(leaves, h0, xs, zs, upd,
                                                                    m4))),
            resid_bwd_rows=(cuda_ms(lambda: resid_ef.resid_bwd_rows(
                                leaves, p4, upd, dh, zs, zs, m4, leaves_t=leaves_t,
                                cluster=True)), t_rows_plain),
            resid_bwd_rows_block=(cuda_ms(lambda: resid_ef.resid_bwd_rows(
                                      leaves, p4, upd, dh, zs, zs, m4, leaves_t=leaves_t)),
                                  t_rows_plain),
            param_grads=(cuda_ms(lambda: resid_ef.param_grads(leaves, p4, rows)),
                         cuda_ms(lambda: resid_ef.param_grads_plain(leaves, p4, rows))),
        )
    fma = {k: v * B * depth for k, v in layer_fma(N, F, F, 50, cfg.n_heads, 256).items()}
    # the cluster kernels run the x-mixing product and o_f, o1 in 3xTF32
    tcf = {k: v * B * depth for k, v in tc_fma(N, F, 50, cfg.n_heads, 256).items()}
    moved_fwd = nbytes((leaves, h0, xs, zs, m4), p4)
    moved_rows = nbytes(leaves, leaves_t, p4.bh, p4.bx, p4.bv, p4.resid, m4, dh, zs, zs, dh, zs,
                        zs, rows)
    inputs_fwd = (leaves, h0, xs, zs, m4)
    moved_infer = nbytes(inputs_fwd, p4.h_fin, p4.x_fin)
    bounds = {"resid_fwd_masked": bound(fma["fwd"], moved_fwd, tc=tcf["fwd"])[0],
              "resid_fwd_masked_block": bound(fma["fwd"], moved_fwd)[0],
              "resid_infer": bound(fma["fwd"], moved_infer, tc=tcf["fwd"])[0],
              "resid_bwd_rows": bound(fma["bwd"], moved_rows, tc=tcf["bwd"])[0],
              "resid_bwd_rows_block": bound(fma["bwd"], moved_rows)[0]}
    print(f"QM9 TIMING per kernel (ms, kernel and plain) at B={B}, N={N}, depth {depth} "
          f"(resid_fwd_masked, resid_infer and resid_bwd_rows on their cluster route, the "
          f"*_block ones on the one-block route; {smi}): "
          + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in t.items()})
          + "; bounds (ms) " + json.dumps({k: round(v, 4) for k, v in bounds.items()})
          + f"; kernels of one step {t['resid_fwd_masked'][0] + t['resid_bwd_rows'][0] + t['param_grads'][0]:.2f} ms",
          flush=True)
    src = "sake_tpu_torch/csrc/"
    at = "sake_tpu/kernels/resid_ef.py:"
    return [
        kernel_entry("resid_fwd_masked", src + "resid_fwd.cu", at + "1484",
                     qm9_launches["resid_fwd (cluster)"], abs_qm9["resid_fwd_masked"],
                     *t["resid_fwd_masked"], fma["fwd"], moved_fwd, tc=tcf["fwd"]),
        kernel_entry("resid_infer", src + "resid_fwd.cu", at + "1732",
                     qm9_launches["resid_infer"], abs_qm9["resid_infer"], *t["resid_infer"],
                     fma["fwd"], moved_infer, tc=tcf["fwd"]),
        kernel_entry("resid_bwd_rows", src + "resid_bwd_cl.cu", at + "1598",
                     qm9_launches["resid_bwd_rows (cluster)"], abs_qm9["resid_bwd_rows"],
                     *t["resid_bwd_rows"], fma["bwd"], moved_rows, tc=tcf["bwd"]),
        kernel_entry("param_grads", src + "param_grads.cu", at + "1598",
                     qm9_launches["param_grads"], abs_qm9["param_grads"], *t["param_grads"],
                     fma["grads"], nbytes(leaves, p4.bh, grads_streams(p4.resid), rows, grads)),
    ]


def md17_train_phases(dev, smi) -> list:
    """Phases 8-10 (see the module docstring); returns their kernel entries."""
    import dataclasses

    import torch

    from sake_tpu_torch.data.md17 import load_md17
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.adapter import model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed, flat_params, readout
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
    from sake_tpu_torch.tasks import md17 as task
    from sake_tpu_torch.tasks.registry import get_workload
    from sake_tpu_torch.train import (
        TrainState,
        make_optimizer,
        run_epoch,
        shuffle_batches,
        tree_leaves,
        warmup_cosine_schedule,
    )
    from sake_tpu_torch.train.metrics import MetricLogger

    cfg = task.MD17Config(use_kernel_ef=True, aug_mode="shared", **MD17_RUN)
    data = load_md17(cfg.molecule, None, n_samples=max(cfg.n_train + 2 * cfg.n_valid,
                                                       max(TRAIN_BATCHES)))
    species = task.species_onehot(data.z, int(data.z.max()))
    n_tr = cfg.n_train
    e_mean, e_std = float(data.e[:n_tr].mean()), float(data.e[:n_tr].std())
    N, F, depth = len(data.z), cfg.hidden_features, cfg.depth
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    train = {"x": tdev(data.x), "e": tdev(data.e), "f": tdev(data.f)}

    def branch(use_kernel_ef: bool, aug_mode: str = "shared"):
        c = dataclasses.replace(cfg, use_kernel_ef=use_kernel_ef, aug_mode=aug_mode)
        model = task.make_model(c, species.shape[-1], device=dev,
                                generator=torch.Generator().manual_seed(c.seed))
        prm, ef_fn, _ = task.make_branch(c, model, species, e_mean, e_std)
        total = (c.n_train // c.batch_size) * c.n_epochs
        state = TrainState.create(params=prm, tx=make_optimizer(
            warmup_cosine_schedule(c.learning_rate, total)))
        return dict(params=prm, ef=ef_fn, step=task.make_step_fn(ef_fn, c.energy_loss_weight),
                    state=state)

    # -- 8. #7-#10 against their plain versions at full width -------------------
    kp = branch(True)["params"]
    Bc = TRAIN_CHECK_B
    gen = torch.Generator(dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    upd = [1.0] * depth
    with torch.no_grad():
        leaves = wide_stack(kp, cfg.n_heads)
        leaves_t = transposed(leaves)
        h0 = embed(kp, species.to(dev).expand(Bc, N, -1)).contiguous()
        xs = train["x"][:Bc].permute(2, 0, 1).contiguous()
        zs = torch.zeros_like(xs)
        tx0, dh_fin, dth_fin = rnd(3, Bc, N), rnd(Bc, N, F), rnd(Bc, N, F)
        k7 = t2.shared_fwd(leaves, h0, xs, upd)
        p7 = resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd)
        k8 = t2.shared_bwd(leaves, p7, upd, dh_fin, leaves_t=leaves_t)
        p8 = resid_ef.resid_bwd_plain(leaves, p7, upd, dh_fin, zs, zs)[1]
        k9 = t2.resid_jvp(leaves, p7, upd, tx0)
        p9 = t2.resid_jvp_plain(leaves, p7, upd, tx0)
        torch.cuda.synchronize()
        fwd_names = ("bh", "bx", "bv", "h_fin", "x_fin", "v_fin")
        checks = {
            "shared_fwd": [*zip(fwd_names, k7[:6], p7[:6]),
                           *((n, k7.resid[n], p7.resid[n]) for n in resid_ef.RESIDS)],
            "shared_bwd": [("dx", k8, p8)],
            "resid_jvp": [*zip(fwd_names, k9[:6], p9[:6]),
                          *((n, k9.resid[n], p9.resid[n]) for n in resid_ef.RESIDS)],
        }
        del k7, k9
        kt = t2.resid_tbwd(leaves, p7, p9, upd, dth_fin, zs, zs, leaves_t=leaves_t)
        pt = t2.resid_tbwd_plain(leaves, p7, p9, upd, dth_fin, zs, zs)
        torch.cuda.synchronize()
        checks["resid_tbwd"] = [*zip(("dh", "dx", "dv", "add_h", "add_x", "add_v"),
                                     [*kt[:3], *kt[3]], [*pt[:3], *pt[3]]),
                                *((n, kt[4][n], pt[4][n]) for n in resid_ef.ROWS),
                                *((f"t_{n}", kt[5][n], pt[5][n]) for n in resid_ef.ROWS)]
        del kt
        kb = t2.resid_bwd_aug(leaves, p7, upd, dh_fin, zs, zs, pt[3], leaves_t=leaves_t)
        pb = t2.resid_bwd_aug_plain(leaves, p7, upd, dh_fin, zs, zs, pt[3])
        torch.cuda.synchronize()
        checks["resid_bwd_aug"] = [*zip(("dh", "dx", "dv"), kb[:3], pb[:3]),
                                   *((n, kb[3][n], pb[3][n]) for n in resid_ef.ROWS)]
        del kb
        kg = t2.param_grads_aug(leaves, p7, p9, pb[3], pt[4], pt[5])
        pg = t2.param_grads_aug_plain(leaves, p7, p9, pb[3], pt[4], pt[5])
        torch.cuda.synchronize()
        checks["param_grads_aug"] = [(f"{n}[{l}]", kg[n][l], pg[n][l]) for n in LEAF_NAMES
                                     for l in range(depth)]
        del kg, pg, pb, pt
        ka = t2.resid_aug_bwd(leaves, p7, p9, upd, dh_fin, dth_fin, leaves_t=leaves_t)
        pa = t2.resid_aug_bwd_plain(leaves, p7, p9, upd, dh_fin, dth_fin)
        torch.cuda.synchronize()
        checks["resid_aug_bwd"] = [*zip(("dh0", "dx", "dth"), ka[:3], pa[:3]),
                                   *((f"{n}[{l}]", ka[3][n][l], pa[3][n][l])
                                     for n in LEAF_NAMES for l in range(depth))]
    abs_train = {}
    report_checks(checks, abs_train, f"vs plain (B={Bc}, N={N}, depth {depth})")
    del checks, ka, pa, p8, p9

    # #11 and #12 against their plain versions, and #12 against the shared
    # backward (#9, head, #10) on one FwdOut
    with torch.no_grad():
        g_e = rnd(Bc)
        k11 = t2.fused_primal(kp, leaves, h0, xs, upd, leaves_t=leaves_t)
        p11 = t2.fused_primal_plain(kp, leaves, h0, xs, upd)
        torch.cuda.synchronize()
        checks = {"fused_primal": [*zip(fwd_names, k11[0][:6], p11[0][:6]),
                                   *((n, k11[0].resid[n], p11[0].resid[n])
                                     for n in resid_ef.RESIDS),
                                   ("e", k11[1], p11[1]), ("dx", k11[2], p11[2])]}
        # the kernel's E plane against the torch readout the loss reads
        e_torch = readout(kp, p11[0].h_fin).sum(dim=(-2, -1))
        checks["fused_primal_e_vs_torch_readout"] = [("e", k11[1], e_torch)]
        del k11
        k12 = t2.fused_bwd(kp, leaves, p7, upd, tx0, g_e, leaves_t=leaves_t)
        torch.cuda.synchronize()
        names12 = ("dh0", "dx0", "d_w_out0", "d_b_out0", "d_w_out1", "d_b_out1")
        flat12 = lambda r: [r[0], r[1], *r[2]]
        grads12 = lambda r: [(f"{n}[{l}]", r[3][n][l]) for n in LEAF_NAMES for l in range(depth)]
        p12 = t2.fused_bwd_plain(kp, leaves, p7, upd, tx0, g_e)
        checks["fused_bwd"] = [*zip(names12, flat12(k12), flat12(p12)),
                               *((n, a, b) for (n, a), (_, b) in zip(grads12(k12), grads12(p12)))]
        del p12
        tf = t2.resid_jvp(leaves, p7, upd, tx0)
        ro, dh_s, dth_s = t2.head_grads(kp, p7.h_fin, tf.h_fin, g_e)
        sh = t2.resid_aug_bwd(leaves, p7, tf, upd, dh_s, dth_s, leaves_t=leaves_t)
        sh = (sh[0], sh[1], ro, sh[3])
        torch.cuda.synchronize()
        checks["fused_bwd_vs_shared_bwd"] = [
            *zip(names12, flat12(k12), flat12(sh)),
            *((n, a, b) for (n, a), (_, b) in zip(grads12(k12), grads12(sh)))]
        del tf, sh, k12
    report_checks(checks, abs_train, f"(B={Bc}, N={N}, depth {depth})")
    del checks, p7, p11

    # the resid and retrace modes: #18, #16, #17 and #19 against their plain
    # versions, and #17 against #19 (two routes to the same gradients)
    with torch.no_grad():
        k18 = t2.aug_fwd(leaves, h0, xs, upd, tx0)
        p18 = t2.aug_fwd_plain(leaves, h0, xs, upd, tx0)
        torch.cuda.synchronize()
        checks = {"aug_fwd": [
            (f"{lab}.{n}", a, b) for lab, k, p in (("p", k18[0], p18[0]), ("t", k18[1], p18[1]))
            for n, a, b in [*zip(fwd_names, k[:6], p[:6]),
                            *((r, k.resid[r], p.resid[r]) for r in resid_ef.RESIDS)]]}
        del k18
        k16 = t2.retrace_fwd(leaves, h0, xs, upd, tx0)
        p16 = t2.retrace_fwd_plain(leaves, h0, xs, upd, tx0)
        torch.cuda.synchronize()
        checks["retrace_fwd"] = [(f"{lab}.{n}", a, b) for lab, k, p in
                                 (("p", k16[0], p16[0]), ("t", k16[1], p16[1]))
                                 for n, a, b in zip(fwd_names, k[:6], p[:6])]
        del k16
        names_aug = ("dh0", "dx0", "dth0")
        flat_aug = lambda r: [*zip(names_aug, r[:3]),
                              *((f"{n}[{l}]", r[3][n][l]) for n in LEAF_NAMES for l in range(depth))]
        k17 = t2.retrace_bwd(leaves, *p16, upd, dh_fin, dth_fin, leaves_t=leaves_t)
        p17 = t2.retrace_bwd_plain(leaves, *p16, upd, dh_fin, dth_fin)
        torch.cuda.synchronize()
        checks["retrace_bwd"] = [(n, a, b) for (n, a), (_, b) in zip(flat_aug(k17), flat_aug(p17))]
        del p17
        k19 = t2.aug_bwd(leaves, *p18, upd, dh_fin, dth_fin, leaves_t=leaves_t)
        p19 = t2.resid_aug_bwd_plain(leaves, *p18, upd, dh_fin, dth_fin)
        torch.cuda.synchronize()
        checks["aug_bwd"] = [(n, a, b) for (n, a), (_, b) in zip(flat_aug(k19), flat_aug(p19))]
        checks["retrace_bwd_vs_aug_bwd"] = [(n, a, b) for (n, a), (_, b) in
                                            zip(flat_aug(k17), flat_aug(k19))]
        del k17, k19, p19, p16, p18
    report_checks(checks, abs_train, f"(B={Bc}, N={N}, depth {depth})")
    del checks
    # the same kernels at narrow widths: 50 rbf channels against H*K = 32 at
    # hidden 8 (the widest buffer of a shared-memory carve changes) and 64 at
    # hidden 16
    for hid in (8, 16):
        narrow = narrow_aug_checks(dev, hid)
        report_checks(narrow, {}, f"at hidden {hid} (B=4, N=7, depth 2)")

    # -- 9. step parity: kernel branch against the plain branch -----------------
    batches = shuffle_batches(np.random.RandomState(0), {k: v[:n_tr] for k, v in train.items()},
                              cfg.batch_size)
    kernel_sides = ("fused", "shared", "resid", "retrace")
    branches = {**{m: branch(True, m) for m in kernel_sides}, "plain": branch(False)}

    def loss_and_grads(br, batch):
        return md17_loss_and_grads(br, batch, cfg.energy_loss_weight)

    lp, gp_ = loss_and_grads(branches["plain"], batches[0])
    tree = {}  # the plain branch's gradients by linen name
    for name, g in zip(sorted(branches["plain"]["params"]), gp_):  # tree_leaves order
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = g
    want = flat_params(model_params_from_linen(tree, dev))
    with torch.no_grad():
        e_p, f_p = branches["plain"]["ef"](None, batches[0]["x"])
    for side, primal in (("fused", "#11"), ("shared", "#7 + #8"), ("resid", "K1 + K2"),
                         ("retrace", "K1 + K2")):
        br = branches[side]
        with torch.no_grad():
            e_k, f_k = br["ef"](br["params"], batches[0]["x"])
        ef_err = {"f_err": rel_err(f_k, f_p), "e_err": rel_err((e_k - e_mean) / e_std,
                                                               (e_p - e_mean) / e_std)}
        print(f"MD17 TRAIN primal ({primal}) E and F vs the functional path at "
              f"B={cfg.batch_size}: " + json.dumps({k: float(f"{v:.3e}") for k, v in
                                                     ef_err.items()}), flush=True)
        if not (ef_err["f_err"] <= F_TOL and ef_err["e_err"] <= E_TOL):
            fail(f"MD17 training primal ({side}) beyond f_err {F_TOL} / e_err {E_TOL}")
        lk, gk = loss_and_grads(br, batches[0])
        grad_err = [rel_err(a, b) for a, b in zip(gk, want)]
        loss_err = abs(float(lk - lp)) / abs(float(lp))
        print(f"MD17 STEP 1 {side} kernel branch vs plain branch: loss {float(lk):.7f} vs "
              f"{float(lp):.7f} (rel {loss_err:.2e}); gradients of {len(gk)} leaves, max rel "
              f"err {max(grad_err):.3e} (leaf {int(np.argmax(grad_err))})", flush=True)
        if loss_err > TRAIN_TOL or max(grad_err) > TRAIN_TOL or len(gk) != len(want):
            fail(f"MD17 step 1 ({side}) beyond {TRAIN_TOL}")
    traj = {}
    for name, br in branches.items():
        traj[name] = []
        for b_ in batches[:PARITY_STEPS]:
            br["state"], loss = br["step"](br["state"], b_)
            traj[name].append(float(loss))
    for side in kernel_sides:
        traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj[side], traj["plain"]))
        print(f"MD17 STEPS 1-{PARITY_STEPS} losses {side} {json.dumps(traj[side])} plain "
              f"{json.dumps(traj['plain'])}: max rel diff {traj_err:.2e}", flush=True)
        if traj_err > LOSS_TOL:
            fail(f"MD17 step losses ({side}) differ beyond {LOSS_TOL}")

    # -- 10. the slices: md17_kernel from the registry in its fused mode,
    # then in the shared, resid and retrace modes; then timing -----------------
    # the training counters each mode must move (K1 and K2 count the shared
    # primal's and the resid_energy_forces primal's launches); the rest stay 0
    k12 = (resid_ef.resid_fwd, resid_ef.resid_bwd)
    aug10 = (t2.resid_tbwd, t2.resid_bwd_aug, t2.param_grads_aug)
    mode_counters = {
        "fused": (t2.fused_primal, t2.fused_bwd_block, t2.fused_bwd_grads),
        "shared": (t2.shared_fwd, t2.shared_bwd, t2.resid_jvp, *aug10, *k12),
        "resid": (t2.aug_fwd, t2.aug_bwd, *aug10, *k12),
        "retrace": (t2.retrace_fwd, t2.retrace_bwd, *k12),
    }
    all_counters = tuple(dict.fromkeys(k for ks in mode_counters.values() for k in ks))

    def slice_run(label, run, c, counters):
        """Train ``c`` through ``run``; every counter of ``counters`` must
        move and every other training counter stay at 0."""
        step_losses = []

        def recording_epoch(step_fn, state, batches_):
            state, losses = run_epoch(step_fn, state, batches_)
            step_losses.append(losses)
            return state, losses

        task.run_epoch = recording_epoch  # keeps every step's loss of the run
        for k in all_counters:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, results = run(c, MetricLogger(stream=sys.stdout), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        task.run_epoch = run_epoch
        launches = {k.__name__: k.launches for k in all_counters}
        losses = torch.cat(step_losses).cpu()
        print(f"MD17 SLICE {label}: launches {json.dumps(launches)}; {len(losses)} steps in "
              f"{wall:.2f} s with the evaluation; loss first {float(losses[0]):.6f} last "
              f"{float(losses[-1]):.6f} (means of the first and last 20 steps "
              f"{float(losses[:20].mean()):.6f} {float(losses[-20:].mean()):.6f}); E MAE "
              f"{results['e_mae_kcalmol']:.4f} kcal/mol (CI "
              f"{[float(v) for v in results['e_mae_ci']]}), F MAE "
              f"{results['f_mae_kcalmol']:.4f} kcal/mol (CI "
              f"{[float(v) for v in results['f_mae_ci']]})", flush=True)
        if min(k.launches for k in counters) == 0:
            fail(f"the MD17 {label} path did not launch every kernel")
        if any(k.launches for k in all_counters if k not in counters):
            fail(f"the MD17 {label} path launched another mode's kernels")
        if not (torch.isfinite(losses).all() and losses[-20:].mean() < losses[:20].mean()):
            fail(f"the MD17 {label} training loss is not finite or did not fall")
        if not all(np.isfinite(results[k]) for k in ("e_mae_kcalmol", "f_mae_kcalmol")):
            fail(f"non-finite MD17 {label} evaluation")
        return launches

    run_k, cfg_k = get_workload("md17_kernel", **MD17_RUN)
    if not (cfg_k.use_kernel_ef and cfg_k.aug_mode == "fused"):
        fail(f"md17_kernel is not the fused kernel branch: {cfg_k}")
    launches = slice_run("md17_kernel (fused mode)", run_k, cfg_k, mode_counters["fused"])
    for mode, over in (("shared", MD17_SHARED_RUN), ("resid", MD17_SHARED_RUN),
                       ("retrace", MD17_RETRACE_RUN)):
        run_m, cfg_m = get_workload("md17_kernel", aug_mode=mode, **over)
        ran = slice_run(f"md17_kernel aug_mode={mode!r}", run_m, cfg_m, mode_counters[mode])
        # each kernel's launches on its own path: #10's from the shared run
        own = mode_counters[mode][:6 if mode == "shared" else 2]
        launches.update({c.__name__: ran[c.__name__] for c in own})

    entries = {}
    order = ("plain", *kernel_sides)
    sides = (*order, *order[::-1])
    for B in TRAIN_BATCHES:
        batch = {k: v[:B] for k, v in train.items()}
        runs = {k: [] for k in order}
        steps = 5 if B < 64 else 2
        for side in sides:
            br = branches[side]
            br["step"](br["state"], batch)  # warm up this side's shapes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                br["state"], _ = br["step"](br["state"], batch)
            torch.cuda.synchronize()
            runs[side].append((time.perf_counter() - t0) * 1e3 / steps)
        step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
        print(f"MD17 TIMING train step at B={B}: "
              + "; ".join(f"{k} {v:.2f} ms = {B * 1e3 / v:.1f} samples/s"
                          for k, v in step_ms.items())
              + f" (ms per step, runs {json.dumps(runs)}; {smi})", flush=True)

        # each branch's step in parts, and each kernel beside its plain version
        fma = {k: v * B * depth for k, v in layer_fma(N, F, F, 50, cfg.n_heads, 256).items()}
        plain_reps = 3 if B < 64 else 1
        t, ops, moved = {}, {}, {}
        br = branches["shared"]
        prm = br["params"]
        with torch.no_grad():
            leaves = wide_stack(prm, cfg.n_heads)
            leaves_t = transposed(leaves)
            h0 = embed(prm, species.to(dev).expand(B, N, -1)).contiguous()
            xs = batch["x"].permute(2, 0, 1).contiguous()
            zs = torch.zeros_like(xs)
            tx0, g_e = rnd(3, B, N), rnd(B)
            fwd = t2.shared_fwd(leaves, h0, xs, upd)
            _, dh_fin = resid_ef._readout_seed(prm, fwd.h_fin, None)
            tfwd = t2.resid_jvp(leaves, fwd, upd, tx0)
            _, dh_s, dth_s = t2.head_grads(prm, fwd.h_fin, tfwd.h_fin, g_e)
            tb = t2.resid_tbwd(leaves, fwd, tfwd, upd, dth_s, zs, zs, leaves_t=leaves_t)
            ba = t2.resid_bwd_aug(leaves, fwd, upd, dh_s, zs, zs, tb[3], leaves_t=leaves_t)
            grads = t2.param_grads_aug(leaves, fwd, tfwd, ba[3], tb[4], tb[5])
            t.update(
                shared_fwd=(cuda_ms(lambda: t2.shared_fwd(leaves, h0, xs, upd)),
                            cuda_ms(lambda: resid_ef.resid_fwd_plain(leaves, h0, xs, zs, upd),
                                    reps=plain_reps)),
                shared_bwd=(cuda_ms(lambda: t2.shared_bwd(leaves, fwd, upd, dh_fin,
                                                          leaves_t=leaves_t)),
                            cuda_ms(lambda: resid_ef.resid_bwd_plain(leaves, fwd, upd, dh_fin,
                                                                     zs, zs), reps=plain_reps)),
                resid_jvp=(cuda_ms(lambda: t2.resid_jvp(leaves, fwd, upd, tx0)),
                           cuda_ms(lambda: t2.resid_jvp_plain(leaves, fwd, upd, tx0),
                                   reps=plain_reps)),
                resid_tbwd=(cuda_ms(lambda: t2.resid_tbwd(leaves, fwd, tfwd, upd, dth_s, zs, zs,
                                                          leaves_t=leaves_t)),
                            cuda_ms(lambda: t2.resid_tbwd_plain(leaves, fwd, tfwd, upd, dth_s,
                                                                zs, zs), reps=plain_reps)),
                resid_bwd_aug=(cuda_ms(lambda: t2.resid_bwd_aug(leaves, fwd, upd, dh_s, zs, zs,
                                                                tb[3], leaves_t=leaves_t)),
                               cuda_ms(lambda: t2.resid_bwd_aug_plain(leaves, fwd, upd, dh_s, zs,
                                                                      zs, tb[3]),
                                       reps=plain_reps)),
                param_grads_aug=(cuda_ms(lambda: t2.param_grads_aug(leaves, fwd, tfwd, ba[3],
                                                                    tb[4], tb[5])),
                                 cuda_ms(lambda: t2.param_grads_aug_plain(
                                     leaves, fwd, tfwd, ba[3], tb[4], tb[5]), reps=plain_reps)),
            )
            t_seed = cuda_ms(lambda: resid_ef._readout_seed(prm, fwd.h_fin, None))
            t_head = cuda_ms(lambda: t2.head_grads(prm, fwd.h_fin, tfwd.h_fin, g_e))
            moved.update(
                shared_fwd=nbytes(leaves, h0, xs, fwd),
                shared_bwd=nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, dh_fin,
                                  xs),
                resid_jvp=nbytes(leaves, fwd.bh, fwd.bx, fwd.bv, fwd.resid, tx0, tfwd),
                resid_tbwd=nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, tfwd.bh,
                                  tfwd.bx, tfwd.bv, tfwd.resid, dth_s, tb),
                resid_bwd_aug=nbytes(leaves, leaves_t, fwd.bh, fwd.bx, fwd.bv, fwd.resid, dh_s,
                                     tb[3], ba),
                param_grads_aug=nbytes(leaves, fwd.bh, tfwd.bh, grads_streams(fwd.resid),
                                       grads_streams(tfwd.resid), ba[3], tb[4], tb[5], grads),
            )
            del fwd, tfwd, tb, ba, grads
        zero_grads = [torch.zeros_like(p) for p in tree_leaves(prm)]
        t_opt = cuda_ms(lambda: br["state"].apply_gradients(zero_grads))
        parts = dict(primal=t["shared_fwd"][0] + t_seed + t["shared_bwd"][0],
                     tangent_forward=t["resid_jvp"][0],
                     aug_pullback=t["resid_tbwd"][0] + t["resid_bwd_aug"][0],
                     contraction=t["param_grads_aug"][0], head=t_head, optimizer=t_opt)
        rest = step_ms["shared"] - sum(parts.values())
        print(f"MD17 BREAKDOWN shared-mode step at B={B}, {step_ms['shared']:.3f} ms: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f", rest {rest:.3f} ms ({len(zero_grads)} parameter tensors)", flush=True)

        br = branches["fused"]
        prm = br["params"]
        with torch.no_grad():
            leaves = wide_stack(prm, cfg.n_heads)
            leaves_t = transposed(leaves)
            fwd, e_k, dx_k = t2.fused_primal(prm, leaves, h0, xs, upd, leaves_t=leaves_t)
            blk = t2.fused_bwd_block(prm, leaves, fwd, upd, tx0, g_e, leaves_t=leaves_t)
            grads, ro = t2.fused_bwd_grads(prm, leaves, fwd, *blk[2:])

            def grads_plain():
                t2.param_grads_aug_plain(leaves, fwd, blk[2], *blk[3:6])
                blk[6].double().sum(dim=0)

            t.update(
                fused_primal=(cuda_ms(lambda: t2.fused_primal(prm, leaves, h0, xs, upd,
                                                              leaves_t=leaves_t)),
                              cuda_ms(lambda: t2.fused_primal_plain(prm, leaves, h0, xs, upd),
                                      reps=plain_reps)),
                fused_bwd_block=(cuda_ms(lambda: t2.fused_bwd_block(prm, leaves, fwd, upd, tx0,
                                                                    g_e, leaves_t=leaves_t)),
                                 cuda_ms(lambda: t2.fused_bwd_block_plain(prm, leaves, fwd, upd,
                                                                          tx0, g_e),
                                         reps=plain_reps)),
                fused_bwd_grads=(cuda_ms(lambda: t2.fused_bwd_grads(prm, leaves, fwd, *blk[2:])),
                                 cuda_ms(grads_plain, reps=plain_reps)),
            )
            t_e = cuda_ms(lambda: readout(prm, fwd.h_fin).sum(dim=(-2, -1)))
            moved.update(
                fused_primal=nbytes(leaves, leaves_t, h0, xs, fwd, e_k, dx_k),
                fused_bwd_block=nbytes(leaves, leaves_t, fwd, tx0, g_e, blk),
                fused_bwd_grads=nbytes(leaves, fwd.bh, blk[2].bh, grads_streams(fwd.resid),
                                       grads_streams(blk[2].resid), blk[3:], grads, ro),
            )
            del fwd, blk, grads
        zero_grads = [torch.zeros_like(p) for p in tree_leaves(prm)]
        t_opt = cuda_ms(lambda: br["state"].apply_gradients(zero_grads))
        parts = dict(fused_primal=t["fused_primal"][0], energy_readout=t_e,
                     fused_bwd_block=t["fused_bwd_block"][0],
                     contraction=t["fused_bwd_grads"][0], optimizer=t_opt)
        rest = step_ms["fused"] - sum(parts.values())
        print(f"MD17 BREAKDOWN fused-mode step at B={B}, {step_ms['fused']:.3f} ms: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f", rest {rest:.3f} ms ({len(zero_grads)} parameter tensors)", flush=True)
        # the resid and retrace modes: primal K1 + K2 (resid_energy_forces),
        # then per chunk of aug_chunk molecules #18 or #16, the head, #19 or #17
        aug_chunk = 128  # make_ef_train2's default, which the task uses
        Bc_ = min(B, aug_chunk)
        n_chunks = -(-B // aug_chunk)
        for mode in ("resid", "retrace"):
            br = branches[mode]
            prm = br["params"]
            with torch.no_grad():
                leaves = wide_stack(prm, cfg.n_heads)
                leaves_t = transposed(leaves)
                h_in = species.to(dev).expand(B, N, -1)
                fwd_fn, bwd_fn = ((t2.aug_fwd, t2.aug_bwd) if mode == "resid"
                                  else (t2.retrace_fwd, t2.retrace_bwd))
                fwd_plain, bwd_plain = ((t2.aug_fwd_plain, t2.resid_aug_bwd_plain)
                                        if mode == "resid"
                                        else (t2.retrace_fwd_plain, t2.retrace_bwd_plain))
                fname, bname = fwd_fn.__name__, bwd_fn.__name__
                af = fwd_fn(leaves, h0, xs, upd, tx0)
                _, dh_a, dth_a = t2.head_grads(prm, af[0].h_fin, af[1].h_fin, g_e)
                ab = bwd_fn(leaves, *af, upd, dh_a, dth_a, leaves_t=leaves_t)
                t[fname] = (cuda_ms(lambda: fwd_fn(leaves, h0, xs, upd, tx0)),
                            cuda_ms(lambda: fwd_plain(leaves, h0, xs, upd, tx0), reps=plain_reps))
                t[bname] = (cuda_ms(lambda: bwd_fn(leaves, *af, upd, dh_a, dth_a,
                                                   leaves_t=leaves_t)),
                            cuda_ms(lambda: bwd_plain(leaves, *af, upd, dh_a, dth_a),
                                    reps=plain_reps))
                moved[fname] = nbytes(leaves, h0, xs, tx0, af)
                moved[bname] = nbytes(leaves, leaves_t, [f[:3] for f in af], dh_a, dth_a, ab)
                if mode == "resid":
                    moved[bname] += nbytes([f.resid for f in af])
                # the step's parts at its own chunk size
                sl = slice(0, Bc_)
                h0c, xsc, txc, gec = h0[sl], xs[:, sl].contiguous(), tx0[:, sl].contiguous(), g_e[sl]
                afc = fwd_fn(leaves, h0c, xsc, upd, txc)
                _, dhc, dthc = t2.head_grads(prm, afc[0].h_fin, afc[1].h_fin, gec)
                parts = dict(
                    primal=cuda_ms(lambda: resid_ef.resid_energy_forces(prm, h_in, batch["x"],
                                                                        n_heads=cfg.n_heads)),
                    aug_forward=n_chunks * cuda_ms(lambda: fwd_fn(leaves, h0c, xsc, upd, txc)),
                    head=n_chunks * cuda_ms(lambda: t2.head_grads(prm, afc[0].h_fin,
                                                                  afc[1].h_fin, gec)),
                    aug_backward=n_chunks * cuda_ms(lambda: bwd_fn(leaves, *afc, upd, dhc, dthc,
                                                                   leaves_t=leaves_t)))
                del af, ab, afc
            zero_grads = [torch.zeros_like(p) for p in tree_leaves(prm)]
            parts["optimizer"] = cuda_ms(lambda: br["state"].apply_gradients(zero_grads))
            rest = step_ms[mode] - sum(parts.values())
            print(f"MD17 BREAKDOWN {mode}-mode step at B={B} ({n_chunks} chunk(s) of {Bc_}), "
                  f"{step_ms[mode]:.3f} ms: " + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
                  + f", rest {rest:.3f} ms ({len(zero_grads)} parameter tensors)", flush=True)
        print(f"MD17 TIMING per kernel (ms, kernel and plain) at B={B}, N={N}, depth {depth}: "
              + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in t.items()}),
              flush=True)
        ops.update(shared_fwd=fma["fwd"], shared_bwd=fma["bwd"], resid_jvp=fma["jvp"],
                   resid_tbwd=fma["tbwd"], resid_bwd_aug=fma["bwd"],
                   param_grads_aug=fma["grads_aug"], fused_primal=fma["fwd"] + fma["bwd"],
                   fused_bwd_block=fma["jvp"] + fma["tbwd"] + fma["bwd"],
                   fused_bwd_grads=fma["grads_aug"], aug_fwd=fma["fwd"] + fma["jvp"],
                   retrace_fwd=fma["fwd"] + fma["jvp"],
                   aug_bwd=fma["tbwd"] + fma["bwd"] + fma["grads_aug"],
                   retrace_bwd=fma["fwd"] + fma["jvp"] + fma["tbwd"] + fma["bwd"]
                   + fma["grads_aug"])
        tcf = {k: v * B * depth for k, v in tc_fma(N, F, 50, cfg.n_heads, 256).items()}
        tc = dict(fused_primal=tcf["fwd"] + tcf["bwd"],
                  fused_bwd_block=tcf["jvp"] + tcf["tbwd"] + tcf["bwd"])
        print(f"MD17 BOUNDS at B={B} (ms, by; #11 and #12 with their 3xTF32 products at "
              f"{TF32_PASSES} passes over {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s): " + json.dumps(
                  {k: [round(bound(ops[k], moved[k], tc=tc.get(k, 0))[0], 4),
                       bound(ops[k], moved[k], tc=tc.get(k, 0))[1]] for k in t}), flush=True)
        entries[B] = (t, ops, moved, tc)
        del h0, xs, zs

    # where the block time of #11 and #12 goes, at both batches (the probe build)
    mod = probe_module()
    plib = mod.load(PROBE_LIB)
    for B in TRAIN_BATCHES:
        mod.probe(branches["fused"]["params"], cfg, data, species, dev, B, plib, smi)

    t, ops, moved, tc = entries[max(TRAIN_BATCHES)]  # the entries carry B = 512
    src = "sake_tpu_torch/csrc/"
    at = "sake_tpu/kernels/train2_ef.py:"
    where = dict(shared_fwd=("resid_fwd.cu", "1030"), shared_bwd=("resid_bwd.cu", "1110"),
                 resid_jvp=("resid_jvp.cu", "1397"), resid_tbwd=("resid_tbwd.cu", "1507"),
                 resid_bwd_aug=("resid_bwd.cu", "1507"), param_grads_aug=("param_grads.cu", "1507"),
                 fused_primal=("fused_ef.cu", "1239"), fused_bwd_block=("fused_bwd.cu", "1750"),
                 fused_bwd_grads=("param_grads.cu", "1750"), aug_fwd=("aug_fwd.cu", "584"),
                 retrace_fwd=("aug_fwd.cu", "270"), retrace_bwd=("retrace_bwd.cu", "379"),
                 aug_bwd=("resid_tbwd.cu", "723"))
    errs = dict(abs_train, fused_bwd_block=abs_train["fused_bwd"],
                fused_bwd_grads=abs_train["fused_bwd"])
    return [kernel_entry(name, src + where[name][0], at + where[name][1], launches[name],
                         errs[name], *t[name], ops[name], moved[name], tc=tc.get(name, 0))
            for name in t]


def sparse_fma(F, R, H, Kh, C):
    """Multiply-adds per edge of the sparse edge chain's products, counted as
    ``layer_fma`` counts them (elementwise work left out): the forward (the
    j-projections, o_f, o1, the semantic heads, x-mixing), the pullback
    (which recomputes the forward) and the leaf-gradient contraction. The
    function needs f32 leaf gradients, so the contraction's multiply-adds
    count at the f32 peak, though the kernel sums them in f64. ``tc_fwd`` and
    ``tc_bwd``: of ``fwd`` and ``bwd``, those #13 and #14 run on the tensor
    cores in 3xTF32 (the x-mixing product, and in the pullback its transpose
    too), which their bounds count at TF32_PASSES passes over the TF32 peak;
    #15 runs ``bwd`` on values and tangents, so twice ``tc_bwd``."""
    HK = H * Kh
    fwd = F * R + F * H + R * H + H * H + H * Kh + HK * C
    pull = HK * C + Kh * H + H * H + H * R + R * F + H * F
    return dict(fwd=fwd, bwd=fwd + pull, grads=fwd, tc_fwd=HK * C, tc_bwd=2 * HK * C)


def check_pairs(label, checks: dict, tol: float) -> dict:
    """Print each check's worst relative error (per tensor, against the
    tensor's largest entry) and fail beyond ``tol`` or on a non-finite
    value; returns each check's max absolute error."""
    import torch

    out = {}
    for name, pairs in checks.items():
        errs = {n: rel_err(a, b) for n, a, b in pairs}
        out[name] = max(abs_err(a, b) for _, a, b in pairs)
        w = max(errs, key=errs.get)
        finite = all(bool(torch.isfinite(a).all()) for _, a, _ in pairs)
        print(f"{label} {name} vs plain: max rel err {errs[w]:.3e} ({w}), max abs err "
              f"{out[name]:.3e}, finite {finite} "
              + json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()}), flush=True)
        if errs[w] > tol or not finite:
            fail(f"{label} {name} beyond {tol}")
    return out


def _pair_codes(idx, m, N):
    """The live (receiver, sender) pairs of a (1, N, K) list as sorted codes."""
    import torch

    rows = torch.arange(N, device=idx.device)[None, :, None].expand_as(idx)
    return (rows * N + idx)[m > 0].sort().values


def _layer0_edge_inputs(kp, h, x, idx, m, n_heads, box=None):
    """Layer 0's edge-op inputs as the kernel model builds them."""
    from sake_tpu_torch.kernels import sparse_ef as se
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import split_layer

    F = kp.w_embed.shape[-1]
    L = split_layer(kp.layers[0], F, n_heads)
    ep = {n: L[n].detach().contiguous() for n in se.EDGE_LEAVES}
    hg, ai, oi, d0 = se.edge_inputs({k: v.detach() for k, v in L.items()},
                                    embed(kp, h).detach(), x, idx, box)
    NR, K = hg.shape[:2]
    return hg, ai, oi, d0, m.reshape(NR, K).float().contiguous(), ep


def sparse_md_phases(dev, smi) -> list:
    """Phases 11-13 (see the module docstring); returns their kernel entries."""
    import dataclasses

    import torch

    from sake_tpu_torch import sparse as sp
    from sake_tpu_torch.kernels import sparse_ef as se
    from sake_tpu_torch.tasks import sparse_md as task
    from sake_tpu_torch.tasks.registry import get_workload
    from sake_tpu_torch.train.metrics import MetricLogger

    run, cfg = get_workload("sparse_md_kernel")
    if not cfg.use_kernel:
        fail(f"sparse_md_kernel is not the kernel force field: {cfg}")
    h, x, _, box = task._synthesize_box(cfg, dev)
    kp = task.make_params(cfg, cfg.n_species, cfg.seed, dev)
    N, K, depth, heads = cfg.n_atoms, cfg.max_neighbors, cfg.depth, cfg.n_heads
    rc = cfg.cutoff + cfg.skin
    with torch.no_grad():
        idx, m, ovf = sp.neighbor_list(x, rc, K, with_overflow=True)
    live = m.sum(-1)
    print(f"SPARSE MD box: N={N}, side {(N / cfg.density) ** (1 / 3):.3f}, first list at "
          f"{rc}: live slots per atom mean {float(live.mean()):.2f} max {int(live.max())} of "
          f"K={K}, overflow {int(ovf.max())}", flush=True)

    # -- 11. #13 and #14 against plain on the first list (layer 0) ---------------
    gen = torch.Generator(dev).manual_seed(11)
    with torch.no_grad():
        hg, ai, oi, d0, mf, ep = _layer0_edge_inputs(kp, h, x, idx, m, heads)
        C, HK = ep["w_xmix"].shape[1], ep["w_xmix"].shape[0]
        gp = torch.randn(3, N, C, device=dev, generator=gen)
        gh = torch.randn(N, HK, device=dev, generator=gen)
        k13, p13 = se._launch_fwd(hg, ai, oi, d0, mf, ep), se.sparse_fwd_plain(hg, ai, oi, d0, mf,
                                                                               ep)
        wt = se.edge_transposes(ep)  # made once per layer, as the model does
        k14 = se._launch_bwd(hg, ai, oi, d0, mf, ep, gp, gh, wt)
        p14 = se.sparse_bwd_plain(hg, ai, oi, d0, mf, ep, gp, gh)
        r13 = se._launch_fwd(hg, ai, oi, d0, mf, ep, wt)
        r14 = se._launch_bwd(hg, ai, oi, d0, mf, ep, gp, gh, wt)
        torch.cuda.synchronize()
    abs_md = check_pairs(f"SPARSE MD (N={N}, K={K}, layer 0)", {
        "sparse_fwd": list(zip(("pooled", "hatt"), k13, p13)),
        "sparse_bwd": list(zip(("d_h_g", "d_a_i", "d_o_i", "d_d0"), k14, p14))}, SPARSE_TOL)
    same = all(torch.equal(a, b) for a, b in [*zip(k13, r13), *zip(k14, r14)])
    print(f"SPARSE MD (N={N}, K={K}) #13 and #14 launched twice: outputs bitwise equal {same}",
          flush=True)
    if not same:
        fail("#13 or #14 differ from run to run")
    del k13, p13, k14, p14, r13, r14
    ps = sparse_probe_module()
    for K_x, NR_x in SPARSE_EXTRA_K:
        try:
            err = ps.check_on_card(K_x, NR_x, dev)
        except AssertionError as e:
            fail(f"#13 / #14 at K={K_x}: {e}")
        print(f"SPARSE EXTRA K={K_x} (NR={NR_x}, seeded inputs) #13, #14, #14 with dW vs plain: "
              + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()})
              + f", two launches bitwise equal (limit {SPARSE_TOL})", flush=True)
    try:
        most, err = ps.check_slot_limit(dev)
    except AssertionError as e:
        fail(f"#13 / #14 at the route's limit of slots: {e}")
    print(f"SPARSE LIMIT K={most} (the most the route takes at these widths; seeded inputs) "
          "#13, #14, #14 with dW vs plain: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()})
          + f", two launches bitwise equal (limit {SPARSE_TOL}); K={most + 1} raises",
          flush=True)
    ps.probe((hg, ai, oi, d0, mf, ep, gp, gh), ps.load(SPARSE_PROBE_LIB),
             f"N={N} K={K} (sparse_md_kernel, layer 0)", smi)

    # the model's E + F: kernel against plain, per-atom energies (a random
    # box's total cancels) and forces
    ef_k = se.make_sparse_kernel_energy_forces(h, n_heads=heads, update=False)
    ef_p = sp.make_sparse_energy_forces(h, n_heads=heads, update=False, remat=True)
    with torch.no_grad():
        out_k = se.sparse_kernel_model_forward(kp, h, x, idx, m, n_heads=heads, update=False)[0]
        out_p = sp.sparse_model_forward(kp, h, x, idx, m, n_heads=heads, update=False)[0]
        _, f_k = ef_k(kp, x, idx, m)
        _, f_p = ef_p(kp, x, idx, m)
        torch.cuda.synchronize()
    ef_err = {"f_err": rel_err(f_k, f_p), "e_atom_err": rel_err(out_k, out_p)}
    print(f"SPARSE MD E+F (N={N}, K={K}, depth {depth}) kernel vs plain: "
          + json.dumps({k: float(f"{v:.3e}") for k, v in ef_err.items()})
          + f"; |F|max {float(f_p.abs().max()):.4g}, |e_atom|max {float(out_p.abs().max()):.4g}",
          flush=True)
    if not (ef_err["f_err"] <= F_TOL and ef_err["e_atom_err"] <= E_TOL
            and torch.isfinite(f_k).all()):
        fail(f"sparse E+F beyond f_err {F_TOL} / per-atom e_err {E_TOL}")
    del out_k, out_p, f_k, f_p

    # -- 12. a periodic box: the cell list and the minimum image on the card -----
    cfg_p = dataclasses.replace(cfg, periodic=True, cell_capacity=SPARSE_CELL_CAPACITY,
                                n_steps=SPARSE_PERIODIC_STEPS)
    _, xp, _, boxp = task._synthesize_box(cfg_p, dev)
    with torch.no_grad():
        i_c, m_c, o_c = sp.cell_neighbor_list(xp, rc, K, box=boxp,
                                              cell_capacity=cfg_p.cell_capacity,
                                              with_overflow=True)
        i_a, m_a, o_a = sp.neighbor_list(xp, rc, K, box=boxp, with_overflow=True)
        same = torch.equal(_pair_codes(i_c, m_c, N), _pair_codes(i_a, m_a, N))
    print(f"SPARSE MD periodic box {boxp[0]:.4f}: cell list (capacity {cfg_p.cell_capacity}) "
          f"== all-pairs list {same}, overflow {int(o_c.max())} / {int(o_a.max())}", flush=True)
    if not same or int(o_c.max()) != 0:
        fail("the periodic cell list differs from the all-pairs list or overflowed")
    _, res_p = run(cfg_p, MetricLogger(stream=sys.stdout), device=dev)
    print("SPARSE MD periodic run " + json.dumps(res_p), flush=True)
    if not res_p["finite"] or res_p["max_nbr_overflow"] != 0:
        fail("the periodic sparse MD run is not finite or overflowed")

    # -- 13. the slice: sparse_md_kernel at its defaults --------------------------
    counters = (se.sparse_fwd, se.sparse_bwd, se.sparse_bwd_grads, se.sparse_bwd2)
    others = dense_counters()
    before = [c.launches for c in others]
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (xs, _, es), res = run(cfg, MetricLogger(stream=sys.stdout), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    print(f"SPARSE MD SLICE sparse_md_kernel ({N} atoms, {cfg.n_steps} steps, twice): launches "
          f"{json.dumps(launches)}; {wall:.2f} s; results " + json.dumps(res)
          + f"; energies {json.dumps([float(e) for e in es])} ({smi})", flush=True)
    if not (launches["sparse_fwd"] and launches["sparse_bwd"]) or (
            launches["sparse_bwd_grads"] or launches["sparse_bwd2"]) or (
            [c.launches for c in others] != before):
        fail("the sparse MD path did not launch exactly #13 and #14, and no dense kernel")
    if not (res["finite"] and res["max_nbr_overflow"] == 0 and np.isfinite(es).all()):
        fail("the sparse MD rollout is not finite or overflowed")

    # timing: one E + F, kernel and plain in turns; each kernel; the neighbour build
    runs = {"plain": [], "kernel": []}
    for side in ("plain", "kernel", "kernel", "plain"):
        fn = ef_k if side == "kernel" else ef_p
        with torch.no_grad():
            runs[side].append(cuda_ms(lambda: fn(kp, x, idx, m), reps=2))
    ef_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    with torch.no_grad():
        t13 = cuda_ms(lambda: se._launch_fwd(hg, ai, oi, d0, mf, ep, wt))
        t14 = cuda_ms(lambda: se._launch_bwd(hg, ai, oi, d0, mf, ep, gp, gh, wt))
        p13t = cuda_ms(lambda: se.sparse_fwd_plain(hg, ai, oi, d0, mf, ep), reps=1)
        p14t = cuda_ms(lambda: se.sparse_bwd_plain(hg, ai, oi, d0, mf, ep, gp, gh), reps=1)
        t_nb = cuda_ms(lambda: sp.neighbor_list(x, rc, K, with_overflow=True))
    print(f"SPARSE MD TIMING E+F at N={N}: kernel {ef_ms['kernel']:.3f} ms = "
          f"{N * 1e3 / ef_ms['kernel']:.1f} atom-E+F/s, plain {ef_ms['plain']:.3f} ms = "
          f"{N * 1e3 / ef_ms['plain']:.1f} atom-E+F/s (runs {json.dumps(runs)}); rollout "
          f"{res['steps_per_s']} steps/s = {res['atom_steps_per_s']} atom-steps/s; per kernel "
          f"#13 {t13:.3f} ms (plain {p13t:.3f}), #14 {t14:.3f} ms (plain {p14t:.3f}) ({smi})",
          flush=True)
    step_ms = 1e3 / res["steps_per_s"]
    edge = depth * (t13 + t14)
    nb = t_nb / cfg.rebuild_every
    print(f"SPARSE MD BREAKDOWN rollout step {step_ms:.3f} ms: edge kernels {depth}x("
          f"{t13:.3f}+{t14:.3f}) = {edge:.3f} ms, neighbour build {t_nb:.3f} ms / "
          f"{cfg.rebuild_every} steps = {nb:.3f} ms, torch glue (node update, gathers and "
          f"scatter, integrator) {step_ms - edge - nb:.3f} ms", flush=True)
    fma = sparse_fma(hg.shape[-1], ai.shape[-1], oi.shape[-1], ep["w_sem"].shape[-1], C)
    E = N * K
    src = "sake_tpu_torch/csrc/"
    at = "sake_tpu/kernels/sparse_ef.py:"
    entries = [
        kernel_entry("sparse_fwd", src + "sparse_fwd.cu", at + "353", launches["sparse_fwd"],
                     abs_md["sparse_fwd"], t13, p13t, fma["fwd"] * E,
                     nbytes(hg, ai, oi, d0, mf, ep) + 4 * N * (3 * C + HK), tc=fma["tc_fwd"] * E),
        kernel_entry("sparse_bwd", src + "sparse_bwd.cu", at + "401", launches["sparse_bwd"],
                     abs_md["sparse_bwd"], t14, p14t, fma["bwd"] * E,
                     nbytes(hg, ai, oi, d0, mf, ep, gp, gh) + nbytes(hg, ai, oi, d0),
                     tc=fma["tc_bwd"] * E),
    ]
    print(f"SPARSE MD BOUNDS (N={N}, K={K}; the x-mixing products at {TF32_PASSES} passes over "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, the rest at {PEAK_F32_FLOPS / 1e12:.0f}): "
          + json.dumps({e["name"]: [round(e["bound_ms"], 4), e["bound_by"]] for e in entries}),
          flush=True)
    return entries


def sparse_train_phases(dev, smi) -> list:
    """Phases 14-16 (see the module docstring); returns their kernel entries."""
    import dataclasses

    import torch

    from sake_tpu_torch import sparse as sp
    from sake_tpu_torch.kernels import sparse_ef as se
    from sake_tpu_torch.kernels.functional import flat_params
    from sake_tpu_torch.tasks import sparse_train as task
    from sake_tpu_torch.tasks.registry import get_workload
    from sake_tpu_torch.train.metrics import MetricLogger

    run, cfg = get_workload("sparse_train_kernel")
    if not cfg.use_kernel:
        fail(f"sparse_train_kernel is not the kernel branch: {cfg}")
    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    N, K, heads = cfg.n_atoms, cfg.max_neighbors, cfg.n_heads
    h, x = task.synthesize(cfg, dev)
    with torch.no_grad():
        idx, m = sp.neighbor_list(x, cfg.cutoff, K)
    kp_k, loss_k = task.setup(cfg, dev)
    kp_p, loss_p = task.setup(plain_cfg, dev)

    # -- 14. #13, #14 with the leaf gradients and #15 against plain (layer 0) ----
    gen = torch.Generator(dev).manual_seed(14)
    with torch.no_grad():
        hg, ai, oi, d0, mf, ep = _layer0_edge_inputs(kp_k, h, x, idx, m, heads)
        C, HK = ep["w_xmix"].shape[1], ep["w_xmix"].shape[0]
        rnd = lambda *s: torch.randn(*s, device=dev, generator=gen)
        gp, gh = rnd(3, N, C), rnd(N, HK)
        cg = (rnd(*hg.shape), rnd(*ai.shape), rnd(*oi.shape), rnd(*d0.shape))
        k13 = se._launch_fwd(hg, ai, oi, d0, mf, ep)
        p13 = se.sparse_fwd_plain(hg, ai, oi, d0, mf, ep)
        wt = se.edge_transposes(ep)
        kg = se._launch_bwd_grads(hg, ai, oi, d0, mf, ep, gp, gh, wt)
        pg = se.sparse_bwd_plain(hg, ai, oi, d0, mf, ep, gp, gh, True)
        torch.cuda.synchronize()
    grad_names = ("d_h_g", "d_a_i", "d_o_i", "d_d0")
    checks = {"sparse_fwd_train": list(zip(("pooled", "hatt"), k13, p13)),
              "sparse_bwd_grads": [*zip(grad_names, kg[:4], pg[:4]),
                                   *((f"dW.{n}", kg[4][n], pg[4][n]) for n in se.EDGE_LEAVES)]}
    del k13, p13, kg, pg
    k15 = se._launch_bwd2(hg, ai, oi, d0, mf, ep, gp, gh, *cg, wt)
    r15 = se._launch_bwd2(hg, ai, oi, d0, mf, ep, gp, gh, *cg, wt)
    p15 = se.sparse_bwd2_plain(hg, ai, oi, d0, mf, ep, gp, gh, *cg)
    torch.cuda.synchronize()
    flat15 = lambda r: [*r[:6], *(r[6][n] for n in se.EDGE_LEAVES)]
    same = all(torch.equal(a, b) for a, b in zip(flat15(k15), flat15(r15)))
    print(f"SPARSE TRAIN (N={N}, K={K}) #15 launched twice: outputs bitwise equal {same}",
          flush=True)
    if not same:
        fail("#15 differs from run to run")
    checks["sparse_bwd2"] = [
        *zip(("e_hg", "e_ai", "e_oi", "e_d0", "e_gp", "e_gh"), k15[:6], p15[:6]),
        *((f"dW2.{n}", k15[6][n], p15[6][n]) for n in se.EDGE_LEAVES)]
    abs_tr = check_pairs(f"SPARSE TRAIN (N={N}, K={K}, layer 0)", checks, SPARSE_TOL)
    del k15, r15, p15, checks
    ps = sparse_probe_module()
    for K_x, NR_x in ps.BWD2_CASES:
        try:
            err = ps.check_bwd2_on_card(K_x, NR_x, dev)
        except AssertionError as e:
            fail(f"#15 at K={K_x}: {e}")
        print(f"SPARSE TRAIN EXTRA K={K_x} (NR={NR_x}, seeded inputs) #15 vs plain: max rel err "
              f"{err:.3e}, two launches bitwise equal (limit {SPARSE_TOL})", flush=True)
    try:
        most, err = ps.check_bwd2_slot_limit(dev)
    except AssertionError as e:
        fail(f"#15 at its limit of slots: {e}")
    print(f"SPARSE TRAIN LIMIT K={most} (the most #15 takes at these widths; seeded inputs) "
          f"#15 vs plain: max rel err {err:.3e}, two launches bitwise equal (limit "
          f"{SPARSE_TOL}); K={most + 1} raises", flush=True)
    ps.probe((hg, ai, oi, d0, mf, ep, gp, gh), ps.load(SPARSE_PROBE_LIB),
             f"N={N} K={K} (sparse_train_kernel, layer 0)", smi, bwd2=True)

    # -- 15. step parity against the plain (double autograd) branch ---------------
    def loss_and_grads(kp, loss):
        leaves = flat_params(kp)
        lval = loss(kp)
        g = torch.autograd.grad(lval, leaves, allow_unused=True)
        return lval.detach(), [torch.zeros_like(p) if a is None else a for p, a in zip(leaves, g)]

    lk, gk = loss_and_grads(kp_k, loss_k)
    lp, gp_ = loss_and_grads(kp_p, loss_p)
    grad_err = [rel_err(a, b) for a, b in zip(gk, gp_)]
    loss_err = abs(float(lk - lp)) / abs(float(lp))
    print(f"SPARSE TRAIN STEP 1 kernel vs plain branch (N={N}, K={K}): loss {float(lk):.7f} vs "
          f"{float(lp):.7f} (rel {loss_err:.2e}); gradients of {len(gk)} leaves, max rel err "
          f"{max(grad_err):.3e} (leaf {int(np.argmax(grad_err))}) "
          + json.dumps([float(f"{e:.2e}") for e in grad_err]), flush=True)
    if loss_err > SPARSE_TOL or max(grad_err) > SPARSE_TOL:
        fail(f"sparse training step 1 beyond {SPARSE_TOL}")
    # the energy loss (#14 with the leaf gradients) per leaf
    e_t = torch.zeros(1, device=dev)
    le = se.make_sparse_kernel_energy_loss(h, n_heads=heads)

    def plain_energy_loss(p):
        out = sp.sparse_model_forward(p, h, x, idx, m, n_heads=heads, update=False)[0]
        return (out.sum(dim=(-2, -1)) - e_t).abs().mean()

    _, gek = loss_and_grads(kp_k, lambda p: le(p, x, idx, m, e_t))
    _, gep = loss_and_grads(kp_p, plain_energy_loss)
    e_grad_err = [rel_err(a, b) for a, b in zip(gek, gep)]
    print(f"SPARSE TRAIN energy-loss gradients kernel vs plain: max rel err "
          f"{max(e_grad_err):.3e} (leaf {int(np.argmax(e_grad_err))})", flush=True)
    if max(e_grad_err) > SPARSE_TOL:
        fail(f"sparse energy-loss gradients beyond {SPARSE_TOL}")
    steps = {"kernel": task.make_step(cfg, kp_k, loss_k),
             "plain": task.make_step(plain_cfg, kp_p, loss_p)}
    traj = {k: [float(s()) for _ in range(PARITY_STEPS)] for k, s in steps.items()}
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj["kernel"], traj["plain"]))
    print(f"SPARSE TRAIN STEPS 1-{PARITY_STEPS} losses kernel {json.dumps(traj['kernel'])} plain "
          f"{json.dumps(traj['plain'])}: max rel diff {traj_err:.2e}", flush=True)
    if traj_err > LOSS_TOL:
        fail(f"sparse training losses differ beyond {LOSS_TOL}")

    # -- 16. the slice: sparse_train_kernel for its 100 steps ---------------------
    counters = (se.sparse_fwd, se.sparse_bwd, se.sparse_bwd_grads, se.sparse_bwd2)
    others = dense_counters()
    before = [c.launches for c in others]
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res = run(cfg, MetricLogger(stream=sys.stdout), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    print(f"SPARSE TRAIN SLICE sparse_train_kernel ({N} atoms, {cfg.n_steps} steps): launches "
          f"{json.dumps(launches)}; {wall:.2f} s; result " + json.dumps(res) + f" ({smi})",
          flush=True)
    if min(launches.values()) == 0 or [c.launches for c in others] != before:
        fail("the sparse training path did not launch exactly #13, #14 and #15, and no dense "
             "kernel")
    if not (res["finite"] and res["loss_decreased"]):
        fail("the sparse training loss is not finite or did not fall")

    # timing: the train step, kernel and plain branches in turns
    runs = {"plain": [], "kernel": []}
    for side in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            steps[side]()
        torch.cuda.synchronize()
        runs[side].append((time.perf_counter() - t0) * 1e3 / 2)
    step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    with torch.no_grad():
        t = dict(
            sparse_fwd_train=(cuda_ms(lambda: se._launch_fwd(hg, ai, oi, d0, mf, ep, wt)),
                              cuda_ms(lambda: se.sparse_fwd_plain(hg, ai, oi, d0, mf, ep),
                                      reps=1)),
            sparse_bwd_train=(cuda_ms(lambda: se._launch_bwd(hg, ai, oi, d0, mf, ep, gp, gh,
                                                             wt)),
                              cuda_ms(lambda: se.sparse_bwd_plain(hg, ai, oi, d0, mf, ep, gp,
                                                                  gh), reps=1)),
            sparse_bwd_grads=(cuda_ms(lambda: se._launch_bwd_grads(hg, ai, oi, d0, mf, ep, gp,
                                                                   gh, wt)),
                              cuda_ms(lambda: se.sparse_bwd_plain(hg, ai, oi, d0, mf, ep, gp,
                                                                  gh, True), reps=1)),
            sparse_bwd2=(cuda_ms(lambda: se._launch_bwd2(hg, ai, oi, d0, mf, ep, gp, gh, *cg,
                                                         wt)),
                         cuda_ms(lambda: se.sparse_bwd2_plain(hg, ai, oi, d0, mf, ep, gp, gh,
                                                              *cg), reps=1)),
        )
    depth = cfg.depth
    edge = depth * (t["sparse_fwd_train"][0] + t["sparse_bwd_train"][0]
                    + t["sparse_bwd_grads"][0] + t["sparse_bwd2"][0])
    print(f"SPARSE TRAIN TIMING train step at N={N}: kernel {step_ms['kernel']:.2f} ms, plain "
          f"{step_ms['plain']:.2f} ms (runs {json.dumps(runs)}); per kernel (ms, kernel and "
          f"plain) " + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in t.items()})
          + f" ({smi})", flush=True)
    with torch.no_grad():
        e15 = cuda_ms(lambda: ps.bwd2_edge(hg, ai, oi, d0, mf, ep, gp, gh, cg, wt))
    k_c = contraction_library(dev, smi)
    c14, c15 = k_c["#14 with dW"], k_c["#15"]
    print(f"SPARSE TRAIN BREAKDOWN kernel step {step_ms['kernel']:.3f} ms: edge kernels "
          f"{depth}x(#13 {t['sparse_fwd_train'][0]:.3f} + #14 {t['sparse_bwd_train'][0]:.3f} + #14 "
          f"with dW {t['sparse_bwd_grads'][0]:.3f} (rows kernel "
          f"{t['sparse_bwd_grads'][0] - c14:.3f} + contraction {c14:.3f}) + #15 "
          f"{t['sparse_bwd2'][0]:.3f} (edge kernel {t['sparse_bwd2'][0] - c15:.3f}, alone "
          f"{e15:.3f}, + contraction {c15:.3f})) = {edge:.3f} ms, the rest (torch glue: node "
          f"products, gathers and scatters, double autograd, adam) "
          f"{step_ms['kernel'] - edge:.3f} ms; the contractions "
          f"alone timed on rows of the same shapes", flush=True)
    fma = sparse_fma(hg.shape[-1], ai.shape[-1], oi.shape[-1], ep["w_sem"].shape[-1], C)
    E = N * K
    ins = nbytes(hg, ai, oi, d0, mf, ep)
    src = "sake_tpu_torch/csrc/"
    at = "sake_tpu/kernels/sparse_ef.py:"
    return [
        kernel_entry("sparse_fwd_train", src + "sparse_fwd.cu", at + "353",
                     launches["sparse_fwd"], abs_tr["sparse_fwd_train"],
                     *t["sparse_fwd_train"], fma["fwd"] * E, ins + 4 * N * (3 * C + HK),
                     tc=fma["tc_fwd"] * E),
        kernel_entry("sparse_bwd_grads", src + "sparse_bwd.cu", at + "401",
                     launches["sparse_bwd_grads"], abs_tr["sparse_bwd_grads"],
                     *t["sparse_bwd_grads"], (fma["bwd"] + fma["grads"]) * E,
                     ins + nbytes(gp, gh) + nbytes(hg, ai, oi, d0, ep), tc=fma["tc_bwd"] * E),
        kernel_entry("sparse_bwd2", src + "sparse_bwd2.cu", at + "501",
                     launches["sparse_bwd2"], abs_tr["sparse_bwd2"], *t["sparse_bwd2"],
                     2 * (fma["bwd"] + fma["grads"]) * E,
                     ins + nbytes(gp, gh, cg) + nbytes(hg, ai, oi, d0, gp, gh, ep),
                     tc=2 * fma["tc_bwd"] * E),
    ]


def contraction_library(dev, smi) -> dict:
    """The contraction kernels on the f64 tensor cores (CONTRACT and LIBRARY
    lines): first ``tools/probe_contract.check_contractions`` (both against
    their plain versions, each sparse leaf within 1e-6 of the f64
    ``contract_plain``, two launches of each bitwise equal); then each kernel
    alone beside its yardsticks (``probe_contract.library``: ``torch.matmul``
    over materialised operands, the whole function as one product per term in
    f64, their times summed, and its w_xmix term in f64 and f32, TF32 off):
    ``csrc/sparse_contract.cu`` on layer 0's rows of the sparse training box
    under #14's and #15's terms, ``csrc/param_grads.cu`` over six layers at
    QM9's B = 64, N = 29 (#5) and, augmented, MD17's B = 4 and 512, N = 21
    (#12). Returns the sparse kernel's ms under #14's and #15's terms."""
    pc = contract_probe_module()
    try:
        err = pc.check_contractions(dev)
    except AssertionError as e:
        fail(f"contraction check: {e}")
    print("CONTRACT both contractions against plain (sparse: per leaf against the f64 plain "
          "version, limit 1e-6; dense: per leaf, 1e-4), two launches bitwise equal: max rel err "
          + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()}) + f" ({smi})", flush=True)
    lib = {}
    for label in LIBRARY_CASES:  # one case's inputs at a time
        lib.update(pc.library(pc.cases(dev, (label,)), smi))
    kernel = lambda prefix: next(v["kernel"] for k, v in lib.items() if k.startswith(prefix))
    return {"#14 with dW": kernel(LIBRARY_CASES[0]), "#15": kernel(LIBRARY_CASES[1])}


def remat_phases(dev, smi) -> list:
    """Phases 17-20 (see the module docstring); returns their kernel entries."""
    import math

    import torch

    from sake_tpu_torch import md
    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.kernels import depthgrid_ef, dispatch, fori_ef, resid_ef
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.functional import embed, energy_and_forces_fn, flat_params
    from sake_tpu_torch.kernels.leaves import transposed, wide_stack
    from sake_tpu_torch.kernels.train_ef import make_trainable_energy_forces
    from sake_tpu_torch.models import SAKEModel
    from sake_tpu_torch.tasks.md17 import MD17Config, make_model, make_step_fn, species_onehot
    from sake_tpu_torch.train import TrainState, make_optimizer, tree_leaves
    from sake_tpu_torch.utils import coloring

    data = synthesize_md17(n_samples=max(REMAT_REQUESTS), seed=SEED)
    species = species_onehot(data.z, int(data.z.max())).to(dev)
    cfg = MD17Config(hidden_features=FULL["hidden"], depth=FULL["depth"], n_heads=FULL["heads"])
    model = make_model(cfg, species.shape[-1], device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    model.requires_grad_(False)
    params = model.functional_params()
    leaves = wide_stack(params, cfg.n_heads)
    leaves_t = transposed(leaves)
    N, F, depth = len(data.z), cfg.hidden_features, cfg.depth
    xs_all = torch.as_tensor(data.x, device=dev)
    h_of = lambda B: species.expand(B, N, -1)
    u6 = [1.0] * depth
    counters = (fori_ef.fori_fwd, fori_ef.fori_bwd, depthgrid_ef.depthgrid_fwd,
                depthgrid_ef.depthgrid_bwd)
    k12 = (resid_ef.resid_fwd, resid_ef.resid_bwd)
    def reset_counts():
        for c in (*counters, *k12):
            c.launches = 0
        for c in counters:  # #21-#24, each counted by route
            c.routes = dict.fromkeys(fori_ef.ROUTES, 0)

    def check_routes(label, route, which=counters):
        """Fail unless every launch of ``which`` (#21-#24) since the last reset
        took ``route``, the one the shape selects."""
        got = {c.__name__: dict(c.routes) for c in which}
        print(f"REMAT ROUTES {label}: {json.dumps(got)}", flush=True)
        if any(n for c in got.values() for r, n in c.items() if r != route) or \
                not all(c[route] for c in got.values()):
            fail(f"#21-#24 {label}: launches off the {route} route: {got}")

    # -- 17. #21-#24 against their plain versions at full width, then narrow ------
    Bc = TRAIN_CHECK_B
    with torch.no_grad():
        h0 = embed(params, h_of(Bc)).contiguous()
        xs = xs_all[:Bc].permute(2, 0, 1).contiguous()
        dh = torch.randn(Bc, N, F, device=dev, generator=torch.Generator(dev).manual_seed(7))
    abs_remat = {}
    reset_counts()
    report_checks(remat_checks(leaves, h0, xs, u6, dh), abs_remat,
                  f"vs plain (B={Bc}, N={N}, depth {depth})", prefix="REMAT")
    check_routes(f"at aspirin B={Bc}", "tensor cores")
    with torch.no_grad():  # #21 is K1's tensor-core body without the residual stores
        k21 = fori_ef.fori_fwd(leaves, h0, xs, u6)
        k1 = resid_ef._launch_fwd(leaves, h0, xs, torch.zeros_like(xs), u6, None, "tensor cores")
        same = {n: torch.equal(a, b) for n, a, b in zip(("bh", "bx", "bv", "h_fin"), k21, k1)}
        torch.cuda.synchronize()
    print(f"REMAT #21 on the tensor cores against K1's tensor-core kernel at B={Bc}, bit for "
          f"bit: {json.dumps(same)}", flush=True)
    del h0, xs, dh, k21, k1
    # aspirin's widths with one atom more (a copy of atom 0, 1.2 further along each
    # axis): K1's rule sends #21 and #23 to their CUDA-core kernel, two tensor-core
    # blocks no longer fitting an SM; #22 and #24 stay on the tensor cores
    B22 = min(37, Bc)
    with torch.no_grad():
        sp = h_of(B22)
        h22 = embed(params, torch.cat([sp, sp[:, :1]], 1)).contiguous()
        x22 = torch.cat([xs_all[:B22], xs_all[:B22, :1] + 1.2], 1).permute(2, 0, 1).contiguous()
        dh22 = torch.randn(B22, N + 1, F, device=dev,
                           generator=torch.Generator(dev).manual_seed(22))
    reset_counts()
    report_checks(remat_checks(leaves, h22, x22, u6, dh22), {},
                  f"at aspirin's widths with N={N + 1} (B={B22}, depth {depth})", prefix="REMAT")
    check_routes(f"of #21 and #23 at N={N + 1}", "CUDA cores", counters[::2])
    check_routes(f"of #22 and #24 at N={N + 1}", "tensor cores", counters[1::2])
    del h22, x22, dh22
    for hid in (8, 16):  # 50 rbf channels against H*K = 32 and 64
        m = SAKEModel(hid, 1, 2, in_features=5, device=dev,
                      generator=torch.Generator().manual_seed(hid))
        lv = wide_stack(model_params_from_linen(linen_tree(m), device=dev), 4)
        gen = torch.Generator(dev).manual_seed(hid)
        rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
        reset_counts()
        report_checks(remat_checks(lv, rnd(4, 7, hid), 1.5 * rnd(3, 4, 7), [1.0, 0.4],
                                   rnd(4, 7, hid)), {}, f"at hidden {hid} (B=4, N=7, depth 2)",
                      prefix="REMAT")
        check_routes(f"at hidden {hid}", "CUDA cores")
    with torch.no_grad():  # the re-forward's residuals, which feel the x-mixing
        pf = probe_module()
        h0 = embed(params, h_of(Bc)).contiguous()
        xs = xs_all[:Bc].permute(2, 0, 1).contiguous()
        bnd = fori_ef.fori_fwd_plain(leaves, h0, xs, u6)
        err = pf.resid_err(leaves, bnd, u6, resid_ef._readout_seed(params, bnd.h_fin, None)[1])
        torch.cuda.synchronize()
    print(f"REMAT RESIDUALS the re-forward's residual scratch of layer {depth - 1} at aspirin "
          f"B={Bc} vs layer_fwd_resid: max rel err {err:.3e} (limit {pf.REMAT_RESID_TOL:.0e})",
          flush=True)
    if not err <= pf.REMAT_RESID_TOL:
        fail("#22's re-forward residuals beyond their limit")
    del h0, xs, bnd

    # -- 18. the E + F slice through fori_energy_forces and depthgrid_energy_forces
    paths = {"fori": fori_ef.fori_energy_forces,
             "depthgrid": depthgrid_ef.depthgrid_energy_forces}

    def plain_ef(x, chunk=CHECK_CHUNK):
        return chunked_plain_ef(params, species, x, cfg.n_heads, chunk)

    reset_counts()
    answers = {(name, B): fn(params, h_of(B), xs_all[:B], n_heads=cfg.n_heads)
               for name, fn in paths.items() for B in REMAT_REQUESTS}
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in (*counters, *k12)}
    print(f"REMAT SLICE launches {json.dumps(launches)}", flush=True)
    if min(c.launches for c in counters) == 0 or any(c.launches for c in k12):
        fail("the fori / depthgrid path did not launch #21-#24, or launched K1 or K2")
    check_routes("of the E + F slice", "tensor cores")
    refs = {B: plain_ef(xs_all[:B]) for B in REMAT_REQUESTS}
    worst = {"f_err": 0.0, "e_err": 0.0}
    for (name, B), (e, f) in answers.items():
        if e.shape != (B,) or f.shape != (B, N, 3):
            fail(f"{name} B={B}: shapes {tuple(e.shape)} {tuple(f.shape)}")
        if not (torch.isfinite(e).all() and torch.isfinite(f).all()):
            fail(f"{name} B={B}: non-finite output")
        err = {"f_err": rel_err(f, refs[B][1]), "e_err": rel_err(e, refs[B][0])}
        worst = {k: max(worst[k], v) for k, v in err.items()}
        print(f"REMAT SLICE {name} B={B}: f_err {err['f_err']:.3e} e_err {err['e_err']:.3e}",
              flush=True)
    if not (worst["f_err"] <= F_TOL and worst["e_err"] <= E_TOL):
        fail(f"fori / depthgrid slice beyond f_err {F_TOL} / e_err {E_TOL}: {worst}")
    del answers, refs

    # timing at B = 2048 in turns: fori, depthgrid, K1 + K2 and the plain path
    # (chunks of 512), and each path's peak device memory
    Bt = max(REMAT_REQUESTS)
    hb, xb = h_of(Bt), xs_all[:Bt]
    timed = {**paths, "resid": resid_ef.resid_energy_forces,
             "plain": lambda p, h, x, n_heads: plain_ef(x, PATH_CHUNK)}
    runs, peak = {k: [] for k in timed}, {}
    for side in ("plain", "fori", "depthgrid", "resid", "resid", "depthgrid", "fori", "plain"):
        runs[side].append(cuda_ms(lambda: timed[side](params, hb, xb, n_heads=cfg.n_heads)))
    for side, fn in timed.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():  # the plain path enables autograd for its forces itself
            out = fn(params, hb, xb, n_heads=cfg.n_heads)
        torch.cuda.synchronize()
        peak[side] = torch.cuda.max_memory_allocated() - base
        del out
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"REMAT TIMING B={Bt}: " + "; ".join(
        f"{k} {v:.2f} ms = {Bt * 1e3 / v:.1f} evals/s, peak memory {peak[k] / 2**20:.1f} MiB"
        for k, v in ms.items()) + f" (runs {json.dumps(runs)}; {smi})", flush=True)

    # each kernel at the path's shapes (chunk 512)
    Bk = PATH_CHUNK
    with torch.no_grad():
        hc = embed(params, h_of(Bk)).contiguous()
        xc = xs_all[:Bk].permute(2, 0, 1).contiguous()
        reset_counts()
        bnd = fori_ef.fori_fwd(leaves, hc, xc, u6)
        k23 = depthgrid_ef.depthgrid_fwd(leaves, hc, xc, u6)
        pf = fori_ef.fori_fwd_plain(leaves, hc, xc, u6)
        pg = depthgrid_ef.depthgrid_fwd_plain(leaves, hc, xc, u6)
        torch.cuda.synchronize()
    fn = ("bh", "bx", "bv", "h_fin")
    report_checks({"fori_fwd": [*zip(fn, bnd, pf)], "depthgrid_fwd": [*zip(fn, k23, pg)]}, {},
                  f"vs plain at the path's chunk (B={Bk}, N={N}, depth {depth})", prefix="REMAT")
    check_routes(f"of #21 and #23 at B={Bk}", "tensor cores", counters[::2])
    del k23, pf, pg
    with torch.no_grad():
        _, dhc = resid_ef._readout_seed(params, bnd.h_fin, None)
        t = dict(
            fori_fwd=(cuda_ms(lambda: fori_ef.fori_fwd(leaves, hc, xc, u6)),
                      cuda_ms(lambda: fori_ef.fori_fwd_plain(leaves, hc, xc, u6), reps=1)),
            fori_bwd=(cuda_ms(lambda: fori_ef.fori_bwd(leaves, bnd, u6, dhc, leaves_t=leaves_t)),
                      cuda_ms(lambda: fori_ef.fori_bwd_plain(leaves, bnd, u6, dhc), reps=1)),
            depthgrid_fwd=(cuda_ms(lambda: depthgrid_ef.depthgrid_fwd(leaves, hc, xc, u6)),
                           cuda_ms(lambda: depthgrid_ef.depthgrid_fwd_plain(leaves, hc, xc, u6),
                                   reps=1)),
            depthgrid_bwd=(cuda_ms(lambda: depthgrid_ef.depthgrid_bwd(leaves, bnd, u6, dhc,
                                                                      leaves_t=leaves_t)),
                           cuda_ms(lambda: depthgrid_ef.depthgrid_bwd_plain(leaves, bnd, u6, dhc),
                                   reps=1)),
        )
        t_seed = cuda_ms(lambda: resid_ef._readout_seed(params, bnd.h_fin, None))
    print(f"REMAT TIMING per kernel (ms, kernel and plain) at B={Bk}, N={N}, depth {depth}: "
          + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in t.items()})
          + f" ({smi})", flush=True)
    n_chunks = -(-Bt // Bk)
    for name, (fk, bk) in (("fori", ("fori_fwd", "fori_bwd")),
                           ("depthgrid", ("depthgrid_fwd", "depthgrid_bwd"))):
        inside = n_chunks * (t[fk][0] + t[bk][0])
        print(f"REMAT BREAKDOWN {name} B={Bt}, {ms[name]:.3f} ms: kernels {n_chunks}x("
              f"{t[fk][0]:.3f}+{t[bk][0]:.3f}) = {inside:.3f} ms, readout seed "
              f"{n_chunks}x{t_seed:.3f} ms, the rest (embed, leaf restaging, layout copies, "
              f"host gaps) {ms[name] - inside - n_chunks * t_seed:.3f} ms", flush=True)
    fma = {k: v * Bk * depth for k, v in layer_fma(N, F, F, 50, cfg.n_heads, 256).items()}
    dims = (Bk, N, F, F, 50, cfg.n_heads, 256, depth)
    # the tensor-core products on their routes: the forwards' (#21, #23), the
    # pullbacks' (re-forward and pullback; #22, #24)
    tc = {k: v * Bk * depth for k, v in tc_fma(N, F, 50, cfg.n_heads, 256).items()}
    tc_fwd = tc["fwd"] if fori_ef.fwd_tensor_core_route(dims) else 0.0
    tc_pull = (tc["fwd"] + tc["bwd"]) if fori_ef.tensor_core_route(dims) else 0.0
    scratch = 4 * sum(math.prod(s[1:]) for s in resid_ef._resid_shapes(dims, leaves).values())
    dx_out = (dhc, xc, xc)  # the shapes of (dh0, dx, dv)
    fwd_bytes = nbytes(leaves, hc, xc, bnd)
    bwd_bytes = nbytes(leaves, leaves_t, bnd[:3], dhc, dx_out) + 2 * depth * scratch
    entries = {"fori_fwd": (fma["fwd"], fwd_bytes, "fori_ef.py:133", tc_fwd),
               "fori_bwd": (fma["fwd"] + fma["bwd"], bwd_bytes, "fori_ef.py:200", tc_pull),
               "depthgrid_fwd": (fma["fwd"], fwd_bytes, "depthgrid_ef.py:360", tc_fwd),
               "depthgrid_bwd": (fma["fwd"] + fma["bwd"], bwd_bytes, "depthgrid_ef.py:438",
                                 tc_pull)}
    print(f"REMAT BOUNDS (ms, by; on their routes the forwards' {tc_fwd / Bk / depth / 1e6:.2f} "
          f"M of {fma['fwd'] / Bk / depth / 1e6:.2f} M and the pullbacks' "
          f"{tc_pull / Bk / depth / 1e6:.2f} M of {(fma['fwd'] + fma['bwd']) / Bk / depth / 1e6:.2f}"
          f" M multiply-adds a molecule and layer in 3xTF32 at {TF32_PASSES} passes over "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s and the rest at {PEAK_F32_FLOPS / 1e12:.0f}, "
          f"beside their CUDA-core bound): "
          + json.dumps({k: [round(bound(o, b, tc=c)[0], 4), bound(o, b, tc=c)[1]]
                        + ([round(bound(o, b)[0], 4)] if c else [])
                        for k, (o, b, _, c) in entries.items()}), flush=True)
    kernels = [kernel_entry(name, "sake_tpu_torch/csrc/remat_ef.cu", "sake_tpu/kernels/" + at,
                            launches[name], abs_remat[name], *t[name], o, b, tc=c)
               for name, (o, b, at, c) in entries.items()]
    del bnd, hc, xc, dhc

    # -- 19. force-loss training through make_trainable_energy_forces -------------
    Bs = REMAT_TRAIN_B
    e_mean, e_std = float(data.e.mean()), float(data.e.std())
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    batches = [{"x": tdev(data.x[s : s + Bs]), "e": tdev(data.e[s : s + Bs]),
                "f": tdev(data.f[s : s + Bs])} for s in range(0, len(data.x), Bs)]
    primals = ("fori", "resid", "depthgrid")

    def branch(side, lr):
        prm = resid_ef._unflat_params([a.detach().clone().requires_grad_(True)
                                       for a in flat_params(params)], depth)
        ef_raw = (make_trainable_energy_forces(n_heads=cfg.n_heads, primal=side)
                  if side != "plain" else
                  lambda p, h, x: energy_and_forces_fn(p, h, x, n_heads=cfg.n_heads))

        def ef_fn(p, x):
            e, f = ef_raw(p, h_of(x.shape[0]), x)
            return coloring(e, e_mean, e_std)[:, None], f * e_std

        return dict(params=prm, ef=ef_fn, step=make_step_fn(ef_fn, cfg.energy_loss_weight),
                    state=TrainState.create(params=prm, tx=make_optimizer(lr)))

    def loss_and_grads(br, batch):
        return md17_loss_and_grads(br, batch, cfg.energy_loss_weight)

    branches = {side: branch(side, cfg.learning_rate) for side in ("plain", *primals)}
    lp, gp = loss_and_grads(branches["plain"], batches[0])
    for side in primals:
        lk, gk = loss_and_grads(branches[side], batches[0])
        grad_err = [rel_err(a, b) for a, b in zip(gk, gp)]
        loss_err = abs(float(lk - lp)) / abs(float(lp))
        print(f"REMAT TRAIN STEP 1 primal {side} vs plain double autograd at B={Bs}: loss "
              f"{float(lk):.7f} vs {float(lp):.7f} (rel {loss_err:.2e}); gradients of {len(gk)} "
              f"leaves, max rel err {max(grad_err):.3e} (leaf {int(np.argmax(grad_err))})",
              flush=True)
        if loss_err > TRAIN_TOL or max(grad_err) > TRAIN_TOL:
            fail(f"make_trainable_energy_forces ({side}) step 1 beyond {TRAIN_TOL}")
    traj = {}
    for side, br in branches.items():
        traj[side] = []
        for i in range(PARITY_STEPS):
            br["state"], loss = br["step"](br["state"], batches[i % len(batches)])
            traj[side].append(float(loss))
    for side in primals:
        traj_err = max(abs(a - b) / abs(b) for a, b in zip(traj[side], traj["plain"]))
        print(f"REMAT TRAIN STEPS 1-{PARITY_STEPS} losses {side} {json.dumps(traj[side])} plain "
              f"{json.dumps(traj['plain'])}: max rel diff {traj_err:.2e}", flush=True)
        if traj_err > LOSS_TOL:
            fail(f"make_trainable_energy_forces ({side}) losses differ beyond {LOSS_TOL}")
    run = branch("fori", REMAT_TRAIN_LR)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(REMAT_TRAIN_STEPS):
        run["state"], loss = run["step"](run["state"], batches[i % len(batches)])
        losses.append(float(loss))
    wall = time.perf_counter() - t0
    run_launches = {c.__name__: c.launches for c in (*counters, *k12)}
    print(f"REMAT TRAIN {REMAT_TRAIN_STEPS} adam steps (lr {REMAT_TRAIN_LR}) primal fori at "
          f"B={Bs}: {wall:.2f} s, launches {json.dumps(run_launches)}, #22 by route "
          f"{json.dumps(fori_ef.fori_bwd.routes)}; losses "
          + json.dumps([float(f"{v:.6f}") for v in losses]), flush=True)
    if not (all(np.isfinite(losses)) and np.mean(losses[-10:]) < np.mean(losses[:10])):
        fail("the fori training loss is not finite or did not fall")
    if min(c.launches for c in counters[:2]) == 0 or any(c.launches for c in k12):
        fail("the fori training run did not launch #21 and #22, or launched K1 or K2")
    if fori_ef.fori_bwd.routes["CUDA cores"] or fori_ef.fori_fwd.routes["CUDA cores"]:
        fail("the fori training run took #21's or #22's CUDA-core route at aspirin's widths")
    del run

    # the train step of the three primals and the plain branch, in turns
    order = ("plain", *primals)
    runs = {k: [] for k in order}
    batch = batches[0]
    for side in (*order, *order[::-1]):
        br = branches[side]
        br["step"](br["state"], batch)  # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            br["state"], _ = br["step"](br["state"], batch)
        torch.cuda.synchronize()
        runs[side].append((time.perf_counter() - t0) * 1e3 / 2)
    step_ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"REMAT TRAIN TIMING train step at B={Bs}: " + "; ".join(
        f"{k} {v:.2f} ms = {Bs * 1e3 / v:.1f} samples/s" for k, v in step_ms.items())
        + f" (ms per step, runs {json.dumps(runs)}; {smi})", flush=True)
    with torch.no_grad():
        hk = embed(params, h_of(Bs)).contiguous()
        xk = batch["x"].permute(2, 0, 1).contiguous()
        zk = torch.zeros_like(xk)
        fwk = resid_ef.resid_fwd(leaves, hk, xk, zk, u6)
        dhk = torch.randn_like(hk)
        t_k12 = (cuda_ms(lambda: resid_ef.resid_fwd(leaves, hk, xk, zk, u6))
                 + cuda_ms(lambda: resid_ef.resid_bwd(leaves, fwk, u6, dhk, zk, zk,
                                                      leaves_t=leaves_t)))
        del fwk
    kernel_ms = {"fori": t["fori_fwd"][0] + t["fori_bwd"][0], "resid": t_k12,
                 "depthgrid": t["depthgrid_fwd"][0] + t["depthgrid_bwd"][0]}
    for side in primals:
        br = branches[side]
        prm, leaves_ = br["params"], tree_leaves(br["params"])
        call = {"fori": fori_ef.fori_energy_forces, "resid": resid_ef.resid_energy_forces,
                "depthgrid": depthgrid_ef.depthgrid_energy_forces}[side]
        with torch.no_grad():
            t_primal = cuda_ms(lambda: call(prm, h_of(Bs), batch["x"], n_heads=cfg.n_heads))
        with torch.enable_grad():
            e, f = br["ef"](prm, batch["x"])
            loss = ((f - batch["f"]).abs().mean()
                    + cfg.energy_loss_weight * (e - batch["e"]).abs().mean())
            t_pull = cuda_ms(lambda: torch.autograd.grad(loss, leaves_, retain_graph=True))
        del e, f, loss
        zero_grads = [torch.zeros_like(a) for a in leaves_]
        t_opt = cuda_ms(lambda: br["state"].apply_gradients(zero_grads))
        parts = dict(primal_kernels=kernel_ms[side], readout_seed=t_seed,
                     primal_glue=t_primal - kernel_ms[side] - t_seed, torch_pullback=t_pull,
                     adam=t_opt)
        print(f"REMAT TRAIN BREAKDOWN primal {side} step at B={Bs}, {step_ms[side]:.3f} ms: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f", rest {step_ms[side] - sum(parts.values()):.3f} ms", flush=True)
    del branches

    # -- 20. dense MD on fori forces against plain forces ---------------------------
    Bm = MD_B
    masses = torch.tensor([ATOM_MASS[int(z)] for z in data.z], device=dev)
    x0 = xs_all[:Bm].float()
    v0 = tdev(0.05 * np.random.RandomState(SEED + 20).randn(Bm, N, 3))
    hm = h_of(Bm)

    def plain_md(p, x):
        return energy_and_forces_fn(p, hm, x, n_heads=cfg.n_heads)

    with torch.no_grad():
        force_fields = {
            "fori": lambda p, x: fori_ef.fori_energy_forces(p, hm, x, n_heads=cfg.n_heads),
            "dispatch": lambda p, x: dispatch.dispatch_energy_forces(p, hm, x,
                                                                     n_heads=cfg.n_heads),
            "plain": plain_md,
        }
        traj, md_ms = {}, {k: [] for k in force_fields}
        for side in ("fori", "dispatch", "plain", "plain", "dispatch", "fori"):
            if side == "fori" and not md_ms[side]:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = md.velocity_verlet_rollout(force_fields[side], params, x0, v0, masses, MD_DT,
                                             MD_STEPS)
            torch.cuda.synchronize()
            md_ms[side].append((time.perf_counter() - t0) * 1e3)
            if side == "fori" and len(md_ms[side]) == 1:
                md_launches = {c.__name__: c.launches for c in (*counters, *k12)}
                md_routes = {c.__name__: dict(c.routes) for c in counters[:2]}
            traj.setdefault(side, out)
    xs_k, vs_k, es_k = traj["fori"]
    xs_p, vs_p, _ = traj["plain"]
    viol = lambda a, b, rtol, atol: float(((a - b).abs() / (atol + rtol * b.abs())).max())
    x_viol, v_viol = viol(xs_k, xs_p, 1e-4, 1e-5), viol(vs_k, vs_p, 1e-3, 1e-4)
    rate = {k: Bm * MD_STEPS * 1e3 / (sum(v) / len(v)) for k, v in md_ms.items()}
    print(f"REMAT MD velocity Verlet B={Bm}, {MD_STEPS} steps of dt {MD_DT}: fori against plain "
          f"forces, positions at {x_viol:.3e} and velocities at {v_viol:.3e} of the JAX test's "
          f"tolerances (rtol 1e-4 / atol 1e-5, rtol 1e-3 / atol 1e-4); fori launches "
          f"{json.dumps(md_launches)}, #21 and #22 by route {json.dumps(md_routes)}; "
          f"molecule-steps/s "
          + json.dumps({k: round(v, 1) for k, v in rate.items()})
          + f" (ms per rollout {json.dumps(md_ms)}; {smi})", flush=True)
    if not (x_viol <= 1.0 and v_viol <= 1.0 and torch.isfinite(es_k).all()):
        fail("the fori MD rollout is beyond the JAX test's tolerances of the plain one")
    if min(md_launches[c.__name__] for c in counters[:2]) == 0 or any(
            md_launches[c.__name__] for c in k12):
        fail("the fori MD rollout did not launch #21 and #22, or launched K1 or K2")
    if any(r["CUDA cores"] for r in md_routes.values()):
        fail("the fori MD rollout took #21's or #22's CUDA-core route at aspirin's widths")
    return kernels


SPLIT_BATCHED = {"edge_att": ("x0", "x1", "x2", "a_j", "a_i", "o_j", "o_i"),
                 "coeff_pool": ("x0", "x1", "x2", "h_e", "att"),
                 "merged": ("x0", "x1", "x2", "a_j", "a_i", "o_j", "o_i")}
SPLIT_OUTS = {"edge_att": ("h_e", "att"),
              "coeff_pool": ("pooled0", "pooled1", "pooled2", "hatt_sum"),
              "merged": ("pooled0", "pooled1", "pooled2", "hatt_sum")}


def split_fma(R, H, K, C):
    """Multiply-adds per edge of the split ops' products, counted as
    ``layer_fma`` counts them: each body's forward, and its pullback, which
    recomputes the forward (the edge_att pullback: d_sem @ w_sem^T, d_h_e @
    w1^T, d_e0 @ w_r^T; the coeff_pool one: the x-mixing product transposed,
    the pooled planes' cotangents and the head expansion's)."""
    HK = H * K
    ea, cp = R * H + H * H + H * K, HK * C + 3 * C
    ea_pull, cp_pull = K * H + H * H + H * R, C * HK + 6 * C + 2 * HK
    return dict(edge_att_fwd=ea, coeff_pool_fwd=cp, edge_att_bwd=ea + ea_pull,
                coeff_pool_bwd=cp + cp_pull, merged_fwd=ea + cp,
                merged_bwd=ea + cp + ea_pull + cp_pull)


def split_tc_fma(R, H, K, C):
    """Of ``split_fma``'s multiply-adds per edge, those a kernel runs on the
    tensor cores in 3xTF32 on its tensor-core route (``csrc/split_edge.cuh``'s
    ``split_group_fwd`` and ``split_group``): the edge_att forward's o_f and o1,
    and its pullback's also d_h_e @ w1^T and d_e0 @ w_r^T; the coeff_pool
    forward's x-mixing product, and its pullback's also the transpose; the merged
    op's both."""
    ea, cp = R * H + H * H, H * K * C
    return dict(edge_att_fwd=ea, coeff_pool_fwd=cp, edge_att_bwd=2 * ea, coeff_pool_bwd=2 * cp,
                merged_fwd=ea + cp, merged_bwd=2 * (ea + cp))


def split_routes(own) -> dict:
    """``{wrapper name: {route: launches}}`` of the forwards and pullbacks among
    ``own``."""
    return {c.__name__: dict(c.routes) for c in own if hasattr(c, "routes")}


def reset_split_counts(own):
    for c in own:
        c.launches = 0
        if hasattr(c, "routes"):
            c.routes = dict.fromkeys(c.routes, 0)


def split_checks(args: dict, seed: int) -> dict:
    """#25-#28 against their plain versions on the ops' arguments ``args``
    (``tools/probe_split.layer0_args``) and seeded cotangents; #27 also against #25's
    two kernels composed. Checks as :func:`report_checks` takes them."""
    import torch

    from sake_tpu_torch.kernels import split_ef as se

    gen = torch.Generator(args["merged"][0].device).manual_seed(seed)
    checks = {}
    for kind in ("edge_att", "coeff_pool", "merged"):
        a = args[kind]
        with torch.no_grad():
            k_out, p_out = se.FWD[kind](*a), se.BODIES[kind](*a)
        checks[f"{kind}_fwd"] = [*zip(SPLIT_OUTS[kind], k_out, p_out)]
        cots = [torch.randn(o.shape, device=o.device, generator=gen) for o in p_out]
        kb, kw = se.BWD[kind](a, cots, True)
        kb0, _ = se.BWD[kind](a, cots, False)
        pb, pw = se.vjp_plain(kind, a, cots, True)
        torch.cuda.synchronize()
        names = [f"d_{n}" for n in SPLIT_BATCHED[kind]]
        checks[f"{kind}_bwd"] = [*zip(names, kb, pb),
                                 *zip((f"d_{n}" for n in se.WEIGHTS[kind]), kw, pw),
                                 *zip((f"no_w.{n}" for n in names), kb0, pb)]
    with torch.no_grad():
        a = args["merged"]
        he, att = se.edge_att_fwd(*a[:16])
        composed = se.coeff_pool_fwd(*a[:3], he, att, a[16])
        merged = se.merged_fwd(*a)
        torch.cuda.synchronize()
    checks["merged_fwd_vs_split"] = [*zip(SPLIT_OUTS["merged"], merged, composed)]
    return checks


def split_phases(dev, smi) -> list:
    """Phases 21-23 (see the module docstring); returns their kernel entries."""
    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels import split_ef as se
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.functional import CFConvParams, flat_params, model_forward
    from sake_tpu_torch.models import SAKEModel
    from sake_tpu_torch.tasks.md17 import MD17Config, make_model, species_onehot

    data = synthesize_md17(n_samples=max(SPLIT_REQUESTS), seed=SEED)
    species = species_onehot(data.z, int(data.z.max())).to(dev)
    cfg = MD17Config(hidden_features=FULL["hidden"], depth=FULL["depth"], n_heads=FULL["heads"])
    model = make_model(cfg, species.shape[-1], device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    model.requires_grad_(False)
    params = model.functional_params()
    N, F, depth, heads = len(data.z), cfg.hidden_features, cfg.depth, cfg.n_heads
    xs_all = torch.as_tensor(data.x, device=dev)
    h_of = lambda B: species.expand(B, N, -1)
    own = {"split": (se.edge_att_fwd, se.coeff_pool_fwd, se.edge_att_bwd, se.coeff_pool_bwd),
           "merged": (se.merged_fwd, se.merged_bwd)}
    every = (*own["split"], *own["merged"])
    dense = dense_counters()
    ps = split_probe_module()

    def on_route(label: str, want: str):
        """Fail unless every forward and pullback launch since the counts were
        reset took the route ``want``."""
        routes = split_routes(every)
        print(f"SPLIT ROUTES {label}: {json.dumps(routes)}", flush=True)
        if any(n for r in routes.values() for k, n in r.items() if k != want):
            fail(f"split kernels {label} off the {want} route: {routes}")

    # -- 21. #25-#28 against their plain versions at full width, then narrow -------
    Bc = TRAIN_CHECK_B
    abs_split = {}
    reset_split_counts(every)
    report_checks(split_checks(ps.layer0_args(params, h_of(Bc), xs_all[:Bc], heads), 21),
                  abs_split, f"vs plain (B={Bc}, N={N}, layer 0)", prefix="SPLIT")
    on_route(f"at aspirin B={Bc}", "tensor cores")
    reset_split_counts(every)
    for hid in (8, 16):  # 50 rbf channels against H*K = 32 and 64
        m = SAKEModel(hid, 1, 2, in_features=5, device=dev,
                      generator=torch.Generator().manual_seed(hid))
        pm = model_params_from_linen(linen_tree(m), device=dev)
        gen = torch.Generator(dev).manual_seed(hid)
        hm = torch.randn(4, 7, 5, device=dev, generator=gen)
        xm = 1.5 * torch.randn(4, 7, 3, device=dev, generator=gen)
        report_checks(split_checks(ps.layer0_args(pm, hm, xm, 4), hid), {},
                      f"at hidden {hid} (B=4, N=7, depth 2)", prefix="SPLIT")
    on_route("at hidden 8 and 16", "CUDA cores")
    # the tensor-core route's groups: three rows a tile (N = 21), two (N = 22), a
    # last group of two rows (N = 17); the narrow models on the CUDA cores
    for d, res in (("fwd", ps.check_forwards(dev)), ("bwd", ps.check_pullbacks(dev))):
        for (label, kind), (err, route, bitwise) in res.items():
            want = "tensor cores" if label.startswith("hidden 64") else "CUDA cores"
            print(f"SPLIT ROUTE CHECK {kind}_{d} {label}: max rel err {err:.3e}, route {route}, "
                  f"two launches bitwise {bitwise}", flush=True)
            if not (err <= SPLIT_TOL and bitwise and route == want):
                fail(f"SPLIT ROUTE CHECK {kind}_{d} {label}: beyond {SPLIT_TOL}, not bitwise or "
                     f"off the {want} route")

    # -- 22. the E + F slice through split_energy_forces and merged_energy_forces --
    paths = {"split": se.split_energy_forces, "merged": se.merged_energy_forces}
    answers, launches = {}, {}
    for name, fn in paths.items():
        reset_split_counts(every)
        for c in dense:
            c.launches = 0
        for B in SPLIT_REQUESTS:
            answers[(name, B)] = fn(params, h_of(B), xs_all[:B], n_heads=heads)
        torch.cuda.synchronize()
        launches[name] = {c.__name__: c.launches for c in every}
        others = [c for c in every if c not in own[name]]
        print(f"SPLIT SLICE {name} launches {json.dumps(launches[name])}, dense kernels "
              f"{sum(c.launches for c in dense)}", flush=True)
        if (min(c.launches for c in own[name]) == 0 or any(c.launches for c in others)
                or any(c.launches for c in dense)):
            fail(f"the {name} path did not launch only its own kernels")
        on_route(f"of the {name} path", "tensor cores")

    def plain_ef(x, chunk=CHECK_CHUNK):
        return chunked_plain_ef(params, species, x, heads, chunk)

    refs = {B: plain_ef(xs_all[:B]) for B in SPLIT_REQUESTS}
    worst = {"f_err": 0.0, "e_err": 0.0}
    for (name, B), (e, f) in answers.items():
        if e.shape != (B,) or f.shape != (B, N, 3):
            fail(f"{name} B={B}: shapes {tuple(e.shape)} {tuple(f.shape)}")
        if not (torch.isfinite(e).all() and torch.isfinite(f).all()):
            fail(f"{name} B={B}: non-finite output")
        err = {"f_err": rel_err(f, refs[B][1]), "e_err": rel_err(e, refs[B][0])}
        worst = {k: max(worst[k], v) for k, v in err.items()}
        print(f"SPLIT SLICE {name} B={B}: f_err {err['f_err']:.3e} e_err {err['e_err']:.3e}",
              flush=True)
    if not (worst["f_err"] <= F_TOL and worst["e_err"] <= E_TOL):
        fail(f"split / merged slice beyond f_err {F_TOL} / e_err {E_TOL}: {worst}")
    del answers, refs

    # timing at B = 2048 in turns: split, merged, K1 + K2 and the plain path
    # (chunks of 512), and each path's peak device memory
    Bt = max(SPLIT_REQUESTS)
    hb, xb = h_of(Bt), xs_all[:Bt]
    timed = {**paths, "resid": resid_ef.resid_energy_forces,
             "plain": lambda p, h, x, n_heads: plain_ef(x, PATH_CHUNK)}
    runs, peak = {k: [] for k in timed}, {}
    for side in ("plain", "split", "merged", "resid", "resid", "merged", "split", "plain"):
        runs[side].append(cuda_ms(lambda: timed[side](params, hb, xb, n_heads=heads)))
    for side, fn in timed.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():  # the paths enable autograd for their forces themselves
            out = fn(params, hb, xb, n_heads=heads)
        torch.cuda.synchronize()
        peak[side] = torch.cuda.max_memory_allocated() - base
        del out
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"SPLIT TIMING B={Bt}: " + "; ".join(
        f"{k} {v:.2f} ms = {Bt * 1e3 / v:.1f} evals/s, peak memory {peak[k] / 2**20:.1f} MiB"
        for k, v in ms.items()) + f" (runs {json.dumps(runs)}; {smi})", flush=True)

    # each kernel at the path's shapes: one layer of the 2048-molecule request
    args = ps.layer0_args(params, hb, xb, heads)
    with torch.no_grad():
        args["coeff_pool"] = (*args["coeff_pool"][:3], *se.edge_att_fwd(*args["edge_att"]),
                              args["coeff_pool"][5])
        outs = {k: se.BODIES[k](*a) for k, a in args.items()}
    gen = torch.Generator(dev).manual_seed(22)
    cots = {k: [torch.randn(o.shape, device=dev, generator=gen) for o in v]
            for k, v in outs.items()}
    del outs
    t, moved = {}, {}
    for kind, a in args.items():
        t[f"{kind}_fwd"] = (cuda_ms(lambda: se.FWD[kind](*a)),
                            cuda_ms(lambda: se.BODIES[kind](*a), reps=1))
        t[f"{kind}_bwd"] = (cuda_ms(lambda: se.BWD[kind](a, cots[kind])),
                            cuda_ms(lambda: se.vjp_plain(kind, a, cots[kind]), reps=1))
        with torch.no_grad():
            fo = se.FWD[kind](*a)
            bo = se.BWD[kind](a, cots[kind])[0]
        moved[f"{kind}_fwd"] = nbytes(a, fo)
        moved[f"{kind}_bwd"] = nbytes(a, cots[kind], bo)
        del fo, bo
    print(f"SPLIT TIMING per kernel (ms, kernel and plain) at B={Bt}, N={N}, one layer: "
          + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b) in t.items()})
          + f" ({smi})", flush=True)
    for name, kinds in (("split", ("edge_att", "coeff_pool")), ("merged", ("merged",))):
        inside = depth * sum(t[f"{k}_{d}"][0] for k in kinds for d in ("fwd", "bwd"))
        print(f"SPLIT BREAKDOWN {name} B={Bt}, {ms[name]:.3f} ms: kernels {depth} layers x ("
              + " + ".join(f"{t[f'{k}_{d}'][0]:.3f}" for k in kinds for d in ("fwd", "bwd"))
              + f") = {inside:.3f} ms, the rest (embedding, node-level math, its autograd, "
              f"readout, host gaps) {ms[name] - inside:.3f} ms", flush=True)
    fma = {k: v * Bt * N * N for k, v in split_fma(50, F, heads, 256).items()}
    # the tensor-core products where the kernel takes that route (aspirin's)
    tc_route = {f"{k}_{d}": se.tensor_core_route(k, se._dims(k, a), d == "bwd")
                for k, a in args.items() for d in ("fwd", "bwd")}
    tc = {k: v * Bt * N * N * tc_route[k] for k, v in split_tc_fma(50, F, heads, 256).items()}
    print(f"SPLIT BOUNDS (ms, by; the x-mixing and edge products on the "
          f"tensor-core route in 3xTF32 at {TF32_PASSES} passes over "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, the rest at {PEAK_F32_FLOPS / 1e12:.0f}, "
          f"beside the bound with every product at the f32 rate): " + json.dumps(
              {k: [round(bound(fma[k], moved[k], tc=tc[k])[0], 4),
                   bound(fma[k], moved[k], tc=tc[k])[1]]
                  + ([round(bound(fma[k], moved[k])[0], 4)] if tc[k] else []) for k in t}),
          flush=True)
    sites = {"edge_att_fwd": ("split_fwd.cu", "split_ef.py:158", "split"),
             "coeff_pool_fwd": ("split_fwd.cu", "split_ef.py:158", "split"),
             "edge_att_bwd": ("split_bwd.cu", "split_ef.py:212", "split"),
             "coeff_pool_bwd": ("split_bwd.cu", "split_ef.py:212", "split"),
             "merged_fwd": ("split_fwd.cu", "split_ef.py:448", "merged"),
             "merged_bwd": ("split_bwd.cu", "split_ef.py:513", "merged")}
    kernels = [kernel_entry(k, "sake_tpu_torch/csrc/" + src, "sake_tpu/kernels/" + at,
                            launches[path][k], abs_split[k], *t[k], fma[k], moved[k], tc=tc[k])
               for k, (src, at, path) in sites.items()]
    del args, cots

    # -- 23. the weight cotangents through the split ops and the merged op --------
    Bg = SPLIT_GRAD_B
    xg, hg = xs_all[:Bg], h_of(Bg)
    prm = resid_ef._unflat_params([p.detach().clone() for p in flat_params(params)], depth)
    leaves = [t for lp in prm.layers for t in (*lp.edge, lp.w_sem, lp.b_sem, lp.w_xmix)]
    names = [f"layer{l}.{n}" for l in range(depth)
             for n in (*CFConvParams._fields, "w_sem", "b_sem", "w_xmix")]
    for t_ in leaves:
        t_.requires_grad_(True)
    want = [torch.zeros_like(t_) for t_ in leaves]
    for s in range(0, Bg, CHECK_CHUNK):
        with torch.enable_grad():
            out, _, _ = model_forward(prm, hg[s : s + CHECK_CHUNK], xg[s : s + CHECK_CHUNK],
                                      n_heads=heads)
            g = torch.autograd.grad(out.sum(), leaves)
        want = [a + b for a, b in zip(want, g)]
    for merged in (False, True):
        name = "merged" if merged else "split"
        reset_split_counts(every)
        with torch.enable_grad():
            e = se.model_energy(prm, hg, xg, n_heads=heads, merged=merged)
            got = torch.autograd.grad(e.sum(), leaves)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        w = int(np.argmax(errs))
        print(f"SPLIT GRADS {name} B={Bg}: {len(errs)} edge leaves, max rel err {errs[w]:.3e} "
              f"({names[w]}), launches "
              + json.dumps({c.__name__: c.launches for c in own[name]}), flush=True)
        if errs[w] > SPLIT_TOL or not all(bool(torch.isfinite(a).all()) for a in got):
            fail(f"the {name} weight cotangents beyond {SPLIT_TOL}")
        if min(c.launches for c in own[name]) == 0:
            fail(f"the {name} weight cotangents did not run through its kernels")
        on_route(f"of the {name} weight cotangents", "tensor cores")
    return kernels


def fused_fma(N, F_in, F, H, R, K, C, F0, O, depth):
    """Multiply-adds that #20's function needs for one molecule: the
    embedding, one forward and one pullback over depth, the readout and its
    seed (``layer_fma``'s counting, as #3's bound)."""
    lf = layer_fma(N, F, H, R, K, C)
    return N * F_in * F + depth * (lf["fwd"] + lf["bwd"]) + N * (2 * F * F0 + F0 * O)


def fused_tc(N, H, R, K, C, depth, bf16: bool):
    """Of ``fused_fma``'s multiply-adds, ``(those #20 runs on the tensor cores,
    their mean TF32 passes)``: ``tc_fma``'s forward and pullback products over
    depth; 3 passes in f32, in bf16 1 for the forward's o_f and o1 and 2 for the
    x-mixing and every pullback product (``mma_tf32x3.cuh``'s ``tc_passes``).
    The bf16 passes describe the route, not the bound: the bound counts every
    bf16 product at the bf16 peak."""
    E, HK = N * N, H * K
    tc = tc_fma(N, H, R, K, C)
    total = depth * (tc["fwd"] + tc["bwd"])
    if not bf16:
        return total, TF32_PASSES
    weighted = depth * E * (2 * HK * C + (R * H + H * H) + 2 * (HK * C + R * H + H * H))
    return total, weighted / total


def fused_phases(dev, smi) -> list:
    """Phase 24 (see the module docstring); returns its kernel entries."""
    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch import kernels
    from sake_tpu_torch.kernels import fori_ef, fused_ef, resid_ef
    from sake_tpu_torch.kernels.adapter import linen_tree, model_params_from_linen
    from sake_tpu_torch.kernels.functional import params_to
    from sake_tpu_torch.models import SAKEModel
    from sake_tpu_torch.tasks.md17 import MD17Config, make_model, species_onehot

    data = synthesize_md17(n_samples=max(FUSED_REQUESTS), seed=SEED)
    species = species_onehot(data.z, int(data.z.max())).to(dev)
    cfg = MD17Config(hidden_features=FULL["hidden"], depth=FULL["depth"], n_heads=FULL["heads"])
    model = make_model(cfg, species.shape[-1], device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    model.requires_grad_(False)
    params = model.functional_params()
    N, F, depth, heads = len(data.z), cfg.hidden_features, cfg.depth, cfg.n_heads
    F_in = species.shape[-1]
    xs_all = torch.as_tensor(data.x, device=dev)
    h_of = lambda B: species.expand(B, N, -1)
    u6 = [1.0] * depth
    modes = {"f32": None, "bf16": torch.bfloat16}
    others = dense_counters()

    def plain(p, h, x, upd, dtype, chunk=CHECK_CHUNK):
        outs = [fused_ef.fused_ef_plain(p, h[s : s + chunk], x[s : s + chunk], upd,
                                        n_heads=heads, matmul_dtype=dtype)
                for s in range(0, x.shape[0], chunk)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    # -- 24. the bf16 tier's tensor-core products alone, against float64 ----------
    pf = probe_module()
    errs = pf.check_tc_products(dev)
    print(f"FUSED TC PRODUCTS bf16 vs float64 (max |diff| / max |ref| over 4 seeds, limit "
          f"{pf.TC_PRODUCT_TOL:.0e}): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
          flush=True)
    if max(errs.values()) > pf.TC_PRODUCT_TOL:
        fail("#20's bf16 tensor-core products beyond their limit against float64")

    # -- #20 against its plain version: aspirin B = 37, then narrow models --------
    abs_fused = {}
    cases = [("aspirin B=37", params, h_of(37), xs_all[:37], u6)]
    for hid in (8, 16):  # 50 rbf channels against H*K = 32 and 64
        m = SAKEModel(hid, 1, 2, in_features=5, device=dev,
                      generator=torch.Generator().manual_seed(hid))
        gen = torch.Generator(dev).manual_seed(hid)
        cases.append((f"hidden {hid} (B=4, N=7, depth 2, gates [1, 0.4])",
                      params_to(model_params_from_linen(linen_tree(m), device=dev), dev),
                      torch.randn(4, 7, 5, device=dev, generator=gen),
                      1.5 * torch.randn(4, 7, 3, device=dev, generator=gen), [1.0, 0.4]))
    for label, p, h, x, upd in cases:
        ref32 = plain(p, h, x, upd, None)
        aspirin = label.startswith("aspirin")
        for mode, dtype in modes.items():
            w = fused_ef.kernel_weights(p, heads, dtype is not None)
            hc = h.float().contiguous()
            with torch.no_grad():
                k = fused_ef.launch(w, hc, x.float().contiguous(), upd)
                torch.cuda.synchronize()
            route = fused_ef.ROUTES[fused_ef.tensor_core_route(w, hc)]
            q = ref32 if dtype is None else plain(p, h, x, upd, dtype)
            err = {"e": rel_err(k[0], q[0]), "f": rel_err(k[1], q[1])}
            gap = {"e": rel_err(q[0], ref32[0]), "f": rel_err(q[1], ref32[1])}
            finite = bool(torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all())
            key = f"fused_ef_{mode}"
            abs_fused[key] = max(abs_fused.get(key, 0.0), abs_err(k[0], q[0]),
                                 abs_err(k[1], q[1]))
            if dtype is None:
                tol = {"e": E_TOL, "f": F_TOL}
                ok = all(err[o] <= tol[o] for o in tol)
            else:  # and no farther from plain bf16 than plain bf16 is from plain f32
                tol = (FUSED_ASPIRIN_BF16_TOL if aspirin
                       else dict.fromkeys(("e", "f"), FUSED_NARROW_BF16_TOL))
                ok = err["f"] <= gap["f"] and all(err[o] <= tol[o] for o in tol)
            print(f"FUSED {key} on the {route} vs plain {mode} at {label}: e rel err "
                  f"{err['e']:.3e}, f rel err {err['f']:.3e} (limits e {tol['e']:.3e}, f "
                  f"{tol['f']:.3e}); plain {mode} vs plain f32: e {gap['e']:.3e}, f "
                  f"{gap['f']:.3e}; finite {finite}", flush=True)
            if route != ("tensor cores" if aspirin else "CUDA cores"):
                fail(f"#20 ({mode}) at {label} took the {route}")
            if not (ok and finite):
                fail(f"#20 ({mode}) against its plain version at {label}")
            if label.startswith("aspirin"):  # the same plain sums in the host's order
                c = fused_ef.fused_ef_plain(params_to(p, torch.device("cpu")), h.cpu(), x.cpu(),
                                            upd, n_heads=heads, matmul_dtype=dtype)
                print(f"FUSED plain {mode} on the host CPU vs on the card at {label}: e rel "
                      f"{rel_err(c[0], q[0].cpu()):.3e}, f rel {rel_err(c[1], q[1].cpu()):.3e}",
                      flush=True)

    # -- requests through kernels.fused_energy_forces, one launch each ------------
    refs = {B: chunked_plain_ef(params, species, xs_all[:B], heads, CHECK_CHUNK)
            for B in FUSED_REQUESTS}
    launches, worst = {}, {}
    for mode, dtype in modes.items():
        for c in (fused_ef.fused_ef, *others):
            c.launches = 0
        fused_ef.fused_ef.routes = dict.fromkeys(fused_ef.ROUTES, 0)
        for B in FUSED_REQUESTS:
            before, routes = fused_ef.fused_ef.launches, dict(fused_ef.fused_ef.routes)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e, f = kernels.fused_energy_forces(params, h_of(B), xs_all[:B], n_heads=heads,
                                               batch_tile=1, matmul_dtype=dtype)
            torch.cuda.synchronize()
            peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
            route = [r for r, n in fused_ef.fused_ef.routes.items() if n != routes[r]]
            print(f"FUSED REQUEST {mode} B={B}: route {route}, peak device memory "
                  f"{peak_mib:.1f} MiB", flush=True)
            if fused_ef.fused_ef.launches != before + 1 or route != ["tensor cores"]:
                fail(f"fused_energy_forces ({mode}) B={B} did not launch #20 once on the "
                     "tensor cores")
            if e.shape != (B,) or f.shape != (B, N, 3):
                fail(f"fused_energy_forces ({mode}) B={B}: shapes {tuple(e.shape)} "
                     f"{tuple(f.shape)}")
            if not (torch.isfinite(e).all() and torch.isfinite(f).all()):
                fail(f"fused_energy_forces ({mode}) B={B}: non-finite output")
            err = {"f_err": rel_err(f, refs[B][1]), "e_err": rel_err(e, refs[B][0])}
            if dtype is None:
                ok = err["f_err"] <= F_TOL and err["e_err"] <= E_TOL
                rule = f"f_err <= {F_TOL}, e_err <= {E_TOL}"
            else:
                pe, pf = plain(params, h_of(B), xs_all[:B], u6, dtype)
                p_err = rel_err(pf, refs[B][1])
                gate = max(2e-3, 2 * p_err)
                err |= {"plain_bf16_f_err": p_err, "vs_plain_bf16": rel_err(f, pf),
                        "plain_bf16_e_err": rel_err(pe, refs[B][0])}
                ok = err["f_err"] <= gate and err["vs_plain_bf16"] <= p_err
                rule = (f"f_err <= max(2e-3, 2 x plain bf16's {p_err:.3e}) = {gate:.3e} and "
                        f"|kernel - plain bf16| <= plain bf16's f_err")
            worst[mode] = {k: max(worst.get(mode, {}).get(k, 0.0), v) for k, v in err.items()}
            print(f"FUSED SLICE {mode} B={B} against the plain f32 oracle: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) + f" ({rule})",
                  flush=True)
            if not ok:
                fail(f"fused_energy_forces ({mode}) B={B} beyond its gate")
        launches[mode] = fused_ef.fused_ef.launches
        stray = {c.__name__: c.launches for c in others if c.launches}
        print(f"FUSED SLICE {mode} launches: #20 {launches[mode]} (by route "
              f"{json.dumps(fused_ef.fused_ef.routes)}), other dense kernels "
              f"{json.dumps(stray)}", flush=True)
        if launches[mode] != len(FUSED_REQUESTS) or stray:
            fail(f"the fused slice ({mode}) launched another kernel or not #20 once a request")
    del refs

    # -- timing at B = 2048 in turns, and each path's peak device memory ---------
    Bt = max(FUSED_REQUESTS)
    hb, xb = h_of(Bt), xs_all[:Bt]
    timed = {
        "fused_f32": lambda: kernels.fused_energy_forces(params, hb, xb, n_heads=heads,
                                                         matmul_dtype=None),
        "fused_bf16": lambda: kernels.fused_energy_forces(params, hb, xb, n_heads=heads),
        "fori": lambda: fori_ef.fori_energy_forces(params, hb, xb, n_heads=heads),
        "resid": lambda: resid_ef.resid_energy_forces(params, hb, xb, n_heads=heads),
        "plain": lambda: chunked_plain_ef(params, species, xb, heads, PATH_CHUNK),
    }
    runs, peak = {k: [] for k in timed}, {}
    for side in (*timed, *reversed(timed)):
        runs[side].append(cuda_ms(timed[side]))
    for side, fn in timed.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        peak[side] = torch.cuda.max_memory_allocated() - base
        del out
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"FUSED TIMING B={Bt}: " + "; ".join(
        f"{k} {v:.2f} ms = {Bt * 1e3 / v:.1f} evals/s, peak memory {peak[k] / 2**20:.1f} MiB"
        for k, v in ms.items()) + f" (runs {json.dumps(runs)}; {smi})", flush=True)

    # the kernel alone (weights staged once) beside its plain version, per mode
    hc, xc = hb.float().contiguous(), xb.float().contiguous()
    kernel_t = {}
    for mode, dtype in modes.items():
        w = fused_ef.kernel_weights(params, heads, dtype is not None)
        with torch.no_grad():
            k_ms = cuda_ms(lambda: fused_ef.launch(w, hc, xc, u6))
        p_ms = cuda_ms(lambda: plain(params, hc, xc, u6, dtype, chunk=Bt), reps=1)
        kernel_t[mode] = (k_ms, p_ms, nbytes(w.leaves, w.leaves_t, w.head, hc, xc)
                          + 4 * Bt * (1 + 3 * N))
    print(f"FUSED TIMING per kernel (ms, kernel and plain) at B={Bt}, N={N}, depth {depth}: "
          + json.dumps({k: [round(a, 3), round(b, 3)] for k, (a, b, _) in kernel_t.items()})
          + f"; request overhead (weights staging, host) f32 "
          f"{ms['fused_f32'] - kernel_t['f32'][0]:.3f} ms, bf16 "
          f"{ms['fused_bf16'] - kernel_t['bf16'][0]:.3f} ms ({smi})", flush=True)
    fma = Bt * fused_fma(N, F_in, F, F, 50, heads, 256, F, 1, depth)
    peaks = {"f32": PEAK_F32_FLOPS, "bf16": PEAK_BF16_FLOPS}
    entries = []
    for mode in modes:
        k_ms, p_ms, moved = kernel_t[mode]
        tc, passes = fused_tc(N, F, 50, heads, 256, depth, mode == "bf16")
        tc *= Bt
        btc = tc if mode == "f32" else 0.0  # bf16: every product at the bf16 peak
        b_ms, b_by = bound(fma, moved, peaks[mode], btc)
        old_ms, old_by = bound(fma, moved, peaks[mode])
        how = (f"{2 * tc / 1e9:.2f} GFLOP of tensor-core products in 3xTF32 at {passes} passes "
               f"over {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {2 * (fma - tc) / 1e9:.2f} GFLOP "
               f"over {peaks[mode] / 1e12:.0f} TFLOP/s" if mode == "f32" else
               f"{2 * fma / 1e9:.2f} GFLOP, every product at the dense bf16 peak "
               f"{peaks[mode] / 1e12:.0f} TFLOP/s in one pass")
        note = (f"the bound before the tensor-core route {old_ms:.4f} ms ({old_by}; every "
                f"product over {peaks[mode] / 1e12:.0f} TFLOP/s)" if mode == "f32" else
                f"the route, not the bound: its {2 * tc / 1e9:.2f} GFLOP of tensor-core "
                f"products at {passes:.3f} TF32 passes on average over "
                f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s take at least "
                f"{2 * passes * tc / PEAK_TF32_FLOPS * 1e3:.4f} ms")
        print(f"FUSED BOUND {mode}: {b_ms:.4f} ms ({b_by}; {how}; {moved} bytes over "
              f"{PEAK_BYTES / 1e12:.2f} TB/s); {note}", flush=True)
        entries.append(kernel_entry(f"fused_ef_{mode}", "sake_tpu_torch/csrc/fused_remat_ef.cu",
                                    "sake_tpu/kernels/fused_ef.py:94", launches[mode],
                                    abs_fused[f"fused_ef_{mode}"], k_ms, p_ms, fma, moved,
                                    peak=peaks[mode], tc=btc))
    return entries


def edge_fma(N, H, R, K, C):
    """Of ``layer_fma``'s multiply-adds, the edge products that resid_ef's bf16
    tier rounds to bf16 on both sides: o_f, o1, the semantic logits, the
    x-mixing, their pullbacks and the four edge leaves' weight contractions."""
    E, HK = N * N, H * K
    one = E * (R * H + H * H + H * K + HK * C)
    return dict(fwd=one, bwd=one, grads=one)


def entry16(name, source, replaces, launches, max_abs_err, ms, plain_ms, fma, edge, moved):
    """A kernel entry of the bf16 tier: its edge products at the dense bf16 peak in
    one pass, the rest over the f32 peak, or its bytes (the bf16 streams at 2 bytes
    an element) over the memory rate."""
    t_ops = (2 * (fma - edge) / PEAK_F32_FLOPS + 2 * edge / PEAK_BF16_FLOPS) * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    bound_ms, bound_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def tier_pairs(k, p, mask=None):
    """K1's outputs ``k`` against ``p`` (``FwdOut``s of the bf16 tier): the f32
    outputs (boundaries, final state, r, t) and the bf16 streams apart; masked, att
    on receiver rows with a live sender only (no output reads the others). Fails
    unless every stream of ``k`` but r and t is a bf16 tensor."""
    import torch

    from sake_tpu_torch.kernels import resid_ef

    if any(k.resid[n].dtype != torch.bfloat16 for n in resid_ef.RESID_LOWP):
        fail("a bf16-tier forward wrote a low-precision stream in another dtype")

    f32 = [*zip(("bh", "bx", "bv", "h_fin", "x_fin", "v_fin"), k[:6], p[:6]),
           *((n, k.resid[n], p.resid[n]) for n in ("r", "t"))]
    low = [(n, k.resid[n], p.resid[n]) for n in resid_ef.RESIDS
           if n in resid_ef.RESID_LOWP and n != "att"]
    att_k, att_p = k.resid["att"].float(), p.resid["att"].float()
    if mask is not None:
        depth, B, NN, _ = att_k.shape
        N = mask.shape[1]
        live = (mask.reshape(B, N, N).sum(-1) > 0).to(att_k.dtype)
        rows = live[:, :, None].expand(B, N, N).reshape(1, B, NN, 1)
        att_k, att_p = att_k * rows, att_p * rows
    return f32, low + [("att", att_k, att_p)]


def gate_tier(label, pairs, ref32: dict, tol: float, stream_pairs=()) -> float:
    """Each (name, kernel, plain bf16) of ``pairs`` within ``tol`` relative and no
    farther than plain bf16 lies from plain f32 (``ref32[name]``, that distance),
    each bf16 stream of ``stream_pairs`` within BF16_STREAM_TOL;
    prints the line and fails beyond; returns the max absolute error."""
    import torch

    errs = {n: rel_err(a.float(), b.float()) for n, a, b in pairs}
    serr = {n: rel_err(a.float(), b.float()) for n, a, b in stream_pairs}
    finite = all(bool(torch.isfinite(a.float()).all()) for _, a, _ in [*pairs, *stream_pairs])
    w = max(errs, key=errs.get)
    bad = [n for n in errs if errs[n] > tol or errs[n] > ref32[n]]
    bad += [n for n in serr if serr[n] > BF16_STREAM_TOL]
    print(f"BF16 {label}: max rel err {errs[w]:.3e} ({w}; plain bf16 from plain f32 there "
          f"{ref32[w]:.3e}); streams max rel err "
          f"{max(serr.values()) if serr else 0.0:.3e}; finite {finite} "
          + json.dumps({k: [float(f"{v:.2e}"), float(f"{ref32[k]:.2e}")]
                        for k, v in errs.items()}), flush=True)
    if bad or not finite:
        fail(f"bf16 tier {label}: beyond its limits at {bad} (limit {tol}, and plain bf16's "
             f"distance from plain f32; streams {BF16_STREAM_TOL}), or a non-finite value")
    return max(abs_err(a.float(), b.float()) for _, a, b in pairs)


def f64_sums():
    """A context in which every ``@`` and ``torch.matmul`` sums in float64 and
    returns its first operand's dtype: a plain version's operands formed as they
    are, its products' sums as exact as an f64-summing kernel's."""
    import torch
    from torch.overrides import TorchFunctionMode

    mms = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    class F64Sums(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in mms:
                a, b = args
                return torch.matmul(a.double(), b.double()).to(a.dtype)
            return func(*args, **(kwargs or {}))

    return F64Sums()


def widened(fwd):
    """``fwd`` (an ``FwdOut`` of the bf16 tier) with its bf16 streams widened to
    f32 tensors: the plain versions read it in the f32 tier, with f32 products."""
    return fwd._replace(resid={n: v.float() for n, v in fwd.resid.items()})


def plain_tier_ef(params, h, x, bf16: bool, n_heads: int, chunk: int):
    """E and F of ``resid_energy_forces`` through the plain versions of K1 and K2
    on the tensors' device (the card): the plain bf16 tier, or the plain f32."""
    import torch

    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import wide_stack

    leaves = wide_stack(params, n_heads)
    upd = [1.0] * len(params.layers)
    es, fs = [], []
    with torch.no_grad():
        for s in range(0, x.shape[0], chunk):
            xs = x[s : s + chunk].permute(2, 0, 1).contiguous()
            zs = torch.zeros_like(xs)
            fwd = resid_ef.resid_fwd_plain(leaves, embed(params, h[s : s + chunk]), xs, zs, upd,
                                           bf16=bf16)
            e, dh = resid_ef._readout_seed(params, fwd.h_fin, None)
            dx = resid_ef.resid_bwd_plain(leaves, fwd, upd, dh, zs, zs)[1]
            es.append(e)
            fs.append(-dx.permute(1, 2, 0))
    return torch.cat(es), torch.cat(fs)


def bf16_phases(dev, smi) -> list:
    """Phase 25 (see the module docstring); returns its kernel entries."""
    import torch

    from sake_tpu_torch.data.md17 import synthesize_md17
    from sake_tpu_torch.data.qm9 import dimenet_split, load_qm9
    from sake_tpu_torch.kernels import dispatch, resid_ef
    from sake_tpu_torch.kernels.functional import embed, readout
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
    from sake_tpu_torch.tasks import qm9 as task
    from sake_tpu_torch.tasks.md17 import MD17Config, make_model, species_onehot
    from sake_tpu_torch.train import shuffle_batches

    t_phase = time.perf_counter()
    data = synthesize_md17(n_samples=max(BF16_REQUESTS), seed=SEED)
    species = species_onehot(data.z, int(data.z.max()))
    heads, depth = FULL["heads"], FULL["depth"]
    cfg = MD17Config(hidden_features=FULL["hidden"], depth=depth, n_heads=heads)
    model = make_model(cfg, species.shape[-1], device=dev,
                       generator=torch.Generator().manual_seed(SEED))
    model.requires_grad_(False)
    params = model.functional_params()
    leaves = wide_stack(params, heads)
    N = len(data.z)
    tier = dict(edge_matmul_dtype=torch.bfloat16, resid_dtype=torch.bfloat16,
                resid_lowp=dispatch.LOWP_X)

    # -- 25a. K1 and K2 in the tier against plain bf16, B = 37 ---------------------
    rng = np.random.RandomState(SEED + 25)
    Bk = 37
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    x37 = tdev(data.x[:Bk].transpose(2, 0, 1))
    h37 = embed(params, species.to(dev).expand(Bk, N, -1)).contiguous()
    v37 = tdev(0.1 * rng.randn(3, Bk, N))
    upd = [1.0, 0.3, 0.0, 1.0, 1.0, 1.0][:depth]  # the gate at 0 < upd < 1, and off
    nm37 = (np.arange(N)[None] < rng.randint(3, N + 1, size=Bk)[:, None]).astype(np.float32)
    nm37[0] = 0.0
    masks = {"unmasked": None, "masked": tdev((nm37[:, :, None] * nm37[:, None, :])[..., None])}
    cases = [("aspirin", leaves, h37, None), ("aspirin", leaves, h37, "CUDA cores")]
    for hid in (8, 16):
        nmod = make_model(MD17Config(hidden_features=hid, depth=depth, n_heads=heads),
                          species.shape[-1], device=dev,
                          generator=torch.Generator().manual_seed(SEED + hid))
        nmod.requires_grad_(False)
        np_ = nmod.functional_params()
        cases.append((f"hidden {hid}", wide_stack(np_, heads),
                      embed(np_, species.to(dev).expand(Bk, N, -1)).contiguous(), None))
    abs16 = {"resid_fwd": 0.0, "resid_bwd": 0.0}
    for label, m4 in masks.items():
        for model_label, lv, h_in, forced in cases:
            lv_t = transposed(lv)
            sd = (tdev(rng.randn(*h_in.shape)), tdev(rng.randn(3, Bk, N)),
                  tdev(rng.randn(3, Bk, N)))
            before = {c.__name__: dict(c.routes) for c in (resid_ef.resid_fwd, resid_ef.resid_bwd)}
            with torch.no_grad():
                p1 = resid_ef.resid_fwd_plain(lv, h_in, x37, v37, upd, mask=m4, bf16=True)
                p1_32 = resid_ef.resid_fwd_plain(lv, h_in, x37, v37, upd, mask=m4)
                p2 = resid_ef.resid_bwd_plain(lv, p1, upd, *sd, mask=m4)
                p2_32 = resid_ef.resid_bwd_plain(lv, p1_32, upd, *sd, mask=m4)
                p2_w = resid_ef.resid_bwd_plain(lv, widened(p1), upd, *sd, mask=m4)
                if forced:
                    k1 = [resid_ef._launch_fwd(lv, h_in, x37, v37, upd, m4, forced, bf16=True)
                          for _ in range(2)]
                    k2 = [resid_ef._bwd_launch("resid_bwd", lv, p1, upd, *sd, m4, lv_t, False,
                                               route=forced)[:3] for _ in range(2)]
                    k21 = resid_ef._bwd_launch("resid_bwd", lv, k1[0], upd, *sd, m4, lv_t, False,
                                               route=forced)[:3]
                else:
                    k1 = [resid_ef.resid_fwd(lv, h_in, x37, v37, upd, mask=m4, bf16=True)
                          for _ in range(2)]
                    k2 = [resid_ef.resid_bwd(lv, p1, upd, *sd, mask=m4, leaves_t=lv_t)
                          for _ in range(2)]
                    k21 = resid_ef.resid_bwd(lv, k1[0], upd, *sd, mask=m4, leaves_t=lv_t)
                torch.cuda.synchronize()
            took = {c.__name__: {r: c.routes[r] - before[c.__name__][r] for r in c.routes}
                    for c in (resid_ef.resid_fwd, resid_ef.resid_bwd)}
            dims = resid_ef._dims(lv, h_in)
            route = {"resid_fwd": resid_ef.ROUTES[resid_ef.fwd_tensor_core_route(dims)],
                     "resid_bwd": resid_ef.ROUTES[resid_ef.bwd_tensor_core_route(dims)]}
            if not forced and any(n != ((3 if k == "resid_bwd" else 2) if r == route[k] else 0)
                                  for k, t in took.items() for r, n in t.items()):
                fail(f"bf16 K1 / K2 {model_label} {label}: a launch off its route: {took}")
            f32_1, low_1 = tier_pairs(k1[0], p1, m4)
            ref1, _ = tier_pairs(p1, p1_32, m4)
            out1 = lambda k: [*k[:6], *(k.resid[n] for n in resid_ef.RESIDS)]
            bitwise = (all(torch.equal(a, b) for a, b in zip(out1(k1[0]), out1(k1[1])))
                       and all(torch.equal(a, b) for a, b in zip(k2[0], k2[1])))
            on = f"{model_label} {label} on the {forced or route['resid_fwd']}" + (
                " (forced)" if forced else "")
            if not bitwise:
                fail(f"bf16 {on}: a second launch differs from the first")
            d32 = {n: rel_err(b.float(), c.float()) for (n, b, c) in ref1}
            a1 = gate_tier(f"K1 vs plain bf16 {on} (B={Bk}, N={N}, depth {depth}), second launch "
                           "bitwise", f32_1, d32, BF16_TOL, low_1)
            names2 = ("dh", "dx", "dv")
            # K2 on plain's streams: against the distance of the tier's products alone
            # (plain bf16 from f32 products on the same bf16 streams)
            d_mm = {n: rel_err(a, b) for n, a, b in zip(names2, p2, p2_w)}
            a2 = gate_tier(f"K2 vs plain bf16 {on.replace(route['resid_fwd'], route['resid_bwd'])}"
                           " on plain's streams (reference: f32 products on those streams)",
                           [*zip(names2, k2[0], p2)], d_mm, BF16_TOL)
            d32 = {n: rel_err(a, b) for n, a, b in zip(names2, p2, p2_32)}
            gate_tier(f"K2 on K1's streams vs plain bf16 {on}", [*zip(names2, k21, p2)], d32,
                      BF16_TOL)
            if model_label == "aspirin" and not forced:
                abs16["resid_fwd"] = max(abs16["resid_fwd"], a1)
                abs16["resid_bwd"] = max(abs16["resid_bwd"], a2)
            del k1, k2, k21, p1, p1_32, p2, p2_32, p2_w

    # -- 25b. aspirin requests through the dispatch in the tier --------------------
    xs_all = torch.as_tensor(data.x, device=dev)
    h_of = lambda B: species.to(dev).expand(B, N, -1)
    counted = (resid_ef.resid_fwd, resid_ef.resid_bwd)
    for c in counted:
        c.launches = 0
        c.routes = dict.fromkeys(resid_ef.ROUTES, 0)
    answers = {B: dispatch.dispatch_energy_forces(params, h_of(B), xs_all[:B], n_heads=heads,
                                                  **tier)
               for B in BF16_REQUESTS}
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counted}
    routes = {c.__name__: dict(c.routes) for c in counted}
    print(f"BF16 SERVING ROUTES B in {list(BF16_REQUESTS)} (dispatch_energy_forces, "
          f"{json.dumps({k: str(v) for k, v in tier.items() if k != 'resid_lowp'})}): "
          f"launches {json.dumps(launches)}, by route {json.dumps(routes)}", flush=True)
    if min(launches.values()) == 0 or any(
            n != (launches[k] if r == "tensor cores" else 0)
            for k, rs in routes.items() for r, n in rs.items()):
        fail(f"the bf16 serving path did not launch K1 and K2 on their aspirin route: {routes}")
    worst = {}
    for B, (e, f) in answers.items():
        if e.shape != (B,) or f.shape != (B, N, 3) or not (
                torch.isfinite(e).all() and torch.isfinite(f).all()):
            fail(f"bf16 serving B={B}: shapes {tuple(e.shape)} {tuple(f.shape)} or non-finite")
        e_ref, f_ref = chunked_plain_ef(params, species, xs_all[:B], heads, CHECK_CHUNK)
        pe, pf = plain_tier_ef(params, h_of(B), xs_all[:B], True, heads, PATH_CHUNK)
        p_err = rel_err(pf, f_ref)
        gate = max(2e-3, 2 * p_err)
        err = {"f_err": rel_err(f, f_ref), "e_err": rel_err(e, e_ref), "plain_bf16_f_err": p_err,
               "plain_bf16_e_err": rel_err(pe, e_ref), "vs_plain_bf16": rel_err(f, pf),
               "e_vs_plain_bf16": rel_err(e, pe)}
        worst = {k: max(worst.get(k, 0.0), v) for k, v in err.items()}
        print(f"BF16 SLICE B={B} against the plain f32 oracle: "
              + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
              + f" (f_err <= max(2e-3, 2 x plain bf16's) = {gate:.3e}; |kernel - plain bf16| <= "
              "plain bf16's f_err)", flush=True)
        if err["f_err"] > gate or err["vs_plain_bf16"] > p_err:
            fail(f"bf16 serving B={B} beyond its gate")
        del e_ref, f_ref, pe, pf
    del answers

    # -- 25c. K1, K2 and the served path timed in both tiers ------------------------
    xc = xs_all[:PATH_CHUNK].permute(2, 0, 1).contiguous()
    hc = embed(params, h_of(PATH_CHUNK)).contiguous()
    zc = torch.zeros_like(xc)
    u6 = [1.0] * depth
    leaves16 = resid_ef.edge_bf16_leaves(leaves)
    leaves_t16 = transposed(leaves16)
    leaves_t = transposed(leaves)
    with torch.no_grad():
        fwd32 = resid_ef.resid_fwd(leaves, hc, xc, zc, u6)
        fwd16 = resid_ef.resid_fwd(leaves16, hc, xc, zc, u6, bf16=True)
        dh = torch.randn(hc.shape, device=dev, generator=torch.Generator(dev).manual_seed(2))
        runs = {k: [] for k in ("K1 f32", "K1 bf16", "K2 f32", "K2 bf16")}
        timed = {
            "K1 f32": lambda: resid_ef.resid_fwd(leaves, hc, xc, zc, u6),
            "K1 bf16": lambda: resid_ef.resid_fwd(leaves16, hc, xc, zc, u6, bf16=True),
            "K2 f32": lambda: resid_ef.resid_bwd(leaves, fwd32, u6, dh, zc, zc,
                                                 leaves_t=leaves_t),
            "K2 bf16": lambda: resid_ef.resid_bwd(leaves16, fwd16, u6, dh, zc, zc,
                                                  leaves_t=leaves_t16),
        }
        for side in (*timed, *reversed(timed)):
            runs[side].append(cuda_ms(timed[side]))
        t_p1 = cuda_ms(lambda: resid_ef.resid_fwd_plain(leaves, hc, xc, zc, u6, bf16=True))
        t_p2 = cuda_ms(lambda: resid_ef.resid_bwd_plain(leaves, fwd16, u6, dh, zc, zc))
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    stream_mb = {t: nbytes(f.resid) / 2**20 for t, f in (("f32", fwd32), ("bf16", fwd16))}
    print(f"BF16 TIMING per kernel at B={PATH_CHUNK}, depth {depth}, aspirin (ms; the routes "
          f"the shape takes): " + json.dumps({k: round(v, 3) for k, v in ms.items()})
          + f"; plain bf16 K1 {t_p1:.3f}, K2 {t_p2:.3f}; residual streams of the chunk "
          f"{stream_mb['f32']:.2f} MiB f32, {stream_mb['bf16']:.2f} MiB bf16 (runs "
          f"{json.dumps(runs)}; {smi})", flush=True)
    Bt = max(BF16_REQUESTS)
    path = {"f32": lambda: resid_ef.resid_energy_forces(params, h_of(Bt), xs_all[:Bt],
                                                        n_heads=heads),
            "bf16": lambda: resid_ef.resid_energy_forces(params, h_of(Bt), xs_all[:Bt],
                                                         n_heads=heads, **tier)}
    pruns, peak = {k: [] for k in path}, {}
    for side in ("f32", "bf16", "bf16", "f32"):
        pruns[side].append(cuda_ms(path[side]))
    for side, fn in path.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peak[side] = (torch.cuda.max_memory_allocated() - base) / 2**20
        del out
    print(f"BF16 PATH B={Bt} resid_energy_forces (chunk {PATH_CHUNK}): " + "; ".join(
        f"{k} {sum(v) / len(v):.2f} ms = {Bt * 1e3 * len(v) / sum(v):.1f} evals/s, peak device "
        f"memory {peak[k]:.1f} MiB" for k, v in pruns.items())
        + f" (runs {json.dumps(pruns)}; {smi})", flush=True)
    dims21 = (N, FULL["hidden"], FULL["hidden"], 50, heads, 256)
    fma21 = {k: v * PATH_CHUNK * depth for k, v in layer_fma(*dims21).items()}
    edge21 = {k: v * PATH_CHUNK * depth for k, v in edge_fma(N, *dims21[2:]).items()}
    moved1 = nbytes(leaves16, hc, xc, zc, fwd16)
    moved2 = nbytes(leaves16, leaves_t16, fwd16.bh, fwd16.bx, fwd16.bv, fwd16.resid, dh, zc,
                    zc, dh, zc, zc)
    src, at = "sake_tpu_torch/csrc/", "sake_tpu/kernels/resid_ef.py:"
    entries = [
        entry16("resid_fwd_bf16", src + "resid_fwd.cu", at + "1099", launches["resid_fwd"],
                abs16["resid_fwd"], ms["K1 bf16"], t_p1, fma21["fwd"], edge21["fwd"], moved1),
        entry16("resid_bwd_bf16", src + "resid_bwd.cu", at + "1211", launches["resid_bwd"],
                abs16["resid_bwd"], ms["K2 bf16"], t_p2, fma21["bwd"], edge21["bwd"], moved2),
    ]
    print(f"BF16 BOUND per kernel at B={PATH_CHUNK}: K1 {entries[0]['bound_ms']:.4f} ms "
          f"({entries[0]['bound_by']}), K2 {entries[1]['bound_ms']:.4f} ms "
          f"({entries[1]['bound_by']}) (edge products at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s "
          f"in one pass, the rest at {PEAK_F32_FLOPS / 1e12:.0f}, {moved1} and {moved2} bytes "
          f"over {PEAK_BYTES / 1e12:.2f} TB/s)", flush=True)
    del fwd32, fwd16

    # -- 25d. QM9 in the tier: #4, #5, #6 and make_hidden_fn --------------------------
    qcfg = task.QM9Config(use_kernel_backbone=True, data_parallel=False, n_samples=640)
    qdata = load_qm9(None, qcfg.n_samples, seed=qcfg.seed)
    tr_idx, _, _ = dimenet_split(len(qdata.x))
    n_classes = int(qdata.charges.max()) + 1
    train = task.prepare_split(qdata, tr_idx, n_classes, float(qdata.y[tr_idx].mean()),
                               float(qdata.y[tr_idx].std()), dev)
    batch = shuffle_batches(np.random.RandomState(qcfg.seed), train, qcfg.batch_size)[0]
    B, Nq = batch["x"].shape[:2]
    F = qcfg.hidden_features
    qmodel = task.QM9Model(qcfg, n_classes, device=dev,
                           generator=torch.Generator().manual_seed(qcfg.seed))
    kp = task.make_forward(qcfg, qmodel)[0]["kp"]
    kp = type(kp)(*[t.detach() if isinstance(t, torch.Tensor) else t for t in kp])
    kp = kp._replace(layers=tuple(type(lp)(type(lp.edge)(*[t.detach() for t in lp.edge]),
                                           *[t.detach() for t in lp[1:]]) for lp in kp.layers))
    qleaves = wide_stack(kp, qcfg.n_heads)
    qleaves_t = transposed(qleaves)
    qupd = [1.0] * qcfg.depth
    m4 = batch["edge_mask"][..., None].contiguous()
    with torch.no_grad():
        h0 = embed(kp, batch["species"]).contiguous()
        xs = batch["x"].permute(2, 0, 1).contiguous()
        zs = torch.zeros_like(xs)
        dhq = torch.randn(B, Nq, F, device=dev, generator=torch.Generator(dev).manual_seed(3))
        p4 = resid_ef.resid_fwd_plain(qleaves, h0, xs, zs, qupd, mask=m4, bf16=True)
        p4_32 = resid_ef.resid_fwd_plain(qleaves, h0, xs, zs, qupd, mask=m4)
        k4 = [resid_ef.resid_fwd(qleaves, h0, xs, zs, qupd, mask=m4, cluster=True, bf16=True)
              for _ in range(2)]
        k6 = [resid_ef.resid_infer(qleaves, h0, xs, zs, qupd, mask=m4, bf16=True)
              for _ in range(2)]
        p6 = resid_ef.resid_infer_plain(qleaves, h0, xs, zs, qupd, mask=m4, bf16=True)
        p6_32 = resid_ef.resid_infer_plain(qleaves, h0, xs, zs, qupd, mask=m4)
        k5 = [resid_ef.resid_bwd_rows(qleaves, p4, qupd, dhq, zs, zs, mask=m4,
                                      leaves_t=qleaves_t, cluster=True) for _ in range(2)]
        p5 = resid_ef.resid_bwd_rows_plain(qleaves, p4, qupd, dhq, zs, zs, mask=m4)
        p5_32 = resid_ef.resid_bwd_rows_plain(qleaves, p4_32, qupd, dhq, zs, zs, mask=m4)
        p5_w = resid_ef.resid_bwd_plain(qleaves, widened(p4), qupd, dhq, zs, zs, mask=m4)
        kg = [resid_ef.param_grads(qleaves, p4, k5[0][3]) for _ in range(2)]
        with f64_sums():
            pg = resid_ef.param_grads_plain(qleaves, p4, k5[0][3])
        pg_32 = resid_ef.param_grads_plain(qleaves, p4_32, p5_32[3])
        torch.cuda.synchronize()
    out1 = lambda k: [*k[:6], *(k.resid[n] for n in resid_ef.RESIDS)]
    bitwise = {"#4": all(torch.equal(a, b) for a, b in zip(out1(k4[0]), out1(k4[1]))),
               "#6": all(torch.equal(a, b) for a, b in zip(k6[0], k6[1])),
               "#5": all(torch.equal(a, b) for a, b in zip(
                   [*k5[0][:3], *k5[0][3].values()], [*k5[1][:3], *k5[1][3].values()])),
               "param_grads": all(torch.equal(kg[0][n], kg[1][n]) for n in LEAF_NAMES)}
    print(f"BF16 QM9 BITWISE second launch: {json.dumps(bitwise)}", flush=True)
    if not all(bitwise.values()):
        fail("bf16 QM9: a kernel's second launch differs from its first")
    on = f"(B={B}, N={Nq}, depth {qcfg.depth}, masked, the cluster route)"
    f32_4, low_4 = tier_pairs(k4[0], p4, m4)
    ref4, _ = tier_pairs(p4, p4_32, m4)
    abs_q = {"#4": gate_tier(f"QM9 #4 vs plain bf16 {on}", f32_4,
                             {n: rel_err(b.float(), c.float()) for n, b, c in ref4}, BF16_TOL,
                             low_4)}
    abs_q["#6"] = gate_tier(f"QM9 #6 vs plain bf16 {on}", [*zip(("h_fin", "x_fin"), k6[0], p6)],
                            {n: rel_err(a, b) for n, a, b in zip(("h_fin", "x_fin"), p6, p6_32)},
                            BF16_TOL)
    names5 = ("dh", "dx", "dv")
    abs_q["#5"] = gate_tier(f"QM9 #5 rows kernel vs plain bf16 {on} (dh, dx, dv; reference: "
                            "f32 products on the same streams)",
                            [*zip(names5, k5[0][:3], p5[:3])],
                            {n: rel_err(a, b) for n, a, b in zip(names5, p5[:3], p5_w)},
                            BF16_TOL)
    gpairs = [(f"{n}[{l}]", kg[0][n][l], pg[n][l]) for n in LEAF_NAMES for l in range(qcfg.depth)]
    gref = {f"{n}[{l}]": rel_err(pg[n][l], pg_32[n][l]) for n in LEAF_NAMES
            for l in range(qcfg.depth)}
    abs_q["param_grads"] = gate_tier(f"QM9 param_grads vs plain bf16 on the kernel's rows, its "
                                     f"sums in float64 {on}", gpairs, gref, BF16_CONTRACT_TOL)
    del k4, k6, k5, kg, p5, p5_32, p5_w, pg, pg_32, p6, p6_32

    # make_hidden_fn in the tier, launches counted from 0: h_fin and every leaf's
    # gradient of a weighted readout loss against the plain bf16 stack on the card
    w = torch.randn(B, device=dev, generator=torch.Generator(dev).manual_seed(4))
    nmask = batch["node_mask"]
    cl = (resid_ef.resid_fwd, resid_ef.resid_bwd_rows)
    others = (resid_ef.resid_infer, resid_ef.param_grads, resid_ef.resid_bwd)
    for c in (*cl, *others):
        c.launches = 0
    for c in cl:
        c.cluster_launches = 0
    hidden = resid_ef.make_hidden_fn(n_heads=qcfg.n_heads, **tier)
    flat = [t.detach().clone().requires_grad_(True) for t in resid_ef.flat_params(kp)]
    kpg = resid_ef._unflat_params(flat, qcfg.depth)
    hf = hidden(kpg, batch["species"], batch["x"], batch["edge_mask"])
    loss = ((readout(kpg, hf)[..., 0] * nmask).sum(-1) * w).sum()
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    with torch.no_grad():
        hf_eval = hidden(kp, batch["species"], batch["x"], batch["edge_mask"])
    torch.cuda.synchronize()
    qlaunch = {"resid_fwd (cluster)": resid_ef.resid_fwd.cluster_launches,
               "resid_bwd_rows (cluster)": resid_ef.resid_bwd_rows.cluster_launches,
               **{c.__name__: c.launches for c in (*cl, *others)}}
    print(f"BF16 QM9 make_hidden_fn launches {json.dumps(qlaunch)}", flush=True)
    if (qlaunch["resid_fwd (cluster)"], qlaunch["resid_bwd_rows (cluster)"],
            qlaunch["param_grads"], qlaunch["resid_infer"]) != (1, 1, 1, 1) or (
            qlaunch["resid_fwd"] or qlaunch["resid_bwd_rows"] or qlaunch["resid_bwd"]):
        fail(f"bf16 make_hidden_fn did not launch #4, #5, the contraction and #6 once each on "
             f"their routes: {qlaunch}")

    def plain_hidden(bf16):
        """h_fin and the gradient of every flat leaf through the plain stack."""
        with torch.no_grad():
            fwd = resid_ef.resid_fwd_plain(qleaves, h0, xs, zs, qupd, mask=m4, bf16=bf16)
        hfp = fwd.h_fin.detach().requires_grad_(True)
        lp_ = ((readout(kp, hfp)[..., 0] * nmask).sum(-1) * w).sum()
        (dhf,) = torch.autograd.grad(lp_, hfp)
        with torch.no_grad():
            dh0, _, _, rows = resid_ef.resid_bwd_rows_plain(qleaves, fwd, qupd, dhf, zs, zs,
                                                            mask=m4)
            g = resid_ef.param_grads_plain(qleaves, fwd, rows)
            h2 = batch["species"].reshape(B * Nq, -1)
            dh2 = dh0.reshape(B * Nq, F)
            out = [h2.T @ dh2, dh2.sum(0)]
            for l in range(qcfg.depth):
                lpg = resid_ef.unsplit_layer_grads({n: g[n][l] for n in LEAF_NAMES})
                out += [*lpg.edge, *lpg[1:]]
        return fwd.h_fin, out

    hp, gp = plain_hidden(True)
    hp32, gp32 = plain_hidden(False)
    gate_tier(f"QM9 make_hidden_fn h_fin vs plain bf16 {on}", [("h_fin", hf.detach(), hp),
                                                               ("h_fin eval", hf_eval, hp)],
              {"h_fin": rel_err(hp, hp32), "h_fin eval": rel_err(hp, hp32)}, BF16_TOL)
    n_layer = len(gp)
    gpairs = [(f"leaf {i}", got[i], gp[i]) for i in range(n_layer)]
    gate_tier(f"QM9 make_hidden_fn gradient of every leaf vs plain bf16 {on}", gpairs,
              {f"leaf {i}": rel_err(gp[i], gp32[i]) for i in range(n_layer)}, BF16_GRAD_TOL)
    del hf, got, hf_eval, hp, gp, hp32, gp32

    # timing, both tiers, and the entries
    with torch.no_grad():
        q16 = resid_ef.edge_bf16_leaves(qleaves)
        rows16 = resid_ef.resid_bwd_rows(q16, p4, qupd, dhq, zs, zs, mask=m4, cluster=True)[3]
        rows32 = resid_ef.resid_bwd_rows(qleaves, p4_32, qupd, dhq, zs, zs, mask=m4,
                                         cluster=True)[3]
        tq = {
            "#4": (lambda: resid_ef.resid_fwd(qleaves, h0, xs, zs, qupd, m4, cluster=True),
                   lambda: resid_ef.resid_fwd(q16, h0, xs, zs, qupd, m4, cluster=True,
                                              bf16=True),
                   lambda: resid_ef.resid_fwd_plain(qleaves, h0, xs, zs, qupd, m4, bf16=True)),
            "#6": (lambda: resid_ef.resid_infer(qleaves, h0, xs, zs, qupd, m4),
                   lambda: resid_ef.resid_infer(q16, h0, xs, zs, qupd, m4, bf16=True),
                   lambda: resid_ef.resid_infer_plain(qleaves, h0, xs, zs, qupd, m4, bf16=True)),
            "#5 rows": (lambda: resid_ef.resid_bwd_rows(qleaves, p4_32, qupd, dhq, zs, zs, m4,
                                                        cluster=True),
                        lambda: resid_ef.resid_bwd_rows(q16, p4, qupd, dhq, zs, zs, m4,
                                                        cluster=True),
                        lambda: resid_ef.resid_bwd_rows_plain(qleaves, p4, qupd, dhq, zs, zs,
                                                              m4)),
            "param_grads": (lambda: resid_ef.param_grads(qleaves, p4_32, rows32),
                            lambda: resid_ef.param_grads(qleaves, p4, rows16),
                            lambda: resid_ef.param_grads_plain(qleaves, p4, rows16)),
        }
        qt = {}
        for k, (f32_fn, bf_fn, plain_fn) in tq.items():
            a, b_ = [], []
            for side in ("f32", "bf16", "bf16", "f32"):
                (a if side == "f32" else b_).append(cuda_ms(f32_fn if side == "f32" else bf_fn))
            qt[k] = (sum(a) / 2, sum(b_) / 2, cuda_ms(plain_fn, reps=1))
        grads16 = resid_ef.param_grads(qleaves, p4, rows16)
    print(f"BF16 QM9 TIMING per kernel (ms: f32, bf16, plain bf16) {on}: "
          + json.dumps({k: [round(x, 3) for x in v] for k, v in qt.items()}) + f" ({smi})",
          flush=True)
    fmaq = {k: v * B * qcfg.depth for k, v in layer_fma(Nq, F, F, 50, qcfg.n_heads, 256).items()}
    edgeq = {k: v * B * qcfg.depth for k, v in edge_fma(Nq, F, 50, qcfg.n_heads, 256).items()}
    inq = (q16, h0, xs, zs, m4)
    entries += [
        entry16("resid_fwd_masked_bf16", src + "resid_fwd.cu", at + "1484",
                qlaunch["resid_fwd (cluster)"], abs_q["#4"], qt["#4"][1], qt["#4"][2],
                fmaq["fwd"], edgeq["fwd"], nbytes(inq, p4)),
        entry16("resid_infer_bf16", src + "resid_fwd.cu", at + "1732", qlaunch["resid_infer"],
                abs_q["#6"], qt["#6"][1], qt["#6"][2], fmaq["fwd"], edgeq["fwd"],
                nbytes(inq, p4.h_fin, p4.x_fin)),
        entry16("resid_bwd_rows_bf16", src + "resid_bwd_cl.cu", at + "1598",
                qlaunch["resid_bwd_rows (cluster)"], abs_q["#5"], qt["#5 rows"][1],
                qt["#5 rows"][2], fmaq["bwd"], edgeq["bwd"],
                nbytes(q16, transposed(q16), p4.bh, p4.bx, p4.bv, p4.resid, m4, dhq, zs, zs,
                       dhq, zs, zs, rows16)),
        entry16("param_grads_bf16", src + "param_grads.cu", at + "1598", qlaunch["param_grads"],
                abs_q["param_grads"], qt["param_grads"][1], qt["param_grads"][2],
                fmaq["grads"], edgeq["grads"],
                nbytes(qleaves, p4.bh, grads_streams(p4.resid), rows16, grads16)),
    ]
    print(f"BF16 PHASE {time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries


def tier_dist(got, want) -> tuple:
    """``(rms, max)`` distance of ``got`` from ``want``: ||got - want|| / ||want||
    and max |got - want| / max |want|, and the share of elements that differ by
    more than 1e-5 of max |want|."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return (float(d.norm() / (w.norm() + 1e-30)), float(d.max() / (w.max() + 1e-30)),
            float((d > 1e-5 * w.max()).float().mean()))


def gate_widened(label, pairs, ref: dict, floor: float) -> float:
    """Each (name, kernel, plain bf16) of ``pairs`` no farther from plain bf16, in
    the root-mean-square norm, than ``TIER16_SHARE`` of the distance plain bf16 lies
    from the f32 tier on the same inputs (``ref[name]``, that ``tier_dist``; the
    ``widened`` rule), or of ``floor`` (TRAIN_TOL: the f32 kernels' limit) where the
    tier moves a tensor less; and no element farther than ``BF16_STREAM_TOL`` of
    the tensor's max (a flipped rounding moves an element by about one bf16 step of
    an operand).
    Kernel and plain round an operand the other way where their sums, in other
    orders, straddle a bf16 midpoint; such a flip moves a few elements by about
    the tier's own rounding there, so the maximum, unlike the norm, can exceed
    the tier's distance. Prints the line and fails beyond; returns the max
    absolute error."""
    import torch

    errs = {n: tier_dist(a, b) for n, a, b in pairs}
    finite = all(bool(torch.isfinite(a.float()).all()) for _, a, _ in pairs)
    share = {n: errs[n][0] / max(ref[n][0], floor) for n in errs}
    w = max(share, key=share.get)
    m = max(errs, key=lambda n: errs[n][1])
    print(f"BF16 TRAIN {label}: largest share of plain bf16's distance {share[w]:.3f} (limit "
          f"{TIER16_SHARE}; {w}: rms {errs[w][0]:.3e} from plain bf16, which lies "
          f"{ref[w][0]:.3e} from f32; floor {floor:.0e}); max rel "
          f"err {errs[m][1]:.3e} ({m}, plain bf16 {ref[m][1]:.3e} from f32; limit "
          f"{BF16_STREAM_TOL:.3e}), {errs[m][2]:.2%} of its elements moved; finite {finite}",
          flush=True)
    if share[w] > TIER16_SHARE or errs[m][1] > BF16_STREAM_TOL or not finite:
        fail(f"bf16 tier {label}: {w} or {m} beyond its limits, or a non-finite value")
    return max(abs_err(a.float(), b.float()) for _, a, b in pairs)


def block_outputs(o) -> list:
    """#12's block outputs ``(dh0, dx0, tfwd, rows, rows_t, t_rows, ro_part)`` as
    named tensors (the tangent streams widened)."""
    return [("dh0", o[0]), ("dx0", o[1]), ("ro_part", o[6]),
            *zip(("tbh", "tbx", "tbv"), o[2][:3]),
            *((f"t.{n}", v.float()) for n, v in o[2].resid.items()),
            *((f"{k}.{n}", o[i][n]) for i, k in ((3, "rows"), (4, "rows_t"), (5, "t_rows"))
              for n in o[i])]


def train16_phases(dev, smi) -> list:
    """Phase 26 (see the module docstring); returns its kernel entries."""
    import contextlib
    import functools

    import torch

    from sake_tpu_torch.data.md17 import load_md17
    from sake_tpu_torch.kernels import resid_ef
    from sake_tpu_torch.kernels import train2_ef as t2
    from sake_tpu_torch.kernels.functional import embed
    from sake_tpu_torch.kernels.leaves import LEAF_NAMES, transposed, wide_stack
    from sake_tpu_torch.tasks import md17 as task
    from sake_tpu_torch.train import (
        TrainState,
        make_optimizer,
        shuffle_batches,
        warmup_cosine_schedule,
    )

    t_phase = time.perf_counter()
    cfg = task.MD17Config(use_kernel_ef=True, aug_mode="fused")
    data = load_md17(cfg.molecule, None, n_samples=max(cfg.n_train, max(TRAIN_BATCHES)))
    species = task.species_onehot(data.z, int(data.z.max()))
    e_mean, e_std = float(data.e[:cfg.n_train].mean()), float(data.e[:cfg.n_train].std())
    N, F, depth, heads = len(data.z), cfg.hidden_features, cfg.depth, cfg.n_heads
    tdev = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    train = {"x": tdev(data.x), "e": tdev(data.e), "f": tdev(data.f)}
    tier = dict(edge_matmul_dtype=torch.bfloat16, resid_dtype=torch.bfloat16)
    model = task.make_model(cfg, species.shape[-1], device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    fused3 = (t2.fused_primal, t2.fused_bwd_block, t2.fused_bwd_grads)

    def branch(tier_kw):
        """The task's kernel branch (``make_branch``: its colouring, its
        parameters) with ``make_ef_train2`` built with ``tier_kw``."""
        real = task.make_ef_train2
        task.make_ef_train2 = functools.partial(real, **tier_kw)
        try:
            prm, ef_fn, _ = task.make_branch(cfg, model, species, e_mean, e_std)
        finally:
            task.make_ef_train2 = real
        return dict(params=prm, ef=ef_fn)

    @contextlib.contextmanager
    def plain_fused():
        """The fused mode on the card through #11's and #12's plain versions."""
        saved = t2._fused_primal, t2.fused_bwd
        t2._fused_primal = (lambda prm, lv, h0, xs, upd, *, leaves_t=None, bf16=False:
                            t2.fused_primal_plain(prm, lv, h0, xs, upd, bf16=bf16))
        t2.fused_bwd = (lambda prm, lv, fwd, upd, tx0, g_e, *, leaves_t=None:
                        t2.fused_bwd_plain(prm, lv, fwd, upd, tx0, g_e))
        try:
            yield
        finally:
            t2._fused_primal, t2.fused_bwd = saved

    kp = branch({})["params"]
    kp = type(kp)(*[t.detach() if isinstance(t, torch.Tensor) else t for t in kp])
    kp = kp._replace(layers=tuple(type(lp)(type(lp.edge)(*[t.detach() for t in lp.edge]),
                                           *[t.detach() for t in lp[1:]]) for lp in kp.layers))
    leaves = wide_stack(kp, heads)
    leaves_t = transposed(leaves)
    upd = [1.0] * depth
    gen = torch.Generator(dev).manual_seed(26)

    # -- 26a. #11, #12's block and #12's contraction in the tier against plain bf16 --
    abs16 = dict.fromkeys(("fused_primal", "fused_bwd_block", "fused_bwd_grads"), 0.0)
    for B in TRAIN_BATCHES:
        on = f"(B={B}, N={N}, depth {depth}, aspirin)"
        with torch.no_grad():
            h0 = embed(kp, species.to(dev).expand(B, N, -1)).contiguous()
            xs = train["x"][:B].permute(2, 0, 1).contiguous()
            tx0 = torch.randn(3, B, N, device=dev, generator=gen)
            g_e = torch.randn(B, device=dev, generator=gen)
            k11 = [t2.fused_primal(kp, leaves, h0, xs, upd, leaves_t=leaves_t, bf16=True)
                   for _ in range(2)]
            p11 = t2.fused_primal_plain(kp, leaves, h0, xs, upd, bf16=True)
            p11_32 = t2.fused_primal_plain(kp, leaves, h0, xs, upd)
            torch.cuda.synchronize()
        out11 = lambda k: [*k[0][:6], *(k[0].resid[n] for n in resid_ef.RESIDS), k[1], k[2]]
        if not all(torch.equal(a, b) for a, b in zip(out11(k11[0]), out11(k11[1]))):
            fail(f"bf16 #11 {on}: a second launch differs from the first")
        f32_11, low_11 = tier_pairs(k11[0][0], p11[0])
        ref11, _ = tier_pairs(p11[0], p11_32[0])
        ref11 = {n: tier_dist(b, c) for n, b, c in ref11}
        a11 = gate_widened(f"#11 fused_primal (csrc/fused_ef16.cu) vs plain bf16 {on}, second "
                           "launch bitwise: boundaries, final state, r, t, the E plane",
                           [*f32_11, ("e", k11[0][1], p11[1])],
                           {**ref11, "e": tier_dist(p11[1], p11_32[1])}, TRAIN_TOL)
        serr = {n: rel_err(a.float(), b.float()) for n, a, b in low_11}
        f_err, p_err = rel_err(k11[0][2], p11_32[2]), rel_err(p11[2], p11_32[2])
        gate = max(2e-3, 2 * p_err)
        print(f"BF16 TRAIN #11 {on}: F f_err {f_err:.3e} against the plain f32 primal (limit "
              f"max(2e-3, 2 x plain bf16's {p_err:.3e}) = {gate:.3e}), {rel_err(k11[0][2], p11[2]):.3e}"
              f" from plain bf16; bf16 streams max rel err {max(serr.values()):.3e} (limit "
              f"{BF16_STREAM_TOL:.3e}) " + json.dumps({k: float(f"{v:.2e}") for k, v in serr.items()}),
              flush=True)
        if f_err > gate or max(serr.values()) > BF16_STREAM_TOL or not torch.isfinite(k11[0][2]).all():
            fail(f"bf16 #11 {on}: forces or streams beyond their limits")
        abs16["fused_primal"] = max(abs16["fused_primal"], a11, abs_err(k11[0][2], p11[2]))
        del k11, p11_32, f32_11, low_11

        # #12's block on the plain bf16 primal's streams
        fwd = p11[0]
        with torch.no_grad():
            kb = [t2.fused_bwd_block(kp, leaves, fwd, upd, tx0, g_e, leaves_t=leaves_t)
                  for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for (_, a), (_, b) in zip(block_outputs(kb[0]),
                                                                  block_outputs(kb[1]))):
                fail(f"bf16 #12 block {on}: a second launch differs from the first")
            kb = kb[0]
            if any(kb[2].resid[n].dtype != torch.bfloat16 for n in resid_ef.RESID_LOWP):
                fail("bf16 #12 block wrote a low-precision tangent stream in another dtype")
            pb = t2.fused_bwd_block_plain(kp, leaves, fwd, upd, tx0, g_e)
            pb_w = t2.fused_bwd_block_plain(kp, leaves, widened(fwd), upd, tx0, g_e)
            torch.cuda.synchronize()
        ref = {n: tier_dist(a, b) for (n, a), (_, b) in zip(block_outputs(pb),
                                                             block_outputs(pb_w))}
        del pb_w
        pairs = [(n, a, b) for (n, a), (_, b) in zip(block_outputs(kb), block_outputs(pb))]
        abs16["fused_bwd_block"] = max(abs16["fused_bwd_block"], gate_widened(
            f"#12 block (csrc/fused_bwd16.cu) vs plain bf16 on plain's primal streams {on}, "
            "second launch bitwise: dh0, dx0, the readout partials, the tangent streams, "
            "every row (reference: the f32 tier on the same streams)", pairs, ref, TRAIN_TOL))
        del pb, pairs

        # #12's contraction on the block's streams and rows, against plain with f64 sums
        with torch.no_grad():
            kg = [t2.fused_bwd_grads(kp, leaves, fwd, *kb[2:]) for _ in range(2)]
            with f64_sums():
                pg = t2.param_grads_aug_plain(leaves, fwd, *kb[2:6])
                # the f32 tier's products on the same streams and rows
                pg_w = t2.param_grads_aug_plain(leaves, widened(fwd), widened(kb[2]), *kb[3:6])
            ro_want = kb[6].double().sum(dim=0).float()
            torch.cuda.synchronize()
        if not (all(torch.equal(kg[0][0][n], kg[1][0][n]) for n in LEAF_NAMES)
                and all(torch.equal(a, b) for a, b in zip(kg[0][1], kg[1][1]))):
            fail(f"bf16 #12 contraction {on}: a second launch differs from the first")
        gerr = {f"{n}[{l}]": rel_err(kg[0][0][n][l], pg[n][l]) for n in LEAF_NAMES
                for l in range(depth)}
        gerr["readout"] = rel_err(torch.cat([a.reshape(-1) for a in kg[0][1]]), ro_want)
        limit = dict.fromkeys(gerr, BF16_CONTRACT_TOL)
        share = {}
        for n in resid_ef.EDGE_MM_LEAVES:
            for l in range(depth):
                d = rel_err(pg[n][l], pg_w[n][l])
                share[f"{n}[{l}]"] = gerr[f"{n}[{l}]"] / d
                limit[f"{n}[{l}]"] = max(BF16_CONTRACT_TOL, BF16_FLIP_SHARE * d)
        w = max(gerr, key=lambda k: gerr[k] / limit[k])
        o = max((k for k in gerr if k not in share), key=gerr.get)
        e = max(share, key=share.get)
        print(f"BF16 TRAIN #12 contraction (sake_param_grads_aug16) vs plain on the block's "
              f"streams and rows, its sums in float64 {on}, second launch bitwise: nearest its "
              f"limit {w} {gerr[w]:.3e} (limit {limit[w]:.3e}); the other leaves max rel err "
              f"{gerr[o]:.3e} ({o}; limit {BF16_CONTRACT_TOL:.0e}); the four edge leaves at most "
              f"{share[e]:.3e} of the tier's own distance ({e}: {gerr[e]:.3e}; limit "
              f"{BF16_FLIP_SHARE} of it, or {BF16_CONTRACT_TOL:.0e}) "
              + json.dumps({k: float(f"{v:.2e}") for k, v in share.items()}), flush=True)
        if gerr[w] > limit[w]:
            fail(f"bf16 #12 contraction {on}: {w} beyond its limit")
        abs16["fused_bwd_grads"] = max(abs16["fused_bwd_grads"], max(
            abs_err(kg[0][0][n], pg[n]) for n in LEAF_NAMES))
        del kg, pg, pg_w, kb, fwd, p11, h0, xs, tx0, g_e

    # -- 26b. one step of the tier's fused branch through the task ------------------
    batches = shuffle_batches(np.random.RandomState(cfg.seed),
                              {k: v[:cfg.n_train] for k, v in train.items()}, cfg.batch_size)
    weight = cfg.energy_loss_weight
    loss16, g16 = md17_loss_and_grads(branch(tier), batches[0], weight)
    loss32, g32 = md17_loss_and_grads(branch({}), batches[0], weight)
    with plain_fused():
        lossp, gp = md17_loss_and_grads(branch(tier), batches[0], weight)
    # a step at depth 6 sits downstream of every layer's roundings: once one flips, the
    # operands after it round apart too, so kernel and plain bf16 differ by about the
    # tier's own distance (on an H100: b_vel0 of layer 4 at 0.999 of it in the norm; layer
    # 4's b_sem, a sum that cancels, 1.5e-2 at its largest element); the step is held
    # to twice that distance in the norm, and to lie as far from the f32 branch as plain
    # bf16 does (the median share, at least STEP16_FAR_MIN), which a step that skipped
    # the tier's roundings would not
    names = ["loss", *(f"leaf {i}" for i in range(len(g16)))]
    kern, plain, f32 = [loss16, *g16], [lossp, *gp], [loss32, *g32]
    dist = {n: (tier_dist(a, b), tier_dist(b, c), tier_dist(a, c))
            for n, a, b, c in zip(names, kern, plain, f32)}
    share = {n: e[0] / max(d[0], TRAIN_TOL) for n, (e, d, _) in dist.items()}
    w = max(share, key=share.get)
    far = [dk[0] / d[0] for e, d, dk in dist.values() if d[0] >= TRAIN_TOL]
    finite = all(bool(torch.isfinite(a).all()) for a in kern)
    print(f"BF16 TRAIN step 1 of the fused branch in the tier (B={cfg.batch_size}, task "
          f"colouring) vs its plain bf16 path, the loss and every leaf's gradient: largest share "
          f"of plain bf16's distance from the f32 fused branch {share[w]:.3f} ({w}: rms "
          f"{dist[w][0][0]:.3e} against {dist[w][1][0]:.3e}; limit {STEP16_SHARE}, floor "
          f"{TRAIN_TOL:.0e}), max rel err there {dist[w][0][1]:.3e}; the kernel step from the f32 "
          f"branch, as a share of plain bf16's distance, median {float(np.median(far)):.3f} "
          f"(limit at least {STEP16_FAR_MIN}; range {min(far):.3f}-{max(far):.3f}); finite "
          f"{finite}", flush=True)
    if share[w] > STEP16_SHARE or float(np.median(far)) < STEP16_FAR_MIN or not finite:
        fail(f"bf16 tier step 1: {w} beyond {STEP16_SHARE} x plain bf16's distance, the step "
             f"nearer the f32 branch than {STEP16_FAR_MIN} of plain bf16's distance, or a "
             "non-finite value")
    d32 = [rel_err(a, b) for a, b in zip(g16, g32)]
    print(f"BF16 TRAIN step 1 in the tier vs the f32 fused branch: loss {float(loss16):.7f} vs "
          f"{float(loss32):.7f} (rel {rel_err(loss16, loss32):.2e}); gradients max rel "
          f"{max(d32):.3e} (leaf {int(np.argmax(d32))}), median {float(np.median(d32)):.3e}",
          flush=True)
    del g16, g32, gp

    # -- 26c. a short training run in the tier, launches counted from 0 ------------
    br = branch(tier)
    state = TrainState.create(params=br["params"], tx=make_optimizer(
        warmup_cosine_schedule(cfg.learning_rate, TRAIN16_STEPS)))
    step = task.make_step_fn(br["ef"], weight)
    for c in dense_counters():
        c.launches = 0
    for c in fused3:
        c.tiers = dict.fromkeys(t2.TIERS, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b_ in batches[:TRAIN16_STEPS]:
        state, loss = step(state, b_)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(losses).cpu()
    launches = {c.__name__: c.launches for c in dense_counters() if c.launches}
    tiers = {c.__name__: dict(c.tiers) for c in fused3}
    print(f"BF16 TRAIN RUN {len(losses)} steps of the fused branch in the tier at B="
          f"{cfg.batch_size} in {wall:.2f} s: launches {json.dumps(launches)}, by tier "
          f"{json.dumps(tiers)}; loss first {float(losses[0]):.6f} last {float(losses[-1]):.6f} "
          f"(means of the first and last 20 steps {float(losses[:20].mean()):.6f} "
          f"{float(losses[-20:].mean()):.6f})", flush=True)
    n = len(losses)
    if launches != {c.__name__: n for c in fused3} or any(
            t != {"f32": 0, "bf16": n} for t in tiers.values()):
        fail("the tier's training run launched other kernels than #11, #12's block and "
             "#12's contraction in the tier")
    if not (torch.isfinite(losses).all() and losses[-20:].mean() < losses[:20].mean()):
        fail("the tier's training loss is not finite or did not fall")
    run_launches = {c.__name__: c.launches for c in fused3}
    del br, state, step

    # -- 26d. timing: each kernel and the fused step in both tiers, in turns ---------
    src, at = "sake_tpu_torch/csrc/", "sake_tpu/kernels/train2_ef.py:"
    dims = (N, F, F, 50, heads, 256)
    entries = []
    for B in TRAIN_BATCHES:
        with torch.no_grad():
            h0 = embed(kp, species.to(dev).expand(B, N, -1)).contiguous()
            xs = train["x"][:B].permute(2, 0, 1).contiguous()
            tx0 = torch.randn(3, B, N, device=dev, generator=gen)
            g_e = torch.randn(B, device=dev, generator=gen)
            prim = {b: t2.fused_primal(kp, leaves, h0, xs, upd, leaves_t=leaves_t, bf16=b)
                    for b in (False, True)}
            blk = {b: t2.fused_bwd_block(kp, leaves, prim[b][0], upd, tx0, g_e,
                                         leaves_t=leaves_t) for b in (False, True)}
            fns = {}
            for b, side in ((False, "f32"), (True, "bf16")):
                fns[("fused_primal", side)] = functools.partial(
                    t2.fused_primal, kp, leaves, h0, xs, upd, leaves_t=leaves_t, bf16=b)
                fns[("fused_bwd_block", side)] = functools.partial(
                    t2.fused_bwd_block, kp, leaves, prim[b][0], upd, tx0, g_e,
                    leaves_t=leaves_t)
                fns[("fused_bwd_grads", side)] = functools.partial(
                    t2.fused_bwd_grads, kp, leaves, prim[b][0], *blk[b][2:])
            runs = {k: [] for k in fns}
            for _ in range(TRAIN16_ROUNDS):
                for side in ("f32", "bf16", "bf16", "f32"):
                    for name in ("fused_primal", "fused_bwd_block", "fused_bwd_grads"):
                        runs[(name, side)].append(cuda_ms(fns[(name, side)]))
            fwd16 = prim[True][0]

            def grads_plain():
                with f64_sums():
                    return t2.param_grads_aug_plain(leaves, fwd16, *blk[True][2:6])

            plain = {"fused_primal": cuda_ms(lambda: t2.fused_primal_plain(
                         kp, leaves, h0, xs, upd, bf16=True), reps=1),
                     "fused_bwd_block": cuda_ms(lambda: t2.fused_bwd_block_plain(
                         kp, leaves, fwd16, upd, tx0, g_e), reps=1),
                     "fused_bwd_grads": cuda_ms(grads_plain, reps=1)}
        stat = {f"{k[0]} {k[1]}": (float(np.mean(v)), float(np.std(v))) for k, v in runs.items()}
        print(f"BF16 TRAIN TIMING per kernel at B={B}, N={N}, depth {depth} (ms, mean and "
              f"standard deviation of {len(next(iter(runs.values())))} runs, f32 and bf16 in "
              f"turns; {smi}): " + json.dumps({k: [round(m, 3), round(sd, 3)]
                                                for k, (m, sd) in stat.items()})
              + "; plain bf16 " + json.dumps({k: round(v, 3) for k, v in plain.items()}),
              flush=True)

        # the fused step in both tiers, in turns, and its peak device memory
        batch = ({k: v[:B] for k, v in train.items()} if B > cfg.batch_size else batches[0])
        steps = {}
        for side, kw in (("f32", {}), ("bf16", tier)):
            b_ = branch(kw)
            st = TrainState.create(params=b_["params"], tx=make_optimizer(
                warmup_cosine_schedule(cfg.learning_rate, 1000)))
            steps[side] = functools.partial(task.make_step_fn(b_["ef"], weight), st, batch)
        sruns = {k: [] for k in steps}
        for _ in range(TRAIN16_ROUNDS):
            for side in ("f32", "bf16", "bf16", "f32"):
                sruns[side].append(cuda_ms(steps[side]))
        peak = {}
        for side, fn in steps.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak[side] = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"BF16 TRAIN STEP at B={B} (make_step_fn, fused mode; ms, mean and standard "
              f"deviation, in turns; {smi}): " + "; ".join(
                  f"{k} {np.mean(v):.3f} +- {np.std(v):.3f} ms, peak device memory "
                  f"{peak[k]:.1f} MiB" for k, v in sruns.items()), flush=True)
        del steps

        fma = {k: v * B * depth for k, v in layer_fma(*dims).items()}
        one = edge_fma(N, *dims[2:])["fwd"] * B * depth
        lv16 = resid_ef.edge_bf16_leaves(leaves)
        moved = {
            "fused_primal": nbytes(lv16, transposed(lv16), h0, xs, prim[True]),
            "fused_bwd_block": nbytes(lv16, transposed(lv16), fwd16, tx0, g_e, blk[True]),
            # the streams the loaders read, the rows, the readout partials, the gradients
            "fused_bwd_grads": nbytes(leaves, fwd16.bh, blk[True][2].bh,
                                      grads_streams(fwd16.resid),
                                      grads_streams(blk[True][2].resid), *blk[True][3:7],
                                      fns[("fused_bwd_grads", "bf16")]()),
        }
        ops = {"fused_primal": (fma["fwd"] + fma["bwd"], 2 * one),
               "fused_bwd_block": (fma["jvp"] + fma["tbwd"] + fma["bwd"], 4 * one),
               "fused_bwd_grads": (fma["grads_aug"], 2 * one)}
        where = {"fused_primal": ("fused_ef16.cu", "1239"),
                 "fused_bwd_block": ("fused_bwd16.cu", "1750"),
                 "fused_bwd_grads": ("param_grads.cu", "1750")}
        at_b = [entry16(f"{k}_bf16", src + where[k][0], at + where[k][1], run_launches[k],
                        abs16[k], stat[f"{k} bf16"][0], plain[k], *ops[k], moved[k])
                for k in where]
        print(f"BF16 TRAIN BOUND per kernel at B={B}: " + json.dumps(
            {e["name"]: [round(e["bound_ms"], 4), e["bound_by"]] for e in at_b})
            + f" (edge products at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s in one pass, the "
            f"rest at {PEAK_F32_FLOPS / 1e12:.0f}, bytes over {PEAK_BYTES / 1e12:.2f} TB/s, "
            "the bf16 streams at 2 bytes)", flush=True)
        if B == max(TRAIN_BATCHES):  # the entries carry B = 512
            entries = at_b
        del prim, blk, fns, h0, xs, tx0, g_e, fwd16, lv16, at_b
    print(f"BF16 TRAIN PHASE {time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries


if __name__ == "__main__":
    sys.exit(main())
