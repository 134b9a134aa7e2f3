#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ideepcolor_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA Hopper card
(the kernels are built for sm_90a) and the CUDA toolkit. Phases, one line
or more each; any failure exits non-zero:

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as nvidia-smi reports them;
2. build: the three kernel sources of ideepcolor_tpu_torch/csrc (K1's
   library exports the by-value entry and the batched, device-count entry;
   K2's the compose, the fused click entry and the batched compose; K3's
   the global statistics), one nvcc each, in parallel, timed; then the
   native host runtime (ideepcolor_tpu_torch/native/hostops.cpp, g++ -O3
   -march=native -fopenmp; it must build: every click's hint mirrors need
   it), its build seconds, its OpenMP threads and its first window compose
   timed;
3. K1 (hint rasterizer) against its plain version on the card, bit-exact,
   at 0, 10, 200 and 256 live hints (overlapping, across the edges) at
   S=256 and at S=250 (not a multiple of 4); timed at the main path's
   table (10 hints) and at 200 hints, with the box tests its tile culling
   leaves beside those of a full scan per pixel. Its batched entry (counts
   read on the device) at N=1 and N=8 against the plain loop, bit-exact,
   and inside ONE captured CUDA graph replayed with the count changed in
   place between replays (0, 10, 200, 256, and counts past both ends);
4. K2 against its plain version on the card, <= 1 LSB on < 1e-3 of the
   values, at the click frame, the main path's full-res frame (750 wide,
   not a multiple of 4) and 1536x2048, in five plane layouts: contiguous
   planes, stride-3 L with planar ab (L as a channel of a Lab image),
   stride-2 ab views (a zoom output's channels), stride-0 zero ab (the
   mask and gray getters) and a plane 4 bytes off 16-byte alignment; each
   timed, with the bytes the layout really moves beside the 15 B/px bound.
   Then the full-res getters' launch shapes, the 256-px buckets 1024x768
   (of the main path's 1000x750 image) and 1280x768 (of 1100x750), in the
   getters' layout (contiguous L, the ab of a zoom through zero-padded
   matrices), and the same layout at the exact sizes: each under the same
   bar, timed with its plain version, against the bound at the bucket and
   at the true size.
   Then the dist session's two compose shapes in its own layouts, under
   the same bar: the 512x512 window frame (contiguous L, the two channels
   of a zoom_with_matrices output; timed) and the 1 x K palette (three
   stride-3 planes of a (K,3) Lab tensor) at K = 1, 9 and 25.
   The fused entry: its frame byte-identical to the compose's, its ab
   within 1e-3 of requantized_ab of that frame, timed. The batched entry
   at N=8 and N=1 at 256x256 and N=3 at 33x17, in the batch engine's planar
   layout and with channel-last ab: the same bar, and each frame equal to
   the single-frame entry's.
   K3 (the global statistics) against its plain chain on the card, on the
   Caffe path's global reference (256x256) and a 1000x752 one: the bin
   counts apart by at most one pooled pixel (direct distance against the
   chain's product expansion), the saturation and BGR means within
   K3_MEAN_BOUND, two calls equal bit for bit; timed at 256x256 against
   its 12 B/px bound, with the plain chain's eager time;
5. the main path: ColorizeImageTorch(Xd=256) with the bundled full-width
   teacher weights -- load a seeded 1000x750 image, a table click with no
   hint, ten clicks that add hints, a dense click, the full-res, mask and
   sup full-res getters -- with every kernel entry's launch count read
   around it; the same session on the CPU (plain kernel versions, CPU
   convs) must give the same frames within the bound below (1 LSB on <
   1e-3 of the pixels of each frame, output_ab within 1e-3 where the
   frames agree); click latency, and a profile of five clicks that says
   where the device time goes, how many device kernels a click runs and
   how many launches the host makes for it. On the card the API's clicks
   are captured CUDA graphs, so the rasterizer on this path is K1's
   device-count entry and a kernel's count adds its graph nodes at every
   replay;
6. the dist session, the GUI's second path: ColorizeImageTorch and
   ColorizeImageTorchDist with the teacher at Xd=256 on the same image --
   predict_dist_table, a table click, ten click+suggest clicks
   (net_forward_table_win_suggest) with a 512-px window and cubic matrices,
   get_ab_reccs, suggest_table (K=9), compute_entropy and snap_ab -- with
   the launch counts read around it apart from phase 5's (K1 and both K2
   entries must launch here too). Checked: the map's shape, finiteness and
   row sums; each click's net frame byte-identical to net_forward_table's
   for the same table when cuDNN's deterministic kernels are chosen (its
   default transposed convs accumulate with atomics, so two forwards of
   one input differ in the last bits: the session's own frames are held
   to the frame bound below); the last window frame against K2's plain
   version on the session's own tensors; palette row 0 the previous
   frame's pixel;
   confidences sorted and summing to 1; centers inside [-110, 110]. Against
   a CPU twin of the session (fewer clicks): the distribution map, the
   window frames, the entropy, snap_ab, and the k-means chain's
   deterministic cores on shared random numbers (bins_from_uniform,
   _lloyd). Timed: the click+suggest click, predict_dist_table and
   suggest_table on the host clock, the device kernels per click+suggest
   click and the k-means chain alone from the profiler, and how far 20
   forwards of one table lie apart with cuDNN's default kernels;
7. captured against eager. A second session whose graphs are captured
   with cuDNN's deterministic kernels chosen: the table, window and
   click+suggest clicks, predict_dist_table and suggest_table through the
   API (graph replays) against the plain functions they were captured from
   (``program.fn``), at tables of 0, 4 and 10 hints: frames, output_ab and
   hint planes byte-equal, map within 1e-5; the suggest chain's
   deterministic cores, captured, equal to the eager ones on shared random
   numbers; two replays draw different samples and a re-seeded generator
   the same ones. Then each click timed captured and eager in turns within
   this one run (p50/p95 on the host clock), with the device kernels, the
   host's launches, device busy time and idle share of each;
8. the serving precisions: a bf16 session (prep_net(dtype="bfloat16")) and
   a precision_name="default" (TF32) session against the f32 session on
   the same tables: frame_delta_stats, PSNR, max |d output_ab| and the
   distribution map's max |dp|, each held to BF16_BOUND / TF32_BOUND below;
   the captured table click's p50/p95 and device time in the three modes;
9. the async getters (byte-equal to the synchronous ones, also after the
   model's state has moved on), then the engines with launch counts of
   their own: InteractiveSession (40 submits, one latest per 4: counters,
   submit never waits for the device, last frame, window frame and hint
   mirrors equal the synchronous clicks'), StreamingSession (120 uint8
   frames at depth 4, table and dense hints, with and without the
   distribution map, against the direct step; frames/s);
10. the batch engine: colorize_batch_table at N=8 against the per-image f32
   table clicks and stream_window_u8 at T=8 against the per-frame step, by
   frame_delta_stats within TF32_BOUND; every K1 and K2 entry, the two
   batched ones included, must have launched on the engines' path. The
   layouts of the convs: an N=16 TF32 forward (channels-last on the card)
   must launch no NCHW <-> NHWC transpose, and an f32 table click must
   still launch cuDNN's NCHW (nchwkcrs) fprop kernels; the TF32 forward's
   conv and layout device time per batch beside the NCHW forward's;
11. the Caffe family, the fourth path, with launch counts of its own: the
   three graphs at their one width, Xd=256, with weights made from a seed
   with numpy (``init_state_dict(calibrate=True)``) and loaded through
   ``prep_net`` from a ``.caffemodel`` the run writes itself (main), a
   ``.pth`` (global) and a JAX-layout ``.npz`` (dist). Main: a dense click
   with no hint, table clicks that add hints, a window click, the full-res
   and mask getters. Global: ``global_stats.extract`` on a second image,
   ``net_forward`` with ``glob_dist=-1`` (equal to an all-zero blob) and
   with the histogram (another frame), ``demo_global_histogram`` on arrays.
   Dist: ``net_forward``, ``predict_dist_table``, ``get_ab_reccs``,
   ``suggest_table`` (K=9), ``compute_entropy``; the (256,256,313) map
   finite with rows summing to 1, ``dist_ab_full`` 529 with zeros outside
   the hull, confidences sorted and summing to 1. ``colorize_batch_global``
   at N=8 against eight ``net_forward`` calls, ``suggest_batch_table`` at
   N=8 by its contract. K1's device-count entry, K2's compose, fused and
   batched entries and K3 must launch. A CPU twin of the main, global and dist
   clicks (fewer clicks) holds the frames, ``output_ab`` and the map to the
   CAFFE_* bounds below. A second set of models, captured with cuDNN's
   deterministic kernels, holds each Caffe click against the plain function
   it was captured from (frames, ``output_ab``, hint planes byte-equal, map
   within 1e-5) and ``net_forward_fullres`` against the two-step form byte
   for byte. Timed, for information: the main, global and dist clicks and
   ``predict_dist_table`` (p50 / p95 on the host clock, device kernels and
   host launches per click, where the dist click's device time goes), one
   captured bf16 main click against f32, and the run's peak device memory;
12. the HTTP server (``apps/serve.py``), the fifth path, with launch counts
   of its own: ``make_server(device="cuda", dtype="float32", auto_batch=4)``
   on the teacher with ``student_w05`` as the fast tier and phase 11's
   seeded global net, ``warmup(suggest=True)``, ``serve_forever`` on a
   thread, then requests over ``http.client`` with bodies encoded by the
   port's own PNG codec: /healthz, a full-res /colorize with hints, a net-res
   one, 8 concurrent net-res ones (they must coalesce in the auto-batcher),
   ?model=fast, a session (10 clicks, a full-res click, /session/suggest,
   DELETE; the closed session's image must be freed), two sessions clicked
   from two threads in turns, /suggest, /colorize_global, /colorize_batch
   (N=4, hint tables), /stats, /metrics and bad requests (the JAX server's
   status codes; JPEG 415 without OpenCV), then a bf16 server for 10 session
   clicks. K1's device-count entry, K2's compose, fused and batched
   entries and K3 must launch. Every reply is then held against the port's API
   called directly on the same inputs: f32 net frames 1 LSB on < 1e-3 of
   the pixels (a full-res reply is its own model's fusion byte for byte,
   and moves < 1e-3 of the pixels from the API's full-res frame),
   auto-batched and /colorize_batch frames within TF32_BOUND, the
   global frame within the CAFFE_* bound, interleaved sessions against
   their single-session frames, the bf16 server against the f32 server
   within BF16_BOUND, suggestions within SUGGEST_BOUND of ``suggest_table``
   on the same seed. Printed, for information: the codec's encode and
   decode ms at 1000x750 (also the decode of the same image written by
   another encoder: Sub rows, and Average / Paeth rows), each stage's
   p50 / p95 from /stats (the traffic's, after warmup) and each
   endpoint's HTTP round trip, the session click over HTTP against the
   in-process captured click, the host pieces of a reply timed alone, and
   the phase's peak device memory;
13. training, distillation and evaluation (``train/``, ``apps/train.py``,
   ``apps/eval.py``), the sixth path, with launch counts of its own: a
   seeded corpus of 16 training and 8 held-out PNG images (288-400 px, some
   not square); one f32 train step of the teacher at batch 2, 64x64, on the
   card and on a CPU twin from the same weights and hints (the hint
   sampler's core on the card equal to the CPU's), held to the TRAIN_*
   bounds below; the step at the train CLI's defaults (full width, TF32,
   batch 16 at 176x176, rematerialized, a device-resident corpus with color
   jitter): p50 / p95 on the host clock, images/s, the peak memory, device
   busy and idle share and where the device time goes from the profiler,
   the augmentation and the hint sampler timed alone, 5 f32 steps for
   information; 30 steps on one fixed batch of a seeded w0.5 net cutting
   the loss by more than 40%; save -> load -> step byte-equal to the step
   taken straight through under deterministic convolutions; ``apps/train``
   run twice (a fine-tune of the teacher, a w0.5 distillation, 10 steps
   each, exported); ``apps/eval``'s ``evaluate`` (the teacher on the 8
   held-out images at 256, counts 0-25), ``hint_fidelity`` and
   ``save_colorization_grid``, whose renders K2's batched entry composes
   (it must launch; K1 must not); the counts are read there. Then a CPU
   twin of the eval with the same hint locations (the curve within
   EVAL_DB_BOUND per count, the fidelity within FID_*), and each export
   loaded by ``prep_net`` for a table click;
14. the front-ends, the seventh path, with launch counts of their own:
   the Qt GUI's drawing pad (``ui/qt_gui.GUIDraw``, under PyQt5 offscreen
   where it imports, else under ``tests/_fake_qt.py``) on the teacher and
   its dist model at load size 256 and a 512-px window, f32: a seeded
   1000x750 PNG through ``init_result`` (the port's codec, cubic resizes
   and ``load_image``), ten click+suggest clicks with colors, a drag of 20
   motion events through the async session, a palette pick, an erase, a
   wheel step, 40 timed re-clicks and ``save_result``; then a bf16 GUI,
   timed. The video app (``apps/video.run``) on 64 seeded 640x480 PNG
   frames at --size 256, with static hints and with tracked hints moved by
   a known translation field in place of the optical flow. K1's
   device-count entry and K2's compose must launch on both, K2's fused
   entry on the GUI. Then, after the counts are read: every scripted GUI
   frame against the API's window clicks on the same table, window L plane
   and matrices, the drag against a synchronous click on its final table,
   the saved PNGs against their frames, three clicks of a CPU twin, all
   within the frame bound; the video frames against StreamingSession on
   the same gray frames and hints; without OpenCV, ``--track-hints`` with
   its default flow exits 2 before any work. Printed: the GUI click (press
   to update_result) p50 / p95 on the host clock, f32 and bf16, against
   the 16.7 ms display frame; drag frames painted per second; the video
   app's steady fps beside phase 9's engine-only rate, and its host decode
   and resize ms per frame. Then an f32 GUI with the window composed on
   the host (``IDEEPCOLOR_WIN_COMPOSE=host``): the same scripted clicks,
   each window within WIN_BOUND_* of the device compose's, and timed
   clicks. Last, ``python -m ideepcolor_tpu_torch --help`` and
   ``fidelity --list`` in subprocesses;
15. the native host runtime and the host-composed clicks, the eighth path,
   with launch counts of their own: the teacher at Xd=256 on a seeded
   1000x750 image, three tables (0, 4, 10 hints), each through the table
   click (hint mirrors rasterized on the host), the abq and abq_half
   clicks (the full-res getter after the abq click reads the host ab,
   uploaded on first read), net_forward_table_win_host and
   net_forward_table_suggest_host with a 512-px window; then a server under
   ``IDEEPCOLOR_NET_CLICK=abq`` (warmup, ten session clicks over HTTP and
   a full-res one). K1's device-count entry and K2's fused entry must
   launch. After the counts are read: host.rasterize_hints bit-exact
   against K1 (10 and 200 hints, boxes across the edges, and every table
   click's planes); host lab2rgb_u8_planar against K2's compose at
   1000x750 (1 LSB on < 1e-3 of the values); zoom2_matrices against
   zoom_with_matrices; the abq frames against the rgb click (ABQ_BOUND);
   the captured abq payload against its plain function
   (PAYLOAD_FLIP_SHARE); the host windows against K2's compose of the same
   ab (the frame bound) and against the device window and click+suggest
   clicks (WIN_BOUND_*); the suggest_host palette (row 0 exact, the
   suggestions within SUGGEST_BOUND of win_suggest's on the same generator
   state); the server's replies against the API's abq click
   (ABQ_SERVER_BOUND), its full-res click an rgb click. Timed (host clock):
   the table click f32 and bf16 with host mirrors, each host click beside
   its device twin, and alone the 786 KB readback of K1's planes, the host
   rasterizer and the plain K1 on the host CPU at 10 and 200 hints, the
   two host composes;
16. the multi-device forms, the ninth path, with launch counts of their
   own: meshes whose entries all name the card (``parallel.mesh.make_mesh
   (devices=[card] * 8)``, the counterpart of XLA's forced host device
   count). On the (1, 1) mesh under cuDNN's deterministic kernels, every
   mesh= batch form on the teacher at Xd=256 (colorize_batch_table,
   colorize_batch, suggest_batch_table K=9, stream_window_u8, N=T=8; and
   colorize_batch_global on phase 11's seeded global net), one f32 train
   step of the teacher (batch 8 at 64x64) and one w0.5 distill step,
   byte for byte the single-device forms'. On the (4, 2) and (2, 2, 2)
   meshes over the card x8: under deterministic kernels, every form at
   N=19 (padded to 20; the global form 7 to 8), palettes included, byte
   for byte the single-device forms run chunk by chunk as the mesh splits
   the batch; with the default kernels, the forms at N=16 and 19 against
   the unsharded call on the whole batch within MESH_FRAME_BOUND (the
   palettes' distance printed), the train and distill steps within the
   TRAIN_* bounds of the single-device steps. The server with
   ``use_mesh`` where ``local_devices`` gives the card 8 times: health's
   mesh, the alignment, /colorize_batch (5 images) against the unsharded
   form (MESH_FRAME_BOUND) and the API's f32 clicks (TF32_BOUND). K1's two
   entries and K2's
   single-frame and batched entries must launch; the references are made
   after the counts are read. Printed: the sharded colorize_batch_table
   N=16 against the unsharded call and a train step on each mesh (host
   clock; on one card that is the cost of the split, the copies and the
   gather, not scaling), the phase's peak memory;
17. the mesh across processes, the tenth path: two ranks spawned into one
   gloo group over a file store (NCCL refuses two ranks on one card),
   each giving the card four times (``devices=[card] * 4``). On the
   (2, 2, 2) hybrid mesh and on make_mesh(8, 2) across the ranks, phase
   16's f32 train step of the teacher and w0.5 distill step (same batch,
   weights and generator seed, two steps each) under deterministic cuDNN:
   the ranks' params byte for byte equal after every step; rank 0's state
   file, loaded on one device, holds rank 0's params; against this
   process's meshes of the same shapes over the card x8, the loss within
   MP_LOSS_BOUND and the params within the TRAIN_* bounds (the all-reduce
   adds the ranks' sums in another order). In both ranks
   colorize_batch_table(mesh=) and a ColorizeService start raise before
   any work (no kernel launches), and apps/train.main runs MP_APP_STEPS
   steps on phase 13's corpus: rank 0 alone prints and writes each
   checkpoint and the .pth export, once. The parent joins the ranks within
   MP_DEADLINE_S; a rank that fails or outlives it fails the run. Printed:
   the train step's host ms in one process and in each rank, and the
   gradient all-reduce's alone. No kernel of K1 or K2 runs here;
18. the reference's doors, the eleventh path, with launch counts of its
   own, in a child process (``chip_smoke.py --doors-child``) whose
   sys.path starts with the port's drop-in root
   (``ideepcolor_tpu_torch/compat``: the repository root's own ``data/``
   and ``caffe.py`` are the JAX package's drop-ins and would shadow it);
   the child reads its own counts and hands them back. cuDNN's
   deterministic kernels are chosen for the whole child. Counted: the
   reference's code run verbatim through the drop-in --
   ``CI.ColorizeImageTorch(Xd=256)``, ``prep_net(0, path=teacher.npz)``, a
   seeded 1000x750 image, ten ``net_forward`` clicks that add a point each
   with the notebook's ``put_point``, each followed by the table click of
   the same points (the port's own click, which the drop-in class keeps),
   the full-res, mask and input getters; the global-histogram pattern
   (``import caffe``, ``caffe.Net`` on global_stats, blob stuffing,
   ``caffe.io``) with a seeded calibrated global net written as a
   ``.caffemodel``; both port notebooks (``notebooks/torch``) cell by cell
   on the card (read as JSON; where matplotlib does not import, a
   stand-in ``matplotlib.pyplot`` records the plotting calls, and every
   device call runs for real); ``apps.convert`` on the teacher (.npz ->
   .pth, timed) and on the three seeded ``.caffemodel`` files. K1's
   batched entry, K2's compose and fused entries and K3 must launch. Then:
   (a) ``data.colorize_image`` and ``caffe`` resolve to the drop-in root,
   and no module of JAX or the JAX package is loaded at the child's end;
   (b) the drop-in session's frames byte-identical to the same clicks
   through ``ideepcolor_tpu_torch.api``, each dense click within the frame
   bound of its table click; (c) the converted ``.pth``'s frames
   byte-identical to the ``.npz``'s; (d) main, dist and global: each
   ``.caffemodel``'s outputs byte-identical to its converted ``.npz``'s;
   (e) the global pattern against its CPU twin (``gpu_id=-1``) within the
   CAFFE_* bounds, ``glob_dist_in`` within 1e-6 and summing to 1 within
   1e-4; (f) the notebooks' frames of the right shapes, on the card.
   Printed: the drop-in click's p50 / p95 on the host clock beside the
   API's, in turns in the same child; the converter's seconds for the
   teacher; the phase's wall time;
19. the standalone programs, the twelfth path, with launch counts of its
   own, on phase 5's main session and phase 6's dist session (teacher,
   Xd=256, the seeded 1000x750 image). Counted: the image load (padded to
   its 1024x768 bucket and converted by the load program), a dense
   ``net_forward_fullres``, a table click, the five full-res getters and
   the async one, ``get_ab_reccs``, ``compute_entropy``, a snap of one and
   of eight colors, a gamut redraw, then a fresh model loading 1000x750,
   1000x700, 990x760 (one bucket: each program captured once) and
   1100x750 (1280x768: once more), a table click and the getters each.
   K1's batched entry and K2's compose and fused entries must launch.
   Then each program captured against its eager function on the same
   inputs (frames <= 1 LSB on < 1e-3 of the pixels, the load's Lab within
   1e-4, entropy, snap and gamut mask byte for byte, a re-seeded
   get_ab_reccs byte for byte and both forms within their contract); each
   program's call timed captured and eager in turns (host-clock p50 / p95,
   host launches per call); a novel k's suggest program captured ahead
   (``compile_now``) by a second thread while this one clicks, outside the
   clicks' lock and then under it (the clicks of a session captured with
   deterministic cuDNN, each frame byte-equal to a lone run's; click p50 /
   p95 during each capture), then a third novel k while this thread runs
   ``suggest_table`` and ``get_ab_reccs`` on the same dist model (they
   wait on its generator lock while it captures: each palette within its
   contract, and re-seeded calls after the capture byte-equal to re-seeded
   calls before it; their p50 / p95 during the capture); the GUI click (press
   to ``update_result``) with the device snap and with the host snap, in
   turns;
20. one JSON line listing each kernel entry with its launches on the
   eleven paths that launch kernels, its error against the plain version,
   its time, the plain version's, its bound and what sets it, and the
   shape and plane layout those numbers were measured at;
21. last line: {"ok": true, "device": {...}}.

Times are device times from CUDA events: a kernel's ``ms`` and the plain
version's ``plain_ms`` are the median over 50 replays of a CUDA graph of 20
calls, divided by 20 (K3's plain chain uploads its bin centers every call,
which a graph cannot capture: its ``plain_ms`` is the eager call's, CUDA
events around 4 calls). ``bound_ms`` is the larger of the bytes the function
must move over 3.35 TB/s and its f32 operations over 67 TFLOP/s (the H100
SXM data sheet's HBM rate and f32 rate outside the tensor cores). No single
PyTorch call computes either function, so ``library_ms`` is null.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K2_OPS_PER_PIXEL = 60        # f32 operations of the chain, pow counted once
K2_AB_OPS_PER_PIXEL = 100    # the fused entry: the chain, then RGB -> Lab ab
K2_BAR = (1, 1e-3)           # K2 vs plain: max LSB, share of values
K3_MEAN_BOUND = 2e-5         # K3 vs plain: s_avg and bgr_avg
AB_BAR = 1e-3                # fused ab vs requantized_ab of the same frame
S = 256
FULLRES_HW = (1000, 750)
K2_SIZES = ((S, S), FULLRES_HW, (1536, 2048))
K3_SIZES = ((S, S), (1000, 752))
FRAME_BOUND_LSB = 1          # card vs CPU session, per channel
FRAME_BOUND_SHARE = 1e-3     # of the pixels of any one frame
WEIGHTS = "weights/teacher.npz"
WIN = 512                    # the GUI's window size
SUGGEST_K = 9                # the GUI's palette
DIST_CPU_CLICKS = 2          # of the ten click+suggest clicks, on the CPU
MAP_BOUND = 1e-5             # distribution map, card vs CPU, max |d p|
BINS_MOVED_BOUND = 5         # of 25000 samples: f32 cumsum order differs
# a serving-precision session against the f32 session, over table clicks of
# 0, 4 and 10 hints: frames (frame_delta_stats: max LSB, share of equal
# pixels; PSNR in dB), output_ab and the distribution map
# (measured on an H100: bf16 22 LSB, 0.689, 53.06 dB, 3.52, 1.09e-3; TF32
# 1 LSB, 0.975, 68.81 dB, 1.03, 9.9e-5). TF32's frame bounds also hold two
# TF32 runs of other batch sizes, whose convs take other kernels
BF16_BOUND = dict(max_lsb=40, equal=0.55, psnr=48.0, dab=8.0, map=5e-3)
TF32_BOUND = dict(max_lsb=3, equal=0.95, psnr=60.0, dab=2.5, map=5e-4)
# the Caffe path, card vs its CPU twin: frames (LSB per channel, share of a
# frame's pixels), output_ab where the frames agree, the (256,256,313) map
# (MAP_BOUND). The share is not the main path's 1e-3: the seeded nets carry
# the convs' last-bit differences to ab at a few 1e-3 of its range (also
# between the port and JAX on one CPU), a uint8 step is about 0.4 ab, and
# 1 LSB on 4.20e-3 and 4.14e-3 of a frame's pixels was measured on an H100
# in two runs (output_ab 1.18e-4, maps 5.65e-6). The same bound holds a
# batch of 8 against eight single forwards (measured 1.08e-3)
CAFFE_FRAME_BOUND_LSB = 1
CAFFE_FRAME_BOUND_SHARE = 1e-2
CAFFE_AB_BOUND = 1e-3
CAFFE_CPU_CLICKS = 2         # table clicks of the CPU twin
CAFFE_SEED = 21              # of the three seeded weight sets
# a served suggestion against the dist class's suggest_table on the same
# image, table and generator seed (graph replay against graph replay): max
# |d color| in LSB, max |d conf|. The dist forward's cuDNN kernels differ in
# the last bits between two runs, which may move a sample's bin
SUGGEST_BOUND = (2, 1e-3)
# phase 13: one f32 train step of the teacher (batch 2 at 64x64), card vs
# its CPU twin on the same weights and hints: loss (relative), weights after
# the step in units of lr (a first Adam step moves a weight by about
# lr sign(g), so a gradient near 0 whose sign differs gives 2 lr), and the
# share of weights more than 1e-3 lr apart: Adam divides each gradient by
# its own magnitude, so weights with gradients near its eps (1e-8) carry
# the convs' last-bit differences up (measured on an H100: 1.09e-7, 1.54
# lr, 4.06e-2)
TRAIN_LOSS_BOUND = 1e-5
TRAIN_DW_BOUND = 2.001
TRAIN_DW_SHARE = 0.1
TRAIN_BATCH, TRAIN_SIZE = 16, 176     # the train CLI's defaults
TRAIN_STEPS = 20                      # timed, after 3 of warm-up
CLI_STEPS = 10
EVAL_SIZE = 256
EVAL_COUNTS = (0, 1, 2, 5, 10, 25)
# the eval's curve card vs CPU per count (dB), the fidelity's ΔE and radii
# (rounded by hint_fidelity to 1e-3 and 0.1 px; measured on an H100:
# 9.54e-7 dB, both equal)
EVAL_DB_BOUND = 0.01
FID_DE_BOUND = 0.01
FID_RADIUS_BOUND = 0.2
# phase 14, the front-ends: the GUI's scripted clicks (each checked), the
# timed re-clicks after them, the clicks of its CPU twin, the drag; the video
# app's clip; a 60 Hz display frame
GUI_CLICKS = 10
GUI_TIMED_CLICKS = 40
GUI_CPU_CLICKS = 3
DRAG_EVENTS = 20
VIDEO_FRAMES = 64
VIDEO_HW = (480, 640)
DISPLAY_FRAME_MS = 1000 / 60
# phase 14's GUI in host compose mode against its device-compose GUI on the
# same scripted clicks, and phase 15's host windows against the device
# window clicks: the window bound of tests/test_torch_gui_logic.py (the
# host Lab -> RGB and K2 differ by 1 LSB on a few values, and a net byte
# flipped by cuDNN's atomics spreads over a few window pixels)
WIN_BOUND_LSB = 2
WIN_BOUND_SHARE = 5e-3
# phase 15, the host runtime's clicks on the teacher: timed clicks per kind;
# the abq frames against the rgb click on the same table (max LSB, least
# PSNR in dB; the payload's 0.863-ab step moves a pixel by a few LSB where
# the sRGB curve is steep, the half payload also smooths the chroma); the
# captured abq payload against its plain function run eagerly (cuDNN's
# atomics move a prediction across a step now and then: the share of values
# one step apart); the abq server's replies against the API's abq click
# (LSB, share of pixels)
# (measured at Xd=256 on the port's CPU twin and on an H100 alike: abq 13
# LSB, 51.21 dB; abq_half 84 LSB, 37.61 dB; payload 0 apart; server 1.5e-5
# of the pixels)
HOST_TIMED = 30
ABQ_BOUND = {"abq": (16, 45.0), "abq_half": (96, 33.0)}
PAYLOAD_FLIP_SHARE = 1e-3
ABQ_SERVER_BOUND = (16, 1e-3)
# phase 16, the multi-device forms on meshes whose entries all name the card:
# the batch sizes on the (4, 2) and (2, 2, 2) meshes (16 divides their
# alignment 4, 19 does not), the global form's (its unsharded reference is
# the 13.7 GiB transient of lever L2 at N=8), the train and distill steps'
# batch and size, and the timed calls per form
MESH_N = (16, 19)
MESH_GLOBAL_N = 7
MESH_TRAIN_BATCH, MESH_TRAIN_SIZE = 8, 64
MESH_TIMED = 5
# a repeated mesh's chunks (4 or 5 images; 1 on the server's (8, 1) mesh)
# run at TF32 with other cuDNN kernels than the whole batch of 16-19: frames
# against the unsharded call, max LSB and share of the pixels (measured on
# an H100: 1 LSB on at most 4.41e-3; JAX's 1e-3 holds on the CPU). Against
# the single-device forms run chunk by chunk, as the mesh splits the batch,
# under deterministic kernels the frames and palettes are held equal
MESH_FRAME_BOUND = (1, 1e-2)
# phase 17, the mesh across processes: two spawned ranks in one gloo group
# on the one card (NCCL refuses two ranks on one device), the parent's join
# deadline, the loss bound against one process (the chunks' losses are
# averaged in another order), and the app's steps and batch
MP_WORLD = 2
MP_DEADLINE_S = 600
MP_LOSS_BOUND = 1e-6
MP_APP_STEPS, MP_APP_BATCH = 4, 4
MP_MESHES = ("(2,2,2)", "(4,2)")

# phase 18, the reference's doors: a child process with the drop-in root
# first on sys.path; its deadline, the hints of its ten reference-style
# clicks and the timed clicks of each of the two sessions
COMPAT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "ideepcolor_tpu_torch", "compat")
DOORS_DEADLINE_S = 400
DOORS_CLICKS = 10
DOORS_TIMED = 30
# phase 19, the standalone programs: calls timed per program and form (in
# turns of half), the image sizes of the bucket check (the first three share
# the 1024x768 bucket, the fourth is 1280x768), the novel k's captured ahead
# (outside the clicks' lock, then inside it, then while the same dist model
# suggests), and the GUI clicks per snap
PROGRAM_TIMED = 40
# the images whose buckets phase 4 holds K2 at, in the getters' layout
GETTER_SIZES = (FULLRES_HW, (1100, 750))
BUCKET_SIZES = ((1000, 750), (1000, 700), (990, 760), (1100, 750))
AHEAD_K = (7, 8, 6)
AHEAD_CLICKS_AFTER = 10      # clicks after the capture ended
SNAP_GUI_CLICKS = 20


def die(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def params_digest(params: dict) -> str:
    """sha256 of every tensor's bytes, in key order: equal digests are
    params equal byte for byte."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def device_ms(fn, reps: int = 20, samples: int = 50) -> float:
    """Median device time of one call of ``fn``: ``reps`` calls captured in
    a CUDA graph, replayed ``samples`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def eager_ms(fn, reps: int = 20, samples: int = 50) -> float:
    """Median time of one eager call, host launch included: CUDA events
    around ``reps`` back-to-back calls."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def image(seed: int, H: int, W: int) -> np.ndarray:
    """A seeded smooth color field with noise, uint8 (H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * yy + c) * np.cos(5 * xx - 2 * c)
                     for c in range(3)], -1)
    return np.clip(127.5 + 100 * base + rng.normal(0, 12, (H, W, 3)),
                   0, 255).astype(np.uint8)


def write_corpus(root: str) -> tuple[str, str]:
    """Phase 13's seeded corpus under ``root``: 16 training and 8 held-out
    PNG images of 288-400 px (a quarter of them square). Returns the two
    folders."""
    from ideepcolor_tpu_torch.utils.imageio import encode_png
    rng = np.random.default_rng(13)
    for name, n in (("train", 16), ("held", 8)):
        os.makedirs(os.path.join(root, name))
        for i in range(n):
            H, W = (int(v) for v in rng.integers(288, 401, 2))
            W = H if i % 4 == 0 else W
            with open(os.path.join(root, name, f"{i:02d}.png"), "wb") as f:
                f.write(encode_png(image(1300 + 50 * (name == "held") + i,
                                         H, W)))
    return os.path.join(root, "train"), os.path.join(root, "held")


def mesh_train_batch(dev):
    """Phases 16's and 17's train batch on ``dev``: MESH_TRAIN_BATCH seeded
    images at MESH_TRAIN_SIZE, as {'l': (N,1,H,W), 'ab': (N,2,H,W)}."""
    import torch
    from ideepcolor_tpu_torch.ops.colorspace import rgb_to_lab
    from ideepcolor_tpu_torch.ops.resize import resize_u8_pil_bilinear
    small = [resize_u8_pil_bilinear(image(1700 + i, 300, 340),
                                    (MESH_TRAIN_SIZE, MESH_TRAIN_SIZE))
             for i in range(MESH_TRAIN_BATCH)]
    lab = rgb_to_lab(torch.from_numpy(np.stack(small)).float() / 255.0)
    return {"l": lab[..., :1].permute(0, 3, 1, 2).contiguous().to(dev),
            "ab": lab[..., 1:].permute(0, 3, 1, 2).contiguous().to(dev)}


def session_hints(n: int, seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"y": int(rng.integers(0, S)), "x": int(rng.integers(0, S)),
             "ab": rng.uniform(-80, 80, 2).tolist(),
             "radius": int(rng.integers(1, 5))} for _ in range(n)]


def k1_table(n_live: int, size: int = S, seed: int = 1):
    """A 256-slot table: n_live overlapping boxes, many across the edges."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((256, 4), np.int32)
    values = np.zeros((256, 2), np.float32)
    for i in range(256):
        y, x = rng.integers(-10, size + 10, 2)
        r = rng.integers(0, 13)
        boxes[i] = [y - r, x - r, y + r, x + r]
        values[i] = rng.uniform(-100, 100, 2)
    return boxes, values, n_live


def k1_box_tests(boxes, count: int, size: int = S) -> tuple[int, int, int]:
    """Box tests of this table: (K1's cull, K1's scan, a full scan per
    pixel). K1 tests every live slot against each 8x64 tile, then each
    thread scans its tile's list from the end until its four pixels are
    covered (all of it where one is not). A full scan per pixel goes from
    slot count-1 down to the first cover (all count slots without one)."""
    if count == 0:
        return 0, 0, 0
    b = boxes[:count]
    ys, xs = np.mgrid[0:size, 0:size]
    last = np.full((size, size), -1)
    for k in range(count):
        last[(ys >= b[k, 0]) & (ys <= b[k, 2]) & (xs >= b[k, 1])
             & (xs <= b[k, 3])] = k
    full = int(np.where(last >= 0, count - last, count).sum())
    cull = scan = 0
    for ty in range(0, size, 8):
        for tx in range(0, size, 64):
            y1, x1 = min(ty + 8, size) - 1, min(tx + 64, size) - 1
            cull += count
            hit = ((b[:, 0] <= y1) & (b[:, 2] >= ty) & (b[:, 1] <= x1)
                   & (b[:, 3] >= tx))
            rank = np.cumsum(hit) - 1         # place in the tile's list
            n = int(hit.sum())
            tile = last[ty:y1 + 1, tx:x1 + 1]
            j = np.where(tile >= 0, rank[np.maximum(tile, 0)], -1)
            pad = (-j.shape[1]) % 4
            j = np.pad(j, ((0, 0), (0, pad)), constant_values=n)
            groups = j.reshape(j.shape[0], -1, 4)
            first = np.where((groups < 0).any(-1), 0, groups.min(-1))
            scan += int((n - first).sum())
    return cull, scan, full


def needed(planes, out_bytes: int) -> int:
    """Bytes the function must move: each distinct input element once (a
    stride-0 plane is one element), plus the output."""
    seen = {(t.data_ptr(), t.stride()): 1 if t.stride() == (0, 0)
            else t.numel() for t in planes}
    return 4 * sum(seen.values()) + out_bytes


def traffic(planes, out_bytes: int) -> int:
    """Bytes a call really moves: each storage the planes read spans, once,
    plus the output."""
    spans = {}
    for t in planes:
        lo = t.data_ptr()
        hi = lo + 4 * (1 + sum((n - 1) * st for n, st in
                               zip(t.shape, t.stride())))
        key = t.untyped_storage().data_ptr()
        old = spans.get(key, (lo, hi))
        spans[key] = (min(lo, old[0]), max(hi, old[1]))
    return sum(hi - lo for lo, hi in spans.values()) + out_bytes


def lsb(got, want) -> tuple[int, float]:
    d = (got.int() - want.int()).abs()
    return int(d.max()), float((d != 0).float().mean())


def frame_check(label: str, got, want, max_lsb: int, share: float) -> float:
    """Die unless ``got`` is within ``max_lsb`` of ``want`` per channel on
    fewer than ``share`` of the pixels; returns the share that differs."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != np.uint8:
        die(f"{label}: {got.shape} {got.dtype} against {want.shape}")
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    moved = float(np.mean(d != 0))
    if d.max() > max_lsb or moved >= share:
        die(f"{label}: {int(d.max())} LSB on {moved:.2e} of the pixels "
            f"(bound {max_lsb} LSB on < {share})")
    return moved


def filtered_png(img: np.ndarray, kinds: list) -> bytes:
    """(H, W, 3) uint8 as a PNG whose row y is filtered with
    ``kinds[y % len(kinds)]`` (PNG spec section 9), as another encoder
    would write it."""
    import struct
    import zlib
    from ideepcolor_tpu_torch.utils.imageio import PNG_SIGNATURE
    H, W = img.shape[:2]
    x = img.reshape(H, W * 3).astype(np.int32)
    up = np.vstack([np.zeros((1, W * 3), np.int32), x[:-1]])
    left = np.hstack([np.zeros((H, 3), np.int32), x[:, :-3]])
    ul = np.hstack([np.zeros((H, 3), np.int32), up[:, :-3]])
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    preds = (0 * x, left, up, (left + up) >> 1, paeth)
    k = np.array([kinds[y % len(kinds)] for y in range(H)])
    pred = np.choose(k[:, None], preds)
    rows = np.hstack([k[:, None], (x - pred) & 0xFF]).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def server_phase(entries, glob_weights: str) -> dict:
    """Phase 12: apps/serve.py on the card. Returns the phase's launches
    per kernel entry (the server's traffic only: the references are made
    after the counts are read)."""
    import gc
    import http.client
    import importlib.util
    import io
    import threading
    import weakref

    import torch
    from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                          ColorizeImageTorchCaffeGlobDist,
                                          ColorizeImageTorchDist)
    from ideepcolor_tpu_torch.apps import serve
    from ideepcolor_tpu_torch.engine import batch as B
    from ideepcolor_tpu_torch.engine import pipeline as P
    from ideepcolor_tpu_torch.models import global_stats
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import global_stats_kernel as k3
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    from ideepcolor_tpu_torch.ops.resize import resize_u8_half_pixel
    from ideepcolor_tpu_torch.utils.imageio import decode_image, encode_png

    fast_weights = "weights/student_w05.npz"
    server_entries = (k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
                      k2.KERNEL_BATCH, k3.KERNEL)
    rtt: dict = {}                   # endpoint -> [client round trip, s]

    def request(srv, kind, method, path, body=None, headers=None):
        c = http.client.HTTPConnection(*srv.server_address, timeout=300)
        t0 = time.perf_counter()
        c.request(method, path, body=body, headers=headers or {})
        r = c.getresponse()
        data = r.read()
        rtt.setdefault(kind, []).append(time.perf_counter() - t0)
        c.close()
        return r.status, data

    def ok(srv, kind, method, path, body=None, headers=None):
        st, data = request(srv, kind, method, path, body, headers)
        if st != 200:
            die(f"server: {method} {path} answered {st}: {data[:200]!r}")
        return data

    def own_state(m):
        """What a model's full-res frame is made from: the tensors it keeps
        (the bucket-padded full-res L, the kept ab, the padded matrices;
        held, not the model), the image's size and its net frame (read
        back: a copy, no kernel)."""
        return (m._dev_l_fullres_pad, m._dev_output_ab, m._dev_rh, m._dev_rw,
                m._fullres_hw, m.output_rgb)

    def start(**kw):
        srv = serve.make_server(port=0, size=S, device="cuda",
                                weights=WEIGHTS, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    # the codec at the full-res size (host clock)
    big = image(12, *FULLRES_HW)
    enc_ms, dec_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        png = encode_png(big)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        back = decode_image(png)
        dec_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(back, big):
        die("server: the PNG codec does not round-trip")
    # other encoders' rows: OpenCV's default PNG filters every row Sub;
    # libpng's adaptive choice mixes in Average and Paeth (decoded along
    # anti-diagonals)
    other_ms = {}
    for name, kinds in (("Sub rows (OpenCV's default)", [1]),
                        ("Average/Paeth rows (adaptive)", [3, 4, 1, 2])):
        data = filtered_png(big, kinds)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            back = decode_image(data)
            ts.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(back, big):
            die(f"server: the PNG decoder on {name}")
        other_ms[name] = np.median(ts)
    print(f"PNG codec at {FULLRES_HW[0]}x{FULLRES_HW[1]} (host clock, "
          f"median of 5): encode {np.median(enc_ms):.1f} ms "
          f"({len(png) / 1e6:.2f} MB), decode {np.median(dec_ms):.1f} ms; "
          f"decode (median of 3) of " + ", ".join(f"{k} {v:.1f} ms"
                                    for k, v in other_ms.items()))

    # -- the server's traffic, launches counted --
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    for k in entries:
        k.launches = 0
    t_start = time.perf_counter()
    srv = start(dtype="float32", auto_batch=4, student_weights=fast_weights,
                glob_weights=glob_weights)
    svc = srv.RequestHandlerClass.service
    t0 = time.perf_counter()
    svc.warmup(suggest=True)
    warm_s = time.perf_counter() - t0
    svc.timer.samples.clear()        # /stats: the traffic's stages only
    replies, states = {}, {}
    health = json.loads(ok(srv, "healthz", "GET", "/healthz"))
    if health["device"] != torch.cuda.get_device_name(0):
        die(f"server: /healthz device {health['device']!r}")
    full_hints = session_hints(10, seed=21)
    replies["fullres"] = ok(srv, "colorize_fullres", "POST", "/colorize",
                            encode_png(big),
                            {"X-Hints": json.dumps(full_hints)})
    states["fullres"] = own_state(svc.model)
    net_img = image(13, 300, 400)
    net_png = encode_png(net_img)
    replies["netres"] = ok(srv, "colorize_netres", "POST",
                           "/colorize?fullres=0", net_png,
                           {"X-Hints": json.dumps(full_hints[:4])})
    conc_hints = [session_hints(3, seed=40 + i) for i in range(8)]
    conc = [None] * 8
    before = svc.batcher.dispatches

    def one(i):
        conc[i] = request(srv, "colorize_netres_x8", "POST",
                          "/colorize?fullres=0", net_png,
                          {"X-Hints": json.dumps(conc_hints[i])})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    coalesced = svc.batcher.dispatches - before
    if any(c is None or c[0] != 200 for c in conc) or not 1 <= coalesced < 8:
        die(f"server: 8 concurrent net-res requests: "
            f"{[c and c[0] for c in conc]}, {coalesced} batched forwards")
    replies["fast"] = ok(srv, "colorize_fast", "POST", "/colorize?model=fast",
                         encode_png(image(14, 240, 320)))
    states["fast"] = own_state(svc.model_fast)
    sess_img = image(5, *FULLRES_HW)
    sid = json.loads(ok(srv, "session_open", "POST", "/session",
                        encode_png(sess_img)))["id"]
    clicks = session_hints(10)
    for i in range(1, len(clicks) + 1):
        replies[f"click{i}"] = ok(srv, "session_click", "POST",
                                  f"/session/click?id={sid}",
                                  json.dumps(clicks[:i]).encode())
    replies["click_fullres"] = ok(srv, "session_click_fullres", "POST",
                                  f"/session/click?id={sid}&fullres=1",
                                  json.dumps(clicks).encode())
    svc._dist._generator.manual_seed(11)
    replies["session_suggest"] = json.loads(ok(
        srv, "session_suggest", "POST",
        f"/session/suggest?id={sid}&h={S // 3}&w={S // 2}&k={SUGGEST_K}",
        json.dumps(clicks).encode()))
    states["session"] = own_state(svc._sessions[sid])
    # the session's image: full-res Lab and the net-res planes its clicks
    # fed the shared graphs (which keep only weak references to them)
    closed = [weakref.ref(getattr(svc._sessions[sid], k)) for k in
              ("_dev_lab_fullres_pad", "_dev_l_net", "_dev_l_mc")]
    ok(srv, "session_close", "DELETE", f"/session?id={sid}")
    gc.collect()
    if any(r() is not None for r in closed):
        die("server: a closed session's image is still held")
    # two sessions clicked from two threads in turns, each against its own
    # single-session frames
    inter_imgs = [image(30 + i, 600, 450) for i in range(2)]
    inter_ids = [json.loads(ok(srv, "session_open", "POST", "/session",
                               encode_png(im)))["id"] for im in inter_imgs]
    inter_hints = [session_hints(5, seed=50 + i) for i in range(2)]
    inter_alone = [ok(srv, "session_click", "POST",
                      f"/session/click?id={inter_ids[i]}",
                      json.dumps(inter_hints[i]).encode()) for i in range(2)]
    inter_got = {0: [], 1: []}

    def clicker(i):
        for _ in range(5):
            inter_got[i].append(request(
                srv, "session_click", "POST",
                f"/session/click?id={inter_ids[i]}",
                json.dumps(inter_hints[i]).encode()))

    threads = [threading.Thread(target=clicker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    svc._dist._generator.manual_seed(12)
    sug_img = image(15, 480, 640)
    replies["suggest"] = json.loads(ok(
        srv, "suggest", "POST",
        f"/suggest?h={S // 4}&w={3 * S // 4}&k={SUGGEST_K}",
        encode_png(sug_img), {"X-Hints": json.dumps(clicks[:3])}))
    glob_img, glob_ref = image(16, 500, 375), image(6, 200, 300)
    gbuf = io.BytesIO()
    np.savez(gbuf, image=np.frombuffer(encode_png(glob_img), np.uint8),
             ref=np.frombuffer(encode_png(glob_ref), np.uint8))
    replies["global"] = ok(srv, "colorize_global", "POST",
                           "/colorize_global", gbuf.getvalue())
    states["global"] = own_state(svc._glob)
    batch_imgs = np.stack([image(60 + i, S, S) for i in range(4)])
    tabs = [hints.points_json_to_table(session_hints(2 * i, seed=70 + i), S)
            for i in range(4)]
    bbuf = io.BytesIO()
    np.savez(bbuf, images=batch_imgs, boxes=np.stack([t[0] for t in tabs]),
             values=np.stack([t[1] for t in tabs]),
             counts=np.asarray([t[2] for t in tabs], np.int32))
    with np.load(io.BytesIO(ok(srv, "colorize_batch", "POST",
                               "/colorize_batch", bbuf.getvalue()))) as z:
        replies["batch"] = z["frames"]
    # bad requests: the JAX server's status codes (JPEG: 415, the card's
    # machine has no OpenCV)
    gray = encode_png(image(17, 64, 64))
    bad = [("POST", "/colorize", b"not an image", None, 400),
           ("POST", "/colorize?fullres=0", gray, {"X-Hints": "not json"},
            400),
           ("POST", "/colorize?fullres=0", gray,
            {"X-Hints": '[{"y": 0, "x": 0, "ab": [1, 2], "radius": 999}]'},
            400),
           ("POST", "/colorize", b"\xff\xd8\xff\xe0 a jpeg", None,
            400 if importlib.util.find_spec("cv2") else 415),
           ("POST", "/colorize_batch", b"junk", None, 400),
           ("POST", "/colorize_global", b"not-an-npz", None, 400),
           ("POST", "/suggest?h=999&w=0", gray, None, 400),
           ("POST", "/suggest?h=1&w=1&k=26", gray, None, 400),
           ("POST", "/session/click?id=nope", b"[]", None, 404),
           ("POST", "/session/click", b"[]", None, 400),
           ("DELETE", "/session?id=nope", None, None, 404),
           ("GET", "/nope", None, None, 404)]
    for method, path, body, headers, want in bad:
        st, data = request(srv, "bad", method, path, body, headers)
        if st != want:
            die(f"server: {method} {path} answered {st}, not {want}: "
                f"{data[:200]!r}")
    c = http.client.HTTPConnection(*srv.server_address, timeout=60)
    c.putrequest("POST", "/colorize")
    c.putheader("Content-Length", str(600 << 20))
    c.endheaders()
    if c.getresponse().status != 413:
        die("server: an oversized body was not refused with 413")
    stats = json.loads(ok(srv, "stats", "GET", "/stats"))
    metrics = ok(srv, "metrics", "GET", "/metrics").decode()
    if "ideepcolor_requests_total" not in metrics or \
            'ideepcolor_stage_latency_ms{stage="session_click"' not in metrics:
        die("server: /metrics lacks its counters")
    # the bf16 server (the JAX package's default precision): ten clicks
    srv16 = start()
    sid16 = json.loads(ok(srv16, "session_open", "POST", "/session",
                          encode_png(sess_img)))["id"]
    bf16 = [ok(srv16, "session_click_bf16", "POST",
               f"/session/click?id={sid16}",
               json.dumps(clicks[:i]).encode())
            for i in range(1, len(clicks) + 1)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    phase_launches = {k.name: k.launches for k in entries}
    peak = torch.cuda.max_memory_allocated()
    for s_ in (srv, srv16):
        s_.shutdown()
        s_.server_close()
    print(f"server on the card: {wall:.2f} s (warmup {warm_s:.2f} s), "
          f"launches {phase_launches}; peak device memory in the phase "
          f"{peak / 2**30:.3f} GiB allocated ({mem_before / 2**30:.3f} "
          f"held when it began)")
    for k in server_entries:
        if phase_launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the server's path")

    # -- every reply against the port's own API on the same inputs --
    ref = ColorizeImageTorch(Xd=S)
    ref.prep_net(path=WEIGHTS)
    ref.load_image_array(big)
    ab, mask = (np.zeros((2, S, S), np.float32),
                np.zeros((1, S, S), np.float32))
    hints.put_points_json(ab, mask, full_hints, S)
    worst, spread = {}, []

    def fullres_check(label, reply, state, want_full, want_net,
                      bound=(FRAME_BOUND_LSB, FRAME_BOUND_SHARE)):
        """A full-res reply is the fusion of its own model's kept ab, byte
        for byte; that model's net frame is within the frame bound of the
        API's. Against the API's full-res frame only the share of moved
        pixels is held: the kept ab is the requantized ab of the net frame,
        so a net byte that flipped (cuDNN's transposed convs differ in the
        last bits between runs) moves it by up to about 0.6 at that pixel,
        which the fusion spreads over the full-res pixels around it and the
        sRGB curve near black turns into a few LSB there."""
        l_pad, out_ab, rh, rw, (H, W), net = state
        got = decode_image(reply)
        own = P.fullres_fuse_bucketed(l_pad, out_ab, rh,
                                      rw).cpu().numpy()[:H, :W]
        if not np.array_equal(got, own):
            die(f"{label}: the reply is not its model's own full-res frame")
        worst[label] = frame_check(f"{label}, net frame", net, want_net,
                                   *bound)
        d = np.abs(got.astype(int) - want_full.astype(int)).max(-1)
        spread.append((label, int(d.max()), float(np.mean(d != 0))))
        if spread[-1][2] >= bound[1]:
            die(f"{label} vs the API's full-res frame: {spread[-1][1:]} "
                f"(bound: share < {bound[1]})")

    fullres_check("server /colorize (full res)", replies["fullres"],
                  states["fullres"], ref.net_forward_fullres(ab, mask),
                  ref.output_rgb)
    net_small = resize_u8_half_pixel(torch.from_numpy(net_img),
                                     (S, S)).numpy()
    ref.set_image(net_small)
    tf32 = []
    for label, reply, hs in [("netres", replies["netres"], full_hints[:4])] \
            + [(f"batched{i}", conc[i][1], conc_hints[i]) for i in range(8)]:
        want = ref.net_forward_table(*hints.points_json_to_table(hs, S))
        tf32.append(B.frame_delta_stats(decode_image(reply), want))
    b_lsb = max(t[0] for t in tf32)
    b_equal = min(t[1] for t in tf32)
    if b_lsb > TF32_BOUND["max_lsb"] or b_equal < TF32_BOUND["equal"]:
        die(f"server: auto-batched frames vs f32 clicks: {b_lsb} LSB, "
            f"{b_equal:.4f} equal (TF32_BOUND {TF32_BOUND})")
    fast = ColorizeImageTorch(Xd=S)
    fast.prep_net(path=fast_weights)
    fast.load_image_array(image(14, 240, 320))
    z_ab, z_mask = (np.zeros((2, S, S), np.float32),
                    np.zeros((1, S, S), np.float32))
    fullres_check("server /colorize?model=fast", replies["fast"],
                  states["fast"],
                  fast.net_forward_fullres(z_ab, z_mask), fast.output_rgb)
    ref.load_image_array(sess_img)
    click_ms = []
    for i in range(1, len(clicks) + 1):
        t0 = time.perf_counter()
        want = ref.net_forward_table(*hints.points_json_to_table(
            clicks[:i], S))
        click_ms.append((time.perf_counter() - t0) * 1e3)
        worst[f"click{i}"] = frame_check(
            f"server session click {i}",
            decode_image(replies[f"click{i}"]), want,
            FRAME_BOUND_LSB, FRAME_BOUND_SHARE)
        if i == len(clicks):
            fullres_check("server session click ?fullres=1",
                          replies["click_fullres"], states["session"],
                          ref.get_img_fullres(), want)
    table = hints.points_json_to_table(clicks, S)
    for _ in range(30):
        t0 = time.perf_counter()
        ref.net_forward_table(*table)
        click_ms.append((time.perf_counter() - t0) * 1e3)
    for i in (0, 1):
        for n, (st, data) in enumerate(inter_got[i]):
            if st != 200:
                die(f"server: interleaved session {i} click {n}: {st}")
            worst[f"inter{i}_{n}"] = frame_check(
                f"server interleaved session {i}, click {n}",
                decode_image(data), decode_image(inter_alone[i]),
                FRAME_BOUND_LSB, FRAME_BOUND_SHARE)
    # the suggestions: the dist class on the same image, table and seed
    d = ColorizeImageTorchDist(Xd=S)
    d.prep_net(path=WEIGHTS)
    sug_err = []
    for key, img, hs, h, w, seed in (
            ("session_suggest", sess_img, clicks, S // 3, S // 2, 11),
            ("suggest", sug_img, clicks[:3], S // 4, 3 * S // 4, 12)):
        d.load_image_array(img)
        table = hints.points_json_to_table(hs, S)
        # the first call captures (its warm-up runs draw numbers); the
        # server's graph was captured in warmup: compare replay with replay
        d.suggest_table(*table, h=h, w=w, K=SUGGEST_K)
        d._generator.manual_seed(seed)
        colors, conf = d.suggest_table(*table, h=h, w=w, K=SUGGEST_K)
        got = replies[key]
        g_colors = np.asarray(got["colors"], np.int64)
        g_conf = np.asarray(got["conf"])
        if g_colors.shape != (SUGGEST_K, 3) or abs(g_conf.sum() - 1) > 1e-4 \
                or np.any(np.diff(g_conf) > 1e-6):
            die(f"server /{key}: colors {g_colors.shape}, conf {g_conf}")
        sug_err.append((key, int(np.abs(g_colors - colors).max()),
                        float(np.abs(g_conf - conf).max())))
        if sug_err[-1][1] > SUGGEST_BOUND[0] or \
                sug_err[-1][2] > SUGGEST_BOUND[1]:
            die(f"server /{key} vs suggest_table on the same seed: "
                f"{sug_err[-1][1:]} (bound {SUGGEST_BOUND})")
    g = ColorizeImageTorchCaffeGlobDist(Xd=S)
    g.prep_net(caffemodel_path=glob_weights)
    ref_small = resize_u8_half_pixel(torch.from_numpy(glob_ref), (S, S))
    hist = global_stats.extract(g._to_dev(ref_small).to(torch.float32)
                                / 255.0)["glob_ab_313"].cpu().numpy()
    g.load_image_array(glob_img)
    fullres_check("server /colorize_global", replies["global"],
                  states["global"],
                  g.net_forward_fullres(z_ab, z_mask, hist), g.output_rgb,
                  (CAFFE_FRAME_BOUND_LSB, CAFFE_FRAME_BOUND_SHARE))
    batch_stats = []
    for i in range(4):
        ref.set_image(batch_imgs[i])
        batch_stats.append(B.frame_delta_stats(
            replies["batch"][i], ref.net_forward_table(*tabs[i])))
    bb_lsb = max(t[0] for t in batch_stats)
    bb_equal = min(t[1] for t in batch_stats)
    if bb_lsb > TF32_BOUND["max_lsb"] or bb_equal < TF32_BOUND["equal"]:
        die(f"server /colorize_batch vs f32 clicks: {bb_lsb} LSB, "
            f"{bb_equal:.4f} equal (TF32_BOUND {TF32_BOUND})")
    bf_stats = [B.frame_delta_stats(decode_image(b),
                                    decode_image(replies[f"click{i}"]))
                for i, b in enumerate(bf16, 1)]

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))

    bf_psnr = min(psnr(decode_image(b), decode_image(replies[f"click{i}"]))
                  for i, b in enumerate(bf16, 1))
    bf_lsb = max(t[0] for t in bf_stats)
    bf_equal = min(t[1] for t in bf_stats)
    if bf_lsb > BF16_BOUND["max_lsb"] or bf_equal < BF16_BOUND["equal"] \
            or bf_psnr < BF16_BOUND["psnr"]:
        die(f"server bf16 clicks vs f32 clicks: {bf_lsb} LSB, {bf_equal:.4f}"
            f" equal, {bf_psnr:.2f} dB (BF16_BOUND {BF16_BOUND})")
    glob_key = "server /colorize_global"
    print(f"server replies vs the API on the same inputs: the four full-res "
          f"replies are their models' own fusions byte for byte; net frames "
          f"(full-res, fast tier, 10 session clicks + a full-res click, 2 x "
          f"5 interleaved clicks) within {FRAME_BOUND_LSB} LSB on at most "
          f"{max(v for k, v in worst.items() if k != glob_key):.2e} of the "
          f"pixels (bound {FRAME_BOUND_SHARE}); global net frame "
          f"{worst[glob_key]:.2e} (bound {CAFFE_FRAME_BOUND_SHARE}); "
          f"full-res replies vs the API's full-res frames (max LSB, share "
          f"moved; the share bounded): {spread}; "
          f"auto-batched (9 frames, {coalesced} batched forwards for 8 "
          f"concurrent) max {b_lsb} LSB, {b_equal:.4f} equal; "
          f"/colorize_batch N=4 max {bb_lsb} LSB, {bb_equal:.4f} equal "
          f"(TF32_BOUND); bf16 server vs f32 server, 10 clicks: max "
          f"{bf_lsb} LSB, {bf_equal:.4f} equal, {bf_psnr:.2f} dB "
          f"(BF16_BOUND); suggestions vs suggest_table on the same seed "
          f"(max |d color| LSB, max |d conf|; bound {SUGGEST_BOUND}): "
          f"{sug_err}")
    # where a reply's host time goes, each piece alone (host clock)
    small = decode_image(replies["click10"])
    alone = {
        "encode_png 256x256": lambda: encode_png(small),
        "decode_image 400x300": lambda: decode_image(net_png),
        "resize 400x300 -> 256 (host)": lambda: resize_u8_half_pixel(
            torch.from_numpy(net_img), (S, S)),
        "colorize_batch_table N=1 (TF32)": lambda: B.colorize_batch_table(
            ref.net, batch_imgs[:1], np.stack([tabs[0][0]]),
            np.stack([tabs[0][1]]), np.asarray([tabs[0][2]], np.int32)),
        "colorize_batch_table N=4 (TF32)": lambda: B.colorize_batch_table(
            ref.net, batch_imgs, np.stack([t[0] for t in tabs]),
            np.stack([t[1] for t in tabs]),
            np.asarray([t[2] for t in tabs], np.int32)),
    }
    for label, fn in alone.items():
        fn()
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"  alone: {label:34s} p50 {np.median(ts):8.3f} ms")
    for key, s in sorted(stats["latency"].items()):
        print(f"  server stage {key:24s} n {s['n']:3d} p50 "
              f"{s['p50_ms']:8.3f} ms p95 {s['p95_ms']:8.3f} ms")
    for key, xs in sorted(rtt.items()):
        ms = np.array(xs) * 1e3
        print(f"  HTTP round trip {key:22s} n {len(ms):3d} p50 "
              f"{np.percentile(ms, 50):8.3f} ms p95 "
              f"{np.percentile(ms, 95):8.3f} ms")
    sc = np.array(rtt["session_click"]) * 1e3
    print(f"session click over HTTP (f32, captured): p50 "
          f"{np.percentile(sc, 50):.3f} ms against the in-process captured "
          f"table click's {np.percentile(click_ms, 50):.3f} ms in this run; "
          f"auto_batch {stats['auto_batch']}")
    return phase_launches


def train_phase(entries, dev) -> dict:
    """Phase 13: training, distillation and evaluation on ``dev`` (the
    card; "cpu" rehearses the phase's control flow). Returns the phase's
    launches per kernel entry (the sixth count), read before the exported
    weights are clicked."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ideepcolor_tpu_torch.api import ColorizeImageTorch
    from ideepcolor_tpu_torch.apps import eval as ev
    from ideepcolor_tpu_torch.apps import train as train_cli
    from ideepcolor_tpu_torch.models import siggraph
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops.colorspace import rgb_to_lab
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.resize import resize_u8_pil_bilinear
    from ideepcolor_tpu_torch.train import device_data as DD
    from ideepcolor_tpu_torch.train import hints_sim as HS
    from ideepcolor_tpu_torch.train import step as TS

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for k in entries:
        k.launches = 0
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    # a. the corpus: 16 training and 8 held-out seeded images, PNG
    corpus, held = write_corpus(tmp.name)
    teacher_sd = siggraph.load_state_dict_file(WEIGHTS)

    # b. one f32 step of the teacher, batch 2 at 64x64, on dev and the CPU
    small = [resize_u8_pil_bilinear(image(1400 + i, 300, 340), (64, 64))
             for i in range(2)]
    lab = rgb_to_lab(torch.from_numpy(np.stack(small)).float() / 255.0)
    batch = {"l": lab[..., :1].permute(0, 3, 1, 2).contiguous(),
             "ab": lab[..., 1:].permute(0, 3, 1, 2).contiguous()}
    g = torch.Generator().manual_seed(7)
    draws = (torch.rand((2, HS.MAX_POINTS), generator=g),
             torch.randn((2, HS.MAX_POINTS, 2), generator=g),
             torch.randint(0, 5, (2, HS.MAX_POINTS), generator=g),
             torch.zeros(2, dtype=torch.bool))
    cfg = TS.TrainConfig(precision_name="highest")
    twin = {}
    for d in (dev, torch.device("cpu")):
        b = {k: v.to(d) for k, v in batch.items()}
        h = HS.hints_from_draws(b["ab"], *(t.to(d) for t in draws))
        st = TS.init_state(cfg, teacher_sd, device=d)
        t0 = time.perf_counter()
        st, aux = TS.make_train_step(cfg)(st, b, hints=h)
        sync()
        twin[d.type] = (float(aux["loss"]),
                        {k: v.detach().cpu() for k, v in
                         st["params"].items()},
                        [t.cpu() for t in h], time.perf_counter() - t0)
        del st
    (lc, pc, hc, sc), (lp, pp, hp, sp) = twin[dev.type], twin["cpu"]
    if not torch.equal(hc[1], hp[1]) or float((hc[0] - hp[0]).abs().max()) \
            > 1e-4:
        die("hint sampler core: the card's hints differ from the CPU's")
    loss_rel = abs(lc - lp) / abs(lp)
    dw = torch.cat([(pc[k] - pp[k]).abs().flatten() for k in pp]) / cfg.lr
    dw_max = float(dw.max())
    dw_share = float((dw > 1e-3).double().mean())
    print(f"train step, teacher f32 (highest), batch 2 at 64x64, same "
          f"weights and hints: loss {lc:.6f} on {dev.type} vs {lp:.6f} on "
          f"the CPU (relative {loss_rel:.2e}, bound {TRAIN_LOSS_BOUND}); "
          f"weights after the step: max |dw| {dw_max:.4f} lr (bound "
          f"{TRAIN_DW_BOUND} lr), {dw_share:.3e} of the {dw.numel()} "
          f"weights more than 1e-3 lr apart (bound {TRAIN_DW_SHARE}); "
          f"{dev.type} step {sc:.2f} s (first call), CPU {sp:.2f} s")
    if loss_rel > TRAIN_LOSS_BOUND or dw_max > TRAIN_DW_BOUND \
            or dw_share > TRAIN_DW_SHARE:
        die("train step: card and CPU disagree past the bounds")

    # c. throughput at the CLI's defaults: full width, TF32, remat,
    # device-resident corpus with color jitter, batch and size below
    cfg = TS.TrainConfig()
    held_before = torch.cuda.memory_allocated() / 2**30 if on_card else 0.0
    state = TS.init_state(cfg, teacher_sd, device=dev)
    ds = DD.DeviceDataset(corpus, batch_size=TRAIN_BATCH, size=TRAIN_SIZE,
                          seed=0, device=dev)
    train = TS.make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)

    def one(step_fn=train):
        return step_fn(state, next(ds), gen)[1]

    for _ in range(3):
        one()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        aux = one()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["loss"]))
    if not np.all(np.isfinite(losses)):
        die(f"train step: loss not finite: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    p50, p95 = np.percentile(times, 50), np.percentile(times, 95)
    print(f"train step, teacher (34.2 M parameters) fine-tuned at TF32, "
          f"batch {TRAIN_BATCH} at {TRAIN_SIZE}x{TRAIN_SIZE}, remat, "
          f"device-resident corpus, {TRAIN_STEPS} steps after 3 (host "
          f"clock, synchronized): p50 {p50:.3f} ms, p95 {p95:.3f} ms, "
          f"{TRAIN_BATCH * 1e3 / np.mean(times):.1f} images/s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak device memory "
          f"{peak:.3f} GiB allocated in the steps, {held_before:.3f} GiB of "
          f"it held before the train state was made")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            one()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3

    def kind(name):
        n = name.lower()
        for tag, words in (("wgrad", ("wgrad",)), ("dgrad", ("dgrad",)),
                           ("layout NCHW <-> NHWC", ("nchwtonhwc",
                                                     "nhwctonchw")),
                           ("adam", ("adam", "multi_tensor")),
                           ("conv fprop and GEMM",
                            ("fprop", "conv", "gemm", "xmma", "cutlass",
                             "cudnn", "winograd")),
                           ("copy", ("memcpy", "memset", "copy"))):
            if any(w in n for w in words):
                return tag
        return "elementwise, reductions, gathers"

    by_kind: dict = {}
    for e in kern:
        by_kind[kind(e.key)] = by_kind.get(kind(e.key), 0.0) \
            + e.self_device_time_total / 5e3
    launches = sum(e.count for e in kern) / 5
    print(f"train step under the profiler (5 steps): device busy "
          f"{busy / 5:.3f} ms per step of {wall / 5:.3f} ms, idle share "
          f"{1 - busy / max(wall, 1e-9):.3f} (against the unprofiled p50: "
          f"{1 - busy / 5 / p50:.3f}); {launches:.0f} device kernels "
          f"per step; by kind (ms per step): "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      sorted(by_kind.items(), key=lambda kv: -kv[1])))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 5e3:9.3f} ms/step "
              f"{e.count // 5:4d}x  {e.key[:100]}")
    b = next(ds)
    alone = {"augmentation (sample_batch)": lambda: next(ds),
             "hint sampler (sample_hints)":
                 lambda: HS.sample_hints(b["ab"], gen)}
    for label, fn in alone.items():
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        sync()
        print(f"  alone: {label:30s} {(time.perf_counter() - t0) * 100:.3f} "
              f"ms per call (host clock, 10 calls)")
    cfg32 = TS.TrainConfig(precision_name="highest")
    train32 = TS.make_train_step(cfg32)
    one(train32)
    sync()
    t0 = time.perf_counter()
    for _ in range(5):
        one(train32)
    sync()
    print(f"train step at f32 (highest), same shapes, 5 steps: "
          f"{(time.perf_counter() - t0) * 200:.3f} ms per step (for "
          f"information)")
    del state
    # 30 steps on one fixed batch, seeded width-0.5 init, lr 3e-3
    cfg = TS.TrainConfig(lr=3e-3, remat=False)
    state = TS.init_state(cfg, siggraph.init_state_dict(0.5, 11), device=dev)
    fixed = {k: v[:2, :, :32, :32].contiguous() for k, v in b.items()}
    h = HS.sample_hints(fixed["ab"], torch.Generator(device=dev)
                        .manual_seed(100))
    fit = TS.make_train_step(cfg)
    seen = [float(fit(state, fixed, hints=h)[1]["loss"]) for _ in range(30)]
    print(f"30 steps on one fixed batch of 2 at 32x32 (w0.5, lr 3e-3): loss "
          f"{seen[0]:.4f} "
          f"-> {seen[-1]:.4f} ({seen[-1] / seen[0]:.3f} of the first)")
    if not seen[-1] < 0.6 * seen[0]:
        die("train step: 30 steps on a fixed batch did not cut the loss by "
            "40%")
    del state

    # d. save and resume: under deterministic convolutions the resumed step
    # equals the step taken straight through, byte for byte
    torch.backends.cudnn.deterministic = True
    try:
        cfg = TS.TrainConfig(schedule="cosine", warmup_steps=1,
                             total_steps=4)
        state = TS.init_state(cfg, teacher_sd, device=dev)
        train = TS.make_train_step(cfg)
        batches = [DD.sample_batch(ds._dev, torch.Generator(device=dev)
                                   .manual_seed(i), 4, 64) for i in range(3)]

        def step_i(st, i):
            return train(st, batches[i], torch.Generator(device=dev)
                         .manual_seed(100 + i))[1]

        step_i(state, 0)
        step_i(state, 1)
        path = os.path.join(tmp.name, "state.pt")
        TS.save_train_state(path, state)
        want = float(step_i(state, 2)["loss"])
        resumed = TS.load_train_state(path, cfg, dev)
        got = float(step_i(resumed, 2)["loss"])
        same = all(torch.equal(resumed["params"][k], v)
                   for k, v in state["params"].items())
        if got != want or not same or resumed["step"] != 3:
            die(f"save / resume: loss {got} vs {want}, weights equal "
                f"{same}, step {resumed['step']}")
        del state, resumed
    finally:
        torch.backends.cudnn.deterministic = False
    print("save -> load -> step under cudnn.deterministic: loss and every "
          "weight byte-equal to the step taken straight through (cosine "
          "schedule, count restored)")

    # e. the CLIs: a fine-tune and a distillation, 10 steps each, exported
    dev_arg = [] if on_card else ["--device", "cpu"]
    exports = {}
    for label, extra in (("fine-tune", ["--init-from", WEIGHTS]),
                         ("distill w0.5", ["--distill-from", WEIGHTS,
                                           "--width", "0.5"])):
        out = os.path.join(tmp.name, label.split()[0] + ".npz")
        t0 = time.perf_counter()
        rc = train_cli.main([corpus, "--steps", str(CLI_STEPS), "--batch",
                             str(TRAIN_BATCH), "--size", str(TRAIN_SIZE),
                             "--ckpt", os.path.join(tmp.name, "ck"),
                             "--ckpt-every", str(CLI_STEPS), "--log-every",
                             "5", "--export", out] + extra + dev_arg)
        sync()
        if rc != 0:
            die(f"apps/train {label}: exit {rc}")
        exports[label] = out
        print(f"apps/train {label}: {CLI_STEPS} steps and the export in "
              f"{time.perf_counter() - t0:.2f} s")

    # f. eval of the teacher on the held-out images; K2's batched entry
    # composes every render
    net = siggraph.as_module(teacher_sd, dev)
    images = ev.load_eval_images(held, EVAL_SIZE)
    t0 = time.perf_counter()
    curve, per = ev.evaluate(net, images, EVAL_COUNTS, batch=8,
                             return_per_image=True, device=dev)
    sync()
    first_s = time.perf_counter() - t0
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        ev.evaluate(net, images, EVAL_COUNTS, batch=8, device=dev)
        sync()
        reps.append((time.perf_counter() - t0) * 1e3)
    fid = ev.hint_fidelity(net, images, batch=8, device=dev)
    fid4 = ev.hint_fidelity(net, images[:4], batch=4, counts=(1, 5),
                            device=dev)
    grid = ev.save_colorization_grid(net, images, EVAL_COUNTS,
                                     os.path.join(tmp.name, "grid.png"),
                                     device=dev)
    sync()
    phase_launches = {k.name: k.launches for k in entries}
    n_chunks = -(-len(images) // 8)
    print(f"eval of the teacher, {len(images)} held-out images at "
          f"{EVAL_SIZE}, counts {EVAL_COUNTS}, batch 8: "
          f"{np.median(reps) / n_chunks:.3f} ms per chunk of 8 images and "
          f"{len(EVAL_COUNTS)} counts (host clock, median of 3; the first "
          f"call {first_s:.2f} s); curve "
          + ", ".join(f"{k}: {v:.3f} dB" for k, v in curve.items())
          + f"; AUC {ev.curve_auc(curve):.3f} dB; fidelity {fid}; contact "
          f"sheet {os.path.getsize(grid)} bytes")
    print(f"train and eval on {dev.type}: {time.perf_counter() - t_phase:.1f}"
          f" s; launches {phase_launches}")
    if on_card:
        if phase_launches[k2.KERNEL_BATCH.name] == 0:
            die("kernel lab_to_rgb_u8_batch was not launched by the eval")
        busy_k = [k.name for k in entries if k.launches
                  and k is not k2.KERNEL_BATCH]
        if busy_k:
            die(f"kernels {busy_k} launched on the train and eval path")

    # the eval against a CPU twin with the same hint locations
    cpu_net = siggraph.as_module(teacher_sd, "cpu")
    t0 = time.perf_counter()
    curve_c = ev.evaluate(cpu_net, images, EVAL_COUNTS, batch=8,
                          device="cpu")
    fid4_c = ev.hint_fidelity(cpu_net, images[:4], batch=4, counts=(1, 5),
                              device="cpu")
    cpu_s = time.perf_counter() - t0
    d_db = max(abs(curve[k] - curve_c[k]) for k in EVAL_COUNTS)
    d_de = max(abs(fid4[k] - fid4_c[k]) for k in fid4
               if not k.startswith("radius"))
    d_r = max(abs(fid4[k] - fid4_c[k]) for k in fid4
              if k.startswith("radius"))
    print(f"eval on {dev.type} vs its CPU twin ({cpu_s:.1f} s), the same "
          f"hint locations: curve max {d_db:.2e} dB per count (bound "
          f"{EVAL_DB_BOUND}); fidelity on 4 images, counts 1 and 5: ΔE "
          f"{d_de:.3f} (bound {FID_DE_BOUND}), radii {d_r:.1f} px (bound "
          f"{FID_RADIUS_BOUND})")
    if d_db > EVAL_DB_BOUND or d_de > FID_DE_BOUND or d_r > FID_RADIUS_BOUND:
        die("eval: card and CPU disagree past the bounds")

    # each exported file serves: prep_net, then a table click
    for label, path in exports.items():
        m = ColorizeImageTorch(Xd=S, device=dev)
        m.prep_net(path=path)
        m.load_image_array(image(1500, 300, 400))
        frame = m.net_forward_table(*hints.points_json_to_table(
            session_hints(5), S))
        if not isinstance(frame, np.ndarray) or frame.shape != (S, S, 3):
            die(f"the {label} export does not serve")
        print(f"the {label} export loads in prep_net (conv1 "
              f"{tuple(m.net.model1[0].weight.shape)}) and a table click "
              f"runs on it")
    tmp.cleanup()
    return phase_launches


def frontend_phase(entries, dev, engine_fps: dict) -> dict:
    """Phase 14: the front-ends on ``dev`` (the card; "cpu" rehearses the
    phase's control flow): the Qt GUI's drawing pad (``ui/qt_gui.GUIDraw``)
    on a dist session, the video app (``apps/video.run``) with static and
    tracked hints, and the front door in subprocesses. ``engine_fps`` holds
    phase 9's StreamingSession rates without the map ("dense", "table").
    Returns the phase's launches per kernel entry (the seventh count), read
    before the references are made."""
    import contextlib
    import io
    import re
    import shutil
    import torch
    from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                          ColorizeImageTorchDist)
    from ideepcolor_tpu_torch.apps import video
    from ideepcolor_tpu_torch.data import lab_gamut
    from ideepcolor_tpu_torch.engine.streaming import StreamingSession
    from ideepcolor_tpu_torch.models import siggraph
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    from ideepcolor_tpu_torch.ops.hints import put_points_json
    from ideepcolor_tpu_torch.ops.resize import resize_u8_half_pixel
    from ideepcolor_tpu_torch.utils.imageio import encode_png, read_image

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # a. the GUI needs Qt: PyQt5 offscreen where it imports, else the
    # repository's stand-in (the module imports exactly its names)
    try:
        import PyQt5.QtWidgets  # noqa: F401
        os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
        from PyQt5.QtWidgets import QApplication
        app = QApplication.instance() or QApplication([])
        qt = "PyQt5, offscreen"
    except ImportError:
        sys.path.insert(0, "tests")
        import _fake_qt
        _fake_qt.install()
        app = None
        qt = "tests/_fake_qt.py (PyQt5 is not installed)"
    from PyQt5.QtCore import QPoint, Qt
    from ideepcolor_tpu_torch.ui import qt_gui

    class Event:
        """What the drawing pad's handlers read of a mouse or wheel
        event."""

        def __init__(self, x, y, button=Qt.LeftButton, delta=0):
            self._pos, self._button = QPoint(x, y), button
            self._delta = QPoint(0, delta)

        def pos(self):
            return self._pos

        def button(self):
            return self._button

        def angleDelta(self):
            return self._delta

    def pump():                 # the real Qt runs QTimer callbacks here
        if app is not None:
            app.processEvents()

    def gui(device, dtype=None):
        m = ColorizeImageTorch(Xd=S, device=device)
        m.prep_net(path=WEIGHTS, dtype=dtype)
        d = ColorizeImageTorchDist(Xd=S, device=device)
        d.prep_net(path=WEIGHTS, dtype=dtype)
        draw = qt_gui.GUIDraw(m, dist_model=d, load_size=S, win_size=WIN)
        shown, palettes = [], []
        draw.update_result.connect(
            lambda r: shown.append(time.perf_counter()))
        draw.suggest_colors.connect(lambda c: palettes.append(np.array(c)))
        return draw, shown, palettes

    def press(draw, shown, x, y, button=Qt.LeftButton):
        """A mouse press; its time from the press to the frame handed to
        update_result (host clock, the frame read back)."""
        n = len(shown)
        t0 = time.perf_counter()
        draw.mousePressEvent(Event(x, y, button))
        pump()
        if len(shown) != n + 1:
            die(f"GUI press at {x},{y}: {len(shown) - n} frames shown")
        return (shown[-1] - t0) * 1e3

    def host_clock(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.array(out)

    os.makedirs(os.path.join("build", "frontend"), exist_ok=True)
    img_path = os.path.join("build", "frontend", "seeded_1000x750.png")
    with open(img_path, "wb") as f:
        f.write(encode_png(image(1700, *FULLRES_HW)))

    for k in entries:
        k.launches = 0
    t_phase = time.perf_counter()
    draw, shown, palettes = gui(dev)
    t0 = time.perf_counter()
    draw.init_result(img_path)
    sync()
    load_ms = (time.perf_counter() - t0) * 1e3
    if draw.result.shape != (draw.win_h, draw.win_w, 3):
        die(f"GUI window frame {draw.result.shape}")
    rng = np.random.default_rng(14)
    xs = np.linspace(draw.dw + 24, WIN - draw.dw - 24, GUI_CLICKS // 2)
    pts = [(int(x), int(y)) for y in (WIN // 3, 2 * WIN // 3) for x in xs]
    colors = [tuple(int(v) for v in rng.integers(0, 256, 3))
              for _ in pts]
    # the scripted session: each click's table, pixel and window frame, held
    # against the API after the counts are read
    record = []
    click_ms = []
    for (x, y), color in zip(pts, colors):
        if not draw._can_fuse_suggest():
            die("GUI click: the click+suggest program is not available")
        draw.user_color = color
        click_ms.append(press(draw, shown, x, y))
        pal = palettes[-1]
        if pal.shape != (SUGGEST_K + 1, 3) or not np.all(pal[-1] == 0.5) \
                or not np.all((pal >= 0) & (pal <= 1)):
            die(f"GUI suggestion palette {pal.shape}")
        record.append(("suggest", draw.uiControl.hint_table(),
                       draw.scale_point(QPoint(x, y)), draw.result.copy()))
    if len(draw.uiControl.userEdits) != GUI_CLICKS:
        die(f"GUI: {len(draw.uiControl.userEdits)} edits of {GUI_CLICKS}")
    # a synchronous window click (it captures the window program the drag
    # submits), then a drag of DRAG_EVENTS motion events through the async
    # session
    draw.compute_result()
    record.append(("win", draw.uiControl.hint_table(), None,
                   draw.result.copy()))
    x0, y0 = pts[-1]
    sess_frames = draw._async.frames_materialized if draw._async else 0
    t0 = time.perf_counter()
    for j in range(1, DRAG_EVENTS + 1):
        draw.mouseMoveEvent(Event(x0 + j, y0))
        pump()
    sync()
    drag_s = time.perf_counter() - t0
    sess = draw._async
    painted = sess.frames_materialized - sess_frames
    if sess.frames_submitted != DRAG_EVENTS or sess.pending or not painted:
        die(f"GUI drag: {sess.frames_submitted} submitted, {painted} "
            f"painted, {sess.pending} pending")
    drag_frame = draw.result.copy()
    draw.compute_result()               # a synchronous click, same table
    frame_check("GUI drag against the synchronous click on its final "
                "table", drag_frame, draw.result, FRAME_BOUND_LSB,
                FRAME_BOUND_SHARE)
    record.append(("win", draw.uiControl.hint_table(), None,
                   draw.result.copy()))
    # a palette pick (the suggestion palette's fourth swatch), an erase, a
    # wheel step
    draw.pos = QPoint(x0 + DRAG_EVENTS, y0)
    draw.set_color((np.clip(palettes[-1][3], 0, 1) * 255).astype(np.uint8))
    record.append(("win", draw.uiControl.hint_table(), None,
                   draw.result.copy()))
    press(draw, shown, *pts[0], button=Qt.RightButton)
    if len(draw.uiControl.userEdits) != GUI_CLICKS - 1:
        die("GUI erase did not remove the point")
    record.append(("win", draw.uiControl.hint_table(), None,
                   draw.result.copy()))
    width = draw.brushWidth
    draw.wheelEvent(Event(0, 0, delta=-120))
    if draw.brushWidth == width:
        die("GUI wheel step did not change the brush")
    # timed: clicks that reselect the points with new colors (each a
    # click+suggest click)
    for i in range(GUI_TIMED_CLICKS):
        draw.user_color = colors[i % len(colors)][::-1]
        click_ms.append(press(draw, shown, *pts[1 + i % (len(pts) - 1)]))
    save_dir = draw.save_result()
    sync()
    gui_launches = {k.name: k.launches for k in entries}
    gui_s = time.perf_counter() - t_phase
    for name, want in (("ours.png", draw.result),
                       ("ours_fullres.png", draw.model.get_img_fullres()),
                       ("input_mask.png", np.repeat(
                           draw.im_mask0[0, ..., None].astype(np.uint8)
                           * 255, 3, axis=2))):
        if not np.array_equal(read_image(os.path.join(save_dir, name)),
                              want):
            die(f"GUI session save: {name} does not decode to its frame")
    for name, shape in (("im_l.npy", (1, S, S)), ("im_ab.npy", (2, S, S)),
                        ("im_mask.npy", (1, S, S))):
        if np.load(os.path.join(save_dir, name)).shape != shape:
            die(f"GUI session save: {name}")
    shutil.rmtree(save_dir)

    # bf16, timed only
    bdraw, bshown, _ = gui(dev, "bfloat16")
    bdraw.init_result(img_path)
    bf_ms = []
    for i in range(GUI_CLICKS + GUI_TIMED_CLICKS // 2):
        bdraw.user_color = colors[i % len(colors)]
        bf_ms.append(press(bdraw, bshown, *pts[i % len(pts)]))
    del bdraw
    sync()
    # f32 with the window composed on the host (IDEEPCOLOR_WIN_COMPOSE=host):
    # the scripted clicks against the device GUI's frames, then timed
    saved_compose = os.environ.get("IDEEPCOLOR_WIN_COMPOSE")
    os.environ["IDEEPCOLOR_WIN_COMPOSE"] = "host"
    try:
        hdraw, hshown, _ = gui(dev)
    finally:
        if saved_compose is None:
            os.environ.pop("IDEEPCOLOR_WIN_COMPOSE", None)
        else:
            os.environ["IDEEPCOLOR_WIN_COMPOSE"] = saved_compose
    if not hdraw._win_host:
        die("GUI: IDEEPCOLOR_WIN_COMPOSE=host was not read")
    hdraw.init_result(img_path)
    host_gui_ms, host_gui_worst = [], 0.0
    for i, ((x, y), color) in enumerate(zip(pts, colors)):
        if not hdraw._can_fuse_suggest():
            die("GUI host compose: the click+suggest program is not "
                "available")
        hdraw.user_color = color
        host_gui_ms.append(press(hdraw, hshown, x, y))
        host_gui_worst = max(host_gui_worst, frame_check(
            f"GUI click {i}, host compose, against the device compose",
            hdraw.result, record[i][3], WIN_BOUND_LSB, WIN_BOUND_SHARE))
    for i in range(GUI_TIMED_CLICKS):
        hdraw.user_color = colors[i % len(colors)][::-1]
        host_gui_ms.append(press(hdraw, hshown,
                                 *pts[1 + i % (len(pts) - 1)]))
    del hdraw
    sync()

    # b. the video app: a seeded clip of VIDEO_FRAMES PNG frames, a window
    # sliding one pixel a frame over a larger image
    for k in entries:
        k.launches = 0
    H, W = VIDEO_HW
    tmp = tempfile.TemporaryDirectory()
    frames_dir = os.path.join(tmp.name, "frames")
    os.makedirs(frames_dir)
    big = image(1800, H, W + VIDEO_FRAMES)
    for i in range(VIDEO_FRAMES):
        with open(os.path.join(frames_dir, f"f{i:04d}.png"), "wb") as f:
            f.write(encode_png(big[:, i:i + W]))
    hints = session_hints(10, seed=33)
    hints_path = os.path.join(tmp.name, "hints.json")
    with open(hints_path, "w") as f:
        json.dump(hints, f)
    shift = -S / W                # content moves 1 source px left a frame

    def translation(prev, cur):
        """The known flow of the clip, in net pixels per frame."""
        flow = np.zeros(cur.shape + (2,), np.float32)
        flow[..., 0] = shift
        return flow

    def run(tag, flow=None, extra=()):
        out = os.path.join(tmp.name, tag)
        args = video.parse_args([frames_dir, "--out", out, "--weights",
                                 WEIGHTS, "--hints", hints_path, "--size",
                                 str(S), "--device", dev.type, *extra])
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = video.run(args, flow=flow or video.farneback_flow)
        return rc, out, buf.getvalue(), err.getvalue(), \
            time.perf_counter() - t0

    runs = {}
    for tag, flow, extra in (("static", None, ()),
                             ("tracked", translation, ("--track-hints",))):
        rc, out, stdout, _, secs = run(tag, flow, extra)
        m = re.search(r"colorized (\d+) frames .* steady ([0-9.]+) fps",
                      stdout)
        if rc != 0 or m is None or int(m.group(1)) != VIDEO_FRAMES:
            die(f"video app ({tag}): rc {rc}, {stdout.strip()!r}")
        runs[tag] = (out, float(m.group(2)), secs)
    sync()
    video_launches = {k.name: k.launches for k in entries}
    # without OpenCV (made unimportable where it is installed),
    # --track-hints with its default flow exits 2 before any work
    had_cv2 = video._opencv() is not None
    saved_cv2 = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        rc, out, _, err, _ = run("untracked", None, ("--track-hints",))
    finally:
        if saved_cv2 is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved_cv2
    if rc != 2 or "cv2" not in err or os.path.exists(out):
        die(f"video app --track-hints without OpenCV: rc {rc}, "
            f"{err.strip()!r}")
    cv2_note = (f"OpenCV {'is' if had_cv2 else 'is not'} installed here; "
                f"with it unimportable, --track-hints and its default flow "
                f"exit 2 before any work: {err.strip()!r}")
    t0 = time.perf_counter()
    grays = list(video._frame_source(frames_dir))
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(grays)
    t0 = time.perf_counter()
    net_grays = [resize_u8_half_pixel(torch.from_numpy(g)[..., None],
                                      (S, S))[..., 0].numpy() for g in grays]
    resize_ms = (time.perf_counter() - t0) * 1e3 / len(grays)
    phase_launches = {k: gui_launches[k] + video_launches[k]
                      for k in gui_launches}
    print(f"front-ends on {dev.type} ({qt}): GUI {gui_s:.1f} s, launches "
          f"{gui_launches}; video app launches {video_launches}")
    if on_card:
        for label, counts, need in (
                ("GUI", gui_launches, (k1.KERNEL_BATCH, k2.KERNEL,
                                       k2.KERNEL_AB)),
                ("video app", video_launches, (k1.KERNEL_BATCH, k2.KERNEL))):
            idle = [k.name for k in need if counts[k.name] == 0]
            if idle:
                die(f"kernels {idle} were not launched by the {label}")

    # the GUI's frames against the API on the same tables, window L plane
    # and matrices
    rm = ColorizeImageTorch(Xd=S, device=dev)
    rm.prep_net(path=WEIGHTS)
    rd = ColorizeImageTorchDist(Xd=S, device=dev)
    rd.prep_net(path=WEIGHTS)
    rm.load_image(img_path)
    rd.set_image(draw.im_rgb)
    empty = (np.zeros((256, 4), np.int32), np.zeros((256, 2), np.float32), 0)
    rd.predict_dist_table(*empty)
    rm.net_forward_table(*empty)
    worst = 0.0
    for kind, table, pixel, frame in record:
        if kind == "suggest":
            want, _ = rm.net_forward_table_win_suggest(
                *table, *draw._window(), rd, pixel[1], pixel[0],
                K=SUGGEST_K)
        else:
            want = rm.net_forward_table_win(*table, *draw._window())
        worst = max(worst, frame_check(f"GUI {kind} click against the API",
                                       frame, want, FRAME_BOUND_LSB,
                                       FRAME_BOUND_SHARE))
    # the GUI click's parts, timed alone on the host clock: the API's
    # click+suggest click on the last scripted table, one gamut snap (a
    # click makes two, as the reference's)
    _, table, pixel, _ = record[GUI_CLICKS - 1]
    api_ms = host_clock(lambda: rm.net_forward_table_win_suggest(
        *table, *draw._window(), rd, pixel[1], pixel[0], K=SUGGEST_K), 30)
    snap_ms = host_clock(lambda: draw.calibrate_color(
        colors[0], QPoint(*pts[1])), 30)
    snap_l = float(draw.im_lab[S // 2, S // 2, 0])
    snap_dev_ms = host_clock(lambda: lab_gamut.snap_ab(
        snap_l, np.array(colors[0], np.uint8), device=dev), 30)
    # a CPU twin of the first GUI_CPU_CLICKS clicks
    t0 = time.perf_counter()
    cdraw, cshown, _ = gui(torch.device("cpu"))
    cdraw.init_result(img_path)
    for i, ((x, y), color) in enumerate(zip(pts[:GUI_CPU_CLICKS], colors)):
        cdraw.user_color = color
        press(cdraw, cshown, x, y)
        frame_check(f"GUI click {i} on the card against its CPU twin",
                    record[i][3], cdraw.result, FRAME_BOUND_LSB,
                    FRAME_BOUND_SHARE)
    cpu_s = time.perf_counter() - t0
    # the first clicks capture the click programs: the stats take the
    # timed re-clicks (f32) and the bf16 clicks after the first two
    ms, bms = np.array(click_ms[GUI_CLICKS:]), np.array(bf_ms[2:])
    hms = np.array(host_gui_ms[GUI_CLICKS:])
    print(f"GUI drawing pad on {dev.type} (teacher, load size {S}, window "
          f"{draw.win_w}x{draw.win_h} of {WIN}, a {FULLRES_HW[0]}x"
          f"{FULLRES_HW[1]} (HxW) PNG through init_result: {load_ms:.1f} "
          f"ms): {GUI_CLICKS} click+suggest "
          f"clicks with colors, a drag of {DRAG_EVENTS} motion events, a "
          f"palette pick, an erase, a wheel step, {GUI_TIMED_CLICKS} more "
          f"clicks and save_result; every scripted frame against the API's "
          f"window clicks on the same table, L plane and matrices: 1 LSB on"
          f" at most {worst:.2e} of the pixels; the drag equal to the "
          f"synchronous click within the bound; {GUI_CPU_CLICKS} clicks on "
          f"a CPU twin ({cpu_s:.1f} s) within the bound; the saved PNGs "
          f"decode to their frames")
    print(f"GUI click, press to update_result (host clock, window frame and"
          f" palette read back), f32: p50 {np.percentile(ms, 50):.3f} ms, "
          f"p95 {np.percentile(ms, 95):.3f} ms over {len(ms)} clicks; bf16:"
          f" p50 {np.percentile(bms, 50):.3f} ms, p95 "
          f"{np.percentile(bms, 95):.3f} ms over {len(bms)}; against the "
          f"{DISPLAY_FRAME_MS:.1f} ms display frame. f32 with the window "
          f"composed on the host (IDEEPCOLOR_WIN_COMPOSE=host): p50 "
          f"{np.percentile(hms, 50):.3f} ms, p95 "
          f"{np.percentile(hms, 95):.3f} ms over {len(hms)}, its scripted "
          f"frames against the device compose's within {WIN_BOUND_LSB} LSB"
          f" on at most {host_gui_worst:.2e} of the pixels. Alone: the API's "
          f"click+suggest click p50 {np.percentile(api_ms, 50):.3f} ms, p95 "
          f"{np.percentile(api_ms, 95):.3f} ms; one gamut snap "
          f"(calibrate_color, on the host) p50 "
          f"{np.percentile(snap_ms, 50):.3f} ms, the same snap on "
          f"{dev.type} p50 {np.percentile(snap_dev_ms, 50):.3f} ms. Drag:"
          f" {painted} frames painted for {DRAG_EVENTS} motion events, "
          f"{painted / drag_s:.1f} frames/s")

    # the video app's frames against StreamingSession on the same gray
    # frames and hints
    sd = siggraph.load_state_dict_file(WEIGHTS)
    for tag in ("static", "tracked"):
        ref = StreamingSession(sd, size=S, depth=4, with_dist=False,
                               device=dev)
        tracker = None
        if tag == "static":
            ab = np.zeros((2, S, S), np.float32)
            mask = np.zeros((1, S, S), np.float32)
            put_points_json(ab, mask, hints, S)
            ref.set_hints(ab.transpose(1, 2, 0), mask.transpose(1, 2, 0))
        else:
            tracker = video.HintTracker(hints, S, translation)
        want = []
        for g in net_grays:
            if tracker is not None:
                ref.set_hint_table(*tracker.step(g))
            r = ref.submit(g, srgb=True)
            if r is not None:
                want.append(r[0])
        want.extend(r[0] for r in ref.drain())
        out = runs[tag][0]
        names = sorted(os.listdir(out))
        if len(names) != VIDEO_FRAMES:
            die(f"video app ({tag}) wrote {len(names)} frames")
        share = max(frame_check(f"video app ({tag}) frame {i}",
                                read_image(os.path.join(out, n)), want[i],
                                FRAME_BOUND_LSB, FRAME_BOUND_SHARE)
                    for i, n in enumerate(names))
        if tracker is not None:
            moved = tracker.hints[0]["x"] - hints[0]["x"]
            if moved >= 0 and hints[0]["x"] > 0:
                die(f"tracked hints did not move with the field: {moved}")
        print(f"video app, {tag} hints ({VIDEO_FRAMES} PNG frames of "
              f"{W}x{H} at --size {S}, teacher): steady "
              f"{runs[tag][1]:.1f} fps (the run: {runs[tag][2]:.2f} s); "
              f"phase 9's engine alone, "
              f"{'table' if tracker else 'dense'} hints: "
              f"{engine_fps['table' if tracker else 'dense']:.1f} frames/s;"
              f" frames against StreamingSession on the same gray frames "
              f"and hints: 1 LSB on at most {share:.2e} of the pixels")
    print(f"video app host work per frame: PNG decode + RGB2GRAY "
          f"{decode_ms:.3f} ms, resize to {S} {resize_ms:.3f} ms; {cv2_note}")
    tmp.cleanup()

    # c. the front door, in subprocesses
    for argv, want in ((["--help"], "fidelity"),
                       (["fidelity", "--list"], "caffemodel-main-256")):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "ideepcolor_tpu_torch",
                            *argv], capture_output=True, text=True,
                           timeout=120)
        if r.returncode != 0 or want not in r.stdout:
            die(f"python -m ideepcolor_tpu_torch {' '.join(argv)}: rc "
                f"{r.returncode}, {r.stderr.strip()[-300:]!r}")
        print(f"python -m ideepcolor_tpu_torch {' '.join(argv)}: rc 0 in "
              f"{time.perf_counter() - t0:.2f} s")
    print(f"front-ends phase: {time.perf_counter() - t_phase:.1f} s")
    return phase_launches


def host_phase(entries, dev) -> dict:
    """Phase 15: the native host runtime (``ops/host.py``,
    ``native/hostops.cpp``) and the host-composed clicks on ``dev`` (the
    card; "cpu" rehearses the phase's control flow). Returns the phase's
    launches per kernel entry (the eighth count), read before the checks
    and timings that launch kernels of their own."""
    import http.client
    import threading

    import torch
    from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                          ColorizeImageTorchDist)
    from ideepcolor_tpu_torch.api.colorize import (compose_net_abq_host,
                                                   compose_window_host)
    from ideepcolor_tpu_torch.apps import serve
    from ideepcolor_tpu_torch.engine import pipeline as P
    from ideepcolor_tpu_torch.ops import hints, host
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    from ideepcolor_tpu_torch.ops.resize import (cubic_resize_matrix_np,
                                                 zoom_with_matrices)
    from ideepcolor_tpu_torch.utils.imageio import decode_image, encode_png

    on_card = dev.type == "cuda"
    if not host.available():
        die("the native host runtime is not available (no g++ here)")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def clock(fn, n, idle_s=0.0):
        out = []
        for _ in range(n):
            time.sleep(idle_s)
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.array(out)

    def pq(t):
        return f"p50 {np.percentile(t, 50):.3f} ms, p95 " \
               f"{np.percentile(t, 95):.3f} ms"

    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)

    def models(dtype=None):
        m = ColorizeImageTorch(Xd=S, device=dev)
        m.prep_net(path=WEIGHTS, dtype=dtype)
        d = ColorizeImageTorchDist(Xd=S, device=dev)
        d.prep_net(path=WEIGHTS, dtype=dtype)
        img = image(1500, *FULLRES_HW)
        m.load_image_array(img)
        d.set_image(m.img_rgb)
        return m, d

    # the window of the GUI's dist session: a WIN-px window of the image,
    # its L plane on the host (host rgb2lab) and on the device, the cubic
    # matrices
    wh, ww = WIN, WIN * FULLRES_HW[1] // FULLRES_HW[0] // 4 * 4
    win_rgb = image(1501, wh, ww)
    l_win_np = host.rgb2lab(win_rgb.astype(np.float32) / 255.0)[..., :1]
    rh_np = cubic_resize_matrix_np(S, wh)
    rw_np = cubic_resize_matrix_np(S, ww)
    l_win = torch.from_numpy(np.ascontiguousarray(l_win_np)).to(dev)
    rh, rw = torch.from_numpy(rh_np).to(dev), torch.from_numpy(rw_np).to(dev)
    host_win = (l_win_np, rh_np, rw_np)
    dev_win = (l_win, rh, rw)
    tables = [hints.points_json_to_table(session_hints(n, seed=90 + n), S)
              for n in (0, 4, 10)]
    empty = tables[0]
    pix = [(h["y"], h["x"]) for h in session_hints(len(tables), seed=95)]

    # -- the path, launches counted: the clicks of the teacher at Xd=S and
    # a server whose session clicks are abq clicks --
    sync()
    for k in entries:
        k.launches = 0
    t_phase = time.perf_counter()
    m, d = models()
    d.predict_dist_table(*empty)
    m.net_forward_table(*empty)
    rec = []
    for t, (h, w) in zip(tables, pix):
        rgb = m.net_forward_table(*t).copy()
        mirrors = (m.input_ab.copy(), m.input_mask.copy())
        abq = m.net_forward_table_abq(*t).copy()
        parked = m._dev_out_ab_val is None
        full_abq = m.get_img_fullres()
        ab_host = m.output_ab.copy()
        abq_half = m.net_forward_table_abq(*t, half=True).copy()
        win_host = m.net_forward_table_win_host(*t, *host_win)
        net_win_host = m.output_rgb.copy()
        dev_ab = m._dev_output_ab
        win_sug, colors = m.net_forward_table_suggest_host(
            *t, *host_win, d, h, w, K=SUGGEST_K)
        rec.append(dict(table=t, pixel=(h, w), rgb=rgb, mirrors=mirrors,
                        abq=abq, parked=parked, full_abq=full_abq,
                        ab_host=ab_host, abq_half=abq_half,
                        win_host=win_host, net_win_host=net_win_host,
                        dev_ab=dev_ab, win_sug=win_sug, colors=colors,
                        net_sug=m.output_rgb.copy()))
    # a server under IDEEPCOLOR_NET_CLICK=abq: ten session clicks over HTTP
    # and a full-res one
    saved_mode = os.environ.get("IDEEPCOLOR_NET_CLICK")
    os.environ["IDEEPCOLOR_NET_CLICK"] = "abq"
    try:
        srv = serve.make_server(port=0, size=S, device=dev.type,
                                weights=WEIGHTS, dtype="float32")
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        svc = srv.RequestHandlerClass.service
        svc.warmup()
        body = encode_png(image(1502, 600, 450))

        def post(path, data, ctype="application/octet-stream"):
            c = http.client.HTTPConnection(*srv.server_address, timeout=300)
            t0 = time.perf_counter()
            c.request("POST", path, body=data,
                      headers={"Content-Type": ctype})
            r = c.getresponse()
            out = r.read()
            c.close()
            if r.status != 200:
                die(f"abq server: POST {path} answered {r.status}: "
                    f"{out[:200]!r}")
            return out, (time.perf_counter() - t0) * 1e3

        sid = json.loads(post("/session", body)[0])["id"]
        served, served_ms = [], []
        for i in range(10):
            hs = session_hints(i + 1, seed=97)
            reply, ms = post(f"/session/click?id={sid}",
                             json.dumps(hs).encode(), "application/json")
            served.append((hs, decode_image(reply)))
            served_ms.append(ms)
        full_reply = decode_image(post(f"/session/click?id={sid}&fullres=1",
                                       json.dumps(hs).encode(),
                                       "application/json")[0])
        sess = svc._sessions[sid]
        full_took_rgb = sess._out_ab_host_pending is None
        srv.shutdown()
        srv.server_close()
    finally:
        if saved_mode is None:
            os.environ.pop("IDEEPCOLOR_NET_CLICK", None)
        else:
            os.environ["IDEEPCOLOR_NET_CLICK"] = saved_mode
    sync()
    phase_launches = {k.name: k.launches for k in entries}
    path_s = time.perf_counter() - t_phase
    print(f"host ops path on {dev.type} ({path_s:.1f} s: {len(tables)} "
          f"tables x (table, abq, abq_half, win_host, suggest_host clicks) "
          f"on the teacher at Xd={S}, a {wh}x{ww} window, an abq server: 10 "
          f"session clicks over HTTP and a full-res one): launches "
          f"{phase_launches}")
    if on_card:
        idle = [k.name for k in (k1.KERNEL_BATCH, k2.KERNEL_AB)
                if phase_launches[k.name] == 0]
        if idle:
            die(f"kernels {idle} were not launched on the host ops path")

    # -- checks, after the counts are read --
    # the host rasterizer bit-exact against K1's planes, boxes across the
    # edges, 10 and 200 hints; and the session's mirrors against K1's
    worst_mirror = 0
    for n in (10, 200):
        boxes, values, count = k1_table(n)
        ab, mask = host.rasterize_hints(boxes, values, count, S)
        planes = k1.rasterize_hints_planar(
            torch.from_numpy(boxes).to(dev), torch.from_numpy(values).to(dev),
            count, S).cpu().numpy()
        if not (np.array_equal(planes[:2], ab.transpose(2, 0, 1))
                and np.array_equal(planes[2:], mask.transpose(2, 0, 1))):
            die(f"host.rasterize_hints differs from K1 at {n} hints")
    for r in rec:
        b, v, c = r["table"]
        planes = k1.rasterize_hints_planar(
            torch.from_numpy(b).to(dev), torch.from_numpy(v).to(dev), c,
            S).cpu().numpy()
        if not (np.array_equal(planes[:2], r["mirrors"][0])
                and np.array_equal(planes[2:], r["mirrors"][1])):
            die("a table click's host mirrors differ from K1's planes")
    # lab2rgb_u8_planar against K2's compose at the full-res size
    rng = np.random.default_rng(1503)
    H, W = FULLRES_HW
    lab = [rng.uniform(0, 100, (H, W)), rng.uniform(-110, 110, (H, W)),
           rng.uniform(-110, 110, (H, W))]
    lab = [x.astype(np.float32) for x in lab]
    got = host.lab2rgb_u8_planar(*lab)
    want = k2.lab_to_rgb_u8_hwc(*(torch.from_numpy(x).to(dev)
                                  for x in lab)).cpu().numpy()
    d_lab = np.abs(got.astype(int) - want.astype(int))
    lab_share = float(np.mean(d_lab != 0))
    if d_lab.max() > 1 or lab_share >= 1e-3:
        die(f"host lab2rgb_u8_planar against K2: {d_lab.max()} LSB on "
            f"{lab_share:.2e} of the values")
    # zoom2_matrices against zoom_with_matrices on the card
    ab = rng.uniform(-110, 110, (S, S, 2)).astype(np.float32)
    za, zb = host.zoom2_matrices(ab[..., 0], ab[..., 1], rh_np, rw_np)
    zw = zoom_with_matrices(torch.from_numpy(ab).to(dev), rh, rw).cpu().numpy()
    zoom_err = float(max(np.abs(za - zw[..., 0]).max(),
                         np.abs(zb - zw[..., 1]).max()))
    if zoom_err > 2e-3:
        die(f"host zoom2_matrices against zoom_with_matrices: {zoom_err}")
    # the clicks against their device twins
    abq_stats, worst = {}, {}
    for r in rec:
        for kind in ("abq", "abq_half"):
            mx, share = lsb(torch.from_numpy(r[kind]),
                            torch.from_numpy(r["rgb"]))
            p = psnr(r[kind], r["rgb"])
            old = abq_stats.get(kind, (0, 0.0, float("inf")))
            abq_stats[kind] = (max(old[0], mx), max(old[1], share),
                               min(old[2], p))
        if not r["parked"]:
            die("abq click: output_ab was uploaded before a getter read it")
        H, W = m._fullres_hw
        want_full = P.fullres_fuse_bucketed(
            m._dev_l_fullres_pad, torch.from_numpy(np.ascontiguousarray(
                r["ab_host"].transpose(1, 2, 0))).to(dev), m._dev_rh,
            m._dev_rw).cpu().numpy()[:H, :W]
        if not np.array_equal(r["full_abq"], want_full):
            die("abq click: get_img_fullres does not read the host ab")
        # the host window compose against K2's compose of the same ab
        dwin = P.fullres_fuse(l_win, r["dev_ab"], rh, rw).cpu().numpy()
        worst["win_host vs K2 on the same ab"] = max(
            worst.get("win_host vs K2 on the same ab", 0), frame_check(
                "win_host window against K2's compose of the same ab",
                r["win_host"], dwin, FRAME_BOUND_LSB, FRAME_BOUND_SHARE))
        if not np.array_equal(r["win_sug"], compose_window_host(
                r["net_sug"], *host_win)):
            die("suggest_host window is not the host compose of its frame")
    for kind, (mx, share, p) in abq_stats.items():
        b_lsb, b_psnr = ABQ_BOUND[kind]
        if mx > b_lsb or p < b_psnr:
            die(f"{kind} frames against the rgb click: {mx} LSB, {p:.2f} "
                f"dB (bound {b_lsb} LSB, {b_psnr} dB)")
    # device twins on the same tables: the window click, the click+suggest
    # click (same generator state: both graphs captured first)
    for r in rec:
        t, (h, w) = r["table"], r["pixel"]
        want = m.net_forward_table_win(*t, *dev_win)
        worst["win_host vs win"] = max(worst.get("win_host vs win", 0),
                                       frame_check(
            "win_host against the device window click", r["win_host"],
            want, WIN_BOUND_LSB, WIN_BOUND_SHARE))
    t, (h, w) = rec[-1]["table"], rec[-1]["pixel"]
    m.net_forward_table_win_suggest(*t, *dev_win, d, h, w, K=SUGGEST_K)
    m.net_forward_table(*t)
    prev = m.output_rgb.copy()
    state = d._generator.get_state()
    hwin, hcol = m.net_forward_table_suggest_host(*t, *host_win, d, h, w,
                                                  K=SUGGEST_K)
    d._generator.set_state(state)
    m.net_forward_table(*t)
    dwin, dcol = m.net_forward_table_win_suggest(*t, *dev_win, d, h, w,
                                                 K=SUGGEST_K)
    if not np.array_equal(hcol[0], prev[h, w].astype(np.float32) / 255.0):
        die("suggest_host palette row 0 is not the previous frame's pixel")
    col_lsb = float(np.abs(hcol[1:] - dcol[1:]).max() * 255)
    if col_lsb > SUGGEST_BOUND[0] + 0.5:
        die(f"suggest_host suggestions against win_suggest's: {col_lsb} "
            f"LSB")
    worst["suggest_host vs win_suggest"] = frame_check(
        "suggest_host window against the click+suggest click's", hwin, dwin,
        WIN_BOUND_LSB, WIN_BOUND_SHARE)
    # the abq payload, captured, against the plain function it was
    # captured from (eager, default cuDNN kernels)
    pay_share = 0.0
    for half in (False, True):
        prog = m._click_tbl_abq_half if half else m._click_tbl_abq
        for t in tables:
            tab = m._dev_table(*t)
            cap = prog(m._dev_l_mc, *tab)[0].cpu().numpy()
            plain = prog.fn(m._dev_l_mc, *(x.t if hasattr(x, "t") else x
                                            for x in tab))[0].cpu().numpy() \
                if on_card else cap
            dd = np.abs(cap.astype(int) - plain.astype(int))
            pay_share = max(pay_share, float(np.mean(dd != 0)))
            if dd.max() > 1 or pay_share > PAYLOAD_FLIP_SHARE:
                die(f"abq payload captured vs eager: {dd.max()} steps on "
                    f"{pay_share:.2e}")
    # the abq server's replies against the API's abq click on the same
    # image and table; the full-res click took the rgb click
    ref = ColorizeImageTorch(Xd=S, device=dev)
    ref.prep_net(path=WEIGHTS)
    ref.load_image_array(decode_image(body))
    for hs, reply in served:
        worst["abq server vs API"] = max(
            worst.get("abq server vs API", 0), frame_check(
                "abq server session click against the API's abq click",
                reply, ref.net_forward_table_abq(
                    *hints.points_json_to_table(hs, S)),
                ABQ_SERVER_BOUND[0], ABQ_SERVER_BOUND[1]))
    if not full_took_rgb or full_reply.shape != (600, 450, 3):
        die("abq server: the full-res session click did not stay rgb")
    print(f"host ops checks: host.rasterize_hints bit-exact against K1 at "
          f"10 and 200 hints (boxes across the edges) and against every "
          f"session click's K1 planes; lab2rgb_u8_planar against K2's "
          f"compose at {H}x{W}: 1 LSB on {lab_share:.2e} of the values; "
          f"zoom2_matrices against zoom_with_matrices: {zoom_err:.2e}; "
          f"abq payload captured vs eager: one step on {pay_share:.2e}; "
          f"suggest_host palette row 0 exact, suggestions within "
          f"{col_lsb:.2f} LSB of win_suggest's; the lazy ab upload read by "
          f"get_img_fullres; abq server replies; the full-res session "
          f"click stayed rgb. Pixel shares differing: " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items()))
    for kind, (mx, share, p) in abq_stats.items():
        print(f"{kind} frame against the rgb click (Xd={S}, 0/4/10 "
              f"hints): max {mx} LSB, {share:.4f} of the pixels differ, "
              f"PSNR >= {p:.2f} dB")

    # -- timings (host clock, frames read back), for information --
    t = tables[-1]
    h, w = pix[-1]
    n = HOST_TIMED
    times = {}
    for name, fn in (
            ("table click (host mirrors)", lambda: m.net_forward_table(*t)),
            ("abq click", lambda: m.net_forward_table_abq(*t)),
            ("abq_half click", lambda: m.net_forward_table_abq(
                *t, half=True)),
            ("win click (device window)",
             lambda: m.net_forward_table_win(*t, *dev_win)),
            ("win_host click", lambda: m.net_forward_table_win_host(
                *t, *host_win)),
            ("click+suggest (device window)",
             lambda: m.net_forward_table_win_suggest(
                 *t, *dev_win, d, h, w, K=SUGGEST_K)),
            ("suggest_host click", lambda: m.net_forward_table_suggest_host(
                *t, *host_win, d, h, w, K=SUGGEST_K))):
        fn()
        times[name] = clock(fn, n)
    bm, _bd = models("bfloat16")
    bm.net_forward_table(*t)
    times["bf16 table click (host mirrors)"] = clock(
        lambda: bm.net_forward_table(*t), n)
    del bm, _bd
    for name, tm in times.items():
        print(f"{name}: {pq(tm)} over {n}")
    # the pieces alone: the readback the mirrors used to need, the host
    # rasterizer (and the plain K1 on the host's live slots, the drag's old
    # mirrors), the host composes back to back and, as a click meets them,
    # after 10 ms of idle (the OpenMP team has gone to sleep)
    planes = k1.rasterize_hints_planar(
        *(torch.from_numpy(x).to(dev) for x in k1_table(10)[:2]), 10, S)
    alone = {"K1 planes read back (786 KB, pageable)":
             clock(lambda: planes.cpu(), 50)}
    for n_h in (10, 200):
        bx, vx, cx = k1_table(n_h)
        alone[f"host.rasterize_hints, {n_h} hints"] = clock(
            lambda: host.rasterize_hints(bx, vx, cx, S), 50)
        tb, tv = torch.from_numpy(bx[:cx]), torch.from_numpy(vx[:cx])
        alone[f"plain K1 on the host CPU (live slots), {n_h} hints"] = \
            clock(lambda: hints.rasterize_hints(tb, tv, cx, S), 20)
    net = rec[-1]["rgb"]
    alone[f"compose_window_host {wh}x{ww}"] = clock(
        lambda: compose_window_host(net, *host_win), 50)
    alone[f"compose_window_host {wh}x{ww} after 10 ms idle"] = clock(
        lambda: compose_window_host(net, *host_win), 30, idle_s=0.01)
    l_net = m._host_l_net()
    for half in (False, True):
        prog = m._click_tbl_abq_half if half else m._click_tbl_abq
        pay = prog(m._dev_l_mc, *m._dev_table(*t))[0].cpu().numpy()
        alone[f"compose_net_abq_host{', half' if half else ''}"] = clock(
            lambda: compose_net_abq_host(l_net, pay, half=half), 50)
    for name, tm in alone.items():
        print(f"  alone: {name}: {pq(tm)}")
    print(f"abq server: session click over HTTP {pq(np.array(served_ms))} "
          f"over 10; host runtime: {host.get_lib().num_threads()} OpenMP "
          f"threads, torch {torch.get_num_threads()} intra-op threads; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return phase_launches


def mesh_phase(entries, dev, global_sd) -> dict:
    """Phase 16: the multi-device forms on ``dev`` (the card; "cpu"
    rehearses the phase's control flow): meshes whose entries all name the
    one device, so the split, padding, gather and gradient sum of a (4, 2)
    and a (2, 2, 2) mesh run as on eight devices. Returns the phase's
    launches per kernel entry (the ninth count), read before any reference
    is made."""
    import http.client
    import io
    import threading

    import torch
    from ideepcolor_tpu_torch.api import ColorizeImageTorch
    from ideepcolor_tpu_torch.apps import serve
    from ideepcolor_tpu_torch.engine import batch as B
    from ideepcolor_tpu_torch.models import caffe_net, siggraph
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    from ideepcolor_tpu_torch.ops.quantize import make_pts_grid
    from ideepcolor_tpu_torch.parallel import mesh as pmesh
    from ideepcolor_tpu_torch.train import distill as TD
    from ideepcolor_tpu_torch.train import step as TS

    on_card = dev.type == "cuda"
    # K1's batched entry rasterizes the table and suggest forms' tables,
    # its by-value entry the window's one table; K2's batched entry composes
    # every frame, its single-frame entry the palettes
    mesh_entries = (k1.KERNEL, k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_BATCH)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def clock(fn, n=MESH_TIMED):
        fn()
        sync()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    for k in entries:
        k.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    meshes = {"(1,1)": pmesh.make_mesh(1, 1, devices=[dev]),
              "(4,2)": pmesh.make_mesh(8, 2, devices=[dev] * 8),
              "(2,2,2)": pmesh.make_hybrid_mesh(2, 2, devices=[dev] * 8)}
    teacher_sd = siggraph.load_state_dict_file(WEIGHTS)
    net = siggraph.as_module(teacher_sd, dev)
    gnet = caffe_net.as_module(global_sd, dev, "global")

    # inputs: images with tables of 0-10 hints, click pixels, histograms
    # (row 0 all zero: the glob_dist=-1 sentinel), gray frames
    n_max = max(MESH_N)
    imgs = np.stack([image(1600 + i, S, S) for i in range(n_max)])
    tabs = [hints.points_json_to_table(session_hints(i % 11, 1600 + i), S)
            for i in range(n_max)]
    bx = np.stack([t[0] for t in tabs])
    vl = np.stack([t[1] for t in tabs])
    ct = np.array([t[2] for t in tabs], np.int32)
    rng = np.random.default_rng(16)
    hs = rng.integers(0, S, n_max).astype(np.int32)
    ws = rng.integers(0, S, n_max).astype(np.int32)
    glob = np.zeros((n_max, 314), np.float32)
    for i in range(1, n_max):
        bins = rng.integers(0, 313, 9)
        glob[i, bins] = rng.random(9)
        glob[i, :313] /= glob[i, :313].sum()
        glob[i, 313] = 1.0
    gray = imgs.mean(-1, keepdims=True).astype(np.uint8)

    def forms(n, n_global, **where):
        """Every mesh= batch form at n images (the global form at
        n_global), on ``where``'s mesh or device."""
        t = slice(0, n)
        return {
            "colorize_batch_table": B.colorize_batch_table(
                net, imgs[t], bx[t], vl[t], ct[t], **where),
            "colorize_batch": B.colorize_batch(net, imgs[t], **where),
            "suggest_batch_table": B.suggest_batch_table(
                net, imgs[t], bx[t], vl[t], ct[t], hs[t], ws[t],
                K=SUGGEST_K, seed=5, **where),
            "colorize_batch_global": B.colorize_batch_global(
                gnet, imgs[:n_global], glob[:n_global], **where),
            "stream_window_u8": B.stream_window_u8(net, gray[t], *tabs[10],
                                                   **where)}

    centers = torch.as_tensor(make_pts_grid(), dtype=torch.float32,
                              device=dev)

    def chunked(align, n, n_global):
        """The single-device forms run chunk by chunk as a mesh of batch
        alignment ``align`` splits the batch (padded with row 0, as it
        pads): what its positions compute, gathered."""
        parts: dict = {}
        for form, k in (("colorize_batch_table", n), ("colorize_batch", n),
                        ("suggest_batch_table", n),
                        ("colorize_batch_global", n_global),
                        ("stream_window_u8", n)):
            rows = np.array(list(range(k)) + [0] * ((-k) % align))
            m = len(rows) // align
            for j in range(align):
                c = rows[j * m:(j + 1) * m]
                if form == "colorize_batch_table":
                    out = B.colorize_batch_table(net, imgs[c], bx[c], vl[c],
                                                 ct[c], device=dev)
                elif form == "colorize_batch":
                    out = B.colorize_batch(net, imgs[c], device=dev)
                elif form == "colorize_batch_global":
                    out = B.colorize_batch_global(gnet, imgs[c], glob[c],
                                                  device=dev)
                elif form == "stream_window_u8":
                    out = B.stream_window_u8(net, gray[c], *tabs[10],
                                             device=dev)
                else:   # the palettes keep each image's global index
                    as_t = lambda a: torch.as_tensor(  # noqa: E731
                        a[c], device=dev)
                    colors, conf = B.batch_suggest_table(
                        net, B._prep_l_mc(B._images(imgs[c], dev)),
                        as_t(bx), as_t(vl), as_t(ct), as_t(hs), as_t(ws),
                        centers, seed=5, K=SUGGEST_K, index0=j * m)
                    out = (colors.cpu().numpy(), conf.cpu().numpy())
                parts.setdefault(form, []).append(out)
        return {form: (tuple(np.concatenate([o[i] for o in outs])[:n]
                             for i in range(2))
                       if isinstance(outs[0], tuple)
                       else np.concatenate(outs)[:n_global if form ==
                                                 "colorize_batch_global"
                                                 else n])
                for form, outs in parts.items()}

    # the train and distill steps: 8 seeded images at 64x64, f32
    batch = mesh_train_batch(dev)
    cfg = TS.TrainConfig(precision_name="highest")
    dcfg = TD.DistillConfig(width=0.5, precision_name="highest")
    student_sd = siggraph.load_state_dict_file("weights/student_w05.npz")
    teacher = TD.teacher_params(teacher_sd, "float32", dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(7)

    def train(mesh=None):
        """One train step of the teacher -> (loss, params whole on the
        host, host ms of the step)."""
        state = TS.init_state(cfg, teacher_sd, device=dev)
        if mesh is None:
            step = TS.make_train_step(cfg)
        else:
            step, shard_state, shard_batch = TS.make_sharded_train_step(
                cfg, mesh)
            state = shard_state(state)
        b = batch if mesh is None else shard_batch(batch)
        sync()
        t0 = time.perf_counter()
        state, aux = step(state, b, gen())
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return (float(aux["loss"]), {k: v.cpu() for k, v in
                                     TS.full_params(state["params"]).items()},
                ms)

    def distill(mesh=None):
        state = TD.init_student(dcfg, student_sd, device=dev)
        if mesh is None:
            state, aux = TD.make_distill_step(dcfg)(state, teacher, batch,
                                                    gen())
        else:
            step, shard_state, shard_batch, put_teacher = \
                TD.make_sharded_distill_step(dcfg, mesh)
            state, aux = step(shard_state(state), put_teacher(teacher),
                              shard_batch(batch), gen())
        return float(aux["loss"]), {k: v.cpu() for k, v in
                                    TS.full_params(state["params"]).items()}

    # -- the path, launches counted: the (1,1) mesh under cuDNN's
    # deterministic kernels, then the repeated meshes with its defaults --
    got = {}
    torch.backends.cudnn.deterministic = True
    try:
        m11 = meshes["(1,1)"]
        got["(1,1)", 8] = forms(8, 8, mesh=m11)
        got["(1,1)", "train"] = train(m11)
        got["(1,1)", "distill"] = distill(m11)
        for name in ("(4,2)", "(2,2,2)"):
            got[name, "chunks"] = forms(MESH_N[-1], MESH_GLOBAL_N,
                                        mesh=meshes[name])
    finally:
        torch.backends.cudnn.deterministic = False
    for name in ("(4,2)", "(2,2,2)"):
        m = meshes[name]
        for n in MESH_N:
            got[name, n] = forms(n, MESH_GLOBAL_N, mesh=m)
        got[name, "train"] = train(m)
        got[name, "distill"] = distill(m)

    # the server with --mesh where local_devices gives the card 8 times: an
    # (8, 1) mesh of alignment 8; /colorize_batch of 5 images pads to 8
    hook = pmesh.local_devices
    pmesh.local_devices = lambda device_type="cuda": [dev] * 8
    try:
        srv = serve.make_server(port=0, size=S, device=dev.type,
                                weights=WEIGHTS, dtype="float32",
                                auto_batch=8, use_mesh=True)
    finally:
        pmesh.local_devices = hook
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        def request(method, path, body=None):
            c = http.client.HTTPConnection(*srv.server_address, timeout=300)
            c.request(method, path, body=body)
            r = c.getresponse()
            data = r.read()
            c.close()
            if r.status != 200:
                die(f"mesh server: {method} {path} answered {r.status}: "
                    f"{data[:200]!r}")
            return data

        health = json.loads(request("GET", "/healthz"))
        buf = io.BytesIO()
        np.savez(buf, images=imgs[:5], boxes=bx[:5], values=vl[:5],
                 counts=ct[:5])
        with np.load(io.BytesIO(request("POST", "/colorize_batch",
                                        buf.getvalue()))) as z:
            served = z["frames"]
        svc = srv.RequestHandlerClass.service
        align = svc.batcher.align
    finally:
        srv.shutdown()
        srv.server_close()
    sync()
    path_s = time.perf_counter() - t_phase
    launches = {k.name: k.launches for k in entries}
    for k in mesh_entries:
        if on_card and launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the mesh path")

    # -- the references, after the counts --
    torch.backends.cudnn.deterministic = True
    try:
        want = forms(8, 8, device=dev)
        want_train, want_distill = train(), distill()
        want_chunks = {
            a: chunked(a, MESH_N[-1], MESH_GLOBAL_N)
            for a in {B.mesh_batch_align(meshes[k]) for k in ("(4,2)",
                                                              "(2,2,2)")}}
    finally:
        torch.backends.cudnn.deterministic = False
    for form, out in got["(1,1)", 8].items():
        pairs = zip(out, want[form]) if isinstance(out, tuple) else \
            [(out, want[form])]
        if not all(np.array_equal(a, b) for a, b in pairs):
            die(f"{form} on the (1,1) mesh differs from the single-device "
                f"form under deterministic convolutions")
    for label, (loss, params, *_), (w_loss, w_params, *_) in (
            ("train", got["(1,1)", "train"], want_train),
            ("distill", got["(1,1)", "distill"], want_distill)):
        if loss != w_loss or not all(torch.equal(params[k], w_params[k])
                                     for k in w_params):
            die(f"the {label} step on the (1,1) mesh differs from the "
                f"single-device step")
    print(f"mesh (1,1) on {dev}, deterministic convolutions: "
          f"{', '.join(want)} (N=8, K={SUGGEST_K}, T=8), the teacher's f32 "
          f"train step (batch {MESH_TRAIN_BATCH} at {MESH_TRAIN_SIZE}x"
          f"{MESH_TRAIN_SIZE}) and a w0.5 distill step: byte for byte the "
          f"single-device forms' (frames, palettes, loss, every param)")

    for name in ("(4,2)", "(2,2,2)"):
        ref = want_chunks[B.mesh_batch_align(meshes[name])]
        for form, out in got[name, "chunks"].items():
            pairs = zip(out, ref[form]) if isinstance(out, tuple) else \
                [(out, ref[form])]
            if not all(np.array_equal(a, b) for a, b in pairs):
                die(f"{form} N={MESH_N[-1]} on the {name} mesh differs from "
                    f"the single-device form run chunk by chunk under "
                    f"deterministic convolutions")
    print(f"meshes (4,2) and (2,2,2) over {dev} x8, deterministic "
          f"convolutions, N={MESH_N[-1]} padded to 20 (global "
          f"N={MESH_GLOBAL_N} to 8): every form, palettes and confidences "
          f"included, byte for byte the single-device forms run chunk by "
          f"chunk as the mesh splits the batch")

    refs = {n: forms(n, MESH_GLOBAL_N, device=dev) for n in MESH_N}
    worst, palettes = {}, []
    for name in ("(4,2)", "(2,2,2)"):
        for n in MESH_N:
            for form, out in got[name, n].items():
                ref = refs[n][form]
                if form == "suggest_batch_table":
                    d = np.abs(out[0].astype(int) - ref[0].astype(int))
                    palettes.append((f"{name} N={n}", int(d.max()),
                                     float(np.mean(d != 0))))
                    continue
                moved = frame_check(f"{form} N={n} on the {name} mesh", out,
                                    ref, *MESH_FRAME_BOUND)
                worst[form] = max(worst.get(form, 0.0), moved)
    print(f"meshes (4,2) and (2,2,2) over {dev} x8, default convolutions, "
          f"N={' and '.join(map(str, MESH_N))} (global N={MESH_GLOBAL_N}) "
          f"against the unsharded call on the whole batch (TF32 chunks of "
          f"4-5 against a batch of 16-19): frames within "
          f"{MESH_FRAME_BOUND[0]} LSB on < {MESH_FRAME_BOUND[1]} of the "
          f"pixels (most moved: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + "); palettes, for information (the TF32 dist forward moves "
          "sampled bins and the k-means may settle elsewhere): "
          + ", ".join(f"{k} max {m} LSB on {f:.2e} of the values"
                      for k, m, f in palettes))

    ref_train = train()
    train_ms = {"one device": float(np.median(
        [ref_train[2]] + [train()[2] for _ in range(2)]))}
    for label, ref in (("train", ref_train), ("distill", distill())):
        for name in ("(4,2)", "(2,2,2)"):
            loss, params = got[name, label][:2]
            loss_rel = abs(loss - ref[0]) / abs(ref[0])
            lr = cfg.lr if label == "train" else dcfg.lr
            dw = torch.cat([(params[k] - ref[1][k]).abs().flatten()
                            for k in ref[1]]) / lr
            dw_max, dw_share = float(dw.max()), float((dw > 1e-3).double()
                                                      .mean())
            print(f"{label} step on the {name} mesh against one device "
                  f"(f32 highest, same weights and generator): loss "
                  f"relative {loss_rel:.2e} (bound {TRAIN_LOSS_BOUND}); max "
                  f"|dw| {dw_max:.4f} lr (bound {TRAIN_DW_BOUND}), "
                  f"{dw_share:.3e} of the weights more than 1e-3 lr apart "
                  f"(bound {TRAIN_DW_SHARE})")
            if loss_rel > TRAIN_LOSS_BOUND or dw_max > TRAIN_DW_BOUND \
                    or dw_share > TRAIN_DW_SHARE:
                die(f"{label} step on the {name} mesh: past the bounds")

    # the server's frames: against the unsharded table form, and against
    # the API's f32 table clicks (the batch runs at TF32)
    if health["mesh"] != {"data": 8, "model": 1} or align != 8:
        die(f"mesh server: health mesh {health['mesh']}, alignment {align}")
    plain = B.colorize_batch_table(net, imgs[:5], bx[:5], vl[:5], ct[:5],
                                   device=dev)
    moved = frame_check("mesh server /colorize_batch against the unsharded "
                        "form", served, plain, *MESH_FRAME_BOUND)
    api = ColorizeImageTorch(Xd=S, device=dev)
    api.prep_net(path=WEIGHTS)
    clicks = []
    for i in range(5):
        api.set_image(imgs[i])
        clicks.append(api.net_forward_table(*tabs[i]).copy())
    s_lsb, s_equal = B.frame_delta_stats(served, np.stack(clicks))
    if s_lsb > TF32_BOUND["max_lsb"] or s_equal < TF32_BOUND["equal"]:
        die(f"mesh server /colorize_batch against the API's clicks: {s_lsb} "
            f"LSB, {s_equal:.4f} equal")
    print(f"server --mesh (local_devices gives {dev} 8 times): health mesh "
          f"{health['mesh']}, auto-batch alignment {align}; /colorize_batch "
          f"N=5 (padded to 8, chunks of 1): {moved:.2e} of the pixels 1 LSB "
          f"from the unsharded call, and {s_lsb} LSB, {s_equal:.4f} of the "
          f"pixels equal against the "
          f"API's f32 table clicks (bounds {TF32_BOUND['max_lsb']} LSB, "
          f"{TF32_BOUND['equal']})")

    # times on the host clock: on one card the split, copies and gather of
    # a repeated mesh, not scaling
    smi = ""
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    n = MESH_N[0]
    t_single = clock(lambda: B.colorize_batch_table(
        net, imgs[:n], bx[:n], vl[:n], ct[:n], device=dev))
    t_mesh = {name: clock(lambda: B.colorize_batch_table(
        net, imgs[:n], bx[:n], vl[:n], ct[:n], mesh=meshes[name]))
        for name in ("(4,2)", "(2,2,2)")}
    for name in ("(1,1)", "(4,2)", "(2,2,2)"):
        train_ms[name + " mesh"] = float(np.median(
            [train(meshes[name])[2] for _ in range(3)]))
    peak = (torch.cuda.max_memory_allocated() / 2**30) if on_card else 0.0
    print(f"mesh times on one card ({smi or dev}; the split, copy and "
          f"gather of a mesh that repeats the card, not scaling; host clock, "
          f"median of {MESH_TIMED}, frames read back): colorize_batch_table "
          f"N={n} unsharded {t_single:.2f} ms, "
          + ", ".join(f"on the {k} mesh {v:.2f} ms" for k, v in
                      t_mesh.items())
          + "; one f32 train step of the teacher (batch "
          f"{MESH_TRAIN_BATCH} at {MESH_TRAIN_SIZE}x{MESH_TRAIN_SIZE}, "
          "median of 3): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in train_ms.items()))
    print(f"mesh phase: path {path_s:.1f} s, whole phase "
          f"{time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{peak:.3f} GiB allocated; launches on the mesh path "
          + ", ".join(f"{k.name} {launches[k.name]}" for k in entries))
    return launches


def mesh_steps(kind: str, mesh, dev, weights: dict):
    """Phase 17's sharded step of ``kind`` ("train": the teacher's f32
    step; "distill": the w0.5 student's) on ``mesh`` -> (state, run), where
    ``run(state, seed)`` takes one step on phase 16's batch with a
    generator seeded ``seed`` on ``dev`` and returns (state, aux)."""
    import torch
    from ideepcolor_tpu_torch.train import distill as TD
    from ideepcolor_tpu_torch.train import step as TS

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    batch = weights["batch"]
    if kind == "train":
        cfg = TS.TrainConfig(precision_name="highest")
        step, shard_state, shard_batch = TS.make_sharded_train_step(cfg,
                                                                    mesh)
        state = shard_state(TS.init_state(cfg, weights["teacher"],
                                          device=dev))
        return state, lambda st, seed: step(st, shard_batch(batch),
                                            gen(seed))
    dcfg = TD.DistillConfig(width=0.5, precision_name="highest")
    step, shard_state, shard_batch, put_teacher = \
        TD.make_sharded_distill_step(dcfg, mesh)
    state = shard_state(TD.init_student(dcfg, weights["student"],
                                        device=dev))
    teacher = put_teacher(TD.teacher_params(weights["teacher"], "float32",
                                            dev))
    return state, lambda st, seed: step(st, teacher, shard_batch(batch),
                                        gen(seed))


def mesh_step_weights(dev) -> dict:
    from ideepcolor_tpu_torch.models import siggraph
    return {"batch": mesh_train_batch(dev),
            "teacher": siggraph.load_state_dict_file(WEIGHTS),
            "student": siggraph.load_state_dict_file(
                "weights/student_w05.npz")}


def mp_meshes(devs) -> dict:
    """Phase 17's meshes over ``devs`` (per rank, or all of one process):
    the hybrid (2, 2, 2) mesh and make_mesh(8, 2)."""
    from ideepcolor_tpu_torch.parallel import mesh as pmesh
    return {"(2,2,2)": pmesh.make_hybrid_mesh(2, 2, devices=devs),
            "(4,2)": pmesh.make_mesh(8, 2, devices=devs)}


def mesh_rank(rank: int, work: str, dev_name: str, corpus: str) -> None:
    """Phase 17's rank ``rank`` of MP_WORLD, spawned by
    :func:`process_mesh_phase`: joins a gloo group over a file store in
    ``work`` and writes what it saw to ``work/rank<rank>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist
    # the loopback: the card's machine has no other network
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "store"),
        rank=rank, world_size=MP_WORLD,
        timeout=datetime.timedelta(seconds=MP_DEADLINE_S))
    try:
        out = mesh_rank_body(rank, work, dev, corpus)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def mesh_rank_body(rank: int, work: str, dev, corpus: str) -> dict:
    import contextlib
    import io

    import torch
    from ideepcolor_tpu_torch.apps import serve
    from ideepcolor_tpu_torch.apps import train as train_cli
    from ideepcolor_tpu_torch.engine import batch as B
    from ideepcolor_tpu_torch.models import siggraph
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    from ideepcolor_tpu_torch.parallel import mesh as pmesh
    from ideepcolor_tpu_torch.train import step as TS

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    torch.backends.cudnn.deterministic = True
    meshes = mp_meshes([dev] * 4)
    out: dict = {"meshes": {name: (dict(m.shape), m.ranks.tolist(),
                                   m.local_positions())
                            for name, m in meshes.items()}}
    weights = mesh_step_weights(dev)
    for name, m in meshes.items():
        for kind in ("train", "distill"):
            state, run = mesh_steps(kind, m, dev, weights)
            res: dict = {"loss": [], "digests": []}
            for seed in (7, 8):
                state, aux = run(state, seed)
                res["loss"].append(float(aux["loss"]))
                res["digests"].append(params_digest(
                    TS.full_params(state["params"])))
                if seed == 7:
                    TS.save_train_state(
                        os.path.join(work, f"{kind}_{name}.pt"), state)
            if kind == "train" and name == "(2,2,2)":
                res["step_ms"] = []
                for _ in range(MESH_TIMED):
                    sync()
                    t0 = time.perf_counter()
                    state, _ = run(state, 9)
                    sync()
                    res["step_ms"].append((time.perf_counter() - t0) * 1e3)
                grads = [p.grad for g in state["opt"].param_groups
                         for p in g["params"] if p.grad is not None]
                res["grad_values"] = sum(g.numel() for g in grads)
                res["all_reduce_ms"] = []
                for _ in range(MESH_TIMED):
                    sync()
                    t0 = time.perf_counter()
                    TS.mean_over_processes(grads)
                    sync()
                    res["all_reduce_ms"].append(
                        (time.perf_counter() - t0) * 1e3)
            out[kind, name] = res
            del state, run

    # the refusals, before any work: no kernel may have launched
    hm = meshes["(2,2,2)"]
    net = siggraph.as_module(weights["teacher"], dev)
    imgs = np.stack([image(1600 + i, S, S) for i in range(4)])
    table = np.zeros((4, 256, 4), np.int32), np.zeros((4, 256, 2),
                                                      np.float32)
    out["refusals"] = {}
    for name, call in (
            ("colorize_batch_table", lambda: B.colorize_batch_table(
                net, imgs, *table, np.zeros(4, np.int32), mesh=hm)),
            ("ColorizeService", lambda: serve.ColorizeService(
                weights=WEIGHTS, dtype="float32", device=dev.type))):
        try:
            call()
            out["refusals"][name] = None
        except (ValueError, RuntimeError) as e:
            out["refusals"][name] = str(e)
    out["launches"] = sum(k.launches for k in (
        k1.KERNEL, k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
        k2.KERNEL_BATCH))

    # the train app in both ranks, on the card given twice per rank: a
    # (4, 1) mesh across the ranks; each file it saves is counted
    saved = []
    real_save, hook = torch.save, pmesh.local_devices

    def save(obj, f, *a, **kw):
        saved.append(os.path.basename(f))
        return real_save(obj, f, *a, **kw)
    torch.save = save
    pmesh.local_devices = lambda device_type="cuda": [dev] * 2
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(
                [corpus, "--steps", str(MP_APP_STEPS), "--batch",
                 str(MP_APP_BATCH), "--size", str(MESH_TRAIN_SIZE), "--ckpt",
                 os.path.join(work, "app_ck"), "--ckpt-every", "2",
                 "--log-every", "2", "--init-from", WEIGHTS, "--export",
                 os.path.join(work, "app.pth")]
                + ([] if dev.type == "cuda" else ["--device", "cpu"]))
    finally:
        torch.save, pmesh.local_devices = real_save, hook
    out["app"] = {"rc": rc, "stdout": buf.getvalue(), "saved": saved,
                  "s": time.perf_counter() - t0}
    return out


def process_mesh_phase(dev) -> None:
    """Phase 17: the mesh across two processes on ``dev`` (the card;
    "cpu" rehearses the phase). Two ranks spawned into one gloo group run
    the (2, 2, 2) hybrid mesh and make_mesh(8, 2), each giving its device
    four times, against this process's meshes of the same shapes. It
    launches no kernel of its own: training never did."""
    import torch
    import torch.multiprocessing as mp
    from ideepcolor_tpu_torch.models import siggraph
    from ideepcolor_tpu_torch.train import distill as TD
    from ideepcolor_tpu_torch.train import step as TS

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    os.makedirs(os.path.join(tmp.name, "corpus"))
    corpus, _ = write_corpus(os.path.join(tmp.name, "corpus"))
    work = os.path.join(tmp.name, "work")
    os.makedirs(work)
    ctx = mp.start_processes(mesh_rank, args=(work, str(dev), corpus),
                             nprocs=MP_WORLD, join=False,
                             start_method="spawn")
    end = time.monotonic() + MP_DEADLINE_S
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.1)):
            if time.monotonic() >= end:
                die(f"phase 17: the ranks still ran after {MP_DEADLINE_S} "
                    f"s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        die(f"phase 17: a rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(30)
    ranks_s = time.perf_counter() - t_phase
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"),
                       weights_only=False) for r in range(MP_WORLD)]

    # the meshes: rank r drives the dcn = r slab of the hybrid mesh and the
    # rows of its devices, rank-major, of make_mesh(8, 2)
    want_ranks = {"(2,2,2)": [[[0, 0], [0, 0]], [[1, 1], [1, 1]]],
                  "(4,2)": [[0, 0], [0, 0], [1, 1], [1, 1]]}
    for r, o in enumerate(outs):
        for name in MP_MESHES:
            shape, ranks, local = o["meshes"][name]
            grid = np.array(want_ranks[name])
            if ranks != want_ranks[name] or list(shape.values()) != list(
                    grid.shape) or local != [p for p in np.ndindex(
                        grid.shape) if grid[p] == r]:
                die(f"phase 17: rank {r}'s {name} mesh: {shape}, ranks "
                    f"{ranks}, local {local}")

    # the same steps in this process on meshes of the card x8, under the
    # same deterministic kernels
    single = mp_meshes([dev] * 8)
    weights = mesh_step_weights(dev)
    refs, one_ms = {}, []
    torch.backends.cudnn.deterministic = True
    try:
        for name in MP_MESHES:
            for kind in ("train", "distill"):
                state, run = mesh_steps(kind, single[name], dev, weights)
                state, aux = run(state, 7)
                refs[kind, name] = (float(aux["loss"]), {
                    k: v.to("cpu", copy=True) for k, v in
                    TS.full_params(state["params"]).items()})
                if kind == "train" and name == "(2,2,2)":
                    for _ in range(MESH_TIMED):
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, _ = run(state, 9)
                        if dev.type == "cuda":
                            torch.cuda.synchronize()
                        one_ms.append((time.perf_counter() - t0) * 1e3)
                del state, run
    finally:
        torch.backends.cudnn.deterministic = False

    lrs = {"train": TS.TrainConfig().lr, "distill": TD.DistillConfig().lr}
    for name in MP_MESHES:
        for kind in ("train", "distill"):
            a, b = outs[0][kind, name], outs[1][kind, name]
            if a["digests"] != b["digests"] or a["loss"] != b["loss"]:
                die(f"phase 17: the ranks' {kind} params or losses differ on "
                    f"the {name} mesh")
            path = os.path.join(work, f"{kind}_{name}.pt")
            loaded = (TS.load_train_state(path, TS.TrainConfig(), dev)
                      if kind == "train" else TD.load_student_state(
                          path, TD.DistillConfig(width=0.5), dev))
            if params_digest(loaded["params"]) != a["digests"][0]:
                die(f"phase 17: rank 0's {kind} state file on the {name} "
                    f"mesh does not load with rank 0's params")
            ref_loss, ref = refs[kind, name]
            loss_rel = abs(a["loss"][0] - ref_loss) / abs(ref_loss)
            dw = torch.cat([(loaded["params"][k].detach().cpu() - ref[k])
                            .abs().flatten() for k in ref]) / lrs[kind]
            dw_max, share = float(dw.max()), float((dw > 1e-3).double()
                                                   .mean())
            print(f"{kind} step on the {name} mesh across {MP_WORLD} "
                  f"processes against one process (deterministic kernels, "
                  f"same weights and generator): the ranks' params byte "
                  f"for byte equal after both steps; loss relative "
                  f"{loss_rel:.2e} (bound {MP_LOSS_BOUND}); max |dw| "
                  f"{dw_max:.4f} lr (bound {TRAIN_DW_BOUND}), {share:.3e} "
                  f"of the weights more than 1e-3 lr apart (bound "
                  f"{TRAIN_DW_SHARE}); rank 0's state file loads on one "
                  f"device with rank 0's params")
            if loss_rel > MP_LOSS_BOUND or dw_max > TRAIN_DW_BOUND \
                    or share > TRAIN_DW_SHARE:
                die(f"phase 17: the {kind} step on the {name} mesh across "
                    f"processes is past the bounds")

    for r, o in enumerate(outs):
        ref = o["refusals"]
        if not (ref["colorize_batch_table"] or "").count("not addressable") \
                or "one process" not in (ref["ColorizeService"] or ""):
            die(f"phase 17: rank {r} did not refuse: {ref}")
        if o["launches"]:
            die(f"phase 17: rank {r} launched {o['launches']} kernels")
    print(f"refusals in both ranks, before any work (0 kernel launches): "
          f"colorize_batch_table(mesh=(2,2,2)): "
          f"{outs[0]['refusals']['colorize_batch_table'][:80]}...; "
          f"ColorizeService: {outs[0]['refusals']['ColorizeService']}")

    apps = [o["app"] for o in outs]
    files = sorted(f for f in os.listdir(work) if f.startswith("app"))
    if [a["rc"] for a in apps] != [0] * MP_WORLD or apps[1]["stdout"] \
            or apps[1]["saved"] or apps[0]["saved"] != [
                "app_ck_2.pt", "app_ck_4.pt", "app.pth"] \
            or files != ["app.pth", "app_ck_2.pt", "app_ck_4.pt"] \
            or f"step {MP_APP_STEPS}: loss=" not in apps[0]["stdout"]:
        die(f"phase 17: apps/train in two ranks: {apps}, files {files}")
    if TS.load_train_state(os.path.join(work, "app_ck_4.pt"),
                           TS.TrainConfig(), dev)["step"] != MP_APP_STEPS:
        die("phase 17: the app's last state does not load at its step")
    siggraph.SIGGRAPHGenerator().load_state_dict(torch.load(
        os.path.join(work, "app.pth"), weights_only=True), strict=True)
    mesh_line = next(line for line in apps[0]["stdout"].splitlines()
                     if line.startswith("mesh:"))
    print(f"apps/train in {MP_WORLD} ranks ({mesh_line}; --batch "
          f"{MP_APP_BATCH} --size {MESH_TRAIN_SIZE}, {MP_APP_STEPS} steps, "
          f"--ckpt-every 2, --export .pth): {apps[0]['s']:.1f} s; rank 0 "
          f"alone printed and saved {', '.join(apps[0]['saved'])}, once "
          f"each; the last state loads on one device, the .pth strictly")

    smi = dev.type
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    timed = [o["train", "(2,2,2)"] for o in outs]
    print(f"mesh across processes, times on one card ({smi}; host clock, "
          f"median of {MESH_TIMED}; two ranks share the card, so this is "
          f"the cost of the split and the gloo all-reduce, not scaling): "
          f"the teacher's f32 train step (batch {MESH_TRAIN_BATCH} at "
          f"{MESH_TRAIN_SIZE}x{MESH_TRAIN_SIZE}) on the (2,2,2) mesh, one "
          f"process {np.median(one_ms):.2f} ms, two ranks "
          + ", ".join(f"rank {r} {np.median(t['step_ms']):.2f} ms"
                      for r, t in enumerate(timed))
          + f"; the gradient all-reduce alone ({timed[0]['grad_values']} "
          f"f32 values, gloo through the host) "
          + ", ".join(f"rank {r} {np.median(t['all_reduce_ms']):.2f} ms"
                      for r, t in enumerate(timed))
          + f"; phase: ranks {ranks_s:.1f} s, whole "
          f"{time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()


def doors_phase(entries, dev_name: str = "cuda") -> dict:
    """Phase 18: the reference's doors, in a child process (``python3
    chip_smoke.py --doors-child WORK DEVICE``) whose sys.path starts with
    the port's drop-in root, so that ``data`` and ``caffe`` are the port's
    and not the repository root's (the JAX package's drop-ins). The child
    reads its own launch counts (they live in its process) and writes them
    into WORK/doors.json; it exits non-zero on any failed check. Returns
    the counts. ``dev_name="cpu"`` rehearses the phase."""
    t0 = time.perf_counter()
    work = tempfile.TemporaryDirectory()
    env = {**os.environ, "MPLBACKEND": "Agg"}
    try:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--doors-child",
             work.name, dev_name], cwd=work.name, env=env,
            timeout=DOORS_DEADLINE_S)
    except subprocess.TimeoutExpired:
        die(f"phase 18: the child still ran after {DOORS_DEADLINE_S} s")
    if res.returncode != 0:
        die(f"phase 18: the child failed (exit {res.returncode})")
    with open(os.path.join(work.name, "doors.json")) as f:
        report = json.load(f)
    work.cleanup()
    launches = {k.name: report["launches"].get(k.name, 0) for k in entries}
    print(f"phase 18, the reference's doors: {time.perf_counter() - t0:.1f} "
          f"s with the child's start, launches {launches}")
    return launches


def _stand_in_pyplot() -> list:
    """A ``matplotlib.pyplot`` that records its calls, for a machine
    without matplotlib: the notebooks' plotting only; every device call in
    them runs for real. Returns the list the calls go to."""
    import types
    calls: list = []
    plt = types.ModuleType("matplotlib.pyplot")
    for name in ("figure", "imshow", "title", "axis", "colorbar", "xlabel",
                 "ylabel", "show", "close", "subplot"):
        setattr(plt, name, lambda *a, _n=name, **k: calls.append(_n))
    mpl = types.ModuleType("matplotlib")
    mpl.pyplot = plt
    sys.modules["matplotlib"], sys.modules["matplotlib.pyplot"] = mpl, plt
    return calls


def doors_child(work: str, dev_name: str) -> int:
    """The child of phase 18: the reference's code through the drop-in
    root on ``dev_name``, launches counted, then every comparison. See the
    module docstring, phase 18."""
    sys.path.insert(0, COMPAT_DIR)
    repo = os.path.dirname(os.path.dirname(COMPAT_DIR))
    import torch
    torch.backends.cudnn.deterministic = True     # byte-for-byte checks
    import caffe
    from data import colorize_image as CI
    from ideepcolor_tpu_torch import api
    from ideepcolor_tpu_torch.apps import convert
    from ideepcolor_tpu_torch.models import caffe_net, caffemodel_io
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops.cuda import build
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import global_stats_kernel as k3
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    from ideepcolor_tpu_torch.utils.imageio import encode_png
    from ideepcolor_tpu_torch.utils.notebook import run_cells
    on_card = dev_name != "cpu"
    gpu_id = 0 if on_card else -1
    dev = torch.device(dev_name)
    entries = (k1.KERNEL, k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
               k2.KERNEL_BATCH, k3.KERNEL)
    if on_card:
        build.build_all(entries)                  # built by the parent
    teacher = os.path.join(repo, WEIGHTS)
    files = {"data.colorize_image": CI.__file__, "caffe": caffe.__file__}
    for mod, path in files.items():
        if not os.path.abspath(path).startswith(COMPAT_DIR):
            die(f"phase 18: {mod} resolves to {path}, not the drop-in root")

    # the files the reference's code reads: the notebooks' images at their
    # paths, the session's image, seeded calibrated Caffe weights of each
    # graph as .caffemodel
    imgs = os.path.join(work, "test_imgs")
    os.makedirs(os.path.join(imgs, "global_ref_bird"))
    img_path = os.path.join(imgs, "mortar_pestle.jpg")
    ref_path = os.path.join(imgs, "global_ref_bird",
                            "ILSVRC2012_val_00002383.JPEG")
    gray = image(6, 480, 640).mean(-1).astype(np.uint8)
    for path, img in ((img_path, image(5, *FULLRES_HW)),
                      (ref_path, image(9, 375, 500)),
                      (os.path.join(imgs, "bird_gray.jpg"),
                       np.repeat(gray[..., None], 3, -1))):
        with open(path, "wb") as f:
            f.write(encode_png(img))
    caffemodel = {}
    for v in caffe_net.VARIANTS:
        caffemodel[v] = os.path.join(work, f"{v}.caffemodel")
        with open(caffemodel[v], "wb") as f:
            f.write(caffemodel_io.encode_caffemodel(
                caffemodel_io.layers_from_state_dict(caffe_net.init_state_dict(
                    v, seed=CAFFE_SEED, calibrate=True))))
    try:
        import matplotlib.pyplot  # noqa: F401
        plot_calls = None
    except ImportError:
        plot_calls = _stand_in_pyplot()
        print("phase 18: no matplotlib on this machine; the notebooks plot "
              "into a stand-in matplotlib.pyplot that records the calls")

    clicks = session_hints(DOORS_CLICKS, seed=18)
    for c in clicks:                  # put_point's slice needs the margin
        c["y"] = min(max(c["y"], c["radius"]), S - 1 - c["radius"])
        c["x"] = min(max(c["x"], c["radius"]), S - 1 - c["radius"])

    def teacher_session(model, timed=None):
        """The reference's local-hints pattern at Xd=256: ten dense clicks
        that add a point each (the notebook's put_point), each followed by
        the table click of the same points, then the getters."""
        model.load_image(img_path)
        out = {}
        ab, mask = np.zeros((2, S, S)), np.zeros((1, S, S))
        for i, c in enumerate(clicks):
            hints.put_point(ab, mask, [c["y"], c["x"]], c["radius"], c["ab"])
            out[f"dense{i}"] = model.net_forward(ab, mask).copy()
            out[f"ab_dense{i}"] = model.output_ab.copy()
            out[f"table{i}"] = model.net_forward_table(
                *hints.points_json_to_table(clicks[:i + 1], S)).copy()
        out["fullres"] = model.get_img_fullres()
        out["mask_fullres"] = model.get_img_mask_fullres()
        out["input_fullres"] = model.get_input_img_fullres()
        return out, (ab, mask)

    def global_pattern(gid):
        """DemoGlobalHistogramTransfer's reference pattern (``import
        caffe``, blob stuffing) at Xd=256 with the seeded global net."""
        cid = CI.ColorizeImageCaffeGlobDist(S)
        cid.prep_net(gid, prototxt_path='./models/global_model/'
                     'deploy_nodist.prototxt',
                     caffemodel_path=caffemodel["global"])
        gt_glob_net = caffe.Net('./models/global_model/global_stats.prototxt',
                                './models/global_model/dummy.caffemodel',
                                caffe.TEST)
        cid.load_image(img_path)
        input_ab, input_mask = np.zeros((2, S, S)), np.zeros((1, S, S))
        out = {"auto": cid.net_forward(input_ab, input_mask).copy(),
               "ab_auto": cid.output_ab.copy()}
        ref_img_fullres = caffe.io.load_image(ref_path)
        img_glob_dist = (255 * caffe.io.resize_image(
            ref_img_fullres, (256, 256))).astype('uint8')
        gt_glob_net.blobs['img_bgr'].data[...] = \
            img_glob_dist[:, :, ::-1].transpose((2, 0, 1))
        gt_glob_net.forward()
        out["glob"] = gt_glob_net.blobs['gt_glob_ab_313_drop'] \
            .data[0, :-1, 0, 0].copy()
        out["pred"] = cid.net_forward(input_ab, input_mask,
                                      out["glob"]).copy()
        out["ab_pred"] = cid.output_ab.copy()
        out["fullres"] = cid.get_img_fullres()
        return out

    # the doors, counted: the drop-in teacher session, the global pattern,
    # both notebooks, the converter
    for k in entries:
        k.launches = 0
    t0 = time.perf_counter()
    drop = CI.ColorizeImageTorch(Xd=S)
    drop.prep_net(gpu_id, path=teacher)
    if drop.device.type != dev.type:
        die(f"phase 18: prep_net({gpu_id}) built the model on {drop.device}")
    dframes, (ab, mask) = teacher_session(drop)
    gcard = global_pattern(gpu_id)
    nbs = {}
    for name in ("DemoInteractiveColorization",
                 "DemoGlobalHistogramTransfer"):
        nbs[name] = {}
        for _ in run_cells(os.path.join(repo, "notebooks", "torch",
                                        f"{name}.ipynb"),
                           {"DEVICE": dev_name}, nbs[name]):
            pass
    t1 = time.perf_counter()
    teacher_pth = os.path.join(work, "teacher.pth")
    if convert.main([teacher, teacher_pth]) != 0:
        die("phase 18: apps.convert failed on the teacher")
    convert_s = time.perf_counter() - t1
    converted = {}
    for v in caffe_net.VARIANTS:
        converted[v] = os.path.join(work, f"{v}.npz")
        if convert.main([caffemodel[v], converted[v], "--variant", v]) != 0:
            die(f"phase 18: apps.convert failed on the {v} .caffemodel")
    if on_card:
        torch.cuda.synchronize()
    doors_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in entries}
    print(f"phase 18: the doors ran {doors_s:.2f} s: the drop-in teacher "
          f"session ({DOORS_CLICKS} net_forward + {DOORS_CLICKS} "
          f"net_forward_table clicks, the getters), the global pattern, "
          f"both notebooks, the converter; launches {launches}")
    if on_card:
        for k in (k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB, k3.KERNEL):
            if launches[k.name] == 0:
                die(f"phase 18: kernel {k.name} was not launched on the "
                    f"reference's doors")

    # (b) the same clicks through ideepcolor_tpu_torch.api: byte for byte
    direct = api.ColorizeImageTorch(Xd=S, device=dev)
    direct.prep_net(path=teacher)
    aframes, _ = teacher_session(direct)
    for key, want in aframes.items():
        if not np.array_equal(dframes[key], want):
            die(f"phase 18: the drop-in's {key} differs from the API's")
    for i in range(DOORS_CLICKS):
        frame_check(f"phase 18 dense vs table click {i}", dframes[f"dense{i}"],
                    dframes[f"table{i}"], FRAME_BOUND_LSB, FRAME_BOUND_SHARE)
    # (c) the converter's .pth: the same frames as the .npz
    via_pth = api.ColorizeImageTorch(Xd=S, device=dev)
    via_pth.prep_net(path=teacher_pth)
    pframes, _ = teacher_session(via_pth)
    for key, want in aframes.items():
        if not np.array_equal(pframes[key], want):
            die(f"phase 18: the converted .pth's {key} differs from the "
                f".npz's")
    # (d) each .caffemodel against its converted .npz
    table = hints.points_json_to_table(clicks, S)
    glob_in = gcard["glob"]
    for v, cls in (("main", api.ColorizeImageTorchCaffe),
                   ("dist", api.ColorizeImageTorchCaffeDist),
                   ("global", api.ColorizeImageTorchCaffeGlobDist)):
        got = {}
        for form, path in (("caffemodel", caffemodel[v]),
                           ("npz", converted[v])):
            m = cls(Xd=S, device=dev)
            m.prep_net(0, caffemodel_path=path)
            m.load_image(img_path)
            if v == "global":
                out = [m.net_forward(ab, mask, glob_in).copy()]
            else:
                out = [m.net_forward(ab, mask).copy()]
                if v == "main":
                    out.append(m.net_forward_table(*table).copy())
                else:
                    out.append(m._dev_dist.cpu().numpy())
            got[form] = out
        for a, b in zip(got["caffemodel"], got["npz"]):
            if not np.array_equal(a, b):
                die(f"phase 18: the {v} .caffemodel and its converted .npz "
                    f"give different outputs")
    # (e) the global pattern's CPU twin (gpu_id=-1 moves the drop-in root,
    # caffe.Net with it, to the CPU)
    t1 = time.perf_counter()
    gcpu = global_pattern(-1)
    twin_s = time.perf_counter() - t1
    glob_err = float(np.abs(gcard["glob"] - gcpu["glob"]).max())
    if abs(float(gcard["glob"].sum()) - 1) >= 1e-4 or glob_err > 1e-6:
        die(f"phase 18: glob_dist_in sums to {gcard['glob'].sum():.6f} and "
            f"lies {glob_err:.1e} from the CPU twin's (bounds 1e-4, 1e-6)")
    worst = (0, 0.0, 0.0)
    for key in ("auto", "pred"):
        d = np.abs(gcard[key].astype(int) - gcpu[key].astype(int)).max(-1)
        same = d == 0
        ab_err = float(np.abs(gcard[f"ab_{key}"] - gcpu[f"ab_{key}"])
                       .max(0)[same].max())
        worst = (max(worst[0], int(d.max())),
                 max(worst[1], float(np.mean(d != 0))), max(worst[2], ab_err))
    if worst[0] > CAFFE_FRAME_BOUND_LSB or \
            worst[1] >= CAFFE_FRAME_BOUND_SHARE or worst[2] > CAFFE_AB_BOUND:
        die(f"phase 18: the global pattern is {worst[0]} LSB on "
            f"{worst[1]:.2e} of the pixels and ab {worst[2]:.2e} from its "
            f"CPU twin (CAFFE_* bounds)")
    if np.array_equal(gcard["auto"], gcard["pred"]):
        die("phase 18: the reference histogram changed no pixel")
    # (f) the notebooks' results
    nb_i = nbs["DemoInteractiveColorization"]
    nb_g = nbs["DemoGlobalHistogramTransfer"]
    full = FULLRES_HW + (3,)
    if (nb_i["img_out"].shape != (S, S, 3)
            or nb_i["img_out_fullres"].shape != full
            or nb_i["mask_fullres"].shape != full
            or not nb_i["mask"].any()
            or nb_i["colorModel"].device.type != dev.type
            or nb_g["img_pred_withref_fullres"].shape != (480, 640, 3)
            or abs(float(nb_g["glob_dist_ref"].sum()) - 1) >= 1e-4
            or nb_g["cid"].device.type != dev.type):
        die("phase 18: a notebook's results have the wrong shape or device")
    # timed, for information: the drop-in click and the API's, in turns
    t_drop, t_api = [], []
    for _ in range(DOORS_TIMED):
        for model, ts in ((drop, t_drop), (direct, t_api)):
            t1 = time.perf_counter()
            model.net_forward(ab, mask)
            ts.append(time.perf_counter() - t1)
    print(f"phase 18 (deterministic cuDNN, host clock, frame read back): "
          f"drop-in net_forward p50 {np.percentile(t_drop, 50) * 1e3:.3f} "
          f"ms, p95 {np.percentile(t_drop, 95) * 1e3:.3f} ms; the API's "
          f"p50 {np.percentile(t_api, 50) * 1e3:.3f} ms, p95 "
          f"{np.percentile(t_api, 95) * 1e3:.3f} ms over {DOORS_TIMED} "
          f"each, in turns; apps.convert teacher.npz -> .pth "
          f"{convert_s:.2f} s")
    print(f"phase 18: (a) data.colorize_image and caffe from "
          f"{COMPAT_DIR}; (b) the drop-in session's {len(aframes)} frames "
          f"byte-identical to the API's, dense and table clicks within "
          f"{FRAME_BOUND_LSB} LSB on < {FRAME_BOUND_SHARE}; (c) the "
          f"converted .pth's frames byte-identical to the .npz's; (d) main, "
          f"dist and global .caffemodel byte-identical to their converted "
          f".npz; (e) the global pattern within {worst[0]} LSB on "
          f"{worst[1]:.2e} of the pixels, ab {worst[2]:.2e}, glob_dist_in "
          f"within {glob_err:.1e} of its CPU twin ({twin_s:.1f} s), summing "
          f"to {gcard['glob'].sum():.6f}; (f) both notebooks ran cell by "
          f"cell on {dev_name}"
          + (f", {len(plot_calls)} plotting calls recorded by the stand-in"
             if plot_calls is not None else ""))
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ideepcolor_tpu"))
    if jax_mods:
        die(f"phase 18: the child loaded {jax_mods[:5]}")
    with open(os.path.join(work, "doors.json"), "w") as f:
        json.dump({"launches": launches}, f)
    return 0


def launches_per_call(fn, n: int = 5) -> dict:
    """What the host puts on the stream per call of ``fn``, by the CUDA
    runtime's own names (kernel and graph launches, copies, sets), from
    ``torch.profiler`` over ``n`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith(
                ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cudaMemcpy", "cudaMemset")):
            out[e.key] = out.get(e.key, 0) + e.count / n
    return out


def programs_phase(entries, dev, m, d) -> dict:
    """Phase 19: the standalone device programs (the image load, the
    full-res getters, get_ab_reccs, compute_entropy, the gamut snap and
    mask), on the main path's session ``m`` and the dist session ``d``;
    the bucket reuse; the suggest program captured ahead of its first call
    while another thread clicks; the GUI click with either snap. Returns
    the phase's launches per kernel entry (the twelfth count)."""
    import threading
    import torch
    from ideepcolor_tpu_torch.api import ColorizeImageTorch
    from ideepcolor_tpu_torch.data import lab_gamut
    from ideepcolor_tpu_torch.engine import graphs
    from ideepcolor_tpu_torch.engine import pipeline as P
    from ideepcolor_tpu_torch.ops import gamut, hints
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1

    clicks = session_hints(10)
    tables = [hints.points_json_to_table(clicks[:i], S)
              for i in range(len(clicks) + 1)]
    h, w = clicks[-1]["y"], clicks[-1]["x"]
    im = image(5, *FULLRES_HW)
    snap_colors = np.random.default_rng(19).integers(0, 256, (8, 3))
    ab = np.zeros((2, S, S), np.float32)
    mask = np.zeros((1, S, S), np.float32)
    for p in session_hints(6, seed=8):
        hints.put_point(ab, mask, [min(max(p["y"], 4), S - 5),
                                   min(max(p["x"], 4), S - 5)], 4, p["ab"])

    def getters(mod):
        return {"fullres": mod.get_img_fullres(),
                "input": mod.get_input_img_fullres(),
                "gray": mod.get_img_gray_fullres(),
                "mask": mod.get_img_mask_fullres(),
                "sup": mod.get_sup_fullres()}

    # a. the path, counted: the main session's load and getters, the dist
    # session's suggestions and entropy, a snap and a gamut redraw, then
    # the bucket check on a fresh model
    for k in entries:
        k.launches = 0
    t_phase = time.perf_counter()
    m.load_image_array(im)
    dense_full = m.net_forward_fullres(ab, mask)
    dense_two_step = m.get_img_fullres()
    m.net_forward_table(*tables[-1])
    out = getters(m)
    out["async"] = m.get_img_fullres_async()()
    d.set_image(m.img_rgb)
    if d.predict_dist_table(*tables[-1]) != 0:
        die("phase 19: predict_dist_table failed")
    # the first call captures (its warm-up runs draw numbers); re-seeded
    # replays after it draw the same ones
    d.get_ab_reccs(h, w, K=SUGGEST_K)
    d._generator.manual_seed(19)
    reccs = d.get_ab_reccs(h, w, K=SUGGEST_K, return_conf=True)
    d._generator.manual_seed(19)
    reccs_again = d.get_ab_reccs(h, w, K=SUGGEST_K, return_conf=True)
    reccs_next = d.get_ab_reccs(h, w, K=SUGGEST_K, return_conf=True)
    d.compute_entropy()
    entropy = d.dist_entropy
    snap = lab_gamut.snap_ab(50.0, snap_colors[0], device=dev)
    snap_batch = lab_gamut.snap_ab(50.0, snap_colors, device=dev)
    grid = lab_gamut.abGrid(device=dev)
    grid_rgb, grid_mask = (a.copy() for a in grid.update_gamut(37.5))
    fresh = ColorizeImageTorch(Xd=S)
    fresh.prep_net(path=WEIGHTS)
    progs = {"load": fresh._load_prog, **fresh._getters}
    bucket_caps = []
    for i, (H, W) in enumerate(BUCKET_SIZES):
        fresh.load_image_array(image(50 + i, H, W))
        fresh.net_forward_table(*tables[i + 3])
        for key, f in getters(fresh).items():
            if f.shape != (H, W, 3) or f.dtype != np.uint8:
                die(f"phase 19: {key} getter at {H}x{W} gave {f.shape}")
        bucket_caps.append({k: p.captures for k, p in progs.items()})
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in entries}
    print(f"phase 19, the standalone programs: "
          f"{time.perf_counter() - t_phase:.2f} s, launches {launches}")
    for k in (k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB):
        if launches[k.name] == 0:
            die(f"phase 19: kernel {k.name} was not launched")
    if any(c != 1 for c in bucket_caps[2].values()) or \
            any(c != 2 for c in bucket_caps[3].values()):
        die(f"phase 19: captures per program after each load: {bucket_caps}")
    sizes = ", ".join(f"{H}x{W}" for H, W in BUCKET_SIZES)
    buckets = ", ".join(f"{P.bucket_size(H)}x{P.bucket_size(W)}"
                        for H, W in BUCKET_SIZES)
    print(f"bucket reuse: loads of {sizes} (buckets {buckets}), each with a "
          f"table click and the five getters: captures per program after "
          f"each load {[c['load'] for c in bucket_caps]} (load), "
          f"{[c['fullres'] for c in bucket_caps]} (fullres; gray, mask and "
          f"sup alike: {bucket_caps[3]})")

    # b. captured against eager (after the counts): the eager form is the
    # same function run eagerly on the same inputs
    def eager(prog):
        return lambda *a, **kw: prog.fn(
            *(x.t if isinstance(x, graphs.Fixed) else x for x in a), **kw)

    checks = []
    Hb, Wb = m._dev_l_fullres_pad.shape[:2]
    pad = np.zeros((Hb, Wb, 3), np.uint8)
    pad[:FULLRES_HW[0], :FULLRES_HW[1]] = im
    pad_dev = torch.from_numpy(pad).to(dev)
    lab_e, _ = m._load_prog.fn(pad_dev)
    lab_c, l_c = m._load_prog(pad_dev)
    load_err = float((lab_c - lab_e).abs().max())
    if load_err > 1e-4 or not torch.equal(l_c[..., 0], lab_c[..., 0]):
        die(f"phase 19: the captured load is {load_err} off the eager one")
    if not torch.equal(m._dev_lab_fullres_pad, lab_c):
        die("phase 19: the session's Lab is not the load program's")
    checks.append(f"load: Lab within {load_err:.1e}")
    m_ab = m._dev_output_ab
    in_ab = m._to_dev(m.input_ab.transpose(1, 2, 0))
    m_mask = m._to_dev(m.input_mask.transpose(1, 2, 0))
    planes = m._to_dev(np.concatenate([m.input_mask, m.input_ab],
                                      0).transpose(1, 2, 0))
    args = {"fullres": (m._dev_l_fullres_pad, m_ab, m._dev_rh, m._dev_rw),
            "input": (m._dev_l_fullres_pad, in_ab, m._dev_rh, m._dev_rw),
            "gray": (m._dev_l_fullres_pad,),
            "mask": (m_mask, m._dev_rh0, m._dev_rw0),
            "sup": (planes, m._dev_rh0, m._dev_rw0)}
    H0, W0 = FULLRES_HW
    for key, a in args.items():
        prog = m._getters["fullres" if key == "input" else key]
        want = prog.fn(*a).cpu().numpy()
        got = prog(*a).cpu().numpy()
        moved = frame_check(f"phase 19: captured {key} getter vs eager", got,
                            want, FRAME_BOUND_LSB, FRAME_BOUND_SHARE)
        frame_check(f"phase 19: the API's {key} getter vs its program",
                    out[key], got[:H0, :W0], 0, 1e-12)
        checks.append(f"{key}: {moved:.1e} of the pixels moved")
    if not (np.array_equal(out["async"], out["fullres"])):
        die("phase 19: get_img_fullres_async differs from get_img_fullres")
    frame_check("phase 19: net_forward_fullres against get_img_fullres",
                dense_full, dense_two_step, 0, 1e-12)
    centers, conf = reccs
    if not (np.array_equal(centers, reccs_again[0])
            and np.array_equal(conf, reccs_again[1])):
        die("phase 19: a re-seeded captured get_ab_reccs drew other samples")
    if np.array_equal(centers, reccs_next[0]):
        die("phase 19: two replays of get_ab_reccs drew the same samples")
    d._generator.manual_seed(19)
    e_out = eager(d._suggest_prog)(
        d._dev_dist, *d._dev_table(np.zeros((0, 4), np.int32),
                                   np.zeros((0, 2), np.float32), 0, h, w)[3:],
        d._dev_pts(), d._generator, K=SUGGEST_K, N=25000,
        map_div=d.dist_map_div).cpu().numpy()
    for name, c, cf in (("captured", centers, conf),
                        ("eager", e_out[:, :2], e_out[:, 2])):
        if (c.shape != (SUGGEST_K, 2) or np.abs(c).max() > 110
                or abs(float(cf.sum()) - 1) > 1e-5 or (np.diff(cf) > 0).any()):
            die(f"phase 19: {name} get_ab_reccs breaks its contract: {c}, "
                f"{cf}")
    ent_e = P.dist_entropy(d._dev_dist).cpu().numpy()
    if not np.array_equal(entropy[::4, ::4], ent_e):
        die("phase 19: the captured entropy is not the eager one")
    snap_e = gamut.snap_ab(50.0, torch.from_numpy(
        snap_colors.astype(np.float32)).to(dev)).cpu().numpy()
    snap_cpu = gamut.snap_ab(50.0, torch.from_numpy(
        snap_colors.astype(np.float32))).numpy()
    if not np.array_equal(snap_batch, snap_e.astype(np.uint8)) or \
            np.abs(snap_e - snap_cpu).max() > 1:
        die(f"phase 19: the captured snap {snap_batch.tolist()} is not the "
            f"eager one {snap_e.tolist()} (CPU {snap_cpu.tolist()})")
    if np.abs(snap.astype(int) - lab_gamut.snap_ab(
            50.0, snap_colors[0], device="cpu").astype(int)).max() > 1:
        die("phase 19: one color's captured snap is more than 1 LSB from "
            "the CPU's")
    rgb_e, mask_e = gamut.ab_gamut_mask(37.5, device=dev)
    if not (np.array_equal(grid_rgb, rgb_e.cpu().numpy())
            and np.array_equal(grid_mask, mask_e.cpu().numpy())):
        die("phase 19: the captured gamut mask is not the eager one")
    print(f"captured vs eager (same inputs): {'; '.join(checks)}; "
          f"get_ab_reccs: a re-seeded replay byte for byte, the next one "
          f"draws anew, both forms keep the contract (top confidence "
          f"{conf[0]:.3f} captured, {e_out[0, 2]:.3f} eager); entropy and "
          f"snap (1 and 8 colors) byte for byte, the snap within "
          f"{int(np.abs(snap_e - snap_cpu).max())} LSB of the CPU's; gamut "
          f"mask and colors byte for byte")

    # c. each program's call, captured against eager: host launches per
    # call and host-clock p50 / p95, in turns
    # the captured programs, and a switch of every one to its eager form
    real = {(obj, name): getattr(obj, name) for obj, name in (
        (m, "_load_prog"), (m, "_getters"), (d, "_suggest_prog"),
        (d, "_entropy_prog"))}
    real_gamut = dict(lab_gamut._PROGRAMS)

    def swap(to_eager: bool):
        for (obj, name), prog in real.items():
            if isinstance(prog, dict):
                prog = {k: eager(p) if to_eager else p
                        for k, p in prog.items()}
            elif to_eager:
                prog = eager(prog)
            setattr(obj, name, prog)
        for key, prog in real_gamut.items():
            lab_gamut._PROGRAMS[key] = eager(prog) if to_eager else prog

    def timed(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    pick = snap_colors[1]
    grid_l = iter(np.linspace(1.0, 99.0, 10 * PROGRAM_TIMED))

    def redraw():                   # a new L every time: the cache misses
        return lab_gamut.abGrid(device=dev).update_gamut(float(next(grid_l)))

    calls = {
        "image load (1000x750)": lambda: m.load_image_array(im),
        "get_img_fullres": m.get_img_fullres,
        "get_img_fullres_async": lambda: m.get_img_fullres_async()(),
        "get_input_img_fullres": m.get_input_img_fullres,
        "get_img_gray_fullres": m.get_img_gray_fullres,
        "get_img_mask_fullres": m.get_img_mask_fullres,
        "get_sup_fullres": m.get_sup_fullres,
        f"get_ab_reccs (K={SUGGEST_K})": lambda: d.get_ab_reccs(
            h, w, K=SUGGEST_K, return_conf=True),
        "compute_entropy": d.compute_entropy,
        "snap_ab (one pick)": lambda: lab_gamut.snap_ab(50.0, pick,
                                                        device=dev),
        "gamut mask redraw": redraw}
    for name, fn in calls.items():
        t = {True: [], False: []}
        row = []
        for to_eager in (False, True):
            swap(to_eager)
            fn()
            row.append(launches_per_call(fn))
        for _ in range(2):
            for to_eager in (False, True):
                swap(to_eager)
                t[to_eager] += timed(fn, PROGRAM_TIMED // 2)
        swap(False)
        stats = {}
        for to_eager, label in ((False, "captured"), (True, "eager")):
            arr = np.array(t[to_eager])
            stats[label] = (float(np.percentile(arr, 50)),
                            float(np.percentile(arr, 95)))
        lc = ", ".join(
            f"{sum(r.values()):.0f} (" + ", ".join(
                f"{v:.0f} {k}" for k, v in sorted(r.items())) + ")"
            for r in row)
        print(f"program {name}: captured p50 {stats['captured'][0]:.3f} ms, "
              f"p95 {stats['captured'][1]:.3f} ms; eager p50 "
              f"{stats['eager'][0]:.3f} ms, p95 {stats['eager'][1]:.3f} ms "
              f"(host clock, {PROGRAM_TIMED} calls each in turns of "
              f"{PROGRAM_TIMED // 2}); host launches per call, captured then "
              f"eager: {lc}")

    # d. a novel k captured ahead (compile_now) while this thread clicks:
    # first outside the clicks' lock, then inside it (the server before).
    # The clicks' graphs are captured with cuDNN's deterministic kernels, so
    # a click's frame is the same bytes at every replay
    lock = threading.Lock()
    torch.backends.cudnn.deterministic = True
    try:
        cm = ColorizeImageTorch(Xd=S)
        cm.prep_net(path=WEIGHTS)
        cm.load_image_array(im)
        lone = [cm.net_forward_table(*tables[i]).copy()
                for i in range(1, len(tables))]
    finally:
        torch.backends.cudnn.deterministic = False
    d._stage = cm._stage          # one staging buffer, as in the server

    def click(i):
        """One table click under the lock, then a millisecond's pause that
        lets a thread waiting on the lock take it; (start, end, frame
        equal to the lone run's)."""
        t0 = time.perf_counter()
        with lock:
            f = cm.net_forward_table(*tables[1 + i % 10])
        t1 = time.perf_counter()
        time.sleep(1e-3)
        return t0, t1, np.array_equal(f, lone[i % 10])

    base = [click(i) for i in range(4 * AHEAD_CLICKS_AFTER)]
    if not all(ok for *_, ok in base):
        die("phase 19: a click's frame moved between replays")
    base_ms = [(t1 - t0) * 1e3 for t0, t1, _ in base]
    ahead = {}
    for K, under_lock in zip(AHEAD_K, (False, True)):
        span, errors = {}, []

        def capture():
            try:
                span["t0"] = time.perf_counter()
                if under_lock:
                    with lock:
                        d.ensure_suggest_program(K=K, compile_now=True)
                else:
                    d.ensure_suggest_program(K=K, compile_now=True)
            except BaseException as e:      # reported below, then fatal
                errors.append(repr(e))
            finally:
                span["t1"] = time.perf_counter()

        th = threading.Thread(target=capture)
        rec, after = [], 0
        t_start = time.perf_counter()
        th.start()
        while after < AHEAD_CLICKS_AFTER:
            rec.append(click(len(rec)))
            if not th.is_alive():
                after += 1
            if time.perf_counter() - t_start > 120:
                die(f"phase 19: the capture of k={K} ran past 120 s")
        th.join()
        if errors:
            die(f"phase 19: capturing k={K} with compile_now "
                f"{'under' if under_lock else 'outside'} the clicks' lock "
                f"failed: {errors[0]}")
        prog = d.ensure_suggest_program(K, 25000)
        during = [(t1 - t0) * 1e3 for t0, t1, _ in rec
                  if t1 > span["t0"] and t0 < span["t1"]]
        if prog.captures != 1 or not all(ok for *_, ok in rec) or not during:
            die(f"phase 19: k={K}: {prog.captures} captures, "
                f"{sum(not ok for *_, ok in rec)} of {len(rec)} frames off "
                f"the lone run's, {len(during)} clicks during the capture")
        colors, cconf = d.suggest_table(*tables[-1], h, w, K=K)
        if (prog.captures != 1 or colors.shape != (K, 3)
                or abs(float(cconf.sum()) - 1) > 1e-5):
            die(f"phase 19: the program captured ahead for k={K} was "
                f"captured again at its call, or its palette is wrong")
        ahead[under_lock] = (span["t1"] - span["t0"], during)
    base = np.array(base_ms)
    line = [f"lone clicks p50 {np.percentile(base, 50):.3f} ms, p95 "
            f"{np.percentile(base, 95):.3f} ms"]
    for under_lock, label in ((False, "outside the lock"),
                              (True, "under the lock (before)")):
        secs, during = ahead[under_lock]
        arr = np.array(during)
        line.append(f"capture {label} {secs * 1e3:.1f} ms, {len(arr)} clicks "
                    f"during it: p50 {np.percentile(arr, 50):.3f} ms, p95 "
                    f"{np.percentile(arr, 95):.3f} ms, max {arr.max():.3f} ms")
    print(f"compile ahead (k={AHEAD_K[0]} outside, k={AHEAD_K[1]} under the "
          f"clicks' lock; table clicks from this thread, host clock, frames "
          f"read back, each byte-equal to a lone run's; one capture each, "
          f"none at the first call): " + "; ".join(line))

    # the same dist model's suggestions while a novel k is captured ahead:
    # the server's /suggest and session suggest replay graphs that draw from
    # the generator the capture registers, so they wait on the model's
    # generator lock meanwhile. Re-seeded calls after the capture must give
    # the bytes re-seeded calls gave before it
    def suggest_pair(i, seed=None):
        """suggest_table, then get_ab_reccs on the map it left, under the
        clicks' lock; (start, end, colors, conf, centers, cconf)."""
        t0 = time.perf_counter()
        with lock:
            if seed is not None:
                d._generator.manual_seed(seed)
            colors, conf = d.suggest_table(*tables[1 + i % 10], h, w,
                                           K=SUGGEST_K)
            centers, cconf = d.get_ab_reccs(h, w, K=SUGGEST_K,
                                            return_conf=True)
        t1 = time.perf_counter()
        time.sleep(1e-3)
        return t0, t1, colors, conf, centers, cconf

    def pair_contract(colors, conf, centers, cconf) -> bool:
        return (colors.shape == (SUGGEST_K, 3) and colors.dtype == np.uint8
                and abs(float(conf.sum()) - 1) <= 1e-5
                and centers.shape == (SUGGEST_K, 2)
                and np.abs(centers).max() <= 110
                and abs(float(cconf.sum()) - 1) <= 1e-5
                and not (np.diff(cconf) > 0).any())

    # captured on the shared stage with cuDNN's deterministic kernels, so
    # a re-seeded call repeats its forward's bytes too
    torch.backends.cudnn.deterministic = True
    try:
        suggest_pair(9)
    finally:
        torch.backends.cudnn.deterministic = False
    seeded_before = suggest_pair(9, seed=29)[2:]
    K3 = AHEAD_K[2]
    span, errors = {}, []

    def capture_k3():
        try:
            span["t0"] = time.perf_counter()
            d.ensure_suggest_program(K=K3, compile_now=True)
        except BaseException as e:          # reported below, then fatal
            errors.append(repr(e))
        finally:
            span["t1"] = time.perf_counter()

    th = threading.Thread(target=capture_k3)
    rec, after = [], 0
    t_start = time.perf_counter()
    th.start()
    try:
        while after < AHEAD_CLICKS_AFTER:
            rec.append(suggest_pair(len(rec)))
            if not th.is_alive():
                after += 1
            if time.perf_counter() - t_start > 120:
                die(f"phase 19: the capture of k={K3} ran past 120 s")
    finally:
        th.join()
    if errors:
        die(f"phase 19: capturing k={K3} with compile_now while the same "
            f"dist model suggests failed: {errors[0]}")
    prog = d.ensure_suggest_program(K3, 25000)
    during = [(t1 - t0) * 1e3 for t0, t1, *_ in rec
              if t1 > span["t0"] and t0 < span["t1"]]
    broken = sum(not pair_contract(*r[2:]) for r in rec)
    seeded_after = suggest_pair(9, seed=29)[2:]
    same = all(np.array_equal(a, b)
               for a, b in zip(seeded_before, seeded_after))
    if prog.captures != 1 or broken or not during or not same:
        die(f"phase 19: k={K3} captured while the same dist model suggests: "
            f"{prog.captures} captures, {broken} of {len(rec)} palettes "
            f"break their contract, {len(during)} calls during the capture, "
            f"re-seeded calls after it {'equal' if same else 'differ from'} "
            f"those before it")
    colors, cconf = d.suggest_table(*tables[-1], h, w, K=K3)
    if prog.captures != 1 or colors.shape != (K3, 3):
        die(f"phase 19: the program captured ahead for k={K3} was captured "
            f"again at its call, or its palette is wrong")
    arr = np.array(during)
    print(f"compile ahead beside the same dist model's suggestions (k={K3}, "
          f"captured in {(span['t1'] - span['t0']) * 1e3:.1f} ms; "
          f"suggest_table then get_ab_reccs (K={SUGGEST_K}) from this "
          f"thread, host clock): {len(rec)} pairs, {len(arr)} during the "
          f"capture: p50 {np.percentile(arr, 50):.3f} ms, p95 "
          f"{np.percentile(arr, 95):.3f} ms, max {arr.max():.3f} ms (they "
          f"wait on the model's generator lock); every palette within its "
          f"contract; re-seeded calls after the capture byte-equal to those "
          f"before it")

    # e. the GUI click (press to update_result) with the device snap and with
    # the host snap, in turns, on the click+suggest path
    try:
        import PyQt5.QtWidgets as qw
    except ImportError:
        sys.path.insert(0, "tests")
        import _fake_qt
        _fake_qt.install()
        qw = None
    app = None
    if hasattr(getattr(qw, "QApplication", None), "instance"):
        # PyQt5 itself (phase 14 leaves the repository's stand-in, which
        # has no event loop, installed where PyQt5 does not import)
        os.environ.setdefault("QT_QPA_PLATFORM", "offscreen")
        app = qw.QApplication.instance() or qw.QApplication([])
    from PyQt5.QtCore import QPoint, Qt
    from ideepcolor_tpu_torch.ui import qt_gui
    from ideepcolor_tpu_torch.utils.imageio import encode_png

    class Event:
        def __init__(self, x, y):
            self._pos = QPoint(x, y)

        def pos(self):
            return self._pos

        def button(self):
            return Qt.LeftButton

    os.makedirs(os.path.join("build", "programs"), exist_ok=True)
    img_path = os.path.join("build", "programs", "seeded_1000x750.png")
    with open(img_path, "wb") as f:
        f.write(encode_png(im))
    draw = qt_gui.GUIDraw(cm, dist_model=d, load_size=S, win_size=WIN)
    shown = []
    draw.update_result.connect(lambda r: shown.append(time.perf_counter()))
    draw.init_result(img_path)
    rng = np.random.default_rng(119)
    xs = np.linspace(draw.dw + 24, WIN - draw.dw - 24, 5)
    pts = [(int(x), int(y)) for y in (WIN // 3, 2 * WIN // 3) for x in xs]
    # the GUI snaps on the host; for its device form the GUI module's
    # lab_gamut.snap_ab is pointed at the card in turns
    host_snap = lab_gamut.snap_ab

    def device_snap(input_l, input_rgb, return_type="rgb", device=None):
        return host_snap(input_l, input_rgb, return_type, device=dev)

    snap_ms = {"cpu": [], "device": []}
    gui_ms = {"cpu": [], "device": []}
    for i in range(2 * SNAP_GUI_CLICKS + 2):
        where = "device" if i % 2 else "cpu"
        qt_gui.lab_gamut.snap_ab = device_snap if i % 2 else host_snap
        draw.user_color = tuple(int(v) for v in rng.integers(0, 256, 3))
        x, y = pts[i % len(pts)]
        t0 = time.perf_counter()
        draw.calibrate_color(draw.user_color, QPoint(x, y))
        t1 = time.perf_counter()
        n = len(shown)
        draw.mousePressEvent(Event(x, y))
        if app is not None:
            app.processEvents()
        if len(shown) != n + 1:
            die("phase 19: a GUI press showed no frame")
        if i >= 2:                       # the first of each captures
            snap_ms[where].append((t1 - t0) * 1e3)
            gui_ms[where].append((shown[-1] - t1) * 1e3)
    qt_gui.lab_gamut.snap_ab = host_snap
    gui_line = []
    for where in ("device", "cpu"):
        sn, gu = np.array(snap_ms[where]), np.array(gui_ms[where])
        gui_line.append(f"{where} snap: one snap p50 "
                        f"{np.percentile(sn, 50):.3f} ms, p95 "
                        f"{np.percentile(sn, 95):.3f} ms; GUI click p50 "
                        f"{np.percentile(gu, 50):.3f} ms, p95 "
                        f"{np.percentile(gu, 95):.3f} ms")
    print(f"GUI click, press to update_result, {SNAP_GUI_CLICKS} clicks per "
          f"snap in turns (host clock; a click snaps twice): "
          + "; ".join(gui_line))
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the card",
              file=sys.stderr)
        return 1
    from ideepcolor_tpu_torch.api import (ColorizeImageTorch,
                                          ColorizeImageTorchDist)
    from ideepcolor_tpu_torch.data import lab_gamut
    from ideepcolor_tpu_torch.engine import batch as B
    from ideepcolor_tpu_torch.engine import graphs
    from ideepcolor_tpu_torch.engine import pipeline as P
    from ideepcolor_tpu_torch.engine import streaming as ST
    from ideepcolor_tpu_torch.engine.interactive import InteractiveSession
    from ideepcolor_tpu_torch.ops import colorspace as cs
    from ideepcolor_tpu_torch.ops import hints
    from ideepcolor_tpu_torch.ops import kmeans as km
    from ideepcolor_tpu_torch.ops import resize
    from ideepcolor_tpu_torch.ops.cuda import build
    from ideepcolor_tpu_torch.ops.cuda import colorspace_kernel as k2
    from ideepcolor_tpu_torch.ops.cuda import global_stats_kernel as k3
    from ideepcolor_tpu_torch.ops.cuda import hints_kernel as k1
    dev = torch.device("cuda")
    entries = (k1.KERNEL, k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
               k2.KERNEL_BATCH, k3.KERNEL)
    # the entries each path must put on the card: the API's clicks are
    # captured graphs, whose rasterizer is K1's device-count entry
    click_entries = (k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}")
    print(smi)

    # 2. build
    secs = build.build_all(entries)
    print(f"build: {secs:.1f} s for {k1.KERNEL.source}, "
          f"{k2.KERNEL.source} and {k3.KERNEL.source}")
    for k in (k1.KERNEL, k2.KERNEL, k3.KERNEL):
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.source}: {line.strip()}")
    from ideepcolor_tpu_torch.api.colorize import compose_window_host
    from ideepcolor_tpu_torch.ops import host
    t0 = time.perf_counter()
    if not host.available():
        die("the native host runtime did not build: no g++ on this machine")
    host_build_s = time.perf_counter() - t0
    lut_rgb = image(3, S, S)
    lut_l = np.full((WIN, WIN, 1), 50.0, np.float32)
    lut_m = resize.cubic_resize_matrix_np(S, WIN)
    t0 = time.perf_counter()
    compose_window_host(lut_rgb, lut_l, lut_m, lut_m)
    first_ms = (time.perf_counter() - t0) * 1e3
    print(f"build: host runtime {host.library_path('g++').name} "
          f"(g++ {' '.join(host.CXX_FLAGS)}): {host_build_s:.2f} s with the "
          f"load; {host.get_lib().num_threads()} OpenMP threads; first "
          f"{WIN}x{WIN} compose_window_host (gamma table, thread team) "
          f"{first_ms:.2f} ms")

    report = {}

    # 3. K1: bit-exact at 0/10/200/256 live hints at S=256 and S=250, then
    # timed at the main path's table and at 200 hints
    def k1_pair(table, size=S):
        b = torch.from_numpy(table[0]).to(dev)
        v = torch.from_numpy(table[1]).to(dev)
        kern = lambda: k1.rasterize_hints_planar(b, v, table[2], size)  # noqa
        def plain():
            ab, mask = hints.rasterize_hints(b, v, table[2], size)
            return torch.cat([ab, mask], -1).permute(2, 0, 1)
        return kern, plain

    k1_err = 0.0
    for size in (S, 250):
        for n in (0, 10, 200, 256):
            kern, plain = k1_pair(k1_table(n, size), size)
            got, want = kern(), plain()
            err = float((got - want).abs().max())
            k1_err = max(k1_err, err)
            if not torch.equal(got, want):
                die(f"K1 differs from its plain version at S={size}, {n} "
                    f"live hints (max |d| {err})")
    print(f"K1 check: S={S} and S=250, 0, 10, 200 and 256 live hints: "
          f"bit-exact with the plain version")
    for label, table in (("200 hints", k1_table(200)),
                         ("main path, 10 hints",
                          hints.points_json_to_table(session_hints(10), S))):
        kern, plain = k1_pair(table)
        n = table[2]
        b_ms, b_by = bound(3 * S * S * 4 + 24 * n + 4)
        cull, scan, full = k1_box_tests(table[0], n)
        ms, p_ms, e_ms = device_ms(kern), device_ms(plain), eager_ms(kern)
        print(f"K1 time ({label}): kernel {ms:.5f} ms, plain {p_ms:.5f} ms,"
              f" eager call {e_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}), "
              f"share of bound {b_ms / ms:.3f}; box tests: cull {cull} + "
              f"scan {scan} (a full scan per pixel: {full})")
    report[k1.KERNEL.name] = dict(
        max_abs_err=k1_err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, shape=[S, S],
        layout=f"{n} live hints of 256 slots, planar (3,{S},{S}) f32 out")

    # the batched entry (counts read on the device): N = 1 and 8 tables
    # against the plain loop, then ONE captured graph replayed with the
    # count changed in place between replays
    live = (0, 10, 200, 256, 3, 77, 255, 1)

    def k1_batch_inputs(N, size=S):
        tabs = [k1_table(n, size, seed=20 + i) for i, n in
                enumerate(live[:N])]
        return (torch.from_numpy(np.stack([t[0] for t in tabs])).to(dev),
                torch.from_numpy(np.stack([t[1] for t in tabs])).to(dev),
                torch.tensor(live[:N], dtype=torch.int32, device=dev))

    kb_err = 0.0
    for size in (S, 250):
        for N in (1, 8):
            b, v, c = k1_batch_inputs(N, size)
            got = k1.rasterize_hints_batch(b, v, c, size)
            want = k1.rasterize_hints_batch_plain(b, v, c, size)
            kb_err = max(kb_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                die(f"K1 batched entry differs from its plain version at "
                    f"S={size}, N={N}")
    b, v, _ = k1_batch_inputs(1)
    b, v = b[0].contiguous(), v[0].contiguous()
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    raster = graphs.GraphProgram(
        lambda b, v, c: k1.rasterize_hints_planar(b, v, c, S))
    for n in (0, 10, 200, 256, 10, 300, -3):
        cnt.fill_(n)
        got = raster(graphs.Fixed(b), graphs.Fixed(v), graphs.Fixed(cnt))
        if not torch.equal(got, k1._planar_plain(b, v, n, S)):
            die(f"K1 in a captured graph: count {n} set between replays "
                f"gives another raster than the plain version")
    if raster.captures != 1 or raster.replays != 7:
        die(f"K1 graph: {raster.captures} captures, {raster.replays} "
            f"replays")
    print(f"K1 batched entry: N=1 and N=8 at S={S} and S=250 bit-exact "
          f"with the plain loop; one captured graph replayed with counts 0, "
          f"10, 200, 256, 10, 300 (clamped) and -3 (clamped) set between "
          f"replays: bit-exact each time ({raster.captures} capture, "
          f"{raster.replays} replays)")
    for N in (1, 8):
        b, v, c = k1_batch_inputs(N)
        if N == 1:                  # the main path's table, as a click has it
            t = hints.points_json_to_table(session_hints(10), S)
            b = torch.from_numpy(t[0]).to(dev)[None]
            v = torch.from_numpy(t[1]).to(dev)[None]
            c = torch.tensor([t[2]], dtype=torch.int32, device=dev)
        n_live = int(c.clamp(0, 256).sum())
        b_ms, b_by = bound(N * (3 * S * S * 4 + 4) + 24 * n_live)
        ms = device_ms(lambda: k1.rasterize_hints_batch(b, v, c, S))
        p_ms = device_ms(
            lambda: k1.rasterize_hints_batch_plain(b, v, c, S), reps=4)
        print(f"K1 batched time (N={N}, {n_live} live hints in all): kernel "
              f"{ms:.5f} ms, plain loop {p_ms:.5f} ms, bound {b_ms:.6f} ms "
              f"({b_by}), share of bound {b_ms / ms:.3f}")
        if N == 1:
            report[k1.KERNEL_BATCH.name] = dict(
                max_abs_err=kb_err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, shape=[1, S, S],
                layout=f"N=1, {n_live} live hints of 256 slots, count in "
                       f"device memory (the captured clicks'); N=8 on the "
                       f"line above")

    # 4. K2: <= 1 LSB on < 1e-3 of the values, three sizes, five layouts
    rng = np.random.default_rng(2)
    worst = (0, 0.0)
    for H, W in K2_SIZES:
        lab = torch.from_numpy(np.concatenate(
            [rng.uniform(0, 100, (H, W, 1)),
             rng.uniform(-110, 110, (H, W, 2))],
            -1).astype(np.float32)).to(dev)
        l = lab[..., 0].contiguous()
        ab = lab[..., 1:].permute(2, 0, 1).contiguous()   # planar: U-Net
        ab_hwc = lab[..., 1:].contiguous()                # as a zoom output
        zero = torch.zeros((), device=dev).expand(H, W)   # stride 0
        off = torch.empty(H * W + 4, device=dev)[1:H * W + 1].view(H, W)
        off.copy_(ab[0])                                  # 4 B off 16 B
        layouts = {
            "contiguous": (l, ab[0], ab[1]),
            "stride-3 L, planar ab": (lab[..., 0], ab[0], ab[1]),
            "stride-2 ab": (l, ab_hwc[..., 0], ab_hwc[..., 1]),
            "stride-0 ab": (l, zero, zero),
            "misaligned a": (l, off, ab[1]),
        }
        kernel_ms = {}
        for layout, planes in layouts.items():
            w, s = lsb(k2.lab_to_rgb_u8_hwc(*planes),
                       k2.lab_to_rgb_u8_plain(*planes))
            if w > K2_BAR[0] or s >= K2_BAR[1]:
                die(f"K2 at {H}x{W}, {layout}: {w} LSB on {s:.2e} of the "
                    f"values")
            worst = max(worst[0], w), max(worst[1], s)
            ms = kernel_ms[layout] = device_ms(
                lambda: k2.lab_to_rgb_u8_hwc(*planes))
            moved = traffic(planes, 3 * H * W)
            nbytes = needed(planes, 3 * H * W)
            b_ms, _ = bound(nbytes, K2_OPS_PER_PIXEL * H * W)
            print(f"K2 {H}x{W} {layout} ({k2.load_modes(*planes)}): {w} LSB "
                  f"on {s:.2e} of the values; kernel {ms:.5f} ms, moves "
                  f"{moved / (H * W):.2f} B/px ({moved / ms / 1e9:.3f} TB/s),"
                  f" bound {b_ms:.6f} ms at {nbytes / (H * W):.2f} B/px, "
                  f"share {b_ms / ms:.3f}")
        # a zoom output's layout at the full-res size; contiguous elsewhere
        layout = "stride-2 ab" if (H, W) == FULLRES_HW else "contiguous"
        planes = layouts[layout]
        p_ms = device_ms(lambda: k2.lab_to_rgb_u8_plain(*planes))
        e_ms = eager_ms(lambda: k2.lab_to_rgb_u8_hwc(*planes))
        print(f"K2 {H}x{W} {layout}: plain {p_ms:.5f} ms, eager call "
              f"{e_ms:.5f} ms")

        # the fused entry, on the click's layout and one scalar-load layout
        ab_worst = 0.0
        for layout in ("contiguous", "stride-3 L, planar ab"):
            planes = layouts[layout]
            rgb, got_ab = k2.lab_to_rgb_u8_ab(*planes)
            if not torch.equal(rgb, k2.lab_to_rgb_u8_hwc(*planes)):
                die(f"K2 fused entry at {H}x{W}, {layout}: its frame is not "
                    f"the compose's")
            d = float((got_ab - cs.requantized_ab(rgb)).abs().max())
            if not d <= AB_BAR:
                die(f"K2 fused entry at {H}x{W}, {layout}: ab off "
                    f"requantized_ab by {d}")
            ab_worst = max(ab_worst, d)
        planes = layouts["contiguous"]
        ms = device_ms(lambda: k2.lab_to_rgb_u8_ab(*planes))
        def plain():
            rgb = k2.lab_to_rgb_u8_plain(*planes)
            return rgb, cs.requantized_ab(rgb)
        p_ms = device_ms(plain)
        e_ms = eager_ms(lambda: k2.lab_to_rgb_u8_ab(*planes))
        b_ms, b_by = bound(23 * H * W, K2_AB_OPS_PER_PIXEL * H * W)
        print(f"K2 fused {H}x{W}: frame byte-identical to the compose's, ab "
              f"within {ab_worst:.2e} of requantized_ab; kernel {ms:.5f} ms,"
              f" plain {p_ms:.5f} ms, eager call {e_ms:.5f} ms, bound "
              f"{b_ms:.6f} ms at 23 B/px ({b_by}), share {b_ms / ms:.3f}")
        if (H, W) == (S, S):                      # the click's frame
            report[k2.KERNEL_AB.name] = dict(
                ab_max_abs_err=ab_worst, ms=ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, shape=[H, W],
                layout="L and planar ab contiguous (the click's)")
    # the dist session's two compose shapes, in its own layouts
    cubic = torch.from_numpy(resize.cubic_resize_matrix_np(S, WIN)).to(dev)
    win_ab = resize.zoom_with_matrices(
        torch.from_numpy(rng.uniform(-110, 110, (S, S, 2)).astype(
            np.float32)).to(dev), cubic, cubic)
    win_l = torch.from_numpy(rng.uniform(0, 100, (WIN, WIN, 1)).astype(
        np.float32)).to(dev)
    planes = (win_l[..., 0], win_ab[..., 0], win_ab[..., 1])
    w, s = lsb(k2.lab_to_rgb_u8_hwc(*planes), k2.lab_to_rgb_u8_plain(*planes))
    if w > K2_BAR[0] or s >= K2_BAR[1]:
        die(f"K2 at the {WIN}x{WIN} window frame: {w} LSB on {s:.2e} of the "
            f"values")
    worst = max(worst[0], w), max(worst[1], s)
    ms = device_ms(lambda: k2.lab_to_rgb_u8_hwc(*planes))
    p_ms = device_ms(lambda: k2.lab_to_rgb_u8_plain(*planes))
    b_ms, _ = bound(15 * WIN * WIN, K2_OPS_PER_PIXEL * WIN * WIN)
    print(f"K2 {WIN}x{WIN} window frame, contiguous L and a zoom output's ab "
          f"({k2.load_modes(*planes)}): {w} LSB on {s:.2e} of the values; "
          f"kernel {ms:.5f} ms, plain {p_ms:.5f} ms, bound {b_ms:.6f} ms, "
          f"share {b_ms / ms:.3f}")
    # the full-res getters' shapes: the buckets of the main path's image and
    # of GETTER_SIZES[1], in the getters' layout (contiguous L, the two
    # channels of a zoom output through zero-padded matrices as ab), under
    # the same bar; timed there and at the exact size, against the bound at
    # the bucket (the work launched) and at the true size
    for H, W in GETTER_SIZES:
        Hb, Wb = P.bucket_size(H), P.bucket_size(W)
        g_rng = np.random.default_rng(H)
        ab_small = torch.from_numpy(g_rng.uniform(-110, 110, (S, S, 2)).astype(
            np.float32)).to(dev)
        timing = {}
        for Hx, Wx in ((Hb, Wb), (H, W)):
            lin = lambda n, rows: torch.from_numpy(  # noqa: E731
                resize.linear_resize_matrix_np(S, n, rows)).to(dev)
            l_pl = torch.from_numpy(g_rng.uniform(0, 100, (Hx, Wx)).astype(
                np.float32)).to(dev)
            abz = resize.zoom_with_matrices(ab_small, lin(H, Hx), lin(W, Wx))
            pl = (l_pl, abz[..., 0], abz[..., 1])
            w, s = lsb(k2.lab_to_rgb_u8_hwc(*pl), k2.lab_to_rgb_u8_plain(*pl))
            if w > K2_BAR[0] or s >= K2_BAR[1]:
                die(f"K2 at {Hx}x{Wx} for a {H}x{W} image, the getters' "
                    f"layout: {w} LSB on {s:.2e} of the values")
            worst = max(worst[0], w), max(worst[1], s)
            timing[Hx, Wx] = dict(
                lsb=(w, s), modes=k2.load_modes(*pl),
                ms=device_ms(lambda: k2.lab_to_rgb_u8_hwc(*pl)),
                plain_ms=device_ms(lambda: k2.lab_to_rgb_u8_plain(*pl)))
        pad, ex = timing[Hb, Wb], timing[H, W]
        b_pad, b_by = bound(15 * Hb * Wb, K2_OPS_PER_PIXEL * Hb * Wb)
        b_true, _ = bound(15 * H * W, K2_OPS_PER_PIXEL * H * W)
        print(f"K2 at the bucket {Hb}x{Wb} of a {H}x{W} image (the getters' "
              f"layout: L contiguous, stride-2 ab of a zoom output, "
              f"{pad['modes']}): {pad['lsb'][0]} LSB on {pad['lsb'][1]:.2e} "
              f"of the values; kernel {pad['ms']:.5f} ms, plain "
              f"{pad['plain_ms']:.5f} ms, {Hb * Wb / (H * W) - 1:.3f} more "
              f"pixels than the image; at the exact size {ex['lsb'][0]} LSB "
              f"on {ex['lsb'][1]:.2e}, kernel {ex['ms']:.5f} ms, plain "
              f"{ex['plain_ms']:.5f} ms; bound {b_pad:.6f} ms at the bucket, "
              f"{b_true:.6f} ms at the true size ({b_by}), share of the true "
              f"size's bound {b_true / pad['ms']:.3f} padded, "
              f"{b_true / ex['ms']:.3f} exact")
        if (H, W) == FULLRES_HW:
            report[k2.KERNEL.name] = dict(
                ms=pad["ms"], plain_ms=pad["plain_ms"], bound_ms=b_pad,
                bound_by=b_by, bound_true_size_ms=b_true, shape=[Hb, Wb],
                layout=f"L contiguous, stride-2 ab of a zoom output (the "
                       f"full-res getter's, at the bucket of the {H}x{W} "
                       f"image)")
    pal_modes, pal_off, pal_values, pal_worst = set(), 0, 0, 0
    for K in (1, SUGGEST_K, 25):
        for _ in range(64):
            l_net = torch.from_numpy(rng.uniform(0, 100, (S, S, 1)).astype(
                np.float32)).to(dev)
            centers = torch.from_numpy(rng.uniform(-110, 110, (K, 2)).astype(
                np.float32)).to(dev)
            lab = P._palette_lab(l_net, int(rng.integers(S)),
                                 int(rng.integers(S)), centers)
            planes = tuple(lab[None, :, c] for c in range(3))
            d = (k2.lab_to_rgb_u8_hwc(*planes).int()
                 - k2.lab_to_rgb_u8_plain(*planes).int()).abs()
            pal_modes.add(k2.load_modes(*planes))
            pal_worst = max(pal_worst, int(d.max()))
            pal_off += int((d != 0).sum())
            pal_values += d.numel()
    if pal_worst > K2_BAR[0] or pal_off / pal_values >= K2_BAR[1]:
        die(f"K2 at the 1 x K palette: {pal_worst} LSB on {pal_off} of "
            f"{pal_values} values")
    worst = max(worst[0], pal_worst), max(worst[1], pal_off / pal_values)
    print(f"K2 1 x K palette, K = 1, {SUGGEST_K} and 25, 64 random palettes "
          f"each, stride-3 planes of a (K,3) Lab tensor ({sorted(pal_modes)}):"
          f" {pal_off} of {pal_values} values off the plain version, max "
          f"{pal_worst} LSB")
    # suggest_batch_table's palettes: one (B, K) image, stride-3 planes of
    # a (B, K, 3) Lab tensor
    lab = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 100, (8, SUGGEST_K, 1)),
         rng.uniform(-110, 110, (8, SUGGEST_K, 2))], -1).astype(
             np.float32)).to(dev)
    planes = tuple(lab[..., c] for c in range(3))
    w, s = lsb(k2.lab_to_rgb_u8_hwc(*planes), k2.lab_to_rgb_u8_plain(*planes))
    if w > K2_BAR[0]:
        die(f"K2 at the 8 x {SUGGEST_K} batch palette: {w} LSB")
    worst = max(worst[0], w), worst[1]
    ms = device_ms(lambda: k2.lab_to_rgb_u8_hwc(*planes))
    p_ms = device_ms(lambda: k2.lab_to_rgb_u8_plain(*planes))
    print(f"K2 8 x {SUGGEST_K} batch palette ({k2.load_modes(*planes)}): {w} "
          f"LSB on {int(s * 8 * SUGGEST_K * 3)} of {8 * SUGGEST_K * 3} "
          f"values; kernel {ms:.5f} ms, plain {p_ms:.5f} ms")
    # the batched entry: the batch engine's (N,1,S,S) L and (N,2,S,S)
    # prediction, channel-last ab, and an odd size whose frames do not start
    # on 4 pixels
    for N, H, W in ((8, S, S), (1, S, S), (3, 33, 17)):
        l = torch.from_numpy(rng.uniform(0, 100, (N, 1, H, W)).astype(
            np.float32)).to(dev)
        ab = torch.from_numpy(rng.uniform(-110, 110, (N, 2, H, W)).astype(
            np.float32)).to(dev)
        hwc = ab.permute(0, 2, 3, 1).contiguous()
        for layout, planes in (
                ("planar prediction", (l[:, 0], ab[:, 0], ab[:, 1])),
                ("channel-last ab", (l[:, 0], hwc[..., 0], hwc[..., 1]))):
            got = k2.lab_to_rgb_u8_batch(*planes)
            w, sh = lsb(got, k2.lab_to_rgb_u8_plain(*planes))
            if w > K2_BAR[0] or sh >= K2_BAR[1]:
                die(f"K2 batched entry at {N}x{H}x{W}, {layout}: {w} LSB on "
                    f"{sh:.2e} of the values")
            for i in range(N):
                if not torch.equal(got[i], k2.lab_to_rgb_u8_hwc(
                        *(t[i] for t in planes))):
                    die(f"K2 batched entry at {N}x{H}x{W}, {layout}: frame "
                        f"{i} is not the single-frame entry's")
            worst = max(worst[0], w), max(worst[1], sh)
            if (N, H) == (8, S) and layout == "planar prediction":
                ms = device_ms(lambda: k2.lab_to_rgb_u8_batch(*planes))
                p_ms = device_ms(lambda: k2.lab_to_rgb_u8_plain(*planes))
                b_ms, b_by = bound(15 * N * H * W,
                                   K2_OPS_PER_PIXEL * N * H * W)
                print(f"K2 batched {N}x{H}x{W} {layout} "
                      f"({k2.load_modes(*planes)}): {w} LSB on {sh:.2e} of "
                      f"the values, each frame the single-frame entry's; "
                      f"kernel {ms:.5f} ms, plain {p_ms:.5f} ms, bound "
                      f"{b_ms:.6f} ms ({b_by}), share {b_ms / ms:.3f}")
                report[k2.KERNEL_BATCH.name] = dict(
                    ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                    shape=[N, H, W],
                    layout="(N,1,S,S) L and (N,2,S,S) prediction planes, "
                           "batch strides S*S and 2*S*S (the batch "
                           "engine's)")
    for k in (k2.KERNEL, k2.KERNEL_AB, k2.KERNEL_BATCH):
        report[k.name]["max_abs_err"] = worst[0]
    print(f"K2 compose: max {worst[0]} LSB on {worst[1]:.2e} of the values "
          f"over {len(K2_SIZES)} sizes and {len(layouts)} layouts, the "
          f"getters' buckets, the {WIN}x{WIN} window frame and the 1 x K "
          f"palettes (bar "
          f"{K2_BAR[0]} LSB on < {K2_BAR[1]})")
    print("library_ms: null for every K1 and K2 entry: no single PyTorch "
          "call computes either function")

    # K3: the global statistics against the plain chain on the card
    k3_err = 0.0
    for H, W in K3_SIZES:
        ref = image(6 if (H, W) == (S, S) else 7, H, W)
        rgb = torch.from_numpy(ref).to(dev).to(torch.float32) / 255.0
        got = k3.global_stats(rgb)
        again = k3.global_stats(rgb)
        want = k3.global_stats_plain(rgb)
        pooled = (H // 4) * (W // 4)
        counts = [(t.double() * pooled).round().long() for t in
                  (got[0], want[0])]
        moved = int((counts[0] - counts[1]).abs().sum()) // 2
        err = max(float((got[1] - want[1]).abs()),
                  float((got[2] - want[2]).abs().max()))
        k3_err = max(k3_err, err)
        if int(counts[0].sum()) != pooled or moved > 1:
            die(f"K3 at {H}x{W}: {int(counts[0].sum())} pooled pixels "
                f"counted of {pooled}, {moved} in another bin than the "
                f"plain chain's")
        if err > K3_MEAN_BOUND:
            die(f"K3 at {H}x{W}: means {err:.2e} from the plain chain's")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            die(f"K3 at {H}x{W}: two calls differ")
        print(f"K3 check {H}x{W}: {moved} of {pooled} pooled pixels in "
              f"another bin than the plain chain's, means within "
              f"{err:.2e} (bound {K3_MEAN_BOUND}), two calls bit-equal")
    rgb = torch.from_numpy(image(6, S, S)).to(dev).to(torch.float32) / 255.0
    ms = device_ms(lambda: k3.global_stats(rgb))
    e_ms = eager_ms(lambda: k3.global_stats(rgb))
    p_ms = eager_ms(lambda: k3.global_stats_plain(rgb), reps=4)
    b_ms, b_by = bound(12 * S * S)
    print(f"K3 time ({S}x{S}, {k3.blocks_for(S, S)} blocks + 1): kernel "
          f"{ms:.5f} ms (two launches), eager call {e_ms:.5f} ms, plain "
          f"chain eager {p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}, 12 B/px "
          f"in), share of bound {b_ms / ms:.3f}; library_ms null: no single "
          f"PyTorch call computes the statistics")
    report[k3.KERNEL.name] = dict(
        max_abs_err=k3_err, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, shape=[S, S, 3],
        layout="(H,W,3) f32 contiguous in; (313,), (), (3,) f32 out; "
               "partials then one finishing block")

    # 5. the main path on the card, launches counted; then the CPU session
    def session(device):
        m = ColorizeImageTorch(Xd=S, device=device)
        m.prep_net(path=WEIGHTS)
        frames, click_s = {}, []
        m.load_image_array(image(5, *FULLRES_HW))
        frames["click0"] = m.net_forward_table(
            *hints.points_json_to_table([], S))
        frames["ab0"] = m.output_ab
        clicks = session_hints(10)
        for i in range(1, len(clicks) + 1):
            t0 = time.perf_counter()
            frames[f"click{i}"] = m.net_forward_table(
                *hints.points_json_to_table(clicks[:i], S))
            click_s.append(time.perf_counter() - t0)
            frames[f"ab{i}"] = m.output_ab
        ab = np.zeros((2, S, S), np.float32)
        mask = np.zeros((1, S, S), np.float32)
        for h in session_hints(6, seed=8):
            hints.put_point(ab, mask, [min(max(h["y"], 4), S - 5),
                                       min(max(h["x"], 4), S - 5)], 4,
                            h["ab"])
        frames["dense"] = m.net_forward(ab, mask)
        frames["ab_dense"] = m.output_ab
        frames["fullres"] = m.get_img_fullres()
        frames["mask_fullres"] = m.get_img_mask_fullres()
        frames["sup_fullres"] = m.get_sup_fullres()
        return m, frames, click_s

    for k in entries:
        k.launches = 0
    t0 = time.perf_counter()
    m, gpu, click_s = session(None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in entries}
    print(f"main path on the card: {wall:.2f} s, launches {launches}")
    for k in click_entries:
        if launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the main path")
    for key, f in gpu.items():
        if not np.isfinite(f).all():
            die(f"main path: {key} is not finite")
    for key in ("click0", "click10", "dense"):
        if gpu[key].shape != (S, S, 3) or gpu[key].dtype != np.uint8:
            die(f"main path: {key} is {gpu[key].shape} {gpu[key].dtype}")
    for key in ("fullres", "mask_fullres", "sup_fullres"):
        if gpu[key].shape != FULLRES_HW + (3,):
            die(f"main path: {key} is {gpu[key].shape}")
    if not m.input_mask.any():
        die("main path: the dense click saw no hint")

    # click latency, for information: more clicks with the last table
    table = hints.points_json_to_table(session_hints(10), S)
    for _ in range(40):
        t0 = time.perf_counter()
        m.net_forward_table(*table)
        click_s.append(time.perf_counter() - t0)
    ms = np.array(click_s[1:]) * 1e3
    print(f"table click on the card (host clock, frame read back): p50 "
          f"{np.percentile(ms, 50):.3f} ms, p95 {np.percentile(ms, 95):.3f}"
          f" ms over {len(ms)} clicks")

    # where a click's device time goes, for information
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_profile(fn, n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        # the program's spans have a device-side range too: not device work
        events = sorted((e for e in averages
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)),
                        key=lambda e: -e.self_device_time_total)
        kernels = sum(e.count for e in events
                      if not e.key.startswith(("Memcpy", "Memset")))
        # what the host put on the stream: kernel launches, graph launches
        # and copies, by the runtime's own names
        host = {}
        for e in averages:
            if e.device_type == DeviceType.CPU and e.key.startswith(
                    ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")):
                host[e.key] = host.get(e.key, 0) + e.count / n
        profile_host.clear()
        profile_host.update(host)
        return events, kernels / n, wall_ms

    profile_host = {}

    def host_launches() -> str:
        """The last profile's host-side launches per call, by kind."""
        total = sum(profile_host.values())
        kinds = ", ".join(f"{v:.0f} {k}" for k, v in
                          sorted(profile_host.items()))
        return f"{total:.0f} host launches per click ({kinds})"

    events, per_click, wall_ms = device_profile(
        lambda: m.net_forward_table(*table), 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    copies = sum(e.count for e in events) / 5 - per_click
    table_launches = host_launches()
    rgb = torch.from_numpy(gpu["click10"]).to(dev)
    _, chain, _ = device_profile(lambda: cs.requantized_ab(rgb), 1)
    print(f"profile of 5 table clicks (captured): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (share {busy_ms / wall_ms:.3f}), "
          f"{len(events)} distinct device activities; {per_click:.0f} device"
          f" kernels and {copies:.0f} copies per click, "
          f"{table_launches} (the plain "
          f"requantized_ab chain that K2's fused entry replaces is "
          f"{chain:.0f} kernels)")
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 5:10.1f} us/click "
              f"{e.count // 5:4d}x  {e.key[:100]}")

    t0 = time.perf_counter()
    _, cpu, _ = session("cpu")
    print(f"the same session on the CPU: {time.perf_counter() - t0:.1f} s")
    worst_frame, worst_share, worst_ab = 0, 0.0, 0.0
    for key, want in cpu.items():
        got = gpu[key]
        if got.dtype == np.uint8:
            d = np.abs(got.astype(int) - want.astype(int)).max(-1)
            worst_frame = max(worst_frame, int(d.max()))
            worst_share = max(worst_share, float(np.mean(d != 0)))
            if d.max() > FRAME_BOUND_LSB or np.mean(d != 0) >= \
                    FRAME_BOUND_SHARE:
                die(f"{key}: card vs CPU {d.max()} LSB on "
                    f"{np.mean(d != 0):.2e} of the pixels")
        else:
            frame = gpu["dense" if key == "ab_dense" else "click" + key[2:]]
            same = (frame == cpu["dense" if key == "ab_dense"
                                 else "click" + key[2:]]).all(-1)
            if same.any():
                worst_ab = max(worst_ab, float(
                    np.abs(got - want).max(0)[same].max()))
    if worst_ab > 1e-3:
        die(f"output_ab: card vs CPU {worst_ab} where the frames agree")
    print(f"card vs CPU session: frames within {worst_frame} LSB on at most "
          f"{worst_share:.2e} of a frame's pixels (bound {FRAME_BOUND_LSB} "
          f"LSB on < {FRAME_BOUND_SHARE}); output_ab within {worst_ab:.2e} "
          f"where the frames agree (bound 1e-3)")

    # 6. the dist session on the card, launches counted apart from phase
    # 5's; then its CPU twin on fewer clicks
    clicks = session_hints(10)
    tables = [hints.points_json_to_table(clicks[:i], S)
              for i in range(len(clicks) + 1)]
    snap_colors = np.random.default_rng(9).integers(
        0, 256, (8, 3)).astype(np.float32)

    def dist_session(device, n_clicks):
        m = ColorizeImageTorch(Xd=S, device=device)
        m.prep_net(path=WEIGHTS)
        d = ColorizeImageTorchDist(Xd=S, device=device)
        d.prep_net(path=WEIGHTS)
        im = image(5, *FULLRES_HW)
        m.load_image_array(im)
        d.set_image(m.img_rgb)             # the GUI hands it the net size
        win_rgb = resize.resize_u8_half_pixel(m._to_dev(im), (WIN, WIN))
        window = (P.rgb_to_lab_dev_u8(win_rgb)[..., :1].contiguous(),
                  m._to_dev(resize.cubic_resize_matrix_np(S, WIN)),
                  m._to_dev(resize.cubic_resize_matrix_np(S, WIN)))
        out, click_s = {}, []
        if d.predict_dist_table(*tables[0]) != 0:
            die("dist session: predict_dist_table failed")
        out["map"] = d._dev_dist.cpu().numpy()
        out["net0"] = m.net_forward_table(*tables[0])
        for i in range(1, n_clicks + 1):
            h, w = clicks[i - 1]["y"], clicks[i - 1]["x"]
            prev = m.output_rgb[h, w].copy()
            t0 = time.perf_counter()
            res = m.net_forward_table_win_suggest(
                *tables[i], *window, d, h, w, K=SUGGEST_K)
            click_s.append(time.perf_counter() - t0)
            if isinstance(res, int):
                die(f"dist session: click+suggest click {i} returned {res}")
            out[f"win{i}"], out[f"colors{i}"] = res
            out[f"net{i}"] = m.output_rgb
            # CUDA's division by a host scalar multiplies by its
            # reciprocal, so row 0 is the pixel / 255 to 1 ulp, not bitwise
            if (np.abs(res[1][0] - prev.astype(np.float32) / 255).max()
                    > 1e-6 or not np.array_equal(np.rint(res[1][0] * 255),
                                                 prev)):
                die(f"dist session: click {i}: palette row 0 {res[1][0]} is "
                    f"not the previous frame's pixel {prev}")
        # the last window frame again, by K2's plain version on the
        # session's own tensors (no launch)
        z = resize.zoom_with_matrices(m._dev_output_ab, window[1], window[2])
        out["win_plain"] = k2.lab_to_rgb_u8_plain(
            window[0][..., 0], z[..., 0], z[..., 1]).cpu().numpy()
        h, w = clicks[n_clicks - 1]["y"], clicks[n_clicks - 1]["x"]
        out["reccs"] = d.get_ab_reccs(h, w, K=SUGGEST_K, return_conf=True)
        out["palette"] = d.suggest_table(*tables[n_clicks], h, w,
                                         K=SUGGEST_K)
        out["map_suggest"] = d._dev_dist.cpu().numpy()
        d.compute_entropy()
        out["entropy"] = d.dist_entropy
        out["snap"] = np.stack([
            lab_gamut.snap_ab(l_in, c, device=device)
            for l_in in (20.0, 50.0, 80.0) for c in snap_colors])
        return m, d, window, out, click_s

    for k in entries:
        k.launches = 0
    t0 = time.perf_counter()
    dm, dd, window, dgpu, dclick_s = dist_session(None, len(clicks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dist_launches = {k.name: k.launches for k in entries}
    print(f"dist session on the card: {wall:.2f} s, launches {dist_launches}")
    for k in click_entries:
        if dist_launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the dist session")

    for key in ("map", "map_suggest"):
        dmap = dgpu[key]
        if dmap.shape != (S // 4, S // 4, 529) or not np.isfinite(dmap).all():
            die(f"dist session: {key} is {dmap.shape}, or not finite")
        if np.abs(dmap.sum(-1) - 1).max() > 1e-4:
            die(f"dist session: {key}'s rows sum to 1 within "
                f"{np.abs(dmap.sum(-1) - 1).max():.2e} only")
    win_lsb, win_share = lsb(torch.from_numpy(dgpu[f"win{len(clicks)}"]),
                             torch.from_numpy(dgpu["win_plain"]))
    if win_lsb > K2_BAR[0] or win_share >= K2_BAR[1]:
        die(f"dist session: the last window frame is {win_lsb} LSB on "
            f"{win_share:.2e} of the values from K2's plain version on the "
            f"same tensors")
    rerun_share = 0.0
    for i in range(1, len(clicks) + 1):
        win, colors = dgpu[f"win{i}"], dgpu[f"colors{i}"]
        if win.shape != (WIN, WIN, 3) or win.dtype != np.uint8:
            die(f"dist session: window frame {i} is {win.shape} {win.dtype}")
        if (colors.shape != (SUGGEST_K + 1, 3) or colors.min() < 0
                or colors.max() > 1 or not np.isfinite(colors).all()):
            die(f"dist session: colors {i} are {colors.shape}, outside "
                f"[0,1] or not finite")
        # launched after the counts were read: comparisons, not the path.
        # cuDNN's default transposed-conv kernels accumulate with atomics,
        # so two forwards of one input differ in the last bits of ab and a
        # few bytes of the frame; the session's frame is held to the frame
        # bound here, and byte for byte in phase 7, whose session is
        # captured with the deterministic kernels chosen
        want = dm.net_forward_table(*tables[i])
        d = np.abs(want.astype(int) - dgpu[f"net{i}"].astype(int)).max(-1)
        rerun_share = max(rerun_share, float(np.mean(d != 0)))
        if d.max() > FRAME_BOUND_LSB or np.mean(d != 0) >= FRAME_BOUND_SHARE:
            die(f"dist session: click {i}'s net frame is {d.max()} LSB on "
                f"{np.mean(d != 0):.2e} of the pixels from "
                f"net_forward_table's for the same table")
    centers, conf = dgpu["reccs"]
    colors_u8, pal_conf = dgpu["palette"]
    if colors_u8.shape != (SUGGEST_K, 3) or colors_u8.dtype != np.uint8:
        die(f"suggest_table: colors are {colors_u8.shape} {colors_u8.dtype}")
    for name, c in (("get_ab_reccs", conf), ("suggest_table", pal_conf)):
        if (c.shape != (SUGGEST_K,) or abs(float(c.sum()) - 1) > 1e-5
                or (np.diff(c) > 0).any()):
            die(f"{name}: confidences {c} do not sum to 1 within 1e-5, or "
                f"are not sorted")
    if centers.shape != (SUGGEST_K, 2) or np.abs(centers).max() > 110:
        die(f"get_ab_reccs: centers {centers.shape} leave [-110, 110]")
    if not np.isfinite(dgpu["entropy"]).all() or \
            dgpu["entropy"].shape != (S, S) or (dgpu["entropy"] > 0).any():
        die("compute_entropy: not finite, not (Xd, Xd) or positive")
    print(f"dist session checks: map ({S // 4},{S // 4},529) finite, rows "
          f"sum to 1 within {np.abs(dgpu['map'].sum(-1) - 1).max():.2e}; "
          f"{len(clicks)} net frames within 1 LSB on at most "
          f"{rerun_share:.2e} of the pixels of net_forward_table's (cuDNN's "
          f"default kernels; byte for byte in phase 7); "
          f"the last window frame {win_lsb} LSB on {win_share:.2e} of the "
          f"values from K2's plain version on the same tensors; "
          f"palette row 0 the previous pixel; confidences sorted, sum "
          f"{float(conf.sum()):.7f}; centers within "
          f"{np.abs(centers).max():.1f}; top confidence {conf[0]:.3f}")

    # timings, for information: the click+suggest click with the last table
    h, w = clicks[-1]["y"], clicks[-1]["x"]
    sug_click = lambda: dm.net_forward_table_win_suggest(  # noqa: E731
        *tables[-1], *window, dd, h, w, K=SUGGEST_K)

    def host_ms(fn, n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return np.array(out)

    # how far two forwards of one table lie apart with cuDNN's default
    # kernels (the deterministic ones must not differ at all)
    dm.net_forward_table(*tables[-1])
    net_in = (dm._dev_l_mc.permute(2, 0, 1)[None],
              dm._to_dev(dm.input_ab)[None], dm._to_dev(dm.input_mask)[None])
    spread = {}
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        try:
            with torch.no_grad():
                outs = [dm._fwd_tbl(*net_in) for _ in range(20)]
            spread[det] = max(float((o - outs[0]).abs().max())
                              for o in outs[1:])
        finally:
            torch.backends.cudnn.deterministic = False
    if spread[True] != 0:
        die(f"the deterministic forward differs run to run: {spread[True]}")
    print(f"20 forwards of one table: max |d ab| {spread[False]:.3e} with "
          f"cuDNN's default kernels, {spread[True]:.1e} with the "
          f"deterministic ones")
    ms = np.concatenate([np.array(dclick_s[1:]) * 1e3, host_ms(sug_click, 40)])
    print(f"click+suggest click on the card (host clock, window frame and "
          f"palette read back): p50 {np.percentile(ms, 50):.3f} ms, p95 "
          f"{np.percentile(ms, 95):.3f} ms over {len(ms)} clicks")
    for name, fn in (
            ("predict_dist_table",
             lambda: dd.predict_dist_table(*tables[-1])),
            ("suggest_table (K=9)",
             lambda: dd.suggest_table(*tables[-1], h, w, K=SUGGEST_K))):
        fn()
        ms = host_ms(fn, 20)
        print(f"{name} on the card (host clock): p50 "
              f"{np.percentile(ms, 50):.3f} ms, p95 "
              f"{np.percentile(ms, 95):.3f} ms over {len(ms)} calls")
    events, per_click, wall_ms = device_profile(sug_click, 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    copies = sum(e.count for e in events) / 5 - per_click
    print(f"profile of 5 click+suggest clicks (captured): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (share "
          f"{busy_ms / wall_ms:.3f}); {per_click:.0f} device kernels and "
          f"{copies:.0f} copies per click, {host_launches()}")
    for e in events[:8]:
        print(f"  {e.self_device_time_total / 5:10.1f} us/click "
              f"{e.count // 5:4d}x  {e.key[:100]}")
    chain = lambda: P.suggest_at(  # noqa: E731
        dd._dev_dist, h // 4, w // 4, dd._dev_pts(), dd._generator,
        K=SUGGEST_K)
    events, chain_kernels, wall_ms = device_profile(chain, 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    def chain_synced():
        chain()
        torch.cuda.synchronize()

    ms = host_ms(chain_synced, 20)
    print(f"the k-means chain alone (suggest_at, K={SUGGEST_K}, N=25000, 4 "
          f"restarts x 30 Lloyd steps): {chain_kernels:.0f} device kernels, "
          f"device busy {busy_ms / 5:.3f} ms per call (wall "
          f"{wall_ms / 5:.3f} ms under the profiler); host clock without "
          f"it, synchronized: p50 {np.percentile(ms, 50):.3f} ms, p95 "
          f"{np.percentile(ms, 95):.3f} ms over {len(ms)} calls")

    # card against the CPU twin
    t0 = time.perf_counter()
    _, cd, _, dcpu, _ = dist_session("cpu", DIST_CPU_CLICKS)
    print(f"the dist session's CPU twin ({DIST_CPU_CLICKS} click+suggest "
          f"clicks): {time.perf_counter() - t0:.1f} s")
    map_err = float(np.abs(dgpu["map"] - dcpu["map"]).max())
    if not map_err <= MAP_BOUND:
        die(f"distribution map: card vs CPU {map_err} (bound {MAP_BOUND})")
    worst_frame, worst_share = 0, 0.0
    for i in range(DIST_CPU_CLICKS + 1):
        for key in (f"win{i}", f"net{i}"):
            if key not in dcpu:
                continue
            d = np.abs(dgpu[key].astype(int) - dcpu[key].astype(int)).max(-1)
            worst_frame = max(worst_frame, int(d.max()))
            worst_share = max(worst_share, float(np.mean(d != 0)))
            if d.max() > FRAME_BOUND_LSB or \
                    np.mean(d != 0) >= FRAME_BOUND_SHARE:
                die(f"dist session {key}: card vs CPU {d.max()} LSB on "
                    f"{np.mean(d != 0):.2e} of the pixels")
    # the CPU twin's last map saw fewer hints: compare entropy of the first
    ent_gpu = P.dist_entropy(torch.from_numpy(dgpu["map"]).to(dev)).cpu()
    ent_err = float((ent_gpu - P.dist_entropy(
        torch.from_numpy(dcpu["map"]))).abs().max())
    if not ent_err <= 1e-3:
        die(f"dist_entropy: card vs CPU {ent_err}")
    snap_d = np.abs(dgpu["snap"].astype(int) - dcpu["snap"].astype(int))
    if snap_d.max() > 1:
        die(f"snap_ab: card vs CPU {snap_d.max()} LSB")
    # the chain's deterministic cores on shared random numbers
    pdf = torch.from_numpy(dcpu["map"][h // 4, w // 4])
    pts = cd._dev_pts()
    gen = torch.Generator().manual_seed(3)
    u = torch.rand(25000, generator=gen)
    counts = km.bins_from_uniform(pdf, u)
    counts_gpu = km.bins_from_uniform(pdf.to(dev), u.to(dev)).cpu()
    moved = int((counts - counts_gpu).abs().sum()) // 2
    if counts_gpu.sum() != 25000 or moved > BINS_MOVED_BOUND:
        die(f"bins_from_uniform: card vs CPU {moved} samples in another bin")
    c0 = km.seeds_from_uniform(pts, counts.float(),
                               torch.rand((4, SUGGEST_K), generator=gen))
    want = km._lloyd(pts, counts.float(), c0, SUGGEST_K, 30)
    got = km._lloyd(pts.to(dev), counts.float().to(dev), c0.to(dev),
                    SUGGEST_K, 30)
    lloyd_err = float((got[0].cpu() - want[0]).abs().max())
    if not lloyd_err <= 1e-3 or not torch.allclose(
            got[2].cpu(), want[2], rtol=1e-4):
        die(f"_lloyd: card vs CPU centers {lloyd_err}, inertia "
            f"{got[2].cpu().tolist()} vs {want[2].tolist()}")
    print(f"card vs CPU dist session: map within {map_err:.2e} (bound "
          f"{MAP_BOUND}); frames within {worst_frame} LSB on at most "
          f"{worst_share:.2e} of a frame's pixels; entropy within "
          f"{ent_err:.2e}; snap_ab: {int((snap_d != 0).sum())} of "
          f"{snap_d.size} values 1 LSB off; bins_from_uniform: {moved} of "
          f"25000 samples in another bin (bound {BINS_MOVED_BOUND}); _lloyd "
          f"centers within {lloyd_err:.2e}")

    # 7. captured against eager. The API's programs are captured graphs
    # (.fn is the plain function each was captured from). First one session
    # whose graphs are captured with cuDNN's deterministic kernels chosen,
    # so that captured and eager must agree byte for byte
    im = image(5, *FULLRES_HW)

    def up(table):
        return (torch.from_numpy(table[0]).to(dev),
                torch.from_numpy(table[1]).to(dev), int(table[2]))

    def seeded(gen, seed, fn):
        gen.manual_seed(seed)
        return fn()

    torch.backends.cudnn.deterministic = True
    try:
        cm = ColorizeImageTorch(Xd=S)
        cm.prep_net(path=WEIGHTS)
        cm.load_image_array(im)
        cd = ColorizeImageTorchDist(Xd=S)
        cd.prep_net(path=WEIGHTS)
        cd.set_image(cm.img_rgb)
        gen = cd._generator
        cap_map_err = 0.0
        for i in (0, 4, 10):
            b, v, c = up(tables[i])
            hy, wx = clicks[max(i, 1) - 1]["y"], clicks[max(i, 1) - 1]["x"]
            frame = cm.net_forward_table(*tables[i]).copy()
            out_ab = cm._dev_output_ab
            rgb, ab, planes = cm._click_tbl.fn(cm._dev_l_net, cm._dev_l_mc,
                                               b, v, c)
            if not (np.array_equal(frame, rgb.cpu().numpy())
                    and torch.equal(out_ab, ab)
                    and np.array_equal(cm.input_mask,
                                       planes[2:].cpu().numpy())):
                die(f"captured table click {i} differs from the eager one")
            win = cm.net_forward_table_win(*tables[i], *window)
            ewin = cm._click_tbl_win.fn(cm._dev_l_net, cm._dev_l_mc, *window,
                                        b, v, c)[2]
            if not (np.array_equal(win, ewin.cpu().numpy())
                    and np.array_equal(cm.output_rgb, frame)):
                die(f"captured window click {i} differs from the eager one")
            if cd.predict_dist_table(*tables[i]) != 0:
                die("captured predict_dist_table failed")
            emap = cd._predict_tbl.fn(cd._dev_l_mc, b, v, c)[0]
            cap_map_err = max(cap_map_err,
                              float((cd._dev_dist - emap).abs().max()))
            sug = lambda: cm.net_forward_table_win_suggest(  # noqa: E731
                *tables[i], *window, cd, hy, wx, K=SUGGEST_K)
            win2, colors = seeded(gen, 11, sug)
            if not (np.array_equal(win2, win)
                    and np.array_equal(cm.output_rgb, frame)):
                die(f"captured click+suggest click {i}: its frames are not "
                    f"the table click's and the window click's")
            # a graph and an eager call draw other numbers from one seed
            # (a captured generator takes its offset another way), so the
            # palettes are held by their contract here and the chain's
            # deterministic cores on shared numbers below
            pal, conf = cd.suggest_table(*tables[i], hy, wx, K=SUGGEST_K)
            cap_map_err = max(cap_map_err,
                              float((cd._dev_dist - emap).abs().max()))
            if (colors.shape != (SUGGEST_K + 1, 3) or colors.min() < 0
                    or colors.max() > 1 or pal.shape != (SUGGEST_K, 3)
                    or pal.dtype != np.uint8 or (np.diff(conf) > 0).any()
                    or abs(float(conf.sum()) - 1) > 1e-5
                    or not np.array_equal(
                        np.rint(colors[0] * 255), frame[hy, wx])):
                die(f"captured suggestions at table {i} break their "
                    f"contract: colors {colors}, palette {pal}, conf {conf}")
        # the generator is registered with the graphs: replays draw fresh
        # numbers, a re-seeded generator the same ones again
        first = seeded(gen, 5, lambda: sug()[1])
        second = sug()[1]
        again = seeded(gen, 5, lambda: sug()[1])
        if np.array_equal(first[1:], second[1:]) or \
                not np.array_equal(first, again):
            die("captured suggest chain: two replays drew the same samples, "
                "or a re-seeded generator did not reproduce them")
        if cap_map_err > MAP_BOUND:
            die(f"captured vs eager: map {cap_map_err}")
        # the chain's deterministic cores, captured, on shared numbers
        ugen = torch.Generator(device=dev).manual_seed(3)
        u_bins = torch.rand(25000, generator=ugen, device=dev)
        u_seed = torch.rand((4, SUGGEST_K), generator=ugen, device=dev)
        pdf = cd._dev_dist[hy // 4, wx // 4].clone()

        def cores(pdf, u_bins, u_seed, pts):
            counts = km.bins_from_uniform(pdf, u_bins).float()
            c0 = km.seeds_from_uniform(pts, counts, u_seed)
            return (counts, c0) + km._lloyd(pts, counts, c0, SUGGEST_K, 30)

        core_args = (pdf, u_bins, u_seed, cd._dev_pts())
        for got, want in zip(graphs.GraphProgram(cores)(*core_args),
                             cores(*core_args)):
            if not torch.equal(got, want):
                die("the suggest chain's cores, captured, differ from the "
                    "eager ones on the same random numbers")
    finally:
        torch.backends.cudnn.deterministic = False
    graphs_made = sum(p.captures for p in (
        cm._click_tbl, cm._click_tbl_win, cm._click_tbl_win_suggest,
        cd._predict_tbl, cd.ensure_suggest_program(SUGGEST_K, 25000)))
    print(f"captured vs eager, deterministic convolutions, tables of 0, 4 "
          f"and 10 hints: table, window and click+suggest frames byte-equal, "
          f"output_ab and hint planes equal; map within {cap_map_err:.2e} "
          f"(bound {MAP_BOUND}); the suggest chain's cores (sampler, "
          f"seeding, 30 Lloyd steps), captured, equal the eager ones on "
          f"shared random numbers; captured palettes keep their contract; "
          f"two replays draw different samples, a re-seed reproduces them; "
          f"{graphs_made} graphs captured for 5 programs")

    # the same clicks timed captured and eager in turns, default kernels,
    # on phase 6's session; the eager click is what the API did before
    # capture: upload the table, run the plain function, read back
    b, v, c = up(tables[-1])
    prev = torch.from_numpy(dm.output_rgb).to(dev)

    def eager_table():
        b, v, c = up(tables[-1])
        rgb, _, planes = dm._click_tbl.fn(dm._dev_l_net, dm._dev_l_mc, b, v, c)
        return planes.cpu(), rgb.cpu()

    def eager_win():
        b, v, c = up(tables[-1])
        out = dm._click_tbl_win.fn(dm._dev_l_net, dm._dev_l_mc, *window, b,
                                   v, c)
        return out[3].cpu(), out[2].cpu()

    def eager_sug():
        b, v, c = up(tables[-1])
        out = dm._click_tbl_win_suggest.fn(
            dm._dev_l_net, dm._dev_l_mc, *window, b, v, c, dd._dev_dist, h,
            w, dd._dev_pts(), prev, dd._generator, K=SUGGEST_K, N=25000,
            map_div=dd.dist_map_div)
        return out[4].cpu(), out[2].cpu(), out[3].cpu()

    def eager_predict():
        b, v, c = up(tables[-1])
        return dd._predict_tbl.fn(dd._dev_l_mc, b, v, c)[1].cpu()

    def eager_suggest_table():
        b, v, c = up(tables[-1])
        out = dd.ensure_suggest_program(SUGGEST_K, 25000).fn(
            dm._dev_l_net, dd._dev_l_mc, b, v, c, h, w, dd._dev_pts(),
            dd._generator)
        return out[3].cpu(), out[1].cpu(), out[2].cpu()

    click_times = {}
    for name, captured, eager in (
            ("table click", lambda: dm.net_forward_table(*tables[-1]),
             eager_table),
            ("window click",
             lambda: dm.net_forward_table_win(*tables[-1], *window),
             eager_win),
            ("click+suggest click", sug_click, eager_sug),
            ("predict_dist_table",
             lambda: dd.predict_dist_table(*tables[-1]), eager_predict),
            ("suggest_table",
             lambda: dd.suggest_table(*tables[-1], h, w, K=SUGGEST_K),
             eager_suggest_table)):
        captured()
        eager()
        t_cap = host_ms(captured, 20)
        t_eag = host_ms(eager, 20)
        t_cap = np.concatenate([t_cap, host_ms(captured, 20)])
        t_eag = np.concatenate([t_eag, host_ms(eager, 20)])
        line = [f"{name} (host clock, results read back, 40 calls each in "
                f"turns of 20)"]
        for label, fn, t in (("captured", captured, t_cap),
                             ("eager", eager, t_eag)):
            events, per_click, wall_ms = device_profile(fn, 5)
            busy_ms = sum(e.self_device_time_total for e in events) / 1e3
            line.append(
                f"{label}: p50 {np.percentile(t, 50):.3f} ms, p95 "
                f"{np.percentile(t, 95):.3f} ms; {per_click:.0f} device "
                f"kernels, {host_launches()}; device busy "
                f"{busy_ms / 5:.3f} ms per call, idle share "
                f"{1 - busy_ms / wall_ms:.3f} under the profiler")
            click_times[name, label] = (float(np.percentile(t, 50)),
                                        float(np.percentile(t, 95)))
        print("; ".join(line))
    if click_times["click+suggest click", "captured"][1] >= 16.7:
        print("note: the captured click+suggest click's p95 is over the "
              "16.7 ms limit in this run")

    # 8. the serving precisions against the f32 session: bf16 weights
    # (prep_net(dtype="bfloat16")) and precision_name="default" (TF32),
    # each captured, on the same image and tables
    def psnr(a, b):
        mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
        return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))

    def precision_models(dtype, precision_name):
        pm = ColorizeImageTorch(Xd=S)
        pm.prep_net(path=WEIGHTS, dtype=dtype)
        pd = ColorizeImageTorchDist(Xd=S)
        pd.prep_net(path=WEIGHTS, dtype=dtype)
        if precision_name != "highest":
            # the API serves at "highest"; the engines' mode through the
            # same factories
            mc = pm.mask_cent
            pm._click_tbl = P.make_table_click_program(
                lambda A, B_, M: pm.net(A, B_, M, mc,
                                        precision_name=precision_name),
                S, pm.device)

            def dist_fwd(l_mc, ab, mask):
                with torch.no_grad():
                    return pd.net(
                        l_mc.permute(2, 0, 1)[None], ab[None], mask[None],
                        mc, dist=True, dist_lowres=True,
                        precision_name=precision_name
                    )[1][0].permute(1, 2, 0).contiguous()

            pd._predict_tbl = P.make_table_dist_program(dist_fwd, S,
                                                        pd.device)
        pm.load_image_array(im)
        pd.set_image(pm.img_rgb)
        return pm, pd

    modes = {"f32": (m, dd)}
    modes["bf16"] = precision_models("bfloat16", "highest")
    modes["default"] = precision_models(None, "default")
    outs = {}
    for mode, (pm, pd) in modes.items():
        for i in (0, 4, 10):
            outs[mode, i] = (pm.net_forward_table(*tables[i]).copy(),
                             pm.output_ab.copy())
        pd.predict_dist_table(*tables[10])
        outs[mode, "map"] = pd._dev_dist.cpu().numpy()
    precision_stats = {}
    for mode, bar in (("bf16", BF16_BOUND), ("default", TF32_BOUND)):
        st = dict(max_lsb=0, equal=1.0, psnr=1e9, dab=0.0)
        for i in (0, 4, 10):
            got, want = outs[mode, i], outs["f32", i]
            max_lsb, equal = B.frame_delta_stats(got[0], want[0])
            st["max_lsb"] = max(st["max_lsb"], max_lsb)
            st["equal"] = min(st["equal"], equal)
            st["psnr"] = min(st["psnr"], psnr(got[0], want[0]))
            st["dab"] = max(st["dab"], float(np.abs(got[1] - want[1]).max()))
        st["map"] = float(np.abs(outs[mode, "map"]
                                 - outs["f32", "map"]).max())
        precision_stats[mode] = st
        print(f"{mode} session vs f32 session (table clicks of 0, 4, 10 "
              f"hints; frame_delta_stats): max {st['max_lsb']} LSB, "
              f"{st['equal']:.4f} of the pixels equal, PSNR "
              f"{st['psnr']:.2f} dB, max |d output_ab| {st['dab']:.3f}, map "
              f"max |dp| {st['map']:.3e} (bounds: {bar})")
        if (st["max_lsb"] > bar["max_lsb"] or st["equal"] < bar["equal"]
                or st["psnr"] < bar["psnr"] or st["dab"] > bar["dab"]
                or st["map"] > bar["map"]):
            die(f"{mode} session is outside its bounds against f32: {st}")
    mode_ms = {mode: [] for mode in modes}
    for _ in range(2):
        for mode, (pm, _pd) in modes.items():
            mode_ms[mode].append(host_ms(
                lambda: pm.net_forward_table(*tables[-1]), 20))
    line = []
    for mode, (pm, _pd) in modes.items():
        t = np.concatenate(mode_ms[mode])
        events, per_click, wall_ms = device_profile(
            lambda: pm.net_forward_table(*tables[-1]), 5)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        conv_us = sum(e.self_device_time_total for e in events
                      if any(tag in e.key for tag in
                             ("conv", "gemm", "dgrad", "xmma", "cutlass",
                              "cudnn", "nhwc", "nchw"))) / 5
        line.append(f"{mode}: p50 {np.percentile(t, 50):.3f} ms, p95 "
                    f"{np.percentile(t, 95):.3f} ms, device busy "
                    f"{busy_ms / 5:.3f} ms per click, of it conv and layout "
                    f"kernels {conv_us / 1e3:.3f} ms, {per_click:.0f} "
                    f"kernels")
    print("captured table click by precision (host clock, frame read back, "
          "40 clicks each in turns of 20): " + "; ".join(line))

    # 9. the async getters, then the engines, with the launch counts read
    # around them: InteractiveSession, StreamingSession and the batch
    # functions (phase 10) are the third path
    ab = np.zeros((2, S, S), np.float32)
    mask = np.zeros((1, S, S), np.float32)
    hints.put_point(ab, mask, [50, 60], 4, [30.0, -20.0])
    torch.backends.cudnn.deterministic = True
    try:
        # cm's graphs hold the deterministic kernels: byte for byte
        frame = cm.net_forward(ab, mask).copy()
        full = cm.get_img_fullres()
        finish = cm.get_img_fullres_async()
        finish2 = cm.net_forward_fullres_async(ab, mask)
        cm.net_forward_table(*tables[3])          # the state moves on
        if not (np.array_equal(finish(), full)
                and np.array_equal(finish2(), full)
                and np.array_equal(cm.net_forward_fullres(ab, mask), full)):
            die("an async full-res getter differs from the synchronous one")
        if full.shape != FULLRES_HW + (3,) or \
                not np.array_equal(cm.output_rgb, frame):
            die("net_forward_fullres left another net frame than "
                "net_forward")
    finally:
        torch.backends.cudnn.deterministic = False
    print("async getters: get_img_fullres_async, net_forward_fullres_async "
          "and net_forward_fullres equal get_img_fullres byte for byte, "
          "also after the model's state moved on")

    for k in entries:
        k.launches = 0
    sess = InteractiveSession(cm, depth=4)
    submit_ms, pending_after = [], []
    t0 = time.perf_counter()
    for i in range(40):
        t1 = time.perf_counter()
        sess.submit(*tables[i % len(tables)])
        submit_ms.append((time.perf_counter() - t1) * 1e3)
        # the device is still at work when submit returns
        pending_after.append(not torch.cuda.current_stream().query())
        if i % 4 == 3:
            seq, shown = sess.latest()
    wall = time.perf_counter() - t0
    counters = (sess.frames_submitted, sess.frames_materialized,
                sess.frames_dropped, sess.pending)
    if counters != (40, 10, 30, 0) or seq != 40:
        die(f"InteractiveSession counters {counters}, seq {seq}")
    last = tables[39 % len(tables)]
    mirrors = (cm.input_ab.copy(), cm.input_mask.copy())
    if sum(pending_after) < 30:
        die(f"InteractiveSession.submit: the device had already finished "
            f"after {40 - sum(pending_after)} of 40 submits; submit waits")
    sess.submit(*last, win_args=window)
    _, shown_win = sess.latest()

    def check_interactive():      # after the path's counts are read
        want = cm.net_forward_table(*last)
        if not (np.array_equal(shown, want)
                and np.array_equal(mirrors[0], cm.input_ab)
                and np.array_equal(mirrors[1], cm.input_mask)):
            die("InteractiveSession: the last frame or the hint mirrors are "
                "not the synchronous click's")
        if not (np.array_equal(shown_win,
                               cm.net_forward_table_win(*last, *window))
                and shown_win.shape == (WIN, WIN, 3)):
            die("InteractiveSession: the window frame is not the "
                "synchronous window click's")

    print(f"InteractiveSession: 40 submits, one latest per 4: submitted, "
          f"materialized, dropped, pending = {counters}; submit p50 "
          f"{np.percentile(submit_ms, 50):.3f} ms, max "
          f"{max(submit_ms):.3f} ms on the host clock, device still at "
          f"work after {sum(pending_after)} of 40 submits; 40 submits + 10 "
          f"frames in {wall * 1e3:.1f} ms")

    rng = np.random.default_rng(12)
    gray = [rng.integers(0, 256, (S, S), dtype=np.uint8) for _ in range(8)]
    table = tables[-1]
    dense = k1._planar_plain(*(torch.from_numpy(a) for a in table[:2]),
                             table[2], S).permute(1, 2, 0).numpy()
    fps, stream_runs = {}, {}
    for form in ("table", "dense"):
        for with_dist in (True, False):
            ss = ST.StreamingSession(m.net, size=S, depth=4,
                                     with_dist=with_dist)
            if form == "table":
                ss.set_hint_table(*table)
            else:
                ss.set_hints(dense[..., :2], dense[..., 2:])
            got = []
            for i in range(8):                    # capture, warm up
                ss.submit(gray[i])
            list(ss.drain())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(120):
                r = ss.submit(gray[i % 8])
                if r is not None:
                    got.append(r)
            got.extend(ss.drain())
            fps[form, with_dist] = 120 / (time.perf_counter() - t0)
            if len(got) != 120 or ss.frames_out != 128:
                die(f"StreamingSession gave {len(got)} of 120 frames")
            stream_runs[form, with_dist] = (ss, got)

    def check_streaming():        # after the path's counts are read
        for (form, with_dist), (ss, got) in stream_runs.items():
            worst, share = 0, 0.0
            for i in range(8):
                g = torch.from_numpy(gray[i]).to(dev)[None, ..., None]
                if form == "table":
                    want = ST._stream_step_u8_table(
                        ss.net, g, *up(table), size=S, with_dist=with_dist)
                else:
                    want = ST._stream_step_u8(
                        ss.net, g, ss._hint_ab, ss._hint_mask,
                        with_dist=with_dist)
                for j in (i, i + 112):
                    d = np.abs(got[j][0].astype(int)
                               - want[0].cpu().numpy().astype(int)).max(-1)
                    worst = max(worst, int(d.max()))
                    share = max(share, float(np.mean(d != 0)))
                    if (want[1] is None) != (got[j][1] is None):
                        die("StreamingSession: with_dist not respected")
                    if with_dist and float((got[j][1] - want[1]).abs().max()
                                           ) > MAP_BOUND:
                        die("StreamingSession: a frame's map differs from "
                            "the direct step's")
            if worst > FRAME_BOUND_LSB or share >= FRAME_BOUND_SHARE:
                die(f"StreamingSession ({form} hints, with_dist="
                    f"{with_dist}): {worst} LSB on {share:.2e} of the pixels"
                    f" from the direct step")
            print(f"StreamingSession, {form} hints, with_dist={with_dist}, "
                  f"uint8 frames, depth 4, default precision: 120 frames in "
                  f"order, {fps[form, with_dist]:.1f} frames/s (host clock, "
                  f"frames read back); against the direct step on 16 of "
                  f"them: {worst} LSB on at most {share:.2e} of the pixels"
                  f"{', maps within ' + str(MAP_BOUND) if with_dist else ''}")

    # 10. the batch engine: N = 8 images with a table each against the
    # per-image f32 clicks, and a window of T = 8 frames against the
    # per-frame streaming step
    imgs = np.stack([image(30 + i, S, S) for i in range(8)])
    bx = np.stack([tables[i][0] for i in range(8)])
    vl = np.stack([tables[i][1] for i in range(8)])
    ct = np.array([tables[i][2] for i in range(8)], np.int32)
    batch_out = B.colorize_batch_table(m.net, imgs, bx, vl, ct)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    B.colorize_batch_table(m.net, imgs, bx, vl, ct)
    batch_ms = (time.perf_counter() - t0) * 1e3
    win_frames = np.stack(gray)[..., None]
    window_out = B.stream_window_u8(m.net, win_frames, *table)
    dense_out = B.colorize_batch(m.net, imgs)
    engine_launches = {k.name: k.launches for k in entries}
    for k in (k1.KERNEL, k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
              k2.KERNEL_BATCH):
        if engine_launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the engines' path")
    check_interactive()
    print("InteractiveSession: last frame, window frame and hint mirrors "
          "equal the synchronous clicks' (graphs captured with "
          "deterministic convolutions)")
    check_streaming()
    clicks_out = []
    for i in range(8):
        m.set_image(imgs[i])
        clicks_out.append(m.net_forward_table(bx[i], vl[i], ct[i]).copy())
    b_lsb, b_equal = B.frame_delta_stats(batch_out, np.stack(clicks_out))
    steps_out = np.stack([ST._stream_step_u8_table(
        m.net, torch.from_numpy(win_frames[t:t + 1]).to(dev), *up(table),
        size=S, with_dist=False)[0].cpu().numpy() for t in range(8)])
    w_lsb, w_equal = B.frame_delta_stats(window_out, steps_out)
    if (batch_out.shape != (8, S, S, 3) or window_out.shape != (8, S, S, 3)
            or dense_out.shape != (8, S, S, 3)
            or not np.array_equal(dense_out[0], batch_out[0])):
        die("batch engine: wrong shapes, or image 0 (no hints) differs "
            "between the table and the dense form")
    if b_lsb > TF32_BOUND["max_lsb"] or b_equal < TF32_BOUND["equal"]:
        die(f"colorize_batch_table N=8 vs the per-image f32 clicks: "
            f"{b_lsb} LSB, {b_equal:.4f} equal")
    # a forward over 8 frames takes other TF32 conv kernels than over 1
    if w_lsb > TF32_BOUND["max_lsb"] or w_equal < TF32_BOUND["equal"]:
        die(f"stream_window_u8 T=8 vs the per-frame step: {w_lsb} LSB, "
            f"{w_equal:.5f} equal")
    print(f"batch engine (default precision): colorize_batch_table N=8 vs "
          f"the per-image f32 table clicks: max {b_lsb} LSB, {b_equal:.4f} "
          f"of the pixels equal (bounds {TF32_BOUND['max_lsb']} LSB, "
          f"{TF32_BOUND['equal']}); one call {batch_ms:.3f} ms on the host "
          f"clock, frames read back; stream_window_u8 T=8 vs the per-frame "
          f"streaming step: max {w_lsb} LSB, {w_equal:.5f} equal; engines' "
          f"path launches {engine_launches}")

    # the convs' layouts: the TF32 batch forward channels-last on the card
    # (models.siggraph.activation_format), the f32 clicks NCHW
    from ideepcolor_tpu_torch.device import conv_precision
    transposes = ("nchwToNhwc", "nhwcToNchw")
    conv_tags = ("fprop", "dgrad", "xmma", "implicit_gemm", "conv")
    g16 = torch.Generator(device=dev).manual_seed(16)
    planes = (torch.rand((16, 1, S, S), generator=g16, device=dev) * 100.0
              - 50.0,
              torch.rand((16, 2, S, S), generator=g16, device=dev) * 20.0,
              (torch.rand((16, 1, S, S), generator=g16, device=dev) > 0.99)
              .float())

    def tf32_batch():
        with torch.no_grad():
            m.net(*planes, 0.0, precision_name="default")

    def nchw_tf32_batch():          # the NCHW forward this path replaced
        with torch.no_grad(), conv_precision("default"):
            m.net._forward(*planes, 0.0, False, False,
                           torch.contiguous_format)

    def conv_split(events, n):
        """(conv kernels, layout transposes, all busy) in ms per call."""
        tr = sum(e.self_device_time_total for e in events
                 if any(t in e.key for t in transposes))
        conv = sum(e.self_device_time_total for e in events
                   if any(t in e.key.lower() for t in conv_tags)
                   and not any(t in e.key for t in transposes))
        busy = sum(e.self_device_time_total for e in events)
        return conv / n / 1e3, tr / n / 1e3, busy / n / 1e3

    layout_line = []
    for label, fn in [("NCHW", nchw_tf32_batch),
                      ("channels-last", tf32_batch)] * 2:
        fn()
        torch.cuda.synchronize()
        events, kernels, _ = device_profile(fn, 5)
        conv_ms, tr_ms, busy_ms = conv_split(events, 5)
        if label == "channels-last" and tr_ms:
            die("the TF32 batch forward launched layout transposes: "
                + ", ".join(e.key[:80] for e in events
                            if any(t in e.key for t in transposes)))
        layout_line.append(f"{label} conv {conv_ms:.3f} + transposes "
                           f"{tr_ms:.3f} ms of {busy_ms:.3f} busy, "
                           f"{kernels:.0f} kernels")
    print("TF32 forward at N=16, 256x256 (device time per batch, 5 batches,"
          " in turns): " + "; ".join(layout_line))
    events, _, _ = device_profile(lambda: m.net_forward_table(bx[7], vl[7],
                                                               ct[7]), 5)
    fprop = [e.key for e in events if "fprop" in e.key]
    if not fprop or not all("nchwkcrs" in k for k in fprop):
        die(f"the f32 table click's fprop kernels are not cuDNN's NCHW "
            f"ones: {[k[:80] for k in fprop]}")
    print(f"f32 table click: {len(fprop)} fprop kernels, all NCHW "
          f"(nchwkcrs), e.g. {fprop[0][:80]}")

    # 11. the Caffe family: the fourth path. Weights from a seed with numpy,
    # written once in the three formats prep_net takes and read back from
    # the files by the card's models and the CPU twin's alike
    from ideepcolor_tpu_torch.api import (ColorizeImageTorchCaffe,
                                          ColorizeImageTorchCaffeDist,
                                          ColorizeImageTorchCaffeGlobDist)
    from ideepcolor_tpu_torch.apps import demos
    from ideepcolor_tpu_torch.models import caffe_net, caffemodel_io
    from ideepcolor_tpu_torch.models import global_stats
    from ideepcolor_tpu_torch.models import layers as wl

    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    sds = {v: caffe_net.init_state_dict(v, seed=CAFFE_SEED, calibrate=True)
           for v in caffe_net.VARIANTS}
    blobs = {}
    for key, value in sds["main"].items():
        name, field = key.split(".")
        slot = blobs.setdefault(name, {})
        slot[field] = value.numpy().reshape(value.shape or (1,))
    caffe_layers = {}
    for name, f in blobs.items():
        if "weight" in f:
            caffe_layers[name] = [f["weight"], f["bias"]]
        elif "mean" in f:       # BatchNorm: (sum, sumsq, count), count 2
            caffe_layers[name] = [f["mean"] * 2, f["var"] * 2,
                                  np.full(1, 2.0, np.float32)]
        else:
            caffe_layers[name] = [f["scale"]]
    wpath = {"main": os.path.join(tmp.name, "main.caffemodel"),
             "global": os.path.join(tmp.name, "global.pth"),
             "dist": os.path.join(tmp.name, "dist.npz")}
    with open(wpath["main"], "wb") as f:
        f.write(caffemodel_io.encode_caffemodel(caffe_layers))
    torch.save(sds["global"], wpath["global"])
    kinds = {c[0]: c[5] for c in caffe_net._convs_for("dist")}
    np.savez(wpath["dist"], **{
        k: ((wl.torch_convT_to_hwio(v.numpy())
             if kinds[k.split(".")[0]] == "deconv"
             else wl.torch_conv_to_hwio(v.numpy())) if v.dim() == 4
            else v.numpy()) for k, v in sds["dist"].items()})
    n_params = {v: sum(t.numel() for k, t in sd.items()
                       if k.endswith((".weight", ".bias"))) / 1e6
                for v, sd in sds.items()}
    print(f"Caffe weights: three variants from seed {CAFFE_SEED} "
          f"(calibrated BatchNorm statistics; conv parameters in millions "
          f"{ {v: round(n, 3) for v, n in n_params.items()} }), written as "
          f".caffemodel "
          f"({os.path.getsize(wpath['main']) / 1e6:.1f} MB), .pth and "
          f"JAX-layout .npz in {time.perf_counter() - t0:.1f} s")

    ref_im = image(6, S, S)
    zero_hints = (np.zeros((2, S, S), np.float32),
                  np.zeros((1, S, S), np.float32))
    dense_ab, dense_mask = (a.copy() for a in zero_hints)
    for hint in session_hints(6, seed=8):
        hints.put_point(dense_ab, dense_mask,
                        [min(max(hint["y"], 4), S - 5),
                         min(max(hint["x"], 4), S - 5)], 4, hint["ab"])

    def caffe_models(device, dtype=None):
        cm_ = ColorizeImageTorchCaffe(Xd=S, device=device)
        cm_.prep_net(0, caffemodel_path=wpath["main"], dtype=dtype)
        cg_ = ColorizeImageTorchCaffeGlobDist(Xd=S, device=device)
        cg_.prep_net(0, caffemodel_path=wpath["global"], dtype=dtype)
        cd_ = ColorizeImageTorchCaffeDist(Xd=S, device=device)
        cd_.prep_net(0, caffemodel_path=wpath["dist"], dtype=dtype)
        im_ = image(5, *FULLRES_HW)
        cm_.load_image_array(im_)
        cg_.load_image_array(im_)
        cd_.set_image(cm_.img_rgb)
        return cm_, cg_, cd_

    mem_marks = []

    def mem_mark(label):
        """On the card's run: the peak allocation since the last mark."""
        mem_marks.append(
            f"{label} {torch.cuda.max_memory_allocated() / 2**30:.3f}")
        torch.cuda.reset_peak_memory_stats()

    def caffe_session(device, n_clicks, whole):
        """The three backends' clicks; ``whole`` adds what only the card's
        run drives (window click, getters, suggestions, demo)."""
        mark = mem_mark if whole else (lambda label: None)
        cm_, cg_, cd_ = caffe_models(device)
        out = {}
        mark("models loaded")
        out["main_dense0"] = cm_.net_forward(*zero_hints)
        out["ab_main_dense0"] = cm_.output_ab
        for i in range(1, n_clicks + 1):
            out[f"main_click{i}"] = cm_.net_forward_table(*tables[i])
            out[f"ab_main_click{i}"] = cm_.output_ab
        mark("main clicks")
        glob = global_stats.extract(
            cg_._to_dev(ref_im).to(torch.float32) / 255.0)["glob_ab_313"]
        out["glob"] = glob.cpu().numpy()
        out["glob_none"] = cg_.net_forward(*zero_hints, -1)
        out["ab_glob_none"] = cg_.output_ab
        out["glob_ref"] = cg_.net_forward(*zero_hints, out["glob"])
        out["ab_glob_ref"] = cg_.output_ab
        mark("global clicks")
        out["dist_dense"] = cd_.net_forward(dense_ab, dense_mask)
        mark("dist click")
        out["ab_dist_dense"] = cd_.output_ab
        out["map_dense"] = cd_._dev_dist.cpu().numpy()
        if cd_.predict_dist_table(*tables[n_clicks]) != 0:
            die("Caffe path: predict_dist_table failed")
        out["map_table"] = cd_._dev_dist.cpu().numpy()
        mark("predict_dist_table")
        if not whole:
            return (cm_, cg_, cd_), out
        res = cm_.net_forward_table_win(*tables[n_clicks], *window)
        if isinstance(res, int):
            die(f"Caffe path: the window click returned {res}")
        out["main_win"] = res
        out["main_win_net"] = cm_.output_rgb
        out["main_fullres"] = cm_.get_img_fullres()
        out["main_mask_fullres"] = cm_.get_img_mask_fullres()
        out["main_mask"] = cm_.get_img_mask()
        h_, w_ = clicks[n_clicks - 1]["y"], clicks[n_clicks - 1]["x"]
        out["reccs"] = cd_.get_ab_reccs(h_, w_, K=SUGGEST_K,
                                        return_conf=True)
        out["palette"] = cd_.suggest_table(*tables[n_clicks], h_, w_,
                                           K=SUGGEST_K)
        out["map_suggest"] = cd_._dev_dist.cpu().numpy()
        mark("window click, getters, suggest_table")
        cd_.compute_entropy()
        out["entropy"] = cd_.dist_entropy
        out["dist_ab_full"] = cd_.dist_ab_full
        out["in_hull"] = cd_.in_hull
        out["demo"] = demos.demo_global_histogram(
            image(5, *FULLRES_HW), ref_im, weights=wpath["global"], Xd=S,
            device=device)
        out["glob_fullres"] = cg_.get_img_fullres()
        mark("entropy, demo")
        # the batch forms: N = 8 images, row 0 without a histogram
        globs = np.zeros((8, 314), np.float32)
        globs[1:, :313] = np.stack([np.roll(out["glob"], 11 * i)
                                    for i in range(1, 8)])
        globs[1:, 313] = 1.0
        out["globs"] = globs
        out["batch_global"] = B.colorize_batch_global(cg_.net, imgs, globs,
                                                      device=device)
        mark("colorize_batch_global N=8")
        out["batch_suggest"] = B.suggest_batch_table(
            m.net, imgs, bx, vl, ct, [c["y"] for c in clicks[:8]],
            [c["x"] for c in clicks[:8]], K=SUGGEST_K, seed=3,
            device=device)
        mark("suggest_batch_table N=8")
        return (cm_, cg_, cd_), out

    caffe_entries = (k1.KERNEL_BATCH, k2.KERNEL, k2.KERNEL_AB,
                     k2.KERNEL_BATCH, k3.KERNEL)
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    for k in entries:
        k.launches = 0
    t0 = time.perf_counter()
    (cfm, cfg, cfd), cgpu = caffe_session(None, len(clicks), True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    caffe_launches = {k.name: k.launches for k in entries}
    print(f"Caffe path on the card: {wall:.2f} s, launches {caffe_launches}")
    for k in caffe_entries:
        if caffe_launches[k.name] == 0:
            die(f"kernel {k.name} was not launched on the Caffe path")
    print(f"device memory: {mem_before / 2**30:.3f} GiB allocated by the "
          f"earlier phases' models and graphs when the Caffe path began, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB held after it "
          f"({torch.cuda.max_memory_reserved() / 2**30:.3f} GiB reserved); "
          f"peak GiB allocated by step: " + "; ".join(mem_marks))

    # what came out
    for key, val in cgpu.items():
        if isinstance(val, np.ndarray) and val.dtype != bool and \
                not np.isfinite(val).all():
            die(f"Caffe path: {key} is not finite")
    for key in ("main_dense0", f"main_click{len(clicks)}", "glob_none",
                "glob_ref", "dist_dense", "main_win_net", "main_mask"):
        if cgpu[key].shape != (S, S, 3) or cgpu[key].dtype != np.uint8:
            die(f"Caffe path: {key} is {cgpu[key].shape} {cgpu[key].dtype}")
    for key in ("main_fullres", "main_mask_fullres", "glob_fullres"):
        if cgpu[key].shape != FULLRES_HW + (3,):
            die(f"Caffe path: {key} is {cgpu[key].shape}")
    if cgpu["main_win"].shape != (WIN, WIN, 3):
        die(f"Caffe path: the window frame is {cgpu['main_win'].shape}")
    if np.array_equal(cgpu["main_dense0"], cgpu[f"main_click{len(clicks)}"]):
        die("Caffe path: ten hints did not change the main frame")
    if not np.array_equal(cgpu["main_win_net"],
                          cgpu[f"main_click{len(clicks)}"]):
        d = np.abs(cgpu["main_win_net"].astype(int)
                   - cgpu[f"main_click{len(clicks)}"].astype(int)).max(-1)
        if d.max() > CAFFE_FRAME_BOUND_LSB or \
                np.mean(d != 0) >= CAFFE_FRAME_BOUND_SHARE:
            die(f"Caffe path: the window click's net frame is {d.max()} LSB "
                f"on {np.mean(d != 0):.2e} of the pixels from the table "
                f"click's")
    glob_moved = float(np.mean((cgpu["glob_none"] != cgpu["glob_ref"])
                               .any(-1)))
    if glob_moved < 0.5:
        die(f"Caffe path: the histogram changed only {glob_moved:.3f} of "
            f"the global frame's pixels")
    if abs(float(cgpu["glob"].sum()) - 1) > 1e-5 or cgpu["glob"].shape != \
            (313,):
        die("global_stats.extract: the histogram does not sum to 1")
    for key in ("map_dense", "map_table", "map_suggest"):
        cmap = cgpu[key]
        if cmap.shape != (S, S, 313):
            die(f"Caffe path: {key} is {cmap.shape}")
        if np.abs(cmap.sum(-1) - 1).max() > 1e-4:
            die(f"Caffe path: {key}'s rows sum to 1 within "
                f"{np.abs(cmap.sum(-1) - 1).max():.2e} only")
    full = cgpu["dist_ab_full"]
    if full.shape != (529, S, S) or full[~cgpu["in_hull"]].any() or \
            not np.array_equal(full[cgpu["in_hull"]],
                               cgpu["map_suggest"].transpose(2, 0, 1)):
        die("Caffe path: dist_ab_full is not the map scattered into the 529 "
            "grid with zeros outside the hull")
    centers, conf = cgpu["reccs"]
    colors_u8, pal_conf = cgpu["palette"]
    bs_colors, bs_conf = cgpu["batch_suggest"]
    if colors_u8.shape != (SUGGEST_K, 3) or colors_u8.dtype != np.uint8:
        die(f"Caffe suggest_table: colors are {colors_u8.shape}")
    if bs_colors.shape != (8, SUGGEST_K, 3) or bs_colors.dtype != np.uint8:
        die(f"suggest_batch_table: colors are {bs_colors.shape}")
    for name, c in (("get_ab_reccs", conf[None]),
                    ("suggest_table", pal_conf[None]),
                    ("suggest_batch_table", bs_conf)):
        if (c.shape[1] != SUGGEST_K or np.abs(c.sum(1) - 1).max() > 1e-5
                or (np.diff(c, axis=1) > 0).any()):
            die(f"Caffe path, {name}: confidences {c} do not sum to 1 "
                f"within 1e-5, or are not sorted")
    if centers.shape != (SUGGEST_K, 2) or np.abs(centers).max() > 110:
        die(f"Caffe get_ab_reccs: centers {centers.shape} leave [-110, 110]")
    if cgpu["entropy"].shape != (S, S) or (cgpu["entropy"] > 0).any():
        die("Caffe compute_entropy: not (Xd, Xd) or positive")
    demo = cgpu["demo"]
    if (demo["auto"].shape != FULLRES_HW + (3,)
            or np.array_equal(demo["auto"], demo["with_ref"])
            or np.abs(demo["glob_dist"] - cgpu["glob"]).max() > 1e-6):
        die("demo_global_histogram: wrong shapes, the reference changed "
            "nothing, or its histogram is not global_stats.extract's")
    d = np.abs(demo["with_ref"].astype(int)
               - cgpu["glob_fullres"].astype(int)).max(-1)
    if d.max() > CAFFE_FRAME_BOUND_LSB or \
            np.mean(d != 0) >= CAFFE_FRAME_BOUND_SHARE:
        die(f"demo_global_histogram: its frame is {d.max()} LSB on "
            f"{np.mean(d != 0):.2e} of the pixels from the session's")
    # the batch form against eight net_forward calls (after the counts)
    b_worst, b_share = 0, 0.0
    for i in range(8):
        cfg.set_image(imgs[i])
        want = cfg.net_forward(*zero_hints,
                               -1 if i == 0 else cgpu["globs"][i, :313])
        d = np.abs(cgpu["batch_global"][i].astype(int)
                   - want.astype(int)).max(-1)
        b_worst = max(b_worst, int(d.max()))
        b_share = max(b_share, float(np.mean(d != 0)))
    cfg.load_image_array(image(5, *FULLRES_HW))
    ab_span = np.percentile(np.abs(cgpu["ab_main_dense0"]), [10, 50, 90])
    print(f"Caffe path checks: frames finite and of the expected shapes; "
          f"main output |ab| at the 10th/50th/90th percentile "
          f"{ab_span[0]:.1f}/{ab_span[1]:.1f}/{ab_span[2]:.1f} (tanh not "
          f"saturated); the histogram changed {glob_moved:.3f} of the "
          f"global frame's pixels; maps ({S},{S},313) with rows summing to "
          f"1 within {np.abs(cgpu['map_dense'].sum(-1) - 1).max():.2e}, "
          f"largest p {cgpu['map_dense'].max():.3f}; dist_ab_full 529 with "
          f"zeros outside the hull; confidences sorted, top "
          f"{conf[0]:.3f}; demo_global_histogram's frame within "
          f"{int(d.max())} LSB of the session's; colorize_batch_global N=8 "
          f"vs eight net_forward calls: {b_worst} LSB on at most "
          f"{b_share:.2e} of the pixels; suggest_batch_table N=8: (8,"
          f"{SUGGEST_K},3) palettes, confidences sorted and summing to 1")
    if cgpu["batch_global"].shape != (8, S, S, 3) or \
            b_worst > CAFFE_FRAME_BOUND_LSB or \
            b_share >= CAFFE_FRAME_BOUND_SHARE:
        die(f"colorize_batch_global N=8 vs eight net_forward calls: "
            f"{b_worst} LSB on {b_share:.2e} of the pixels (bound "
            f"{CAFFE_FRAME_BOUND_LSB} LSB on < {CAFFE_FRAME_BOUND_SHARE})")

    # the CPU twin
    t0 = time.perf_counter()
    _, ccpu = caffe_session("cpu", CAFFE_CPU_CLICKS, False)
    print(f"the Caffe path's CPU twin (dense click, {CAFFE_CPU_CLICKS} "
          f"table clicks, two global clicks, dist click, predict): "
          f"{time.perf_counter() - t0:.1f} s")
    # the card's table map saw ten hints, the twin's fewer: again on the card
    if cfd.predict_dist_table(*tables[CAFFE_CPU_CLICKS]) != 0:
        die("Caffe path: predict_dist_table failed")
    cgpu["map_table"] = cfd._dev_dist.cpu().numpy()
    worst_frame, worst_share, worst_ab, worst_map = 0, 0.0, 0.0, 0.0
    for key, want in ccpu.items():
        got = cgpu[key]
        if key.startswith("map"):
            worst_map = max(worst_map, float(np.abs(got - want).max()))
        elif got.dtype == np.uint8:
            d = np.abs(got.astype(int) - want.astype(int)).max(-1)
            worst_frame = max(worst_frame, int(d.max()))
            worst_share = max(worst_share, float(np.mean(d != 0)))
            same = d == 0
            if same.any():
                worst_ab = max(worst_ab, float(np.abs(
                    cgpu["ab_" + key] - ccpu["ab_" + key]).max(0)[same]
                    .max()))
    glob_err = float(np.abs(cgpu["glob"] - ccpu["glob"]).max())
    print(f"card vs CPU, Caffe path: frames within {worst_frame} LSB on at "
          f"most {worst_share:.2e} of a frame's pixels (bound "
          f"{CAFFE_FRAME_BOUND_LSB} LSB on < {CAFFE_FRAME_BOUND_SHARE}); "
          f"output_ab within {worst_ab:.2e} where the frames agree (bound "
          f"{CAFFE_AB_BOUND}); maps within {worst_map:.2e} (bound "
          f"{MAP_BOUND}); global_stats histogram within {glob_err:.1e}")
    if (worst_frame > CAFFE_FRAME_BOUND_LSB
            or worst_share >= CAFFE_FRAME_BOUND_SHARE
            or worst_ab > CAFFE_AB_BOUND or worst_map > MAP_BOUND
            or glob_err > 1e-6):
        die("the Caffe path on the card is outside its bounds against the "
            "CPU twin")

    # captured against eager, deterministic convolutions
    torch.backends.cudnn.deterministic = True
    try:
        dm_, dg_, dd_ = caffe_models(None)
        l4 = lambda mod: mod._dev_l_mc.permute(2, 0, 1)[None]  # noqa: E731
        glob_dev = dg_._to_dev(dg_._glob_array(cgpu["glob"]))
        for ab_, mask_ in (zero_hints, (dense_ab, dense_mask)):
            frame = dm_.net_forward(ab_, mask_).copy()
            rgb, ab = dm_._click.fn(dm_._dev_l_net, l4(dm_), dm_._hints3())
            if not (np.array_equal(frame, rgb.cpu().numpy())
                    and torch.equal(dm_._dev_output_ab, ab)):
                die("captured Caffe dense click differs from the eager one")
            for g_in, g_dev in ((-1, torch.zeros_like(glob_dev)),
                                (cgpu["glob"], glob_dev)):
                frame = dg_.net_forward(ab_, mask_, g_in).copy()
                rgb, ab = dg_._click.fn(dg_._dev_l_net, l4(dg_),
                                        dg_._hints3(), g_dev)
                if not (np.array_equal(frame, rgb.cpu().numpy())
                        and torch.equal(dg_._dev_output_ab, ab)):
                    die("captured global click differs from the eager one "
                        "(glob_dist=-1 must equal an all-zero blob)")
                two_step = dg_.get_img_fullres()
                if not np.array_equal(
                        dg_.net_forward_fullres(ab_, mask_, g_in), two_step):
                    die("global net_forward_fullres differs from "
                        "net_forward + get_img_fullres")
            frame = dd_.net_forward(ab_, mask_).copy()
            rgb, ab, dmap = dd_._click.fn(dd_._dev_l_net, l4(dd_),
                                          dd_._hints3())
            cap_err = float((dd_._dev_dist - dmap).abs().max())
            if not (np.array_equal(frame, rgb.cpu().numpy())
                    and torch.equal(dd_._dev_output_ab, ab)
                    and cap_err <= MAP_BOUND):
                die(f"captured Caffe dist click differs from the eager one "
                    f"(map {cap_err})")
        for i in (0, 4, 10):
            b, v, c = up(tables[i])
            frame = dm_.net_forward_table(*tables[i]).copy()
            out_ab = dm_._dev_output_ab
            rgb, ab, planes = dm_._click_tbl.fn(dm_._dev_l_net,
                                                dm_._dev_l_mc, b, v, c)
            if not (np.array_equal(frame, rgb.cpu().numpy())
                    and torch.equal(out_ab, ab)
                    and np.array_equal(dm_.input_mask,
                                       planes[2:].cpu().numpy())):
                die(f"captured Caffe table click {i} differs from the eager "
                    f"one")
            # the dense click gets the mask already x110, the table click
            # scales it inside: one frame by both routes
            if not np.array_equal(
                    dm_.net_forward(dm_.input_ab, dm_.input_mask), frame):
                die(f"Caffe table click {i} and the dense click on its own "
                    f"planes give different frames")
            win = dm_.net_forward_table_win(*tables[i], *window)
            ewin = dm_._click_tbl_win.fn(dm_._dev_l_net, dm_._dev_l_mc,
                                         *window, b, v, c)[2]
            if not (np.array_equal(win, ewin.cpu().numpy())
                    and np.array_equal(dm_.output_rgb, frame)):
                die(f"captured Caffe window click {i} differs from the "
                    f"eager one")
            if dd_.predict_dist_table(*tables[i]) != 0:
                die("captured Caffe predict_dist_table failed")
            emap = dd_._predict_tbl.fn(dd_._dev_l_mc, b, v, c)[0]
            cap_err = max(cap_err,
                          float((dd_._dev_dist - emap).abs().max()))
        if cap_err > MAP_BOUND:
            die(f"captured vs eager, Caffe maps: {cap_err}")
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"captured vs eager, Caffe clicks, deterministic convolutions: "
          f"dense (0 and 6 hints), global (glob_dist=-1 equal to an "
          f"all-zero blob; with the histogram), dist, table and window "
          f"clicks (0, 4, 10 hints): frames, output_ab and hint planes "
          f"byte-equal; table click equal to the dense click on its planes; "
          f"global net_forward_fullres equal to the two-step form byte for "
          f"byte; maps within {cap_err:.2e} (bound {MAP_BOUND})")

    # times, for information
    glob_np = cgpu["glob"]
    caffe_clicks = (
        ("Caffe main table click", lambda: cfm.net_forward_table(*tables[-1])),
        ("Caffe main dense click",
         lambda: cfm.net_forward(dense_ab, dense_mask)),
        ("Caffe global click",
         lambda: cfg.net_forward(*zero_hints, glob_np)),
        ("Caffe dist click", lambda: cfd.net_forward(dense_ab, dense_mask)),
        ("Caffe predict_dist_table",
         lambda: cfd.predict_dist_table(*tables[-1])))
    for name, fn in caffe_clicks:
        fn()
        t = host_ms(fn, 30)
        events, per_click, wall_ms = device_profile(fn, 5)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        conv_us = sum(e.self_device_time_total for e in events
                      if any(tag in e.key for tag in
                             ("conv", "gemm", "dgrad", "xmma", "cutlass",
                              "cudnn", "nhwc", "nchw"))) / 5
        print(f"{name} on the card (captured; host clock, results read "
              f"back): p50 {np.percentile(t, 50):.3f} ms, p95 "
              f"{np.percentile(t, 95):.3f} ms over {len(t)} calls; "
              f"{per_click:.0f} device kernels, {host_launches()}; device "
              f"busy {busy_ms / 5:.3f} ms per call, of it conv and layout "
              f"kernels {conv_us / 1e3:.3f} ms; idle share "
              f"{1 - busy_ms / wall_ms:.3f} under the profiler")
        if name == "Caffe dist click":
            for e in events[:10]:
                print(f"  {e.self_device_time_total / 5:10.1f} us/click "
                      f"{e.count // 5:4d}x  {e.key[:100]}")
    bfm = ColorizeImageTorchCaffe(Xd=S)
    bfm.prep_net(0, caffemodel_path=wpath["main"], dtype="bfloat16")
    bfm.load_image_array(image(5, *FULLRES_HW))
    bf_frame = bfm.net_forward_table(*tables[-1]).copy()
    f32_frame = cfm.net_forward_table(*tables[-1])
    bf_lsb, bf_equal = B.frame_delta_stats(bf_frame, f32_frame)
    t = host_ms(lambda: bfm.net_forward_table(*tables[-1]), 30)
    events, per_click, wall_ms = device_profile(
        lambda: bfm.net_forward_table(*tables[-1]), 5)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"Caffe main table click, bf16 (captured): p50 "
          f"{np.percentile(t, 50):.3f} ms, p95 {np.percentile(t, 95):.3f} "
          f"ms; {per_click:.0f} device kernels, device busy "
          f"{busy_ms / 5:.3f} ms per click; against the f32 click: max "
          f"{bf_lsb} LSB, {bf_equal:.4f} of the pixels equal, PSNR "
          f"{psnr(bf_frame, f32_frame):.2f} dB, max |d output_ab| "
          f"{np.abs(bfm.output_ab - cfm.output_ab).max():.3f} (printed, not "
          f"bounded: a random-weight net; BF16_BOUND is the teacher's)")
    print(f"peak device memory at the end of the Caffe path: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB allocated, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB reserved")
    # 12. the HTTP server on the card (fifth launch count)
    server_launches = server_phase(entries, wpath["global"])
    tmp.cleanup()
    # 13. training, distillation and evaluation on the card (sixth count)
    train_launches = train_phase(entries, dev)
    # 14. the front-ends: the GUI, the video app, the front door (seventh)
    frontend_launches = frontend_phase(
        entries, dev, {"dense": fps["dense", False],
                       "table": fps["table", False]})
    # 15. the native host runtime and the host-composed clicks (eighth)
    host_ops_launches = host_phase(entries, dev)
    # 16. the multi-device forms on meshes that repeat the card (ninth)
    mesh_launches = mesh_phase(entries, dev, sds["global"])
    # 17. the mesh across two processes (no kernel of its own)
    process_mesh_phase(dev)
    # 18. the reference's doors, in a child process (eleventh path)
    doors_launches = doors_phase(entries)
    # 19. the standalone programs on the main and dist sessions (twelfth)
    programs_launches = programs_phase(entries, dev, m, dd)

    # 20. the kernels line
    kernels = []
    for k in entries:
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"ideepcolor_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": (launches[k.name] + dist_launches[k.name]
                         + engine_launches[k.name]
                         + caffe_launches[k.name]
                         + server_launches[k.name]
                         + train_launches[k.name]
                         + frontend_launches[k.name]
                         + host_ops_launches[k.name]
                         + mesh_launches[k.name]
                         + doors_launches[k.name]
                         + programs_launches[k.name]),
            "launches_main_path": launches[k.name],
            "launches_dist_session": dist_launches[k.name],
            "launches_engines": engine_launches[k.name],
            "launches_caffe_path": caffe_launches[k.name],
            "launches_server": server_launches[k.name],
            "launches_train_eval": train_launches[k.name],
            "launches_frontends": frontend_launches[k.name],
            "launches_host_ops": host_ops_launches[k.name],
            "launches_mesh": mesh_launches[k.name],
            "launches_reference_doors": doors_launches[k.name],
            "launches_programs": programs_launches[k.name],
            **report[k.name], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    # 21.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--doors-child"]:
        sys.exit(doors_child(*sys.argv[2:4]))
    sys.exit(main())
