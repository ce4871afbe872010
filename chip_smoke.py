#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fitclip_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-steps [DIR]   # phase 6 (d) alone, for DIR's package
    python3 chip_smoke.py --row-passes [DIR]    # the LayerNorm and amax kernels alone
    python3 chip_smoke.py --fp32-attention [DIR]  # the fp32 attention rows, encode and step
    python3 chip_smoke.py --fit-attention [DIR]   # FiT's attention rows and encodes
    python3 chip_smoke.py --bench-arms [DIR]      # S2's s8 arms and slice-requant
    python3 chip_smoke.py --stem-cls [DIR]        # the S3D-G stem, K4's CLS row, their encodes
    python3 chip_smoke.py --train-cli             # phase 13 alone, on phase 11's trees
    python3 chip_smoke.py --resnet-wise           # phase 14 alone, on phase 11's and 13's trees
    python3 chip_smoke.py --export                # phase 15 alone
    python3 chip_smoke.py --op-dispatch [DIR]     # phase 15 (d) alone, for DIR's package
    python3 chip_smoke.py --distributed           # phase 16 alone
    python3 chip_smoke.py --per-epoch-grid        # phases 17 and 18 alone

Drives these paths at full width, with weights initialized from a seed: int8
CLIP ViT-B/16 zero-shot encoding, CLIP training (contrastive and FitCLIP
teacher-student, through ``run_train``), Frozen-in-Time base zero-shot
encoding (int8, bf16 and fp32), the S3D-G family (MIL-NCE bf16 and int8, VideoCLIP
bf16), CLIP ViT-B/16 bf16 on the float layer kernels (K2), SLIP ViT-B/16 in
four configurations, the port's benchmarks (``python -m
fitclip_torch.bench``: the ablation arms S1-S3 and the encode bench), and the
eval CLI (``python -m fitclip_torch command=evaluate|predict``, one data module
and the drift_eval group), the embed service over HTTP, and the train-side CLI
(``command=train`` contrastive, teacher-student and with a sweep, resume,
``command=tune``), and the CLIP ResNet (RN50 encodes, evaluate and training
through the CLI) and WiSE-FT slice, and the export slice (each tower a
``torch.export`` program on the ``fitclip::`` operators, served from
EMBED_EXPORT_DIR), and the CLI under a process group (torchrun's variables;
one rank on NCCL, two sharing the card over gloo), the per-epoch evaluation
loop with its frame cache and checkpoint entry points, and tensor
parallelism and the GPipe pipeline (four gloo ranks sharing the card). It
fails (non-zero exit) if any phase fails:

1. device: needs CUDA; prints the card and its power limit;
2. build: compiles fitclip_torch/csrc/*.cu for sm_90a (fitclip_torch/_build.py);
3. kernels: each Hopper kernel against its plain PyTorch version on the card,
   at the main paths' shapes (ViT-B/16 vision: 32 frames x 197 tokens x 768;
   text: 8 x 77 x 512; the attention backward at the training shapes, 128
   frames x 197 x 2304 and 32 x 77 x 1536 causal, in bf16 and fp32, timed in
   bf16 at both; FiT base:
   K4's int8 attention cores on the joint 32 x 785 x 2304 qkv (its space core
   also on the qkv in fp32), K5 on 128 frame groups of 196 rows and K6 on 32 x
   784 x 2304, each in bf16 and fp32, all timed by device time too, and the
   time kernel's frame tiers at F = 1, 8 and 16 (8 clips of F x 196 rows,
   bf16, fp32 and int8 out), K4's CLS row (cls_rows_kernel) on the joint qkv
   in bf16 and fp32; the S3D-G stem, K7 (s3dg_stem_wgmma_kernel), on 32 clips x
   16 frames of 224^2, timed by events and by its own device time; the
   float layer's kernels, K2, at 32 x 197 x 768 with its GEMMs at M = 6304
   and (N, K) = (2304, 768), (768, 768), (3072, 768), (768, 3072), its
   attention also at 8 x 77 causal; K8 at 32 x 197 x 768;
   the fp32 attention (the register-tiled kernels) in its three forward modes
   at one vision layer of the fp32 encode and step (128 x 197 x 2304), at 32
   frames, at the encode's text batch (256 x 77 x 1536 causal) and at L = 577,
   and its backward at the step's shapes and L = 577, each beside SDPA's fp32
   call with TF32 off; the repaired shapes: every attention mode
   and the backward at head_dim 32 (ViT-S/16, 32 x 197 x 384, 6 heads); bf16
   attention past 208 keys on the mma sweep (8 x 257 and 4 x 577, 16 heads,
   full and causal with seq_valid, every shipped mode, and the backward there
   and at 1 x 900 on its global body); the bench kernels at the benches'
   production shapes: S1's LN, attention and fc-epilogue modes on 512 frames
   x 197 x 768, S2's modes, amax pass and s8 attention on 512 x 197 x 2304
   (the s8 arms also at 8 x 257, past their 208 resident keys, and timed by
   device time too), slice-requant on 32 x 785 x 2304 in bf16 and fp32, equal
   to its plain version; a profile of one call each must show the s8 and
   slice-requant bodies, attention_s8_mma_kernel and slice_requant_rows_kernel,
   and no profile may show the kernels they replaced, attention_s8_kernel and
   slice_requant_kernel). ``--bench-arms DIR`` runs those rows, the `bf16`
   arm's device time and S2's and S3's slice cases alone for the package
   under DIR (the parent's, say).
   int8 outputs may differ by one step on at most 0.1% of
   the elements; float outputs stay within atol/rtol 2e-2 of the plain version
   run in fp32, the stem's within one bf16 ulp on all but 0.1%; two launches of
   each shipped attention mode, of the attention backward, of each FiT kernel
   and of the stem give the same bits. Each timed kernel gets
   its plain time, its bound (bytes over 3.35 TB/s or operations over the
   peak of their type) and, where one PyTorch call computes the same function
   (scaled_dot_product_attention; torch._int_mm for the int8 GEMMs' product
   only; torch.addmm for the bf16 bias GEMM, torch.mm, the product only, for
   its residual and GELU GEMMs; F.layer_norm for ln_cast), that call's time.
   The QKV GEMMs are also timed at the encode's M = 25,216 (32 clips x 4
   frames). The int8 bias and residual GEMMs are bit-identical to their plain
   versions, and two launches of each bf16 GEMM give the same bits;
4. the CLIP slice: load, fold the pixel normalization, calibrate on 8 clips and
   32 token rows, encode 8 clips and 8 token rows. The launch counters, zeroed
   just before and read just after, must show calibration through the qkv-mode
   attention kernel and K1's kernels on 12 layers of each tower. Gates: the
   kernel path against the plain path on the card, and int8 against the bf16
   float model, both towers, min-row cosine > 0.999; finite text x video scores;
5. timings (CUDA events, after warm-up): the CLIP slice's clips/s at 32 clips,
   and profiler tables of the int8 and bf16 (module path) encodes. This
   profile and those of phases 7 and 9 require the tensor-core attention
   bodies (attention_mma_kernel, space_mma_kernel) by kernel name, and no
   CUDA-core attention body (attention_f32_kernel, space_f32_kernel and the
   replaced space_kernel_f32): every bf16 attention runs on the tensor cores;
   the FiT profiles require the time kernel (time_rows_kernel), the int8 one
   the CLS kernel (cls_rows_kernel), and no profile may show the kernels they
   and space_f32_kernel replaced (time_kernel, cls_kernel, space_kernel_f32),
   nor the replaced stem kernel (s3dg_stem_kernel); the int8 and K2 paths' profiles
   require the wgmma GEMM kernels (int8_gemm_wgmma_kernel,
   bf16_gemm_wgmma_kernel), and no profile may show the mma.sync GEMM kernels
   they replaced (int8_gemm_kernel, bf16_gemm_kernel), nor the CUDA-core fp32
   attention kernels the register-tiled ones replaced (attention_kernel_f32,
   rows_kernel, columns_kernel);
   (b) CLIP ViT-B/16 in fp32 as load_clip_encoder(dtype="float32") gives it
   (run after phase 9): one fp32 forward launch per layer and tower and
   nothing else of the port's; gate: min-row cosine > 0.999 against the same
   model with fused_attention=False on the card, both towers; clips/s at 32
   clips x 4 frames, text rows/s at 256 x 77, peak memory, and a profile that
   requires attention_f32_kernel and prints its share;
6. training: bf16 compute, fp32 master weights, fused attention, fused AdamW,
   synthetic uint8 video and token ids from a seed, through ``run_train``:
   (a) contrastive, 32 clips x 4 frames, config/trainer.yaml's optimizer and
       temperature, 5 steps: 24 launches each of the attention forward and
       backward kernels per step; the losses within relative 2e-2 of the same
       steps with the plain attention (forward and backward); the gradient
       reaches in_proj through the attention;
   (b) teacher-student, 8 labeled + 8 unlabeled clips, labeled share 0.9999,
       the calibrated int8 encoder of phase 4 as the frozen teacher on K1's
       kernels, 3 steps with finite losses and counted launches;
   (c) resume: 3 steps, checkpoint, restore, 2 more equal (a)'s 5 straight
       steps bit for bit (params and AdamW moments);
   (d) timings: contrastive and teacher-student step ms (the median of 5
       chains of 3 steps after warm-up, with min and max), clips/s, peak
       memory, and a profile of one step of each by group: the attention
       backward (K3b), the forward attention, the port's GEMM and LN kernels,
       cuBLAS, the optimizer; the contrastive and teacher-student profiles
       require K3b's tensor-core kernels (rows_mma_kernel, columns_mma_kernel)
       by name and no fp32 backward kernel. ``--train-steps DIR`` runs this
       part alone for the package under DIR (the parent's, say), on batches of
       its own;
   (e) fp32 contrastive (the configs' default dtype), 32 clips x 4 frames, (a)'s
       optimizer and temperature: 3 steps with 24 launches each of the fp32
       forward and backward kernels per step, the losses within relative 2e-2
       of the plain attention's; step ms as in (d), and a profile of one step
       that requires attention_f32_kernel, rows_f32_kernel and
       columns_f32_kernel and shows no bf16 attention kernel;
7. Frozen-in-Time base (Bain et al., ICCV 2021: 12 SpaceTimeBlocks of width
   768, 4 frames of 196 patches, DistilBERT, projection 256): load int8 and
   bf16 from seed 0 with device="cuda", calibrate the int8 encoder on 8 clips,
   encode 32 clips x 4 frames and 256 WordPiece-shaped rows x 77. Launch
   counts per path: calibration and text launch nothing, the int8 encode runs
   12 launches per block of K4's kernels, the bf16 encode K5 and K6 once per
   block. Gates, min-row cosine over the video embeddings: (i) each kernel
   path against the same model through the plain versions on the card, (ii)
   int8 against bf16, both > 0.999; finite text embeddings. Timings: int8 and
   bf16 clips/s, text rows/s, peak memory, and torch.profiler breakdowns of
   the int8 and bf16 encodes by kernel with the device's busy share;
   (b) FiT base in fp32 as load_frozen_in_time_encoder() gives it (the
   default dtype, fused attention on the card): K5 and K6 once per block and
   nothing else of the port's in an encode of 32 clips and 256 rows; gate:
   min-row cosine > 0.999 against the same model with fused_attention=False
   on the card; clips/s, text rows/s, peak memory, and a profile that requires
   space_f32_kernel and time_rows_kernel and prints their shares.
   ``--fit-attention DIR`` runs phase 3's FiT rows and the int8, bf16 and fp32
   encodes' clips/s alone for the package under DIR (the parent's, say);
8. the S3D-G family, from seed 0 with device="cuda": MIL-NCE (Miech et al.,
   CVPR 2020: S3D-G on 16 frames of 224^2, 512-d, word-embedding text tower)
   bf16 and int8 (calibrated on 8 clips), 32 clips and 256 rows x 20 ids;
   VideoCLIP (Xu et al., EMNLP 2021: BertConfig(), 6 video and 12 text layers)
   bf16, 8 videos x 32 frames and 256 rows x 64 ids. Launch counts per path: one
   stem launch per encode and per calibration, 15 int8 GEMMs in the int8
   encode, none for text. Gates, min-row cosine over the video embeddings: (i)
   each kernel path against the plain versions on the card > 0.999, (ii)
   MIL-NCE int8 against bf16 > 0.99; finite text embeddings; mean row norms.
   Timings: clips/s, videos/s, text rows/s, peak memory, and profiler tables
   of the bf16 MIL-NCE and VideoCLIP encodes by kernel with the device's busy
   share, each requiring the stem kernel (s3dg_stem_wgmma_kernel).
   ``--stem-cls DIR`` runs phase 3's stem and CLS rows (bf16 and fp32 qkv, by
   device time) and the MIL-NCE bf16 and int8, VideoCLIP and FiT int8 encodes
   alone for the package under DIR (the parent's, say);
9. the float layer and SLIP (run after phase 5, on phase 4's inputs):
   (a) CLIP ViT-B/16 bf16 loaded with fused_block=True: K2's seven launches
       per layer on 12 layers of each tower and nothing else; gates, min-row
       cosine > 0.999: (i) K2 against fused_bf16_layer_plain on the card,
       (ii) K2 against the bf16 module path (bench.py's gate 3); clips/s at 32
       clips;
   (b) SLIP ViT-B/16 (Mu et al., ECCV 2022) from seed 0: int8 calibrated on 8
       clips and 32 rows, then four paths on 8 clips and 8 rows: int8
       fused_block (K1, exact GELU in the vision tower), bf16 fused_block
       (K2), the bf16 module path (K3f) and the int8 module path with fused
       attention (K8 once per layer, the static denses on int8_gemm_bias).
       Launch counts per path; gates > 0.999: (i) each path against its plain
       versions on the card, (ii) int8 against bf16, both towers
       (scripts/bench_families.py's gate), (iii) K8's path against K1's;
       clips/s at 32 clips, text rows/s at 256 x 77, peak memory per path;
10. the bench path (fitclip_torch/bench), after phase 8: (a) every arm of S1
    (scripts/bench_block_layer.py), S2 (bench_attn_int8.py) and S3
    (bench_fit_block.py) against its plain twin on the card at 32 frames (S3:
    8 clips of the seeded, calibrated FiT base block 0): S1's arms and S2's
    cores under the float rule (`i8qkav`'s int8 weights under the int8 rule: an
    output may move by one weight step on at most 0.1% of its elements), S3's
    whole int8 blocks at most 0.5% of outputs past the float rule and each
    row's update (output - input) at cosine > 0.999, with a planted wrong arm
    (`nocls` held as `full`) that this rule must reject, and S1s (two CUDA
    streams) bit for bit against `full`; (b) with the launch counts zeroed,
    every arm of the three benches, once, at its script's production shape
    through the benches' own ``run`` (ms, cos_vs_full or min cosine against
    the fp32 oracle, TFLOP/s; SDPA beside S2's `bf16`; the cases that only
    rename an arm print ``same_function_as``), then one encode reading each
    for int8 and bf16 at 128 clips with bench.py's gates; every bench kernel
    must show launches there;
11. the eval CLI, last: a seeded MSR-VTT tree (72 MJPG AVIs of 96 frames of
    320x240 at 30 fps, distinct content and captions; 72 is not a multiple of
    the eval batch of 32) and a BPE vocabulary over its captions'
    (write_tiny_test_vocab), then, in this process through
    fitclip_torch.cli.main.main, ``command=evaluate encoder=clip_vit_b_16
    ++encoder.dtype=int8 data=msrvtt ++quant.calibration_batches=1`` (the
    scales persisted to quant.scales_path) and ``command=predict`` with them;
    prints the decoder that ran, each command's wall seconds and the runners'
    clips/s with decode included, and the card's busy share over one batch's
    window (the loader's next batch, the copy, both towers). Gates: (i) the
    printed R@1/5/10 and MdR equal the rank math of predict's embeddings;
    (ii) predict's video embeddings against the plain versions
    (``fused_attention=False``, the same scales) on the same clips, min-row
    cosine > 0.999; (iii) K1's 7 launches per layer on 12 + 12 layers per eval
    batch in each command, the evaluate's calibration (fused_attention_qkv
    once per layer) apart; (iv) finite embeddings; (v) no decoded clip is all
    zeros. Then grouped eval, ``data=drift_eval`` with those scales over the
    MSR-VTT tree, a CC3M val tree (32 JPEGs, a comma CSV whose captions hold
    commas and quotes) and a WebVid val tree (32 AVIs and a CSV): its
    ``*_msrvtt`` metrics must equal evaluate's, the ``*_cc3m`` and ``*_webvid``
    ones exist and are finite, K1's launches are 5 batches' worth.
12. the embed service (``fitclip_torch.serving.embed_service``), after phase 11
    and on its files: the seeded int8 CLIP ViT-B/16 composed from
    ``EMBED_ENCODER=clip_vit_b_16`` with ``EMBED_OVERRIDES=++encoder.dtype=int8
    ...``, phase 11's scales as EMBED_SCALES and predict's dump as
    EMBED_INDEX; one CUDA graph per bucket of each tower (text 1-32, video
    1-8), captured before any dispatcher starts; the stdlib Handler on
    127.0.0.1. Traffic: (a) 64 serial /embed_text of one text, (b) 32 client
    threads x 4 requests of 1-4 texts (from a spawned process, so that the
    clients do not share the service's interpreter lock), (c) 16 /embed_video
    posts of phase 11's AVIs from 4 threads, (d) 8 /search_videos, (e) an
    empty body, bytes that are not a video, an oversized body and an unknown
    path. Prints the set-up seconds and each capture's ms, p50/p99 latency
    of (a)-(c), requests/s and texts/s of (b), clips/s of (c), /health, and
    each bucket's replay against the eager kernel-path call (CUDA events).
    Gates: (i) served text rows against encode_text on the same ids, min
    cosine >= 0.9999 (the plain versions > 0.999); (ii) served clips against
    the eval pipeline and encode_video by hand, the same rules; (iii)
    /search_videos ranks as the host does from the index and the served
    query; (iv) the captures record K1's 84 launches a bucket (840) and the
    traffic launches nothing eagerly; (v) /health counts what was sent and
    every response has one row per text; (vi) (e) gives 400, 400, 413, 404.
    The trees are written under build/chip_smoke_eval/ and deleted.
13. the train-side CLI, after phase 12 on phase 11's trees, through
    fitclip_torch.cli.main.main with CLIP ViT-B/16 from seed 0 at full width
    (fp32 unless said) and a WebVid train tree it writes (112 seeded mp4v
    clips of 48 frames: 4 steps of webvid.yaml's batch of 28) and MSR-VTT's
    train list: (a) ``command=train encoder=clip_vit_b_16 data=webvid``, one
    epoch, validated on the WebVid val tree: 4 finite losses, per step 24 + 24
    launches of the fp32 attention forward and backward and nothing else, r1,
    r5, r10 and mr logged, ``last`` a full train state; prints clips/s from
    the first batch to the last step (decode included), each step's wall, its
    wait for the loader and its time in the step, beside phase 6 (e)'s
    device-only step; (b) ``+trainer.max_steps=2``, then ``+checkpoint_path=
    <last> +trainer.max_steps=4``: the last equals (a)'s bit for bit; (c) (a)
    on the plain attention: losses within relative 2e-2 of (a)'s, no launch;
    (d) ``--config-name teacher_student_trainer`` with a bf16 student and a
    bf16 ``fused_block`` teacher over ``data=mixed_batch_msrvtt_webvid``, 3
    steps of 8 + 8 clips: finite losses, per step K2's launches on both teacher
    towers and 24 + 24 bf16 attention launches, ``r1_labeled`` and
    ``r1_unlabeled`` logged, a ``best`` checkpoint; (e) ``--config-name
    drift_eval_trainer +hparam_search=random ++hparam_search.n_trials=2``, 2
    steps a trial: each trial validated with ``r10_cc3m``, ``r10_msrvtt`` and
    ``r10_webvid``, the printed best one of them; (f) ``command=evaluate
    data=msrvtt +checkpoint_path=<(a)'s last>``: the printed metrics equal
    RetrievalEvaluator over that state's encoder called directly, whose
    embeddings differ from the untrained encoder's; (g) ``command=tune
    data=webvid``, the doubling from 28 over enough trials to meet one CUDA
    OOM (sized from phase 6 (e)'s peak memory, printed), 8 LR steps: the
    suggestion is the last size that ran, the allocated memory after the
    search within 1% of before it, the LR in [1e-8, 1]. ``--train-cli`` runs
    this phase alone (on trees it writes as phase 11 does).
14. the CLIP ResNet and WiSE-FT, after phase 13 on its trees: (a) RN50 at full
    width from seed 0 (32 clips x 4 frames of 224^2, 77-token texts) in fp32
    and bf16: per encode of both towers 12 launches of the text tower's K3f
    (and of the fp32 attention kernel in fp32) and nothing else, the text
    tower against K3f's plain version on the card and bf16 against fp32 at
    cosine > 0.999, clips/s, texts/s, peak memory, profiles (the convolution
    kernels' share of the video encode; the text encode's attention body
    required); (b) ``command=evaluate encoder=clip_rn50 data=msrvtt`` in bf16:
    finite recalls and K3f's launches, ``++encoder.dtype=int8`` refused; (c)
    ``command=train encoder=clip_rn50 data=webvid`` in fp32, 3 steps of the
    config's batch of 28 under PyTorch's default cuDNN flags: per step 12
    launches each of K3f and K3b (fp32), every running statistic moved and
    equal to the last step's EMA write, with no optimizer moment, and 2 steps
    then a resume through the CLI to 3 bit-identical to the straight run;
    (d) phase 13 (a)'s student exported by ``python -m
    fitclip_torch.convert.checkpoint_to_state_dict``, then ``command=evaluate``
    and ``command=predict encoder=wise`` (model1 the seeded clip_vit_b_16,
    model2 the export, weight_for_2 0.4, bf16): finite metrics, 24 K3f
    launches a batch, and the predicted embeddings bit-equal to those of a
    clip_vit_b_16 loaded from the merged state dict written directly.
    ``--resnet-wise`` runs this phase alone (on trees it writes, with a
    student trained one step).
15. export, after phase 14 on phase 11's BPE vocabulary: (a) the seeded int8
    CLIP ViT-B/16 composed from config/ (``encoder=clip_vit_b_16
    ++encoder.dtype=int8``), calibrated on 8 clips and 32 token rows, its
    scales persisted; ``python -m fitclip_torch.serving.export_serving`` (a
    process of its own) exports text at buckets 1, 8, 32 and video at 1, 8 and
    prints their map; a fresh process (``--load-exported``) loads both programs
    with no ``fitclip_torch.models`` module and runs each bucket once. Gates:
    each bucket's rows against the eager encoder, min-row cosine >= 0.9999
    (and whether they are bit-equal), against the plain versions > 0.999; K1's
    84 launches in one call of each loaded program. Prints the artifacts'
    sizes, export s and load s. (b) The service with EMBED_EXPORT_DIR: the
    buckets are the artifacts', every bucket captured with K1's 84 launches,
    16 serial texts and 8 client threads x 8 requests of 1-4 texts over HTTP
    with no launch; served rows against eager >= 0.9999; set-up s beside phase
    12's. (c) One video bucket of 1 clip of each other family with a kernel,
    exported and loaded in this process: CLIP bf16 ``fused_block`` (K2's 84
    launches), FiT base int8 (K4: 12 a block), FiT bf16 (K5, K6: 12 each), SLIP
    int8 on the module path (K8: 12, with 36 static-dense GEMMs), MIL-NCE bf16
    (K7: 1); each against its eager tower >= 0.9999. (d) The op dispatch's
    cost: phase 5's int8 encode of 32 clips (clips/s, the host's ms to issue a
    call) and one ln_quant launch's host us through the wrapper (the Library
    operator), its CUDA implementation called directly, and a custom_op twin.
    ``--export`` runs this phase alone; ``--op-dispatch DIR`` runs (d) for the
    package under DIR (the parent's, say).
16. distribution, after phase 15 on phase 11's and 13's trees: each rank is a
    child process of this script (``--distributed-child``) that sets
    torchrun's variables and calls ``fitclip_torch.cli.main.run`` with the
    kernels' launches counted. (a) ``command=train`` fp32 contrastive (2 steps
    of 28 clips) and teacher-student (bf16 student, bf16 K2 teacher, 2 steps of
    8 + 8) at world size 1 on NCCL: each ``last`` bit-equal to the same run in
    a child with no process group, per step 24 + 24 fp32 attention launches
    (K2's and 24 + 24 bf16 ones for teacher-student); (b) the int8
    ``command=evaluate`` and ``predict`` on MSR-VTT at world size 1: metrics
    and predictions equal to the no-group run's, K1's launches as phase 11's;
    (c) two ranks on the one card over gloo: (a)'s contrastive run (losses
    within rel 1e-5 of (a)'s, parameters at rtol 1e-3 / atol 3e-3), the same
    under ``++trainer.fsdp=true`` (the same bounds against the replicated
    two-rank run, each rank holding under 0.6 of the parameter and moment
    bytes), and the int8 evaluate (metrics equal to (b)'s). The no-group and
    NCCL processes of (a)-(b) run at once, then the two ranks of (c); prints
    every step's ms beside the no-group run's. ``--distributed`` runs this
    phase alone (on trees it writes).
17. the per-epoch evaluation loop, after phase 16: ``python -m
    fitclip_torch.cli.evaluate_per_epoch`` (its ``main`` in this process) over
    phase 13 (d)'s ``best`` and ``last`` (as epoch_0 and epoch_1) with
    BENCHMARKS=msrvtt,webvid on phase 11's trees and FRAME_CACHE set: each
    checkpoint prepared (a NaN logit_scale), then ``--multirun
    command=evaluate encoder=wise`` of the seeded fp32 clip_vit_b_16 and
    ``clip_from_pretrained`` on the prepared file. Gates: the first checkpoint
    fills the cache (one file a clip), the second opens no video, K3f's fp32
    launches are 24 a batch, the metrics are finite; ``command=predict`` of
    the same ensemble on the warm cache opens no video and is bit-equal to the
    run with no cache; ``python -m fitclip_torch.convert.apply_wise_ft`` of the
    seeded ViT-B/16 and phase 14 (d)'s export is bit-equal to phase 14 (d)'s
    directly merged state dict. Prints the cold and warm windows with their
    items' ms a clip, and decode's ms a clip with decode_short_side=224 and
    without on a tree of 1280 x 720 clips.
18. tensor parallelism and the pipeline, after phase 17: four gloo ranks that
    share the card (NCCL refuses two ranks on one GPU), each a child process
    (``--grid-child``). (a) TP on a (data=2, model=2) grid: 3 contrastive
    steps of the seeded fp32 ViT-B/16 (8 clips, the global-norm clip 1.0),
    every loss within rel 1e-4 of the same steps in this process on one
    device, and the gathered update within 1e-2 of theirs, ‖a − b‖ ≤ 1e-2
    ‖b − θ₀‖ with the key bias left out as in phase 16; (b) the GPipe pipeline
    of the visual tower's 12 blocks over 4 stages, 4 microbatches of 2 x 197
    tokens: the output within atol / rtol 2e-4 of the sequential tower and the
    gradients within 1e-2 relative L2. Prints each rank's K3f and K3b counts
    (fp32), TP step ms and the pipeline's forward and backward ms.
    ``--per-epoch-grid`` runs phases 17 and 18 alone (two checkpoints of one
    and two contrastive steps through the CLI, and phase 14 (d) on the first).

TF32 is off for matmuls and cuDNN throughout, so fp32 references are fp32.
Each timed phase prints the card's SM and memory clocks beside its readings.
The last two lines are the kernels' JSON record (the attention rows also
name their __global__ body under "kernel") and the card line from nvidia-smi
before the final {"ok": true, "device": {...}} line.
"""

import contextlib
import copy
import json
import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VISION = dict(batch=32, seq=197, width=768, heads=12)
TEXT = dict(batch=8, seq=77, width=512, heads=8)
# The attention backward at the training step's shapes: 32 clips x 4 frames.
TRAIN_VISION = dict(VISION, batch=128)
TRAIN_TEXT = dict(TEXT, batch=32)
# Frozen-in-Time base (Bain et al., ICCV 2021, base_patch16_224): 32 clips x 4
# frames of 196 patches + the CLS row, width 768, 12 heads.
FIT = dict(clips=32, frames=4, patches=196, width=768, heads=12)
FIT_LAYERS = 12
FIT_INT8_LAUNCHES_PER_LAYER = {"ln_quant": 3, "int8_gemm_bias": 2, "int8_gemm_residual": 3,
                               "int8_gemm_gelu": 1, "fit_cls_attention_int8": 2,
                               "fit_time_attention_int8": 1, "fit_space_attention_int8": 1}
FIT_BF16_LAUNCHES_PER_LAYER = {"fused_attention_qkv_gkv": 1, "fused_time_attention": 1}
# S3D-G: MIL-NCE (Miech et al., CVPR 2020: S3D-G over 16 frames of 224^2, 512-d; text:
# 300-d word embeddings over 66,250 words, fc 2048, 20 tokens) and VideoCLIP (Xu et al.,
# EMNLP 2021: BertConfig(), 6 video and 12 text layers, 32-frame clips).
MIL_NCE = dict(clips=32, frames=16, size=224, calib=8, text_rows=256, tokens=20, vocab=66250)
VIDEOCLIP = dict(videos=8, frames=32, text_rows=256, tokens=64)
S3DG_INT8_SITES = 15  # 7 blocks from mixed_4b x (merged, b3) + fc
S3DG_GATE_INT8 = 0.99  # int8 against bf16, tests/test_s3dg_fast.py:127
INT8_MAX_FLIPPED = 1e-3  # share of int8 elements allowed one step off
FLOAT_TOL = 2e-2
GATE_COSINE = 0.999
# Share of a whole int8 FiT block's outputs allowed past the float rule: an
# int8 activation that rounds the other way before the MLP moves many outputs
# by a few fc2 steps (0.14% seen on the H100 at 8 clips).
LAYER_MAX_OVER = 5e-3
LOSS_RTOL = 2e-2  # kernel path vs plain attention, per training step
LAYERS = 12  # of each ViT-B/16 tower
INT8_LAUNCHES_PER_LAYER = {"ln_quant": 2, "int8_gemm_bias": 1, "int8_gemm_residual": 2,
                           "int8_gemm_gelu": 1, "attention_int8": 1}
K2_LAUNCHES_PER_LAYER = {"ln_cast": 2, "bf16_gemm_bias": 1, "bf16_gemm_residual": 2,
                         "bf16_gemm_gelu": 1, "attention_block": 1}


STARTED = time.perf_counter()


def elapsed() -> str:
    """The script's wall time so far (each phase's start prints it)."""
    return f"{time.perf_counter() - STARTED:.1f} s into the run"


def require(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"chip_smoke: {message}")


def nvidia_smi() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def clocks() -> str:
    """The card's SM and memory clocks now, beside a timed phase's readings (so
    that an A/B can tell clock drift from a change)."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The least time the card could take (H100 SXM datasheet peaks):
# the bytes a function must move over the memory rate, or its operations over
# the peak rate of their type, whichever is larger.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def bound(bytes_moved: float, ops, kind: str = None):
    """(bound_ms, "bytes" or "operations"). ops is a count of one kind, or
    {kind: count} for work of several types (K8's int8 GEMM and bf16 attention)."""
    ops = ops if isinstance(ops, dict) else {kind: ops}
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# A row whose kernel reads under DEVICE_BELOW_MS by events around 20 Python
# calls is also timed by its device time (device_ms): at that size the
# wrapper's host work (operand checks, torch.empty, the ctypes call) can set
# the events' pace instead of the kernel.
DEVICE_BELOW_MS = 0.1
PROFILER_PASSES = 3
COLD_BYTES = 3 * 50e6  # three times the H100's 50 MB L2


def device_ms(fn, *args, iters: int = 20, graph: bool = False, touched: int = None,
              only: str = None) -> float | None:
    """fn(*args)'s device time per call: the summed device durations of what
    it launches (kernels and memsets), from torch.profiler, over at least
    ``iters`` calls (with ``only``, of the kernels whose name holds it: a
    wrapper's kernel without the operand packing some trees do per call).
    The calls rotate among copies of the tensor arguments whose touched
    bytes together exceed COLD_BYTES, so that each call finds
    its inputs out of L2, as the bound (HBM bytes) assumes; ``touched`` is the
    bytes a call reads where that is less than its tensors' size (a slice of
    each row). The profiler drops an event now and then, so a pass whose
    count of events is no multiple of the calls is run again, up to
    PROFILER_PASSES times. Where every pass lost events (or with ``graph``),
    the same calls are captured in a CUDA graph and its replays timed with
    events; a callable marked ``capturable = False`` (autograd on a forward
    that ran outside the capture) is not captured, and its device time is
    then None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    size = touched or sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    copies = min(256, max(1, -(-int(COLD_BYTES) // max(size, 1))))
    sets = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
                     for _ in range(copies - 1)]
    calls = -(-max(iters, copies) // copies) * copies
    for inputs in sets:  # warm-up: each copy once
        fn(*inputs)
    torch.cuda.synchronize()
    name = getattr(fn, "__name__", fn)
    for _ in range(0 if graph else PROFILER_PASSES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(*sets[i % copies])
            torch.cuda.synchronize()
        total_us, launches = 0.0, 0
        for event in prof.key_averages():
            if str(getattr(event, "device_type", "")).endswith("CUDA") and (
                    only is None or only in event.key):
                us = getattr(event, "self_device_time_total", None)
                total_us += event.self_cuda_time_total if us is None else us
                launches += event.count
        # Every call launches the same work: a count that is no multiple of the
        # calls means the profiler lost events.
        if total_us > 0 and launches % calls == 0:
            return total_us / 1e3 / calls
        print(f"  device_ms: the profiler shows {launches} device events for {calls} calls of "
              f"{name}")
    if not graph:
        require(only is None, f"device_ms: the profiler lost events of {only}")
    if not getattr(fn, "capturable", True):
        print(f"  device_ms: {name} cannot be captured; its device time is not measured")
        return None
    if not graph:
        print(f"  device_ms: timing a CUDA graph of the calls of {name}")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*sets[0])
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(calls):
            fn(*sets[i % copies])
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * calls)
    del g
    return ms


def timing(kernel_ms, plain_ms, library_ms, bound_pair, kernel=None, library=None,
           device=False, touched=None, only=None):
    """A row of the kernels' record. kernel and library are (fn, *args) of the
    kernel's wrapper and of the library call: where the kernel reads under
    DEVICE_BELOW_MS (or with ``device``), their device times are added as
    device_ms and library_device_ms (``touched``, ``only``: device_ms's)."""
    entry = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": bound_pair[0], "bound_by": bound_pair[1]}
    if kernel is not None and (device or kernel_ms < DEVICE_BELOW_MS):
        entry["device_ms"] = device_ms(*kernel, touched=touched, only=only)
        entry["library_device_ms"] = device_ms(*library) if library else None
    return entry


def sdpa_ms(torch, q, k, v, scale, backward=False, causal=False):
    """One F.scaled_dot_product_attention call on (N, H, S, D) operands
    (the yardstick of an attention kernel; the port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not backward:
        return cuda_ms(lambda: sdpa(q, k, v, scale=scale, is_causal=causal))
    fn, *args = sdpa_backward(torch, q, k, v, scale, causal)
    return cuda_ms(lambda: fn(*args))


def sdpa_backward(torch, q, k, v, scale, causal=False):
    """(fn, q, k, v, grad): SDPA's backward on (N, H, S, D) operands, as
    timing() takes it. fn runs SDPA's forward on the first call with a set of
    inputs (a warm-up call in cuda_ms and device_ms, which give each copy of
    the inputs one) and the backward alone on every call. Autograd runs each
    backward op on its forward's stream, here the default one, so fn cannot
    be captured in a CUDA graph (which records on a stream of its own)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    graphs = {}

    def backward(q, k, v, grad):
        key = tuple(t.data_ptr() for t in (q, k, v, grad))
        if key not in graphs:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            graphs[key] = leaves, sdpa(*leaves, scale=scale, is_causal=causal)
        leaves, out = graphs[key]
        return torch.autograd.grad(out, leaves, grad, retain_graph=True)

    backward.capturable = False
    return backward, q, k, v, torch.ones_like(q)


def heads_first(qkv, heads):
    """(B, L, 3*H*D) -> q, k, v as contiguous (B, H, L, D)."""
    b, seq, triple = qkv.shape
    return [t.reshape(b, seq, heads, -1).transpose(1, 2).contiguous()
            for t in qkv.split(triple // 3, dim=-1)]


@contextlib.contextmanager
def swapped(module, **replacements):
    """Module attributes replaced for the duration (a plain version for a kernel)."""
    saved = {name: getattr(module, name) for name in replacements}
    for name, value in replacements.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def min_cosine(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def print_row(name, row) -> None:
    """One row of the kernels' record: kernel, plain, bound, library (and the
    device times where the row has them)."""
    library = row["library_ms"]
    device = (f", device {row['device_ms']:.4f} ms (library "
              f"{row['library_device_ms'] or float('nan'):.4f})" if "device_ms" in row else "")
    at = f" at {row['shape']}" if "shape" in row else ""
    print(f"  {name}{at}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
          f"{'none' if library is None else f'{library:.4f} ms'}{device}")


def bit_identical_to_plain(name, what, kernel_out, plain_out) -> None:
    """The int8 GEMM's bias and residual outputs round where their plain
    versions do (the exact int32 sum as fp32, then * scale, + bias, + residual,
    one rounding each): they must be bit-identical."""
    import torch

    require(torch.equal(kernel_out, plain_out), f"{name} {what}: not bit-identical to the plain "
            f"version (max |diff| {float((kernel_out.float() - plain_out.float()).abs().max())})")
    print(f"  {name} {what}: bit-identical to the plain version")


class KernelChecks:
    """Kernel-vs-plain comparisons, with the largest error seen per kernel."""

    def __init__(self):
        self.max_abs_err = {}

    def _record(self, name, err):
        self.max_abs_err[name] = max(self.max_abs_err.get(name, 0.0), err)

    def int8(self, name, what, kernel_out, plain_out):
        import torch

        torch.cuda.synchronize()
        diff = (kernel_out.int() - plain_out.int()).abs()
        err, flipped = int(diff.max()), float((diff != 0).float().mean())
        print(f"  {name} {what}: max |diff| {err} LSB, {flipped:.2e} of elements differ")
        require(err <= 1 and flipped <= INT8_MAX_FLIPPED,
                f"{name} {what}: int8 output off by {err} LSB on {flipped:.2e} of elements")
        self._record(name, float(err))

    def bf16_ulp(self, name, what, kernel_out, plain_fp32):
        """A bf16 output within one bf16 ulp of the plain fp32 result on all but
        INT8_MAX_FLIPPED of its elements."""
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        diff = (k - plain_fp32).abs()
        ulp = torch.exp2(torch.floor(torch.log2(plain_fp32.abs().clamp_min(1e-38))) - 7)
        over, err = float((diff > ulp).float().mean()), float(diff.max())
        print(f"  {name} {what}: max |diff| {err:.3e}, {over:.2e} of elements beyond one bf16 "
              f"ulp of the plain version in fp32")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(over <= INT8_MAX_FLIPPED, f"{name} {what}: {over:.2e} of elements beyond one ulp")
        self._record(name, err)

    def s8(self, name, what, kernel_out, plain_fp32, step):
        """The float rule, with S2's int8 attention weights under the int8 rule:
        a weight rint(w * 127) may round the other way (its softmax sums in
        another order), moving an output by up to ``step`` (v_amax / 127), on
        at most INT8_MAX_FLIPPED of the elements."""
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        diff = (k - plain_fp32).abs()
        err = float(diff.max())
        over = float((diff > FLOAT_TOL + FLOAT_TOL * plain_fp32.abs()).float().mean())
        print(f"  {name} {what}: max |diff| {err:.3e}, {over:.2e} of elements beyond the float "
              f"rule (one weight step {step:.3e})")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(over <= INT8_MAX_FLIPPED and err <= FLOAT_TOL + step,
                f"{name} {what}: max |diff| {err}, {over:.2e} of elements beyond the float rule")
        self._record(name, err)

    def layer(self, name, what, kernel_out, plain_fp32, x):
        """A whole int8 FiT block on input x against its plain twin. Its
        kernels meet the int8 and float rules one by one (above), but an int8
        activation that rounds the other way carries whole steps through the
        later GEMMs: at most LAYER_MAX_OVER of the outputs may be past the
        float rule, and each row's update (output - x, what the block adds to
        the residual stream, which x would dominate) keeps a cosine above
        GATE_COSINE."""
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        diff = (k - plain_fp32).abs()
        err = float(diff.max())
        over = float((diff > FLOAT_TOL + FLOAT_TOL * plain_fp32.abs()).float().mean())
        cos = min_cosine((k - x.float()).flatten(0, -2), (plain_fp32 - x.float()).flatten(0, -2))
        print(f"  {name} {what}: min row cosine of the update {cos:.6f}; max |diff| {err:.3e}, "
              f"{over:.2e} of elements beyond the float rule")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(cos > GATE_COSINE and over <= LAYER_MAX_OVER,
                f"{name} {what}: min row cosine of the update {cos}, {over:.2e} of elements "
                f"beyond the float rule")
        self._record(name, err)

    def float(self, name, what, kernel_out, plain_fp32):
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        err = float((k - plain_fp32).abs().max())
        print(f"  {name} {what}: max |diff| {err:.3e} against the plain version in fp32")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(torch.allclose(k, plain_fp32, atol=FLOAT_TOL, rtol=FLOAT_TOL),
                f"{name} {what}: max |diff| {err} beyond atol/rtol {FLOAT_TOL}")
        self._record(name, err)


def kernel_phase(torch, checks: KernelChecks):
    """Phase 3: each kernel against its plain version; returns {name: timing(...)}."""
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def normal(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    times = {}
    for tag, s in (("vision", VISION), ("text", TEXT)):
        m, w = s["batch"] * s["seq"], s["width"]
        timed = tag == "vision"

        # ln_quant: the bf16 layer input and the fp32 mid-layer residual.
        gamma, beta = 1 + normal(w, std=0.1), normal(w, std=0.1)
        for what, x in (("bf16 input", normal(m, w, dtype=torch.bfloat16)),
                        ("fp32 residual", normal(m, w, std=3.0))):
            inv = 127.0 / 4.0
            checks.int8("ln_quant", f"{tag} {what}", K.ln_quant(x, gamma, beta, inv),
                        K.ln_quant_plain(x, gamma, beta, inv))

        # int8 GEMM, its three epilogues at the layer's four shapes.
        a_w, a_4w = int8(m, w), int8(m, 4 * w)
        wq, wo, wf, wp = int8(3 * w, w), int8(w, w), int8(4 * w, w), int8(w, 4 * w)
        scale = lambda n, k: (torch.rand(n, generator=gen, device=dev) + 0.5) / (73.0 * 73.0 * k ** 0.5)
        sq, bq = scale(3 * w, w), normal(3 * w, std=0.1)
        out = K.int8_gemm_bias(a_w, wq, sq, bq, torch.bfloat16)
        checks.float("int8_gemm_bias", f"{tag} qkv", out,
                      K.int8_gemm_bias_plain(a_w, wq, sq, bq, torch.float32))
        bit_identical_to_plain("int8_gemm_bias", f"{tag} qkv", out,
                               K.int8_gemm_bias_plain(a_w, wq, sq, bq, torch.bfloat16))
        if timed:  # library: torch._int_mm, the product only, no epilogue
            times["int8_gemm_bias"] = timing(
                cuda_ms(lambda: K.int8_gemm_bias(a_w, wq, sq, bq, torch.bfloat16)),
                cuda_ms(lambda: K.int8_gemm_bias_plain(a_w, wq, sq, bq, torch.bfloat16)),
                cuda_ms(lambda: torch._int_mm(a_w, wq.t())),
                bound(m * w + 3 * w * w + 3 * w * 8 + m * 3 * w * 2, 2 * m * 3 * w * w, "int8"),
                (K.int8_gemm_bias, a_w, wq, sq, bq, torch.bfloat16), (torch._int_mm, a_w, wq.t()))
            # The encode's QKV GEMM: 32 clips x 4 frames x 197 tokens (its own
            # generator, so that the checks after it keep their inputs).
            me = 4 * m
            a_e = torch.randint(-127, 128, (me, w), device=dev, dtype=torch.int8,
                                generator=torch.Generator(device=dev).manual_seed(13))
            checks.float("int8_gemm_bias", f"{tag} qkv at the encode's M = {me}",
                         K.int8_gemm_bias(a_e, wq, sq, bq, torch.bfloat16),
                         K.int8_gemm_bias_plain(a_e, wq, sq, bq, torch.float32))
            times["int8_gemm_bias"]["encode"] = dict(timing(
                cuda_ms(lambda: K.int8_gemm_bias(a_e, wq, sq, bq, torch.bfloat16)),
                cuda_ms(lambda: K.int8_gemm_bias_plain(a_e, wq, sq, bq, torch.bfloat16), iters=5),
                cuda_ms(lambda: torch._int_mm(a_e, wq.t())),
                bound(me * w + 3 * w * w + 3 * w * 8 + me * 3 * w * 2, 2 * me * 3 * w * w, "int8")),
                shape=f"{me} x {3 * w} x {w}")
            print_row("int8_gemm_bias", times["int8_gemm_bias"]["encode"])
            del a_e

        so, bo, x_in = scale(w, w), normal(w, std=0.1), normal(m, w, dtype=torch.bfloat16)
        out = K.int8_gemm_residual(a_w, wo, so, bo, x_in, torch.float32)
        checks.float("int8_gemm_residual", f"{tag} out-proj (bf16 -> fp32)", out,
                     K.int8_gemm_residual_plain(a_w, wo, so, bo, x_in, torch.float32))
        bit_identical_to_plain("int8_gemm_residual", f"{tag} out-proj (bf16 -> fp32)", out,
                               K.int8_gemm_residual_plain(a_w, wo, so, bo, x_in, torch.float32))
        sp, bp, x32 = scale(w, 4 * w), normal(w, std=0.1), normal(m, w)
        out = K.int8_gemm_residual(a_4w, wp, sp, bp, x32, torch.bfloat16)
        checks.float("int8_gemm_residual", f"{tag} proj (fp32 -> bf16)", out,
                     K.int8_gemm_residual_plain(a_4w, wp, sp, bp, x32, torch.float32))
        bit_identical_to_plain("int8_gemm_residual", f"{tag} proj (fp32 -> bf16)", out,
                               K.int8_gemm_residual_plain(a_4w, wp, sp, bp, x32, torch.bfloat16))
        if timed:
            times["int8_gemm_residual"] = timing(
                cuda_ms(lambda: K.int8_gemm_residual(a_4w, wp, sp, bp, x32, torch.bfloat16)),
                cuda_ms(lambda: K.int8_gemm_residual_plain(a_4w, wp, sp, bp, x32,
                                                           torch.bfloat16)),
                cuda_ms(lambda: torch._int_mm(a_4w, wp.t())),
                bound(m * 4 * w + 4 * w * w + w * 8 + m * w * 4 + m * w * 2,
                      2 * m * w * 4 * w, "int8"),
                (K.int8_gemm_residual, a_4w, wp, sp, bp, x32, torch.bfloat16),
                (torch._int_mm, a_4w, wp.t()))

        inv_p = 127.0 / 6.0
        fs2, fb2 = scale(4 * w, w) * 20.0, normal(4 * w, std=2.0)  # t ~ 20 N(0, 1)
        for quick in (True, False):
            kv = (-1.702 * K.LOG2E / inv_p) if quick else (0.7071067811865475 / inv_p)
            checks.int8("int8_gemm_gelu", f"{tag} fc ({'quick' if quick else 'exact'} GELU)",
                        K.int8_gemm_gelu(a_w, wf, fs2, fb2, kv, quick),
                        K.int8_gemm_gelu_plain(a_w, wf, fs2, fb2, kv, quick))
            if timed and quick:
                times["int8_gemm_gelu"] = timing(
                    cuda_ms(lambda: K.int8_gemm_gelu(a_w, wf, fs2, fb2, kv, True)),
                    cuda_ms(lambda: K.int8_gemm_gelu_plain(a_w, wf, fs2, fb2, kv, True)),
                    cuda_ms(lambda: torch._int_mm(a_w, wf.t())),
                    bound(m * w + 4 * w * w + 4 * w * 8 + m * 4 * w, 2 * m * 4 * w * w, "int8"),
                    (K.int8_gemm_gelu, a_w, wf, fs2, fb2, kv, True), (torch._int_mm, a_w, wf.t()))

        # Attention, both modes. Vision is not causal (and once with seq_valid < L);
        # text is causal.
        b, seq, heads = s["batch"], s["seq"], s["heads"]
        causal = tag == "text"
        qkv = normal(b, seq, 3 * w, std=1.5, dtype=torch.bfloat16)
        scale_q = (w // heads) ** -0.5
        out_mul = 127.0 / 2.5
        valids = (None, 150) if tag == "vision" else (None,)
        for valid in valids:
            what = f"{tag} {'causal' if causal else 'full'}" + (f", seq_valid {valid}" if valid else "")
            checks.int8("attention_int8", what,
                        A.attention_int8(qkv, heads, scale_q, causal, out_mul, valid),
                        A.attention_int8_plain(qkv, heads, scale_q, causal, out_mul, valid))
        checks.float("fused_attention_qkv", f"{tag} {'causal' if causal else 'full'}",
                     A.fused_attention_qkv(qkv, heads, scale_q, causal),
                     A.attention_core_plain(qkv.float(), heads, scale_q, causal))
        for name, fn in (("attention_int8", lambda: A.attention_int8(qkv, heads, scale_q, causal,
                                                                     out_mul, valids[-1])),
                         ("fused_attention_qkv", lambda: A.fused_attention_qkv(qkv, heads, scale_q,
                                                                               causal)),
                         ("attention_block", lambda: A.attention_block(qkv, heads, scale_q,
                                                                       causal))):
            require(torch.equal(fn(), fn()), f"{name} {tag}: two launches differ")
        print(f"  attention_int8, fused_attention_qkv, attention_block {tag}: two launches "
              f"bit-identical")
        if timed:
            ops = 4 * b * heads * seq * seq * (w // heads)
            times["attention_int8"] = timing(
                cuda_ms(lambda: A.attention_int8(qkv, heads, scale_q, causal, out_mul)),
                cuda_ms(lambda: A.attention_int8_plain(qkv, heads, scale_q, causal, out_mul)),
                None, bound(b * seq * 3 * w * 2 + b * seq * w, ops, "bf16"),
                (A.attention_int8, qkv, heads, scale_q, causal, out_mul))
            q, k, v = heads_first(qkv, heads)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            times["fused_attention_qkv"] = timing(
                cuda_ms(lambda: A.fused_attention_qkv(qkv, heads, scale_q, causal)),
                cuda_ms(lambda: A.attention_core_plain(qkv, heads, scale_q, causal)),
                sdpa_ms(torch, q, k, v, scale_q),
                bound(b * seq * 3 * w * 2 + b * seq * w * 2, ops, "bf16"),
                (A.fused_attention_qkv, qkv, heads, scale_q, causal),
                (lambda q, k, v: sdpa(q, k, v, scale=scale_q), q, k, v))
            del q, k, v

    # The attention backward (K3b) at the training shapes, bf16 and fp32.
    name = "fused_attention_qkv_backward"
    for tag, s in (("vision", TRAIN_VISION), ("text", TRAIN_TEXT)):
        b, seq, w, heads = s["batch"], s["seq"], s["width"], s["heads"]
        causal = tag == "text"
        scale_q = (w // heads) ** -0.5
        qkv32, grad32 = normal(b, seq, 3 * w, std=1.5), normal(b, seq, w)
        for dtype in (torch.bfloat16, torch.float32):
            qkv, grad = qkv32.to(dtype), grad32.to(dtype)
            what = f"{tag} {b} x {seq} x {3 * w} {str(dtype)[6:]}{' causal' if causal else ''}"
            out = A.fused_attention_qkv_backward(qkv, grad, heads, scale_q, causal)
            checks.float(name, what, out, A.attention_backward_plain(
                qkv.float(), grad.float(), heads, scale_q, causal))
            again = A.fused_attention_qkv_backward(qkv, grad, heads, scale_q, causal)
            require(torch.equal(out, again), f"{name} {what}: two launches differ")
            print(f"  {name} {what}: two launches bit-identical")
            if dtype == torch.bfloat16:
                # Under causal only the pairs at or below the diagonal are computed.
                pairs = seq * (seq + 1) // 2 if causal else seq * seq
                library = sdpa_backward(torch, *heads_first(qkv, heads), scale_q, causal)
                timed = timing(
                    cuda_ms(lambda: A.fused_attention_qkv_backward(qkv, grad, heads, scale_q,
                                                                   causal)),
                    cuda_ms(lambda: A.attention_backward_plain(qkv, grad, heads, scale_q,
                                                               causal)),
                    cuda_ms(lambda: library[0](*library[1:])),
                    bound(b * seq * 3 * w * 2 * 2 + b * seq * w * 2,
                          10 * b * heads * pairs * (w // heads), "bf16"),
                    (A.fused_attention_qkv_backward, qkv, grad, heads, scale_q, causal), library)
                del library
                print(f"  {name} {what}: {timed['ms']:.4f} ms, plain {timed['plain_ms']:.4f} "
                      f"ms, bound {timed['bound_ms']:.4f} ms ({timed['bound_by']}), SDPA "
                      f"backward {timed['library_ms']:.4f} ms")
                if tag == "vision":
                    times[name] = timed
                else:  # the text tower's shape rides in the kernel's record
                    times[name]["text"] = dict(timed, shape=f"{b} x {seq} x {3 * w} causal")
            del out, again
    return times


def float_layer_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, the float layer (K2) and K8 at ViT-B/16 shapes: ln_cast on the
    32 x 197 x 768 rows, the bf16 GEMM's three epilogues at M = 6304 and (N, K) =
    (2304, 768), (768, 768), (3072, 768), (768, 3072), the block-mode attention
    at 32 x 197 (and with seq_valid) and 8 x 77 causal, K8 at 32 x 197. Each is
    held against its plain version in fp32 on the same inputs. Returns
    {name: timing(...)}."""
    import torch.nn.functional as F

    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K

    gen = torch.Generator(device="cuda").manual_seed(10)
    dev = "cuda"

    def normal(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    times = {}
    b, seq, w, heads = (VISION[k] for k in ("batch", "seq", "width", "heads"))
    m, d = b * seq, w // heads

    # ln_cast: the bf16 layer input and the fp32 mid-layer residual, eps 1e-6.
    gamma, beta = 1 + normal(w, std=0.1), normal(w, std=0.1)
    x_bf16 = normal(m, w, dtype=torch.bfloat16)
    for what, x in (("bf16 input", x_bf16), ("fp32 residual", normal(m, w, std=3.0))):
        checks.float("ln_cast", f"vision {what}", K.ln_cast(x, gamma, beta, torch.bfloat16, 1e-6),
                     K.layer_norm_plain(x, gamma, beta, 1e-6))

    # The bf16 GEMM: weights ~ N(0, 1/K), as LeCun-normal weights are.
    def weight(n, k):
        return normal(n, k, std=k ** -0.5, dtype=torch.bfloat16)

    wq, wo, wf, wp = weight(3 * w, w), weight(w, w), weight(4 * w, w), weight(w, 4 * w)
    qb, ob, fb, pb = (normal(n, std=0.1) for n in (3 * w, w, 4 * w, w))
    a_w, a_4w = normal(m, w, dtype=torch.bfloat16), normal(m, 4 * w, dtype=torch.bfloat16)
    out = K.bf16_gemm_bias(a_w, wq, qb)
    checks.float("bf16_gemm_bias", "vision qkv (6304 x 2304 x 768)", out,
                 K._dense_plain(a_w, wq, qb))
    require(torch.equal(out, K.bf16_gemm_bias(a_w, wq, qb)), "bf16_gemm_bias: two launches differ")
    print("  bf16_gemm_bias vision qkv: two launches bit-identical")
    qb16 = qb.bfloat16()
    times["bf16_gemm_bias"] = timing(
        cuda_ms(lambda: K.bf16_gemm_bias(a_w, wq, qb)),
        cuda_ms(lambda: K.bf16_gemm_bias_plain(a_w, wq, qb)),
        cuda_ms(lambda: torch.addmm(qb16, a_w, wq.t())),
        bound(m * w * 2 + 3 * w * w * 2 + 3 * w * 4 + m * 3 * w * 2, 2 * m * 3 * w * w, "bf16"),
        (K.bf16_gemm_bias, a_w, wq, qb), (torch.addmm, qb16, a_w, wq.t()))
    # The encode's QKV GEMM: 32 clips x 4 frames x 197 tokens (its own
    # generator, so that the checks after it keep their inputs).
    me = 4 * m
    a_e = torch.randn(me, w, device=dev, generator=torch.Generator(device=dev).manual_seed(14))
    a_e = a_e.to(torch.bfloat16)
    checks.float("bf16_gemm_bias", f"vision qkv at the encode's M = {me}",
                 K.bf16_gemm_bias(a_e, wq, qb), K._dense_plain(a_e, wq, qb))
    times["bf16_gemm_bias"]["encode"] = dict(timing(
        cuda_ms(lambda: K.bf16_gemm_bias(a_e, wq, qb)),
        cuda_ms(lambda: K.bf16_gemm_bias_plain(a_e, wq, qb), iters=5),
        cuda_ms(lambda: torch.addmm(qb16, a_e, wq.t())),
        bound(me * w * 2 + 3 * w * w * 2 + 3 * w * 4 + me * 3 * w * 2, 2 * me * 3 * w * w, "bf16")),
        shape=f"{me} x {3 * w} x {w}")
    print_row("bf16_gemm_bias", times["bf16_gemm_bias"]["encode"])
    del a_e
    out = K.bf16_gemm_residual(a_w, wo, ob, x_bf16, torch.float32)
    checks.float("bf16_gemm_residual", "vision out-proj (bf16 -> fp32)", out,
                 K.bf16_gemm_residual_plain(a_w, wo, ob, x_bf16, torch.float32))
    x32 = normal(m, w)
    checks.float("bf16_gemm_residual", "vision proj (fp32 -> bf16, K = 3072)",
                 K.bf16_gemm_residual(a_4w, wp, pb, x32, torch.bfloat16),
                 K.bf16_gemm_residual_plain(a_4w, wp, pb, x32, torch.float32))
    times["bf16_gemm_residual"] = timing(  # library: torch.mm, the product only
        cuda_ms(lambda: K.bf16_gemm_residual(a_4w, wp, pb, x32, torch.bfloat16)),
        cuda_ms(lambda: K.bf16_gemm_residual_plain(a_4w, wp, pb, x32, torch.bfloat16)),
        cuda_ms(lambda: torch.mm(a_4w, wp.t())),
        bound(m * 4 * w * 2 + 4 * w * w * 2 + w * 4 + m * w * 4 + m * w * 2, 2 * m * w * 4 * w,
              "bf16"),
        (K.bf16_gemm_residual, a_4w, wp, pb, x32, torch.bfloat16), (torch.mm, a_4w, wp.t()))
    for quick in (True, False):
        h = K._dense_plain(a_w, wf, fb)
        ref = h * torch.sigmoid(1.702 * h) if quick else K.exact_gelu_plain(h)
        checks.float("bf16_gemm_gelu", f"vision fc ({'quick' if quick else 'exact'} GELU)",
                      K.bf16_gemm_gelu(a_w, wf, fb, quick), ref)
        del h, ref
    times["bf16_gemm_gelu"] = timing(  # library: torch.mm, the product only
        cuda_ms(lambda: K.bf16_gemm_gelu(a_w, wf, fb, False)),
        cuda_ms(lambda: K.bf16_gemm_gelu_plain(a_w, wf, fb, False)),
        cuda_ms(lambda: torch.mm(a_w, wf.t())),
        bound(m * w * 2 + 4 * w * w * 2 + 4 * w * 4 + m * 4 * w * 2, 2 * m * 4 * w * w, "bf16"),
        (K.bf16_gemm_gelu, a_w, wf, fb, False), (torch.mm, a_w, wf.t()))
    del a_4w, x32

    # The block-mode attention: vision full (and with seq_valid), text causal.
    scale_q = d ** -0.5
    qkv = normal(b, seq, 3 * w, std=1.5, dtype=torch.bfloat16)
    for what, s, valid in (("vision full", VISION, None), ("vision full, seq_valid 150", VISION, 150),
                           ("text causal", TEXT, None)):
        causal = s is TEXT
        x = qkv if s is VISION else normal(s["batch"], s["seq"], 3 * s["width"], std=1.5,
                                           dtype=torch.bfloat16)
        checks.float("attention_block", what,
                     A.attention_block(x, s["heads"], scale_q, causal, valid),
                     A.attention_core_plain(x.float(), s["heads"], scale_q, causal, 1.0, valid))
    q, k, v = heads_first(qkv, heads)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times["attention_block"] = timing(
        cuda_ms(lambda: A.attention_block(qkv, heads, scale_q, False)),
        cuda_ms(lambda: A.attention_block_plain(qkv, heads, scale_q, False)),
        sdpa_ms(torch, q, k, v, scale_q),
        bound(b * seq * 3 * w * 2 + b * seq * w * 2, 4 * b * heads * seq * seq * d, "bf16"),
        (A.attention_block, qkv, heads, scale_q, False),
        (lambda q, k, v: sdpa(q, k, v, scale=scale_q), q, k, v))
    del q, k, v

    # K8: the int8 QKV projection and the attention, 32 x 197 x 768.
    x_q = torch.randint(-127, 128, (b, seq, w), generator=gen, device=dev, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (3 * w, w), generator=gen, device=dev, dtype=torch.int8)
    k8_scale = (torch.rand(3 * w, generator=gen, device=dev) + 0.5) * 1.5 / (73.0 * 73.0 * w ** 0.5)
    k8_bias = normal(3 * w, std=0.1)
    qkv_k8 = K.int8_gemm_bias_plain(x_q.view(m, w), w_q, k8_scale, k8_bias, torch.bfloat16)
    checks.float("fused_int8_qkv_attention", "vision 32 x 197 x 768",
                 A.fused_int8_qkv_attention(x_q, w_q, k8_scale, k8_bias, heads, scale_q),
                 A.attention_core_plain(qkv_k8.float().view(b, seq, 3 * w), heads, scale_q, False))
    times["fused_int8_qkv_attention"] = timing(
        cuda_ms(lambda: A.fused_int8_qkv_attention(x_q, w_q, k8_scale, k8_bias, heads, scale_q)),
        cuda_ms(lambda: A.fused_int8_qkv_attention_plain(x_q, w_q, k8_scale, k8_bias, heads,
                                                         scale_q)), None,
        bound(m * w + 3 * w * w + 3 * w * 8 + m * w * 2,
              {"int8": 2 * m * 3 * w * w, "bf16": 4 * b * heads * seq * seq * d}),
        (A.fused_int8_qkv_attention, x_q, w_q, k8_scale, k8_bias, heads, scale_q))
    return times


# The LayerNorm kernel (csrc/ln_quant.cu) by its __global__ name, and the names
# of the kernels this tree's row passes replaced, which no profile may show.
LN_KERNEL = "ln_rows_kernel"
OLD_ROW_PASSES = ("::ln_kernel<", "::amax_kernel(")
ENCODE_ROWS = 4 * VISION["batch"] * VISION["seq"]  # 32 clips x 4 frames x 197


def ln_rows(torch, K, m, w, dtype, gen, inv):
    """The LayerNorm rows of one phase-3 case: x (the layer input in bf16 or
    the fp32 residual), gamma and beta; each mode's (kernel, plain) pair."""
    from fitclip_torch.bench import kernels as P

    x = (3.0 * torch.randn(m, w, generator=gen, device="cuda") + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(w, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(w, generator=gen, device="cuda")
    modes = {"ln_quant": (lambda t: K.ln_quant(t, gamma, beta, inv),
                          lambda t: K.ln_quant_plain(t, gamma, beta, inv)),
             "ln_cast": (lambda t: K.ln_cast(t, gamma, beta, torch.bfloat16),
                         lambda t: K.layer_norm_plain(t, gamma, beta))}
    for mode in ("one", "fold", "cast"):
        wrapper = getattr(P, f"ln_quant_{mode}")
        modes[f"ln_quant_{mode}"] = (
            lambda t, wrapper=wrapper: wrapper(t, gamma, beta, inv),
            lambda t, mode=mode: P.ln_quant_variant_plain(t, gamma, beta, inv, K.LN_EPS, mode))
    return x, gamma, beta, modes


def ln_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, the LayerNorm kernel (csrc/ln_quant.cu's ln_rows_kernel) in
    every mode (K1's ln_quant, K2's ln_cast, S1's one, fold and cast) on bf16
    layer inputs and fp32 residuals at the vision rows (M = 6304), the
    encode's (M = 25,216: 32 clips x 4 frames x 197) and widths 384 (ViT-S/16,
    6304 rows) and 512 (text, 616 rows), under the int8 or float rule, with two
    launches giving the same bits. Times ln_quant and ln_cast at M = 6304 and
    25,216 from both input dtypes: the events' ms at M = 6304 from bf16 (the
    record's row, as before) and everywhere device_ms, the kernel's own device
    time with a cold L2, beside F.layer_norm's (ln_cast; bf16 weights for a
    bf16 input). Returns {name: timing(...)}, the other sizes under "sizes"."""
    import torch.nn.functional as F

    from fitclip_torch.ops import block as K

    gen = torch.Generator(device="cuda").manual_seed(15)
    inv = 127.0 / 4.0
    times = {}
    for m, w in ((VISION["batch"] * VISION["seq"], 768), (ENCODE_ROWS, 768),
                 (VISION["batch"] * VISION["seq"], 384), (TEXT["batch"] * TEXT["seq"], 512)):
        for dtype in (torch.bfloat16, torch.float32):
            x, gamma, beta, modes = ln_rows(torch, K, m, w, dtype, gen, inv)
            what = f"{m} x {w} {str(dtype)[6:]}"
            for name, (kernel, plain) in modes.items():
                out = kernel(x)
                if name == "ln_cast":
                    checks.float(name, what, out, plain(x))
                else:
                    checks.int8(name, what, out, plain(x))
                require(torch.equal(out, kernel(x)), f"{name} {what}: two launches differ")
            print(f"  {', '.join(modes)} {what}: two launches bit-identical")
            if w != 768:
                continue
            in_bytes = m * w * x.element_size()
            for name in ("ln_quant", "ln_cast"):
                out_bytes = m * w * (1 if name == "ln_quant" else 2)
                row = {"shape": what, **timing(
                    cuda_ms(lambda: modes[name][0](x)), cuda_ms(lambda: modes[name][1](x)),
                    None, bound(in_bytes + out_bytes + 2 * w * 4, 9 * m * w, "fp32"))}
                if name == "ln_quant":
                    row["device_ms"] = device_ms(K.ln_quant, x, gamma, beta, inv)
                    row["library_device_ms"] = None
                else:
                    # F.layer_norm: bf16 weights for a bf16 input (its output bf16);
                    # fp32 in, fp32 out for the residual (twice ln_cast's output bytes).
                    g, b = (gamma, beta) if dtype == torch.float32 else (gamma.bfloat16(),
                                                                        beta.bfloat16())
                    row["library_ms"] = cuda_ms(lambda: F.layer_norm(x, (w,), g, b, K.LN_EPS))
                    row["device_ms"] = device_ms(K.ln_cast, x, gamma, beta, torch.bfloat16)
                    row["library_device_ms"] = device_ms(F.layer_norm, x, (w,), g, b, K.LN_EPS)
                print(f"  {name} {what}: device {row['device_ms']:.4f} ms (events "
                      f"{row['ms']:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                      f"library device {row['library_device_ms'] or float('nan'):.4f} ms")
                if m == VISION["batch"] * VISION["seq"] and dtype == torch.bfloat16:
                    times[name] = dict(row, sizes=[])
                else:
                    times[name]["sizes"].append(row)
            if m == VISION["batch"] * VISION["seq"] and dtype == torch.bfloat16:
                # The helper's two readings of one row: the profiler's and a CUDA graph's.
                by_graph = device_ms(K.ln_quant, x, gamma, beta, inv, graph=True)
                print(f"  device_ms of ln_quant {what}: profiler {times['ln_quant']['device_ms']:.4f}"
                      f" ms, CUDA graph {by_graph:.4f} ms")
            del x, modes
    return times


# The FiT kernels' __global__ bodies (csrc/fit_attention.cu) and the ones they
# replaced, which no profile may show.
SPACE_F32 = "space_f32_kernel"
TIME_ROWS = "time_rows_kernel"
CLS_ROWS = "cls_rows_kernel"
OLD_FIT_ATTENTION = ("::space_kernel_f32<", "::time_kernel<", "::cls_kernel<")
# The S3D-G stem's __global__ body (csrc/s3dg_stem.cu) and the one it replaced.
STEM_BODY = "s3dg_stem_wgmma_kernel"
OLD_STEM = ("::s3dg_stem_kernel<",)


def fit_kernel_phase(torch, checks: KernelChecks, A):
    """Phase 3, Frozen-in-Time: csrc/fit_attention.cu of the package ``A``
    belongs to against its plain versions at FiT base shapes: K4's three
    int8-mode cores on the joint (32, 785, 2304) bf16 qkv and its space core on
    the same qkv in fp32, K5 on 128 frame groups of 196 rows (bf16 and fp32),
    K6 on (32, 784, 2304) (bf16 and fp32), and the time kernel's frame tiers
    at F = 1, 8 and 16 (8 clips of F x 196 rows, bf16 and fp32 and int8 out);
    each launched twice for bit-identity. Each FiT base row is timed by events
    and by device time (cold L2) beside its plain version, bound and SDPA
    (none for the int8 cores). Returns {name: timing(...)}, the fp32 rows
    nested under "fp32"."""
    from fitclip_torch.ops.quant import quantize_rint

    gen = torch.Generator(device="cuda").manual_seed(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, f, p, w, heads = (FIT[k] for k in ("clips", "frames", "patches", "width", "heads"))
    d, n = w // heads, 1 + f * p
    scale, out_mul = d ** -0.5, 127.0 / 2.5
    print(f"clocks (phase 3, FiT attention): {clocks()}")

    def normal(*shape):
        return (1.5 * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)

    def twice(name, what, fn):
        out = fn()
        require(torch.equal(out, fn()), f"{name} {what}: two launches differ")
        print(f"  {name} {what}: two launches bit-identical")
        return out

    def row(fn, args, plain, library, bound_pair, plain_iters=20, **extra):
        """timing() of fn(*args), its plain version and the library call
        (fn, *args) with device times; extra keys (shape, kernel) added."""
        entry = timing(cuda_ms(lambda: fn(*args)), cuda_ms(plain, iters=plain_iters),
                       None if library is None else cuda_ms(lambda: library[0](*library[1:])),
                       bound_pair, (fn, *args), library, device=True)
        return dict(entry, **extra)

    def sdpa_call(q, k, v):
        return (lambda q, k, v: sdpa(q, k, v, scale=scale), q.contiguous(), k.contiguous(),
                v.contiguous())

    times = {}
    qkv = normal(b, n, 3 * w)
    rows_in = b * n * 3 * w * 2
    what = f"{b} x {n} x {3 * w} bf16"
    times["fit_cls_attention_int8"] = cls_row(torch, checks, A, qkv)
    for mode, keys in (("time", f + 1), ("space", p + 1)):
        name = f"fit_{mode}_attention_int8"
        wrapper = getattr(A, name)
        out = twice(name, what, lambda: wrapper(qkv, heads, f, out_mul))
        checks.int8(name, what, out[:, 1:],
                    quantize_rint(A.fit_rows_attention_int8_plain(qkv, heads, f, mode, out_mul)))
        times[name] = row(
            wrapper, (qkv, heads, f, out_mul, out),
            lambda: A.fit_rows_attention_int8_plain(qkv, heads, f, mode, out_mul), None,
            bound(rows_in + b * (n - 1) * w, 4 * b * f * p * heads * keys * d, "bf16"),
            kernel=TIME_ROWS if mode == "time" else "space_mma_kernel")
    # K4's CLS row on an fp32 qkv (timed), and its space core (the fp32 space
    # kernel's int8 mode), checked only.
    qkv = qkv.float()
    times["fit_cls_attention_int8"]["fp32"] = cls_row(torch, checks, A, qkv)
    print_row("fit_cls_attention_int8", times["fit_cls_attention_int8"]["fp32"])
    what = f"{b} x {n} x {3 * w} fp32"
    out = twice("fit_space_attention_int8", what,
                lambda: A.fit_space_attention_int8(qkv, heads, f, out_mul))
    checks.int8("fit_space_attention_int8", what, out[:, 1:],
                quantize_rint(A.fit_rows_attention_int8_plain(qkv, heads, f, "space", out_mul)))
    del qkv, out

    # K5: 128 frame groups of 196 rows and a global row each, bf16 then fp32.
    groups = normal(b * f, p, 3 * w)
    gkv = normal(b * f, 3 * w)
    for dtype, kind, kernel in (("bf16", "bf16", "space_mma_kernel"), ("fp32", "fp32", SPACE_F32)):
        if dtype == "fp32":
            groups, gkv = groups.float(), gkv.float()
        what = f"{b * f} x {p} x {3 * w} + gkv {dtype}"
        out = twice("fused_attention_qkv_gkv", what,
                    lambda: A.fused_attention_qkv_gkv(groups, gkv, heads, scale))
        checks.float("fused_attention_qkv_gkv", what, out,
                     A.attention_gkv_plain(groups.float(), gkv.float(), heads, scale))
        del out
        q, k, v = heads_first(groups, heads)
        g_k, g_v = (t.reshape(b * f, heads, 1, d) for t in gkv.split(w, dim=-1)[1:])
        size = groups.element_size()
        entry = row(A.fused_attention_qkv_gkv, (groups, gkv, heads, scale),
                    lambda: A.attention_gkv_plain(groups, gkv, heads, scale),
                    sdpa_call(q, torch.cat([g_k, k], 2), torch.cat([g_v, v], 2)),
                    bound(b * f * (p + 1) * 3 * w * size + b * f * p * w * size,
                          4 * b * f * heads * p * (p + 1) * d, kind),
                    plain_iters=20 if dtype == "bf16" else 5, shape=what, kernel=kernel)
        if dtype == "bf16":
            times["fused_attention_qkv_gkv"] = entry
        else:
            times["fused_attention_qkv_gkv"]["fp32"] = entry
            print_row("fused_attention_qkv_gkv", entry)
        del q, k, v, g_k, g_v
    del groups, gkv

    # K6: 32 clips of 4 x 196 rows and their CLS rows, bf16 then fp32.
    rows = normal(b, f * p, 3 * w)
    gkv = normal(b, 3 * w)
    for dtype, kind in (("bf16", "bf16"), ("fp32", "fp32")):
        if dtype == "fp32":
            rows, gkv = rows.float(), gkv.float()
        what = f"{b} x {f * p} x {3 * w} + gkv {dtype}"
        out = twice("fused_time_attention", what,
                    lambda: A.fused_time_attention(rows, gkv, heads, f, scale))
        checks.float("fused_time_attention", what, out,
                     A.time_attention_plain(rows.float(), gkv.float(), heads, f, scale))
        del out
        # The same function as SDPA: per (clip, location), F queries over [CLS | F frames].
        q, k, v = (t.reshape(b, f, p, heads, d).permute(0, 2, 3, 1, 4).reshape(b * p, heads, f, d)
                   for t in rows.split(w, dim=-1))
        g_k, g_v = (t.reshape(b, 1, heads, 1, d).expand(b, p, heads, 1, d)
                    .reshape(b * p, heads, 1, d) for t in gkv.split(w, dim=-1)[1:])
        size = rows.element_size()
        entry = row(A.fused_time_attention, (rows, gkv, heads, f, scale),
                    lambda: A.time_attention_plain(rows, gkv, heads, f, scale),
                    sdpa_call(q, torch.cat([g_k, k], 2), torch.cat([g_v, v], 2)),
                    bound(b * (f * p + 1) * 3 * w * size + b * f * p * w * size,
                          4 * b * p * heads * f * (f + 1) * d, kind),
                    plain_iters=20 if dtype == "bf16" else 5, shape=what,
                    kernel=f"{TIME_ROWS}<{'__nv_bfloat16' if dtype == 'bf16' else 'float'}>")
        if dtype == "bf16":
            times["fused_time_attention"] = entry
        else:
            times["fused_time_attention"]["fp32"] = entry
            print_row("fused_time_attention", entry)
        del q, k, v, g_k, g_v
    del rows, gkv

    # The time kernel's frame tiers (F <= 4, 8, 16) at F = 1, 8 and 16, 8 clips.
    for frames in (1, 8, 16):
        joint = normal(8, 1 + frames * p, 3 * w)
        what = f"8 x {1 + frames * p} x {3 * w} bf16, F = {frames}"
        out = twice("fit_time_attention_int8", what,
                    lambda: A.fit_time_attention_int8(joint, heads, frames, out_mul))
        checks.int8("fit_time_attention_int8", what, out[:, 1:], quantize_rint(
            A.fit_rows_attention_int8_plain(joint, heads, frames, "time", out_mul)))
        for dtype in (torch.bfloat16, torch.float32):
            rows, gkv = joint[:, 1:].to(dtype).contiguous(), joint[:, 0].to(dtype).contiguous()
            what = f"8 x {frames * p} x {3 * w} + gkv {str(dtype)[6:]}, F = {frames}"
            out = twice("fused_time_attention", what,
                        lambda: A.fused_time_attention(rows, gkv, heads, frames, scale))
            checks.float("fused_time_attention", what, out,
                         A.time_attention_plain(rows.float(), gkv.float(), heads, frames, scale))
        del joint, rows, gkv, out
    return times


def cls_row(torch, checks: KernelChecks, A, qkv):
    """K4's CLS row (fit_cls_attention_int8, cls_rows_kernel) on the joint FiT
    base qkv (bf16 or fp32) of the package ``A`` belongs to: held to its plain
    version under the int8 rule, two launches bit-identical, and timed by
    events and device time (cold L2) beside its plain version and bound (no
    library call writes int8). Returns its timing() row."""
    from fitclip_torch.ops.quant import quantize_rint

    b, n, triple = qkv.shape
    w, heads = triple // 3, FIT["heads"]
    d, size = w // heads, qkv.element_size()
    scale, out_mul = d ** -0.5, 127.0 / 2.5
    what = f"{b} x {n} x {triple} {'bf16' if size == 2 else 'fp32'}"
    out = A.fit_cls_attention_int8(qkv, heads, out_mul)
    require(torch.equal(out, A.fit_cls_attention_int8(qkv, heads, out_mul)),
            f"fit_cls_attention_int8 {what}: two launches differ")
    print(f"  fit_cls_attention_int8 {what}: two launches bit-identical")
    checks.int8("fit_cls_attention_int8", what, out[:, :1],
                quantize_rint(A.cls_attention_plain(qkv, heads, scale, out_mul)))
    entry = timing(cuda_ms(lambda: A.fit_cls_attention_int8(qkv, heads, out_mul, out)),
                   cuda_ms(lambda: A.cls_attention_plain(qkv, heads, scale, out_mul)), None,
                   bound(b * (w + n * 2 * w) * size + b * w, 4 * b * heads * n * d,
                         "bf16" if size == 2 else "fp32"),
                   (A.fit_cls_attention_int8, qkv, heads, out_mul, out), device=True)
    return dict(entry, shape=what, kernel=CLS_ROWS)


def s3dg_kernel_phase(torch, checks: KernelChecks, S=None):
    """Phase 3, S3D-G: the stem kernel (K7) against its plain version at the MIL-NCE
    shape, 32 clips x 16 frames of 224^2 bf16, launched twice for bit-identity.
    Returns {name: timing(...)}, timed by events and by the stem kernel's own
    device time (the 154 MB input exceeds L2); no single PyTorch call computes
    conv + ReLU + pool, so the library time is null (cuDNN's bf16 conv3d alone
    is printed beside it). ``S`` is the ops.s3dg_stem module to run (another
    tree's in --stem-cls); the weights are packed once where it can keep them."""
    import torch.nn.functional as F

    if S is None:
        from fitclip_torch.ops import s3dg_stem as S

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, t, size = MIL_NCE["clips"], MIL_NCE["frames"], MIL_NCE["size"]
    x = torch.rand(b, t, size, size, 3, generator=gen, device="cuda").to(torch.bfloat16)
    kernel = (0.05 * torch.randn(2, 4, 4, 24, 64, generator=gen, device="cuda")).to(torch.bfloat16)
    bias = (0.1 * torch.randn(64, generator=gen, device="cuda")).to(torch.bfloat16)
    kept = {"packed": S.stem_operands(kernel, bias)} if hasattr(S, "stem_operands") else {}

    def stem(x, kernel, bias):
        return S.s3dg_stem(x, kernel, bias, **kept)

    what = f"{b} x {t} x {size}^2 bf16"
    out = stem(x, kernel, bias)
    require(torch.equal(out, stem(x, kernel, bias)), f"s3dg_stem {what}: two launches differ")
    print(f"  s3dg_stem {what}: two launches bit-identical")
    checks.bf16_ulp("s3dg_stem", what, out, S.s3dg_stem_plain(x.float(), kernel, bias))
    del out
    positions = b * (t // 2) * (size // 2) ** 2
    times = {"s3dg_stem": timing(
        cuda_ms(lambda: stem(x, kernel, bias)),
        cuda_ms(lambda: S.s3dg_stem_plain(x, kernel, bias), iters=5), None,
        bound(x.numel() * 2 + positions // 4 * 64 * 2 + 768 * 64 * 2 + 64 * 4,
              2 * positions * 768 * 64, "bf16"),
        (stem, x, kernel, bias), device=True, only="s3dg_stem")}
    times["s3dg_stem"].update(shape=what, kernel=STEM_BODY)
    s = S.space_to_depth(x).contiguous().permute(0, 4, 1, 2, 3)
    weight = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    conv_ms = cuda_ms(lambda: F.conv3d(s, weight, padding=(1, 2, 2)), iters=10)
    print(f"  s3dg_stem: for information, cuDNN's bf16 conv3d alone (no bias, ReLU or pool, "
          f"unpooled output) {conv_ms:.4f} ms")
    return times


def fault_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, the repaired shapes: the fp32 attention at L = 577 (ViT-L/14@336;
    the function's gradient runs through both kernels), bf16 past 208 keys
    (the forward's and the backward rows kernel's sweep) and past 848 (the
    backward's global body), and every attention mode and the backward at
    head_dim 32 (SLIP ViT-S/16: 32 x 197 x 384, 6 heads)."""
    from fitclip_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(11)
    bwd_gen = torch.Generator(device="cuda").manual_seed(13)
    b, seq, heads, d = 2, 577, 16, 64
    qkv = (1.5 * torch.randn(b, seq, 3 * heads * d, generator=gen, device="cuda"))
    scale, out_mul = d ** -0.5, 127.0 / 2.5
    what = f"fp32 {b} x {seq} x {3 * heads * d}"
    checks.float("fused_attention_qkv", what, A.fused_attention_qkv(qkv, heads, scale),
                 A.attention_core_plain(qkv, heads, scale, False))
    checks.int8("attention_int8", what, A.attention_int8(qkv, heads, scale, False, out_mul),
                A.attention_int8_plain(qkv, heads, scale, False, out_mul))
    leaf = qkv.clone().requires_grad_()
    grad = torch.randn(b, seq, heads * d, generator=gen, device="cuda")
    before = A.fused_attention_qkv_backward.launches
    with torch.enable_grad():
        A.fused_attention_qkv(leaf, heads, scale).backward(grad)
    launched = A.fused_attention_qkv_backward.launches - before
    require(launched == 1, f"fp32 L = 577 backward: {launched} kernel launches, not 1")
    checks.float("fused_attention_qkv_backward", f"{what}: through the function", leaf.grad,
                 A.attention_backward_plain(qkv, grad, heads, scale, False))
    again = A.fused_attention_qkv_backward(qkv, grad, heads, scale)
    require(torch.equal(again, leaf.grad), "fp32 L = 577 backward: two launches differ")
    print(f"  fused_attention_qkv_backward: fp32 L = 577 on the {A.backward_body(qkv.dtype, seq, d)} "
          f"body, {launched} launch through the function, two launches bit-identical")

    # bf16 past 208 keys: the mma sweep (ViT-L/14's 257, ViT-L/14@336's 577), also
    # causal with seq_valid, under the float and int8 rules.
    for b, seq in ((8, 257), (4, 577)):
        qkv = (1.5 * torch.randn(b, seq, 3 * 16 * 64, generator=gen, device="cuda")).to(
            torch.bfloat16)
        for causal, valid in ((False, None), (True, seq - 57)):
            tag = (f"bf16 {b} x {seq} x {3 * 16 * 64}{' causal' if causal else ''}"
                   f"{f', seq_valid {valid}' if valid else ''} (mma sweep)")
            checks.int8("attention_int8", tag,
                        A.attention_int8(qkv, 16, scale, causal, out_mul, valid),
                        A.attention_int8_plain(qkv, 16, scale, causal, out_mul, valid))
            checks.float("fused_attention_qkv", tag, A.fused_attention_qkv(qkv, 16, scale, causal),
                         A.attention_core_plain(qkv.float(), 16, scale, causal))
            out = A.attention_block(qkv, 16, scale, causal, valid)
            checks.float("attention_block", tag, out,
                         A.attention_core_plain(qkv.float(), 16, scale, causal, 1.0, valid))
            require(torch.equal(out, A.attention_block(qkv, 16, scale, causal, valid)),
                    f"attention_block {tag}: two launches differ")
            # The backward's rows kernel sweeps here too (no seq_valid in training);
            # its inputs come from a generator of their own.
            tag = f"bf16 {b} x {seq} x {3 * 16 * 64}{' causal' if causal else ''} (rows sweep)"
            grad = torch.randn(b, seq, 16 * 64, generator=bwd_gen, device="cuda").to(
                torch.bfloat16)
            out = A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)
            checks.float("fused_attention_qkv_backward", tag, out, A.attention_backward_plain(
                qkv.float(), grad.float(), 16, scale, causal))
            require(torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)),
                    f"fused_attention_qkv_backward {tag}: two launches differ")
    # bf16 past 848 keys: the backward's global body (V and g through L2).
    b, seq = 1, 900
    require(A.backward_body(torch.bfloat16, seq, 64) == "mma_global",
            f"bf16 L = {seq}: not on the backward's global body")
    qkv = (1.5 * torch.randn(b, seq, 3 * 16 * 64, generator=bwd_gen, device="cuda")).to(
        torch.bfloat16)
    grad = torch.randn(b, seq, 16 * 64, generator=bwd_gen, device="cuda").to(torch.bfloat16)
    for causal in (False, True):
        tag = f"bf16 {b} x {seq} x {3 * 16 * 64}{' causal' if causal else ''} (V and g through L2)"
        out = A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)
        checks.float("fused_attention_qkv_backward", tag, out, A.attention_backward_plain(
            qkv.float(), grad.float(), 16, scale, causal))
        require(torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)),
                f"fused_attention_qkv_backward {tag}: two launches differ")

    b, seq, heads, d = 32, 197, 6, 32
    what = f"head_dim 32, {b} x {seq} x {3 * heads * d}"
    for dtype in (torch.bfloat16, torch.float32):
        qkv = (1.5 * torch.randn(b, seq, 3 * heads * d, generator=gen, device="cuda")).to(dtype)
        tag = f"{what} {str(dtype)[6:]}"
        checks.float("fused_attention_qkv", tag, A.fused_attention_qkv(qkv, heads, d ** -0.5),
                     A.attention_core_plain(qkv.float(), heads, d ** -0.5, False))
        checks.float("attention_block", tag, A.attention_block(qkv, heads, d ** -0.5, False),
                     A.attention_core_plain(qkv.float(), heads, d ** -0.5, False, 1.0))
        checks.int8("attention_int8", tag, A.attention_int8(qkv, heads, d ** -0.5, False, out_mul),
                    A.attention_int8_plain(qkv, heads, d ** -0.5, False, out_mul))
        grad = torch.randn(b, seq, heads * d, generator=gen, device="cuda").to(dtype)
        # The plain version with the kernel's casts on the same inputs: the scale
        # 32^-1/2 magnifies the bf16 rounding of dL against an fp32 reference.
        checks.float("fused_attention_qkv_backward", tag,
                     A.fused_attention_qkv_backward(qkv, grad, heads, d ** -0.5),
                     A.attention_backward_plain(qkv, grad, heads, d ** -0.5, False).float())


# The fp32 attention (the configs' default dtype) on phase 3's rows and under
# --fp32-attention: (tag, batch, L, width, heads, causal) of the forward (one
# vision layer of the fp32 encode and step, 32 clips x 4 frames; 32 frames; the
# encode's text batch; ViT-L/14@336) and of the backward (the step's vision and
# text batches, ViT-L/14@336).
F32_FORWARD_SHAPES = (("vision", 128, 197, 768, 12, False), ("vision32", 32, 197, 768, 12, False),
                      ("text", 256, 77, 512, 8, True), ("L577", 2, 577, 1024, 16, False))
F32_BACKWARD_SHAPES = (("vision", 128, 197, 768, 12, False), ("text", 32, 77, 512, 8, True),
                       ("L577", 2, 577, 1024, 16, False))


def f32_attention_phase(torch, checks: KernelChecks, A):
    """Phase 3, the fp32 attention kernels of the package ``A`` belongs to (K3f's
    forward in the qkv, int8 and block modes; K3b's backward): each held to its
    plain version in fp32 (int8 under the int8 rule), two launches bit-identical,
    then timed beside the plain version, the bound (fp32 operations at 67
    TFLOP/s; causal counts the pairs at or below the diagonal) and SDPA's fp32
    call with TF32 off (none for the int8 mode), with device time for the text
    rows and any row that reads under 0.1 ms. Returns {"attention_f32": row, "attention_bwd_f32":
    row}: the first shape's qkv mode and backward, the others nested under
    their tags."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(f"clocks (phase 3, fp32 attention): {clocks()}")
    out_mul, rows = 127.0 / 2.5, {}
    for tag, b, seq, w, heads, causal in F32_FORWARD_SHAPES:
        d = w // heads
        scale = d ** -0.5
        qkv = 1.5 * torch.randn(b, seq, 3 * w, generator=gen, device="cuda")
        what = f"fp32 {b} x {seq} x {3 * w}{' causal' if causal else ''}"
        runs = {"qkv": (A.fused_attention_qkv, (qkv, heads, scale, causal),
                        lambda: A.attention_core_plain(qkv, heads, scale, causal)),
                "int8": (A.attention_int8, (qkv, heads, scale, causal, out_mul),
                         lambda: A.attention_int8_plain(qkv, heads, scale, causal, out_mul)),
                "block": (A.attention_block, (qkv, heads, scale, causal),
                          lambda: A.attention_core_plain(qkv, heads, scale, causal, 1.0))}
        for mode, (fn, args, plain) in runs.items():
            out = fn(*args)
            if mode == "int8":
                checks.int8("attention_f32", f"{what} int8 mode", out, plain())
            else:
                checks.float("attention_f32", f"{what} {mode} mode", out, plain())
            require(torch.equal(out, fn(*args)), f"{what} {mode} mode: two launches differ")
            del out
        print(f"  attention_f32 {what}: two launches bit-identical in every mode")
        pairs = seq * (seq + 1) // 2 if causal else seq * seq
        q, k, v = heads_first(qkv, heads)
        for mode in ("qkv", "int8") if tag.startswith("vision") else ("qkv",):
            fn, args, plain = runs[mode]
            library = None if mode == "int8" else (
                lambda q, k, v: sdpa(q, k, v, scale=scale, is_causal=causal), q, k, v)
            row = dict(timing(
                cuda_ms(lambda: fn(*args)), cuda_ms(plain, iters=5),
                None if library is None else cuda_ms(lambda: library[0](*library[1:])),
                bound(b * seq * 3 * w * 4 + b * seq * w * (1 if mode == "int8" else 4),
                      4 * b * heads * pairs * d, "fp32"), (fn, *args), library,
                device=tag == "text"),
                shape=f"{what}, {mode} mode", kernel=F32_FORWARD,
                body=A.attention_body(qkv.dtype, seq, d))
            print_row(f"attention_f32 ({row['body']})", row)
            rows[f"{tag} {mode}"] = row
        del qkv, q, k, v
    forward = rows.pop("vision qkv")
    forward.update(rows)
    rows = {}
    for tag, b, seq, w, heads, causal in F32_BACKWARD_SHAPES:
        d = w // heads
        scale = d ** -0.5
        qkv = 1.5 * torch.randn(b, seq, 3 * w, generator=gen, device="cuda")
        grad = torch.randn(b, seq, w, generator=gen, device="cuda")
        what = f"fp32 {b} x {seq} x {3 * w}{' causal' if causal else ''}"
        out = A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal)
        checks.float("attention_bwd_f32", what, out,
                     A.attention_backward_plain(qkv, grad, heads, scale, causal))
        require(torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal)),
                f"attention_bwd_f32 {what}: two launches differ")
        print(f"  attention_bwd_f32 {what}: two launches bit-identical")
        del out
        pairs = seq * (seq + 1) // 2 if causal else seq * seq
        library = sdpa_backward(torch, *heads_first(qkv, heads), scale, causal)
        rows[tag] = dict(timing(
            cuda_ms(lambda: A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal),
                    iters=10),
            cuda_ms(lambda: A.attention_backward_plain(qkv, grad, heads, scale, causal), iters=5),
            cuda_ms(lambda: library[0](*library[1:])),
            bound(b * seq * 3 * w * 4 * 2 + b * seq * w * 4, 10 * b * heads * pairs * d, "fp32"),
            (A.fused_attention_qkv_backward, qkv, grad, heads, scale, causal), library,
            device=tag == "text"),
            shape=what, kernel="+".join(F32_BACKWARD), body=A.backward_body(qkv.dtype, seq, d))
        print_row(f"attention_bwd_f32 ({rows[tag]['body']})", rows[tag])
        del qkv, grad, library
    backward = rows.pop("vision")
    backward.update(rows)
    return {"attention_f32": forward, "attention_bwd_f32": backward}


# The ablation benches (fitclip_torch/bench): each new kernel, the TPU kernel
# it replaces (the pallas_call of the script's arm) and its source.
S1_SITE = "scripts/bench_block_layer.py:545"
BENCH_KERNELS = {
    **{f"ln_quant_{m}": (S1_SITE, "csrc/ln_quant.cu") for m in ("one", "fold", "cast")},
    **{f"attention_{m}": (S1_SITE, "csrc/attention.cu")
       for m in ("div", "fold2", "sm2", "sm2div", "nomax", "cast")},
    **{f"int8_gemm_{m}": (S1_SITE, "csrc/int8_gemm.cu")
       for m in ("sigmoid", "bf16", "fold", "fold16", "sigmoid_cast")},
    # S1s: `full`'s kernels on two CUDA streams (no kernel of its own).
    "block_layer_skew": ("scripts/bench_block_layer.py:149", "bench/block_layer.py"),
    **{f"attention_{m}": ("scripts/bench_attn_int8.py:200", "csrc/attention.cu")
       for m in ("head0", "bf16logits", "nosoftmax")},
    **{m: ("scripts/bench_attn_int8.py:200", "csrc/bench_arms.cu")
       for m in ("attn_amax", "attention_i8qk", "attention_i8qkav")},
    "slice_requant": ("scripts/bench_fit_block.py:159", "csrc/bench_arms.cu"),
}


def bench_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, the bench kernels at the benches' production shapes: S1's
    pieces on 512 frames x 197 x 768 (M = 100,864 rows), S2's on 512 x 197 x
    2304 bf16 (its s8 attention also at 8 x 257), slice-requant on S3's 32 x
    785 x 2304 in bf16 and fp32. Returns {name: timing}."""
    from fitclip_torch.bench import attn_int8 as S2
    from fitclip_torch.bench import kernels as P
    from fitclip_torch.ops import block as K

    gen = torch.Generator(device="cuda").manual_seed(12)
    frames, seq, w, heads = S2.FRAMES, S2.SEQ, S2.WIDTH, S2.HEADS
    m, d = frames * seq, w // heads
    times = {}

    def rand_int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    # S1's LN prologues on the bf16 layer input.
    x = torch.randn(m, w, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(w, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(w, generator=gen, device="cuda")
    inv = 127.0 / 4.0
    for mode in ("one", "fold", "cast"):
        name = f"ln_quant_{mode}"
        wrapper = getattr(P, name)
        checks.int8(name, f"{m} x {w} bf16", wrapper(x, gamma, beta, inv),
                    P.ln_quant_variant_plain(x, gamma, beta, inv, K.LN_EPS, mode))
        times[name] = timing(
            cuda_ms(lambda: wrapper(x, gamma, beta, inv)),
            cuda_ms(lambda: P.ln_quant_variant_plain(x, gamma, beta, inv, K.LN_EPS, mode), iters=5),
            None, bound(m * w * 2 + m * w + 2 * w * 4, 9 * m * w, "fp32"),
            (wrapper, x, gamma, beta, inv), device=True)
    del x

    # S1's fc epilogues at (M, 4W, W).
    a, wf = rand_int8(m, w), rand_int8(4 * w, w)
    unit = (torch.rand(4 * w, generator=gen, device="cuda") + 0.5) / (73.0 * 73.0 * w ** 0.5)
    folded = (unit * 20.0, 2.0 * torch.randn(4 * w, generator=gen, device="cuda"),
              -1.702 * K.LOG2E / (127.0 / 6.0))
    unfolded = (unit, 0.1 * torch.randn(4 * w, generator=gen, device="cuda"), 127.0 / 6.0)
    for act in ("sigmoid", "bf16", "fold", "fold16", "sigmoid_cast"):
        name = f"int8_gemm_{act}"
        wrapper = getattr(P, name)
        scale, bias, kv = folded if act in ("fold", "fold16") else unfolded
        checks.int8(name, f"{m} x {4 * w} x {w}", wrapper(a, wf, scale, bias, kv),
                    P.int8_gemm_act_plain(a, wf, scale, bias, kv, act=act))
        times[name] = timing(
            cuda_ms(lambda: wrapper(a, wf, scale, bias, kv)),
            cuda_ms(lambda: P.int8_gemm_act_plain(a, wf, scale, bias, kv, act=act), iters=3),
            cuda_ms(lambda: torch._int_mm(a, wf.t())),
            bound(m * w + 4 * w * w + 4 * w * 8 + m * 4 * w, 2 * m * 4 * w * w, "int8"))
    del a, wf

    # S1's attention cores (int8 out) and S2's float modes, on S2's input.
    qkv = S2.make_qkv(frames)
    core_ops = 4 * frames * heads * seq * seq * d
    qkv_bytes = frames * seq * 3 * w * 2
    out_mul = 127.0 / 2.5
    for mode in ("div", "fold2", "sm2", "sm2div", "nomax", "cast", "head0", "bf16logits",
                 "nosoftmax"):
        name = f"attention_{mode}"
        wrapper = getattr(P, name)
        mul = 127.0 / 0.5 if mode == "cast" else out_mul  # cast: att itself in int8's range
        out = wrapper(qkv, heads, d ** -0.5, False, mul)
        ref = P.attention_variant_plain(qkv, heads, d ** -0.5, False, mul, None, mode)
        if out.dtype == torch.int8:
            checks.int8(name, f"{frames} x {seq} x {3 * w}", out, ref)
        else:  # the plain version's casts (weights to bf16) on the same inputs
            checks.float(name, f"{frames} x {seq} x {3 * w}", out, ref.float())
        del out, ref
        read = frames * seq * 3 * d * 2 if mode == "head0" else qkv_bytes
        times[name] = timing(
            cuda_ms(lambda: wrapper(qkv, heads, d ** -0.5, False, mul), iters=5),
            cuda_ms(lambda: P.attention_variant_plain(qkv, heads, d ** -0.5, False, mul, None,
                                                      mode), iters=3), None,
            bound(read + frames * seq * w * (1 if mode in ("div", "fold2", "sm2", "sm2div",
                                                           "nomax", "cast") else 2),
                  core_ops, "bf16"))

    # S2's amax pass, then its s8 attention and S3's slice-requant (s8_slice_rows).
    for block in (3, 2, 1):  # max is exact in any order: the plain version's bits
        scales, ref = P.attn_amax(qkv, block), P.attn_amax_plain(qkv, block)
        checks.float("attn_amax", f"{frames} x {seq} x {3 * w}, block {block}", scales, ref)
        require(torch.equal(scales, ref), f"attn_amax block {block}: not equal to the plain version")
    print("  attn_amax blocks 3, 2, 1: equal to the plain version")
    parts = qkv.view(frames, seq, 3, w)
    vector_norm = lambda t: torch.linalg.vector_norm(t, float("inf"), dim=(1, 3))  # noqa: E731
    times["attn_amax"] = timing(
        cuda_ms(lambda: P.attn_amax(qkv, 1)), cuda_ms(lambda: P.attn_amax_plain(qkv, 1)),
        cuda_ms(lambda: vector_norm(parts)),
        bound(qkv_bytes + frames * 3 * 4, frames * seq * 3 * w, "fp32"),
        (P.attn_amax, qkv, 1), (vector_norm, parts), device=True)
    del parts
    times.update(s8_slice_rows(torch, checks, qkv, scales))
    del qkv
    return times


# bench_arms.cu's s8 attention and slice-requant bodies by their __global__
# names, and the ones they replaced, which no profile may show.
S8_BODY, SLICE_BODY = "attention_s8_mma_kernel", "slice_requant_rows_kernel"
OLD_BENCH_ARMS = ("::attention_s8_kernel<", "::slice_requant_kernel<")


def s8_slice_rows(torch, checks: KernelChecks, qkv, scales, strict: bool = True):
    """Phase 3's rows of bench_arms.cu's s8 attention (S2's i8qk and i8qkav on
    the 512 x 197 x 2304 qkv with its block-1 scales) and slice-requant (S3's
    32 x 785 x 2304, bf16 and fp32), each held to its plain version, timed by
    events and by device time (cold L2) beside its bound; both s8 arms also
    held at 8 x 257 x 2304, past the 208 resident keys (the sweep). A profile
    of one call each must show the kernels' bodies and none they replaced.
    Slice-requant must equal its plain version; with strict False (another
    tree's package, in --bench-arms) the equality, and the bodies the profile
    shows, are recorded instead of required. Returns {name: timing}."""
    from fitclip_torch.bench import attn_int8 as S2
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator(device="cuda").manual_seed(13)
    frames, seq, w, heads = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, S2.HEADS
    d = w // heads
    core_ops = 4 * frames * heads * seq * seq * d
    qkv_bytes = qkv.numel() * 2
    times = {}
    long_qkv = (0.7 * torch.randn(8, 257, 3 * w, generator=gen, device="cuda")).to(torch.bfloat16)
    long_scales = P.attn_amax(long_qkv, 1)
    for name, av8 in (("attention_i8qk", False), ("attention_i8qkav", True)):
        wrapper = getattr(P, name)
        for what, x, sc in ((f"{frames} x {seq} x {3 * w}", qkv, scales),
                            (f"8 x 257 x {3 * w} (sweep)", long_qkv, long_scales)):
            out = wrapper(x, sc, heads, d ** -0.5)
            ref = P.attention_s8_plain(x, heads, d ** -0.5, 1, av8).float()
            if av8:
                checks.s8(name, what, out, ref, float(sc[:, 2].max()) / 127.0)
            else:
                checks.float(name, what, out, ref)
            del out, ref
        times[name] = timing(
            cuda_ms(lambda: wrapper(qkv, scales, heads, d ** -0.5), iters=5),
            cuda_ms(lambda: P.attention_s8_plain(qkv, heads, d ** -0.5, 1, av8), iters=3), None,
            bound(qkv_bytes + frames * 3 * 4 + frames * seq * w * 2,
                  {"int8": core_ops} if av8 else {"int8": core_ops // 2, "bf16": core_ops // 2}),
            (wrapper, qkv, scales, heads, d ** -0.5), device=True)
    del long_qkv

    # slice-requant on S3's joint qkv, bf16 and fp32: the same fp32 product,
    # rounded half to even, as the plain version.
    clips, n, inv = 32, 785, 127.0 / 4.0
    joint = torch.randn(clips, n, 3 * w, generator=gen, device="cuda").to(torch.bfloat16)
    for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        joint = joint.to(dtype)
        what = f"{clips} x {n} x {3 * w} {str(dtype)[6:]}"
        out, ref = P.slice_requant(joint, inv), P.slice_requant_plain(joint, inv)
        checks.int8("slice_requant", what, out, ref)
        equal = bool(torch.equal(out, ref))
        print(f"  slice_requant {what}: {'equal' if equal else 'NOT equal'} to the plain version")
        require(equal or not strict, f"slice_requant {what}: not equal to the plain version")
        moved = clips * n * w * (size + 1)  # W of each row's 3W read, W bytes written
        entry = dict(timing(
            cuda_ms(lambda: P.slice_requant(joint, inv)),
            cuda_ms(lambda: P.slice_requant_plain(joint, inv)), None,
            bound(moved, clips * n * w * 2, "fp32"),
            (P.slice_requant, joint, inv), device=True, touched=moved), shape=what, equal=equal)
        if dtype == torch.bfloat16:
            times["slice_requant"] = entry
        else:
            times["slice_requant"]["fp32"] = entry
            print_row("slice_requant", entry)
        del out, ref
    per_kernel, _ = profile_ms(torch, lambda: (P.attention_i8qk(qkv, scales, heads, d ** -0.5),
                                               P.attention_i8qkav(qkv, scales, heads, d ** -0.5),
                                               P.slice_requant(joint, inv)), calls=1)
    shown = sorted({k[:60] for k in per_kernel if "s8" in k or "slice" in k})
    print(f"  bench_arms.cu bodies in a profile of one call each: {shown}")
    if strict:
        for body in (S8_BODY, SLICE_BODY):
            require(any(body in k for k in per_kernel), f"the profile shows no {body}")
        old = [k for k in per_kernel if any(name in k for name in OLD_BENCH_ARMS)]
        require(not old, f"the profile shows a replaced kernel: {old}")
    del joint
    return times


def bench_phase(torch, checks: KernelChecks, wrappers, steps=(2, 7, 2)):
    """Phase 10, the port's bench path (fitclip_torch/bench, the entry points
    of ``python -m fitclip_torch.bench``): (a) every S1, S2 and S3 arm against
    its plain twin at 32 frames (S3: 8 clips), the two-stream S1s bit for bit
    against `full`; (b) with the launch counts zeroed, every case of the three
    ablation benches at its script's production shape, with the kernels'
    agreement with `full` (cos_vs_full); (c) one encode reading each for int8
    and bf16 at 128 clips with bench.py's gates. Each case is timed over 2 and
    7 chained steps, in two trials (the reference's count): one trial alone
    can read a long short run, as S1s's two streams sometimes give, and then
    no marginal time. Returns ({path: launches}, {"skew": timing}, records)."""
    from fitclip_torch.bench import attn_int8 as S2
    from fitclip_torch.bench import block_layer as S1
    from fitclip_torch.bench import encode
    from fitclip_torch.bench import fit_block as S3
    from fitclip_torch.bench import kernels as P
    from fitclip_torch.bench.kernels import WRAPPERS

    start = time.perf_counter()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, S1.SEQ, S1.WIDTH)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    layer = S1.layer_block(S1.make_layer_params(rng))
    missed = []

    def arm_check(check, *args):  # every arm is checked; the phase fails after
        try:
            check(*args)
        except RuntimeError as error:
            missed.append(str(error))

    for mode in S1.ARMS:
        ops = S1.arm_operands(layer, mode)
        arm_check(checks.float, "bench arms", f"S1 {mode}", S1.run_arm(x.clone(), ops, mode),
                  S1.run_arm(x, ops, mode, plain=True).float())
    ops = S1.arm_operands(layer, "full")
    full = S1.run_arm(x, ops, "full")
    skew = S1.SkewSchedule()(x, ops)
    require(torch.equal(skew, full), "S1s (two streams) is not bit-identical to `full`")
    checks._record("block_layer_skew", 0.0)
    print("  bench arms S1s: two streams over 8 chunks, bit-identical to `full`")
    qkv = S2.make_qkv(32)
    v_step = float(P.attn_amax_plain(qkv, 1)[:, 2].max()) / 127.0
    for mode in S2.ARMS:
        out, ref = S2.run_arm(qkv, mode), S2.run_arm(qkv, mode, plain=True).float()
        if mode == "i8qkav":
            arm_check(checks.s8, "bench arms", f"S2 {mode}", out, ref, v_step)
        else:
            arm_check(checks.float, "bench arms", f"S2 {mode}", out, ref)
    fit_layer = S3.load_layer()
    cfg, fit_ops = fit_layer
    fx = S3.layer_input(cfg, 8)
    fit_plain = {}
    for mode in S3.ARMS:
        fit_plain[mode] = S3.run_arm(fx, fit_ops, mode, cfg.num_heads, cfg.num_frames,
                                     plain=True).float()
        arm_check(checks.layer, "bench arms", f"S3 {mode}",
                  S3.run_arm(fx, fit_ops, mode, cfg.num_heads, cfg.num_frames), fit_plain[mode],
                  fx)
    require(not missed, "bench arms against their plain twins: " + "; ".join(missed))
    # A planted wrong arm: `nocls` (only the CLS row differs) held as `full`
    # must miss the block rule.
    try:
        checks.layer("planted", "bench arms: S3 nocls held as full",
                     S3.run_arm(fx, fit_ops, "nocls", cfg.num_heads, cfg.num_frames),
                     fit_plain["full"], fx)
    except RuntimeError:
        print("  bench arms: the block rule rejects `nocls` held as `full`")
    else:
        require(False, "the block rule does not tell S3's `nocls` from `full`")
    del x, qkv, fx, full, skew
    print(f"bench arms against their plain twins: {time.perf_counter() - start:.1f} s")

    counted = {**wrappers, **{w.__name__: w for w in WRAPPERS}, "block_layer_skew": S1.SkewSchedule}
    for fn in counted.values():
        fn.launches = 0
    records = []
    s1_cases = ",".join(sorted(S1.ARMS) + sorted(S1.RENAMES) + ["b2", "skew"])
    records += list(S1.run(s1_cases, check=True, steps=steps))
    records += list(S2.run(",".join(f"core_{m}" for m in S2.MODES), check=True, steps=steps))
    records += list(S3.run(",".join(list(S3.ARMS) + ["b2", "pad8", "split2"]), check=True,
                           steps=steps, layer=fit_layer))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    for dtype in ("int8", "bf16"):
        records.append(encode.run(dtype, 128, steps=steps))
    for record in records:
        print(f"  {json.dumps(record)}")

    # S1s's entry: the layer on two streams at 512 frames, its plain twin, and
    # the layer's bound (int8 GEMMs and the bf16-equivalent attention core).
    frames, seq, w, heads = S1.FRAMES, S1.SEQ, S1.WIDTH, S1.HEADS
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(frames, seq, w)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    m = frames * seq
    skew = timing(next(r["ms"] for r in records if r.get("case") == "skew"),
                  cuda_ms(lambda: S1.run_arm(x, ops, "full", plain=True), iters=1, warmup=1),
                  None, bound(m * w * 2 * 2 + 12 * w * w + 20 * w * 4,
                              {"int8": 2 * m * 12 * w * w,
                               "bf16": 4 * frames * heads * seq * seq * (w // heads)}))
    print(f"bench phase: {time.perf_counter() - start:.1f} s")
    return {"bench": launches}, {"block_layer_skew": skew}, records


def token_ids(rows: int, rng: np.random.Generator, context: int = 77, vocab: int = 49408):
    """Random token rows ending in the max-id EOT token (as bench.py makes them)."""
    ids = np.zeros((rows, context), np.int64)
    for row in range(rows):
        n = int(rng.integers(5, context - 7))
        ids[row, :n] = rng.integers(1, vocab - 1, n)
        ids[row, n] = vocab - 1
    return ids


class CountingLoader:
    """Batches in a fixed order. Notes the launch counters as it hands out each
    batch, so successive notes differ by the launches of one train step."""

    def __init__(self, batches, counters):
        self.batches, self.counters, self.notes = batches, counters, []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for batch in self.batches:
            self.notes.append(self.counters())
            yield batch


class TrainData:
    """A data module with a train split only (run_train then skips validation)."""

    def __init__(self, batches, counters):
        self.loader = CountingLoader(batches, counters)

    def train_dataloader(self):
        return self.loader

    def val_dataloader(self):
        raise NotImplementedError


def step_launches(notes, final):
    """Per-step launch counts from the loader's notes and the counts at the end."""
    marks = [*notes, final]
    return [{k: after[k] - before[k] for k in after} for before, after in zip(marks, marks[1:])]


def plain_attention_function(torch):
    """fused_attention_qkv with the kernels' plain versions as forward and backward."""
    from fitclip_torch.ops import attention as A

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, heads, scale, causal):
            ctx.save_for_backward(qkv)
            ctx.args = (heads, scale, causal)
            return A.attention_core_plain(qkv, heads, scale, causal)

        @staticmethod
        def backward(ctx, grad_out):
            (qkv,) = ctx.saved_tensors
            return A.attention_backward_plain(qkv, grad_out, *ctx.args), None, None, None

    return lambda qkv, heads, scale, causal=False: PlainAttention.apply(qkv, heads, scale,
                                                                         causal)


def train(torch, slot, batches, model_cfg, counters, workdir: Path, max_steps=None,
          checkpoint_dir=None, checkpoint_path=None):
    """One run_train call; returns (state, losses per step, launches per step)."""
    from fitclip_torch.training.train_runner import run_train

    data = TrainData(batches, counters)
    trainer_cfg = {"max_epochs": 1, "log_every_n_steps": 1, "max_steps": max_steps}
    callbacks = None
    if checkpoint_dir:
        callbacks = {"checkpoint": {"dirpath": str(checkpoint_dir), "monitor": None,
                                    "every_n_epochs": 0, "train_time_interval_seconds": None}}
    optimizer_cfg = {"lr": 3e-6, "weight_decay": 0.01, "eps": 1e-8}  # config/*trainer.yaml
    out = run_train(slot, data, model_cfg, trainer_cfg, optimizer_cfg, callbacks,
                    log_dir=str(workdir), checkpoint_path=checkpoint_path)
    torch.cuda.synchronize()
    launches = step_launches(data.loader.notes, counters())
    logged = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
    return out["state"], [entry["loss/train"] for entry in logged], launches


def same_bits(torch, a, b) -> bool:
    """Params, moments, AdamW count and step of two train states are identical."""
    named_a, named_b = a.named_parameters(), b.named_parameters()
    return (a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
            and all(torch.equal(named_a[n], named_b[n]) for n in named_a)
            and all(torch.equal(a.opt_state[k][n], b.opt_state[k][n])
                    for k in ("mu", "nu") for n in named_a))


def step_chains(torch, fn, chains: int = 5, steps: int = 3, warmup: int = 2):
    """ms per step of each of ``chains`` chains of ``steps`` steps after warm-up,
    each chain timed by CUDA events from its first step to its last."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(chains):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / steps)
    return out


# The port's GEMM kernels (csrc/gemm_wgmma.cuh's wgmma mainloop) by name, and
# the mma.sync GEMM kernels they replaced, which no profile may show.
INT8_GEMM, BF16_GEMM = "int8_gemm_wgmma_kernel", "bf16_gemm_wgmma_kernel"
OLD_GEMMS = ("int8_gemm_kernel", "bf16_gemm_kernel")

# A train step's device time by group (first match by kernel name): the attention
# backward (K3b: the bf16 tensor-core kernels, or the fp32 register-tiled ones),
# the forward attention, the port's GEMM and LayerNorm kernels (the int8
# teacher), cuBLAS and the fused AdamW.
F32_FORWARD = "attention_f32_kernel"
F32_BACKWARD = ("rows_f32_kernel", "columns_f32_kernel")
STEP_GROUPS = (
    ("K3b", ("rows_mma_kernel", "columns_mma_kernel", *F32_BACKWARD)),
    ("forward attention", ("attention_mma_kernel", F32_FORWARD)),
    ("port GEMM + LN", (INT8_GEMM, BF16_GEMM, LN_KERNEL)),
    ("cuBLAS", ("nvjet", "cublas", "cutlass", "xmma", "gemm", "gemv")),
    ("optimizer", ("Adam", "multi_tensor_apply")),
)
K3B_MMA = ("rows_mma_kernel", "columns_mma_kernel")
# The CUDA-core attention kernels of the fp32 bodies that the register-tiled
# ones replaced: no profile may show them.
OLD_F32_ATTENTION = ("attention_kernel_f32", "::rows_kernel<", "::columns_kernel<")


def step_profile(torch, what, fn, needs=(), forbid=()):
    """torch.profiler over one step: its device ms by group and the top kernels.
    Every kernel named in ``needs`` must show; none in ``forbid`` may."""
    per_kernel, busy = profile_ms(torch, fn, calls=1)
    total = sum(per_kernel.values())
    groups = {name: 0.0 for name, _ in STEP_GROUPS}
    groups["other"] = 0.0
    for key, ms in per_kernel.items():
        group = next((name for name, marks in STEP_GROUPS if any(m in key for m in marks)),
                     "other")
        groups[group] += ms
    print(f"{what} profile, one step: device {total:.3f} ms, busy share {busy:.3f} of the "
          f"host window; by group (ms, share): " +
          ", ".join(f"{name} {ms:.3f} ({ms / total:.2%})" for name, ms in groups.items()))
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} {ms / total:7.2%}  {key[:100]}")
    for name in needs:
        ms = sum(v for k, v in per_kernel.items() if name in k)
        print(f"  {what}: {name} {ms:.3f} ms ({ms / total:.2%})")
        require(ms > 0, f"{what}: the profile shows no {name}")
    bad = [k for k in per_kernel if any(name in k for name in forbid)]
    require(not bad, f"{what}: the profile shows {bad}")
    return {"device_ms": total, "busy": busy, "groups_ms": groups}


def step_timings(torch, student_template, teacher, batch, ts_batch, needs=(), forbid=(),
                 tag="(d)"):
    """Phase 6 (d): the contrastive (32 clips) and teacher-student (8 + 8, the
    int8 teacher; none without a teacher) steps that run_train drives, on fresh
    states: ms per step as the median of 5 chains of 3 steps after warm-up
    (with min and max), peak memory, and a profile of one step of each that
    shows the kernels in ``needs`` and none in ``forbid``."""
    from fitclip_torch.training.state import init_train_state, make_optimizer
    from fitclip_torch.training.steps import (make_contrastive_train_step,
                                              make_teacher_student_train_step)
    from fitclip_torch.training.train_runner import make_batch_preparer

    frames = student_template.encoder.num_frames
    optimizer = make_optimizer(3e-6, weight_decay=0.01, eps=1e-8, fused=True)
    timings = {}
    for kind in ("contrastive", "teacher_student") if teacher else ("contrastive",):
        torch.cuda.empty_cache()
        encoder = copy.deepcopy(student_template.encoder)
        if kind == "contrastive":
            state = init_train_state(encoder, optimizer, init_temperature=0.015)
            step = make_contrastive_train_step(encoder, optimizer)
            device_batch = make_batch_preparer("cuda")(batch)
        else:
            state = init_train_state(encoder, optimizer, init_temperature=0.05,
                                     with_teacher_student_scale=True)
            step = make_teacher_student_train_step(encoder, teacher.encoder, optimizer,
                                                   labeled_loss_share=0.9999)
            device_batch = make_batch_preparer("cuda")(ts_batch)
        torch.cuda.reset_peak_memory_stats()
        chains = step_chains(torch, lambda: step(state, device_batch))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        median = float(np.median(chains))
        timings[kind] = {"ms": median, "min_ms": min(chains), "max_ms": max(chains),
                         "chains_ms": chains, "peak_gib": peak}
        clips = 32 if kind == "contrastive" else 16
        print(f"train {tag} {kind} step, {'32' if clips == 32 else '8 + 8'} clips x {frames} "
              f"frames: median {median:.3f} ms (min {min(chains):.3f}, max {max(chains):.3f}; "
              f"5 chains of 3 steps), {clips * 1e3 / median:.1f} clips/s, peak {peak:.2f} GiB")
        timings[kind]["profile"] = step_profile(torch, f"train {tag} {kind}",
                                                lambda: step(state, device_batch), needs, forbid)
        del state, step, encoder, device_batch
    return timings


def training_phase(torch, student_template, teacher, wrappers, workdir: Path):
    """Phase 6; returns ({phase: launches summed over its steps}, timings)."""
    import fitclip_torch.models.clip.model as model_module
    from fitclip_torch.models.clip.load import LoadedEncoder
    from fitclip_torch.ops.losses import nce_loss
    from fitclip_torch.training.train_runner import make_batch_preparer

    def counters():
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def student():
        return LoadedEncoder(copy.deepcopy(student_template.encoder))

    rng = np.random.default_rng(2)
    size = student_template.encoder.config.vision.image_size
    frames = student_template.encoder.num_frames

    def clips(n):
        return rng.integers(0, 256, size=(n, frames, size, size, 3), dtype=np.uint8)

    # config/trainer.yaml's temperature; fit_temperature false freezes it.
    contrastive_cfg = {"init_temperature": 0.015, "min_temperature": 0.001,
                       "fit_temperature": False}
    batches = [{"video": clips(32), "text": token_ids(32, rng)} for _ in range(5)]
    per_layer = {"fused_attention_qkv": 1, "fused_attention_qkv_backward": 1}
    totals = {}

    # (a) Contrastive, the kernel path.
    zero()
    straight, losses, launches = train(torch, student(), batches, contrastive_cfg, counters,
                                       workdir / "contrastive")
    totals["contrastive"] = counters()
    expected = {k: 2 * LAYERS * per_layer.get(k, 0) for k in wrappers}
    print(f"train (a) contrastive, 32 clips x {frames} frames: losses {losses}; "
          f"launches per step {launches[0]}")
    require(len(losses) == 5 and all(np.isfinite(losses)), f"contrastive losses {losses}")
    require(all(step == expected for step in launches),
            f"contrastive launches per step {launches}, expected {expected}")

    # The gradient reaches in_proj through the attention kernels.
    device_batch = make_batch_preparer("cuda")(batches[0])
    model = straight.params["encoder"].model
    in_projs = [model.visual.transformer.blocks[0].attn.in_proj.weight,
                model.text.transformer.blocks[0].attn.in_proj.weight]
    encoder = straight.params["encoder"]
    scores = torch.exp(straight.params["logit_scale"][0]) * (
        encoder.encode_video(device_batch["video"]).float()
        @ encoder.encode_text(device_batch["text"]).float().T)
    for tower, grad in zip(("vision", "text"),
                           torch.autograd.grad(nce_loss(scores), in_projs)):
        norm = float(grad.float().norm())
        print(f"train (a) {tower} block 0 in_proj gradient norm {norm:.4e}")
        require(np.isfinite(norm) and norm > 0, f"{tower} in_proj gradient norm {norm}")

    # (c) Resume: 3 steps, checkpoint, restore, 2 more.
    zero()
    checkpoints = workdir / "checkpoints"
    train(torch, student(), batches, contrastive_cfg, counters, workdir / "resume_3",
          max_steps=3, checkpoint_dir=checkpoints)
    resumed, resumed_losses, _ = train(torch, student(), batches, contrastive_cfg, counters,
                                       workdir / "resume_5", max_steps=5,
                                       checkpoint_path=str(checkpoints / "last"))
    totals["resume"] = counters()
    bitwise = same_bits(torch, resumed, straight)
    print(f"train (c) resume: 3 steps + checkpoint + 2 steps; losses after resume "
          f"{resumed_losses}; bit-identical to 5 straight steps: {bitwise}")
    require(bitwise, "resumed params or moments differ from the straight run")
    del resumed

    # (a) again with the plain attention forward and backward.
    zero()
    with swapped(model_module, fused_attention_qkv=plain_attention_function(torch)):
        _, plain_losses, plain_launches = train(torch, student(), batches, contrastive_cfg,
                                                counters, workdir / "contrastive_plain")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    print(f"train (a) plain attention: losses {plain_losses}; relative differences {rel}")
    require(not any(any(step.values()) for step in plain_launches),
            "the plain-attention run launched a kernel")
    require(len(plain_losses) == 5 and max(rel) <= LOSS_RTOL,
            f"kernel vs plain attention losses beyond relative {LOSS_RTOL}: {rel}")
    del straight, model, in_projs, encoder, scores

    # (b) Teacher-student with the int8 teacher.
    ts_cfg = {"init_temperature": 0.05, "min_temperature": 0.001, "fit_temperature": True,
              "labeled_dataset_loss_share": 0.9999}

    def ts_batch():
        def sub():
            video, text = clips(8), token_ids(8, rng)
            return {"video_student": video, "text_student": text,
                    "video_teacher": video, "text_teacher": text}
        return {"labeled": sub(), "unlabeled": sub()}

    ts_batches = [ts_batch() for _ in range(3)]
    zero()
    _, ts_losses, ts_launches = train(torch, {"student": student(), "teacher": teacher},
                                      ts_batches, ts_cfg, counters, workdir / "teacher_student")
    totals["teacher_student"] = counters()
    expected = {k: 2 * LAYERS * {**per_layer, **INT8_LAUNCHES_PER_LAYER}.get(k, 0)
                for k in wrappers}
    print(f"train (b) teacher-student, 8 + 8 clips, int8 teacher: losses {ts_losses}; "
          f"launches per step {ts_launches[0]}")
    require(len(ts_losses) == 3 and all(np.isfinite(ts_losses)),
            f"teacher-student losses {ts_losses}")
    require(all(step == expected for step in ts_launches),
            f"teacher-student launches per step {ts_launches}, expected {expected}")
    shutil.rmtree(workdir)

    # (d) Timings and a profile of the steps run_train drives, on fresh states.
    print(f"clocks (phase 6 (d)): {clocks()}")
    timings = step_timings(torch, student_template, teacher, batches[0], ts_batches[0],
                           needs=K3B_MMA, forbid=(*F32_BACKWARD, *OLD_F32_ATTENTION))
    return totals, timings


def fp32_training_phase(torch, wrappers, workdir: Path):
    """Phase 6 (e): the fp32 contrastive step (the configs' default dtype: fp32
    compute on K3f's and K3b's register-tiled fp32 kernels), CLIP ViT-B/16 from
    seed 0 at 32 clips x 4 frames through run_train with (a)'s optimizer and
    temperature: 3 steps with 24 + 24 counted launches of each fp32 kernel per
    step, losses within LOSS_RTOL of the same steps on the plain attention;
    then step ms (median of 5 chains of 3, min and max), peak memory and a
    profile of one step that shows both fp32 kernels. Returns ({path:
    launches}, timings)."""
    import fitclip_torch.models.clip.model as model_module
    from fitclip_torch.models.clip.load import LoadedEncoder, load_clip_encoder

    def counters():
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    template = load_clip_encoder("ViT-B/16", dtype="float32", device="cuda", seed=0)
    rng = np.random.default_rng(5)
    size, frames = template.encoder.config.vision.image_size, template.encoder.num_frames
    batches = [{"video": rng.integers(0, 256, size=(32, frames, size, size, 3), dtype=np.uint8),
                "text": token_ids(32, rng)} for _ in range(3)]
    cfg = {"init_temperature": 0.015, "min_temperature": 0.001, "fit_temperature": False}
    zero()
    _, losses, launches = train(torch, LoadedEncoder(copy.deepcopy(template.encoder)), batches,
                                cfg, counters, workdir / "fp32")
    totals = counters()
    per_layer = {"fused_attention_qkv": 1, "fused_attention_qkv_backward": 1, "attention_f32": 1,
                 "attention_bwd_f32": 1}
    expected = {k: 2 * LAYERS * per_layer.get(k, 0) for k in wrappers}
    print(f"train (e) fp32 contrastive, 32 clips x {frames} frames: losses {losses}; launches "
          f"per step { {k: n for k, n in launches[0].items() if n} }")
    require(len(losses) == 3 and all(np.isfinite(losses)), f"fp32 contrastive losses {losses}")
    require(all(step == expected for step in launches),
            f"fp32 contrastive launches per step {launches}, expected {expected}")
    zero()
    with swapped(model_module, fused_attention_qkv=plain_attention_function(torch)):
        _, plain_losses, plain_launches = train(
            torch, LoadedEncoder(copy.deepcopy(template.encoder)), batches, cfg, counters,
            workdir / "fp32_plain")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    print(f"train (e) fp32 plain attention: losses {plain_losses}; relative differences {rel}")
    require(not any(any(step.values()) for step in plain_launches),
            "the fp32 plain-attention run launched a kernel")
    require(len(plain_losses) == 3 and max(rel) <= LOSS_RTOL,
            f"fp32 kernel vs plain attention losses beyond relative {LOSS_RTOL}: {rel}")
    shutil.rmtree(workdir)
    torch.cuda.empty_cache()
    print(f"clocks (phase 6 (e)): {clocks()}")
    timings = step_timings(torch, template, None, batches[0], None,
                           needs=(F32_FORWARD, *F32_BACKWARD),
                           forbid=(*K3B_MMA, "attention_mma_kernel", *OLD_F32_ATTENTION),
                           tag="(e) fp32")
    return {"fp32_contrastive": totals}, timings


def fp32_encode_timing(torch, enc):
    """An fp32 CLIP encoder's clips/s at 32 clips x 4 frames and text rows/s at
    256 x 77 (CUDA events over 10 calls after warm-up), and peak memory.
    Returns (timings, the 32 clips)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    video32 = torch.randint(0, 256, (32, 4, 224, 224, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
    text256 = torch.from_numpy(token_ids(256, np.random.default_rng(23))).cuda()
    torch.cuda.reset_peak_memory_stats()
    video_ms = cuda_ms(lambda: enc.encode_video(video32), iters=10)
    text_ms = cuda_ms(lambda: enc.encode_text(text256), iters=10)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = {"video_ms": video_ms, "clips_per_s": 32e3 / video_ms, "text_ms": text_ms,
             "text_rows_per_s": 256e3 / text_ms, "peak_gib": peak}
    print(f"clip fp32 encode: encode_video 32 clips x 4 frames {video_ms:.3f} ms, "
          f"{timed['clips_per_s']:.1f} clips/s; encode_text 256 x 77 {text_ms:.3f} ms, "
          f"{timed['text_rows_per_s']:.1f} rows/s; peak {peak:.2f} GiB")
    return timed, video32


def clip_fp32_phase(torch, wrappers, video, text):
    """Phase 5 (b): CLIP ViT-B/16 in fp32, the configs' default dtype, loaded as
    a user gets it (load_clip_encoder(dtype="float32"), fused attention on the
    card): one launch of the fp32 forward kernel per layer and tower in an
    encode of 8 clips and 8 rows and nothing else of the port; gate: min-row
    cosine > 0.999 against the same model with fused_attention=False on the
    card, both towers; clips/s, text rows/s, peak memory and a profile that
    shows the fp32 kernel and its share. Returns ({path: launches}, timings)."""
    from fitclip_torch.models.clip.load import load_clip_encoder

    print(f"clocks (phase 5 (b), fp32 encode): {clocks()}")
    enc = load_clip_encoder("ViT-B/16", dtype="float32", device="cuda", seed=0).encoder
    for fn in wrappers.values():
        fn.launches = 0
    video_emb, text_emb = enc.encode_video(video), enc.encode_text(text)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expected = {name: 0 for name in wrappers}
    expected.update(fused_attention_qkv=2 * LAYERS, attention_f32=2 * LAYERS)
    print(f"clip fp32: launches per encode of both towers "
          f"{ {k: n for k, n in launches.items() if n} }")
    require(launches == expected, f"clip fp32 launch counts {launches}, expected {expected}")
    plain = load_clip_encoder("ViT-B/16", dtype="float32", device="cuda", seed=0,
                              fused_attention=False).encoder
    for tower, kernel_emb, plain_emb in (("vision", video_emb, plain.encode_video(video)),
                                         ("text", text_emb, plain.encode_text(text))):
        cos = min_cosine(kernel_emb, plain_emb)
        print(f"clip fp32 gate {tower}: fused vs unfused attention on the card, min cosine "
              f"{cos:.6f}")
        require(cos > GATE_COSINE, f"clip fp32 {tower}: fused vs unfused cosine {cos}")
    del plain
    torch.cuda.empty_cache()
    timed, video32 = fp32_encode_timing(torch, enc)
    print_profile(torch, "clip fp32 encode_video", lambda: enc.encode_video(video32), top=6,
                  kernels=(F32_FORWARD,))
    return {"fp32_encode": launches}, timed


def fp32_attention_only(torch, package: Path) -> int:
    """``--fp32-attention [DIR]``: the fp32 attention alone for the fitclip_torch
    package under DIR (default: this checkout), so that two trees' kernels are
    timed by the same code in one run: phase 3's fp32 rows (forward and
    backward, each against its plain version, bound and SDPA's fp32 call), the
    fp32 CLIP ViT-B/16 encode's clips/s and text rows/s, and phase 6 (e)'s fp32
    contrastive step ms (its profile requires no kernel by name, so that the
    parent's kernels pass). Prints one JSON line of the readings."""
    sys.path.insert(0, str(package))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.ops import attention as A

    print(f"fp32 attention of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}; clocks {clocks()}")
    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    rows = f32_attention_phase(torch, KernelChecks(), A)
    torch.cuda.empty_cache()
    print(f"clocks (fp32 encode): {clocks()}")
    template = load_clip_encoder("ViT-B/16", dtype="float32", device="cuda", seed=0)
    with torch.no_grad():
        encode, _ = fp32_encode_timing(torch, template.encoder)
    rng = np.random.default_rng(5)
    batch = {"video": rng.integers(0, 256, size=(32, 4, 224, 224, 3), dtype=np.uint8),
             "text": token_ids(32, rng)}
    print(f"clocks (fp32 step): {clocks()}")
    step = step_timings(torch, template, None, batch, None, tag="(e) fp32")
    print(json.dumps({"fp32_attention": rows, "fp32_encode": encode, "fp32_step": step,
                      "package": str(package), "card": nvidia_smi()}))
    return 0


def fit_attention_only(torch, package: Path) -> int:
    """``--fit-attention [DIR]``: FiT's attention alone for the fitclip_torch
    package under DIR (default: this checkout), so that two trees' kernels are
    timed by the same code in one run: phase 3's FiT rows (K4's three int8
    cores, K5 and K6 in bf16 and fp32, each held to its plain version, timed by
    events and device time beside its bound and SDPA) and the FiT base int8
    (calibrated on 8 clips), bf16 and fp32 encodes' clips/s at 32 clips x 4
    frames (CUDA events over 10 calls after warm-up). Prints one JSON line of
    the readings (the rows' kernel names are this checkout's), with
    attention.cu's fp32 forward at 128 x 197 x 2304 by device time beside
    them (the yardstick of K5 in fp32, which runs the same block body)."""
    sys.path.insert(0, str(package))
    from fitclip_torch import _build
    from fitclip_torch.models.frozen_in_time.load import load_frozen_in_time_encoder
    from fitclip_torch.ops import attention as A

    print(f"FiT attention of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}; clocks {clocks()}")
    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    torch.set_grad_enabled(False)
    checks = KernelChecks()
    rows = fit_kernel_phase(torch, checks, A)
    # The yardstick of K5 in fp32: attention.cu's fp32 forward on the same
    # block body at one vision layer of the fp32 encode, by device time.
    qkv = 1.5 * torch.randn(128, 197, 3 * FIT["width"], device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(17))
    heads, scale = FIT["heads"], (FIT["width"] // FIT["heads"]) ** -0.5
    checks.float("attention_f32", "fp32 128 x 197 x 2304", A.fused_attention_qkv(qkv, heads, scale),
                 A.attention_core_plain(qkv, heads, scale, False))
    rows["attention_f32"] = {"shape": "fp32 128 x 197 x 2304, qkv mode", "kernel": F32_FORWARD,
                             "device_ms": device_ms(A.fused_attention_qkv, qkv, heads, scale)}
    del qkv
    for name, entry in rows.items():
        if name == "attention_f32":
            print(f"  attention_f32 at {entry['shape']}: device {entry['device_ms']:.4f} ms")
        else:
            print_row(name, entry)
    torch.cuda.empty_cache()
    print(f"clocks (FiT encodes): {clocks()}")
    video, encode = fit_video(torch, FIT["clips"]), {}
    for dtype in ("int8", "bfloat16", "float32"):
        enc = load_frozen_in_time_encoder(dtype=dtype, device="cuda", seed=0).encoder
        if dtype == "int8":
            enc.calibrate(video[:8])
        ms = cuda_ms(lambda: enc.encode_video(video), iters=10)
        encode[dtype] = {"video_ms": ms, "clips_per_s": FIT["clips"] * 1e3 / ms}
        print(f"fit {dtype} encode_video {FIT['clips']} clips x {FIT['frames']} frames: "
              f"{ms:.3f} ms, {encode[dtype]['clips_per_s']:.1f} clips/s")
        del enc
        torch.cuda.empty_cache()
    print(json.dumps({"fit_attention": rows, "fit_encode": encode, "package": str(package),
                      "card": nvidia_smi()}))
    return 0


def wordpiece_ids(rows: int, rng: np.random.Generator, context: int = 77, vocab: int = 30522):
    """Random DistilBERT rows: [CLS] (101), ids, [SEP] (102), [PAD] (0) to the end."""
    ids = np.zeros((rows, context), np.int64)
    for row in range(rows):
        n = int(rng.integers(5, context - 2))
        ids[row, 0], ids[row, n + 1] = 101, 102
        ids[row, 1:n + 1] = rng.integers(1000, vocab, n)
    return ids


def profile_ms(torch, fn, calls: int = 3):
    """torch.profiler over ``calls`` calls: ({kernel name: device ms per call},
    device busy share of the host window)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    per_kernel = {}
    for event in prof.key_averages():
        if str(getattr(event, "device_type", "")).endswith("CUDA"):
            us = getattr(event, "self_device_time_total", None)
            if us is None:
                us = event.self_cuda_time_total
            if us > 0:
                per_kernel[event.key] = us / 1e3 / calls
    return per_kernel, sum(per_kernel.values()) * calls / window_ms


# The CUDA-core forward attention bodies by their kernel names (fp32 only; every
# bf16 path runs attention_mma.cuh's attention_mma_kernel or space_mma_kernel).
CUDA_CORE_ATTENTION = (F32_FORWARD, SPACE_F32, "space_kernel_f32")


def print_profile(torch, what, fn, top=10, mma=None, kernels=()):
    """The profile's top kernels; with mma (kernel names), require that those
    tensor-core attention bodies ran and no CUDA-core attention body did; with
    kernels, that those kernels (GEMM, LayerNorm, FiT's time and fp32 space)
    ran, each with its share. No profile may show a replaced GEMM, LayerNorm,
    amax, attention or stem kernel."""
    per_kernel, busy = profile_ms(torch, fn)
    total = sum(per_kernel.values())
    print(f"{what} profile, device {total:.3f} ms per call, busy share {busy:.3f} of the host "
          f"window; top kernels (ms per call, share):")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.3f} {ms / total:7.2%}  {key[:100]}")
    for name in (*(mma or ()), *kernels):
        ms = sum(v for k, v in per_kernel.items() if name in k)
        print(f"  {what}: {name} {ms:.3f} ms per call ({ms / total:.2%})")
        require(ms > 0, f"{what}: the profile shows no {name}")
    if mma:
        slow = [k for k in per_kernel if any(name in k for name in CUDA_CORE_ATTENTION)]
        require(not slow, f"{what}: a bf16 path ran a CUDA-core attention body: {slow}")
    old = [k for k in per_kernel
           if any(name in k for name in (*OLD_GEMMS, *OLD_ROW_PASSES, *OLD_F32_ATTENTION,
                                         *OLD_FIT_ATTENTION, *OLD_BENCH_ARMS, *OLD_STEM))]
    require(not old, f"{what}: the profile shows a replaced kernel: {old}")


def fit_phase(torch, wrappers):
    """Phase 7: Frozen-in-Time base, int8 (K4's kernels) and bf16 (K5/K6),
    from seed 0; returns ({path: launches}, timings)."""
    import fitclip_torch.models.frozen_in_time.video_transformer as vt
    from fitclip_torch.models.clip.encoder import l2_normalize
    from fitclip_torch.models.frozen_in_time.encoder import EMBED_EPS
    from fitclip_torch.models.frozen_in_time.fit_fast import encode_video_features_fast
    from fitclip_torch.models.frozen_in_time.load import load_frozen_in_time_encoder
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops.fit_block import fused_fit_int8_layer_plain

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def expect(per_layer):
        return {k: FIT_LAYERS * per_layer.get(k, 0) for k in wrappers}

    start = time.perf_counter()
    int8_enc = load_frozen_in_time_encoder(dtype="int8", device="cuda", seed=0).encoder
    bf16_enc = load_frozen_in_time_encoder(dtype="bfloat16", device="cuda", seed=0).encoder
    print(f"fit: loaded int8 and bf16 FiT base in {time.perf_counter() - start:.1f} s "
          f"(fused_block {int8_enc.fused_block} / {bf16_enc.fused_block}, fused_attention "
          f"{int8_enc.fused_attention} / {bf16_enc.fused_attention})")
    gen = torch.Generator(device="cuda").manual_seed(5)
    clips, frames = FIT["clips"], FIT["frames"]

    def uint8_video(n):
        return torch.randint(0, 256, (n, frames, 224, 224, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    calib, video = uint8_video(8), uint8_video(clips)
    text = torch.from_numpy(wordpiece_ids(256, np.random.default_rng(6))).cuda()

    paths = {}
    zero()
    int8_enc.calibrate(calib)
    paths["fit_calibrate"] = counters()
    zero()
    int8_emb = int8_enc.encode_video(video)
    paths["fit_int8_encode"] = counters()
    zero()
    bf16_emb = bf16_enc.encode_video(video)
    paths["fit_bf16_encode"] = counters()
    zero()
    text_emb = bf16_enc.encode_text(text)
    paths["fit_text_encode"] = counters()
    print(f"fit: launches per path (nonzero counts) "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    nothing = expect({})
    require(paths["fit_calibrate"] == nothing, "FiT calibration launched a kernel")
    require(paths["fit_int8_encode"] == expect(FIT_INT8_LAUNCHES_PER_LAYER),
            f"FiT int8 encode launches {paths['fit_int8_encode']}")
    require(paths["fit_bf16_encode"] == expect(FIT_BF16_LAUNCHES_PER_LAYER),
            f"FiT bf16 encode launches {paths['fit_bf16_encode']}")
    require(paths["fit_text_encode"] == nothing, "the DistilBERT tower launched a kernel")

    # Gate (i): the kernel paths against the same models through the plain versions.
    zero()
    features = encode_video_features_fast(int8_enc.video, int8_enc._prepare_video(video),
                                          layer_fn=fused_fit_int8_layer_plain)
    plain = {"int8": l2_normalize(int8_enc.vid_proj(features.float()), eps=EMBED_EPS)}
    with swapped(vt, fused_attention_qkv_gkv=A.attention_gkv_plain,
                 fused_time_attention=A.time_attention_plain):
        plain["bf16"] = bf16_enc.encode_video(video)
    require(counters() == nothing, "the plain FiT paths launched a kernel")
    for tag, emb in (("int8", int8_emb), ("bf16", bf16_emb)):
        cos = min_cosine(emb, plain[tag])
        print(f"fit gate (i) {tag} video: kernels vs plain on the card, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"FiT {tag}: kernel path vs plain path cosine {cos}")
    cos = min_cosine(int8_emb, bf16_emb)
    print(f"fit gate (ii) video: int8 vs bf16, min cosine {cos:.6f}")
    require(cos > GATE_COSINE, f"FiT int8 vs bf16 cosine {cos}")
    require(int8_emb.shape == (clips, 256) and bool(torch.isfinite(int8_emb).all())
            and bool(torch.isfinite(bf16_emb).all()), "FiT video embeddings not finite (32, 256)")
    require(text_emb.shape == (256, 256) and bool(torch.isfinite(text_emb).all()),
            "FiT text embeddings not finite (256, 256)")
    print(f"fit: text embeddings {tuple(text_emb.shape)}, all finite")
    del plain, features

    timings = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timings["int8_ms"] = cuda_ms(lambda: int8_enc.encode_video(video), iters=10)
    timings["int8_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    timings["bf16_ms"] = cuda_ms(lambda: bf16_enc.encode_video(video), iters=10)
    timings["bf16_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    timings["text_ms"] = cuda_ms(lambda: bf16_enc.encode_text(text), iters=10)
    print(f"fit: int8 encode_video, {clips} clips x {frames} frames: {timings['int8_ms']:.3f} ms, "
          f"{clips * 1e3 / timings['int8_ms']:.1f} clips/s, peak {timings['int8_peak_gib']:.2f} "
          f"GiB; bf16: {timings['bf16_ms']:.3f} ms, {clips * 1e3 / timings['bf16_ms']:.1f} "
          f"clips/s, peak {timings['bf16_peak_gib']:.2f} GiB; encode_text, 256 rows x 77: "
          f"{timings['text_ms']:.3f} ms, {256e3 / timings['text_ms']:.1f} rows/s")

    print_profile(torch, "fit: int8 encode_video", lambda: int8_enc.encode_video(video), top=12,
                  mma=("space_mma_kernel",), kernels=(INT8_GEMM, LN_KERNEL, TIME_ROWS, CLS_ROWS))
    print_profile(torch, "fit: bf16 encode_video", lambda: bf16_enc.encode_video(video), top=6,
                  mma=("space_mma_kernel",), kernels=(TIME_ROWS,))
    return paths, timings


def fit_video(torch, n: int):
    """n uint8 FiT clips (4 frames of 224^2) on the card, from phase 7's seed."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    return torch.randint(0, 256, (n, FIT["frames"], 224, 224, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)


def fit_fp32_phase(torch, wrappers):
    """Phase 7 (b): FiT base in fp32, as load_frozen_in_time_encoder() gives it
    (the default dtype, fused attention on the card), from seed 0: an encode
    of 32 clips x 4 frames and 256 rows x 77 launches K5 and K6 once per block
    (the fp32 space kernel and the time kernel) and nothing else of the
    port's; gate: min-row cosine of the video embeddings > 0.999 against the
    same model with fused_attention=False on the card (TF32 off), finite text
    embeddings; clips/s, text rows/s, peak memory, and a profile that requires
    the fp32 space and time kernels by name, shows neither kernel they
    replaced, and prints each one's share. Returns ({path: launches}, timings)."""
    from fitclip_torch.models.frozen_in_time.load import load_frozen_in_time_encoder

    print(f"clocks (phase 7 (b), FiT fp32 encode): {clocks()}")
    enc = load_frozen_in_time_encoder(device="cuda", seed=0).encoder
    require(enc.fused_attention and not enc.fused_block, "the default FiT encoder on the card "
            f"has fused_attention {enc.fused_attention}, fused_block {enc.fused_block}")
    clips = FIT["clips"]
    video = fit_video(torch, clips)
    text = torch.from_numpy(wordpiece_ids(256, np.random.default_rng(6))).cuda()
    for fn in wrappers.values():
        fn.launches = 0
    video_emb, text_emb = enc.encode_video(video), enc.encode_text(text)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expected = {name: 0 for name in wrappers}
    expected.update(fused_attention_qkv_gkv=FIT_LAYERS, fused_time_attention=FIT_LAYERS)
    print(f"fit fp32: launches per encode {({k: n for k, n in launches.items() if n})}")
    require(launches == expected, f"FiT fp32 launch counts {launches}, expected {expected}")
    plain = load_frozen_in_time_encoder(device="cuda", seed=0, fused_attention=False).encoder
    cos = min_cosine(video_emb, plain.encode_video(video))
    print(f"fit fp32 gate video: fused vs unfused attention on the card, min cosine {cos:.6f}")
    require(cos > GATE_COSINE, f"FiT fp32 video: fused vs unfused cosine {cos}")
    require(video_emb.shape == (clips, 256) and bool(torch.isfinite(video_emb).all())
            and text_emb.shape == (256, 256) and bool(torch.isfinite(text_emb).all()),
            "FiT fp32 embeddings not finite (32, 256) and (256, 256)")
    del plain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    video_ms = cuda_ms(lambda: enc.encode_video(video), iters=10)
    text_ms = cuda_ms(lambda: enc.encode_text(text), iters=10)
    timed = {"video_ms": video_ms, "clips_per_s": clips * 1e3 / video_ms, "text_ms": text_ms,
             "text_rows_per_s": 256e3 / text_ms,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"fit fp32: encode_video {clips} clips x {FIT['frames']} frames {video_ms:.3f} ms, "
          f"{timed['clips_per_s']:.1f} clips/s; encode_text 256 x 77 {text_ms:.3f} ms, "
          f"{timed['text_rows_per_s']:.1f} rows/s; peak {timed['peak_gib']:.2f} GiB")
    print_profile(torch, "fit: fp32 encode_video", lambda: enc.encode_video(video), top=8,
                  kernels=(SPACE_F32, TIME_ROWS))
    return {"fit_fp32_encode": launches}, timed


def s3dg_phase(torch, wrappers):
    """Phase 8: the S3D-G family from seed 0 on the card: MIL-NCE bf16 and int8 (the
    stem on K7, the int8 sites on int8_gemm_bias) and VideoCLIP bf16. Returns
    ({path: launches}, timings)."""
    from fitclip_torch.models.mil_nce import load_mil_nce_encoder
    from fitclip_torch.models.s3dg_fast import s3dg_fast_apply
    from fitclip_torch.models.videoclip import load_videoclip_encoder

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def expect(**counts):
        return {k: counts.get(k, 0) for k in wrappers}

    start = time.perf_counter()
    bf16_enc = load_mil_nce_encoder(dtype="bfloat16", device="cuda", seed=0).encoder
    int8_enc = load_mil_nce_encoder(dtype="int8", device="cuda", seed=0).encoder
    vc_enc = load_videoclip_encoder(dtype="bfloat16", device="cuda", seed=0).encoder
    print(f"s3dg: loaded MIL-NCE bf16 and int8 and VideoCLIP bf16 in "
          f"{time.perf_counter() - start:.1f} s (fast {bf16_enc.fast} / {int8_enc.fast} / "
          f"{vc_enc.fast})")
    gen = torch.Generator(device="cuda").manual_seed(8)
    rng = np.random.default_rng(9)
    m, v = MIL_NCE, VIDEOCLIP

    def uint8_video(n, frames):
        return torch.randint(0, 256, (n, frames, m["size"], m["size"], 3), generator=gen,
                             device="cuda", dtype=torch.uint8)

    calib, video, vc_video = (uint8_video(m["calib"], m["frames"]),
                              uint8_video(m["clips"], m["frames"]),
                              uint8_video(v["videos"], v["frames"]))
    words = rng.integers(1, m["vocab"], (m["text_rows"], m["tokens"]))
    words[np.arange(m["tokens"]) >= rng.integers(3, m["tokens"], (m["text_rows"], 1))] = 0
    mil_text = torch.from_numpy(words).cuda()
    vc_ids = wordpiece_ids(v["text_rows"], rng, context=v["tokens"] - 1)
    vc_text = torch.from_numpy(np.concatenate([vc_ids[:, :1], np.full((len(vc_ids), 1), 102),
                                               vc_ids[:, 1:]], axis=1)).cuda()  # [CLS] [SEP] ...

    paths = {}
    zero()
    int8_enc.calibrate(calib)
    paths["mil_nce_calibrate"] = counters()
    zero()
    int8_emb = int8_enc.encode_video(video)
    paths["mil_nce_int8_encode"] = counters()
    zero()
    bf16_emb = bf16_enc.encode_video(video)
    paths["mil_nce_bf16_encode"] = counters()
    zero()
    mil_text_emb = bf16_enc.encode_text(mil_text)
    paths["mil_nce_text_encode"] = counters()
    zero()
    vc_emb = vc_enc.encode_video(vc_video)
    paths["videoclip_encode"] = counters()
    zero()
    vc_text_emb = vc_enc.encode_text(vc_text)
    paths["videoclip_text_encode"] = counters()
    print(f"s3dg: launches per path (nonzero counts) "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    stem = expect(s3dg_stem=1)
    for path, want in (("mil_nce_calibrate", stem), ("mil_nce_bf16_encode", stem),
                       ("mil_nce_int8_encode", expect(s3dg_stem=1,
                                                      int8_gemm_bias=S3DG_INT8_SITES)),
                       ("videoclip_encode", stem), ("mil_nce_text_encode", expect()),
                       ("videoclip_text_encode", expect())):
        require(paths[path] == want, f"{path} launches {paths[path]}, expected {want}")

    # Gate (i): each kernel path against the same model through the plain versions.
    zero()
    plain = {"MIL-NCE bf16": s3dg_fast_apply(bf16_enc.video, bf16_enc._prepare_video(video),
                                             torch.bfloat16, plain=True),
             "MIL-NCE int8": s3dg_fast_apply(int8_enc.video, int8_enc._prepare_video(video),
                                             torch.bfloat16, int8=True, plain=True)}
    clips = vc_enc._clips(vc_video)
    features = s3dg_fast_apply(vc_enc.s3dg, clips, torch.bfloat16, plain=True)
    plain["VideoCLIP bf16"] = vc_enc.model.forward_video(
        features.reshape(v["videos"], -1, features.shape[-1]),
        torch.ones(v["videos"], 1, dtype=torch.int64, device="cuda"), vc_enc.CLS_ID,
        vc_enc.SEP_ID)
    require(counters() == expect(), "the plain S3D-G paths launched a kernel")
    for tag, emb in (("MIL-NCE bf16", bf16_emb), ("MIL-NCE int8", int8_emb),
                     ("VideoCLIP bf16", vc_emb)):
        cos = min_cosine(emb, plain[tag])
        print(f"s3dg gate (i) {tag} video: kernels vs plain on the card, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"{tag}: kernel path vs plain path cosine {cos}")
    cos = min_cosine(int8_emb, bf16_emb)
    print(f"s3dg gate (ii) MIL-NCE video: int8 vs bf16, min cosine {cos:.6f}")
    require(cos > S3DG_GATE_INT8, f"MIL-NCE int8 vs bf16 cosine {cos}")
    for tag, emb, shape in (("MIL-NCE bf16 video", bf16_emb, (m["clips"], 512)),
                            ("MIL-NCE int8 video", int8_emb, (m["clips"], 512)),
                            ("MIL-NCE text", mil_text_emb, (m["text_rows"], 512)),
                            ("VideoCLIP video", vc_emb, (v["videos"], 768)),
                            ("VideoCLIP text", vc_text_emb, (v["text_rows"], 768))):
        require(emb.shape == shape and bool(torch.isfinite(emb).all()),
                f"{tag} embeddings {tuple(emb.shape)} not finite {shape}")
        print(f"s3dg: {tag} embeddings {tuple(emb.shape)}, all finite, mean row norm "
              f"{float(emb.float().norm(dim=-1).mean()):.4f}")
    del plain, features, clips

    timings = {}
    torch.cuda.empty_cache()
    for tag, fn in (("mil_nce_bf16", lambda: bf16_enc.encode_video(video)),
                    ("mil_nce_int8", lambda: int8_enc.encode_video(video)),
                    ("videoclip", lambda: vc_enc.encode_video(vc_video))):
        torch.cuda.reset_peak_memory_stats()
        timings[f"{tag}_ms"] = cuda_ms(fn, iters=10)
        timings[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    timings["mil_nce_text_ms"] = cuda_ms(lambda: bf16_enc.encode_text(mil_text), iters=10)
    timings["videoclip_text_ms"] = cuda_ms(lambda: vc_enc.encode_text(vc_text), iters=10)
    print(f"s3dg: MIL-NCE encode_video, {m['clips']} clips x {m['frames']} frames: bf16 "
          f"{timings['mil_nce_bf16_ms']:.3f} ms, "
          f"{m['clips'] * 1e3 / timings['mil_nce_bf16_ms']:.1f} clips/s, peak "
          f"{timings['mil_nce_bf16_peak_gib']:.2f} GiB; int8 {timings['mil_nce_int8_ms']:.3f} ms, "
          f"{m['clips'] * 1e3 / timings['mil_nce_int8_ms']:.1f} clips/s, peak "
          f"{timings['mil_nce_int8_peak_gib']:.2f} GiB; encode_text, {m['text_rows']} rows x "
          f"{m['tokens']}: {timings['mil_nce_text_ms']:.3f} ms, "
          f"{m['text_rows'] * 1e3 / timings['mil_nce_text_ms']:.1f} rows/s")
    print(f"s3dg: VideoCLIP encode_video, {v['videos']} videos x {v['frames']} frames: "
          f"{timings['videoclip_ms']:.3f} ms, {v['videos'] * 1e3 / timings['videoclip_ms']:.1f} "
          f"videos/s, peak {timings['videoclip_peak_gib']:.2f} GiB; encode_text, "
          f"{v['text_rows']} rows x {v['tokens']}: {timings['videoclip_text_ms']:.3f} ms, "
          f"{v['text_rows'] * 1e3 / timings['videoclip_text_ms']:.1f} rows/s")

    print_profile(torch, "s3dg: MIL-NCE bf16 encode_video", lambda: bf16_enc.encode_video(video),
                  top=15, kernels=(STEM_BODY,))
    print_profile(torch, "s3dg: VideoCLIP bf16 encode_video",
                  lambda: vc_enc.encode_video(vc_video), top=8, kernels=(STEM_BODY,))
    return paths, timings


def k2_launches(layers: int, towers: int = 2) -> dict:
    """K2's seven launches per layer, over both towers."""
    return {name: n * layers * towers for name, n in K2_LAUNCHES_PER_LAYER.items()}


def tower_cosines(a, b):
    return {tower: min_cosine(x, y) for tower, x, y in zip(("vision", "text"), a, b)}


def clip_bf16_fused_phase(torch, wrappers, module_enc, video, text, video32):
    """Phase 9 (a): CLIP ViT-B/16 bf16 with fused_block=True (K2), against the
    plain layer and the bf16 module path of the same seed (``module_enc``, phase
    4's encoder). Returns ({path: launches}, timings)."""
    from fitclip_torch.models.clip.fast_eval import encode_frames_fast, encode_text_fast
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.ops import block as K

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    enc = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0,
                            fused_block=True).encoder
    enc.fold_pixel_normalization()
    for fn in wrappers.values():
        fn.launches = 0
    video_emb, text_emb = enc.encode_video(video), enc.encode_text(text)
    launches = counters()
    expected = {name: 0 for name in wrappers}
    expected.update(k2_launches(LAYERS))
    print(f"clip bf16 fused_block: launches {({k: n for k, n in launches.items() if n})}")
    require(launches == expected, f"CLIP bf16 fused_block launches {launches}, expected {expected}")

    frames = enc._prepare_frames(video)
    kernel = (encode_frames_fast(enc.model, frames), encode_text_fast(enc.model, text))
    plain = (encode_frames_fast(enc.model, frames, layer_fn=K.fused_bf16_layer_plain),
             encode_text_fast(enc.model, text, layer_fn=K.fused_bf16_layer_plain))
    for tower, cos in tower_cosines(kernel, plain).items():
        print(f"clip bf16 gate (i) {tower}: K2 vs fused_bf16_layer_plain on the card, "
              f"min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"CLIP K2 {tower}: kernel vs plain cosine {cos}")
    module = (module_enc.encode_video(video), module_enc.encode_text(text))
    for tower, cos in tower_cosines((video_emb, text_emb), module).items():
        print(f"clip bf16 gate (ii) {tower}: K2 vs the bf16 module path, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"CLIP K2 {tower}: K2 vs module path cosine {cos}")
    del kernel, plain, module
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: enc.encode_video(video32), iters=10)
    timings = {"clip_bf16_fused_ms": ms,
               "clip_bf16_fused_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"clip bf16 fused_block encode_video, 32 clips x 4 frames: {ms:.3f} ms, "
          f"{32e3 / ms:.1f} clips/s, peak {timings['clip_bf16_fused_peak_gib']:.2f} GiB")
    print_profile(torch, "clip bf16 fused_block encode_video", lambda: enc.encode_video(video32),
                  mma=("attention_mma_kernel",), kernels=(BF16_GEMM, LN_KERNEL))
    return {"clip_bf16_fused_encode": launches}, timings


def slip_phase(torch, wrappers, video, calib_text, text, video32):
    """Phase 9 (b): SLIP ViT-B/16 (Mu et al., ECCV 2022; SlipConfig.vit_b16) from
    seed 0 on the card, four paths: int8 fused_block (K1, exact GELU in the
    vision tower), bf16 fused_block (K2), the bf16 module path (K3f) and the
    int8 module path with fused attention (K8 and the static denses on K1's
    GEMM). Returns ({path: launches}, timings)."""
    import fitclip_torch.models.clip.model as model_module
    from fitclip_torch.models import slip_fast
    from fitclip_torch.models.slip import load_slip_encoder
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def expect(**counts):
        return {name: counts.get(name, 0) for name in wrappers}

    start = time.perf_counter()
    int8_enc = load_slip_encoder(dtype="int8", device="cuda", seed=0).encoder
    bf16_enc = load_slip_encoder(dtype="bfloat16", device="cuda", seed=0,
                                 fused_block=True).encoder
    print(f"slip: loaded int8 and bf16 SLIP ViT-B/16 in {time.perf_counter() - start:.1f} s "
          f"(fused_block {int8_enc.fused_block} / {bf16_enc.fused_block}, fused_attention "
          f"{int8_enc.fused_attention} / {bf16_enc.fused_attention})")

    def encode(enc, fused_block):
        """Both towers through the encoder with fused_block set (the module
        path when False)."""
        enc.fused_block = fused_block
        return enc.encode_video(video), enc.encode_text(text)

    paths, emb = {}, {}
    zero()
    int8_enc.calibrate(video, calib_text)
    paths["slip_calibrate"] = counters()
    for tag, enc, fused_block in (("int8_fused", int8_enc, True), ("bf16_fused", bf16_enc, True),
                                  ("bf16_module", bf16_enc, False),
                                  ("int8_module", int8_enc, False)):
        zero()
        emb[tag] = encode(enc, fused_block)
        paths[f"slip_{tag}_encode"] = counters()
    print(f"slip: launches per path (nonzero counts) "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    per_tower = 2 * LAYERS
    for path, want in (
            ("slip_calibrate", expect(fused_attention_qkv=per_tower)),
            ("slip_int8_fused_encode", expect(**{k: n * per_tower
                                                 for k, n in INT8_LAUNCHES_PER_LAYER.items()})),
            ("slip_bf16_fused_encode", expect(**k2_launches(LAYERS))),
            ("slip_bf16_module_encode", expect(fused_attention_qkv=per_tower)),
            ("slip_int8_module_encode", expect(fused_int8_qkv_attention=per_tower,
                                               int8_gemm_bias=3 * per_tower))):
        require(paths[path] == want, f"{path} launches {paths[path]}, expected {want}")

    # Gate (i): each kernel path against the same model through the plain versions
    # (the fused paths per frame, through slip_fast, as phase 4 compares K1).
    frames = int8_enc._prepare_frames(video)
    kernel, plain = dict(emb), {}
    for tag, enc, layer in (("int8_fused", int8_enc, K.fused_int8_layer_plain),
                            ("bf16_fused", bf16_enc, K.fused_bf16_layer_plain)):
        kernel[tag] = (slip_fast.encode_frames_fast(enc.model, frames),
                       slip_fast.encode_text_fast(enc.model, text))
        plain[tag] = (slip_fast.encode_frames_fast(enc.model, frames, layer_fn=layer),
                      slip_fast.encode_text_fast(enc.model, text, layer_fn=layer))
    zero()
    with swapped(model_module, fused_attention_qkv=A.attention_core_plain):
        plain["bf16_module"] = encode(bf16_enc, False)
    with swapped(model_module, fused_int8_qkv_attention=A.fused_int8_qkv_attention_plain), \
            swapped(K, int8_gemm_bias=K.int8_gemm_bias_plain):
        plain["int8_module"] = encode(int8_enc, False)
    require(counters() == expect(), "the plain SLIP paths launched a kernel")
    for tag in plain:
        for tower, cos in tower_cosines(kernel[tag], plain[tag]).items():
            print(f"slip gate (i) {tag} {tower}: kernels vs plain on the card, "
                  f"min cosine {cos:.6f}")
            require(cos > GATE_COSINE, f"SLIP {tag} {tower}: kernel vs plain cosine {cos}")
    # Gate (ii): int8 against bf16 (scripts/bench_families.py's gate); (iii) K8 against K1.
    for gate, (a, b) in (("(ii) int8 fused_block vs bf16 module path", ("int8_fused", "bf16_module")),
                         ("(iii) int8 module path (K8) vs int8 fused_block (K1)",
                          ("int8_module", "int8_fused"))):
        for tower, cos in tower_cosines(emb[a], emb[b]).items():
            print(f"slip gate {gate} {tower}: min cosine {cos:.6f}")
            require(cos > GATE_COSINE, f"SLIP gate {gate} {tower}: cosine {cos}")
    for tag, (v, t) in emb.items():
        require(v.shape == (video.shape[0], 512) and t.shape == (text.shape[0], 512)
                and bool(torch.isfinite(v).all()) and bool(torch.isfinite(t).all()),
                f"SLIP {tag} embeddings {tuple(v.shape)} / {tuple(t.shape)} not finite")
    del kernel, plain, emb, frames

    rows = torch.from_numpy(token_ids(256, np.random.default_rng(12))).cuda()
    timings = {}
    torch.cuda.empty_cache()
    for tag, enc, fused_block in (("int8_fused", int8_enc, True), ("bf16_fused", bf16_enc, True),
                                  ("bf16_module", bf16_enc, False),
                                  ("int8_module", int8_enc, False)):
        enc.fused_block = fused_block
        torch.cuda.reset_peak_memory_stats()
        timings[f"{tag}_ms"] = cuda_ms(lambda: enc.encode_video(video32), iters=10)
        timings[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        timings[f"{tag}_text_ms"] = cuda_ms(lambda: enc.encode_text(rows), iters=5)
        print(f"slip {tag}: encode_video, 32 clips x 4 frames: {timings[f'{tag}_ms']:.3f} ms, "
              f"{32e3 / timings[f'{tag}_ms']:.1f} clips/s, peak {timings[f'{tag}_peak_gib']:.2f} "
              f"GiB; encode_text, 256 rows x 77: {timings[f'{tag}_text_ms']:.3f} ms, "
              f"{256e3 / timings[f'{tag}_text_ms']:.1f} rows/s")
    print_profile(torch, "slip int8 module path (K8) encode_video",
                  lambda: int8_enc.encode_video(video32), mma=("attention_mma_kernel",),
                  kernels=(INT8_GEMM,))
    return paths, timings


def train_steps_only(torch, package: Path) -> int:
    """``--train-steps [DIR]``: phase 6 (d) alone, for the fitclip_torch package
    under DIR (default: this checkout), so that two trees' steps are timed by the
    same code in one run. Prints the card, the timings and their profiles, and
    one JSON line of the timings."""
    sys.path.insert(0, str(package))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.load import LoadedEncoder, load_clip_encoder

    print(f"train steps of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}; clocks {clocks()}")
    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    rng = np.random.default_rng(2)
    with torch.no_grad():
        teacher = load_clip_encoder("ViT-B/16", dtype="int8", device="cuda", seed=0).encoder
        teacher.fold_pixel_normalization()
        teacher.calibrate(torch.from_numpy(rng.integers(0, 256, (8, 4, 224, 224, 3),
                                                        dtype=np.uint8)).cuda(),
                          torch.from_numpy(token_ids(32, rng)).cuda())
    student = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0)

    def clips(n):
        return rng.integers(0, 256, size=(n, 4, 224, 224, 3), dtype=np.uint8)

    sub = lambda: {"video_student": clips(8), "text_student": token_ids(8, rng)}  # noqa: E731
    ts_batch = {half: {**part, "video_teacher": part["video_student"],
                       "text_teacher": part["text_student"]}
                for half, part in (("labeled", sub()), ("unlabeled", sub()))}
    timings = step_timings(torch, student, LoadedEncoder(teacher),
                           {"video": clips(32), "text": token_ids(32, rng)}, ts_batch)
    print(json.dumps({"train_steps": timings, "package": str(package)}))
    return 0


def row_passes_only(torch, package: Path) -> int:
    """``--row-passes [DIR]``: the two row passes alone for the fitclip_torch
    package under DIR (default: this checkout), so that two trees' kernels are
    read by the same helper in one run: every LayerNorm mode (K1's ln_quant,
    K2's ln_cast, S1's one, fold and cast) at M = 6304 and 25,216 x 768 from bf16
    and fp32 and at S1's M = 100,864 from bf16, and S2's amax pass at 512 x 197 x
    2304, blocks 1, 2 and 3; each held to its plain version, then timed by
    device_ms beside its library call (F.layer_norm, vector_norm). Prints one
    JSON line of {case: device ms}."""
    sys.path.insert(0, str(package))
    import torch.nn.functional as F

    from fitclip_torch import _build
    from fitclip_torch.bench import attn_int8 as S2
    from fitclip_torch.bench import kernels as P
    from fitclip_torch.ops import block as K

    print(f"row passes of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}; clocks {clocks()}")
    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    checks, readings = KernelChecks(), {}
    gen = torch.Generator(device="cuda").manual_seed(16)
    inv = 127.0 / 4.0
    for m, dtypes in ((VISION["batch"] * VISION["seq"], (torch.bfloat16, torch.float32)),
                      (ENCODE_ROWS, (torch.bfloat16, torch.float32)),
                      (S2.FRAMES * S2.SEQ, (torch.bfloat16,))):
        for dtype in dtypes:
            x, gamma, beta, modes = ln_rows(torch, K, m, 768, dtype, gen, inv)
            what = f"{m} x 768 {str(dtype)[6:]}"
            for name, (kernel, plain) in modes.items():
                check = checks.float if name == "ln_cast" else checks.int8
                check(name, what, kernel(x), plain(x))
                readings[f"{name} {what}"] = device_ms(kernel, x)
            g, b = (gamma, beta) if dtype == torch.float32 else (gamma.bfloat16(), beta.bfloat16())
            readings[f"F.layer_norm {what}"] = device_ms(F.layer_norm, x, (768,), g, b, K.LN_EPS)
            del x, modes
    qkv = S2.make_qkv(S2.FRAMES)
    what = f"{S2.FRAMES} x {S2.SEQ} x {3 * S2.WIDTH}"
    for block in (1, 2, 3):
        require(torch.equal(P.attn_amax(qkv, block), P.attn_amax_plain(qkv, block)),
                f"attn_amax block {block}: not equal to the plain version")
        readings[f"attn_amax {what} block {block}"] = device_ms(P.attn_amax, qkv, block)
    parts = qkv.view(S2.FRAMES, S2.SEQ, 3, S2.WIDTH)
    readings[f"vector_norm {what}"] = device_ms(
        lambda t: torch.linalg.vector_norm(t, float("inf"), dim=(1, 3)), parts)
    for case, ms in readings.items():
        print(f"  {case}: device {ms:.4f} ms")
    print(json.dumps({"row_passes_device_ms": readings, "package": str(package),
                      "card": nvidia_smi()}))
    return 0


def bench_arms_only(torch, package: Path) -> int:
    """``--bench-arms [DIR]``: bench_arms.cu's s8 attention and slice-requant
    alone for the fitclip_torch package under DIR (default: this checkout), so
    that two trees' kernels are timed by the same code in one run: phase 3's
    rows of both s8 arms (512 x 197 x 2304, block 1, held at 8 x 257 too) and
    of slice-requant (32 x 785 x 2304, bf16 and fp32), by events and device
    time (cold L2) beside their bounds (s8_slice_rows, its equality and body
    checks recorded, not required); the `bf16` arm (K3f's qkv mode,
    attention_mma_kernel) at 512 x 197 x 2304 by device time, the s8 arms'
    yardstick; S2's default cases through fitclip_torch.bench.attn_int8.run
    (ms, tflops, min_cosine_vs_fp32) and S3's slice arms (`noattn`, `notime`,
    `nospace`, `nocls`, beside `full`) through bench/fit_block.py. Prints one
    JSON line of the readings with the card and its clocks."""
    sys.path.insert(0, str(package))
    from fitclip_torch import _build
    from fitclip_torch.bench import attn_int8 as S2
    from fitclip_torch.bench import fit_block as S3
    from fitclip_torch.bench import kernels as P
    from fitclip_torch.ops import attention as A

    print(f"bench arms of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}; clocks {clocks()}")
    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    torch.set_grad_enabled(False)
    checks = KernelChecks()
    qkv = S2.make_qkv(S2.FRAMES)
    scales = P.attn_amax(qkv, 1)
    rows = s8_slice_rows(torch, checks, qkv, scales, strict=False)
    scale = (S2.WIDTH // S2.HEADS) ** -0.5
    checks.float("bf16 arm", f"{S2.FRAMES} x {S2.SEQ} x {3 * S2.WIDTH}",
                 A.fused_attention_qkv(qkv, S2.HEADS, scale),
                 A.attention_core_plain(qkv, S2.HEADS, scale, False).float())
    rows["bf16_arm"] = {"shape": f"{S2.FRAMES} x {S2.SEQ} x {3 * S2.WIDTH}, qkv mode",
                        "kernel": "attention_mma_kernel",
                        "device_ms": device_ms(A.fused_attention_qkv, qkv, S2.HEADS, scale)}
    del qkv, scales
    for name, entry in rows.items():
        if name == "bf16_arm":
            print(f"  bf16 arm at {entry['shape']}: device {entry['device_ms']:.4f} ms")
        else:
            print_row(name, entry)
    print(f"clocks (benches): {clocks()}")
    s2 = list(S2.run(S2.DEFAULT_CASES))
    s3 = list(S3.run("full,noattn,notime,nospace,nocls"))
    for record in s2 + s3:
        print(f"  {json.dumps(record)}")
    print(json.dumps({"bench_arms": rows, "s2": s2, "s3": s3, "package": str(package),
                      "card": nvidia_smi(), "clocks": clocks()}))
    return 0


def stem_cls_only(torch, package: Path) -> int:
    """``--stem-cls [DIR]``: the S3D-G stem (K7) and K4's CLS row alone for the
    fitclip_torch package under DIR (default: this checkout), so that two
    trees' kernels are timed by the same code in one run: phase 3's stem row
    (32 clips x 16 frames of 224^2; events, and the stem kernel's own device
    time) and the CLS rows on FiT base's joint 32 x 785 x 2304 qkv in bf16 and
    fp32 (events and device time, cold L2), each held to its plain version
    (recorded); then the MIL-NCE bf16 and int8 encodes (32 clips x 16 frames;
    int8 calibrated on 8 clips), VideoCLIP's (8 videos x 32 frames) and FiT
    base int8's (32 clips x 4 frames, calibrated on 8): the median, min and
    max of 5 CUDA-event readings of 10 calls each (and each reading), the
    host's time to issue one call on an idle card before each reading, and
    the kernels' device ms per call and busy share from a profile of 3 calls.
    Prints one JSON line of the readings with the card and its clocks."""
    sys.path.insert(0, str(package))
    from fitclip_torch import _build
    from fitclip_torch.models.frozen_in_time.load import load_frozen_in_time_encoder
    from fitclip_torch.models.mil_nce import load_mil_nce_encoder
    from fitclip_torch.models.videoclip import load_videoclip_encoder
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import s3dg_stem as S

    print(f"stem and CLS of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}; clocks {clocks()}")
    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    torch.set_grad_enabled(False)
    checks = KernelChecks()
    rows = s3dg_kernel_phase(torch, checks, S)
    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = (1.5 * torch.randn(FIT["clips"], 1 + FIT["frames"] * FIT["patches"], 3 * FIT["width"],
                             generator=gen, device="cuda")).to(torch.bfloat16)
    rows["fit_cls_attention_int8"] = cls_row(torch, checks, A, qkv)
    rows["fit_cls_attention_int8"]["fp32"] = cls_row(torch, checks, A, qkv.float())
    del qkv
    for name, entry in rows.items():
        # The rows name no kernel: the tree under DIR may run another one.
        entry.pop("kernel", None)
        entry.get("fp32", {}).pop("kernel", None)
        print_row(name, entry)
        if "fp32" in entry:
            print_row(name, entry["fp32"])
    print(f"  largest error against the plain versions: {checks.max_abs_err}")
    torch.cuda.empty_cache()
    print(f"clocks (encodes): {clocks()}")
    encode = {}
    m, v = MIL_NCE, VIDEOCLIP

    def host_ms(fn):
        """The host's time to issue one call on an idle card (the least of 3):
        where it reaches the device time, the host paces the calls."""
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        return min(times)

    def reading(fn, items):
        runs, hosts = [], []
        for _ in range(5):
            hosts.append(host_ms(fn))
            runs.append(cuda_ms(fn, iters=10))
        ms = sorted(runs)[2]
        kernels, busy = profile_ms(torch, fn)
        return {"ms": ms, "ms_min": min(runs), "ms_max": max(runs), "per_s": items * 1e3 / ms,
                "device_ms": sum(kernels.values()), "busy": busy, "runs": runs,
                "host_ms": hosts}

    def uint8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)

    video, vc_video = (uint8(m["clips"], m["frames"], m["size"], m["size"], 3),
                       uint8(v["videos"], v["frames"], m["size"], m["size"], 3))
    for dtype in ("bfloat16", "int8"):
        enc = load_mil_nce_encoder(dtype=dtype, device="cuda", seed=0).encoder
        if dtype == "int8":
            enc.calibrate(video[:m["calib"]])
        encode[f"mil_nce_{dtype}"] = reading(lambda: enc.encode_video(video), m["clips"])
        del enc
    enc = load_videoclip_encoder(dtype="bfloat16", device="cuda", seed=0).encoder
    encode["videoclip_bfloat16"] = reading(lambda: enc.encode_video(vc_video), v["videos"])
    del enc, video, vc_video
    torch.cuda.empty_cache()
    clips = fit_video(torch, FIT["clips"])
    enc = load_frozen_in_time_encoder(dtype="int8", device="cuda", seed=0).encoder
    enc.calibrate(clips[:8])
    encode["fit_int8"] = reading(lambda: enc.encode_video(clips), FIT["clips"])
    del enc
    for name, entry in encode.items():
        print(f"  {name} encode_video: {json.dumps(entry)}")
    print(json.dumps({"stem_cls": rows, "encode": encode, "package": str(package),
                      "card": nvidia_smi(), "clocks": clocks()}))
    return 0


# Phase 11: the eval CLI (python -m fitclip_torch command=evaluate ... data=msrvtt).
EVAL_VIDEOS = 72  # not a multiple of the eval batch of 32: the last batch is short
EVAL_BATCH = 32
EVAL_FRAMES, EVAL_SIZE, EVAL_FPS = 96, (320, 240), 30.0  # MSR-VTT's 320 x 240 at 30 fps
CAPTION_WORDS = ("man", "woman", "dog", "cat", "car", "ball", "kitchen", "street", "guitar",
                 "song", "game", "water", "horse", "child", "cooking", "running", "talking",
                 "playing", "singing", "driving", "red", "blue", "green", "small")
DRIFT_ITEMS, DRIFT_FRAMES = 32, 48  # each of CC3M's and WebVid's val trees in data=drift_eval


def write_avi(path: Path, rng: np.random.Generator, frames: int = EVAL_FRAMES,
              fourcc: str = "MJPG") -> None:
    """A seeded MJPG AVI (or another codec in the container the name gives:
    mp4v in an .mp4) of distinct content: a low-resolution random image,
    upscaled and drifting a few pixels a frame."""
    import cv2

    width, height = EVAL_SIZE
    base = cv2.resize(rng.integers(0, 256, (12, 16, 3), dtype=np.uint8), (width, height),
                      interpolation=cv2.INTER_LINEAR)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), EVAL_FPS, EVAL_SIZE)
    require(writer.isOpened(), f"cv2 cannot write {fourcc} to {path.suffix} here")
    for t in range(frames):
        writer.write(np.roll(base, (t, 2 * t), axis=(0, 1)))
    writer.release()


def write_msrvtt_tree(root: Path, seed: int = 0):
    """An MSR-VTT tree as MsrVttDataModule reads it (videos/all,
    annotation/MSR_VTT.json, structured-symlinks/val_list_jsfusion.txt): 72
    seeded MJPG AVIs of distinct content and distinct captions. Returns (the
    video ids, the captions)."""
    rng = np.random.default_rng(seed)
    videos = root / "videos" / "all"
    videos.mkdir(parents=True, exist_ok=True)
    ids, captions = [], []
    for i in range(EVAL_VIDEOS):
        video_id = f"video{7010 + i}"
        write_avi(videos / f"{video_id}.avi", rng)
        words = rng.choice(CAPTION_WORDS, size=3, replace=False)
        ids.append(video_id)
        captions.append(f"a {words[0]} and a {words[1]} {words[2]} in video {i}")
    (root / "annotation").mkdir(exist_ok=True)
    (root / "annotation" / "MSR_VTT.json").write_text(json.dumps({"annotations": [
        {"image_id": video_id, "caption": caption} for video_id, caption in zip(ids, captions)]}))
    (root / "structured-symlinks").mkdir(exist_ok=True)
    (root / "structured-symlinks" / "val_list_jsfusion.txt").write_text("\n".join(ids))
    require(len(set(captions)) == len(captions), "the captions are not distinct")
    return ids, captions


def write_drift_trees(root: Path, seed: int = 1):
    """The other two members of data=drift_eval: a CC3M val tree (32 JPEGs and
    a comma CSV of caption,url,filename rows whose captions hold commas and
    quotes) and a WebVid val tree (32 MJPG AVIs and a videoid,name CSV).
    Returns the CC3M_VAL_* and WEBVID_VAL_* settings."""
    import cv2

    rng = np.random.default_rng(seed)
    images, videos = root / "cc3m" / "val", root / "webvid" / "val"
    images.mkdir(parents=True)
    videos.mkdir(parents=True)
    cc3m_rows, webvid_rows = [], ["videoid,name,page_dir"]
    for i in range(DRIFT_ITEMS):
        words = rng.choice(CAPTION_WORDS, size=3, replace=False)
        cv2.imwrite(str(images / f"{i:08d}.jpg"), cv2.resize(
            rng.integers(0, 256, (12, 16, 3), dtype=np.uint8), EVAL_SIZE,
            interpolation=cv2.INTER_LINEAR))
        cc3m_rows.append(f'"a {words[0]}, a {words[1]} and ""{words[2]}"" {i}",'
                         f"http://images.invalid/{i}.jpg,{i:08d}.jpg")
        write_avi(videos / f"{31000 + i}.avi", rng, frames=DRIFT_FRAMES)
        webvid_rows.append(f'{31000 + i},"the {words[0]}, {words[2]} clip {i}",dir{i % 4}')
    (root / "cc3m" / "val.csv").write_text("\n".join(cc3m_rows) + "\n")
    (root / "webvid" / "val.csv").write_text("\n".join(webvid_rows) + "\n")
    return {"CC3M_VAL_TSV": str(root / "cc3m" / "val.csv"), "CC3M_VAL_IMAGES": str(images),
            "WEBVID_VAL_CSV": str(root / "webvid" / "val.csv"),
            "WEBVID_VAL_VIDEOS": str(videos)}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def cli_run(torch, wrappers, argv):
    """fitclip_torch.cli.main.main(argv) in this process, the launch counts
    zeroed just before and read just after: (stdout, runner log lines, wall
    seconds, launches)."""
    import io

    from fitclip_torch.cli.main import main as cli_main

    records = _Records()
    logging.getLogger("fitclip_torch.cli.runners").addHandler(records)
    out = io.StringIO()
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli_main(argv)
        torch.cuda.synchronize()
    finally:
        logging.getLogger("fitclip_torch.cli.runners").removeHandler(records)
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(out.getvalue().rstrip())
    for message in records.messages:
        print(f"  runner: {message}")
    return out.getvalue(), records.messages, seconds, launches


WINDOW_BATCHES = 8  # the warmed window: batches after a first one, cycling over the tree


def warm_eval_window(torch, root: Path, merges: str, scales: Path):
    """Where a warmed eval batch's time goes. (a) Each host stage of an item, run
    serially over every clip: reader open, sampling and decode, the transform;
    then collating a batch and copying it to the card. (b) A running loader's
    window of WINDOW_BATCHES full batches after a first one (the CLI's loop:
    next batch, copy, both towers; synchronised once at its end): clips/s, the
    time the loop waits on the loader and the time it takes to issue the copy
    and encodes (beside the same issued before any loader thread starts); then
    the next window under the profiler for the device's busy share. Returns
    the readings (ms and s as measured)."""
    from fitclip_torch.cli.runners import _video_text
    from fitclip_torch.data.datasets.msrvtt import MsrVttDataModule
    from fitclip_torch.data.loader import DataLoader, item_rng
    from fitclip_torch.data.video_reader import VideoReader
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.ops.quant import load_act_scales
    from fitclip_torch.utils.profiling import StageTimer

    start = time.perf_counter()
    fused = load_clip_encoder("ViT-B/16", dtype="int8", device="cuda", seed=0,
                              bpe_path=merges)
    load_s = time.perf_counter() - start
    load_act_scales(str(scales), fused.encoder.model)
    loader = MsrVttDataModule(base_path=str(root), encoder=fused,
                              eval_batch_size=EVAL_BATCH).val_dataloader()
    dataset, pipeline = loader.dataset, loader.dataset.pipelines["video"]
    stage_s = {"open": [], "decode": [], "transform": []}
    for index in range(len(dataset)):
        t0 = time.perf_counter()
        reader = VideoReader.from_path(dataset.video_paths[index])
        end_frame = len(reader) - 1
        t1 = time.perf_counter()
        frames = reader(pipeline.sampler(0, end_frame, fps=reader.get_avg_fps(),
                                         rng=item_rng(loader.seed, 0, index)))
        t2 = time.perf_counter()
        pipeline.transform(frames, None)
        t3 = time.perf_counter()
        for key, seconds in zip(stage_s, (t1 - t0, t2 - t1, t3 - t2)):
            stage_s[key].append(seconds)
        del reader
    stages = {key: 1e3 * float(np.median(v)) for key, v in stage_s.items()}
    items = [loader._load_item(i) for i in range(EVAL_BATCH)]
    collate_ms, copy_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        batch = loader.collate(items)
        collate_ms.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _video_text(batch, torch.device("cuda"))
        torch.cuda.synchronize()
        copy_ms.append(1e3 * (time.perf_counter() - t0))
    stages.update(collate=float(np.median(collate_ms)), copy=float(np.median(copy_ms)))

    n = len(dataset)
    # A first batch, the window unprofiled, then profile_ms's warm call and its call.
    order = [[(b * EVAL_BATCH + i) % n for i in range(EVAL_BATCH)]
             for b in range(1 + 3 * WINDOW_BATCHES)]
    records = []  # (wall, waiting on the loader, issuing copy and encodes) per window, s

    def encode(batch):
        video, text, _, _ = _video_text(batch, torch.device("cuda"))
        fused.encode_video(video)
        fused.encode_text(text)

    idle_issue = []  # the copy and encodes issued before any loader thread starts
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(batch)
        idle_issue.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    idle_issue = idle_issue[1:]
    steady = DataLoader(dataset, collate=loader.collate, batch_sampler=order,
                        num_threads=loader.num_threads)
    batches_iter = iter(steady)

    def window():
        timer, start = StageTimer(), time.perf_counter()
        for _ in range(WINDOW_BATCHES):
            with timer.stage("wait"):
                batch = next(batches_iter)
            with timer.stage("issue"):
                encode(batch)
        torch.cuda.synchronize()
        records.append((time.perf_counter() - start, timer.totals["wait"],
                        timer.totals["issue"]))

    encode(next(batches_iter))
    torch.cuda.synchronize()
    window()
    per_kernel, busy = profile_ms(torch, window, calls=1)
    ms = [1e3 * v / WINDOW_BATCHES for v in records[0]]
    profiled_wall_ms = 1e3 * records[-1][0] / WINDOW_BATCHES
    device_ms = sum(per_kernel.values()) / WINDOW_BATCHES
    result = {"encoder_load_s": load_s, "item_ms_median": stages,
              "item_ms_per_batch_on_threads": EVAL_BATCH * sum(
                  stages[k] for k in ("open", "decode", "transform")) / loader.num_threads,
              "threads": loader.num_threads, "window_batches": WINDOW_BATCHES,
              "batch_wall_ms": ms[0], "batch_wait_ms": ms[1], "batch_issue_ms": ms[2],
              "batch_issue_ms_no_loader": 1e3 * float(np.median(idle_issue)),
              "clips_per_s": EVAL_BATCH / ms[0] * 1e3,
              "profiled_batch_wall_ms": profiled_wall_ms, "batch_device_ms": device_ms,
              "busy_share": busy}
    print(f"eval cli: the seeded ViT-B/16 int8 load {load_s:.3f} s; one item's host stages, "
          f"median over {n} clips, serial (ms): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stages.items() if k in stage_s)
          + f"; a batch of {EVAL_BATCH}: collate {stages['collate']:.3f} ms, copy to the "
          f"card {stages['copy']:.3f} ms; the items' stages spread over {loader.num_threads} "
          f"threads at best {result['item_ms_per_batch_on_threads']:.3f} ms a batch")
    print(f"eval cli: a warmed window of {WINDOW_BATCHES} batches of {EVAL_BATCH} (after a "
          f"first one), a batch: {ms[0]:.3f} ms wall, {ms[1]:.3f} waiting on the loader, "
          f"{ms[2]:.3f} issuing the copy and both encodes (before any loader thread ran: "
          f"{result['batch_issue_ms_no_loader']:.3f}); {result['clips_per_s']:.1f} clips/s "
          f"with decode. Profiled: {profiled_wall_ms:.3f} ms wall, device {device_ms:.3f} ms, "
          f"busy share {busy:.3f}")
    del fused, batches_iter, steady
    return result


def eval_cli_phase(torch, wrappers, work: Path):
    """Phase 11: write the MSR-VTT tree under ``work``, run ``command=evaluate
    encoder=clip_vit_b_16 ++encoder.dtype=int8 data=msrvtt ++quant.calibration_batches=1``
    and then ``command=predict`` (the persisted scales) through the CLI, then
    ``data=drift_eval`` with those scales, and gate them. Returns the launch
    counts per command and what phase 12 serves from (the tree, the BPE merges,
    the scales, predict's dump)."""
    import os

    from fitclip_torch.data import native
    from fitclip_torch.data.datasets.msrvtt import MsrVttDataModule
    from fitclip_torch.data.video_reader import VideoReader
    from fitclip_torch.evaluation.retrieval import retrieval_metrics
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab
    from fitclip_torch.ops.metrics import ranks_from_scores
    from fitclip_torch.ops.quant import load_act_scales

    shutil.rmtree(work, ignore_errors=True)
    root = work / "msrvtt"
    start = time.perf_counter()
    ids, captions = write_msrvtt_tree(root)
    size_mb = sum(p.stat().st_size for p in root.rglob("*") if p.is_file()) / 1e6
    merges, _ = write_tiny_test_vocab(str(work), [w for c in captions for w in c.split()])
    print(f"eval cli: wrote {len(ids)} MJPG AVIs ({EVAL_FRAMES} frames of "
          f"{EVAL_SIZE[0]}x{EVAL_SIZE[1]}), {size_mb:.1f} MB, and a BPE vocabulary over the "
          f"captions' words in {time.perf_counter() - start:.1f} s")
    try:
        native.load_decoder()
        native_note = "the native decoder built"
    except ImportError as e:
        native_note = f"the native decoder does not build here ({str(e).splitlines()[0]})"
    reader = VideoReader.from_path(root / "videos" / "all" / f"{ids[0]}.avi")
    print(f"eval cli: decoder {type(reader).__name__} ({native_note})")
    del reader

    os.environ["MSRVTT_PATH"] = str(root)
    scales = work / "act_scales.npz"
    common = ["encoder=clip_vit_b_16", "++encoder.dtype=int8", "data=msrvtt",
              f"+encoder.bpe_path={merges}", f"++quant.scales_path={scales}"]
    evaluate = ["command=evaluate", *common, "++quant.calibration_batches=1"]
    print(f"eval cli: python -m fitclip_torch {' '.join(evaluate)}")
    out, messages, eval_s, eval_launches = cli_run(torch, wrappers, evaluate)
    metrics = json.loads(out[out.index("{"):])
    predictions_path = work / "predictions.pt"
    predict = ["command=predict", *common, f"+output_path={predictions_path}"]
    print(f"eval cli: python -m fitclip_torch {' '.join(predict)}")
    _, predict_messages, predict_s, predict_launches = cli_run(torch, wrappers, predict)
    predictions = torch.load(predictions_path, weights_only=False)
    videos, texts = predictions["encoded_videos"], predictions["encoded_texts"]
    print(f"eval cli: evaluate {eval_s:.2f} s wall (encoder load, calibration on one "
          f"batch, {len(ids)} clips), predict {predict_s:.2f} s wall")

    # Gate (i): the printed metrics are the rank math of predict's embeddings.
    require(predictions["video_ids"] == ids and videos.shape[0] == len(ids)
            and texts.shape == videos.shape,
            f"predictions: {videos.shape}, {texts.shape}, ids in order "
            f"{predictions['video_ids'] == ids}")
    scores = texts.float() @ videos.float().T
    recomputed = retrieval_metrics(ranks_from_scores(scores, torch.arange(len(ids))))
    print(f"eval cli gate (i): printed {metrics}, recomputed from predict {recomputed}")
    require(metrics == recomputed, f"printed metrics {metrics} != recomputed {recomputed}")
    # Gate (iv): the text embeddings are finite.
    require(bool(torch.isfinite(texts).all()) and bool(torch.isfinite(videos).all()),
            "non-finite embeddings")

    # Gate (iii): K1's seven launches per layer, 12 + 12 layers, per eval batch;
    # the calibration pass (the module path in dynamic mode: fused_attention_qkv
    # once per layer) is left out of K1's count.
    batches = -(-len(ids) // EVAL_BATCH)
    expected = {name: 0 for name in wrappers}
    expected.update({name: n * 2 * LAYERS * batches
                     for name, n in INT8_LAUNCHES_PER_LAYER.items()})
    calibration = {"fused_attention_qkv": 2 * LAYERS}
    print(f"eval cli gate (iii): evaluate launches "
          f"{({k: n for k, n in eval_launches.items() if n})}, predict launches "
          f"{({k: n for k, n in predict_launches.items() if n})}; K1 expected per run "
          f"{({k: n for k, n in expected.items() if n})} ({batches} batches), the "
          f"calibration {calibration}")
    require(eval_launches == {**expected, **calibration},
            f"evaluate launches {eval_launches}")
    require(predict_launches == expected, f"predict launches {predict_launches}")

    # Gate (ii): predict's video embeddings against the plain versions
    # (fused_attention=False: the module path) with the same scales, on the same
    # clips; gate (v): no decoded clip is all zeros.
    plain = load_clip_encoder("ViT-B/16", dtype="int8", device="cuda", seed=0,
                              fused_attention=False, bpe_path=merges)
    load_act_scales(str(scales), plain.encoder.model)
    loader = MsrVttDataModule(base_path=str(root), encoder=plain,
                              eval_batch_size=EVAL_BATCH).val_dataloader()
    plain_videos, zero_clips = [], 0
    for batch in loader:
        clips = batch["video"]
        zero_clips += int((clips.reshape(clips.shape[0], -1).max(axis=1) == 0).sum())
        plain_videos.append(plain.encode_video(torch.from_numpy(clips).cuda()).float().cpu())
    cos = min_cosine(videos, torch.cat(plain_videos))
    print(f"eval cli gate (ii): predict video embeddings vs the plain versions, min "
          f"cosine {cos:.6f}; gate (v): {zero_clips} all-zero clips of {len(ids)}")
    require(cos > GATE_COSINE, f"eval cli: kernels vs plain versions cosine {cos}")
    require(zero_clips == 0, f"{zero_clips} decoded clips are all zeros")
    del plain

    # Grouped eval: data=drift_eval (CC3M, MSR-VTT, WebVid) with the persisted
    # scales. Its _msrvtt metrics are evaluate's: the same scales, clips and texts.
    start = time.perf_counter()
    os.environ.update(write_drift_trees(work))
    print(f"eval cli: wrote CC3M and WebVid val trees of {DRIFT_ITEMS} JPEGs and "
          f"{DRIFT_ITEMS} AVIs in {time.perf_counter() - start:.1f} s")
    drift = ["command=evaluate", "encoder=clip_vit_b_16", "++encoder.dtype=int8",
             "data=drift_eval", f"+encoder.bpe_path={merges}", f"++quant.scales_path={scales}"]
    print(f"eval cli: python -m fitclip_torch {' '.join(drift)}")
    out, _, drift_s, drift_launches = cli_run(torch, wrappers, drift)
    grouped = json.loads(out[out.index("{"):])
    names = ("cc3m", "msrvtt", "webvid")
    drift_batches = 1 + batches + 1
    drift_expected = {name: 0 for name in wrappers}
    drift_expected.update({name: n * 2 * LAYERS * drift_batches
                           for name, n in INT8_LAUNCHES_PER_LAYER.items()})
    print(f"eval cli grouped gate: {drift_s:.2f} s wall; printed {grouped}; launches "
          f"{({k: n for k, n in drift_launches.items() if n})} ({drift_batches} batches)")
    require(sorted(grouped) == sorted(f"{k}_{name}" for k in metrics for name in names),
            f"drift_eval keys {sorted(grouped)}")
    require({k: grouped[f"{k}_msrvtt"] for k in metrics} == metrics,
            f"drift_eval's msrvtt metrics differ from evaluate's {metrics}")
    require(all(np.isfinite(v) for v in grouped.values()), "non-finite grouped metrics")
    require(drift_launches == drift_expected, f"drift_eval launches {drift_launches}")

    # A warmed window, split. Every clip has been read three times by now (the
    # files sit in the page cache) and CUDA is warm.
    window = warm_eval_window(torch, root, merges, scales)
    rate = [m for m in predict_messages if m.startswith("Encoded")]
    print(f"eval cli: predict's loop (cold: its first batch has nothing to overlap; 3 "
          f"batches): {rate[0] if rate else 'no reading'}; evaluate's: "
          f"{[m for m in messages if m.startswith('Evaluated')]} "
          f"(clocks {clocks()}; {nvidia_smi()})")
    print(json.dumps({"eval_cli_window": window, "card": nvidia_smi()}))
    tree = {"root": root, "ids": ids, "captions": captions, "merges": merges,
            "scales": scales, "predictions": predictions_path}
    return {"eval_cli": eval_launches, "predict_cli": predict_launches,
            "drift_eval_cli": drift_launches}, tree


# Phase 12: the embed service (python -m fitclip_torch.serving.embed_service).
SERVE_TEXT_BUCKETS, SERVE_VIDEO_BUCKETS = (1, 2, 4, 8, 16, 32), (1, 2, 4, 8)
SERVE_CLIENTS, SERVE_REQUESTS = 32, 4  # traffic (b): threads x requests of 1-4 texts
SERVE_SERIAL, SERVE_VIDEOS, SERVE_VIDEO_THREADS, SERVE_QUERIES = 64, 16, 4, 8
SERVE_MAX_VIDEO_MB = 2
SERVE_GATE_EAGER = 0.9999  # served against the eager kernel path on the same inputs


def percentiles(seconds) -> str:
    ms = 1e3 * np.asarray(seconds)
    return f"p50 {np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms"


def http(url: str, body: bytes = None):
    """(status, parsed JSON body, seconds, seconds to connect) of one request
    to the local service, on a connection of its own (as urllib opens one)."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    start = time.perf_counter()
    connection = http.client.HTTPConnection(parts.hostname, parts.port, timeout=120)
    try:
        connection.connect()
        connected = time.perf_counter()
        target = parts.path + (f"?{parts.query}" if parts.query else "")
        connection.request("POST" if body is not None else "GET", target, body=body)
        reply = connection.getresponse()
        status, payload = reply.status, reply.read()
    finally:
        connection.close()
    end = time.perf_counter()
    return status, json.loads(payload), end - start, connected - start


def serve_texts(rng: np.random.Generator, n: int):
    words = rng.choice(CAPTION_WORDS, size=(n, 3))
    return [f"a {a} with the {b} and a {c}" for a, b, c in words]


def burst(url: str, plans):
    """Traffic (b): one client thread per plan, each posting its requests of
    texts to /embed_text in turn. Returns each client's latencies (s), every
    request's seconds to connect, every (texts, rows) reply, and the wall
    seconds."""
    import threading

    latencies, connects, replies = [[] for _ in plans], [], []
    lock = threading.Lock()

    def client(c):
        for texts in plans[c]:
            status, reply, seconds, connect = http(url + "/embed_text",
                                                   json.dumps({"texts": texts}).encode())
            if status != 200 or len(reply["embeddings"]) != len(texts):
                return
            with lock:
                replies.append((texts, reply["embeddings"]))
                connects.append(connect)
            latencies[c].append(seconds)

    start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,)) for c in range(len(plans))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return latencies, connects, replies, time.perf_counter() - start


def serving_phase(torch, wrappers, tree):
    """Phase 12: the port's embed service on the card, over HTTP on
    127.0.0.1: seeded int8 CLIP ViT-B/16 at full width, phase 11's scales as
    EMBED_SCALES and predict's dump as EMBED_INDEX, one CUDA graph per bucket
    of each tower. Traffic (a)-(e), the readings, and gates (i)-(vi)."""
    import multiprocessing
    import os
    import threading
    from concurrent.futures import ProcessPoolExecutor
    from urllib.parse import urlencode

    from fitclip_torch.data.data_module import build_pipeline
    from fitclip_torch.data.transforms import pad_to_min_frames
    from fitclip_torch.data.video_reader import VideoReader
    from fitclip_torch.models.clip.encoder import l2_normalize
    from fitclip_torch.models.clip.fast_eval import encode_frames_fast, encode_text_fast
    from fitclip_torch.ops import block as K
    from fitclip_torch.serving import embed_service as es
    from fitclip_torch.serving.embed_service import RetrievalIndex

    os.environ.update({
        "EMBED_ENCODER": "clip_vit_b_16",
        "EMBED_OVERRIDES": f"++encoder.dtype=int8 +encoder.bpe_path={tree['merges']}",
        "EMBED_SCALES": str(tree["scales"]), "EMBED_INDEX": str(tree["predictions"]),
        "EMBED_MAX_WAIT_MS": "2", "EMBED_MAX_BATCH": str(SERVE_TEXT_BUCKETS[-1]),
        "EMBED_MAX_VIDEO_BATCH": str(SERVE_VIDEO_BUCKETS[-1]),
        "EMBED_MAX_VIDEO_MB": str(SERVE_MAX_VIDEO_MB)})
    start = time.perf_counter()
    encoder = es._ensure_loaded().encoder
    torch.cuda.synchronize()
    load_s = time.perf_counter() - start
    start = time.perf_counter()
    graphs = es.warm_graphs()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    for fn in wrappers.values():
        fn.launches = 0
    es._ensure_service()
    es._ensure_video_service()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start
    capture_launches = {name: fn.launches for name, fn in wrappers.items()}
    READINGS["serve_setup_s"] = round(setup_s, 3)
    buckets = len(SERVE_TEXT_BUCKETS) + len(SERVE_VIDEO_BUCKETS)
    expected = {name: 0 for name in wrappers}
    expected.update({name: n * LAYERS * buckets for name, n in INT8_LAUNCHES_PER_LAYER.items()})
    print(f"serving: seeded int8 ViT-B/16 loaded in {load_s:.2f} s; set-up to both services "
          f"ready {setup_s:.3f} s (each bucket's eager warm-up {warm_s:.3f} s, then the "
          "captures): " + "; ".join(
              f"{tower} capture ms " + ", ".join(f"{b}: {ms:.1f}"
                                                  for b, ms in g.capture_ms.items())
              for tower, g in graphs.items()))
    print(f"serving gate (iv): launches recorded by the {buckets} captures "
          f"{({k: n for k, n in capture_launches.items() if n})}, expected "
          f"{({k: n for k, n in expected.items() if n})} (84 a bucket)")
    require(capture_launches == expected, f"capture launches {capture_launches}")

    handled = []  # seconds each request spent in the service's handler

    class TimedHandler(es.Handler):
        def _respond(self, method):
            start = time.perf_counter()
            super()._respond(method)
            handled.append(time.perf_counter() - start)

    server = es.EmbedHTTPServer(("127.0.0.1", 0), TimedHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(12)
    served_texts, served_rows, serial_connects = [], [], []
    lock = threading.Lock()
    text_requests = 0

    def embed_text(texts):
        status, reply, seconds, connect = http(url + "/embed_text",
                                               json.dumps({"texts": texts}).encode())
        serial_connects.append(connect)
        require(status == 200 and len(reply["embeddings"]) == len(texts),
                f"/embed_text {status}: {len(reply.get('embeddings', []))} rows for "
                f"{len(texts)} texts")
        with lock:
            served_texts.extend(texts)
            served_rows.extend(reply["embeddings"])
        return seconds

    try:
        for fn in wrappers.values():
            fn.launches = 0
        # (a) one client, serial single texts.
        serial = [embed_text([t]) for t in serve_texts(rng, SERVE_SERIAL)]
        text_requests += SERVE_SERIAL
        # (b) 32 client threads x 4 requests of 1-4 texts, from a process of their own
        # (spawned; it imports numpy only), so that the clients do not share the
        # service's interpreter lock.
        plans = [[serve_texts(np.random.default_rng(100 + c), int(k))
                  for k in np.random.default_rng(200 + c).integers(1, 5, SERVE_REQUESTS)]
                 for c in range(SERVE_CLIENTS)]
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
            handled.clear()
            concurrent, burst_connects, replies, burst_s = pool.submit(
                burst, url, plans).result(timeout=600)
            burst_handled = list(handled)
        for texts, rows in replies:
            served_texts.extend(texts)
            served_rows.extend(rows)
        burst_texts = sum(len(texts) for plan in plans for texts in plan)
        text_requests += burst_texts
        require(all(len(c) == SERVE_REQUESTS for c in concurrent), "a client's request failed")
        # (c) phase 11's AVIs from 4 threads.
        paths = [tree["root"] / "videos" / "all" / f"{i}.avi" for i in tree["ids"][:SERVE_VIDEOS]]
        video_rows, video_s = [None] * SERVE_VIDEOS, [None] * SERVE_VIDEOS

        def video_client(k):
            for i in range(k, SERVE_VIDEOS, SERVE_VIDEO_THREADS):
                status, reply, video_s[i], _ = http(url + "/embed_video?format=avi",
                                                    paths[i].read_bytes())
                require(status == 200, f"/embed_video {status}: {reply}")
                video_rows[i] = reply["embedding"]

        start = time.perf_counter()
        threads = [threading.Thread(target=video_client, args=(k,))
                   for k in range(SERVE_VIDEO_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        videos_s = time.perf_counter() - start
        require(all(row is not None for row in video_rows), "a video request failed")
        # (d) searches, each query also embedded on its own for the host ranking.
        queries = serve_texts(np.random.default_rng(300), SERVE_QUERIES)
        searches = []
        for q in queries:
            embed_text([q])
            status, reply, _, _ = http(url + "/search_videos?" +
                                       urlencode({"q": q, "top_k": 5}))
            require(status == 200, f"/search_videos {status}: {reply}")
            searches.append(reply["results"])
        text_requests += 2 * SERVE_QUERIES
        # (e) refusals.
        refused = [http(url + "/embed_video", b"")[0],
                   http(url + "/embed_video?format=avi", b"not a video")[0],
                   http(url + "/embed_video", b"\0" * (SERVE_MAX_VIDEO_MB * 2 ** 20 + 1))[0],
                   http(url + "/nope")[0]]
        status, health, _, _ = http(url + "/health")
        torch.cuda.synchronize()
        traffic_launches = {name: fn.launches for name, fn in wrappers.items()}
    finally:
        server.shutdown()
        server.server_close()
        for service in (es._SERVICE, es._VIDEO_SERVICE):
            if service is not None:
                service.stop()

    print(f"serving (a) {SERVE_SERIAL} serial /embed_text of one text: {percentiles(serial)}")
    burst_latencies = [s for c in concurrent for s in c]
    print(f"serving: seconds to connect, of (a): {percentiles(serial_connects)}; of (b): "
          f"{percentiles(burst_connects)}; (b)'s requests inside the service's handler: "
          f"{percentiles(burst_handled)}")
    print(f"serving (b) {SERVE_CLIENTS} client threads (another process) x {SERVE_REQUESTS} "
          f"requests of 1-4 texts ({burst_texts} texts): {percentiles(burst_latencies)}; "
          f"{len(burst_latencies) / burst_s:.1f} requests/s, "
          f"{burst_texts / burst_s:.1f} texts/s over {burst_s:.3f} s")
    print(f"serving (c) {SERVE_VIDEOS} /embed_video AVIs from {SERVE_VIDEO_THREADS} threads: "
          f"{percentiles(video_s)}; {SERVE_VIDEOS / videos_s:.2f} clips/s")
    print(f"serving /health: {health}")
    # Gate (iv): every batch of the traffic was a replay.
    print(f"serving gate (iv): launches while traffic ran "
          f"{({k: n for k, n in traffic_launches.items() if n}) or 'none'}")
    require(not any(traffic_launches.values()), f"traffic launched eagerly: {traffic_launches}")
    # Gate (v): the service counted what was sent; no padding row came back.
    print(f"serving gate (v): /health requests {health['requests']} (sent {text_requests} "
          f"texts), video {health['video']['requests']} (sent {SERVE_VIDEOS})")
    require(status == 200 and health["requests"] == text_requests
            and health["video"]["requests"] == SERVE_VIDEOS, f"/health {health}")
    # /search_videos embeds its query inside the service: one text each, no row back.
    require(len(served_rows) == len(served_texts) == text_requests - SERVE_QUERIES,
            f"{len(served_rows)} rows for {len(served_texts)} texts")
    # Gate (vi): the refusals.
    print(f"serving gate (vi): empty, not a video, oversized, unknown path -> {refused}")
    require(refused == [400, 400, 413, 404], f"refusals {refused}")

    # Gate (i): each served text row against encode_text on the same ids.
    model = encoder.model
    tokenizer = encoder.get_tokenizer()
    served = torch.tensor(served_rows, dtype=torch.float32)
    eager, plain = [], []
    with torch.no_grad():
        for i in range(0, len(served_texts), 32):
            ids = torch.from_numpy(tokenizer(served_texts[i:i + 32])).long().cuda()
            eager.append(encoder.encode_text(ids).float().cpu())
            plain.append(l2_normalize(encode_text_fast(
                model, ids, layer_fn=K.fused_int8_layer_plain)).float().cpu())
    eager, plain = torch.cat(eager), torch.cat(plain)
    text_cos, text_plain_cos = min_cosine(served, eager), min_cosine(served, plain)
    print(f"serving gate (i): {len(served_texts)} served texts against encode_text on the "
          f"eager kernel path: min cosine {text_cos:.6f}, max abs diff "
          f"{float((served - eager).abs().max()):.3e}; against the plain versions "
          f"{text_plain_cos:.6f}")
    require(text_cos >= SERVE_GATE_EAGER and text_plain_cos > GATE_COSINE, "served text rows")
    # Gate (ii): each served clip against the eval pipeline and encode_video by hand.
    pipeline = build_pipeline(encoder, train=False)
    frames = encoder.preprocess.num_frames
    clips = []
    for path in paths:
        reader = VideoReader.from_path(path)
        indices = pipeline.sampler(0, len(reader) - 1, fps=reader.get_avg_fps())
        clips.append(pad_to_min_frames(pipeline.transform(reader(indices), None), frames))
    clips = torch.from_numpy(np.stack(clips)).cuda()
    with torch.no_grad():
        eager = torch.cat([encoder.encode_video(clips[i:i + 8]).float()
                           for i in range(0, len(paths), 8)]).cpu()
        flat = encoder._prepare_frames(clips)
        plain = l2_normalize(encode_frames_fast(model, flat, layer_fn=K.fused_int8_layer_plain))
        plain = plain.reshape(len(paths), frames, -1).mean(dim=1).float().cpu()
    served = torch.tensor(video_rows, dtype=torch.float32)
    video_cos, video_plain_cos = min_cosine(served, eager), min_cosine(served, plain)
    print(f"serving gate (ii): {len(paths)} served clips against the eval pipeline and "
          f"encode_video: min cosine {video_cos:.6f}, max abs diff "
          f"{float((served - eager).abs().max()):.3e}; against the plain versions "
          f"{video_plain_cos:.6f}")
    require(video_cos >= SERVE_GATE_EAGER and video_plain_cos > GATE_COSINE, "served clips")
    # Gate (iii): /search_videos ranks as the host does with the served query.
    index = RetrievalIndex(str(tree["predictions"]))
    rows = {t: r for t, r in zip(served_texts, served_rows)}
    for q, results in zip(queries, searches):
        want = index.search(np.asarray(rows[q], np.float32), 5)
        require([r["video_id"] for r in results] == [r["video_id"] for r in want],
                f"search {q!r}: {results} against {want}")
    print(f"serving gate (iii): {len(queries)} searches rank the index as the host does")

    # Each bucket's replay against the eager kernel-path call at the same batch.
    replay_ms = {}
    with torch.no_grad():
        for tower, g in graphs.items():
            for b in g.bucket_sizes:
                if tower == "text":
                    inputs = torch.from_numpy(tokenizer(serve_texts(rng, b))).long().cuda()
                    eager_fn = lambda x=inputs: encoder.encode_text(x)  # noqa: E731
                else:
                    inputs = clips[:b]
                    eager_fn = lambda x=inputs: encoder.encode_video(x)  # noqa: E731
                replay_ms[f"{tower}_{b}"] = (cuda_ms(lambda g=g, b=b: g.replay(b)),
                                             cuda_ms(eager_fn))
    print("serving: replay ms against the eager kernel path (CUDA events, 20 calls): " +
          ", ".join(f"{k} {r:.3f} / {e:.3f}" for k, (r, e) in replay_ms.items()) +
          f" (clocks {clocks()}; {nvidia_smi()})")
    print(json.dumps({"serving": {
        "load_s": load_s, "setup_s": setup_s, "warm_s": warm_s,
        "capture_ms": {t: g.capture_ms for t, g in graphs.items()},
        "replay_vs_eager_ms": replay_ms,
        "serial_text_ms": [1e3 * float(np.percentile(serial, q)) for q in (50, 99)],
        "burst_ms": [1e3 * float(np.percentile(burst_latencies, q)) for q in (50, 99)],
        "burst_connect_ms": [1e3 * float(np.percentile(burst_connects, q)) for q in (50, 99)],
        "burst_handler_ms": [1e3 * float(np.percentile(burst_handled, q)) for q in (50, 99)],
        "burst_requests_per_s": len(burst_latencies) / burst_s, "burst_texts_per_s": burst_texts / burst_s,
        "video_ms": [1e3 * float(np.percentile(video_s, q)) for q in (50, 99)],
        "clips_per_s": SERVE_VIDEOS / videos_s, "health": health,
        "card": nvidia_smi()}}))
    for name in ("_SERVICE", "_VIDEO_SERVICE", "_INDEX", "_LOADED", "_GRAPHS"):
        setattr(es, name, None)
    return {"serve_capture": capture_launches, "serve_traffic": traffic_launches}


# Phase 13: the train-side CLI (python -m fitclip_torch command=train|tune, sweeps).
TRAIN_VIDEOS, TRAIN_FRAMES = 112, 48  # 4 steps of config/data/webvid.yaml's batch of 28
TRAIN_BATCH = 28
TUNE_LR_STEPS = 3  # the fewest lr_find takes


def write_webvid_train_tree(root: Path, seed: int = 3):
    """A WebVid train tree: 112 seeded mp4v clips of 48 frames named {videoid}.mp4
    (webvid4_5k reads the CSV's ids as .mp4 names) and a videoid,name CSV.
    Returns the WEBVID_TRAIN_* settings."""
    rng = np.random.default_rng(seed)
    videos = root / "webvid" / "train"
    videos.mkdir(parents=True)
    rows = ["videoid,name,page_dir"]
    for i in range(TRAIN_VIDEOS):
        words = rng.choice(CAPTION_WORDS, size=3, replace=False)
        write_avi(videos / f"{41000 + i}.mp4", rng, frames=TRAIN_FRAMES, fourcc="mp4v")
        rows.append(f'{41000 + i},"a {words[0]} with a {words[1]}, {words[2]} {i}",dir{i % 4}')
    (root / "webvid" / "train.csv").write_text("\n".join(rows) + "\n")
    return {"WEBVID_TRAIN_CSV": str(root / "webvid" / "train.csv"),
            "WEBVID_TRAIN_VIDEOS": str(videos),
            "WEBVID_TRAIN_4_5K_CSV": str(root / "webvid" / "train.csv")}


@contextlib.contextmanager
def timed_steps(torch, counters):
    """Wraps the train steps that run_train makes: per step the launches, the
    host's wait for the batch (from the end of the step before, or for the
    first from the step's making, just before the loader starts), the step
    until its loss is on the host, and the wall time from the step before's
    end."""
    from fitclip_torch.training import train_runner

    steps = []
    last = [time.perf_counter()]

    def wrap(make):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)
            last[0] = time.perf_counter()  # the run is built: its loader starts next

            def counted(state, batch):
                start, before = time.perf_counter(), counters()
                state, metrics = step(state, batch)
                float(metrics["loss/train"])
                end = time.perf_counter()
                after = counters()
                steps.append({"launches": {k: after[k] - before[k] for k in after},
                              "wait_ms": (start - last[0]) * 1e3,
                              "step_ms": (end - start) * 1e3,
                              "wall_ms": (end - last[0]) * 1e3, "start": start, "end": end})
                last[0] = end
                return state, metrics
            return counted
        return made

    with swapped(train_runner,
                 make_contrastive_train_step=wrap(train_runner.make_contrastive_train_step),
                 make_teacher_student_train_step=wrap(
                     train_runner.make_teacher_student_train_step)):
        yield steps


def train_cli_run(torch, wrappers, argv, log_dir: Path):
    """cli_run with the steps wrapped: (stdout, wall s, launches of the whole
    run, per-step records, metrics.jsonl entries)."""
    def counters():
        return {name: fn.launches for name, fn in wrappers.items()}

    print(f"train cli: python -m fitclip_torch {' '.join(argv)}")
    with timed_steps(torch, counters) as steps:
        out, _, seconds, launches = cli_run(torch, wrappers, argv)
    entries = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    return out, seconds, launches, steps, entries


def checkpoints_equal(torch, a, b) -> bool:
    """Params, both moments, AdamW count and step of two train-state files."""
    from fitclip_torch.training.checkpointing import load_checkpoint

    a, b = load_checkpoint(str(a)), load_checkpoint(str(b))
    return (a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
            and set(a["params"]) == set(b["params"])
            and all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
            and all(torch.equal(a["opt_state"][k][n], b["opt_state"][k][n])
                    for k in ("mu", "nu") for n in a["params"]))


def step_line(steps):
    return "; ".join(f"{s['wall_ms']:.1f} wall = {s['wait_ms']:.1f} waiting + "
                     f"{s['step_ms']:.1f} in the step" for s in steps)


def train_cli_phase(torch, wrappers, work: Path, tree, fp32_step):
    """Phase 13, after phase 12 on phase 11's trees: (a) contrastive training
    through the CLI, (b) resume through the CLI, (c) (a) on the plain
    attention, (d) teacher-student, (e) drift_eval_trainer with a random
    sweep of 2 trials, (f) evaluate (a)'s checkpoint, (g) tune. ``fp32_step``
    is phase 6 (e)'s device-only contrastive step ({"ms", "peak_gib"}) or
    None. Returns the launch counts per run. Runs with PyTorch's default cuDNN
    settings, restored after."""
    # cuDNN as a user's process has it (PyTorch's defaults: TF32 allowed, any
    # algorithm): the CLI's own settings must give (b) its bits and (c) its losses.
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    try:
        return _train_cli_phase(torch, wrappers, work, tree, fp32_step)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved


def _train_cli_phase(torch, wrappers, work: Path, tree, fp32_step):
    import gc
    import os

    import fitclip_torch.models.clip.model as model_module
    from fitclip_torch.cli import tune
    from fitclip_torch.data.datasets.msrvtt import MsrVttDataModule
    from fitclip_torch.evaluation.retrieval import RetrievalEvaluator
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel
    from fitclip_torch.training.checkpointing import is_full_train_state, load_checkpoint

    phase_start = time.perf_counter()
    start = time.perf_counter()
    os.environ.update(write_webvid_train_tree(work))
    (tree["root"] / "structured-symlinks" / "train_list_jsfusion.txt").write_text(
        "\n".join(tree["ids"]))
    print(f"train cli: wrote {TRAIN_VIDEOS} mp4v clips of {TRAIN_FRAMES} frames and MSR-VTT's "
          f"train list in {time.perf_counter() - start:.1f} s")
    encoder = ["encoder=clip_vit_b_16", f"+encoder.bpe_path={tree['merges']}"]

    def dirs(name):
        return [f"+log_dir={work / name / 'logs'}",
                f"trainer.callbacks.checkpoint.dirpath={work / name / 'ckpt'}"]

    contrastive = ["command=train", *encoder, "data=webvid", "trainer.log_every_n_steps=1"]
    paths = {}

    # (a) Contrastive, one epoch of 4 steps of 28 clips, epoch-end validation.
    out, a_s, launches, steps, entries = train_cli_run(torch, wrappers, [*contrastive, *dirs("a")],
                                                       work / "a" / "logs")
    paths["train_cli"] = launches
    losses = [e["loss/train"] for e in entries if "loss/train" in e]
    validation = [e for e in entries if "r1" in e]
    per_layer = {"fused_attention_qkv": 1, "fused_attention_qkv_backward": 1, "attention_f32": 1,
                 "attention_bwd_f32": 1}
    expected = {k: 2 * LAYERS * per_layer.get(k, 0) for k in wrappers}
    clips_s = len(steps) * TRAIN_BATCH / (steps[-1]["end"] - steps[0]["start"])
    device_step = "not run" if fp32_step is None else f"{fp32_step['ms']:.3f} ms"
    print(f"train cli (a): {a_s:.2f} s wall; losses {losses}; launches per step "
          f"{[{k: n for k, n in s['launches'].items() if n} for s in steps]}; validation "
          f"{validation}")
    print(f"train cli (a) rate: {clips_s:.2f} clips/s from the first batch to the last step, "
          f"decode included ({len(steps)} steps of {TRAIN_BATCH} clips x 4 frames, fp32); per "
          f"step ms: {step_line(steps)}; phase 6 (e)'s device-only fp32 step at 32 clips: "
          f"{device_step} ({clocks()}; {nvidia_smi()})")
    require(len(losses) == 4 and all(np.isfinite(losses)), f"(a) losses {losses}")
    require(len(steps) == 4 and all(s["launches"] == expected for s in steps),
            f"(a) launches per step {[s['launches'] for s in steps]}, expected {expected}")
    require(len(validation) == 1 and {"r1", "r5", "r10", "mr"} <= set(validation[0]),
            f"(a) validation {validation}")
    last_a = work / "a" / "ckpt" / "last"
    require(is_full_train_state(str(last_a)), "(a) last is not a full train state")

    # (b) Resume through the CLI: 2 steps, then +checkpoint_path=last to 4.
    _, _, first, _, _ = train_cli_run(torch, wrappers,
                                      [*contrastive, *dirs("b"), "+trainer.max_steps=2"],
                                      work / "b" / "logs")
    last_b = work / "b" / "ckpt" / "last"
    _, _, second, resumed, _ = train_cli_run(
        torch, wrappers, [*contrastive, *dirs("b"), f"+checkpoint_path={last_b}",
                          "+trainer.max_steps=4"], work / "b" / "logs")
    paths["train_cli_resume"] = {k: first[k] + second[k] for k in first}
    bitwise = checkpoints_equal(torch, last_b, last_a)
    print(f"train cli (b): 2 steps, then {len(resumed)} resumed to step 4: bit-identical to (a)'s "
          f"last: {bitwise}")
    require(len(resumed) == 2 and bitwise, "(b) the resumed last differs from (a)'s")

    # (c) (a) on the plain attention forward and backward.
    with swapped(model_module, fused_attention_qkv=plain_attention_function(torch)):
        _, _, plain, _, plain_entries = train_cli_run(torch, wrappers,
                                                      [*contrastive, *dirs("c")],
                                                      work / "c" / "logs")
    plain_losses = [e["loss/train"] for e in plain_entries if "loss/train" in e]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    print(f"train cli (c) plain attention: losses {plain_losses}; relative differences {rel}")
    require(not any(plain.values()), f"(c) the plain run launched {plain}")
    require(len(plain_losses) == 4 and max(rel) <= LOSS_RTOL, f"(c) relative differences {rel}")

    # (d) Teacher-student: bf16 student, bf16 fused_block teacher (K2), 3 steps
    # of 8 + 8 clips, validated on each member at step 3.
    ts = ["--config-name", "teacher_student_trainer", "command=train",
          "+encoder@encoder.student=clip_vit_b_16", "+encoder@encoder.teacher=clip_vit_b_16",
          f"+encoder.student.bpe_path={tree['merges']}",
          f"+encoder.teacher.bpe_path={tree['merges']}",
          "++encoder.student.dtype=bfloat16", "++encoder.teacher.dtype=bfloat16",
          "++encoder.teacher.fused_block=true", "data=mixed_batch_msrvtt_webvid",
          "++model.labeled_dataset_loss_share=0.9999", "+trainer.max_steps=3",
          "trainer.val_check_interval=0.25", "trainer.log_every_n_steps=1", *dirs("d")]
    _, d_s, launches, steps, entries = train_cli_run(torch, wrappers, ts, work / "d" / "logs")
    paths["train_cli_teacher_student"] = launches
    ts_losses = [e["loss/train"] for e in entries if "loss/train" in e]
    validation = [e for e in entries if "r1_labeled" in e]
    expected = {k: 0 for k in wrappers}
    expected.update({**k2_launches(LAYERS), "fused_attention_qkv": 2 * LAYERS,
                     "fused_attention_qkv_backward": 2 * LAYERS})
    print(f"train cli (d) teacher-student: {d_s:.2f} s wall; losses {ts_losses}; launches per "
          f"step {[{k: n for k, n in s['launches'].items() if n} for s in steps]}; validation "
          f"{validation}; per step ms: {step_line(steps)}")
    require(len(ts_losses) == 3 and all(np.isfinite(ts_losses)), f"(d) losses {ts_losses}")
    require(len(steps) == 3 and all(s["launches"] == expected for s in steps),
            f"(d) launches per step {[s['launches'] for s in steps]}, expected {expected}")
    require(len(validation) == 1 and "r1_unlabeled" in validation[0],
            f"(d) validation {validation}")
    require(is_full_train_state(str(work / "d" / "ckpt" / "best")),
            "(d) no best checkpoint by r1_labeled")
    torch.cuda.empty_cache()

    # (e) drift_eval_trainer with a random sweep of 2 trials, 2 steps each,
    # validated on data=drift_eval at step 2.
    sweep = ["--config-name", "drift_eval_trainer", "command=train", *encoder,
             "+hparam_search=random", "++hparam_search.n_trials=2", "+trainer.max_steps=2",
             "trainer.val_check_interval=0.5", "trainer.log_every_n_steps=1", *dirs("e")]
    out, e_s, launches, steps, entries = train_cli_run(torch, wrappers, sweep,
                                                       work / "e" / "logs")
    paths["train_cli_sweep"] = launches
    validation = [e for e in entries if "r10_cc3m" in e]
    best = float(out.strip().splitlines()[-1])
    print(f"train cli (e) sweep: {e_s:.2f} s wall; {len(steps)} steps; trials' validation "
          f"{validation}; printed best {best}")
    require(len(steps) == 4 and len(validation) == 2, f"(e) {len(steps)} steps, {validation}")
    require(all({"r10_msrvtt", "r10_webvid"} <= set(v) for v in validation),
            f"(e) validation keys {validation}")
    require(best in [v["r10_cc3m"] for v in validation], f"(e) printed best {best}")

    # (f) Evaluate (a)'s checkpoint through the CLI, against RetrievalEvaluator
    # over that state's encoder called directly.
    out, _, f_s, launches = cli_run(torch, wrappers, ["command=evaluate", *encoder,
                                                      "data=msrvtt", f"+checkpoint_path={last_a}"])
    paths["evaluate_trained_cli"] = launches
    metrics = json.loads(out[out.index("{"):])
    trained = load_clip_encoder("ViT-B/16", device="cuda", seed=0, bpe_path=tree["merges"])
    state = load_checkpoint(str(last_a))["params"]
    trained.encoder.model.load_state_dict(
        {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")})
    untrained = load_clip_encoder("ViT-B/16", device="cuda", seed=0, bpe_path=tree["merges"])
    evaluator, moved = RetrievalEvaluator(), 0.0
    with torch.no_grad():
        for batch in MsrVttDataModule(base_path=str(tree["root"]), encoder=trained,
                                      eval_batch_size=EVAL_BATCH).val_dataloader():
            video = torch.from_numpy(batch["video"]).cuda()
            text = torch.from_numpy(batch["text"]).long().cuda()
            video_emb = trained.encode_video(video)
            evaluator.update(video_emb, trained.encode_text(text))
            moved = max(moved, float((video_emb - untrained.encode_video(video)).abs().max()))
    direct = evaluator.compute()
    print(f"train cli (f) evaluate (a)'s last: {f_s:.2f} s wall; printed {metrics}; direct "
          f"{direct}; max |trained - untrained| video embedding {moved:.3e}")
    require(metrics == direct, f"(f) printed {metrics} != direct {direct}")
    require(moved > 0, "(f) the trained and untrained embeddings are equal")
    del trained, untrained, state
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Tune: the doubling search sized to meet one OOM, then TUNE_LR_STEPS LR steps.
    total = torch.cuda.get_device_properties(0).total_memory
    if fp32_step is None:
        per_clip, fixed = 0.55 * 2 ** 30, 2.5 * 2 ** 30
        source = "assumed"
    else:
        with torch.device("meta"):
            numel = sum(p.numel() for p in CLIPModel(CLIPConfig.vit_b_16()).parameters())
        fixed = 4 * 4 * numel  # fp32 params, gradients and two moments
        per_clip = (fp32_step["peak_gib"] * 2 ** 30 - fixed) / 32
        source = f"from phase 6 (e)'s peak {fp32_step['peak_gib']:.2f} GiB at 32 clips"
    fits = int((total - fixed) / per_clip)
    trials = 1
    while TRAIN_BATCH * 2 ** (trials - 1) <= 2 * fits:
        trials += 1
    print(f"train cli (g) estimate: {per_clip / 2 ** 30:.3f} GiB of activations a clip and "
          f"{fixed / 2 ** 30:.2f} GiB of params, gradients and moments ({source}) -> about "
          f"{fits} clips fit in {total / 2 ** 30:.1f} GiB; doubling from {TRAIN_BATCH} over "
          f"{trials} trials (up to {TRAIN_BATCH * 2 ** (trials - 1)})")
    memory = {}

    def scale_batch_size(*args, **kwargs):
        memory["before"] = torch.cuda.memory_allocated()
        result = search(*args, **kwargs)
        memory["after"] = torch.cuda.memory_allocated()
        memory["reserved_after"] = torch.cuda.memory_reserved()
        return result

    search = tune.scale_batch_size
    records = _Records()
    logging.getLogger("fitclip_torch.cli.tune").addHandler(records)
    try:
        with swapped(tune, scale_batch_size=scale_batch_size):
            out, _, g_s, launches = cli_run(torch, wrappers, [
                "command=tune", *encoder, "data=webvid",
                f"++tune.init_batch_size={TRAIN_BATCH}", f"++tune.max_trials={trials}",
                f"++tune.num_lr_steps={TUNE_LR_STEPS}"])
    finally:
        logging.getLogger("fitclip_torch.cli.tune").removeHandler(records)
    paths["tune_cli"] = launches
    suggested = json.loads(out[out.index("{"):])
    ran = [int(m.split("=")[1].split()[0]) for m in records.messages if m.endswith("fits")]
    oom = [m for m in records.messages if "ran out of device memory" in m]
    print(f"train cli (g) tune: {g_s:.2f} s wall; suggested {suggested}; sizes that ran {ran}, "
          f"{oom}; memory allocated before the search {memory['before'] / 2 ** 30:.3f} GiB, "
          f"after {memory['after'] / 2 ** 30:.3f} GiB (reserved after "
          f"{memory['reserved_after'] / 2 ** 30:.3f} GiB)")
    require(len(oom) == 1 and ran and suggested["batch_size"] == ran[-1],
            f"(g) the doubling met no OOM or suggested another size: {records.messages}")
    require(abs(memory["after"] - memory["before"]) <= 0.01 * memory["before"],
            f"(g) memory after the search {memory}")
    require(1e-8 <= suggested["lr"] <= 1.0, f"(g) suggested lr {suggested['lr']}")
    print(f"train cli: phase 13 took {time.perf_counter() - phase_start:.1f} s ({nvidia_smi()})")
    return paths


# Phase 14: the CLIP ResNet and WiSE-FT slice.
RN50 = dict(clips=32, frames=4, size=224, text_rows=256, gate_rows=32)
RN50_TEXT_LAYERS = 12
RN50_TRAIN_STEPS = 3
WISE_WEIGHT = 0.4  # config/encoder/wise.yaml's released recipe
CONV_KERNELS = ("conv", "xmma", "cudnn", "implicit", "fprop", "dgrad", "wgrad", "winograd")


def rn50_encode_phase(torch, wrappers):
    """Phase 14 (a): RN50 at full width from seed 0, 32 clips x 4 frames of
    224^2 and 77-token texts, fp32 and bf16: the launches per encode (the text
    tower's K3f, one per layer, and nothing else), K3f against its plain
    version in the text tower (tower cosine), bf16 against fp32, clips/s,
    texts/s, peak memory and profiles (the cuDNN convs' share of the video
    encode, K3f's of the text encode). Returns ({path: launches}, timings)."""
    from fitclip_torch.models.clip import model as model_module
    from fitclip_torch.models.clip.load import load_clip_encoder

    print(f"clocks (phase 14 (a)): {clocks()}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    video = torch.randint(0, 256, (RN50["clips"], RN50["frames"], RN50["size"], RN50["size"], 3),
                          generator=gen, device="cuda", dtype=torch.uint8)
    rng = np.random.default_rng(14)
    text = torch.from_numpy(token_ids(RN50["text_rows"], rng)).cuda()
    gate_text = text[:RN50["gate_rows"]]
    paths, timed, embeddings = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        enc = load_clip_encoder("RN50", dtype=dtype, device="cuda", seed=0).encoder
        for fn in wrappers.values():
            fn.launches = 0
        video_emb, text_emb = enc.encode_video(video), enc.encode_text(gate_text)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in wrappers.items()}
        expected = {name: 0 for name in wrappers}
        expected["fused_attention_qkv"] = RN50_TEXT_LAYERS
        if dtype == "float32":
            expected["attention_f32"] = RN50_TEXT_LAYERS
        print(f"rn50 {dtype}: launches per encode of both towers "
              f"{ {k: n for k, n in launches.items() if n} }")
        require(launches == expected, f"rn50 {dtype} launches {launches}, expected {expected}")
        paths[f"rn50_encode_{dtype}"] = launches
        shapes = (tuple(video_emb.shape), tuple(text_emb.shape))
        require(shapes == ((RN50["clips"], 1024), (RN50["gate_rows"], 1024)),
                f"rn50 {dtype}: embeddings {shapes}")
        require(bool(torch.isfinite(video_emb.float()).all())
                and bool(torch.isfinite(text_emb.float()).all()), f"rn50 {dtype}: non-finite")
        with swapped(model_module, fused_attention_qkv=plain_attention_function(torch)):
            plain_text = enc.encode_text(gate_text)
        cos = min_cosine(text_emb, plain_text)
        print(f"rn50 {dtype} gate: text tower on K3f vs its plain version on the card, min "
              f"cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"rn50 {dtype}: K3f vs plain text cosine {cos}")
        embeddings[dtype] = (video_emb, text_emb)
        torch.cuda.reset_peak_memory_stats()
        video_ms = cuda_ms(lambda: enc.encode_video(video), iters=10)
        text_ms = cuda_ms(lambda: enc.encode_text(text), iters=10)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        timed[dtype] = {"video_ms": video_ms, "clips_per_s": RN50["clips"] * 1e3 / video_ms,
                        "text_ms": text_ms, "texts_per_s": RN50["text_rows"] * 1e3 / text_ms,
                        "peak_gib": peak}
        print(f"rn50 {dtype} encode: encode_video {RN50['clips']} clips x {RN50['frames']} "
              f"frames {video_ms:.3f} ms, {timed[dtype]['clips_per_s']:.1f} clips/s; "
              f"encode_text {RN50['text_rows']} x 77 {text_ms:.3f} ms, "
              f"{timed[dtype]['texts_per_s']:.1f} texts/s; peak {peak:.2f} GiB "
              f"({clocks()}; {nvidia_smi()})")
        per_kernel, busy = profile_ms(torch, lambda: enc.encode_video(video))
        total = sum(per_kernel.values())
        conv = sum(ms for k, ms in per_kernel.items() if any(c in k.lower() for c in CONV_KERNELS))
        timed[dtype].update(video_device_ms=total, conv_share=conv / total, video_busy=busy)
        print(f"rn50 {dtype} encode_video profile: device {total:.3f} ms per call, busy share "
              f"{busy:.3f}; convolution kernels {conv:.3f} ms ({conv / total:.2%}); top kernels:")
        for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"  {ms:9.3f} {ms / total:7.2%}  {key[:100]}")
        print_profile(torch, f"rn50 {dtype} encode_text", lambda: enc.encode_text(text), top=6,
                      **({"kernels": (F32_FORWARD,)} if dtype == "float32"
                         else {"mma": ("attention_mma_kernel",)}))
        del enc
        torch.cuda.empty_cache()
    for tower, index in (("vision", 0), ("text", 1)):
        cos = min_cosine(embeddings["bfloat16"][index], embeddings["float32"][index])
        print(f"rn50 gate: bf16 vs fp32 {tower}, min cosine {cos:.6f}")
        require(cos >= GATE_COSINE, f"rn50 bf16 vs fp32 {tower} cosine {cos}")
    return paths, timed


def resnet_train_phase(torch, wrappers, work: Path, tree):
    """Phase 14 (c): ``command=train encoder=clip_rn50 data=webvid`` in fp32 on
    phase 13's WebVid train tree, RN50_TRAIN_STEPS steps of the config's batch
    under PyTorch's default cuDNN flags: per step the text tower's K3f and K3b
    (fp32: fused_attention_qkv, attention_f32 and their backward, one per
    layer), every running statistic moved and equal to the last step's EMA
    write (frozen to the optimizer: no moment), and 2 steps then a resume
    through the CLI to RN50_TRAIN_STEPS equal to the straight run bit for bit,
    running statistics included. Returns ({path: launches}, timings)."""
    from fitclip_torch.models.clip import resnet, resnet_clip
    from fitclip_torch.training import train_runner
    from fitclip_torch.training.checkpointing import load_checkpoint

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    captured = {"encoder": None, "updates": None}
    make_step = train_runner.make_contrastive_train_step

    def capturing(encoder, *args, **kwargs):
        captured["encoder"] = encoder
        return make_step(encoder, *args, **kwargs)

    def recording(updates):
        captured["updates"] = [(bn, mean.clone(), var.clone()) for bn, mean, var in updates]
        resnet.apply_bn_updates(updates)

    train = ["command=train", "encoder=clip_rn50", f"+encoder.bpe_path={tree['merges']}",
             "data=webvid", "trainer.log_every_n_steps=1"]

    def dirs(name):
        return [f"+log_dir={work / name / 'logs'}",
                f"trainer.callbacks.checkpoint.dirpath={work / name / 'ckpt'}"]

    try:
        with swapped(train_runner, make_contrastive_train_step=capturing), \
                swapped(resnet_clip, apply_bn_updates=recording):
            out, seconds, launches, steps, entries = train_cli_run(
                torch, wrappers, [*train, *dirs("rn_a"), f"+trainer.max_steps={RN50_TRAIN_STEPS}"],
                work / "rn_a" / "logs")
        paths = {"rn50_train_cli": launches}
        losses = [e["loss/train"] for e in entries if "loss/train" in e]
        expected = {name: 0 for name in wrappers}
        expected.update({name: RN50_TEXT_LAYERS for name in (
            "fused_attention_qkv", "fused_attention_qkv_backward", "attention_f32",
            "attention_bwd_f32")})
        clips_s = len(steps) * TRAIN_BATCH / (steps[-1]["end"] - steps[0]["start"])
        print(f"rn50 train cli (c): {seconds:.2f} s wall; losses {losses}; launches per step "
              f"{[{k: n for k, n in s['launches'].items() if n} for s in steps]}")
        print(f"rn50 train cli (c) rate: {clips_s:.2f} clips/s from the first batch to the last "
              f"step, decode included ({len(steps)} steps of {TRAIN_BATCH} clips x 4 frames, "
              f"fp32); per step ms: {step_line(steps)} ({clocks()}; {nvidia_smi()})")
        require(len(losses) == RN50_TRAIN_STEPS and all(np.isfinite(losses)),
                f"rn50 (c) losses {losses}")
        require(len(steps) == RN50_TRAIN_STEPS and all(s["launches"] == expected for s in steps),
                f"rn50 (c) launches per step {[s['launches'] for s in steps]}, expected {expected}")
        last = work / "rn_a" / "ckpt" / "last"
        saved_state = load_checkpoint(str(last))
        names = {id(m): n for n, m in captured["encoder"].model.named_modules()}
        stats = [n for n in saved_state["params"] if n.endswith(("running_mean", "running_var"))]
        moved, ema = 0, 0
        for bn, mean, var in captured["updates"]:
            name = f"encoder.{names[id(bn)]}"
            for leaf, value, init in (("running_mean", mean, 0.0), ("running_var", var, 1.0)):
                stored = saved_state["params"][f"{name}.{leaf}"]
                ema += torch.equal(stored, value.cpu()) and torch.equal(getattr(bn, leaf), value)
                moved += not bool((stored == init).all())
                require(saved_state["opt_state"]["mu"][f"{name}.{leaf}"].dim() == 0,
                        f"rn50 (c): {name}.{leaf} has an optimizer moment")
        print(f"rn50 train cli (c): {len(stats)} running statistics in the checkpoint; {moved} "
              f"moved from the seeded init; {ema} equal to the last step's EMA write")
        require(len(stats) == 2 * len(captured["updates"]) == moved == ema,
                f"rn50 (c): {len(stats)} statistics, {moved} moved, {ema} the EMA's")
        _, _, first, _, _ = train_cli_run(torch, wrappers,
                                          [*train, *dirs("rn_b"), "+trainer.max_steps=2"],
                                          work / "rn_b" / "logs")
        last_b = work / "rn_b" / "ckpt" / "last"
        _, _, second, resumed, _ = train_cli_run(
            torch, wrappers, [*train, *dirs("rn_b"), f"+checkpoint_path={last_b}",
                              f"+trainer.max_steps={RN50_TRAIN_STEPS}"], work / "rn_b" / "logs")
        paths["rn50_train_cli_resume"] = {k: first[k] + second[k] for k in first}
        bitwise = checkpoints_equal(torch, last_b, last)
        print(f"rn50 train cli (c): 2 steps, then {len(resumed)} resumed to step "
              f"{RN50_TRAIN_STEPS}: bit-identical to the straight run, running statistics "
              f"included: {bitwise}")
        require(len(resumed) == RN50_TRAIN_STEPS - 2 and bitwise,
                "rn50 (c): the resumed last differs from the straight run's")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved
    step_ms = sorted(s["step_ms"] for s in steps)
    return paths, {"clips_per_s": clips_s, "step_ms_median": step_ms[len(step_ms) // 2]}


def wise_phase(torch, wrappers, work: Path, tree, student_ckpt: Path):
    """Phase 14 (d): export the trained ViT-B/16 student with ``python -m
    fitclip_torch.convert.checkpoint_to_state_dict``, then ``command=evaluate``
    and ``command=predict encoder=wise`` (model1 the seeded clip_vit_b_16,
    model2 the export, weight_for_2 WISE_WEIGHT, bf16): finite metrics, K3f's
    launches, and predict's embeddings bit-equal to those of a clip_vit_b_16
    loaded from the merged state dict written directly (wise_params on the
    CPU, openai_state_dict, torch.save). Returns {path: launches}."""
    import os

    from fitclip_torch.convert.openai_state_dict import openai_state_dict
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.models.wise import wise_params

    export, merged = work / "student_openai.pt", work / "wise_merged.pt"
    start = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "fitclip_torch.convert.checkpoint_to_state_dict",
                           str(student_ckpt), "--output", str(export)], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    print(f"wise (d): python -m fitclip_torch.convert.checkpoint_to_state_dict "
          f"{student_ckpt.relative_to(work)} --output {export.name}: rc {proc.returncode} in "
          f"{time.perf_counter() - start:.1f} s")
    require(proc.returncode == 0, f"export failed: {proc.stderr[-2000:]}")
    members = ["+encoder@encoder.model1=clip_vit_b_16", "+encoder@encoder.model2=clip_vit_b_16",
               f"+encoder.model2.checkpoint_path={export}",
               f"++encoder.weight_for_2={WISE_WEIGHT}"]
    for slot in ("model1", "model2"):
        members += [f"++encoder.{slot}.dtype=bfloat16",
                    f"+encoder.{slot}.bpe_path={tree['merges']}"]
    out, _, eval_s, eval_launches = cli_run(torch, wrappers, ["command=evaluate", "encoder=wise",
                                                              *members, "data=msrvtt"])
    metrics = json.loads(out[out.index("{"):])
    batches = -(-len(tree["ids"]) // EVAL_BATCH)
    expected = {name: 0 for name in wrappers}
    expected["fused_attention_qkv"] = 2 * LAYERS * batches
    print(f"wise (d) evaluate: {eval_s:.2f} s wall; printed {metrics}; launches "
          f"{ {k: n for k, n in eval_launches.items() if n} }")
    require(all(np.isfinite(v) for v in metrics.values()) and "r1" in metrics,
            f"wise (d) metrics {metrics}")
    require(eval_launches == expected, f"wise (d) launches {eval_launches}, expected {expected}")
    wise_dump, direct_dump = work / "wise_predictions.pt", work / "direct_predictions.pt"
    _, _, _, predict_launches = cli_run(torch, wrappers, [
        "command=predict", "encoder=wise", *members, "data=msrvtt", f"+output_path={wise_dump}"])
    seeded = load_clip_encoder("ViT-B/16", device="cpu", seed=0).encoder.model.state_dict()
    trained = load_clip_encoder(checkpoint_path=str(export), device="cpu").encoder.model
    torch.save(openai_state_dict(wise_params(seeded, trained.state_dict(), WISE_WEIGHT)), merged)
    _, _, _, direct_launches = cli_run(torch, wrappers, [
        "command=predict", "encoder=clip_vit_b_16", f"+encoder.checkpoint_path={merged}",
        "++encoder.dtype=bfloat16", f"+encoder.bpe_path={tree['merges']}", "data=msrvtt",
        f"+output_path={direct_dump}"])
    got, want = (torch.load(path, weights_only=False) for path in (wise_dump, direct_dump))
    same = all(torch.equal(got[k], want[k]) for k in ("encoded_videos", "encoded_texts"))
    moved = max(float((a - seeded[k]).abs().max()) for k, a in trained.state_dict().items())
    print(f"wise (d) predict: embeddings {tuple(got['encoded_videos'].shape)} bit-equal to a "
          f"clip_vit_b_16 loaded from the merged state dict: {same}; the student's weights lie "
          f"up to {moved:.3e} from the seeded ones")
    require(moved > 0, "wise (d): the exported student equals the seeded encoder")
    require(same and got["video_ids"] == want["video_ids"],
            "wise (d): the CLI's WiSE embeddings differ from the merged checkpoint's")
    require(predict_launches == direct_launches == expected,
            f"wise (d) predict launches {predict_launches}, direct {direct_launches}")
    return {"wise_evaluate_cli": eval_launches, "wise_predict_cli": predict_launches}


def resnet_wise_phase(torch, wrappers, work: Path, tree, student_ckpt: Path):
    """Phase 14, after phase 13 on phase 11's and 13's trees: (a) RN50 encodes,
    (b) ``command=evaluate encoder=clip_rn50 data=msrvtt`` in bf16 and int8
    refused, (c) RN50 training through the CLI with resume, (d) WiSE-FT of the
    seeded ViT-B/16 and phase 13's trained student. Returns ({path: launches},
    timings)."""
    phase_start = time.perf_counter()
    torch.set_grad_enabled(False)
    paths, timed = rn50_encode_phase(torch, wrappers)
    torch.cuda.empty_cache()

    # (b) The eval CLI over the ResNet in bf16; int8 refused.
    common = ["encoder=clip_rn50", f"+encoder.bpe_path={tree['merges']}", "data=msrvtt"]
    out, _, eval_s, launches = cli_run(torch, wrappers, ["command=evaluate", *common,
                                                         "++encoder.dtype=bfloat16"])
    metrics = json.loads(out[out.index("{"):])
    batches = -(-len(tree["ids"]) // EVAL_BATCH)
    expected = {name: 0 for name in wrappers}
    expected["fused_attention_qkv"] = RN50_TEXT_LAYERS * batches
    print(f"rn50 eval cli (b): {eval_s:.2f} s wall; printed {metrics}; launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    require({"r1", "r5", "r10", "mr"} <= set(metrics)
            and all(np.isfinite(v) for v in metrics.values()), f"rn50 (b) metrics {metrics}")
    require(launches == expected, f"rn50 (b) launches {launches}, expected {expected}")
    paths["rn50_eval_cli"] = launches
    refused = None
    try:
        cli_run(torch, wrappers, ["command=evaluate", *common, "++encoder.dtype=int8"])
    except ValueError as e:
        refused = str(e)
    print(f"rn50 eval cli (b) ++encoder.dtype=int8: refused: {refused}")
    require(refused is not None and "transformer-only" in refused,
            "rn50 (b): int8 was not refused")
    torch.cuda.empty_cache()

    torch.set_grad_enabled(True)
    train_paths, timed["train"] = resnet_train_phase(torch, wrappers, work, tree)
    paths.update(train_paths)
    torch.cuda.empty_cache()
    torch.set_grad_enabled(False)
    paths.update(wise_phase(torch, wrappers, work, tree, student_ckpt))
    torch.cuda.empty_cache()
    print(f"resnet and wise: phase 14 took {time.perf_counter() - phase_start:.1f} s "
          f"({nvidia_smi()})")
    print(json.dumps({"resnet_wise": timed, "card": nvidia_smi()}))
    return paths, timed


def resnet_wise_only(torch) -> int:
    """Phase 14 alone (``--resnet-wise``): the build, phase 11's MSR-VTT tree and
    BPE vocabulary, phase 13's WebVid trees and a ViT-B/16 student trained one
    step through the CLI (phase 13's is trained four), then phase 14."""
    import os

    sys.path.insert(0, str(ROOT))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab

    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s; {nvidia_smi()}")
    wrappers = kernel_wrappers()
    work = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    try:
        ids, captions = write_msrvtt_tree(work / "msrvtt")
        merges, _ = write_tiny_test_vocab(str(work), [w for c in captions for w in c.split()])
        os.environ.update(write_drift_trees(work), MSRVTT_PATH=str(work / "msrvtt"))
        os.environ.update(write_webvid_train_tree(work))
        tree = {"root": work / "msrvtt", "ids": ids, "merges": merges}
        cli_run(torch, wrappers, ["command=train", "encoder=clip_vit_b_16",
                                  f"+encoder.bpe_path={merges}", "data=webvid",
                                  "+trainer.max_steps=1", f"+log_dir={work / 'a' / 'logs'}",
                                  f"trainer.callbacks.checkpoint.dirpath={work / 'a' / 'ckpt'}"])
        paths, _ = resnet_wise_phase(torch, wrappers, work, tree, work / "a" / "ckpt" / "last")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"resnet_wise": {path: {k: n for k, n in c.items() if n}
                                      for path, c in paths.items()}, "card": nvidia_smi()}))
    return 0


# Phase 15: export (each tower a torch.export program; the service from EMBED_EXPORT_DIR).
EXPORT_TEXT_BUCKETS, EXPORT_VIDEO_BUCKETS = (1, 8, 32), (1, 8)
EXPORT_SERIAL, EXPORT_CLIENTS, EXPORT_REQUESTS = 16, 8, 8  # phase 12's (a)-(b), smaller
EXPORT_FAMILY_CLIPS = 1  # the one video bucket of (c): a static batch, traced fastest
EXPORT_EAGER_COSINE = 0.9999
READINGS = {}  # readings one phase keeps for another's print (phase 12's set-up s)


def composed_encoder(torch, name: str, overrides):
    """config/encoder/<name>.yaml with the overrides, on the card: the encoder
    export_serving and the service compose."""
    from fitclip_torch.cli.main import DEFAULT_CONFIG_DIR
    from fitclip_torch.config_engine import compose, instantiate

    cfg = compose(DEFAULT_CONFIG_DIR, "trainer",
                  ["command=evaluate", f"encoder={name}", "data=msrvtt", *overrides])
    return instantiate(cfg["encoder"], device="cuda").encoder


def k1_launches(towers: int = 1) -> dict:
    """K1's seven launches per layer of a ViT-B/16 tower."""
    return {name: n * LAYERS * towers for name, n in INT8_LAUNCHES_PER_LAYER.items()}


def load_exported_child(directory: str, inputs: str, out: str) -> int:
    """``--load-exported DIR INPUTS OUT``: phase 15 (a)'s fresh process. Loads
    both towers' programs from DIR with no model module, runs each bucket once
    on INPUTS' rows (counting K1's launches of that one call), saves the rows
    to OUT and prints one JSON line: load s, the fitclip_torch.models modules
    loaded (none), launches and ms per bucket call."""
    import torch

    sys.path.insert(0, str(ROOT))
    start = time.perf_counter()
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K
    from fitclip_torch.serving.export import load_exported

    towers = {name: load_exported(directory, name) for name in ("text", "video")}
    torch.cuda.synchronize()
    load_s = time.perf_counter() - start
    counted = (K.ln_quant, K.int8_gemm_bias, K.int8_gemm_residual, K.int8_gemm_gelu,
               A.attention_int8)
    batches = torch.load(inputs)
    rows, launches, call_ms = {}, {}, {}
    for tower, (encode, per_bucket) in towers.items():
        for size in sorted(per_bucket):
            batch = batches[tower][:size].cuda()
            encode(batch)  # the program's first call
            for fn in counted:
                fn.launches = 0
            torch.cuda.synchronize()
            start = time.perf_counter()
            out_rows = per_bucket[size](batch)
            torch.cuda.synchronize()
            key = f"{tower}_{size}"
            call_ms[key] = 1e3 * (time.perf_counter() - start)
            launches[key] = {fn.__name__: fn.launches for fn in counted}
            rows[key] = out_rows.float().cpu()
    torch.save(rows, out)
    models = sorted(m for m in sys.modules if m.startswith("fitclip_torch.models"))
    print(json.dumps({"load_s": load_s, "models": models, "launches": launches,
                      "call_ms": call_ms}))
    return 0


def dispatch_readings(torch, enc, video32) -> dict:
    """Phase 15 (d): CLIP int8 encode_video of 32 clips (the median, min and max
    of 5 CUDA-event readings of 10 calls; the host's ms to issue one call on an
    idle card, least of 3, before each reading) and, where the tree binds its
    kernels as operators, one K1 launch's host us by route at the encode's
    ln_quant shape: the wrapper (the Library operator), the operator's CUDA
    implementation called directly (no dispatch), and the same implementation
    as a torch.library.custom_op."""
    from fitclip_torch.ops import block as K

    def host_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        return min(times)

    def encode():
        return enc.encode_video(video32)

    runs, hosts = [], []
    for _ in range(5):
        hosts.append(host_ms(encode))
        runs.append(cuda_ms(encode, iters=10))
    ms = sorted(runs)[2]
    out = {"encode_ms": ms, "clips_per_s": 32e3 / ms, "encode_ms_min": min(runs),
           "encode_ms_max": max(runs), "runs": runs, "host_ms": sorted(hosts)[2],
           "host_ms_runs": hosts}
    print(f"export (d) CLIP int8 encode_video, 32 clips x 4 frames: {ms:.3f} ms "
          f"({min(runs):.3f}-{max(runs):.3f}), {32e3 / ms:.1f} clips/s; host issue "
          f"{out['host_ms']:.3f} ms a call (runs {', '.join(f'{h:.3f}' for h in hosts)})")
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn(32 * 4 * 197, 768, generator=gen, device="cuda").to(torch.bfloat16)
    weight, bias = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    routes = {"wrapper": lambda: K.ln_quant(x, weight, bias, 20.0)}
    if hasattr(K, "_ln_quant_cuda"):
        @torch.library.custom_op("fitclip_ab::ln_quant", mutates_args=(), device_types="cuda")
        def ln_quant_custom_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                               inv: float, eps: float) -> torch.Tensor:
            return K._ln_quant_cuda(x, weight, bias, inv, eps)

        ln_quant_custom_op.register_fake(
            lambda x, weight, bias, inv, eps: x.new_empty(x.shape, dtype=torch.int8))
        routes["no dispatch"] = lambda: K._ln_quant_cuda(x, weight, bias, 20.0, 1e-5)
        routes["custom_op"] = lambda: ln_quant_custom_op(x, weight, bias, 20.0, 1e-5)
    calls, us = 2000, {}
    for route, fn in routes.items():
        readings = []
        for _ in range(3):
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            readings.append((time.perf_counter() - start) / calls * 1e6)
        us[route] = min(readings)
    out["ln_quant_us_per_call"] = us
    print("export (d) one ln_quant launch at 25,216 x 768, host us a call (least of 3 x "
          f"{calls}): " + ", ".join(f"{route} {v:.2f}" for route, v in us.items()))
    return out


def op_dispatch_only(torch, package: Path) -> int:
    """``--op-dispatch [DIR]``: phase 15 (d) alone for the fitclip_torch package
    under DIR (the parent's, say): the seeded int8 CLIP ViT-B/16 with its pixel
    normalization folded, calibrated on 8 clips and 32 token rows, then
    ``dispatch_readings``. Prints one JSON line with the card and its clocks."""
    sys.path.insert(0, str(package))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.load import load_clip_encoder

    print(f"op dispatch of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}; clocks {clocks()}")
    _build.library()
    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    enc = load_clip_encoder("ViT-B/16", dtype="int8", device="cuda", seed=0).encoder
    enc.fold_pixel_normalization()
    video = torch.randint(0, 256, (32, 4, 224, 224, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
    enc.calibrate(video[:8], torch.from_numpy(token_ids(32, np.random.default_rng(0))).cuda())
    readings = dispatch_readings(torch, enc, video)
    print(json.dumps({"op_dispatch": readings, "package": str(package), "card": nvidia_smi(),
                      "clocks": clocks()}))
    return 0


def export_clip_int8(torch, wrappers, work: Path, merges: str):
    """Phase 15 (a). Returns (the calibrated eager encoder, its overrides, the
    scales file, the export directory, {path: launches}, readings)."""
    from fitclip_torch.models.clip.encoder import l2_normalize
    from fitclip_torch.models.clip.fast_eval import encode_frames_fast, encode_text_fast
    from fitclip_torch.ops import block as K
    from fitclip_torch.ops.quant import save_act_scales

    overrides = ["++encoder.dtype=int8", f"+encoder.bpe_path={merges}"]
    enc = composed_encoder(torch, "clip_vit_b_16", overrides)
    gen = torch.Generator(device="cuda").manual_seed(15)
    rng = np.random.default_rng(15)
    inputs = {"video": torch.randint(0, 256, (EXPORT_VIDEO_BUCKETS[-1], 4, 224, 224, 3),
                                     generator=gen, device="cuda", dtype=torch.uint8),
              "text": torch.from_numpy(token_ids(EXPORT_TEXT_BUCKETS[-1], rng)).cuda()}
    enc.calibrate(inputs["video"], inputs["text"])
    scales, export_dir = work / "export_scales.npz", work / "export"
    save_act_scales(str(scales), enc.model)
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fitclip_torch.serving.export_serving", "clip_vit_b_16",
         str(export_dir), "--buckets", ",".join(map(str, EXPORT_TEXT_BUCKETS)),
         "--video-buckets", ",".join(map(str, EXPORT_VIDEO_BUCKETS)), "--scales", str(scales),
         "--overrides", *overrides], cwd=ROOT, capture_output=True, text=True, timeout=900)
    export_s = time.perf_counter() - start
    require(proc.returncode == 0, f"export_serving exited {proc.returncode}:\n"
                                  f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    written = json.loads(proc.stdout[proc.stdout.index("{"):])
    want = {tower: {str(b): str(export_dir / f"{tower}.pt2") for b in buckets}
            for tower, buckets in (("text", EXPORT_TEXT_BUCKETS), ("video", EXPORT_VIDEO_BUCKETS))}
    require(written == want, f"export_serving printed {written}, expected {want}")
    sizes = {name: (export_dir / name).stat().st_size
             for name in ("text.pt2", "text.json", "video.pt2", "video.json")}
    torch.save({k: v.cpu() for k, v in inputs.items()}, work / "export_inputs.pt")
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--load-exported",
                           str(export_dir), str(work / "export_inputs.pt"),
                           str(work / "export_rows.pt")], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    child_s = time.perf_counter() - start
    require(proc.returncode == 0, f"the loading process exited {proc.returncode}:\n"
                                  f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"export (a) int8 CLIP ViT-B/16: export_serving {export_s:.1f} s (its process), "
          f"artifacts {sizes} bytes; a fresh process loaded both programs in "
          f"{child['load_s']:.2f} s ({child_s:.1f} s with its start), "
          f"fitclip_torch.models modules there: {child['models'] or 'none'}")
    require(child["models"] == [], f"loading imported {child['models']}")
    loaded = torch.load(work / "export_rows.pt")
    want_launches = {fn: n for fn, n in k1_launches().items()}
    gates = {}
    with torch.no_grad():
        for key, rows in loaded.items():
            tower, size = key.split("_")
            batch = inputs[tower][:int(size)]
            if tower == "text":
                eager = enc.encode_text(batch)
                plain = l2_normalize(encode_text_fast(enc.model, batch,
                                                      layer_fn=K.fused_int8_layer_plain))
            else:
                eager = enc.encode_video(batch)
                b, t = batch.shape[:2]
                plain = l2_normalize(encode_frames_fast(
                    enc.model, enc._prepare_frames(batch), layer_fn=K.fused_int8_layer_plain)
                ).reshape(b, t, -1).mean(dim=1)
            eager, plain = eager.float().cpu(), plain.float().cpu()
            gates[key] = {"eager": min_cosine(rows, eager), "bit_equal": torch.equal(rows, eager),
                          "plain": min_cosine(rows, plain), "launches": child["launches"][key],
                          "call_ms": child["call_ms"][key]}
            print(f"export (a) {tower} bucket {size}: loaded vs eager min cosine "
                  f"{gates[key]['eager']:.6f} (bit-equal {gates[key]['bit_equal']}), vs the "
                  f"plain versions {gates[key]['plain']:.6f}; K1 launches of one call "
                  f"{child['launches'][key]}; {child['call_ms'][key]:.2f} ms")
            require(gates[key]["eager"] >= EXPORT_EAGER_COSINE,
                    f"export {key}: loaded vs eager cosine {gates[key]['eager']}")
            require(gates[key]["plain"] > GATE_COSINE,
                    f"export {key}: loaded vs plain cosine {gates[key]['plain']}")
            require(child["launches"][key] == want_launches,
                    f"export {key}: launches {child['launches'][key]}, expected {want_launches}")
    readings = {"export_s": export_s, "load_s": child["load_s"], "child_s": child_s,
                "sizes": sizes, "gates": gates}
    paths = {f"export_load_{key}": {name: gates[key]["launches"].get(name, 0) for name in wrappers}
             for key in gates}
    return enc, overrides, scales, export_dir, paths, readings


def export_service(torch, wrappers, enc, overrides, scales: Path, export_dir: Path):
    """Phase 15 (b): the embed service with EMBED_EXPORT_DIR on the card."""
    import os
    import threading

    from fitclip_torch.serving import embed_service as es

    globals_ = ("_SERVICE", "_VIDEO_SERVICE", "_INDEX", "_LOADED", "_GRAPHS")
    for name in globals_:
        setattr(es, name, None)
    os.environ.update({"EMBED_ENCODER": "clip_vit_b_16", "EMBED_OVERRIDES": " ".join(overrides),
                       "EMBED_SCALES": str(scales), "EMBED_EXPORT_DIR": str(export_dir),
                       "EMBED_MAX_WAIT_MS": "2"})
    server = None
    try:
        start = time.perf_counter()
        es._ensure_loaded()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
        start = time.perf_counter()
        graphs = es.warm_graphs()
        for fn in wrappers.values():
            fn.launches = 0
        es._ensure_service()
        es._ensure_video_service()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - start
        capture = {name: fn.launches for name, fn in wrappers.items()}
        buckets = {t: g.bucket_sizes for t, g in graphs.items()}
        captured = {t: sorted(g.capture_ms) for t, g in graphs.items()}
        print(f"export (b) the service from EMBED_EXPORT_DIR: buckets {buckets}, captured "
              f"{captured}; the encoder (tokenizer, preprocessing) loaded in {load_s:.2f} s, "
              f"then set-up to both services ready {setup_s:.3f} s with the programs' load "
              f"(phase 12's in-process towers: {READINGS.get('serve_setup_s', 'not run')} s); "
              "capture ms " + "; ".join(
                  f"{t} " + ", ".join(f"{b}: {ms:.1f}" for b, ms in g.capture_ms.items())
                  for t, g in graphs.items()))
        require(buckets == {"text": EXPORT_TEXT_BUCKETS, "video": EXPORT_VIDEO_BUCKETS}
                and captured == {t: list(b) for t, b in buckets.items()},
                f"buckets {buckets}, captured {captured}")
        n_buckets = len(EXPORT_TEXT_BUCKETS) + len(EXPORT_VIDEO_BUCKETS)
        want = {name: 0 for name in wrappers}
        want.update(k1_launches(n_buckets))
        print(f"export (b) launches recorded by the {n_buckets} captures "
              f"{({k: n for k, n in capture.items() if n})} (84 a bucket)")
        require(capture == want, f"capture launches {capture}, expected {want}")
        server = es.EmbedHTTPServer(("127.0.0.1", 0), es.Handler)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        for fn in wrappers.values():
            fn.launches = 0
        texts, rows, serial = [], [], []
        for text in serve_texts(np.random.default_rng(21), EXPORT_SERIAL):
            status, reply, seconds, _ = http(url + "/embed_text",
                                             json.dumps({"texts": [text]}).encode())
            require(status == 200, f"/embed_text {status}: {reply}")
            texts.append(text)
            rows.extend(reply["embeddings"])
            serial.append(seconds)
        plans = [[serve_texts(np.random.default_rng(400 + c), int(k))
                  for k in np.random.default_rng(500 + c).integers(1, 5, EXPORT_REQUESTS)]
                 for c in range(EXPORT_CLIENTS)]
        concurrent, _, replies, burst_s = burst(url, plans)
        require(all(len(c) == EXPORT_REQUESTS for c in concurrent), "a client's request failed")
        for batch_texts, batch_rows in replies:
            texts.extend(batch_texts)
            rows.extend(batch_rows)
        torch.cuda.synchronize()
        traffic = {name: fn.launches for name, fn in wrappers.items()}
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        for service in (es._SERVICE, es._VIDEO_SERVICE):
            if service is not None:
                service.stop()
        for name in globals_:
            setattr(es, name, None)
        os.environ.pop("EMBED_EXPORT_DIR", None)
    burst_texts = sum(len(t) for plan in plans for t in plan)
    print(f"export (b) (a) {EXPORT_SERIAL} serial /embed_text: {percentiles(serial)}; (b) "
          f"{EXPORT_CLIENTS} client threads x {EXPORT_REQUESTS} requests of 1-4 texts: "
          f"{percentiles([s for c in concurrent for s in c])}, {burst_texts / burst_s:.1f} "
          f"texts/s; launches under traffic {({k: n for k, n in traffic.items() if n}) or 'none'}")
    require(not any(traffic.values()), f"traffic launched eagerly: {traffic}")
    tokenizer = enc.get_tokenizer()
    eager = []
    with torch.no_grad():
        for i in range(0, len(texts), 32):
            ids = torch.from_numpy(tokenizer(texts[i:i + 32])).long().cuda()
            eager.append(enc.encode_text(ids).float().cpu())
    cos = min_cosine(torch.tensor(rows, dtype=torch.float32), torch.cat(eager))
    print(f"export (b) served rows ({len(rows)}) vs eager encode_text, min cosine {cos:.6f}")
    require(len(rows) == len(texts) and cos >= EXPORT_EAGER_COSINE, f"served cosine {cos}")
    return ({"export_serve_capture": capture, "export_serve_traffic": traffic},
            {"load_s": load_s, "setup_s": setup_s, "served_cosine": cos,
             "texts_per_s": burst_texts / burst_s})


def export_families(torch, wrappers, work: Path):
    """Phase 15 (c): one video bucket of every other family that carries a
    kernel, exported in this process and held against its eager tower."""
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.models.frozen_in_time.load import load_frozen_in_time_encoder
    from fitclip_torch.models.mil_nce import load_mil_nce_encoder
    from fitclip_torch.models.slip import load_slip_encoder
    from fitclip_torch.serving.export import export_encode_fn, load_exported

    gen = torch.Generator(device="cuda").manual_seed(17)
    n = EXPORT_FAMILY_CLIPS

    def uint8(frames):
        return torch.randint(0, 256, (n, frames, 224, 224, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    def clip_bf16():
        enc = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0,
                                fused_block=True).encoder
        return enc.fold_pixel_normalization(), uint8(4)

    def fit(dtype):
        def build():
            enc = load_frozen_in_time_encoder(dtype=dtype, device="cuda", seed=0).encoder
            if dtype == "int8":
                enc.calibrate(fit_video(torch, 8))
            return enc, fit_video(torch, n)
        return build

    def slip_int8():
        enc = load_slip_encoder(dtype="int8", device="cuda", seed=0, fused_block=False).encoder
        video = uint8(4)
        enc.calibrate(video, torch.from_numpy(token_ids(8, np.random.default_rng(17))).cuda())
        return enc, video

    def mil_nce():
        return load_mil_nce_encoder(dtype="bfloat16", device="cuda", seed=0).encoder, uint8(16)

    families = (
        ("clip_bf16_fused", clip_bf16, k2_launches(LAYERS, towers=1)),
        ("fit_int8", fit("int8"), {k: n_ * FIT_LAYERS for k, n_ in FIT_INT8_LAUNCHES_PER_LAYER.items()}),
        ("fit_bf16", fit("bfloat16"), {k: n_ * FIT_LAYERS for k, n_ in FIT_BF16_LAUNCHES_PER_LAYER.items()}),
        ("slip_int8_module", slip_int8, {"fused_int8_qkv_attention": LAYERS,
                                         "int8_gemm_bias": 3 * LAYERS}),
        ("mil_nce_bf16", mil_nce, {"s3dg_stem": 1}))
    paths, readings = {}, {}
    for name, build, counts in families:
        start = time.perf_counter()
        enc, video = build()
        built_s = time.perf_counter() - start
        start = time.perf_counter()
        export_encode_fn(enc.encode_video, video[0], (n,), str(work / "export_families"), name)
        export_s = time.perf_counter() - start
        encode, _ = load_exported(str(work / "export_families"), name)
        for fn in wrappers.values():
            fn.launches = 0
        rows = encode(video)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        with torch.no_grad():
            eager = enc.encode_video(video)
        cos = min_cosine(rows, eager)
        want = {k: counts.get(k, 0) for k in wrappers}
        print(f"export (c) {name}: built {built_s:.1f} s, exported at bucket {n} in "
              f"{export_s:.1f} s; loaded vs eager min cosine {cos:.6f} (bit-equal "
              f"{torch.equal(rows, eager)}); launches of one call "
              f"{({k: c for k, c in launches.items() if c})}")
        require(cos >= EXPORT_EAGER_COSINE, f"export {name}: loaded vs eager cosine {cos}")
        require(launches == want, f"export {name}: launches {launches}, expected {want}")
        paths[f"export_{name}"] = launches
        readings[name] = {"cosine": cos, "export_s": export_s}
        del enc, video, encode, rows, eager
        torch.cuda.empty_cache()
    return paths, readings


def export_phase(torch, wrappers, work: Path, merges: str):
    """Phase 15: (a) int8 CLIP ViT-B/16 exported by export_serving and loaded in
    a fresh process, (b) the service from its artifacts, (c) one video bucket
    of every other family with a kernel, (d) the op dispatch's cost. Returns
    {path: launches}."""
    start = time.perf_counter()
    torch.set_grad_enabled(False)
    enc, overrides, scales, export_dir, paths, readings = export_clip_int8(
        torch, wrappers, work, merges)
    serve_paths, readings["service"] = export_service(torch, wrappers, enc, overrides, scales,
                                                      export_dir)
    paths.update(serve_paths)
    gen = torch.Generator(device="cuda").manual_seed(1)
    video32 = torch.randint(0, 256, (32, 4, 224, 224, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
    readings["dispatch"] = dispatch_readings(torch, enc, video32)
    del enc, video32
    torch.cuda.empty_cache()
    family_paths, readings["families"] = export_families(torch, wrappers, work)
    paths.update(family_paths)
    readings["phase_s"] = time.perf_counter() - start
    print(f"export: phase 15 in {readings['phase_s']:.1f} s")
    print(json.dumps({"export": readings, "card": nvidia_smi(), "clocks": clocks()}))
    return paths


def export_only(torch) -> int:
    """Phase 15 alone (``--export``): the build and a BPE vocabulary, then phase 15."""
    sys.path.insert(0, str(ROOT))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab

    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s; {nvidia_smi()}")
    work = ROOT / "build" / "chip_smoke_export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        merges, _ = write_tiny_test_vocab(str(work), list(CAPTION_WORDS))
        paths = export_phase(torch, kernel_wrappers(), work, merges)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"export_launches": {path: {k: n for k, n in c.items() if n}
                                          for path, c in paths.items()}}))
    return 0


DIST_STEPS = 3  # phase 16's training steps of each run
DIST_TIMEOUT_S = 400  # each of phase 16's child processes


def distributed_child(spec_path: str) -> int:
    """``--distributed-child SPEC``: one process of phase 16. Sets the
    environment the spec gives (torchrun's variables for a rank) and, where
    the spec asks for gloo, makes the gloo group itself (two ranks share the
    card, which NCCL refuses), which ``run`` then uses as it is. For each run
    it composes the config from config/ and calls
    ``fitclip_torch.cli.main.run(cfg)`` with the kernels' launches zeroed just
    before and read just after, the train steps timed (``timed_steps``), the
    FSDP state's bytes taken where the run shards it and the initial
    parameters saved where the run names an ``init`` file. Prints one JSON
    line: per run the launches, each step's ms, the printed output, the
    metrics that ``run_eval`` returned on this rank and the state's bytes."""
    import faulthandler
    import io
    import os

    import torch

    # A rank that hangs in a collective prints every thread's stack before the
    # parent gives up on it.
    faulthandler.dump_traceback_later(DIST_TIMEOUT_S - 60, exit=True)
    sys.path.insert(0, str(ROOT))
    spec = json.loads(Path(spec_path).read_text())
    os.environ.update(spec["env"])
    if spec.get("gloo"):
        torch.distributed.init_process_group("gloo")  # env://, the rank's variables
    from fitclip_torch.cli import runners
    from fitclip_torch.cli.main import DEFAULT_CONFIG_DIR, run
    from fitclip_torch.config_engine import compose
    from fitclip_torch.training import train_runner

    wrappers = kernel_wrappers()

    def counters():
        return {name: fn.launches for name, fn in wrappers.items()}

    results = []
    for item in spec["runs"]:
        readings = {"name": item["name"], "metrics": None, "bytes": None}
        run_eval, shard, init = (runners.run_eval, train_runner.shard_train_state,
                                 train_runner.init_train_state)

        def evaluating(*args, **kwargs):
            readings["metrics"] = run_eval(*args, **kwargs)
            return readings["metrics"]

        def held(state):
            named = state.named_parameters()
            return {"params": sum(p.numel() * p.element_size() for p in named.values()),
                    "moments": sum(m.numel() * m.element_size() for key in ("mu", "nu")
                                   for m in state.opt_state[key].values())}

        def sharding(state, optimizer):
            state = shard(state, optimizer)
            readings["bytes"] = state.fsdp.held_bytes(state)
            return state

        def initializing(*args, **kwargs):
            state = init(*args, **kwargs)
            readings["bytes"] = held(state)
            if item.get("init") and (not spec.get("gloo") or torch.distributed.get_rank() == 0):
                torch.save({n: p.detach().cpu() for n, p in state.named_parameters().items()},
                           item["init"])
            return state

        for fn in wrappers.values():
            fn.launches = 0
        out = io.StringIO()
        print(f"{item['name']}: {' '.join(item['overrides'])}", file=sys.stderr, flush=True)
        start = time.perf_counter()
        with swapped(runners, run_eval=evaluating), \
                swapped(train_runner, shard_train_state=sharding,
                        init_train_state=initializing), \
                timed_steps(torch, counters) as steps, contextlib.redirect_stdout(out):
            run(compose(DEFAULT_CONFIG_DIR, item["config"], item["overrides"]))
        torch.cuda.synchronize()
        readings.update(seconds=time.perf_counter() - start, launches=counters(),
                        printed=out.getvalue(),
                        steps=[{k: s[k] for k in ("launches", "wait_ms", "step_ms", "wall_ms")}
                               for s in steps])
        results.append(readings)
    if spec.get("gloo"):
        torch.distributed.destroy_process_group()
    print(json.dumps({"env": spec["env"], "runs": results}))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(work: Path, specs) -> list:
    """Starts one child per spec (together), waits for all, returns each one's
    JSON line; fails if a child fails or outlasts DIST_TIMEOUT_S."""
    procs = []
    for i, spec in enumerate(specs):
        path = work / f"spec{i}_{time.monotonic_ns()}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                       "--distributed-child", str(path)], cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            proc.kill()
            outs.append(proc.communicate())
    for proc, (stdout, stderr) in zip(procs, outs):
        require(proc.returncode == 0, f"phase 16 child exited {proc.returncode}:\n"
                                      f"{stdout[-3000:]}\n{stderr[-6000:]}")
    return [{run["name"]: run for run in json.loads(stdout.strip().splitlines()[-1])["runs"]}
            for stdout, _ in outs]


def _rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _losses(log_dir: Path):
    return [json.loads(line)["loss/train"] for line in
            (log_dir / "metrics.jsonl").read_text().splitlines() if "loss/train" in line]


UPDATE_SHARE = 1e-2  # tests/test_torch_parallel.py's bound on the update's L2 gap


def no_key_bias(name: str, x):
    """A parameter in float64 with the attention's key bias zeroed: its
    gradient is zero in exact arithmetic, so AdamW steps its rounding noise by
    about lr, and two correct runs part there by up to 2 lr."""
    import torch

    x = x.double()
    if name.endswith("in_proj.bias"):  # packed (q, k, v)
        x = x.clone()
        x[x.shape[0] // 3: 2 * x.shape[0] // 3] = 0
    return torch.zeros_like(x) if name.endswith("k_proj.bias") else x


def _params_close(torch, a: Path, b: Path, init: Path, rtol: float, atol: float):
    """(the largest |a - b| - rtol |b| over the parameters of two train-state
    files, <= atol when they agree at the FSDP bound; the L2 norm of a - b
    over that of b's update from ``init``). The key bias is left out of the
    second: its gradient is zero in exact arithmetic, so AdamW steps its
    rounding noise by about lr (tests/test_torch_parallel.py). Fails on
    other names."""
    from fitclip_torch.training.checkpointing import load_checkpoint

    a, b = load_checkpoint(str(a))["params"], load_checkpoint(str(b))["params"]
    init = torch.load(str(init), weights_only=True)
    require(set(a) == set(b) == set(init), "phase 16: the checkpoints hold other parameters")

    excess = max(float(((a[n] - b[n]).abs() - rtol * b[n].abs()).max()) for n in a)
    gap = sum(float((no_key_bias(n, a[n]) - no_key_bias(n, b[n])).square().sum()) for n in a)
    moved = sum(float((no_key_bias(n, b[n]) - no_key_bias(n, init[n])).square().sum())
                for n in a)
    require(moved > 0, "phase 16: the reference run did not move its parameters")
    return excess, (gap / moved) ** 0.5


def distributed_phase(torch, wrappers, work: Path, merges: str) -> dict:
    """Phase 16, after phase 15 on phase 11's and 13's trees (or on trees
    ``--distributed`` writes): the port's CLI under a process group, each rank
    a child process of this script (``--distributed-child``). (a)
    ``command=train`` in fp32 (contrastive, DIST_STEPS steps of webvid.yaml's
    28 clips) and teacher-student (bf16 student, the bf16 K2 teacher, 8 + 8
    clips) under torchrun's variables at world size 1 on NCCL, each last
    checkpoint bit-equal to the same run with no process group, K3f/K3b (and
    K2) launched as phase 13 counts them; (b) ``command=evaluate`` and
    ``predict`` of the int8 CLIP on MSR-VTT at world size 1: metrics and
    predictions equal to the no-group run's, K1's launches as phase 11's; (c)
    two ranks sharing the card over a gloo group each child makes: (a)'s
    contrastive run (losses within rel 1e-5 of (a)'s, parameters at rtol 1e-3
    / atol 3e-3 and the update's L2 gap within UPDATE_SHARE of (a)'s update),
    the same under ``++trainer.fsdp=true`` (the same bounds against the
    replicated two-rank run; each rank's parameter and moment bytes), and the
    int8 evaluate (metrics equal to (b)'s). The no-group and the NCCL process run at the
    same time, then the two ranks. Prints each run's step ms beside the
    no-group run's. Returns the launches per path."""
    phase_start = time.perf_counter()
    dist_dir = work / "distributed"
    shutil.rmtree(dist_dir, ignore_errors=True)
    dist_dir.mkdir(parents=True)
    encoder = ["encoder=clip_vit_b_16", f"+encoder.bpe_path={merges}"]

    def train(name, *extra, run="contrastive", keep_init=False):
        d = dist_dir / name
        d.mkdir(exist_ok=True)
        return {"name": run, "config": "trainer",
                "init": str(d / "init.pt") if keep_init else "",
                "overrides": ["command=train", *encoder, "data=webvid",
                              "trainer.log_every_n_steps=1", f"+trainer.max_steps={DIST_STEPS}",
                              f"+log_dir={d / 'logs'}",
                              f"trainer.callbacks.checkpoint.dirpath={d / 'ckpt'}", *extra]}

    def teacher_student(name):
        d = dist_dir / name
        return {"name": "teacher_student", "config": "teacher_student_trainer",
                "overrides": ["command=train", "+encoder@encoder.student=clip_vit_b_16",
                              "+encoder@encoder.teacher=clip_vit_b_16",
                              f"+encoder.student.bpe_path={merges}",
                              f"+encoder.teacher.bpe_path={merges}",
                              "++encoder.student.dtype=bfloat16",
                              "++encoder.teacher.dtype=bfloat16",
                              "++encoder.teacher.fused_block=true",
                              "data=mixed_batch_msrvtt_webvid",
                              "++model.labeled_dataset_loss_share=0.9999",
                              f"+trainer.max_steps={DIST_STEPS}", "trainer.val_check_interval=1.0",
                              "trainer.log_every_n_steps=1", f"+log_dir={d / 'logs'}",
                              f"trainer.callbacks.checkpoint.dirpath={d / 'ckpt'}"]}

    def int8(name, command):
        d = dist_dir / name
        d.mkdir(exist_ok=True)
        common = ["encoder=clip_vit_b_16", "++encoder.dtype=int8", "data=msrvtt",
                  f"+encoder.bpe_path={merges}", f"++quant.scales_path={d / 'scales.npz'}",
                  "++quant.calibration_batches=1"]
        tail = [f"+output_path={d / 'predictions.pt'}"] if command == "predict" else []
        return {"name": command, "config": "trainer",
                "overrides": [f"command={command}", *common, *tail]}

    def one_card(tag, env):
        return {"env": env, "runs": [train(f"{tag}_a", keep_init=tag == "nccl"),
                                     teacher_student(f"{tag}_ts"),
                                     int8(f"{tag}_b", "evaluate"), int8(f"{tag}_b", "predict")]}

    # The no-group and the NCCL process share the card at the same time (the
    # phase's time); their step ms are each other's contended twins.
    plain, nccl = _run_children(dist_dir, [one_card("plain", {}),
                                           one_card("nccl", _rank_env(0, 1, _free_port()))])
    gloo_port = _free_port()
    two = [{"env": _rank_env(rank, 2, gloo_port), "gloo": True,
            "runs": [train("gloo_a", keep_init=True),
                     train("gloo_fsdp", "++trainer.fsdp=true", run="fsdp"),
                     int8("gloo_b", "evaluate")]}
           for rank in (0, 1)]
    gloo = _run_children(dist_dir, two)

    def per_step(run):
        return [{k: n for k, n in s["launches"].items() if n} for s in run["steps"]]

    def step_ms(run):
        return [round(s["step_ms"], 1) for s in run["steps"]]

    # (a) training at world size 1 on NCCL against no group.
    fp32 = {k: 0 for k in wrappers}
    fp32.update({k: 2 * LAYERS for k in ("fused_attention_qkv", "fused_attention_qkv_backward",
                                         "attention_f32", "attention_bwd_f32")})
    bf16_ts = {k: 0 for k in wrappers}
    bf16_ts.update({**k2_launches(LAYERS), "fused_attention_qkv": 2 * LAYERS,
                    "fused_attention_qkv_backward": 2 * LAYERS})
    for name, tag, expected in (("contrastive", "a", fp32), ("teacher_student", "ts", bf16_ts)):
        same = checkpoints_equal(torch, dist_dir / f"plain_{tag}" / "ckpt" / "last",
                                 dist_dir / f"nccl_{tag}" / "ckpt" / "last")
        print(f"distributed (a) {name}: NCCL world size 1 last bit-equal to no group: {same}; "
              f"step ms {step_ms(nccl[name])} (no group {step_ms(plain[name])}, both processes "
              f"on the card at once); launches per step {per_step(nccl[name])}")
        require(same, f"(a) {name}: the NCCL run's last differs from the no-group run's")
        for run in (plain[name], nccl[name]):
            require(len(run["steps"]) == DIST_STEPS
                    and all(s["launches"] == expected for s in run["steps"]),
                    f"(a) {name} launches per step {per_step(run)}, expected {expected}")

    # (b) int8 evaluate and predict at world size 1.
    batches = -(-len(list((work / "msrvtt" / "videos" / "all").iterdir())) // EVAL_BATCH)
    k1 = {name: 0 for name in wrappers}
    k1.update({name: n * 2 * LAYERS * batches for name, n in INT8_LAUNCHES_PER_LAYER.items()})
    want = {"evaluate": {**k1, "fused_attention_qkv": 2 * LAYERS}, "predict": k1}
    predictions = [torch.load(dist_dir / f"{tag}_b" / "predictions.pt", weights_only=False)
                   for tag in ("plain", "nccl")]
    equal = (predictions[0]["video_ids"] == predictions[1]["video_ids"] and all(
        torch.equal(predictions[0][k], predictions[1][k])
        for k in ("encoded_videos", "encoded_texts")))
    print(f"distributed (b): NCCL world size 1 metrics {nccl['evaluate']['metrics']} (no group "
          f"{plain['evaluate']['metrics']}); predictions bit-equal {equal}; evaluate "
          f"{nccl['evaluate']['seconds']:.2f} s, predict {nccl['predict']['seconds']:.2f} s "
          f"(no group {plain['evaluate']['seconds']:.2f}, {plain['predict']['seconds']:.2f})")
    require(nccl["evaluate"]["metrics"] == plain["evaluate"]["metrics"] and equal,
            "(b) the NCCL run's metrics or predictions differ from the no-group run's")
    for run in (plain, nccl):
        for command in ("evaluate", "predict"):
            require(run[command]["launches"] == want[command],
                    f"(b) {command} launches {run[command]['launches']}")

    # (c) two ranks sharing the card over gloo.
    nccl_losses = _losses(dist_dir / "nccl_a" / "logs")
    rep_losses = _losses(dist_dir / "gloo_a" / "logs")
    fsdp_losses = _losses(dist_dir / "gloo_fsdp" / "logs")
    rel = max(abs(a - b) / abs(b) for a, b in zip(rep_losses, nccl_losses))
    rel_fsdp = max(abs(a - b) / abs(b) for a, b in zip(fsdp_losses, rep_losses))
    excess, gap = _params_close(torch, dist_dir / "gloo_a" / "ckpt" / "last",
                                dist_dir / "nccl_a" / "ckpt" / "last",
                                dist_dir / "nccl_a" / "init.pt", 1e-3, 3e-3)
    excess_fsdp, gap_fsdp = _params_close(torch, dist_dir / "gloo_fsdp" / "ckpt" / "last",
                                          dist_dir / "gloo_a" / "ckpt" / "last",
                                          dist_dir / "gloo_a" / "init.pt", 1e-3, 3e-3)
    rep_name, fsdp_name = "contrastive", "fsdp"
    for rank, ranks in enumerate(gloo):
        print(f"distributed (c) rank {rank}: replicated step ms {step_ms(ranks[rep_name])}, "
              f"bytes {ranks[rep_name]['bytes']}; FSDP step ms {step_ms(ranks[fsdp_name])}, "
              f"bytes {ranks[fsdp_name]['bytes']}; evaluate {ranks['evaluate']['metrics']} in "
              f"{ranks['evaluate']['seconds']:.2f} s (NCCL world size 1 "
              f"{nccl['evaluate']['seconds']:.2f} s; each rank decodes every clip)")
        for name in (rep_name, fsdp_name):
            require(len(ranks[name]["steps"]) == DIST_STEPS
                    and all(s["launches"] == fp32 for s in ranks[name]["steps"]),
                    f"(c) {name} rank {rank} launches per step {per_step(ranks[name])}")
        full, part = ranks[rep_name]["bytes"], ranks[fsdp_name]["bytes"]
        require(part["params"] < 0.6 * full["params"] and part["moments"] < 0.6 * full["moments"],
                f"(c) rank {rank} holds {part} of {full} under FSDP")
        require(ranks["evaluate"]["metrics"] == nccl["evaluate"]["metrics"],
                f"(c) rank {rank} evaluate {ranks['evaluate']['metrics']} != (b)'s")
        require(ranks["evaluate"]["launches"] == want["evaluate"],
                f"(c) rank {rank} evaluate launches {ranks['evaluate']['launches']}")
    print(f"distributed (c): losses {rep_losses} (NCCL world size 1 {nccl_losses}), largest "
          f"relative difference {rel:.3g}; FSDP losses {fsdp_losses}, against the replicated "
          f"{rel_fsdp:.3g}; params past rtol 1e-3 by at most {excess:.3g} (FSDP {excess_fsdp:.3g}"
          f"), bound 3e-3; update L2 gap {gap:.3g} of the reference's update (FSDP "
          f"{gap_fsdp:.3g}), bound {UPDATE_SHARE:g}")
    require(len(rep_losses) == len(fsdp_losses) == DIST_STEPS and rel <= 1e-5
            and rel_fsdp <= 1e-5, f"(c) losses {rep_losses} {fsdp_losses} {nccl_losses}")
    require(excess <= 3e-3 and excess_fsdp <= 3e-3, f"(c) params {excess}, {excess_fsdp}")
    require(gap <= UPDATE_SHARE and gap_fsdp <= UPDATE_SHARE, f"(c) update gap {gap}, {gap_fsdp}")
    print(f"distributed: phase 16 took {time.perf_counter() - phase_start:.1f} s "
          f"({nvidia_smi()})")

    def summed(*runs):
        return {k: sum(run["launches"][k] for run in runs) for k in wrappers}

    return {"distributed_train": summed(*(run[n] for run in (plain, nccl)
                                          for n in ("contrastive", "teacher_student")),
                                        *(r[n] for r in gloo for n in (rep_name, fsdp_name))),
            "distributed_eval": summed(*(run[n] for run in (plain, nccl)
                                         for n in ("evaluate", "predict")),
                                       *(r["evaluate"] for r in gloo))}


def distributed_only(torch) -> int:
    """Phase 16 alone (``--distributed``): the build, phase 11's MSR-VTT tree and
    BPE vocabulary and phase 13's WebVid train tree and MSR-VTT train list,
    then phase 16."""
    import os

    sys.path.insert(0, str(ROOT))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab

    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s; {nvidia_smi()}")
    work = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    try:
        start = time.perf_counter()
        ids, captions = write_msrvtt_tree(work / "msrvtt")
        merges, _ = write_tiny_test_vocab(str(work), [w for c in captions for w in c.split()])
        (work / "msrvtt" / "structured-symlinks" / "train_list_jsfusion.txt").write_text(
            "\n".join(ids))
        os.environ.update(write_drift_trees(work), **write_webvid_train_tree(work),
                          MSRVTT_PATH=str(work / "msrvtt"))
        print(f"distributed: wrote the trees in {time.perf_counter() - start:.1f} s")
        paths = distributed_phase(torch, kernel_wrappers(), work, merges)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"distributed": {path: {k: n for k, n in c.items() if n}
                                      for path, c in paths.items()}, "card": nvidia_smi()}))
    return 0


# Phase 17: the per-epoch evaluation loop (python -m fitclip_torch.cli.evaluate_per_epoch).
SHORT_SIDE = 224  # decode_short_side on the 720p tree: its 720-row frames are >= 2x it
SHORT_SIDE_CLIPS, SHORT_SIDE_SIZE, SHORT_SIDE_FRAMES = 4, (1280, 720), 48


def short_side_readings(torch, work: Path):
    """Decode's ms a clip on a tree of SHORT_SIDE_CLIPS 1280 x 720 MJPG AVIs,
    with ``decode_short_side=SHORT_SIDE`` and without: each clip's eval
    sample of 4 frames opened, decoded and transformed to 224^2 serially,
    median over the clips (warm: every clip read once first). Returns (the
    readings, the clips' paths); the caller removes the clips."""
    import cv2

    from fitclip_torch.data.frame_sampler import UniformFrameSampler
    from fitclip_torch.data.transforms import eval_transform
    from fitclip_torch.data.video_reader import VideoReader

    root = work / "hd"
    root.mkdir()
    rng = np.random.default_rng(5)
    paths = []
    for i in range(SHORT_SIDE_CLIPS):
        width, height = SHORT_SIDE_SIZE
        base = cv2.resize(rng.integers(0, 256, (18, 32, 3), dtype=np.uint8), (width, height),
                          interpolation=cv2.INTER_LINEAR)
        path = root / f"hd{i}.avi"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), EVAL_FPS,
                                 SHORT_SIDE_SIZE)
        require(writer.isOpened(), "cv2 cannot write MJPG here")
        for t in range(SHORT_SIDE_FRAMES):
            writer.write(np.roll(base, (t, 2 * t), axis=(0, 1)))
        writer.release()
        paths.append(path)
    sampler = UniformFrameSampler(4)
    readings, shapes = {}, {}
    for label, side in (("full", None), ("short_side", SHORT_SIDE), ("full_again", None)):
        decode, item = [], []
        for path in paths:
            t0 = time.perf_counter()
            reader = VideoReader.from_path(path, short_side=side)
            frames = reader(sampler(0, len(reader) - 1, fps=reader.get_avg_fps(), rng=None))
            t1 = time.perf_counter()
            out = eval_transform(frames, 224)
            item.append(time.perf_counter() - t0)
            decode.append(t1 - t0)
            shapes[label] = (tuple(frames.shape[1:3]), tuple(out.shape))
        readings[label] = {"decode_ms": 1e3 * float(np.median(decode)),
                           "item_ms": 1e3 * float(np.median(item))}
    require(shapes["short_side"][0][0] == SHORT_SIDE and shapes["full"][0] == (720, 1280)
            and shapes["short_side"][1] == shapes["full"][1] == (4, 224, 224, 3),
            f"short side shapes {shapes}")
    print(f"per-epoch short side: {SHORT_SIDE_CLIPS} clips of {SHORT_SIDE_SIZE[0]}x"
          f"{SHORT_SIDE_SIZE[1]}, 4 frames each, {type(reader).__name__}; decoded "
          f"{shapes['full'][0]} without, {shapes['short_side'][0]} with decode_short_side="
          f"{SHORT_SIDE}; median ms a clip (open + decode; with the transform to 224^2): " +
          "; ".join(f"{k} {v['decode_ms']:.3f} / {v['item_ms']:.3f}" for k, v in readings.items())
          + f" ({nvidia_smi()})")
    return readings, paths


F32_TOL = 2e-4  # the float contract (tests/test_block_kernel.py:55-87)
SUBCORR_ATOL = F32_TOL  # subcorr's probabilities, K3f against the einsum attention (fp32)
# The seeded model's frame and text embeddings are far enough apart that the
# default temperature (0.015) saturates the softmax to exact 0s and 1s, which
# would hide a gap; at 1 the probabilities stay soft.
SUBCORR_TEMPERATURE = 1.0


def subcorr_check(torch, wrappers, work: Path, video: Path, checkpoint: Path, merges: str,
                  texts):
    """``python -m fitclip_torch.utils.subcorr`` (its ``main``) at ViT-B/16 on
    the card on one 720p clip, every frame, with ``checkpoint`` and
    ``--temperature SUBCORR_TEMPERATURE``: K3f's fp32
    launches are 12 layers a tower call (the frames in chunks of
    subcorr.FRAME_CHUNK, the texts once); the probabilities are finite rows
    that sum to 1, within SUBCORR_ATOL of the same run with fused_attention
    off (no K3f launch), and the PNG is written. Returns (launches, readings)."""
    import io

    import cv2

    from fitclip_torch.models.clip import load as L
    from fitclip_torch.utils import subcorr

    argv = [str(video), *texts, "--checkpoint-path", str(checkpoint), "--bpe-path", merges,
            "--device", "cuda", "--temperature", str(SUBCORR_TEMPERATURE)]
    runs, outputs = {}, {}
    load = L.load_clip_encoder
    for label, fused in (("fused", True), ("plain", False)):
        png = work / f"subcorr_{label}.png"
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        with swapped(L, load_clip_encoder=lambda *a, **k: load(*a, fused_attention=fused, **k)), \
                contextlib.redirect_stdout(io.StringIO()):
            probs = subcorr.main([*argv, "--output", str(png)])
        torch.cuda.synchronize()
        runs[label] = {"seconds": time.perf_counter() - start,
                       "launches": {n: fn.launches for n, fn in wrappers.items()},
                       "png": cv2.imread(str(png)) is not None}
        outputs[label] = probs
    frames = outputs["fused"].shape[0]
    chunks = -(-frames // subcorr.FRAME_CHUNK)
    expected = {name: 0 for name in wrappers}
    expected.update(fused_attention_qkv=LAYERS * (chunks + 1), attention_f32=LAYERS * (chunks + 1))
    gap = float(np.abs(outputs["fused"] - outputs["plain"]).max())
    print(f"per-epoch subcorr: ViT-B/16 fp32, {frames} frames of {video.name} x {len(texts)} "
          f"texts, {runs['fused']['seconds']:.2f} s (einsum attention "
          f"{runs['plain']['seconds']:.2f} s, model load included); launches "
          f"{ {k: n for k, n in runs['fused']['launches'].items() if n} } (expected "
          f"{ {k: n for k, n in expected.items() if n} }), the einsum run's "
          f"{ {k: n for k, n in runs['plain']['launches'].items() if n} }; probabilities "
          f"{float(outputs['fused'].min()):.6f} to {float(outputs['fused'].max()):.6f} at "
          f"temperature {SUBCORR_TEMPERATURE}, max |probability gap| {gap:.3e} (bound "
          f"{SUBCORR_ATOL}); PNGs written {runs['fused']['png']}, "
          f"{runs['plain']['png']} ({nvidia_smi()})")
    rows = outputs["fused"]
    require(rows.shape == (frames, len(texts)) and frames > 0 and np.isfinite(rows).all()
            and np.allclose(rows.sum(1), 1.0, atol=1e-5), f"subcorr probabilities {rows}")
    require(runs["fused"]["launches"] == expected,
            f"subcorr launches {runs['fused']['launches']}, expected {expected}")
    require(not any(runs["plain"]["launches"].values()),
            f"subcorr with fused_attention off launched {runs['plain']['launches']}")
    require(gap <= SUBCORR_ATOL, f"subcorr: probabilities {gap} apart with and without K3f")
    require(runs["fused"]["png"] and runs["plain"]["png"], "subcorr wrote no PNG")
    return runs["fused"]["launches"], {"frames": frames, "seconds": runs["fused"]["seconds"],
                                       "max_abs_gap": gap}


def per_epoch_phase(torch, wrappers, work: Path, tree, checkpoints, student_export: Path,
                    direct_merged: Path):
    """Phase 17: ``python -m fitclip_torch.cli.evaluate_per_epoch`` (its
    ``main``, in this process) over two train-state files (``checkpoints``) and
    phase 11's MSR-VTT and WebVid val trees, with FRAME_CACHE set. Gates: the
    first checkpoint fills the cache (one file a clip), the second opens no
    video, K3f's fp32 launches are 2 towers x 12 layers a batch, the metrics
    are finite; ``command=predict encoder=wise`` of the second checkpoint's
    prepared file on the warm cache opens no video and its embeddings are
    bit-equal to the same run with no cache; ``python -m
    fitclip_torch.convert.apply_wise_ft`` of the seeded ViT-B/16 and
    ``student_export`` is bit-equal to phase 14 (d)'s ``direct_merged`` (a NaN
    logit_scale besides); the generic ``prepare_trained_checkpoint_for_evaluation``
    gives the CLIP preparation's tensors without logit_scale; ``subcorr`` runs
    on a 720p clip (``subcorr_check``). Prints each checkpoint's eval window
    cold and warm with its items' ms a clip, and decode's ms a clip with and
    without decode_short_side. Returns ({path: launches}, readings)."""
    import io
    import os
    import threading

    from fitclip_torch.cli import evaluate_per_epoch
    from fitclip_torch.convert import apply_wise_ft
    from fitclip_torch.convert import prepare_trained_checkpoint_for_evaluation as prepare_generic
    from fitclip_torch.convert import prepare_trained_clip_checkpoint_for_evaluation as prepare
    from fitclip_torch.convert.openai_state_dict import openai_state_dict
    from fitclip_torch.data.video_dataset import VideoDataset
    from fitclip_torch.data.video_reader import VideoReader
    from fitclip_torch.models.clip.load import load_clip_encoder

    phase_start = time.perf_counter()
    epochs, cache = work / "per_epoch", work / "frame_cache"
    shutil.rmtree(epochs, ignore_errors=True)
    shutil.rmtree(cache, ignore_errors=True)
    epochs.mkdir()
    for i, ckpt in enumerate(checkpoints):
        (epochs / f"epoch_{i}").symlink_to(ckpt)
    merges = tree["merges"]
    extra = [f"+encoder.model1.bpe_path={merges}", f"+encoder.model2.bpe_path={merges}"]
    os.environ.update(CKPT_GLOB=str(epochs / "epoch_*"), BENCHMARKS="msrvtt,webvid",
                      WISE_WEIGHT=str(WISE_WEIGHT), FRAME_CACHE=str(cache))
    clips = len(tree["ids"]) + DRIFT_ITEMS
    batches = -(-len(tree["ids"]) // EVAL_BATCH) + -(-DRIFT_ITEMS // EVAL_BATCH)

    lock, opens, items = threading.Lock(), [0], []
    from_path, getitem, prepare_main = VideoReader.from_path, VideoDataset.__getitem__, prepare.main

    def counted(path, short_side=None):
        with lock:
            opens[0] += 1
        return from_path(path, short_side=short_side)

    def timed(self, index, rng=None):
        t0 = time.perf_counter()
        try:
            return getitem(self, index, rng)
        finally:
            with lock:
                items.append(time.perf_counter() - t0)

    marks = []  # (opens, items, launches, perf_counter) as each checkpoint starts

    def marking(argv):
        torch.cuda.synchronize()
        marks.append((opens[0], len(items), {n: fn.launches for n, fn in wrappers.items()},
                      time.perf_counter()))
        start = time.perf_counter()
        prepare_main(argv)
        marks[-1] += (time.perf_counter() - start,)

    for fn in wrappers.values():
        fn.launches = 0
    out = io.StringIO()
    print(f"per-epoch: CKPT_GLOB={os.environ['CKPT_GLOB']} BENCHMARKS=msrvtt,webvid "
          f"WISE_WEIGHT={WISE_WEIGHT} FRAME_CACHE={cache} python -m "
          f"fitclip_torch.cli.evaluate_per_epoch {' '.join(extra)}")
    level = logging.getLogger().level  # silent=true quiets the root logger
    try:
        with swapped(VideoReader, from_path=staticmethod(counted)), \
                swapped(VideoDataset, __getitem__=timed), swapped(prepare, main=marking), \
                contextlib.redirect_stdout(out):
            evaluate_per_epoch.main(extra)
    finally:
        logging.getLogger().setLevel(level)
    torch.cuda.synchronize()
    marks.append((opens[0], len(items), {n: fn.launches for n, fn in wrappers.items()},
                  time.perf_counter(), 0.0))
    printed = out.getvalue()
    decoder, jobs, at = json.JSONDecoder(), [], 0
    while (found := printed.find("{", at)) >= 0:
        value, at = decoder.raw_decode(printed, found)
        jobs.append(value)
    windows = []
    for (o0, i0, l0, t0, prep_s), (o1, i1, l1, t1, _) in zip(marks, marks[1:]):
        windows.append({"wall_s": t1 - t0, "prepare_s": prep_s, "eval_s": t1 - t0 - prep_s,
                        "opens": o1 - o0, "items": i1 - i0,
                        "item_ms_mean": 1e3 * float(np.mean(items[i0:i1])) if i1 > i0 else None,
                        "launches": {n: l1[n] - l0[n] for n in wrappers}})
    expected = {name: 0 for name in wrappers}
    expected.update(fused_attention_qkv=2 * LAYERS * batches, attention_f32=2 * LAYERS * batches)
    cached = len(os.listdir(cache))
    for label, w, ckpt in zip(("cold", "warm"), windows, checkpoints):
        print(f"per-epoch {label} ({ckpt.relative_to(work)}): {w['wall_s']:.2f} s "
              f"(prepare {w['prepare_s']:.2f} s, the two eval jobs {w['eval_s']:.2f} s); "
              f"{w['opens']} videos opened; {w['items']} items at {w['item_ms_mean']:.3f} ms "
              f"a clip (on {EVAL_BATCH}-item batches, 8 loader threads); launches "
              f"{ {k: n for k, n in w['launches'].items() if n} }")
    print(f"per-epoch: jobs' metrics {jobs}; {cached} cache files ({nvidia_smi()})")
    require(len(jobs) == 4 and all(np.isfinite(v) for job in jobs for v in job.values())
            and all("r1" in job for job in jobs), f"per-epoch jobs {jobs}")
    require(len(windows) == 2 and windows[0]["opens"] == clips and cached == clips,
            f"per-epoch: the first checkpoint opened {windows[0]['opens']} videos and left "
            f"{cached} cache files, expected {clips}")
    require(windows[1]["opens"] == 0, f"per-epoch: the warm checkpoint opened "
                                      f"{windows[1]['opens']} videos")
    require(all(w["launches"] == expected for w in windows),
            f"per-epoch launches {[w['launches'] for w in windows]}, expected {expected}")

    # The cached predictions against the same checkpoint's with no cache.
    prepared = work / "per_epoch_prepared.pt"
    prepare.main([str(checkpoints[1]), str(prepared)])
    wise = [o for o in evaluate_per_epoch.wise_overrides(str(prepared), str(WISE_WEIGHT), "msrvtt",
                                                         None) if o not in (
        "command=evaluate", "silent=true")] + extra
    dumps, predict_launches, predict_opens = [], [], []
    for label, override in (("cache", [f"++data.eval_frame_cache_dir={cache}"]), ("plain", [])):
        dump = work / f"per_epoch_{label}.pt"
        before = opens[0]
        with swapped(VideoReader, from_path=staticmethod(counted)):
            _, _, seconds, launches = cli_run(torch, wrappers, ["command=predict", *wise,
                                                                *override, f"+output_path={dump}"])
        predict_opens.append(opens[0] - before)
        predict_launches.append(launches)
        dumps.append(torch.load(dump, weights_only=False))
        print(f"per-epoch predict ({label}): {seconds:.2f} s wall, {opens[0] - before} videos "
              f"opened")
    same = dumps[0]["video_ids"] == dumps[1]["video_ids"] and all(
        torch.equal(dumps[0][k], dumps[1][k]) for k in ("encoded_videos", "encoded_texts"))
    print(f"per-epoch predict: cached embeddings bit-equal to the run with no cache: {same}")
    require(same, "per-epoch: the cached predictions differ from the decoded ones")
    require(predict_opens == [0, len(tree["ids"])], f"per-epoch predict opens {predict_opens}")

    # Offline WiSE-FT against phase 14 (d)'s merge, written directly.
    exported = torch.load(student_export, weights_only=False)
    seeded = openai_state_dict(load_clip_encoder("ViT-B/16", device="cpu", seed=0)
                               .encoder.model.state_dict())
    if "visual.conv1.bias" in exported and "visual.conv1.bias" not in seeded:
        seeded["visual.conv1.bias"] = torch.zeros_like(exported["visual.conv1.bias"])
    torch.save(seeded, work / "seeded_openai.pt")
    merged_path = work / "wise_ft.pt"
    start = time.perf_counter()
    apply_wise_ft.main([str(work / "seeded_openai.pt"), str(student_export), str(merged_path),
                        "--weight-for-2", str(WISE_WEIGHT)])
    wise_s = time.perf_counter() - start
    merged, direct = (torch.load(p, weights_only=False) for p in (merged_path, direct_merged))
    bitwise = set(merged) == set(direct) | {"logit_scale"} and all(
        torch.equal(merged[k], direct[k]) for k in direct)
    print(f"per-epoch: python -m fitclip_torch.convert.apply_wise_ft seeded student "
          f"--weight-for-2 {WISE_WEIGHT}: {wise_s:.2f} s; {len(merged)} tensors, bit-equal to "
          f"phase 14 (d)'s merged state dict: {bitwise}; logit_scale "
          f"{float(merged['logit_scale'])}")
    require(bitwise and bool(torch.isnan(merged["logit_scale"])),
            "per-epoch: apply_wise_ft's file differs from the directly merged state dict")

    # The generic (non-CLIP) preparation: the CLIP one's tensors, no logit_scale.
    generic_path = work / "per_epoch_generic.pt"
    prepare_generic.main([str(checkpoints[1]), str(generic_path), "--prefix", "encoder.model"])
    generic, clip_prepared = (torch.load(p, weights_only=False) for p in (generic_path, prepared))
    generic_same = set(generic) == set(clip_prepared) - {"logit_scale"} and all(
        torch.equal(generic[k], clip_prepared[k]) for k in generic)
    print(f"per-epoch: python -m fitclip_torch.convert.prepare_trained_checkpoint_for_evaluation "
          f"--prefix encoder.model: {len(generic)} tensors, bit-equal to the CLIP preparation's "
          f"but for logit_scale: {generic_same}")
    require(generic_same, "per-epoch: the generic preparation differs from the CLIP one")

    short_side, hd_clips = short_side_readings(torch, work)
    annotations = json.loads((tree["root"] / "annotation" / "MSR_VTT.json").read_text())
    texts = [a["caption"] for a in annotations["annotations"][:3]]
    subcorr_launches, subcorr_readings = subcorr_check(torch, wrappers, work, hd_clips[0],
                                                       prepared, merges, texts)
    shutil.rmtree(hd_clips[0].parent, ignore_errors=True)
    for path in (prepared, merged_path, work / "seeded_openai.pt", generic_path,
                 work / "subcorr_fused.png", work / "subcorr_plain.png"):
        path.unlink()
    shutil.rmtree(cache, ignore_errors=True)
    seconds = time.perf_counter() - phase_start
    print(f"per-epoch: phase 17 took {seconds:.1f} s ({nvidia_smi()})")
    readings = {"cold": {k: v for k, v in windows[0].items() if k != "launches"},
                "warm": {k: v for k, v in windows[1].items() if k != "launches"},
                "short_side": short_side, "subcorr": subcorr_readings, "seconds": seconds}
    print(json.dumps({"per_epoch": readings, "card": nvidia_smi()}))
    return {"per_epoch_cold": windows[0]["launches"], "per_epoch_warm": windows[1]["launches"],
            "per_epoch_predict": predict_launches[0],
            "per_epoch_predict_plain": predict_launches[1],
            "subcorr": subcorr_launches}, readings


# Phase 18: tensor parallelism and the GPipe pipeline, four gloo ranks sharing the card.
GRID_RANKS, GRID_STEPS, GRID_ROWS = 4, 3, 8  # ranks; TP steps; global batch of clips
GRID_LR, GRID_CLIP = 1e-4, 1.0
PIPE_MICROBATCHES, PIPE_ROWS = 4, 8  # GPipe over 4 stages: microbatches; frames of 197 tokens


GRID_GRAD_SHARE, GRID_NORM_RTOL = 1e-3, 1e-4  # the first step's gradient, leaf by leaf; its norm


def recording_clip(torch, optimizer, names):
    """Wrap ``optimizer``'s global-norm clip so that it keeps what the first
    step hands it: {"grads": {name: the fp32 gradient, after the data
    average}, "norm": the clip's norm}. ``names``: the trainable state
    parameters in the state's order (as ``AdamW.apply`` lists them)."""
    seen, clip = {}, optimizer._clip

    def recording(grads, norm=None):
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if not seen:
            seen.update(grads={n: g.detach().clone() for n, g in zip(names, grads)},
                        norm=float(norm))
        return clip(grads, norm)

    optimizer._clip = recording
    return seen


def publish(torch, obj, path: Path) -> None:
    """torch.save to ``path`` whole: a reader that sees the file sees all of it."""
    partial = path.with_suffix(".partial")
    torch.save(obj, partial)
    partial.replace(path)


def awaited(path: str) -> str:
    """``path`` once it exists (phase 18's parent publishes its references
    while the ranks run; faulthandler ends a rank that waits too long)."""
    while not Path(path).exists():
        time.sleep(0.2)
    return path


def grid_inputs(torch):
    """Phase 18's seeded inputs, the same in every process: the TP batch (on
    the card) and the pipeline's (PIPE_ROWS, 197, 768) activations."""
    rng = np.random.default_rng(18)
    video = torch.from_numpy(rng.integers(0, 256, (GRID_ROWS, 4, 224, 224, 3),
                                          dtype=np.uint8)).cuda()
    text = torch.from_numpy(token_ids(GRID_ROWS, rng)).cuda()
    h = torch.from_numpy(rng.standard_normal((PIPE_ROWS, 197, 768)).astype(np.float32)).cuda()
    return video, text, h


def grid_child(spec_path: str) -> int:
    """``--grid-child SPEC``: one rank of phase 18 (gloo, on cuda:0). (a) TP on
    a (data=2, model=2) grid: GRID_STEPS contrastive steps of the seeded fp32
    ViT-B/16 on this data row's clips; rank 0 gathers the parameters and the
    first step's gradients (as the clip receives them) and holds them to the
    one-process steps' (the parent's file). (b) The GPipe
    pipeline over the four ranks: the seeded visual tower's 12 blocks, this
    stage's 3 kept, PIPE_MICROBATCHES microbatches; the output and this
    stage's gradients against the sequential tower's (the parent's file).
    Prints one JSON line of readings and launch counts."""
    import faulthandler
    import os

    import torch
    import torch.distributed as dist

    faulthandler.dump_traceback_later(DIST_TIMEOUT_S - 60, exit=True)
    sys.path.insert(0, str(ROOT))
    spec = json.loads(Path(spec_path).read_text())
    rank = spec["rank"]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{spec['port']}",
                            world_size=GRID_RANKS, rank=rank)
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.parallel.mesh import create_grid
    from fitclip_torch.parallel.pipeline import pipeline_apply, stage_layers
    from fitclip_torch.parallel.sharding_rules import gathered_params, shard_params
    from fitclip_torch.training import state as S
    from fitclip_torch.training import steps as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = kernel_wrappers()

    def zeroed():
        for fn in wrappers.values():
            fn.launches = 0

    def counted():
        return {name: fn.launches for name, fn in wrappers.items()}

    video, text, h = grid_inputs(torch)
    out = {"rank": rank}

    # (a) Tensor parallelism.
    grid = create_grid(2, GRID_RANKS // 2)
    rows = slice(grid.data_index * GRID_ROWS // 2, (grid.data_index + 1) * GRID_ROWS // 2)
    encoder = load_clip_encoder("ViT-B/16", device="cuda", seed=0).encoder
    shard_params(encoder, grid)
    optimizer = S.make_optimizer(GRID_LR, gradient_clip_val=GRID_CLIP)
    state = S.init_train_state(encoder, optimizer)
    seen = recording_clip(torch, optimizer, [n for n in state.named_parameters()
                                             if optimizer.trainable(n)])
    step = T.make_contrastive_train_step(encoder, optimizer)
    losses, step_ms = [], []
    zeroed()
    for _ in range(GRID_STEPS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = step(state, {"video": video[rows], "text": text[rows]})
        losses.append(float(metrics["loss/train"]))
        step_ms.append(1e3 * (time.perf_counter() - start))
    out["tp"] = {"losses": losses, "step_ms": step_ms, "launches": counted(),
                 "local_bytes": sum(p.numel() * p.element_size()
                                    for p in encoder.model.parameters())}
    whole = gathered_params(encoder.model)
    grads = gathered_params(encoder.model, {n[len("encoder."):]: g for n, g in
                                            seen["grads"].items() if n.startswith("encoder.")})
    grads = {f"encoder.{n}": g for n, g in grads.items()}
    grads["logit_scale"] = seen["grads"]["logit_scale"]
    out["tp"]["norm"] = seen["norm"]
    if rank == 0:
        reference = torch.load(awaited(spec["tp_reference"]), weights_only=True)
        after, before = reference["after"], reference["before"]
        shares = {}
        for n, g in grads.items():
            gap = float((g.cpu().double() - reference["grads"][n].double()).norm())
            scale = float(reference["grads"][n].double().norm())
            shares[n] = gap / scale if scale else (0.0 if gap == 0 else float("inf"))
        worst = max(shares, key=shares.get)
        out["tp"].update(grad_leaves=len(shares), grad_worst=[worst, shares[worst]],
                         grad_over=sorted(n for n, v in shares.items()
                                          if not v <= GRID_GRAD_SHARE),
                         reference_norm=reference["norm"])
        gap = sum(float((no_key_bias(n, whole[n].cpu()) - no_key_bias(n, after[n]))
                        .square().sum()) for n in after)
        moved = sum(float((no_key_bias(n, after[n]) - no_key_bias(n, before[n]))
                          .square().sum()) for n in after)
        out["tp"].update(gap=gap ** 0.5, moved=moved ** 0.5)
    del encoder, state, whole, grads, seen, optimizer
    torch.cuda.empty_cache()

    # (b) The GPipe pipeline: only this stage's blocks stay on the card.
    blocks = load_clip_encoder("ViT-B/16", device="cpu", seed=0,
                               fused_attention=True).encoder.model.visual
    local = stage_layers(blocks.transformer.blocks, rank, GRID_RANKS).cuda()
    del blocks
    zeroed()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = pipeline_apply(lambda block, x: block(x), local, h, PIPE_MICROBATCHES)
    torch.cuda.synchronize()
    forward_ms = 1e3 * (time.perf_counter() - start)
    start = time.perf_counter()
    grads = torch.autograd.grad(result.square().mean() / GRID_RANKS, list(local.parameters()))
    torch.cuda.synchronize()
    backward_ms = 1e3 * (time.perf_counter() - start)
    reference = torch.load(awaited(spec["pipe_reference"]), weights_only=True)
    per = LAYERS // GRID_RANKS
    names = [f"{rank * per + int(n.split('.', 1)[0])}.{n.split('.', 1)[1]}"
             for n, _ in local.named_parameters()]
    out["pipeline"] = {
        "blocks": len(local), "forward_ms": forward_ms, "backward_ms": backward_ms,
        "max_abs_err": float((result.cpu() - reference["out"]).abs().max()),
        "close": bool(torch.allclose(result.cpu(), reference["out"], rtol=F32_TOL, atol=F32_TOL)),
        "grad_gap_sq": sum(float((g.cpu().double() - reference["grads"][n].double()).square()
                                 .sum()) for n, g in zip(names, grads)),
        "grad_sq": sum(float(reference["grads"][n].double().square().sum()) for n in names),
        "launches": counted()}
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(out))
    return 0



def grid_phase(torch, wrappers, work: Path):
    """Phase 18: four gloo ranks that share the card, each a child process
    (``--grid-child``), started before this process computes the one-device
    references they are held to: (a) TP, model = 2 and data = 2, GRID_STEPS contrastive
    steps of the seeded fp32 ViT-B/16 with the global-norm clip: every step's
    loss within rel 1e-4 of the same steps in this process (one device, the
    whole batch), the first step's gradients gathered whole within
    GRID_GRAD_SHARE of theirs leaf by leaf (relative L2) and the clip's norm
    within GRID_NORM_RTOL (AdamW's first step is about lr · sign(g), so only
    these see a gradient off by a factor or a norm counted on the wrong
    ranks), the gathered update within UPDATE_SHARE of theirs; (b) the
    GPipe pipeline of the visual tower's 12 blocks over 4 stages with
    PIPE_MICROBATCHES microbatches: the output within the fp32 tolerance of
    the sequential tower's and the gradients within UPDATE_SHARE (relative
    L2). K3f and K3b (fp32) are counted per rank. Returns {path: launches}."""
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.training import state as S
    from fitclip_torch.training import steps as T

    phase_start = time.perf_counter()
    video, text, h = grid_inputs(torch)
    # The ranks start first (a process takes seconds to reach the card) and
    # wait for each reference file, which this process computes meanwhile and
    # publishes whole (os.replace).
    tp_reference = work / "grid_tp_reference.pt"
    pipe_reference = work / "grid_pipe_reference.pt"
    port = _free_port()
    procs, logs = [], []
    for rank in range(GRID_RANKS):
        path = work / f"grid_spec{rank}.json"
        path.write_text(json.dumps({"rank": rank, "port": port, "tp_reference": str(tp_reference),
                                    "pipe_reference": str(pipe_reference)}))
        logs.append((work / f"grid_child{rank}.out", work / f"grid_child{rank}.err"))
        with open(logs[-1][0], "w") as out, open(logs[-1][1], "w") as err:
            procs.append(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                           "--grid-child", str(path)], cwd=ROOT, stdout=out,
                                          stderr=err, text=True))
    try:
        # The one-process references.
        encoder = load_clip_encoder("ViT-B/16", device="cuda", seed=0).encoder
        before = {n: p.detach().cpu().clone() for n, p in encoder.model.named_parameters()}
        optimizer = S.make_optimizer(GRID_LR, gradient_clip_val=GRID_CLIP)
        state = S.init_train_state(encoder, optimizer)
        seen = recording_clip(torch, optimizer, [n for n in state.named_parameters()
                                                 if optimizer.trainable(n)])
        step = T.make_contrastive_train_step(encoder, optimizer)
        losses = []
        for _ in range(GRID_STEPS):
            state, metrics = step(state, {"video": video, "text": text})
            losses.append(float(metrics["loss/train"]))
        publish(torch, {"before": before, "after": {n: p.detach().cpu() for n, p in
                                                    encoder.model.named_parameters()},
                        "grads": {n: g.cpu() for n, g in seen["grads"].items()},
                        "norm": seen["norm"]}, tp_reference)
        del seen
        blocks = encoder.model.visual.transformer.blocks
        with torch.no_grad():
            for (name, param) in blocks.named_parameters():
                param.copy_(before[f"visual.transformer.blocks.{name}"].cuda())
        x = h
        for block in blocks:
            x = block(x)
        grads = torch.autograd.grad(x.square().mean(), list(blocks.parameters()))
        publish(torch, {"out": x.detach().cpu(), "grads": {n: g.cpu() for (n, _), g in
                                                           zip(blocks.named_parameters(), grads)}},
                pipe_reference)
        del encoder, state, optimizer, blocks, grads, x
        torch.cuda.empty_cache()

        deadline = time.monotonic() + DIST_TIMEOUT_S
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outs = [(out.read_text(), err.read_text()) for out, err in logs]
    for proc, (stdout, stderr) in zip(procs, outs):
        require(proc.returncode == 0, f"phase 18 child exited {proc.returncode}:\n"
                                      f"{stdout[-3000:]}\n{stderr[-6000:]}")
    ranks = [json.loads(stdout.strip().splitlines()[-1]) for stdout, _ in outs]
    for path in (tp_reference, pipe_reference, *(p for pair in logs for p in pair)):
        path.unlink()

    tp_expected = {name: 0 for name in wrappers}
    tp_expected.update({name: 2 * LAYERS * GRID_STEPS for name in (
        "fused_attention_qkv", "attention_f32", "fused_attention_qkv_backward",
        "attention_bwd_f32")})
    per = LAYERS // GRID_RANKS * PIPE_MICROBATCHES
    pipe_expected = {name: 0 for name in wrappers}
    pipe_expected.update({name: per for name in (
        "fused_attention_qkv", "attention_f32", "fused_attention_qkv_backward",
        "attention_bwd_f32")})
    for r in ranks:
        tp, pipe = r["tp"], r["pipeline"]
        rel = [abs(a - b) / abs(b) for a, b in zip(tp["losses"], losses)]
        print(f"grid rank {r['rank']}: TP losses {tp['losses']} (one process {losses}, relative "
              f"{[f'{v:.2e}' for v in rel]}); step ms {[round(v, 1) for v in tp['step_ms']]}; "
              f"{tp['local_bytes']} parameter bytes; launches "
              f"{ {k: n for k, n in tp['launches'].items() if n} }; pipeline: {pipe['blocks']} "
              f"blocks, forward {pipe['forward_ms']:.1f} ms, backward {pipe['backward_ms']:.1f} "
              f"ms, max |out - sequential| {pipe['max_abs_err']:.3e}; launches "
              f"{ {k: n for k, n in pipe['launches'].items() if n} }")
        require(max(rel) <= 1e-4, f"grid rank {r['rank']}: TP losses {tp['losses']} vs {losses}")
        require(tp["launches"] == tp_expected, f"grid rank {r['rank']}: TP launches "
                                               f"{tp['launches']}, expected {tp_expected}")
        require(pipe["blocks"] == LAYERS // GRID_RANKS and pipe["close"],
                f"grid rank {r['rank']}: pipeline output off by {pipe['max_abs_err']}")
        require(pipe["launches"] == pipe_expected, f"grid rank {r['rank']}: pipeline launches "
                                                   f"{pipe['launches']}, expected {pipe_expected}")
    tp0 = ranks[0]["tp"]
    norm_rel = [abs(r["tp"]["norm"] - tp0["reference_norm"]) / tp0["reference_norm"]
                for r in ranks]
    print(f"grid: TP first step's gradients, gathered whole, against the one-process step's: "
          f"{tp0['grad_leaves']} leaves, the worst {tp0['grad_worst'][0]} at a relative L2 gap "
          f"of {tp0['grad_worst'][1]:.3e} (bound {GRID_GRAD_SHARE}); the clip's norm "
          f"{[r['tp']['norm'] for r in ranks]} against {tp0['reference_norm']} (relative "
          f"{max(norm_rel):.2e}, bound {GRID_NORM_RTOL}; clip {GRID_CLIP})")
    require(not tp0["grad_over"] and tp0["grad_leaves"] > 0,
            f"grid: TP gradients over {GRID_GRAD_SHARE} of the one-process step's: "
            f"{tp0['grad_over']}")
    require(max(norm_rel) <= GRID_NORM_RTOL, f"grid: TP clip norms {norm_rel}")
    gap, moved = ranks[0]["tp"]["gap"], ranks[0]["tp"]["moved"]
    grad_rel = (sum(r["pipeline"]["grad_gap_sq"] for r in ranks)
                / sum(r["pipeline"]["grad_sq"] for r in ranks)) ** 0.5
    print(f"grid: TP update gap {gap:.4e} against the one-process update {moved:.4e} "
          f"(ratio {gap / moved:.3e}, bound {UPDATE_SHARE}); pipeline gradients' relative L2 "
          f"gap {grad_rel:.3e} (bound {UPDATE_SHARE}); phase 18 took "
          f"{time.perf_counter() - phase_start:.1f} s ({nvidia_smi()})")
    require(moved > 0 and gap <= UPDATE_SHARE * moved, f"grid: TP update gap {gap} vs {moved}")
    require(grad_rel <= UPDATE_SHARE, f"grid: pipeline gradients' relative gap {grad_rel}")
    print(json.dumps({"grid": {"tp_step_ms": [r["tp"]["step_ms"] for r in ranks],
                               "pipeline_ms": [[r["pipeline"]["forward_ms"],
                                                r["pipeline"]["backward_ms"]] for r in ranks],
                               "tp_update_ratio": gap / moved, "pipe_grad_rel": grad_rel,
                               "tp_grad_worst": tp0["grad_worst"][1],
                               "tp_norm_rel": max(norm_rel)},
                      "card": nvidia_smi()}))
    return {"tp_grid": {n: sum(r["tp"]["launches"][n] for r in ranks) for n in wrappers},
            "pipeline": {n: sum(r["pipeline"]["launches"][n] for r in ranks) for n in wrappers}}


def per_epoch_grid_only(torch) -> int:
    """Phases 17 and 18 alone (``--per-epoch-grid``): the build, phase 11's
    MSR-VTT and drift trees, phase 13's WebVid train tree, two checkpoints of
    the seeded ViT-B/16 (one contrastive step, and a second step resumed from
    it, through the CLI), phase 14 (d) on the first, then phases 17 and 18."""
    import os

    sys.path.insert(0, str(ROOT))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab

    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s; {nvidia_smi()}")
    wrappers = kernel_wrappers()
    work = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    try:
        ids, captions = write_msrvtt_tree(work / "msrvtt")
        merges, _ = write_tiny_test_vocab(str(work), [w for c in captions for w in c.split()])
        os.environ.update(write_drift_trees(work), MSRVTT_PATH=str(work / "msrvtt"))
        os.environ.update(write_webvid_train_tree(work))
        tree = {"root": work / "msrvtt", "ids": ids, "merges": merges}
        common = ["command=train", "encoder=clip_vit_b_16", f"+encoder.bpe_path={merges}",
                  "data=webvid"]
        cli_run(torch, wrappers, [*common, "+trainer.max_steps=1",
                                  f"+log_dir={work / 'a' / 'logs'}",
                                  f"trainer.callbacks.checkpoint.dirpath={work / 'a' / 'ckpt'}"])
        shutil.copy(work / "a" / "ckpt" / "last", work / "a" / "first")
        cli_run(torch, wrappers, [*common, "+trainer.max_steps=2",
                                  f"+checkpoint_path={work / 'a' / 'first'}",
                                  f"+log_dir={work / 'b' / 'logs'}",
                                  f"trainer.callbacks.checkpoint.dirpath={work / 'b' / 'ckpt'}"])
        torch.set_grad_enabled(False)
        wise_phase(torch, wrappers, work, tree, work / "a" / "first")
        paths, _ = per_epoch_phase(torch, wrappers, work, tree,
                                   [work / "a" / "first", work / "b" / "ckpt" / "last"],
                                   work / "student_openai.pt", work / "wise_merged.pt")
        torch.set_grad_enabled(True)
        torch.cuda.empty_cache()
        paths.update(grid_phase(torch, wrappers, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"per_epoch_grid": {path: {k: n for k, n in c.items() if n}
                                         for path, c in paths.items()}, "card": nvidia_smi()}))
    return 0


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the main paths by name; each counts its launches."""
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K
    from fitclip_torch.ops.s3dg_stem import s3dg_stem

    return {"ln_quant": K.ln_quant, "int8_gemm_bias": K.int8_gemm_bias,
                "int8_gemm_residual": K.int8_gemm_residual,
                "int8_gemm_gelu": K.int8_gemm_gelu, "attention_int8": A.attention_int8,
                "fused_attention_qkv": A.fused_attention_qkv,
                "fused_attention_qkv_backward": A.fused_attention_qkv_backward,
                "fused_attention_qkv_gkv": A.fused_attention_qkv_gkv,
                "fused_time_attention": A.fused_time_attention,
                "fit_cls_attention_int8": A.fit_cls_attention_int8,
                "fit_time_attention_int8": A.fit_time_attention_int8,
                "fit_space_attention_int8": A.fit_space_attention_int8,
                "s3dg_stem": s3dg_stem, "ln_cast": K.ln_cast, "bf16_gemm_bias": K.bf16_gemm_bias,
                "bf16_gemm_residual": K.bf16_gemm_residual, "bf16_gemm_gelu": K.bf16_gemm_gelu,
                "attention_block": A.attention_block,
                "fused_int8_qkv_attention": A.fused_int8_qkv_attention,
                "attention_f32": A.attention_f32, "attention_bwd_f32": A.attention_bwd_f32}


def train_cli_only(torch) -> int:
    """Phase 13 alone (``--train-cli``): the build, phase 11's trees and BPE
    vocabulary (no eval command runs), then phase 13."""
    import os

    sys.path.insert(0, str(ROOT))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab

    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s; {nvidia_smi()}")
    work = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    try:
        ids, captions = write_msrvtt_tree(work / "msrvtt")
        merges, _ = write_tiny_test_vocab(str(work), [w for c in captions for w in c.split()])
        os.environ.update(write_drift_trees(work), MSRVTT_PATH=str(work / "msrvtt"))
        tree = {"root": work / "msrvtt", "ids": ids, "merges": merges}
        paths = train_cli_phase(torch, kernel_wrappers(), work, tree, None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"train_cli": {path: {k: n for k, n in c.items() if n}
                                    for path, c in paths.items()}, "card": nvidia_smi()}))
    return 0


def main() -> int:
    import torch

    # Phase 1: the device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    alone = {"--train-steps": train_steps_only, "--row-passes": row_passes_only,
             "--fp32-attention": fp32_attention_only, "--fit-attention": fit_attention_only,
             "--bench-arms": bench_arms_only, "--stem-cls": stem_cls_only}
    if sys.argv[1:2] == ["--load-exported"]:
        return load_exported_child(*sys.argv[2:5])
    if sys.argv[1:2] == ["--distributed-child"]:
        return distributed_child(sys.argv[2])
    if sys.argv[1:2] == ["--grid-child"]:
        return grid_child(sys.argv[2])
    alone["--op-dispatch"] = op_dispatch_only
    if sys.argv[1:2] in (["--train-cli"], ["--resnet-wise"], ["--export"], ["--distributed"],
                         ["--per-epoch-grid"]):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return {"--train-cli": train_cli_only, "--resnet-wise": resnet_wise_only,
                "--export": export_only, "--distributed": distributed_only,
                "--per-epoch-grid": per_epoch_grid_only}[sys.argv[1]](torch)
    if sys.argv[1:2] and sys.argv[1] in alone:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return alone[sys.argv[1]](torch, Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT)
    sys.path.insert(0, str(ROOT))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.fast_eval import encode_frames_fast, encode_text_fast
    from fitclip_torch.models.clip.load import LoadedEncoder, load_clip_encoder
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K
    from fitclip_torch.ops.s3dg_stem import s3dg_stem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}); nvidia-smi: {card}; TF32 off")

    # Phase 2: the build.
    start = time.perf_counter()
    library = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s -> {library}")
    for line in (library.parent / "ptxas.txt").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # Phase 3: each kernel against its plain version.
    print(f"kernels against their plain versions (clocks {clocks()}):")
    checks = KernelChecks()
    times = kernel_phase(torch, checks)
    times.update(float_layer_kernel_phase(torch, checks))
    times.update(fit_kernel_phase(torch, checks, A))
    times.update(s3dg_kernel_phase(torch, checks))
    fault_kernel_phase(torch, checks)
    times.update(f32_attention_phase(torch, checks, A))
    times.update(ln_kernel_phase(torch, checks))
    times.update(bench_kernel_phase(torch, checks))
    torch.cuda.empty_cache()

    # Phase 4: the slice. Encoding is inference: no autograd graph.
    torch.set_grad_enabled(False)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    start = time.perf_counter()
    int8_enc = load_clip_encoder("ViT-B/16", dtype="int8", device="cuda", seed=0).encoder
    float_enc = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0).encoder
    int8_enc.fold_pixel_normalization()
    float_enc.fold_pixel_normalization()
    print(f"slice: loaded int8 and bf16 ViT-B/16 in {time.perf_counter() - start:.1f} s")
    video = torch.randint(0, 256, (8, 4, 224, 224, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
    calib_text = torch.from_numpy(token_ids(32, rng)).cuda()
    text = torch.from_numpy(token_ids(8, rng)).cuda()

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    int8_enc.calibrate(video, calib_text)
    torch.cuda.synchronize()
    after_calibration = {name: fn.launches for name, fn in wrappers.items()}
    video_emb = int8_enc.encode_video(video)
    text_emb = int8_enc.encode_text(text)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"slice: launches after calibration {after_calibration}; after encoding {launches}")
    layers = LAYERS
    require(after_calibration["fused_attention_qkv"] == 2 * layers,
            "calibration did not run the qkv-mode attention kernel on every layer")
    expected = {name: 0 for name in wrappers}
    expected.update({"ln_quant": 4 * layers, "int8_gemm_bias": 2 * layers,
                     "int8_gemm_residual": 4 * layers, "int8_gemm_gelu": 2 * layers,
                     "attention_int8": 2 * layers, "fused_attention_qkv": 2 * layers})
    require(launches == expected, f"launch counts {launches}, expected {expected}")

    frames = int8_enc._prepare_frames(video)
    for tower, kernel_emb, plain_emb in (
            ("vision", encode_frames_fast(int8_enc.model, frames),
             encode_frames_fast(int8_enc.model, frames, layer_fn=K.fused_int8_layer_plain)),
            ("text", encode_text_fast(int8_enc.model, text),
             encode_text_fast(int8_enc.model, text, layer_fn=K.fused_int8_layer_plain))):
        cos = min_cosine(kernel_emb, plain_emb)
        print(f"slice gate (i) {tower}: kernels vs plain on the card, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"{tower}: kernel path vs plain path cosine {cos}")
    for tower, int8_emb, float_emb in (("vision", video_emb, float_enc.encode_video(video)),
                                       ("text", text_emb, float_enc.encode_text(text))):
        cos = min_cosine(int8_emb, float_emb)
        print(f"slice gate (ii) {tower}: int8 vs bf16 float model, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"{tower}: int8 vs bf16 cosine {cos}")
    scores = text_emb.float() @ video_emb.float().T
    require(scores.shape == (8, 8) and bool(torch.isfinite(scores).all()),
            f"text x video scores: shape {tuple(scores.shape)} or non-finite values")
    print(f"slice: text x video scores {tuple(scores.shape)}, all finite, "
          f"diagonal mean {float(scores.diagonal().mean()):.4f}")

    # Phase 5: the slice's throughput at 32 clips.
    print(f"clocks (phase 5): {clocks()}; {elapsed()}")
    video32 = torch.randint(0, 256, (32, 4, 224, 224, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
    torch.cuda.reset_peak_memory_stats()
    int8_ms = cuda_ms(lambda: int8_enc.encode_video(video32), iters=10)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    float_ms = cuda_ms(lambda: float_enc.encode_video(video32), iters=10)
    print(f"slice: int8 encode_video, 32 clips x 4 frames: {int8_ms:.3f} ms, "
          f"{32e3 / int8_ms:.1f} clips/s, peak {peak_gib:.2f} GiB; "
          f"bf16 float model: {float_ms:.3f} ms, {32e3 / float_ms:.1f} clips/s")
    print_profile(torch, "clip int8 encode_video", lambda: int8_enc.encode_video(video32),
                  mma=("attention_mma_kernel",), kernels=(INT8_GEMM, LN_KERNEL))
    print_profile(torch, "clip bf16 module path encode_video",
                  lambda: float_enc.encode_video(video32), top=6, mma=("attention_mma_kernel",))

    # Phase 9 runs here, while phase 4's inputs and bf16 encoder are at hand.
    # (a) CLIP ViT-B/16 bf16 with fused_block=True (K2); (b) SLIP ViT-B/16.
    print(f"clocks (phase 9): {clocks()}; {elapsed()}")
    clip_k2_paths, clip_k2_times = clip_bf16_fused_phase(torch, wrappers, float_enc, video, text,
                                                         video32)
    slip_paths, slip_times = slip_phase(torch, wrappers, video, calib_text, text, video32)
    torch.cuda.empty_cache()
    # Phase 5 (b): CLIP ViT-B/16 in fp32 (the configs' default dtype).
    fp32_paths, fp32_encode_times = clip_fp32_phase(torch, wrappers, video, text)
    torch.cuda.empty_cache()

    # Phase 6: training.
    torch.set_grad_enabled(True)
    student = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0)
    paths, train_times = training_phase(torch, student, LoadedEncoder(int8_enc), wrappers,
                                        ROOT / "build" / "chip_smoke_train")
    del student
    torch.cuda.empty_cache()
    fp32_train_paths, fp32_train_times = fp32_training_phase(torch, wrappers,
                                                             ROOT / "build" / "chip_smoke_fp32")

    # Phase 7: Frozen-in-Time. Inference: no autograd graph.
    torch.set_grad_enabled(False)
    torch.cuda.empty_cache()
    print(f"clocks (phase 7): {clocks()}; {elapsed()}")
    fit_paths, fit_times = fit_phase(torch, wrappers)
    torch.cuda.empty_cache()
    fit_fp32_paths, fit_fp32_times = fit_fp32_phase(torch, wrappers)

    # Phase 8: the S3D-G family (MIL-NCE, VideoCLIP).
    torch.cuda.empty_cache()
    print(f"clocks (phase 8): {clocks()}; {elapsed()}")
    s3dg_paths, s3dg_times = s3dg_phase(torch, wrappers)

    # Phase 10: the bench path (python -m fitclip_torch.bench's arms and encode).
    torch.cuda.empty_cache()
    print(f"clocks (phase 10): {clocks()}; {elapsed()}")
    bench_paths, bench_times, _ = bench_phase(torch, checks, wrappers)
    times.update(bench_times)

    # Phase 11: the eval CLI on the card; phase 12: the embed service, on phase 11's
    # scales, predictions and videos.
    torch.cuda.empty_cache()
    print(f"clocks (phase 11): {clocks()}; {elapsed()}")
    work = ROOT / "build" / "chip_smoke_eval"
    try:
        cli_paths, eval_tree = eval_cli_phase(torch, wrappers, work)
        torch.cuda.empty_cache()
        print(f"clocks (phase 12): {clocks()}; {elapsed()}")
        serving_paths = serving_phase(torch, wrappers, eval_tree)
        # Phase 13: the train-side CLI, on phase 11's trees.
        torch.cuda.empty_cache()
        print(f"clocks (phase 13): {clocks()}; {elapsed()}")
        torch.set_grad_enabled(True)
        train_cli_paths = train_cli_phase(torch, wrappers, work, eval_tree,
                                          fp32_train_times.get("contrastive"))
        # Phase 14: the CLIP ResNet and WiSE-FT, on phase 11's and 13's trees and
        # phase 13 (a)'s trained student.
        torch.cuda.empty_cache()
        print(f"clocks (phase 14): {clocks()}; {elapsed()}")
        resnet_wise_paths, _ = resnet_wise_phase(torch, wrappers, work, eval_tree,
                                                 work / "a" / "ckpt" / "last")
        # Phase 15: export, on phase 11's BPE vocabulary.
        torch.cuda.empty_cache()
        print(f"clocks (phase 15): {clocks()}; {elapsed()}")
        export_paths = export_phase(torch, wrappers, work, eval_tree["merges"])
        # Phase 16: the CLI under a process group, each rank a child process, on
        # phase 11's and 13's trees.
        torch.cuda.empty_cache()
        print(f"clocks (phase 16): {clocks()}; {elapsed()}")
        distributed_paths = distributed_phase(torch, wrappers, work, eval_tree["merges"])
        # Phase 17: the per-epoch loop over phase 13 (d)'s best and last, on phase
        # 11's trees, its offline WiSE-FT held to phase 14 (d)'s merge.
        torch.cuda.empty_cache()
        print(f"clocks (phase 17): {clocks()}; {elapsed()}")
        torch.set_grad_enabled(False)
        per_epoch_paths, _ = per_epoch_phase(
            torch, wrappers, work, eval_tree,
            [work / "d" / "ckpt" / "best", work / "d" / "ckpt" / "last"],
            work / "student_openai.pt", work / "wise_merged.pt")
        # Phase 18: tensor parallelism and the pipeline, four gloo ranks on the card.
        torch.cuda.empty_cache()
        print(f"clocks (phase 18): {clocks()}; {elapsed()}")
        torch.set_grad_enabled(True)
        grid_paths = grid_phase(torch, wrappers, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    paths = {"encode": launches, **paths, **fit_paths, **fit_fp32_paths, **s3dg_paths,
             **clip_k2_paths,
             **slip_paths, **fp32_paths, **fp32_train_paths, **bench_paths, **cli_paths,
             **serving_paths, **train_cli_paths, **resnet_wise_paths, **export_paths,
             **distributed_paths, **per_epoch_paths, **grid_paths}
    print(f"launches per path (nonzero counts): "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    for name in wrappers:
        require(any(counts[name] for counts in paths.values()),
                f"{name} was launched in no path")
    for name in BENCH_KERNELS:
        require(bench_paths["bench"][name] > 0, f"{name} was not launched on the bench path")

    fit_attention = ("fused_attention_qkv_gkv", "fused_time_attention",
                     "fit_cls_attention_int8", "fit_time_attention_int8",
                     "fit_space_attention_int8")
    replaces = {"fused_attention_qkv": "fitclip_tpu/ops/attention.py:41",
                "fused_attention_qkv_backward": "fitclip_tpu/ops/attention.py:349",
                "attention_f32": "fitclip_tpu/ops/attention.py:41",
                "attention_bwd_f32": "fitclip_tpu/ops/attention.py:349",
                "fused_attention_qkv_gkv": "fitclip_tpu/ops/attention.py:85",
                "fused_time_attention": "fitclip_tpu/ops/attention.py:168",
                "s3dg_stem": "fitclip_tpu/ops/s3dg_stem.py:322",
                "fused_int8_qkv_attention": "fitclip_tpu/ops/attention.py:495",
                **{name: "fitclip_tpu/ops/block.py:210" for name in K2_LAUNCHES_PER_LAYER},
                **{name: "fitclip_tpu/ops/fit_block.py:748" for name in fit_attention[2:]}}
    sources = {"ln_quant": "ln_quant.cu", "attention_int8": "attention.cu",
               "fused_attention_qkv": "attention.cu", "ln_cast": "ln_quant.cu",
               "attention_block": "attention.cu", "fused_int8_qkv_attention": "attention.cu",
               **{name: "bf16_gemm.cu" for name in K2_LAUNCHES_PER_LAYER if "gemm" in name},
               "fused_attention_qkv_backward": "attention_bwd.cu", "s3dg_stem": "s3dg_stem.cu",
               "attention_f32": "attention.cu", "attention_bwd_f32": "attention_bwd.cu",
               **{name: "fit_attention.cu" for name in fit_attention}}
    # The __global__ bodies of the rows on the paths timed here: attention.cu's
    # and the FiT space kernel's tensor-core core, attention_mma.cuh (bf16), the
    # backward's two kernels, attention_bwd_mma.cuh, the GEMMs' wgmma kernels, the
    # LayerNorm kernel of every LN mode and the amax pass.
    bodies = {**{name: "attention_mma_kernel" for name in (
                  "attention_int8", "fused_attention_qkv", "attention_block",
                  *(n for n in BENCH_KERNELS if n.startswith("attention_") and "i8" not in n))},
              "fused_attention_qkv_gkv": "space_mma_kernel",
              "fit_space_attention_int8": "space_mma_kernel",
              "fused_time_attention": TIME_ROWS, "fit_time_attention_int8": TIME_ROWS,
              "fused_attention_qkv_backward": "+".join(K3B_MMA),
              "attention_f32": F32_FORWARD, "attention_bwd_f32": "+".join(F32_BACKWARD),
              "fused_int8_qkv_attention": f"{INT8_GEMM}+attention_mma_kernel",
              **{name: INT8_GEMM for name in (*INT8_LAUNCHES_PER_LAYER, *BENCH_KERNELS)
                 if name.startswith("int8_gemm")},
              **{name: BF16_GEMM for name in K2_LAUNCHES_PER_LAYER if name.startswith("bf16_gemm")},
              **{name: LN_KERNEL for name in ("ln_quant", "ln_cast", "ln_quant_one",
                                              "ln_quant_fold", "ln_quant_cast")},
              "attn_amax": "amax_rows_kernel", "attention_i8qk": S8_BODY,
              "attention_i8qkav": S8_BODY, "slice_requant": SLICE_BODY,
              "s3dg_stem": STEM_BODY, "fit_cls_attention_int8": CLS_ROWS}
    record = [{"name": name, "route": "cuda",
               "source": f"fitclip_torch/csrc/{sources.get(name, 'int8_gemm.cu')}",
               "replaces": replaces.get(name, "fitclip_tpu/ops/block.py:137"),
               "launches": sum(counts[name] for counts in paths.values()),
               "max_abs_err": checks.max_abs_err[name], **times[name]}
              for name in wrappers]
    record += [{"name": name, "route": "cuda", "source": f"fitclip_torch/{source}",
                "replaces": site, "launches": bench_paths["bench"][name],
                "max_abs_err": checks.max_abs_err[name], **times[name]}
               for name, (site, source) in BENCH_KERNELS.items()]
    for entry in record:
        if entry["name"] in bodies:
            entry["kernel"] = bodies[entry["name"]]
    for entry in record:
        print_row(entry["name"], entry)
        require(entry["ms"] >= DEVICE_BELOW_MS or "device_ms" in entry,
                f"{entry['name']}: {entry['ms']:.4f} ms by events and no device time")
    print(f"chip_smoke: every phase passed, {elapsed()}")
    print(json.dumps({"kernels": record}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
