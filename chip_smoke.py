#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the quickest proof that
the port still builds, starts and is right on the card.

    python3 chip_smoke.py            # from the repo root; needs one CUDA device
    python3 chip_smoke.py --profile  # also: torch.profiler device time per
                                     # forward_packed call and grad step

Phases (any failure raises, and the script exits non-zero without a
result line):
  build     compile csrc/ with nvcc (speech_ssl_compression_tpu_torch/ops/
            _kernels.py, one nvcc per source in parallel), print the build
            time, ptxas's registers and spills per kernel, and the HGMMA
            (tensor-core) instructions per kernel in cuobjdump -sass; fails
            if the attention forward, dQ or dK/dV kernel or the conv
            forward, dW or dX kernel (each in bf16, and in f32 in split
            TF32) has none;
  kernels   the flash-attention forward kernels (both on the tensor cores,
            f32 in split TF32) against their plain PyTorch version on the
            card, TF32 off, f32 (against the plain version run in float64,
            its distance from the f32 one printed) and bf16, at the shapes
            the serving path and the long/rectangular/causal paths give
            them, with dropout at the training shape, and at the ragged
            edges of the tiles and of the kernels' two-stage rings: T =
            777 (key padding, dropout), T = 65 and T = 1; CUDA-event times
            of the kernel's launches (launch_fwd, without the wrapper's
            host work) and of the plain version at the serving, training,
            long and rectangular shapes;
  backward  the dQ and dK/dV kernels (both dtypes on the tensor cores; f32
            in split TF32), as the autograd path runs them (the
            dQ kernel computes D from its own P and hands it to the dK/dV
            kernel), against the plain backward at the training shape
            (4, 12, 768, 64) with key padding, dropout 0 and 0.1, and at the
            serving, causal, one-head, long and rectangular shapes, and at
            the ragged T = 777 (key padding, dropout) and T = 65, f32 and
            bf16 (bf16: fewer than BF16_BEYOND_BAR of each gradient's valid
            entries past one ulp; f32: dq, dk, dv against the plain
            backward run in float64, which the f32 plain version itself
            misses by up to ~2e-4 at the causal case, and its distance
            from the f32 one printed); D also against JAX's
            rowsum(dO o O);
            times of both kernels
            and their plain versions at the long and rectangular shapes; the
            forward kernels' keep bits and keep rate against the plain mask
            and the binomial, f32 and bf16; the same seed giving the same
            bits twice, f32 and bf16;
  slice     MelHuBERT-20ms at full width (12 layers, 768 wide, seeded random
            weights written as an npz checkpoint and read back through
            load_any_checkpoint) serves 16 synthetic utterances through
            MelHuBERTExtractor.forward_packed: launch counts, the dense
            path, the unpacked path, bf16 against f32;
  timing    CUDA-event medians of 3 after a warm-up: serve-batch frames/s
            with the kernel and with impl="dense", f32 and bf16; then
            F.scaled_dot_product_attention's forward and backward at the
            attention kernels' timed shapes, f32 and bf16 (one time of 5
            calls after a warm-up); the grad steps and updates of the
            train phases against their yardsticks one time each, the
            yardstick first, each after a warm-up (``alternate(...,
            reps=1, turns=1)``);
  wave serve  serving from waveforms on the slice phase's model: the
            card's featurize_batch at fp 20 and 10 (float and int16-exact
            audio, uploaded as int16) against the host fbank in float64
            and the port's plain CPU featurize_batch (FBANK_BAR), n_valid
            exact, rows past it 0; forward_packed(featurizer="device") f32
            and bf16 against featurizer="host" (WAVE_BAR, BF16_SLICE_BAR)
            and hubconf's compression_20ms_melhubert_960hours_local
            expert (packed, device featurizer) bitwise forward_packed,
            flash_attn_fwd launches counted; forward_stream over
            WAVE_BATCHES batches of 16 utterances bitwise sequential
            forward_packed, its launches counted; frames/s from waveforms,
            streamed and fence-per-call (in turns), device and host
            featurizer, and the idle share under the profiler; the
            stream's last layer dumped (extract_feature.dump_features) and
            clustered by python -m speech_ssl_compression_tpu_torch.cluster
            (K = 500, 2 epochs, on the card; its per-epoch seconds), the
            labels against the CPU kmeans_assign away from near-ties;
  stream    streaming causal serving (streaming.py) at full width, a
            causal MelHuBERT-20ms with seeded random weights, at bench.py's
            two streaming rows: f32 lockstep StreamingCausalBatchExtractor
            B = 16, chunks of 128 frames, max_frames 3072, TF32 off, 16
            synthetic utterances of 8-40 s through push_wav in ragged
            pieces, two slots finished early and opened again; every
            stream's hidden states against the full causal forward of its
            utterance with impl="dense" (atol 2e-5, rtol 1e-5, the JAX
            streaming test's bar) and with the flash kernel (SLICE_BAR);
            the stream launches no kernel, the kernel forwards 12 each;
            then the bf16 ring, B = 64, window 1024 (capacity 1152), a
            stream of 2000 frames past the ring's wrap and a slot reused
            after it, every stream against the dense windowed forward in
            f32 (rel. L2 < BF16_SLICE_BAR); for both, CUDA-event times of
            20 lockstep steps (one poll() each, from features), the
            aggregate realtime factor, the idle share of 3 steps under
            the profiler and the step's FLOP bound (attention at the
            cache's full capacity; f32 at 67 TFLOP/s, TF32 off);
  preprocess  the offline data path: the train phase's 32 synthetic
            utterances written as a 960 h Kaldi release (an FM ark and a
            CM ark, the scp with each matrix's offset, the mean-var
            accumulator, label text and scp per frame period, the 20 ms
            labels nested under split200/) in a tarball, then python -m
            speech_ssl_compression_tpu_torch.preprocess --tar in a
            subprocess: split200 flattened, mean-std.npy the
            accumulator's, the features the utterances normalized
            (bitwise from FM, within the CM quantisation step), the labels
            the release's, the CSVs in scp order;
  train     MelHuBERT-20ms pre-training at full width on a synthetic
            dataset, from the preprocess phase's 20 ms CSV, through the
            trainer's entry point (python -m
            speech_ssl_compression_tpu_torch.train): 3 updates of 8
            micro-batches (B = 4, T = 768), bf16, dropout 0.1; launch
            counts per micro-batch; the checkpoint read back; loss and every
            gradient of the kernel path against impl="dense" in f32 with
            dropout off; 10 updates on one fixed batch, whose loss falls;
  train timing  the grad step with the kernels and with impl="dense", f32
            and bf16, one full update in bf16, and the backward kernels
            against the plain backward at the training shape;
  resume    the train phase's last-step.npz read back by a trainer built
            from -m melhubert -i last-step.npz
            --init_optimizer_from_initial_weight at full width: params, Adam
            moments and count on the card equal to the file's bitwise, then
            one update (dropout off, a fixed batch and span mask) from the
            train phase's runner, its state as it was when it wrote the
            file, and from the resumed one gives bitwise-equal params and
            Adam state (cuDNN deterministic);
  fairseq dump  the same utterances as a fairseq feature dump (one .npy,
            .len, .km, mean-std) through FairseqDumpBuckets (20 ms, crops
            of 750, B = 4); one batch through the train phase's bf16 grad
            step: finite loss and gradients, each attention kernel once a
            layer;
  device masks  ops/masking.py::compute_span_mask on the card at B = 4,
            T = 768, mask_prob 0.8, length 10 (melhubert_forward's draw),
            200 draws: nothing past a row's length, the mean masked
            fraction within 5 sigma of as many host draws
            (compute_mask_indices_np), one seed one mask;
            melhubert_forward(mask=True) with no mask on the card (the
            train phase's model, f32); one draw timed against the host
            draw and its upload;
  deep pos-conv  MelHuBERT-20ms at full width with pos_conv_depth 5 and
            conv_pos 95 (k = 19, data2vec 2.0's audio encoder), seeded
            weights through the npz bridge: the slice phase's 16
            utterances through forward_packed, f32 against impl="dense"
            (SLICE_BAR) and bf16 against it (BF16_SLICE_BAR); one f32 grad
            step with the kernels against impl="dense" (TF32 off, dropout
            off, a fixed span mask; GRAD_BAR); launches; the forward's
            times from features, both dtypes, kernel and dense;
  weight prune  -m weight-pruning through the trainer's entry point from
            that checkpoint, full width, bf16, B = 4, T = 768, 8
            micro-batches: configs/weight_pruning/config_runner_20ms.yaml's
            prune: section with warnup, period and n_iters cut to 1, 1, 1
            (its sparsity ladder to its first entry, which n_iters must
            match), pruning_condition always, total_steps 2; launch counts
            per micro-batch; the event at step 1, after exactly one update
            (Adam count in its artifact); after it exactly round(amount *
            n) of the n ~ 85 M prunable entries
            masked, the masks equal to a host recompute by
            global_magnitude_prune on the artifact's folded weights; the
            artifacts and last-step.npz (masks, Pruning, TotalStep); every
            masked entry's gradient exactly 0 in a bf16 grad step; the
            masked grad step's loss and every gradient with the kernels
            against impl="dense" (f32, TF32 off, dropout off, a fixed span
            mask); MelHuBERTExtractor serving last-step.npz (masks folded)
            against serving the in-memory weights masked by hand; times of
            one update with masks against one without, and of each prune
            event on the host;
  head prune  -m head-pruning through the trainer's entry point from the
            train phase's checkpoint, full width:
            configs/head_pruning/data_driven/config_runner_20ms.yaml with
            its prune: section cut to warm_up 0, interval 1, 2 events of
            66 heads where the recipe takes 11 of 12 (by_whole, to the
            recipe's endpoint; a cut in depth for the script's time), one
            before each of 2 bf16 updates, and data_ratio 1.0 of a
            64-utterance set (two stacked
            scoring groups of B = 32 a event, f32, dropout on); launch
            counts per dtype (the f32 dQ and dK/dV kernels in scoring);
            one head a layer at the end; each event's heads equal to a
            host recompute of select_heads_to_prune on its
            heads_and_score_*.npy; the attention kernels against their
            plain versions at the scoring pass's shape in f32 at every H
            from 12 to 1 a layer, and at the updates' in bf16 at each H
            the run held; the host seconds of each scoring pass
            and each slicing and rebuild, and memory_allocated around each
            event (it must fall by the params and Adam moments pruned
            away); the scoring pass with the kernels against impl="dense"
            (f32, TF32 off, dropout off, a fixed span mask) at 12 heads a
            layer and at the ragged heads of the 2nd event, each layer's
            scores within GRAD_BAR (rel. L2), and its peak memory; the
            sliced model against the unsliced one with the pruned heads'
            out_proj input columns zeroed (events 1 and 2); the last
            states_prune_*.npz served by MelHuBERTExtractor against the
            in-memory model; then an l1, by_layer run of 1 event (11
            heads a layer), its scores and heads recomputed on the host
            from its artifact;
  row prune  -m row-pruning likewise: configs/row_pruning/
            config_runner_20ms.yaml cut to warm_up 0, interval 1 and
            1280 rows an event where the recipe takes 128 (a cut in depth
            for the script's time: 2 events, one before each of 2 bf16
            updates); FFN 512 at the end; each event's rows equal to a host recompute of
            ffn_row_scores on the artifact before it; memory around each
            event; the sliced model against the unsliced one with the
            pruned rows' fc1 rows and fc2 columns zeroed (the first and
            last events); the last states_prune_*.npz served against the
            in-memory model; the serve batch's frames/s from features,
            f32 and bf16, of the full, the one-head and the FFN-512 model,
            in turns;
  distill   -m distillation through the trainer's entry point, full width
            (a 12-layer teacher into a 6-layer student, bf16, B = 4, T =
            768, 8 micro-batches): A, configs/distillation/
            config_{model,runner}_20ms.yaml as shipped (nomasked, T = 1,
            alpha = 1) cut to 1 update, from the train phase's
            checkpoint; B, masked, T = 2, alpha = 0.5,
            initial_from_teacher, 1 update; C, from the head prune phase's
            one-head checkpoint, 1 update; launches per micro-batch (each
            teacher layer one bf16 forward, each student layer a forward,
            a dQ and a dK/dV); after A the teacher bitwise as loaded, no
            grad on it; B's student before its update: pos-conv and
            layers 0-5 bitwise the teacher's (not shared), the rest a
            seeded fresh init; the attention kernels against their plain
            versions at (4, H, 768, 64) bf16, H = 1 and 12; one distill
            grad step with the kernels against impl="dense" (f32, TF32
            off, dropout off) at 12 teacher heads and at 1, nomasked and
            masked with one fixed host mask: the loss, its three logs and
            every student gradient within GRAD_BAR; A's last-step.npz read
            back as 6 layers and served against the in-memory student;
            times of the distill micro-step against the pretrain grad step
            in turns, the teacher's forward alone, the student's own
            pretrain grad step and one update; the grad step's peak memory
            and what the teacher's forward leaves allocated (its logits
            and nothing more);
  long      the long-sequence paths at full width. The 10 ms recipe
            through the trainer's entry point (python -m
            speech_ssl_compression_tpu_torch.train -m melhubert -f 10,
            configs/melhubert/config_{model,runner}_10ms.yaml cut to one
            update of the shipped 8 micro-batches of B = 4 x T = 1500
            crops, bf16, dropout 0.1) on the train phase's set: launches,
            the batch's shape; its f32 grad step with the kernels against
            impl="dense" (TF32 off, dropout off, a fixed span mask); its
            bf16 grad step with and without remat (dropout on, the same
            generators, cuDNN deterministic): every gradient bitwise, the
            peak memory of each, the forwards the recompute adds, the
            times, and one update's. T = 8192 extraction from its
            checkpoint: one utterance of 1,311,000 samples (8192 frames of
            10 ms) through MelHuBERTExtractor.forward in f32 and bf16 and
            with featurizer="device", and the fp = 10 serve batch through
            forward_packed; against impl="dense" at full T (SLICE_BAR),
            bf16 against f32 (BF16_SLICE_BAR), the device featurizer
            against the host's (WAVE_BAR); frames/s and x realtime. The
            attention kernels at (1, 12, 8192, 64) against their plain
            versions (f32 in float64; bf16 by the straddle rule), timed
            beside them and SDPA. T = 8192 distillation (bench.py's
            long-form row: B = 1, nomasked, dropouts 0) of the 10 ms run's
            model into the 10 ms recipe's 6-layer student through
            make_distill_grad_step and the fused apply, LONG_DISTILL_STEPS
            updates in f32 and in bf16: launches; each student layer's
            attention call, as captured (q, k, v, dO), against the plain
            backward (f32 in float64; bf16 by the straddle rule); the
            whole f32 step against impl="dense" (its memory reckoned
            first); the update's time and peak memory. Fails unless the
            forward, dQ and dK/dV kernels each launched past T = 4096
            (the calls JAX sends to its streamed kernels) on these paths;
  conv      the strided-conv forward, dW and dX kernels against their plain
            version at the shapes of HuBERT's frontend layers 1-6 in the
            training batch, at T = 777 / 515, at the ragged edges of the
            bf16 kernels' tiles (CONV_EDGE_CASES) and at stride 9 (k = s = 9
            and k = 20 at T = 777, CONV_FOLD_CASES: conv1d_strided folds the
            stride into the channels for the stride-1 kernels, and
            autograd through it gives dW and dX): f32 (TF32 off) against
            the plain version in float64, bf16 against it in bf16, the
            forward, dW and dX of both dtypes bitwise repeatable; dX zero
            past the last input row an output reaches; CUDA-event times of
            each kernel, its plain version and cuDNN's call for the same
            function (F.conv1d, conv1d_weight, conv1d_input);
  grouped conv  the grouped pos-conv (ops/grouped_conv.py, JAX's
            grouped_conv1d: f32 sums of bf16 products, dX by the conv
            transpose, dW tap by tap) at GC_CASES (the K = 128 pos-conv at
            B = 4 x T = 768, the deep stack's K = 19, the f32 stream
            step's VALID window, T = 8192) against its plain version in
            float64: f32 (TF32 off) forward, dX and dW within GC_BAR rel.
            L2; bf16 inputs' f32 forward and f32 dW sums within GC_BAR,
            dX within one ulp; planted controls (one tap dropped, the
            bf16-summed forward) that must fail; CUDA-event times of the
            forward and of forward and backward, module against the
            F.conv1d autograd route it replaced (cudnn_grouped), f32 and
            bf16, with their bounds; after the timing phase the f32 serve
            batch, and after train timing the bf16 grad step, once on
            each route (cudnn_pos_conv);
  hubert serve  HuBERT-base at full width (configs/hubert/config_model.yaml,
            seeded random weights) through hubert_forward(features_only=True)
            on 8 x 491,520 samples: launch counts, the conv kernels
            (conv_frontend_impl="tc_pallas") against cuDNN ("auto"), bf16
            against f32, frames/s of both routes in f32 and bf16;
  hubert train  HuBERT-base pre-training through the trainer's entry point
            (-u hubert) on a synthetic manifest: 3 updates of 2 micro-batches
            (B = 4, 245,760 samples), bf16; launch counts per grad step; the
            checkpoint read back; loss and every gradient of the kernel
            route (f32, TF32 off, dropout off, a fixed span mask) against
            cuDNN + impl="dense" run in float64 and in f32; the grad step
            and one update at the bench recipe with and without the conv
            kernels, f32 and bf16;
  wave_bench  one bf16 grad step of HuBERT and of wav2vec 2.0 through
            train/wave_bench.py::make_wave_bench_grad_step at the recipe's
            B = 4 x 245,760 samples (seeded weights): finite gradients,
            each attention kernel once a layer;
  w2v2 train  wav2vec 2.0 base pre-training through the trainer's entry
            point (-u wav2vec2) on a synthetic manifest of WAVs of at least
            250,000 samples, configs/wav2vec2/config_{model,runner}.yaml as
            shipped but for total_steps 3, conv_frontend_impl tc_pallas and
            the data path: 3 updates of B = 12 x 250,000 samples, bf16,
            dropouts and LayerDrop 0.05 on; launch counts per grad step
            against the encoder layers LayerDrop kept; the Gumbel
            temperature of each grad step against the host's anneal; the
            checkpoint read back bitwise, with its Config; loss, logs and
            every gradient of the kernel route (f32, TF32 off, dropouts
            off, a fixed span mask, negative counts and Gumbel noise, B = 2
            at full width, one row cut short) against cuDNN +
            impl="dense" run in float64 and in f32 (a gradient past
            GRAD_BAR of float64, as the last layers' q/k projections are
            in any f32 route, within W2V2_CANCEL_FACTOR times the f32
            route's own distance); the attention pair at
            (12, 12, 782, 64) bf16 with dropout 0.1 and the pad key, and
            the conv kernels at frontend layers 1-6 of this batch, against
            their plain versions; 10 updates on one fixed batch, whose
            loss falls; the grad step and one update with the kernels and
            with cuDNN + dense, f32 and bf16, frames/s and peak memory;
  wave prune  the pruning modes of HuBERT and wav2vec 2.0 through the
            trainer's entry point (-m weight-pruning|head-pruning|
            row-pruning -u hubert|wav2vec2), full width, bf16, from the
            hubert train and w2v2 train phases' checkpoints on the w2v2
            train phase's WAVs (its labels for HuBERT), at the shipped
            recipes (configs/{weight_pruning,head_pruning/l1,row_pruning}/
            <upstream>_config_runner.yaml: B = 12 x 250,000 samples,
            wav2vec 2.0 weight pruning B = 4) with the events moved to
            consecutive updates from the first on (WAVE_EVENTS): each
            pair one event and one update (HuBERT l1 head pruning the
            first of its 11, to 11 heads a layer; wav2vec 2.0 row
            pruning's of 128 rows); per run its
            launches (every kernel per grad step, bf16), its events and
            each event's host seconds (the artifact's save apart); HuBERT
            head pruning: each event's heads against a host recompute of
            the l1 scores on the artifact before it, the live bytes
            around each event, the bf16 attention kernels against their
            plain versions at (12, h, 782, 64), h = 12 and 11, with the
            pad key, dropout 0 and 0.1, the head-pruned last-step.npz
            through the HuBERT expert (the trainer's weights, a training
            forward) and its frames/s beside the full model's, f32;
            activation checkpointing: one bf16 HuBERT grad step at
            the recipe's batch with checkpoint_activations off and on
            from the same generators (cuDNN deterministic): the loss and
            every gradient, the peak memory of each, the forward
            launches the recompute adds, and the two steps' times;
            wav2vec 2.0 weight pruning: each
            event's masks against a host recompute by
            global_magnitude_prune, every masked entry's gradient 0 in a
            bf16 grad step; wav2vec 2.0 row pruning: each event's rows
            against a host recompute of ffn_row_scores, the live bytes
            around each event;
  parallel  data-, tensor-, pipeline- and sequence-parallel work on
            the one card: two ranks of the trainer CLI's entry point
            (this script with --child, python -m
            speech_ssl_compression_tpu_torch.train's main, --multi_host
            --dist_backend gloo, torchrun's variables; NCCL refuses two
            ranks on one device), started before w2v2
            train (they wait for the phase's spec; every run but the
            timed new ones, PAR_LATE, runs while w2v2 train and wave prune
            run here, its times shared with them), each in a directory of
            its own, full-width MelHuBERT from the train phase's
            checkpoint (-i), B = 4 x T = 768 a rank: (a) data parallel
            f32 (TF32 off, dropout 0) for 3 updates, held to the
            1-process replay of its global batches in this process
            (losses rtol 2e-4; update_check: every update's gradients
            rel. L2 1e-4, each run's parameters within JAX's elementwise
            rtol 1e-4 + atol 1e-6 of a plain Adam on its own gradients,
            and of the replay's but for the entries rounding decides,
            counted), which must fail three planted faults made from the
            run's data (a LayerNorm bias left unreduced, Adam without bias
            corrections), then 2 bf16 updates with the shipped dropouts;
            (b) --model_parallel 2, f32 for 2 updates, its gathered
            gradients and checkpoint held to a 1-process run by
            update_check, the checkpoint served by a 1-process
            MelHuBERTExtractor against that run's parameters (SLICE_BAR),
            then one bf16 grad step of its model timed; (c) HuBERT data
            parallel, bf16, tc_pallas, one update; (d)
            --pipeline_parallel 2 --pp_microbatches 4 (6 layers a
            stage), f32 for 2 updates held by update_check to the same
            1-process run as (b), then 2 bf16 updates with the shipped
            dropouts, whose model the ranks keep and time again in 2 more
            updates with the card to themselves (pipeline_timing): each
            stage's grad step, its time blocked in sends and receives and
            in the sums over the world (its idle share: the bubble); (e)
            sequence parallel (seqpar_rank): one
            8192-frame 10 ms utterance through forward_seqpar, f32 and
            bf16, held to the long phase's 1-process forward (SLICE_BAR,
            BF16_SLICE_BAR), and T = 8192 distillation (12 -> 6 layers,
            B = 1), one f32 step of each loss type held to the long
            phase's 1-process steps (GRAD_BAR) and a bf16 step timed,
            with the host gathers' share. A verifier process beside the
            ranks (verify_main) computes the 1-process yardsticks and
            holds the f32 runs to them while the parent runs w2v2 train
            and wave prune; the ranks write only the f32 CLI runs'
            last-step.npz (the checkpoints the verifier reads). Per update and rank: its time,
            its grad steps', its collectives' (gloo runs them on the host:
            the rank's idle share, at least), and per run the peak memory
            and the saves' seconds; only rank 0 writes; the ranks'
            launches count as the main path's ("melhubert pipeline
            train", "melhubert seqpar serve", "melhubert seqpar
            distill", "parallel <run>");
  journey   journey.py's run_journey, the staged compression journey, at
            full width (12 layers of 768, FFN 3072, 12 heads, K = 512, 64
            crops of B = 4 x T = 768, the trainers in f32 as JAX's journey
            runs them) in a process of its own (this script with
            --journey, journey_main), its imports and CUDA context during
            long, its stages started after long: its stages, checks and
            curve share the card with hubert serve ... wave prune, as the
            parallel ranks do, and its timed serving waits
            until the parallel phase has ended (journey_ready before it,
            phase_journey_join after it). journey_schedule, a cut in depth:
            3 pretrain updates; the weight-pruning ladder [0.3, 0.5, 0.7]
            under always at steps 1-3 of 4; 2 data-driven head events of
            12 heads and 2 row events of 512 rows, the first of each before
            any update; 2 distill updates into the 6-layer student; 5
            serving repeats. Checks (JourneyChecks): each stage's held-out
            CE finite and within GRAD_BAR of impl="dense" on its checkpoint
            (f32, TF32 off, the saved span mask); each rung's artifact
            exactly round(amount n) of the n prunable entries masked; the
            head-prune run's first parameters bitwise stage 2's folded
            weights, no live masks; each head and row event a host
            recompute from the artifact before it; row pruning on stage
            3's ragged heads; a 6-layer student whose teacher is bitwise
            stage 1; journey_curve over every checkpoint (more points than
            stages, finite CEs); the four served models against
            impl="dense" (SLICE_BAR); each stage's launches, all f32,
            exactly as many as it must make ("journey <stage>" in
            launches_by_path); the four serving frames/s (CUDA events,
            median of 5, the card to itself);
  profile   (--profile only) device busy time, idle share and the largest
            device kernels of forward_packed from features, per path, and
            of the MelHuBERT, HuBERT and wav2vec 2.0 bf16 grad steps, the
            distill micro-step and its teacher forward.

Checkpoint saves that no check reads are skipped for the script's time
(unread_saves_skipped: the train phase's states-epoch-0, the l1 head
pruning run's last states_prune, distill's but run A's last-step, the
long phase's states-epoch-0, and in wave prune each pair's files but
those WAVE_READS names).

The conv kernels' bf16 check: kernel and plain version round only their
outputs, so every entry must lie within one ulp and fewer than
BF16_SHARE_BAR may differ; a control that rounds the two halves of the
reduction to bf16 before adding them must fail that share.

The bf16 kernel check. Kernel and plain version both round their output to
bf16, so the two may differ by one bf16 ulp wherever the f32 results
straddle a rounding point. The plain version runs with the kernel's key
tiles (block_k), so a bf16 P is rounded at the same points. The check asks
that every valid entry lie within one ulp (of max(|ref|, mean |ref|)) and
that fewer than BF16_SHARE_BAR of them differ at all. A control, the same
plain version with P left in f32, must fail that share, or the check could
not see the rounding of P and the script fails (with one key, T = 1, P = 1
is exact and there is no rounding to see: there the kernel must give the
plain version's bits).

The bf16 forward kernel computes the scores on the tensor cores, in
another order than the plain version's f32 product, so a p that lies
within the scores' error bound of a bf16 rounding point may round the
other way. Where short segments give single keys large weights
(STRADDLE_CASES: the packed serving batch), one such p moves an entry by
about an ulp. With random inputs at T = 768 a few such p can do it
too: of the head prune phase's 24 ragged-heads bf16 forward cases, 3
hold entries past one ulp (up to 2.08), each row back within 0.5 ulp
once 1 to 7 of its straddling p round the other way. There, and only
there, an entry may lie past one ulp if
  * it lies within one ulp plus its straddle bound
    (flash_attention.bf16_forward_straddle_bounds: the most that rounding
    those p the other way can move it), and
  * rounding some of its row's straddling p the other way brings the
    whole row of the plain version within one ulp of the kernel's
    (flash_attention.bf16_forward_straddle_flips).

The backward kernels are held to the same share bar against the plain
backward, which rounds dS and Pd to bf16 where the kernels do (its control
leaves them in f32), and each entry to one ulp plus its straddle bound
(flash_attention.bf16_straddle_bounds, for the dS and Pd terms). Each
bound is built from the inputs before the kernels run.

The line before the last holds the kernels' JSON record: per kernel its
f32 numbers at its main case (the serving batch for the forward, the
training shape with dropout for the backward kernels, HuBERT's frontend
layers 1-6 summed for the conv kernels) and, under keys ending in _bf16,
its bf16 ones: ms (CUDA events), plain_ms, library_ms
(F.scaled_dot_product_attention or cuDNN, timed only: one Python call
each, its dispatch included), bound_ms (the larger of the FLOPs at the
dtype's peak, 165 TFLOP/s f32 (495 / 3: f32-accurate products in split
TF32 on the tensor cores) or 989 TFLOP/s bf16, and the bytes at 3.35
TB/s) and bound_by; launches (the main paths' runs), launches_by_dtype and
launches_by_path (per dtype); for the attention kernels also
launches_past_4096 and launches_past_4096_by_path, the long phase's
launches with max(Tq, Tk) past JAX's stream threshold. The attention
kernels' ms times their launches alone (launch_fwd, launch_bwd_dq,
launch_bwd_dkv on prebuilt masks); the forward's wrapper_ms times
flash_attention (or flash_attention_kv_full), the call the model makes,
host work included, as library_ms times SDPA's. The attention kernels'
other timed shapes are under "cases". The f32 forward's max_abs_err is
against the plain version in float64. Every entry names the file of its
f32 kernel (source) and of its bf16 kernel (source_bf16) and the HGMMA
counts of both (hgmma, hgmma_bf16).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()  # the whole run's clock: torch's import on

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG_YAML = ROOT / "configs" / "melhubert" / "config_model_20ms.yaml"
MEAN_STD = ROOT / "example" / "libri-960-mean-std.npy"
FWD_F32_SOURCE = (
    "speech_ssl_compression_tpu_torch/csrc/flash_attn_fwd_f32_sm90.cu")
BWD_F32_SOURCE = (
    "speech_ssl_compression_tpu_torch/csrc/flash_attn_bwd_f32_sm90.cu")
FWD_SM90_SOURCE = "speech_ssl_compression_tpu_torch/csrc/flash_attn_fwd_sm90.cu"
BWD_SM90_SOURCE = "speech_ssl_compression_tpu_torch/csrc/flash_attn_bwd_sm90.cu"
ATTN_SOURCES = {"flash_attn_fwd": FWD_F32_SOURCE,
                "flash_attn_bwd_dq": BWD_F32_SOURCE,
                "flash_attn_bwd_dkv": BWD_F32_SOURCE}
ATTN_REPLACES = {
    "flash_attn_fwd": "speech_ssl_compression_tpu/ops/flash_attention.py:66",
    "flash_attn_bwd_dq": "speech_ssl_compression_tpu/ops/flash_attention.py:473",
    "flash_attn_bwd_dkv":
        "speech_ssl_compression_tpu/ops/flash_attention.py:537",
}
# the kernels' names in the built library's symbols
KERNEL_SYMBOLS = ("flash_attn_fwd_f32_kernel", "flash_attn_fwd_bf16_kernel",
                  "flash_attn_bwd_dq_bf16_kernel",
                  "flash_attn_bwd_dkv_bf16_kernel",
                  "flash_attn_bwd_dq_f32_kernel",
                  "flash_attn_bwd_dkv_f32_kernel", "conv1d_fwd_f32_kernel",
                  "conv1d_split_w_kernel", "conv1d_split_w_dx_kernel",
                  "conv1d_dw_reduce_kernel", "conv1d_dw_f32_kernel",
                  "conv1d_dx_f32_kernel", "conv1d_fwd_bf16_kernel",
                  "conv1d_dw_bf16_kernel", "conv1d_dx_bf16_kernel")
# the kernels that must run on the tensor cores: {(name, dtype tag): symbol}
TENSOR_CORE_KERNELS = {
    ("flash_attn_fwd", "f32"): "flash_attn_fwd_f32_kernel",
    ("flash_attn_fwd", "bf16"): "flash_attn_fwd_bf16_kernel",
    ("flash_attn_bwd_dq", "bf16"): "flash_attn_bwd_dq_bf16_kernel",
    ("flash_attn_bwd_dkv", "bf16"): "flash_attn_bwd_dkv_bf16_kernel",
    ("flash_attn_bwd_dq", "f32"): "flash_attn_bwd_dq_f32_kernel",
    ("flash_attn_bwd_dkv", "f32"): "flash_attn_bwd_dkv_f32_kernel",
    ("conv1d_fwd", "f32"): "conv1d_fwd_f32_kernel",
    ("conv1d_dw", "f32"): "conv1d_dw_f32_kernel",
    ("conv1d_dx", "f32"): "conv1d_dx_f32_kernel",
    ("conv1d_fwd", "bf16"): "conv1d_fwd_bf16_kernel",
    ("conv1d_dw", "bf16"): "conv1d_dw_bf16_kernel",
    ("conv1d_dx", "bf16"): "conv1d_dx_bf16_kernel"}
# the melhubert_pretrain batch: B = 4 utterances cropped to 750 stacked
# frames (sequence_length), padded to 768
TRAIN_SHAPE = (4, 12, 768, 64)
TRAIN_LENGTHS = (750, 750, 700, 512)  # kernel checks: a mix of lengths
DROPOUT_P, DROPOUT_SEED = 0.1, 1234
KEEP_SIGMAS = 5.0  # kernel keep rate within 5 sigma of the binomial
GRAD_BAR = 1e-4  # rel. L2, loss and every gradient: kernels vs impl="dense"
# stacked 20 ms frame counts of the two bundled LibriSpeech utterances that
# bench.py tiles into its 16-utterance serve batch
SERVE_LENGTHS = (101,) * 8 + (792,) * 8
CAPACITY = 896  # pack row width those lengths give (792 rounded up to 128)
RECT_VALID_KEYS = 4800  # of the 5000 keys of the rectangular case
TIMED_CASES = ("serving", "training_dropout", "long", "rectangular",
               "long_8192")
F32_BAR, LSE_BAR = 1e-4, 1e-4  # max |d| / mean |ref|; lse max |d|
BF16_ULP_BAR = 1.0     # max |d| in bf16 ulps of max(|ref|, mean |ref|)
BF16_SHARE_BAR = 0.03  # share of valid bf16 outputs that differ at all
# bf16 backward: share of a gradient's valid entries that may lie past one
# ulp (each also within its straddle bound), fixed before any run
BF16_BEYOND_BAR = 0.001
# bf16 forward cases whose short segments give single keys weights large
# enough that one p rounded the other way moves an entry past one ulp
STRADDLE_CASES = ("serving",)
MAX_STRADDLE_ROWS = 64  # rows past one ulp the flip search takes
SLICE_BAR, PACKED_BAR, BF16_SLICE_BAR = 1e-4, 2e-4, 5e-2
# the stream phase at bench.py's two streaming rows (JAX package, :297-308):
# f32 lockstep B = 16 against a cache of 3072 frames, and the bf16 ring
# B = 64 over a 1024-frame window; chunks of 128 frames
STREAM_F32 = dict(batch=16, chunk_frames=128, max_frames=3072,
                  dtype=torch.float32, matmul_precision="highest")
STREAM_BF16 = dict(batch=64, chunk_frames=128, window_frames=1024,
                   dtype=torch.bfloat16, matmul_precision="default")
STREAM_SECONDS = (8.0, 40.0)  # the f32 streams' lengths, uniform
STREAM_REOPEN = (0, 1)        # slots finished early and opened again
STREAM_STEPS = 20             # timed lockstep steps per shape
# f32 stream against the dense full forward: tests/test_streaming.py's bar
STREAM_ATOL, STREAM_RTOL = 2e-5, 1e-5
# the ring's longest stream (past its wrap: the ring holds ceil((1024 +
# 128) / 128) * 128 = 1152 frames; bench.py's max_frames 1280 is ignored
# with a window), its reused slot's stream, and the range of the other
# slots' lengths, in stacked frames
RING_LONG, RING_REUSED, RING_LENGTHS = 2000, 400, (300, 1400)
# the wave serve phase: forward_stream over WAVE_BATCHES batches of 16
# utterances at SERVE_LENGTHS (synthetic_wavs(seed=i), the first the slice
# phase's own); the device fbank within FBANK_BAR (max |d| / max |ref|) of
# the host's in float64 and of the port's plain CPU version; the
# device-featurized f32 serve within WAVE_BAR (max |d| / mean |ref|) of the
# host-featurized one (the features differ by float32 rounding, and 12
# layers carry it); the last layer clustered by the cluster CLI into K =
# 500 (the HuBERT iteration-2 recipe) in 2 epochs of 1024-row chunks (the
# D^2 seeding runs on the host, O(rows K D))
WAVE_BATCHES = 8
FBANK_BAR = 1e-4
FBANK_EVERY = 4  # the host fbank of every 4th utterance, short and long
WAVE_BAR = 1e-3
KMEANS_K, KMEANS_EPOCHS, KMEANS_CHUNK = 500, 2, 1024
KMEANS_TIE = 1e-4  # a top-2 score gap under this share of |top| is a tie
SLICE_CKPT = "melhubert_20ms_seed0.npz"
CONV_SM90_SOURCE = "speech_ssl_compression_tpu_torch/csrc/conv1d_sm90.cu"
# the f32 conv kernels, all three in split TF32 in one file (csrc/conv1d.cu
# keeps the C entry points and dW's reduce kernel)
CONV_SOURCES = dict.fromkeys(
    ("conv1d_fwd", "conv1d_dw", "conv1d_dx"),
    "speech_ssl_compression_tpu_torch/csrc/conv1d_f32_sm90.cu")
# (B, T, C, K, O, stride) at the ragged edges of the bf16 kernels' 128-row
# tiles and 64-row steps: one output row, one row past a tile, three
# batches, C != O, the last input row read (T - K divisible by s) or not,
# taps over three phases
CONV_EDGE_CASES = (("t_out1", (2, 3, 512, 3, 512, 2)),
                   ("t_out65", (2, 131, 512, 3, 512, 2)),
                   ("b3", (3, 777, 512, 3, 512, 2)),
                   ("c256_o384", (2, 515, 256, 3, 384, 2)),
                   ("k2s2_last_row", (2, 300, 512, 2, 512, 2)),
                   ("k3s2_short", (2, 302, 512, 3, 512, 2)),
                   ("k7s3", (2, 400, 128, 7, 128, 3)))
# strides past the forwards' per-phase maps (SM90_MAX_STRIDE):
# conv1d_strided folds the stride into the channels and runs the stride-1
# kernels; no output tap wasted at K = s, a third of them zero at K = 20
CONV_FOLD_CASES = (("k9s9", (2, 777, 512, 9, 512, 9)),
                   ("k20s9", (2, 777, 512, 20, 512, 9)))
CONV_REPLACES = {
    "conv1d_fwd": "speech_ssl_compression_tpu/ops/conv1d.py:63",
    "conv1d_dw": "speech_ssl_compression_tpu/ops/conv1d.py:106",
    "conv1d_dx": "speech_ssl_compression_tpu/ops/conv1d.py:153",
}
# f32 conv kernels against the plain version run in float64: forward and dX
# max |d| / mean |ref|, dW rel. L2 (its sums run over up to ~10^5 rows)
CONV_F32_BAR = 1e-5
# the grouped pos-conv (ops/grouped_conv.py, JAX's grouped_conv1d) at the
# shapes the model paths give it, (B, T in, C, G, K, pad): MelHuBERT's,
# HuBERT's and wav2vec 2.0's K = 128 SamePad at the training batch; the deep
# stack's K = 19; the f32 lockstep stream step's VALID window (B = 16, 128
# frames out of 128 + K - 1); one 8192-frame utterance
GC_CASES = (("pos_conv", (4, 768, 768, 16, 128, (64, 64))),
            ("deep", (4, 768, 768, 16, 19, (9, 9))),
            ("stream", (16, 255, 768, 16, 128, (0, 0))),
            ("long", (1, 8192, 768, 16, 128, (64, 64))))
# rel. L2 against the float64 sums of the same operands: f32 (TF32 off)
# forward, dX and dW; bf16 inputs' f32 forward and f32 dW sums. bf16 dX
# (rounded from f32) within BF16_ULP_BAR of its float64 value
GC_BAR = 1e-5
GC_REPLACES = "speech_ssl_compression_tpu/ops/grouped_conv.py:45"
WP_MODEL_YAML = ROOT / "configs" / "weight_pruning" / "config_model_20ms.yaml"
WP_RUNNER_YAML = ROOT / "configs" / "weight_pruning" / "config_runner_20ms.yaml"
# the prune: keys the weight prune phase shortens (one event at step 1,
# the ladder's first entry; a cut in depth for the script's time), and its
# updates: the event fires at the top of the 2nd window
WP_SHORT = dict(warnup=1, period=1, n_iters=1, pruning_condition="always")
WP_STEPS = 2
HP_DIR = ROOT / "configs" / "head_pruning"
RP_DIR = ROOT / "configs" / "row_pruning"
# the recipes' prune events down to their endpoints (one head a layer in
# HP_EVENTS events of HP_HEADS, where the data-driven recipe takes 11 of
# 12; FFN 512 in RP_EVENTS events of RP_ROWS, where the recipe takes 20 of
# 128: cuts in depth for the script's time), one before each update from
# the first on
STRUCTURED_SHORT = dict(warm_up=0, interval=1)
HP_EVENTS, HP_HEADS, HP_L1_EVENTS, RP_EVENTS, RP_ROWS = 2, 66, 1, 2, 1280
# the head prune phase's set: 16 buckets of B = 4, two stacked scoring
# groups of B = 32 at data_ratio 1.0
HP_UTTS, HP_DATA_RATIO, HP_GROUPS = 64, 1.0, 2
DISTILL_DIR = ROOT / "configs" / "distillation"
# run A's updates of the shipped distillation recipe (a cut in depth for the
# script's time)
DISTILL_STEPS = 1
# the long phase (bench.py's long-form rows, JAX package :395, :797, :979):
# the shipped 10 ms recipe, one update; one utterance of LONG_SAMPLES
# samples, (N - 400) // 160 + 1 = LONG_T frames of 10 ms with snip edges;
# the 10 ms distillation student (dropouts 0) under a 12-layer 10 ms
# teacher at B = 1, LONG_DISTILL_STEPS updates a dtype
TEN_MS_MODEL_YAML = ROOT / "configs" / "melhubert" / "config_model_10ms.yaml"
TEN_MS_RUNNER_YAML = (ROOT / "configs" / "melhubert" /
                      "config_runner_10ms.yaml")
DISTILL_10MS_YAML = DISTILL_DIR / "config_model_10ms.yaml"
LONG_T, LONG_SAMPLES = 8192, 1_311_000
# the sequence-parallel distillation of the parallel phase and its
# 1-process yardstick in the long phase: both loss terms weigh in
SEQPAR_TEMPERATURE, SEQPAR_ALPHA, SEQPAR_MASK_SEED = 2.0, 0.5, 4
LONG_DISTILL_STEPS = 2
HUBERT_YAML = ROOT / "configs" / "hubert" / "config_model.yaml"
HUBERT_SERVE = (8, 491520)  # B x samples: bench.py's hubert extraction row
HUBERT_TRAIN = (4, 245760)  # B x samples: train/wave_bench.py's recipe
HUBERT_CLASSES = 504        # 500 clusters + 4 specials, the bench recipe's
HUBERT_ACCUM = 2            # micro-batches per update in the trainer run
W2V2_DIR = ROOT / "configs" / "wav2vec2"
W2V2_TRAIN = (12, 250000)   # B x samples: the shipped recipe's batch
W2V2_PARITY = (2, 250000, 200000)  # B x samples, row 1's valid samples
# the wave prune phase: the shipped runner YAMLs of the waveform models'
# pruning modes, and each (upstream, mode) pair's events, one before each
# update from the first on, one event each: HuBERT's l1 head pruning took
# all of the recipe's 11, to one head a layer, until the long phase came,
# wav2vec 2.0's weight and row pruning 2 until the wave serve phase came:
# cuts in depth for the script's time (the MelHuBERT phases chain events
# on the same code, and reach one head a layer)
WAVE_RECIPES = {"weight-pruning": ROOT / "configs" / "weight_pruning",
                "head-pruning": HP_DIR / "l1", "row-pruning": RP_DIR}
WAVE_EVENTS = {("hubert", "head-pruning"): 1,
               ("wav2vec2", "weight-pruning"): 1,
               ("wav2vec2", "row-pruning"): 1,
               ("hubert", "weight-pruning"): 1,
               ("hubert", "row-pruning"): 1,
               ("wav2vec2", "head-pruning"): 1}
# the checkpoints of each wave prune pair that its checks read (every
# other save, ~1.1 GB, is skipped for the script's time)
WAVE_READS = {("hubert", "head-pruning"): ("states_prune_", "last-step"),
              ("wav2vec2", "weight-pruning"): ("before-pruning-",
                                               "last-step"),
              ("wav2vec2", "row-pruning"): ("states_prune_",)}
# past GRAD_BAR of float64, a wav2vec 2.0 gradient may lie this many times
# as far from it as the plain f32 route does (phase_w2v2_train says why)
W2V2_CANCEL_FACTOR = 4.0
def bound(flops: float, n_bytes: float, dtype,
          cuda_cores: bool = False) -> tuple:
    """(least ms the current card could take, "operations" or "bytes"): the
    larger of the FLOPs over the dtype's peak and the bytes over HBM
    bandwidth, both from speech_ssl_compression_tpu_torch/utils/flops.py
    (NVIDIA's data sheets; an unknown card raises). f32-accurate products
    run on the tensor cores in split TF32, three TF32 products each (495 /
    3 TFLOP/s on an H100 SXM; the CUDA cores' 67 would read below the f32
    backward kernels' times), or with ``cuda_cores`` on the CUDA cores."""
    from speech_ssl_compression_tpu_torch.utils.flops import (
        peak_bytes, peak_flops,
    )

    t_ops = flops / peak_flops(dtype, cuda_cores=cuda_cores)
    t_bytes = n_bytes / peak_bytes()
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3, inner: int = 1, warm: bool = True) -> float:
    """Median over ``reps`` of CUDA-event time per call, after one warm-up
    (none without ``warm``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rel_err(got, ref, valid) -> float:
    """max |got - ref| / mean |ref| over the valid entries."""
    got, ref = got.float()[valid], ref.float()[valid]
    return float((got - ref).abs().max() / ref.abs().mean())


def rel_l2(got, ref, valid) -> float:
    got, ref = got.float()[valid], ref.float()[valid]
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def bf16_ulp(ref, floor=None):
    """One bf16 ulp of max(|ref|, floor), the floor mean |ref| unless
    given; a bf16 x in [2^e, 2^(e+1)) has ulp 2^(e-7). The floor keeps
    near-zero entries, whose f32 sums carry errors of the row's scale, from
    counting as many ulps."""
    mag = ref.abs().clamp_min(float(ref.abs().mean()) if floor is None
                              else floor)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def bf16_diff(got, ref, valid):
    """(share of valid entries where two bf16 tensors differ, max |d| in
    bf16 ulps)."""
    got, ref = got.float()[valid], ref.float()[valid]
    d = (got - ref).abs()
    return float((d > 0).float().mean()), float((d / bf16_ulp(ref)).max())


def bf16_bound_diff(got, ref, bound, valid):
    """bf16_diff's (share, max ulps), then the count of valid entries beyond
    one ulp, the largest excess over one ulp as a share of that entry's
    straddle bound (the check passes at <= 1; inf where the bound is 0),
    and the median bound in ulps."""
    got, ref, bound = got.float()[valid], ref.float()[valid], bound[valid]
    ulp = bf16_ulp(ref)
    d = (got - ref).abs()
    beyond = d > ulp
    need = 0.0
    if beyond.any():
        need = float(((d - ulp)[beyond] / bound[beyond]).max())
    return (float((d > 0).float().mean()), float((d / ulp).max()),
            int(beyond.sum()), need, float((bound / ulp).median()))


def packed_segments(lengths, capacity, device):
    """Segment ids of the serve batch as forward_packed lays it out."""
    from speech_ssl_compression_tpu_torch.ops.packing import (
        build_pack_arrays, plan_packing,
    )

    rows = plan_packing(lengths, capacity)
    _, seg, _ = build_pack_arrays(lengths, rows, capacity, capacity)
    return torch.from_numpy(seg).to(device)


def train_padding(dev):
    """Key padding (B, 768) of the kernel checks at the training shape."""
    lens = torch.tensor(TRAIN_LENGTHS, device=dev)
    return torch.arange(TRAIN_SHAPE[2], device=dev)[None, :] >= lens[:, None]


def rect_padding(dev):
    """Key padding (1, 5000) of the rectangular case: the last 200 keys."""
    pad = torch.zeros((1, 5000), dtype=torch.bool, device=dev)
    pad[0, RECT_VALID_KEYS:] = True
    return pad


def kernel_cases(dev):
    """(name, q shape, k shape, mask kwargs, valid rows (B, Tq) bool)."""
    seg = packed_segments(SERVE_LENGTHS, CAPACITY, dev)
    pad_tail = torch.zeros((2, 1024), dtype=torch.bool, device=dev)
    pad_tail[1, 900:] = True
    lens = torch.tensor([896, 700, 500, 101], device=dev)
    pad_1h = torch.arange(896, device=dev)[None, :] >= lens[:, None]
    pad_rect = rect_padding(dev)
    ones = lambda b, t: torch.ones((b, t), dtype=torch.bool, device=dev)
    return [
        ("serving", (seg.shape[0], 12, CAPACITY, 64), None,
         dict(segment_ids=seg, key_padding_mask=seg == 0), seg != 0),
        ("causal", (2, 12, 1024, 64), None,
         dict(causal=True, key_padding_mask=pad_tail), ones(2, 1024)),
        ("one_head", (4, 1, 896, 64), None,
         dict(key_padding_mask=pad_1h), ones(4, 896)),
        ("long", (1, 12, 5000, 64), None, {}, ones(1, 5000)),
        ("rectangular", (1, 12, 1024, 64), (1, 12, 5000, 64),
         dict(key_padding_mask=pad_rect), ones(1, 1024)),
    ]


def training_cases(dev):
    """The training shape, dropout 0 and 0.1, in kernel_cases' layout."""
    pad = dict(key_padding_mask=train_padding(dev))
    valid = torch.ones(TRAIN_SHAPE[0], TRAIN_SHAPE[2], dtype=torch.bool,
                       device=dev)
    return [("training", TRAIN_SHAPE, None, pad, valid),
            ("training_dropout", TRAIN_SHAPE, None,
             dict(pad, dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED), valid)]


def check_forward(fa, name, qs, ks, masks, valid, dtype, gen,
                  straddles=False, inputs=None):
    """One forward case of phase_kernels: the kernel on random q, k, v
    of ``dtype`` drawn from ``gen`` (or the given ``inputs``, (q, k, v) of
    a model's call) against the plain version at the bars above
    (``straddles``: a bf16 entry may lie past one ulp where straddling p
    explain it). Logs the comparison, raises where the two disagree, and
    returns (q, k, v, max |d| of the output). A model's bf16 call need not
    show the control's share, as check_backward says; its share is
    logged."""
    t0 = time.perf_counter()
    if inputs is None:
        q = torch.randn(qs, generator=gen, device=gen.device).to(dtype)
        k = torch.randn(ks, generator=gen, device=gen.device).to(dtype)
        v = torch.randn(ks, generator=gen, device=gen.device).to(dtype)
    else:
        q, k, v = inputs
    # the bound is built from the inputs, before the kernel runs
    bound = (fa.bf16_forward_straddle_bounds(q, k, v, **masks)
             if dtype == torch.bfloat16 else None)
    if ks != qs:
        got, lse = fa.flash_attention_kv_full(q, k, v, return_lse=True,
                                              **masks)
    else:
        got, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, **masks)
    torch.cuda.synchronize()
    rows = valid[:, None, :].expand(lse.shape)
    err = rel_err(got, ref, rows)
    max_abs = float((got.float() - ref.float())[rows].abs().max())
    lse_err = float((lse - ref_lse)[rows].abs().max())
    tag = "f32" if dtype == torch.float32 else "bf16"
    if dtype == torch.float32:
        # the kernel's products are f32-accurate (split TF32) but
        # not rounded where the f32 plain version's are: out and lse
        # are held to the plain version run in float64, and their
        # distance from the f32 one is printed
        exact, exact_lse = fa.flash_attention_reference(
            q.double(), k.double(), v.double(), **masks)
        plain_err, plain_lse = err, lse_err
        err = rel_err(got, exact, rows)
        max_abs = float((got.double() - exact)[rows].abs().max())
        lse_err = float((lse.double() - exact_lse)[rows].abs().max())
        own = rel_err(ref, exact, rows)
        del exact, exact_lse
        ok = err < F32_BAR and lse_err < LSE_BAR
        detail = (f"against the plain version in float64: "
                  f"max|d|/mean|ref| {err:.3e} (bar {F32_BAR:g}), "
                  f"lse max|d| {lse_err:.3e} (bar {LSE_BAR:g}); "
                  f"against it in f32: {plain_err:.3e}, lse "
                  f"{plain_lse:.3e} (that f32 version's own "
                  f"distance from float64 {own:.3e})")
    else:
        tiled, _ = fa.flash_attention_reference(
            q, k, v, block_k=fa.KERNEL_BLOCK_K, **masks)
        share, ulps, n_beyond, need, bound_med = bf16_bound_diff(
            got, tiled, bound, rows)
        del bound
        control, _ = fa.flash_attention_reference(
            q.float(), k.float(), v.float(), block_k=fa.KERNEL_BLOCK_K,
            **masks)
        ctl_share, ctl_ulps = bf16_diff(control.to(dtype), tiled, rows)
        ok = share < BF16_SHARE_BAR and lse_err < LSE_BAR
        detail = (f"differ {share:.3%} (bar {BF16_SHARE_BAR:.0%}), "
                  f"max {ulps:g} ulp (bar {BF16_ULP_BAR:g}"
                  f"{' + straddles' if straddles else ''}"
                  f"), {n_beyond} beyond 1 ulp "
                  f"(excess/straddle bound <= {need:.3g}, bar 1; "
                  f"median bound {bound_med:.3g} ulp), lse "
                  f"max|d| {lse_err:.3e} (bar {LSE_BAR:g}); control "
                  f"with P in f32: differ {ctl_share:.3%}, max "
                  f"{ctl_ulps:g} ulp; max|d|/mean|ref| {err:.3e}")
        if ulps > BF16_ULP_BAR:
            explained, flips = explain_straddles(fa, q, k, v, got,
                                                 tiled, rows, masks)
            ok = (ok and straddles and need <= 1.0
                  and explained)
            detail += f"; flip search: {flips}"
        if ks[2] == 1:
            # one key: P = exp(0) = 1 is exact in bf16, so there is
            # no rounding of P for the control to show; the output
            # is that key's V row, and must be its bits
            ok = ok and share == 0.0
            detail += " (one key: bar 0% differing)"
        elif inputs is None and not ctl_share >= BF16_SHARE_BAR:
            raise AssertionError(
                f"bf16 check at {name} cannot tell a kernel that "
                f"leaves P in f32 apart ({ctl_share:.3%} differ)")
    log("kernels", f"{name} {tag} q{tuple(qs)} k{tuple(ks)}: kernel vs "
        f"plain, {detail}, {time.perf_counter() - t0:.2f} s")
    if not (ok and torch.isfinite(got.float()[rows]).all()):
        raise AssertionError(f"kernel disagrees at {name} {tag}")
    return q, k, v, max_abs


def phase_kernels(dev, gpu: str):
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    record = {}
    for name, qs, ks, masks, valid in (kernel_cases(dev) + training_cases(dev)
                                       + edge_cases(dev)):
        ks = ks or qs
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, max_abs = check_forward(
                fa, name, qs, ks, masks, valid, dtype, gen,
                straddles=name in STRADDLE_CASES)
            tag = "f32" if dtype == torch.float32 else "bf16"
            if name in TIMED_CASES:
                # the kernel's launches alone, as backward_timing times the
                # backward's: the wrapper's host work per call (the bias,
                # the autograd Function) can pace a ~0.1 ms kernel; the
                # wrapper is timed on its own
                args = fa.forward_args(q, k, v, **masks)
                attend = (fa.flash_attention_kv_full if ks != qs
                          else fa.flash_attention)

                def run_kernel(args=args):
                    fa.launch_fwd(*args)

                def run_plain(q=q, k=k, v=v, masks=masks):
                    fa.flash_attention_reference(q, k, v, **masks)

                def run_wrapper(q=q, k=k, v=v, masks=masks, attend=attend):
                    attend(q, k, v, **masks)

                kernel_ms, plain_ms = alternate(run_kernel, run_plain,
                                                inner=5)
                wrapper_ms = cuda_ms(run_wrapper, inner=5)
                record["flash_attn_fwd", name, tag] = dict(
                    max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
                    wrapper_ms=wrapper_ms)
                log("timing", f"flash_attn_fwd {name} {tag} {tuple(qs)}: "
                    f"kernel {kernel_ms:.3f} ms, wrapper {wrapper_ms:.3f} "
                    f"ms, plain {plain_ms:.3f} ms [{gpu}]")
    return record


def explain_straddles(fa, q, k, v, got, ref, rows, masks):
    """(whether p rounded the other way account for every row of the bf16
    forward's output ``got`` with a valid entry past one ulp of ``ref``,
    a report): flash_attention.bf16_forward_straddle_flips must bring each
    such row within one ulp at every entry. More than MAX_STRADDLE_ROWS
    such rows fail without a search."""
    got, ref = got.float(), ref.float()
    ulp = bf16_ulp(ref, floor=float(ref[rows].abs().mean()))
    beyond = (((got - ref).abs() > ulp).any(dim=-1) & rows).nonzero()
    if beyond.shape[0] > MAX_STRADDLE_ROWS:
        return False, f"{beyond.shape[0]} rows past one ulp"
    found = fa.bf16_forward_straddle_flips(q, k, v, got, beyond, ulp, **masks)
    report = "; ".join(
        f"row {tuple(r)}: {n} straddling p, {f} rounded the other way: "
        f"max {a:g} -> {b:g} ulp"
        for r, (n, f, a, b) in zip(beyond.tolist(), found))
    return all(b <= BF16_ULP_BAR for *_, b in found), report


def alternate(run_kernel, run_plain, inner: int = 1, reps: int = 3,
              turns: int = 2):
    """(kernel ms, plain ms), each the mean of two CUDA-event medians of
    ``reps`` taken in the order plain, kernel, kernel, plain, to share
    drift; each warmed up once, before its first median. The grad steps
    and updates of the train phases take ``reps=1`` (a call of 0.1-0.8 s
    varies by less than its two turns do) and, for the script's time, one
    turn (``turns=1``: plain, kernel)."""
    p1 = cuda_ms(run_plain, reps, inner)
    k1 = cuda_ms(run_kernel, reps, inner)
    if turns == 1:
        return k1, p1
    k2 = cuda_ms(run_kernel, reps, inner, warm=False)
    p2 = cuda_ms(run_plain, reps, inner, warm=False)
    return (k1 + k2) / 2, (p1 + p2) / 2


def edge_cases(dev):
    """The ragged edges of the tiles and of the bf16 kernels' two-stage
    rings, in kernel_cases' layout: T = 777 with key padding and dropout,
    T = 65 (one row and one key past a tile) and T = 1 (one row, one
    key)."""
    lens = torch.tensor([777, 600], device=dev)
    pad = torch.arange(777, device=dev)[None, :] >= lens[:, None]
    ones = lambda b, t: torch.ones((b, t), dtype=torch.bool, device=dev)
    return [("ragged_777", (2, 12, 777, 64), None,
             dict(key_padding_mask=pad, dropout_p=DROPOUT_P,
                  dropout_seed=DROPOUT_SEED), ones(2, 777)),
            ("t65", (2, 12, 65, 64), None, {}, ones(2, 65)),
            ("t1", (2, 12, 1, 64), None, {}, ones(2, 1))]


def backward_cases(dev):
    """(name, q shape, k shape, forward kwargs, valid query rows (B, Tq),
    valid keys (B, Tk)): the training shape with dropout 0 and 0.1, the
    forward's other shapes (dropout-free; the rectangular one is the
    backward of flash_attention_kv_full), and the ragged edges T = 777 and
    T = 65. (With one key, T = 1, dQ and dK are zero up to rounding, which
    the relative bars cannot read; tests/test_torch_cuda.py checks them
    against zero.)"""
    ones = lambda b, t: torch.ones((b, t), dtype=torch.bool, device=dev)
    edges = [e for e in edge_cases(dev) if e[1][2] > 1]
    cases = []
    for name, qs, ks, masks, valid in (training_cases(dev) + kernel_cases(dev)
                                       + edges):
        kpm = masks.get("key_padding_mask")
        tk = (ks or qs)[2]
        valid_k = ones(qs[0], tk) if kpm is None else ~kpm
        cases.append((name, qs, ks, masks, valid, valid_k))
    return cases


def rows_of(valid, shape):
    """(B, T) valid mask -> (B, H, T) row selector for (B, H, T, d)."""
    return valid[:, None, :].expand(shape[:3])


def check_backward(fa, name, qs, ks, masks, valid_q, valid_k, dtype,
                   gen, inputs=None):
    """One backward case of phase_backward: the dQ and dK/dV kernels on
    the forward kernel's (out, lse) of random q, k, v and dO of
    ``dtype`` drawn from ``gen`` (or the given ``inputs``, (q, k, v, dO)
    of a model's call) against the plain backward at the bars above.
    Logs the comparison, raises where they disagree, and returns (the
    backward_args tuple, max |d| of dq, dk and dv).

    In bf16 the control (the plain backward with dS and Pd left in f32)
    must differ from the plain version in BF16_SHARE_BAR of the entries,
    or the check could not see the kernels' rounding of dS and Pd. A
    model's call (``inputs``) need not show it: where its gradients are
    sums over many keys of terms far below their rounding, the rounding
    of dS and Pd moves few bf16 outputs (the random inputs at the same
    shape carry that proof). There the control's share is logged, and
    every gradient's rel. L2 from the plain backward in float64 beside
    the plain bf16 backward's own."""
    t0 = time.perf_counter()
    if inputs is None:
        q, dout = (torch.randn(qs, generator=gen, device=gen.device).to(
            dtype) for _ in range(2))
        k, v = (torch.randn(ks, generator=gen, device=gen.device).to(dtype)
                for _ in range(2))
    else:
        q, k, v, dout = inputs
    # padded query rows carry dO = 0, as they do in the model
    dout = dout.masked_fill(~valid_q[:, None, :, None], 0.0)
    if ks != qs:
        out, lse = fa.flash_attention_kv_full(q, k, v, return_lse=True,
                                              **masks)
    else:
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
    args = fa.backward_args(q, k, v, lse, dout, **masks)
    # the bound is built from the inputs, before the kernels run
    bounds = (fa.bf16_straddle_bounds(*args) if dtype == torch.bfloat16
              else None)
    *got, dd = fa.launch_bwd(*args)
    *ref, ref_dd = fa.reference_bwd(*args)
    torch.cuda.synchronize()
    sel = (rows_of(valid_q, qs), rows_of(valid_k, ks),
           rows_of(valid_k, ks))
    tag = "f32" if dtype == torch.float32 else "bf16"
    names = ("dq", "dk", "dv")
    abs_errs = [float((g.float() - r.float())[s].abs().max())
                for g, r, s in zip(got, ref, sel)]
    # D, f32 whatever the inputs, against its plain version; in f32
    # also against JAX's D = rowsum(dO o O) from the forward's
    # output (a bf16 O is rounded, and that D with it)
    d_errs = [rel_err(dd, ref_dd, sel[0])]
    detail = f"D max|d|/mean|ref| {d_errs[0]:.3e}"
    if dtype == torch.float32:
        d_errs.append(rel_err(dd, fa.output_dd(out, dout), sel[0]))
        detail += f", against rowsum(dO o O) {d_errs[1]:.3e}"
    ok = max(d_errs) < F32_BAR
    detail += f" (bar {F32_BAR:g}); "
    if dtype == torch.float32:
        # the kernels' products are f32-accurate (split TF32) but
        # not rounded where the f32 plain version's are, which lies
        # up to ~2e-4 from the exact function itself (the causal
        # case): dq, dk and dv are held to the plain version run in
        # float64
        exact = fa.reference_bwd(*fa.float64_args(args))[:3]
        errs = [rel_err(g, r, s) for g, r, s in zip(got, exact, sel)]
        plain = [rel_err(g, r, s) for g, r, s in zip(got, ref, sel)]
        own = [rel_err(r, e, s) for r, e, s in zip(ref, exact, sel)]
        del exact
        ok = ok and max(errs) < F32_BAR
        detail += "max|d|/mean|ref| against the plain version in " + \
            "float64 " + ", ".join(
                f"{n} {e:.3e}" for n, e in zip(names, errs))
        detail += f" (bar {F32_BAR:g}); against it in f32 " + ", ".join(
            f"{n} {e:.3e}" for n, e in zip(names, plain))
        detail += " (that f32 version's own distance from float64 " + \
            ", ".join(f"{n} {e:.3e}" for n, e in zip(names, own)) + ")"
    else:
        f32_args = tuple(a.float() if torch.is_tensor(a)
                         and a.dtype == dtype else a for a in args)
        control = fa.reference_bwd(*f32_args)[:3]
        diffs = [bf16_bound_diff(g, r, b, s)
                 for g, r, b, s in zip(got, ref, bounds, sel)]
        del bounds
        ctl = [bf16_diff(c.to(dtype), r, s)
               for c, r, s in zip(control, ref, sel)]
        n_valid = [int(sl.sum()) * g.shape[-1]
                   for g, sl in zip(got, sel)]
        ok = ok and all(sh < BF16_SHARE_BAR and need <= 1.0
                        and nb < BF16_BEYOND_BAR * n
                        for (sh, _, nb, need, _), n
                        in zip(diffs, n_valid))
        detail += ", ".join(
            f"{n} differ {sh:.3%} max {u:g} ulp, {nb} beyond 1 ulp "
            f"({nb / nv:.4%}; excess/straddle bound <= {need:.3g}; "
            f"median bound {bm:.3g} ulp) (control {csh:.2%}, {cu:g} "
            f"ulp)" for n, (sh, u, nb, need, bm), (csh, cu), nv
            in zip(names, diffs, ctl, n_valid))
        detail += (f"; bars {BF16_SHARE_BAR:.0%}, 1 ulp + straddle "
                   f"bound, {BF16_BEYOND_BAR:.1%} beyond 1 ulp")
        if inputs is not None:
            exact = fa.reference_bwd(*fa.float64_args(args))[:3]
            detail += "; rel L2 from the plain version in float64: " + \
                ", ".join(f"{n} {rel_l2(g, e, s):.3e} (plain bf16 "
                          f"{rel_l2(r, e, s):.3e})" for n, g, r, e, s
                          in zip(names, got, ref, exact, sel))
            del exact
        elif not all(csh >= BF16_SHARE_BAR for csh, _ in ctl):
            raise AssertionError(
                f"bf16 backward check at {name} cannot tell kernels "
                "that leave dS and Pd in f32 apart")
    finite = all(torch.isfinite(g.float()[s]).all()
                 for g, s in zip(got, sel))
    log("backward", f"{name} {tag} q{tuple(qs)} k{tuple(ks)}: kernels "
        f"vs plain, {detail}, {time.perf_counter() - t0:.2f} s")
    if not (ok and finite):
        raise AssertionError(f"backward kernels disagree at {name} {tag}")
    return args, abs_errs


def phase_backward(dev, gpu: str):
    """The dQ and dK/dV kernels against the plain backward (TF32 off), on
    the forward kernel's (out, lse) and a random dO."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    record = {}
    for name, qs, ks, masks, valid_q, valid_k in backward_cases(dev):
        ks = ks or qs
        for dtype in (torch.float32, torch.bfloat16):
            args, abs_errs = check_backward(
                fa, name, qs, ks, masks, valid_q, valid_k, dtype, gen)
            tag = "f32" if dtype == torch.float32 else "bf16"
            record.setdefault(("flash_attn_bwd_dq", name, tag), {})[
                "max_abs_err"] = abs_errs[0]
            record.setdefault(("flash_attn_bwd_dkv", name, tag), {})[
                "max_abs_err"] = max(abs_errs[1:])
            if name in ("long", "rectangular"):
                backward_timing(args, name, tag, record, gpu)
            del args
    check_keep_bits(dev)
    check_determinism(dev)
    return record


def backward_timing(args, case: str, tag: str, record: dict, gpu: str,
                    inner: int = 5):
    """CUDA-event times, in turns, of the dQ kernel against its plain
    version (reference_dd, then reference_bwd_dq: the kernel computes D
    itself) and of the dK/dV kernel against reference_bwd_dkv, on one
    backward_args tuple, ``inner`` calls a median; into record[kernel,
    case, tag]."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    _, dd = fa.launch_bwd_dq(*args)
    ref_dd = fa.reference_dd(*args)

    def dq_plain():
        fa.reference_bwd_dq(*args, fa.reference_dd(*args))

    for name, kernel, plain in (
            ("flash_attn_bwd_dq", lambda: fa.launch_bwd_dq(*args), dq_plain),
            ("flash_attn_bwd_dkv", lambda: fa.launch_bwd_dkv(*args, dd),
             lambda: fa.reference_bwd_dkv(*args, ref_dd))):
        kernel_ms, plain_ms = alternate(kernel, plain, inner=inner)
        record.setdefault((name, case, tag), {}).update(ms=kernel_ms,
                                                        plain_ms=plain_ms)
        log("timing", f"{name} {case} q{tuple(args[0].shape)} "
            f"k{tuple(args[1].shape)} {tag}: kernel {kernel_ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms [{gpu}]")


def check_keep_bits(dev):
    """The forward kernels' keep bits, read back from their output, f32
    and bf16: with q = 0 every probability is 1/T, and v one-hot on the
    key's residue mod 64 makes out[..., c] * T * (1 - p) the count of kept
    keys j = c mod 64 in that row (at most T / 64 = 12, so a bf16 output,
    within 2^-9 of it, still rounds to the count). Those counts must equal
    the plain keep mask's, and the keep rate must lie within KEEP_SIGMAS of
    the binomial."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.ops.dropout import attention_keep_mask

    b, h, t, d = TRAIN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(TRAIN_SHAPE, device=dev, dtype=dtype)
        k = torch.randn(TRAIN_SHAPE, device=dev).to(dtype)
        v = torch.nn.functional.one_hot(torch.arange(t, device=dev) % d, d)
        v = v.to(dtype).expand(b, h, t, d).contiguous()
        for p in (0.1, 0.5):
            out = fa.flash_attention(q, k, v, dropout_p=p,
                                     dropout_seed=DROPOUT_SEED)
            counts = torch.round(out.double() * t * (1 - p)).long()
            keep = attention_keep_mask(DROPOUT_SEED, b, h, t, t, p, dev)
            plain = keep.view(b, h, t, t // d, d).sum(dim=3)
            n = keep.numel()
            rate = float(counts.sum()) / n
            sigma = (p * (1 - p) / n) ** 0.5
            z = abs(rate - (1 - p)) / sigma
            same = torch.equal(counts, plain)
            log("backward", f"{dtype} forward kernel keep bits at p={p}: "
                f"keep rate {rate:.6f} over {n} draws, {z:.2f} sigma from "
                f"{1 - p:g} (bar {KEEP_SIGMAS:g}); per-row counts equal to "
                f"the plain mask's: {same}")
            if not (same and z < KEEP_SIGMAS):
                raise AssertionError(f"kernel keep bits wrong at p={p} "
                                     f"({dtype})")


def check_determinism(dev):
    """The same seed gives the same forward and backward bits twice, in f32
    and in bf16; another seed gives another output."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(2)
    masks = dict(key_padding_mask=train_padding(dev), dropout_p=DROPOUT_P)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=gen, device=dev)
                         .to(dtype) for _ in range(4))

        def run(seed):
            out, lse = fa.flash_attention(q, k, v, return_lse=True,
                                          dropout_seed=seed, **masks)
            args = fa.backward_args(q, k, v, lse, dout, dropout_seed=seed,
                                    **masks)
            return (out, lse) + fa.launch_bwd(*args)

        first, second, other = run(7), run(7), run(8)
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        differ = not torch.equal(first[0], other[0])
        log("backward", f"{dtype}, seed 7 twice: forward out and lse, dq, "
            f"dk, dv, D bitwise equal: {same}; seed 8 gives another output: "
            f"{differ}")
        if not (same and differ):
            raise AssertionError(
                f"the kernels' dropout is not a function of the seed ({dtype})")


def synthetic_utterances(n_utts: int = 32, seed: int = 0):
    """The synthetic pre-training set's utterances, [(feat (n, 40) float32,
    labels (n,) int64)]: 40-d 10 ms features and k-means-like labels < 512
    that hold for runs of 4-19 frames, each feature a label embedding plus
    noise (so a fixed batch can be learned). Every utterance has
    1,500-1,699 frames: 750+ stacked 20 ms frames, cropped to
    sequence_length 750."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((512, 40)).astype(np.float32)
    out = []
    for _ in range(n_utts):
        n = int(rng.integers(1500, 1700))
        runs = rng.integers(4, 20, n)
        labels = np.repeat(rng.integers(0, 512, n), runs)[:n]
        feat = emb[labels] + 0.5 * rng.standard_normal((n, 40))
        out.append((feat.astype(np.float32), labels.astype(np.int64)))
    return out


def write_dataset(root: pathlib.Path, n_utts: int = 32, seed: int = 0) -> str:
    """:func:`synthetic_utterances` as .npy pairs and the CSV manifest the
    bucket dataset reads. Returns the CSV path."""
    root.mkdir(parents=True, exist_ok=True)
    rows = ["file_path,label_path,length"]
    for i, (feat, labels) in enumerate(synthetic_utterances(n_utts, seed)):
        fp, lp = root / f"feat_{i}.npy", root / f"label_{i}.npy"
        np.save(fp, feat)
        np.save(lp, labels)
        rows.append(f"{fp},{lp},{len(feat)}")
    csv = root / "train.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(csv)


# the 960 h release's tarball nests its 20 ms cluster split one level
# deeper; the CLI's --tar flattens it (preprocess.py::unpack_release)
RELEASE_NESTED = {"stage2-cluster-20ms": "stage2-cluster-20ms/split200"}
PRE_CM_UTTS = 4  # the last utterances of the release go in one CM ark


def write_kaldi_release(root: pathlib.Path, utts, hours: int = 960,
                        n_cm: int = PRE_CM_UTTS) -> list:
    """``utts`` ([(feat (n, D), 10 ms labels (n,))]) as a Kaldi release of
    ``hours``' layout under ``root``: an ``FM`` ark of the first and a
    ``CM`` (compressed) ark of the last ``n_cm`` utterances, the feature
    scp with each matrix's byte offset, the mean-var accumulator of the
    features (sums, sums of squares, frame count; written exactly), and per
    frame period a label text file (one line of labels an utterance: every
    frame's at 10 ms, every other frame's at 20 ms) and its label scp; the
    960 h release nests the 20 ms labels under split200/. The paths are
    the CLI's (preprocess.py::LAYOUTS). Returns the utterance keys in scp
    order."""
    from speech_ssl_compression_tpu_torch.data.kaldi_io import (
        write_feat_matrix,
    )
    from speech_ssl_compression_tpu_torch.preprocess import LAYOUTS

    layout = LAYOUTS[hours]
    feat_scp = root / layout["feat_scp"]
    fdir, stem = feat_scp.parent, feat_scp.stem
    fdir.mkdir(parents=True, exist_ok=True)
    keys = [f"utt{i:03d}" for i in range(len(utts))]
    scp, arks = [], {}
    for i, (key, (feat, _)) in enumerate(zip(keys, utts)):
        compress = i >= len(utts) - n_cm
        ark = fdir / f"raw_fbank_{stem}.{2 if compress else 1}.ark"
        if ark not in arks:
            arks[ark] = open(ark, "wb")
        f = arks[ark]
        f.write(key.encode() + b" ")
        scp.append(f"{key} {ark}:{f.tell()}")
        write_feat_matrix(f, np.asarray(feat, np.float64), compress=compress)
    for f in arks.values():
        f.close()
    feat_scp.write_text("\n".join(scp) + "\n")
    allf = np.concatenate([np.asarray(f, np.float64) for f, _ in utts])
    row = lambda v: "[" + ",".join(repr(float(x)) for x in v) + "]"
    (root / layout["mean_var"]).write_text(
        f"{row(allf.sum(0))}\n{row((allf ** 2).sum(0))}\n{len(allf)}\n")
    for fp, rel in layout["cluster_dirs"].items():
        ldir = root / RELEASE_NESTED.get(rel, rel)
        ldir.mkdir(parents=True, exist_ok=True)
        text, lines = ldir / f"labels.{fp}.txt", []
        with open(text, "w") as f:
            for key, (_, labels) in zip(keys, utts):
                lines.append(f"{key} {text}:{f.tell()}")
                step = 2 if fp == "20ms" else 1
                f.write(" ".join(map(str, labels[::step])) + "\n")
        (ldir / layout["label_scp_name"]).write_text("\n".join(lines)
                                                      + "\n")
    return keys


def phase_preprocess(dev, gpu: str, tmp: str) -> str:
    """The offline data path: the train phase's 32 utterances written as a
    960 h Kaldi release (FM arks, one CM ark, nested split200) in a
    tarball, and the port's preprocess CLI run on it in a subprocess
    (--tar, which unpacks and flattens split200). Its features must equal
    the utterances normalized by the release's accumulator: bitwise from
    the FM ark (float32 -> float64 exactly), within each column's CM
    quantisation step (1/63 of its range, plus the header's 1/65535 of the
    global range) from the CM ark; its labels the release's, its CSVs in
    scp order. Returns the 20 ms CSV, the train phase's set."""
    from speech_ssl_compression_tpu_torch.data.kaldi_io import read_mean_var
    from speech_ssl_compression_tpu_torch.preprocess import LAYOUTS

    layout = LAYOUTS[960]
    t0 = time.perf_counter()
    root = pathlib.Path(tmp) / "preprocess"
    utts = synthetic_utterances()
    staging = root / "release"
    keys = write_kaldi_release(staging, utts)
    tar = root / "release.tar"
    subprocess.run(["tar", "-cf", str(tar), "-C", str(staging), "."],
                   check=True)
    t_write = time.perf_counter() - t0
    data_dir, out = root / "kaldi", root / "out"
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-m",
                    "speech_ssl_compression_tpu_torch.preprocess",
                    str(data_dir), str(out), "--hours", "960", "--tar",
                    str(tar)], check=True, cwd=str(ROOT), env=env,
                   timeout=300, stdout=subprocess.DEVNULL)
    t_cli = time.perf_counter() - t0
    if (data_dir / RELEASE_NESTED["stage2-cluster-20ms"]).exists():
        raise AssertionError("split200 was not flattened")
    mean, std = read_mean_var(str(staging / layout["mean_var"]))
    stats = np.load(out / "mean-std.npy")
    if not (np.array_equal(stats[0], mean) and np.array_equal(stats[1], std)):
        raise AssertionError("mean-std.npy is not the accumulator's")
    csvs = {}
    for fp in ("10ms", "20ms"):
        lines = (out / f"{layout['csv_prefix']}-{fp}.csv").read_text(
        ).splitlines()
        csvs[fp] = [line.split(",") for line in lines[1:]]
        if lines[0] != "file_path,label_path,length" or [
                pathlib.Path(r[0]).stem for r in csvs[fp]] != keys:
            raise AssertionError(f"the {fp} CSV is not in scp order")
    worst_fm, worst_cm = 0.0, 0.0
    for (feat, labels), (fpath, lpath, n) in zip(utts, csvs["20ms"]):
        got = np.load(fpath)
        want = (np.asarray(feat, np.float64) - mean) / std
        if got.dtype != np.float64 or got.shape != want.shape or int(
                n) != len(feat):
            raise AssertionError(f"{fpath}: {got.dtype} {got.shape}")
        d = np.abs(got - want)
        if pathlib.Path(fpath).stem in keys[-PRE_CM_UTTS:]:
            # CM: a column's codes step by at most 1/63 of its range, the
            # percentile header by 1/65535 of the matrix's (normalized)
            span = feat.max(0) - feat.min(0)
            step = (span / 63 + (feat.max() - feat.min()) / 65535) / std
            worst_cm = max(worst_cm, float((d / step).max()))
            if not (d <= step).all():
                raise AssertionError(f"{fpath}: past the CM step")
        else:
            worst_fm = max(worst_fm, float(d.max()))
            if not np.array_equal(got, want):
                raise AssertionError(f"{fpath}: not the FM matrix")
        if not np.array_equal(np.load(lpath), labels[::2]):
            raise AssertionError(f"{lpath}: not the release's labels")
    log("preprocess", f"{len(keys)} utterances as a 960 h Kaldi release "
        f"({len(keys) - PRE_CM_UTTS} FM, {PRE_CM_UTTS} CM, nested "
        f"split200) and its tarball {t_write:.2f} s; the CLI (--tar) "
        f"{t_cli:.2f} s; features: FM max |d| {worst_fm:g} (bitwise), CM "
        f"at most {worst_cm:.3f} of its step; labels and scp order exact "
        f"[{gpu}]")
    return str(out / f"{layout['csv_prefix']}-20ms.csv")


RUNNER_YAML = """runner:
  n_epochs: 0
  total_steps: 3
  gradient_clipping: 10.0
  gradient_accumulate_steps: 8
  log_step: 1
  save_every_x_epochs: 10
  bf16: true
optimizer:
  lr: 0.0001
  betas:
  - 0.9
  - 0.999
  eps: 1.0e-08
  weight_decay: 0
datarc:
  num_workers: 1
  train_batch_size: 4
  max_timestep: 0
  sets:
  - {csv}
"""


def grad_errors(names, got, ref):
    """|got - ref|_2 / |ref|_2 per gradient. The k_proj biases' gradients
    are zero up to rounding (softmax is invariant to a shift of a row's
    scores), and a leaf weight pruning masked whole has a gradient of
    exact zeros, so theirs is taken against the norm of all gradients."""
    norm = lambda t: float(torch.linalg.vector_norm(t.float().ravel()))
    total = float(np.sqrt(sum(norm(r) ** 2 for r in ref)))
    return [norm(g.float() - r.float())
            / (total if n.endswith("k_proj.bias") or not norm(r) else norm(r))
            for n, g, r in zip(names, got, ref)]


def phase_train(dev, gpu: str, tmp: str, csv: str):
    """Pre-training through the trainer's entry point from ``csv`` (the
    preprocess phase's: the offline data path's output), then the checks
    on its model. The same utterances as .npy pairs (write_dataset) are
    the set of the later phases. Returns (runner, fixed batch, launch counts of the training
    run per dtype, (params, Adam state) as the trainer wrote them)."""
    from speech_ssl_compression_tpu_torch.extract import (
        load_any_checkpoint, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    t0 = time.perf_counter()
    root = pathlib.Path(tmp) / "train"
    write_dataset(root / "data")
    runner_yaml = root / "config_runner.yaml"
    runner_yaml.write_text(RUNNER_YAML.format(csv=csv))
    expdir = root / "exp"
    log("train", f"synthetic set written (32 utterances, 40-d, labels < "
        f"512), {time.perf_counter() - t0:.2f} s; the trainer reads the "
        f"preprocess CLI's {pathlib.Path(csv).name}")

    # the main path: counts from exactly one run of the trainer
    t0 = time.perf_counter()
    reset_launch_counts()
    runner = train(["-m", "melhubert", "-g", str(CONFIG_YAML), "-c",
                    str(runner_yaml), "-n", str(expdir), "--device", "cuda",
                    "--seed", "0"])
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
    by_dtype = dtype_launch_counts()
    cfg = runner.cfg
    micro = 3 * runner.accum_steps
    per_micro = {k: v / micro for k, v in counts.items()}
    log("train", f"MelHuBERT-20ms {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {runner.compute_dtype}, 3 updates x "
        f"{runner.accum_steps} micro-batches: launches per micro-batch "
        f"{per_micro} (expected {cfg.encoder_layers} each), "
        f"{time.perf_counter() - t0:.2f} s")
    if any(v != cfg.encoder_layers * micro for v in counts.values()):
        raise AssertionError(f"launch counts {counts}, want "
                             f"{cfg.encoder_layers * micro} each")
    hist = runner.log_history
    for entry in hist:
        log("train", f"update {entry['step']}: loss {entry['loss']:.6f}, "
            f"grad norm {entry['grad_norm']:.6f}")
    if [e["step"] for e in hist] != [1, 2, 3] or not all(
            np.isfinite([e["loss"], e["grad_norm"]]).all() for e in hist):
        raise AssertionError(f"trainer log {hist}")

    params, ckpt_cfg, meta = load_any_checkpoint(str(expdir / "last-step.npz"))
    last = cfg.encoder_layers - 1
    w = params["encoder"]["layers"][last]["fc2"]["kernel"]
    same = np.array_equal(
        w, runner.params[f"encoder.layers.{last}.fc2.weight"].detach().cpu()
        .numpy().T)
    log("train", f"last-step.npz read back through load_any_checkpoint: Step "
        f"{meta['Step']}, {ckpt_cfg.encoder_layers} layers, weights equal to "
        f"the trainer's: {same}")
    if not (same and meta["Step"] == 3
            and ckpt_cfg.encoder_layers == cfg.encoder_layers):
        raise AssertionError("checkpoint does not read back")
    # the state the trainer wrote, for the resume phase (the checks below
    # update the runner's params)
    snapshot = ([p.detach().clone() for p in runner.params.values()],
                [s.clone() for s in runner.opt_state])

    # one fixed micro-batch and span mask for the parity and fixed-batch runs
    batch = runner._device_batch(runner._get_dataloader().get_batch(0))
    t = batch["feat"].shape[1]
    mask = torch.from_numpy(span_mask(cfg, batch["length"], t,
                                      np.random.default_rng(0))).to(dev)
    if tuple(batch["feat"].shape) != (4, 768, 80):
        raise AssertionError(f"batch {tuple(batch['feat'].shape)}")

    t0 = time.perf_counter()
    results = {}
    for impl in ("auto", "dense"):
        step = make_melhubert_grad_step(runner.model, attn_impl=impl,
                                        deterministic=True)
        fa.reset_launch_counts()
        with matmul_precision("highest"):
            loss, grads, _ = step(runner.params, batch, torch.Generator(),
                                  mask_indices=mask)
        torch.cuda.synchronize()
        results[impl] = (loss, grads, dict(fa.launch_counts))
    (loss_k, grads_k, counts_k), (loss_d, grads_d, counts_d) = (
        results["auto"], results["dense"])
    loss_rel = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    names = list(runner.params)
    errs = grad_errors(names, grads_k, grads_d)
    worst = int(np.argmax(errs))
    log("train", f"grad step, kernels vs impl='dense' (f32, TF32 off, dropout "
        f"off, fixed span mask): loss {float(loss_k):.6f} vs "
        f"{float(loss_d):.6f}, rel {loss_rel:.3e}; worst of {len(errs)} "
        f"gradients rel L2 {errs[worst]:.3e} ({names[worst]}), bar "
        f"{GRAD_BAR:g}; launches {counts_k} and {counts_d}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (loss_rel < GRAD_BAR and max(errs) < GRAD_BAR):
        raise AssertionError("kernel gradients disagree with the dense path")
    if set(counts_k.values()) != {cfg.encoder_layers} or any(counts_d.values()):
        raise AssertionError("the parity run took the wrong path")

    t0 = time.perf_counter()
    step = make_melhubert_grad_step(runner.model,
                                    compute_dtype=runner.compute_dtype)
    losses = []
    for _ in range(10):
        loss, grads, _ = step(runner.params, batch, runner.rng,
                              mask_indices=mask)
        runner.apply(grads, 1.0)
        losses.append(float(loss))
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    log("train", f"10 updates on one fixed batch ({runner.compute_dtype}, "
        f"dropout on): loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; mean of the first 3 "
        f"{first:.4f}, of the last 3 {last:.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError("the loss does not fall on a fixed batch")
    return runner, batch, by_dtype, snapshot


def write_fairseq_dump(root: pathlib.Path, utts) -> str:
    """``utts`` as a fairseq feature dump: ``train.npy`` (every utterance's
    10 ms features, concatenated), ``train.len``, ``train.km`` (one line of
    10 ms labels an utterance) and the corpus's ``mean-std.npy``. Returns
    the mean-std path."""
    root.mkdir(parents=True, exist_ok=True)
    feats = np.concatenate([f for f, _ in utts])
    np.save(root / "train.npy", feats)
    (root / "train.len").write_text(
        "".join(f"{len(f)}\n" for f, _ in utts))
    (root / "train.km").write_text(
        "".join(" ".join(map(str, lab)) + "\n" for _, lab in utts))
    ms = root / "mean-std.npy"
    np.save(ms, np.stack([feats.mean(0), feats.std(0)]))
    return str(ms)


def phase_fairseq_dump(dev, gpu: str, tmp: str, runner):
    """The train phase's utterances as a fairseq dump, read by
    FairseqDumpBuckets (20 ms, crops of sequence_length 750, B = 4); one of
    its batches through the train phase's grad step (bf16, dropout on, the
    span mask drawn on the host) on the card: a finite loss, each
    attention kernel launched once a layer. Returns the launches per
    dtype."""
    from speech_ssl_compression_tpu_torch.data.fairseq_dump import (
        FairseqDumpBuckets,
    )
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    t0 = time.perf_counter()
    root = pathlib.Path(tmp) / "fairseq_dump"
    ms = write_fairseq_dump(root, synthetic_utterances())
    ds = FairseqDumpBuckets(frame_period=20, sequence_length=750,
                            bucket_size=4, feat_dir=str(root),
                            label_dir=str(root), split="train",
                            mean_std_pth=ms, seed=0)
    batch = runner._device_batch(ds.get_batch(0))
    t_data = time.perf_counter() - t0
    step = make_melhubert_grad_step(runner.model,
                                    compute_dtype=runner.compute_dtype)
    t0 = time.perf_counter()
    reset_launch_counts()
    loss, grads, _ = step(runner.params, batch, runner.rng)
    torch.cuda.synchronize()
    by_dtype = dtype_launch_counts()
    layers = runner.cfg.encoder_layers
    counts = {k: v["f32"] + v["bf16"] for k, v in by_dtype.items()
              if k.startswith("flash")}
    finite = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    log("fairseq dump", f"{len(ds)} buckets of the 32-utterance dump, batch "
        f"{tuple(batch['feat'].shape)} ({t_data:.2f} s); one "
        f"{runner.compute_dtype} grad step: loss {float(loss):.6f}, finite "
        f"loss and gradients {finite}, launches {counts} (expected {layers} "
        f"each), {time.perf_counter() - t0:.2f} s [{gpu}]")
    if tuple(batch["feat"].shape) != (4, 768, 80) or not finite:
        raise AssertionError("the dump's batch does not train")
    if set(counts.values()) != {layers}:
        raise AssertionError(f"launches {counts}, want {layers} each")
    return by_dtype


DEEP_POS_CONV = dict(pos_conv_depth=5, conv_pos=95)  # data2vec 2.0 audio


def phase_deep_pos_conv(dev, gpu: str, tmp: str, batch):
    """MelHuBERT-20ms at full width with the deep positional conv
    (DEEP_POS_CONV: 5 blocks of k = 19, data2vec 2.0's audio encoder),
    seeded weights through the npz bridge: the slice phase's 16 utterances
    through forward_packed in f32 (against impl="dense", SLICE_BAR) and
    bf16 (against the f32 dense path, BF16_SLICE_BAR), one f32 grad step
    (TF32 off, dropout off, a fixed span mask) with the kernels against
    impl="dense" (GRAD_BAR), and the forward from features timed in both
    dtypes. The npz is loaded once, by the f32 extractor: the bf16 one
    serves a bf16 copy of its model (the cast the extractor makes), and
    the grad step differentiates its weights.
    Returns the launches of the two forwards and of the grad step, per
    dtype."""
    from speech_ssl_compression_tpu_torch.configs import (
        MelHuBERTConfig, melhubert_config_from_yaml,
    )
    from speech_ssl_compression_tpu_torch.extract import (
        MelHuBERTExtractor, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

    t0 = time.perf_counter()
    cfg = MelHuBERTConfig.from_dict(dict(
        melhubert_config_from_yaml(CONFIG_YAML).to_dict(), **DEEP_POS_CONV))
    params = init_params_np(cfg, seed=0)
    ckpt = str(pathlib.Path(tmp) / "melhubert_deep_pos_conv.npz")
    save_checkpoint(ckpt, params, meta={
        "Upstream_Config": {"melhubert": cfg.to_dict()}, "Step": 0})

    # one extractor a dtype; impl="dense" is its attn_impl switched
    f32 = MelHuBERTExtractor(ckpt, fp=20, mean_std_npy_path=str(MEAN_STD),
                             matmul_precision="highest", device=dev)
    bf16 = copy.copy(f32)
    bf16.dtype = torch.bfloat16
    bf16.model = copy.deepcopy(f32.model).to(torch.bfloat16)
    exts = {"f32": f32, "bf16": bf16}

    def serve(tag, impl):
        exts[tag].attn_impl = impl
        return exts[tag].forward_packed(wavs)

    blocks = exts["f32"].model.encoder.pos_conv
    k = blocks[0][0].kernel_size[0]
    same = all(torch.equal(b[0].weight.cpu(), torch.from_numpy(p["weight"]))
               for b, p in zip(blocks, params["encoder"]["pos_conv"][
                   "layers"]))
    if not (len(blocks) == 5 and k == 19 and same):
        raise AssertionError(f"deep stack {len(blocks)} x k = {k} did not "
                             "come through the npz bridge")
    wavs = synthetic_wavs(seed=0)
    log("deep pos-conv", f"MelHuBERT-20ms {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, pos_conv_depth {cfg.pos_conv_depth} x "
        f"k = {k}, seeded weights through the npz bridge (bitwise), "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")

    # the main path: both forwards, counted from 0 just before them
    t0 = time.perf_counter()
    reset_launch_counts()
    out = {tag: serve(tag, "auto") for tag in ("f32", "bf16")}
    torch.cuda.synchronize()
    served = dtype_launch_counts()
    fa.reset_launch_counts()
    ref = serve("f32", "dense")
    torch.cuda.synchronize()
    if fa.launch_counts["flash_attn_fwd"]:
        raise AssertionError("impl='dense' launched the kernel")
    lengths = torch.tensor(ref["lengths"], device=dev)
    t = ref["last_hidden_state"].shape[1]
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    states = lambda o: o["hidden_states"] + [o["last_hidden_state"]]
    err = max(rel_err(a, b, valid) for a, b in zip(states(out["f32"]),
                                                   states(ref)))
    err_bf16 = max(rel_l2(a, b, valid) for a, b in zip(states(out["bf16"]),
                                                       states(ref)))
    finite = all(bool(torch.isfinite(s.float()[valid]).all())
                 for o in out.values() for s in states(o))
    fwd = {tag: served["flash_attn_fwd"][tag] for tag in ("f32", "bf16")}
    log("deep pos-conv", f"forward_packed, kernel vs impl='dense' (f32, "
        f"TF32 off), all hidden states: max|d|/mean|ref| {err:.3e} (bar "
        f"{SLICE_BAR:g}); bf16 vs f32 dense |d|_2/|ref|_2 {err_bf16:.3e} "
        f"(bar {BF16_SLICE_BAR:g}); finite {finite}; flash_attn_fwd "
        f"launches {fwd} (expected {cfg.encoder_layers} each), "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    if not (err < SLICE_BAR and err_bf16 < BF16_SLICE_BAR and finite):
        raise AssertionError("the deep pos-conv model's serving disagrees")
    if set(fwd.values()) != {cfg.encoder_layers}:
        raise AssertionError(f"launches {fwd}")

    t0 = time.perf_counter()
    model = f32.model
    named = {n: p.detach().requires_grad_()
             for n, p in model.named_parameters()}
    mask = torch.from_numpy(span_mask(cfg, batch["length"],
                                      batch["feat"].shape[1],
                                      np.random.default_rng(0))).to(dev)
    results = {}
    for impl in ("auto", "dense"):
        step = make_melhubert_grad_step(model, attn_impl=impl,
                                        deterministic=True)
        reset_launch_counts()
        with matmul_precision("highest"):
            loss, grads, _ = step(named, batch, torch.Generator(),
                                  mask_indices=mask)
        torch.cuda.synchronize()
        results[impl] = (loss, grads, dtype_launch_counts())
    (loss_k, grads_k, train), (loss_d, grads_d, _) = (results["auto"],
                                                      results["dense"])
    loss_rel = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    errs = grad_errors(list(named), grads_k, grads_d)
    worst = int(np.argmax(errs))
    pos_worst = max(e for n, e in zip(named, errs) if "pos_conv" in n)
    launched = {n: c["f32"] for n, c in train.items()
                if n.startswith("flash")}
    log("deep pos-conv", f"f32 grad step, kernels vs impl='dense' (TF32 "
        f"off, dropout off, fixed span mask): loss rel {loss_rel:.3e}; worst "
        f"of {len(errs)} gradients rel L2 {errs[worst]:.3e} "
        f"({list(named)[worst]}), of the deep stack's {pos_worst:.3e}, bar "
        f"{GRAD_BAR:g}; launches {launched}, "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    if not (loss_rel < GRAD_BAR and max(errs) < GRAD_BAR):
        raise AssertionError("the deep pos-conv gradients disagree")
    if set(launched.values()) != {cfg.encoder_layers}:
        raise AssertionError(f"launches {launched}")
    del model, named, results, grads_k, grads_d

    # the model's time: forward_packed from features (from waveforms the
    # host fbank takes most of it)
    frames = sum(SERVE_LENGTHS)
    for tag, ext in exts.items():
        feat, pad_mask, lengths = ext.featurize(wavs)
        ext.attn_impl = "auto"
        ms = cuda_ms(lambda: ext._pack_and_dispatch(feat, pad_mask, lengths))
        log("deep pos-conv", f"forward_packed {tag}: {ms:.2f} ms, "
            f"{frames / ms * 1e3:.0f} frames/s from features [{gpu}]")
    return served, train


DEVICE_MASK = dict(mask_prob=0.8, mask_length=10, min_masks=2,
                   require_same_masks=False)  # melhubert_forward's draw
DEVICE_MASK_DRAWS = 200
MASK_SIGMAS = 5.0  # the two samplers' mean fractions within 5 sigma


def phase_device_masks(dev, gpu: str, runner, batch):
    """The device span-mask sampler (ops/masking.py::compute_span_mask) on
    the card at B = 4, T = 768 (TRAIN_LENGTHS), MelHuBERT's draw
    (DEVICE_MASK): DEVICE_MASK_DRAWS draws, no True past a row's length,
    their mean masked fraction within MASK_SIGMAS binomial sigmas of as
    many host draws (compute_mask_indices_np; a sigma over the draws' spans,
    mask_length frames each, which move together), one seed giving one
    mask twice; melhubert_forward(mask=True) with no mask on the card (the
    train phase's model and batch, f32); one draw timed against the host
    draw and its upload. Returns that forward's launches per dtype."""
    from speech_ssl_compression_tpu_torch.models.melhubert import (
        melhubert_forward,
    )
    from speech_ssl_compression_tpu_torch.ops.masking import (
        compute_mask_indices_np, compute_span_mask,
    )

    t0 = time.perf_counter()
    b, _, t, _ = TRAIN_SHAPE
    lengths_np = np.array(TRAIN_LENGTHS)
    lengths = torch.tensor(TRAIN_LENGTHS, device=dev)

    def draw(gen):
        return compute_span_mask(gen, lengths, t, **DEVICE_MASK)

    gen = torch.Generator(device=dev).manual_seed(0)
    masks = torch.stack([draw(gen) for _ in range(DEVICE_MASK_DRAWS)])
    past = int(masks[:, torch.arange(t, device=dev)[None, :]
                     >= lengths[:, None]].sum())
    rng = np.random.default_rng(0)
    host = np.stack([compute_mask_indices_np(
        (b, t), lengths_np, rng=rng, **DEVICE_MASK)
        for _ in range(DEVICE_MASK_DRAWS)])
    frames = DEVICE_MASK_DRAWS * int(lengths_np.sum())
    p_dev = float(masks.sum()) / frames
    p_host = float(host.sum()) / frames
    spans = frames / DEVICE_MASK["mask_length"]
    sigma = np.sqrt(2 * p_host * (1 - p_host) / spans)
    again = draw(torch.Generator(device=dev).manual_seed(0))
    twice = torch.equal(again, masks[0])
    log("device masks", f"{DEVICE_MASK_DRAWS} draws at B = {b}, T = {t} "
        f"(lengths {TRAIN_LENGTHS}), {DEVICE_MASK}: masked fraction "
        f"{p_dev:.5f} on the card, {p_host:.5f} on the host, |d| "
        f"{abs(p_dev - p_host) / sigma:.2f} sigma (bar {MASK_SIGMAS:g}); "
        f"True past a row's length: {past}; one seed one mask: {twice}, "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    if not (past == 0 and twice
            and abs(p_dev - p_host) < MASK_SIGMAS * sigma):
        raise AssertionError("the device sampler's masks are wrong")

    model = runner.model
    cfg = model.cfg
    pad = batch["pad_mask"]
    named = {k: v.detach() for k, v in runner.params.items()}
    reset_launch_counts()
    with torch.no_grad():
        out = torch.func.functional_call(
            model, named, (batch["feat"], pad),
            dict(mask=True, rng=torch.Generator().manual_seed(0)))
    torch.cuda.synchronize()
    launches = dtype_launch_counts()
    got = out["mask_indices"]
    n_valid = pad.sum(dim=1)
    inside = not bool((got & (pad == 0)).any())
    finite = bool(torch.isfinite(out["logits"].float()[pad > 0]).all())
    log("device masks", f"melhubert_forward(mask=True), no mask given, on "
        f"the card: mask {tuple(got.shape)} on {got.device}, masked "
        f"fraction {float(got.sum()) / float(n_valid.sum()):.4f}, inside "
        f"the rows {inside}, finite logits {finite}, flash_attn_fwd "
        f"launches {launches['flash_attn_fwd']}")
    if not (got.device == pad.device and inside and finite
            and got.any()):
        raise AssertionError("melhubert_forward's device mask")
    if launches["flash_attn_fwd"]["f32"] != cfg.encoder_layers:
        raise AssertionError(f"launches {launches['flash_attn_fwd']}")

    dev_ms = cuda_ms(lambda: draw(gen), reps=5)

    def host_draw():
        m = compute_mask_indices_np((b, t), lengths_np, rng=rng,
                                    **DEVICE_MASK)
        return torch.from_numpy(m).to(dev)

    host_draw()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t1 = time.perf_counter()
        host_draw()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    log("device masks", f"one draw: {dev_ms:.3f} ms on the card (CUDA "
        f"events), {statistics.median(walls):.3f} ms on the host with its "
        f"upload (wall, median of 5) [{gpu}]")
    return launches


WAVE_BENCH = (4, 245760)  # B x samples, train/wave_bench.py's defaults


def phase_wave_bench(dev, gpu: str):
    """One bf16 grad step of each model through
    train/wave_bench.py::make_wave_bench_grad_step at the recipe's shape
    (WAVE_BENCH, seeded weights, dropouts and the span mask on): finite
    gradients and every attention kernel once a layer. Returns {path:
    launches per dtype}."""
    from speech_ssl_compression_tpu_torch.train.wave_bench import (
        make_wave_bench_grad_step, wave_bench_setup,
    )

    b, t_wave = WAVE_BENCH
    paths = {}
    for name in ("hubert", "wav2vec2"):
        t0 = time.perf_counter()
        setup = wave_bench_setup(name, b=b, t_wave=t_wave, device=dev)
        step = make_wave_bench_grad_step(name, setup, torch.bfloat16)
        params = dict(setup["model"].named_parameters())
        t_setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        reset_launch_counts()
        grads = step(params, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        counts = dtype_launch_counts()
        wall = time.perf_counter() - t0
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        layers = setup["cfg"].encoder_layers
        attn = {k: v["bf16"] for k, v in counts.items()
                if k.startswith("flash")}
        log("wave_bench", f"{name}: B = {b} x {t_wave} samples "
            f"({setup['t_frames']} frames), setup {t_setup:.2f} s; one bf16 "
            f"grad step {wall:.2f} s (its first), finite gradients {finite}, "
            f"attention launches {attn} (expected {layers} each) [{gpu}]")
        if not finite or set(attn.values()) != {layers}:
            raise AssertionError(f"the {name} bench step")
        paths[f"{name} wave bench"] = counts
        del setup, step, params, grads
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def phase_train_timing(runner, batch, gpu: str):
    """CUDA-event medians: the grad step with the kernels and with
    impl="dense" (f32 and bf16, TF32 at PyTorch's defaults), one full bf16
    update, and the backward kernels against the plain backward at the
    training shape. Returns the backward kernels' timing record."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.steps import (
        accumulate_grads, make_melhubert_grad_step,
    )

    accum = runner.accum_steps
    frames = int(batch["length"].sum())
    for dtype in (torch.float32, torch.bfloat16):
        steps = {impl: make_melhubert_grad_step(
            runner.model, accum_steps=accum, compute_dtype=dtype,
            attn_impl=impl) for impl in ("auto", "dense")}

        def run(impl):
            return lambda: steps[impl](runner.params, batch, runner.rng)

        kernel_ms, dense_ms = alternate(run("auto"), run("dense"), reps=1,
                                        turns=1)
        log("timing", f"grad step B=4 T=768 {dtype}: kernels {kernel_ms:.2f} "
            f"ms, impl='dense' {dense_ms:.2f} ms ({frames} frames; "
            f"{frames / kernel_ms * 1e3:.0f} and {frames / dense_ms * 1e3:.0f} "
            f"frames/s) [{gpu}]")

    step = make_melhubert_grad_step(runner.model, accum_steps=accum,
                                    compute_dtype=runner.compute_dtype)

    def update():
        acc = None
        for _ in range(accum):
            _, grads, _ = step(runner.params, batch, runner.rng)
            acc = accumulate_grads(acc, grads)
        runner.apply(acc, float(accum))

    ms = cuda_ms(update, reps=1)
    log("timing", f"one update ({accum} micro-batches + apply, bf16): "
        f"{ms:.2f} ms, {1e3 / ms:.3f} updates/s, "
        f"{accum * frames / ms * 1e3:.0f} frames/s [{gpu}]")

    gen = torch.Generator(device=batch["feat"].device).manual_seed(3)
    masks = dict(key_padding_mask=train_padding(gen.device),
                 dropout_p=DROPOUT_P, dropout_seed=DROPOUT_SEED)
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, dout = (torch.randn(TRAIN_SHAPE, generator=gen,
                                     device=gen.device).to(dtype)
                         for _ in range(4))
        _, lse = fa.flash_attention(q, k, v, return_lse=True, **masks)
        args = fa.backward_args(q, k, v, lse, dout, **masks)
        tag = "f32" if dtype == torch.float32 else "bf16"
        backward_timing(args, "training_dropout", tag, record, gpu)
    return record


def fixed_span_mask(runner, batch, seed: int = 0):
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask

    t = batch["feat"].shape[1]
    return torch.from_numpy(span_mask(runner.cfg, batch["length"], t,
                                      np.random.default_rng(seed))).to(
                                          batch["feat"].device)


def one_update(runner, batch, mask):
    """One update from the runner's state: a bf16 grad step with dropout
    off on a fixed batch and span mask, then the fused apply."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    step = make_melhubert_grad_step(runner.model,
                                    compute_dtype=runner.compute_dtype,
                                    deterministic=True)
    loss, grads, _ = step(runner.params, batch, torch.Generator(),
                          mask_indices=mask, masks=runner.masks)
    runner.apply(grads, 1.0)
    torch.cuda.synchronize()
    return float(loss)


def same_state(a, b) -> bool:
    """Params and Adam state of two runners equal bitwise."""
    return (all(torch.equal(a.params[k], b.params[k]) for k in a.params)
            and all(map(torch.equal, a.opt_state, b.opt_state)))


def phase_resume(dev, gpu: str, tmp: str, runner, snapshot, batch):
    """A trainer resumed from the train phase's last-step.npz against the
    train phase's runner, its state put back as it was when it wrote the
    file: the state read back bitwise, then one update on each."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml
    from speech_ssl_compression_tpu_torch.train.__main__ import get_args
    from speech_ssl_compression_tpu_torch.train.runner import Runner
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        load_checkpoint, tree_leaves,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        jax_tree_from_named,
    )

    t0 = time.perf_counter()
    root = pathlib.Path(tmp) / "train"
    ckpt = str(root / "exp" / "last-step.npz")
    args = get_args(["-m", "melhubert", "-g", str(CONFIG_YAML), "-c",
                     str(root / "config_runner.yaml"), "-n",
                     str(pathlib.Path(tmp) / "resume"), "-i", ckpt,
                     "--init_optimizer_from_initial_weight", "--device",
                     "cuda", "--seed", "0"])
    resumed = Runner(args, read_yaml(args.runner_config),
                     read_yaml(args.upstream_config))
    state = load_checkpoint(ckpt)
    params_equal = all(
        np.array_equal(a, b) for a, b in zip(
            tree_leaves(jax_tree_from_named(resumed.params)),
            tree_leaves(state["params"])))
    opt_equal = all(np.array_equal(a, b) for a, b in zip(
        resumed._opt_leaves(), state["opt_leaves"]))
    count = int(resumed.opt_state[0])
    log("resume", f"-i last-step.npz --init_optimizer_from_initial_weight: "
        f"{len(resumed.params)} params on the card equal to the file's "
        f"bitwise: {params_equal}; Adam count {count} and "
        f"{len(state['opt_leaves']) - 1} moments equal: {opt_equal}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (params_equal and opt_equal and count == 3
            and len(state["opt_leaves"]) == len(resumed.opt_state)):
        raise AssertionError("the resumed state differs from the file")

    t0 = time.perf_counter()
    for p, saved in zip(runner.params.values(), snapshot[0]):
        p.data.copy_(saved)
    for s, saved in zip(runner.opt_state, snapshot[1]):
        s.copy_(saved)
    mask = fixed_span_mask(runner, batch)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = same_state(runner, resumed)
        losses = [one_update(r, batch, mask) for r in (runner, resumed)]
        after = same_state(runner, resumed)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("resume", f"in memory and resumed equal before the update: {before}; "
        f"one update (bf16, dropout off, fixed batch and span mask) from "
        f"each: loss {losses[0]!r} and {losses[1]!r}, params and Adam state "
        f"bitwise equal after: {after}, {time.perf_counter() - t0:.2f} s "
        f"[{gpu}]")
    if not (before and after and losses[0] == losses[1]):
        raise AssertionError("one update from the resumed state differs")


def yaml_scalar(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float):  # a float YAML reads back as one: 1.0e-05
        mantissa, e, exp = repr(value).partition("e")
        return (mantissa if "." in mantissa else mantissa + ".0") + e + exp
    return str(value)


def to_yaml(tree: dict, indent: int = 0) -> str:
    """Nested mappings of scalars and lists of scalars as the block YAML
    configs.read_yaml reads."""
    pad, lines = " " * indent, []
    for key, value in tree.items():
        if isinstance(value, dict):
            lines += [f"{pad}{key}:", to_yaml(value, indent + 2)]
        elif isinstance(value, list):
            lines += [f"{pad}{key}:"] + [f"{pad}- {yaml_scalar(v)}"
                                         for v in value]
        else:
            lines.append(f"{pad}{key}: {yaml_scalar(value)}")
    return "\n".join(lines)


def weight_prune_config(csv: str) -> dict:
    """configs/weight_pruning/config_runner_20ms.yaml for the weight prune
    phase: its prune: section with WP_SHORT, its sparsity ladder cut to
    n_iters entries, WP_STEPS updates of 8 micro-batches, a log line per
    update, the synthetic set."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    cfg = read_yaml(WP_RUNNER_YAML)
    cfg["prune"].update(WP_SHORT)
    cfg["prune"]["sparsity"] = cfg["prune"]["sparsity"][:WP_SHORT["n_iters"]]
    cfg["runner"].update(total_steps=WP_STEPS, gradient_accumulate_steps=8,
                         log_step=1)
    cfg["datarc"]["sets"] = [csv]
    return cfg


def prune_event_files(expdir: pathlib.Path, sparsity) -> list:
    """The before-pruning artifacts of the WP_SHORT events, by step, and
    last-step.npz: the masks each event gave are in the next file."""
    names = []
    for i in range(WP_SHORT["n_iters"]):
        step = WP_SHORT["warnup"] + i * WP_SHORT["period"]
        cur = 0 if i == 0 else sparsity[i - 1]
        names.append(f"{'mask-' if i else ''}before-pruning-states-{step}-"
                     f"sparsity-{cur}.npz")
    return [expdir / n for n in names] + [expdir / "last-step.npz"]


def read_prune_state(path: pathlib.Path):
    """(prunable params, masks, Step, Adam count) of a weight-pruning
    checkpoint, the prunable leaves read alone (a fifth of the file)."""
    from speech_ssl_compression_tpu_torch.compress.weight_pruning import (
        PRUNABLE,
    )

    layers, masks = collections.defaultdict(dict), {}
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(data["meta_json"].tobytes().decode())
        count = int(data["opt/0"])
        for key in data.files:
            parts = key.split("/")
            if key.startswith("params/encoder/layers/") and (
                    parts[4] in PRUNABLE):
                layers[int(parts[3][1:-1])].setdefault(
                    parts[4], {})[parts[5]] = data[key]
            elif key.startswith("masks/"):
                masks.setdefault(parts[1], {}).setdefault(
                    parts[2], {})[parts[3]] = data[key]
    params = {"encoder": {"layers": [layers[i] for i in sorted(layers)]}}
    return params, masks, meta, count


def phase_weight_prune(dev, gpu: str, tmp: str):
    """-m weight-pruning from the train phase's checkpoint through the
    trainer's entry point, then the checks on its events, masks, gradients
    and artifacts. Returns the launch counts of the run per dtype."""
    from speech_ssl_compression_tpu_torch.compress import weight_pruning as wp
    from speech_ssl_compression_tpu_torch.extract import (
        MelHuBERTExtractor, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        accumulate_grads, make_melhubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        save_checkpoint, tree_leaves,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        jax_tree_from_named,
    )

    t0 = time.perf_counter()
    train_root = pathlib.Path(tmp) / "train"
    root = pathlib.Path(tmp) / "weight_prune"
    root.mkdir()
    cfg = weight_prune_config(str(train_root / "data" / "train.csv"))
    sparsity = cfg["prune"]["sparsity"]
    runner_yaml = root / "config_runner.yaml"
    runner_yaml.write_text(to_yaml(cfg) + "\n")
    expdir = root / "exp"
    reset_launch_counts()
    runner = train(["-m", "weight-pruning", "-g", str(WP_MODEL_YAML), "-c",
                    str(runner_yaml), "-n", str(expdir), "-i",
                    str(train_root / "exp" / "last-step.npz"), "--device",
                    "cuda", "--seed", "0"])
    torch.cuda.synchronize()
    counts = dict(fa.launch_counts)
    by_dtype = dtype_launch_counts()
    n_layers = runner.cfg.encoder_layers
    micro = WP_STEPS * runner.accum_steps
    log("weight prune", f"-m weight-pruning -i last-step.npz, "
        f"{runner.compute_dtype}, {WP_STEPS} updates x {runner.accum_steps} "
        f"micro-batches, prune steps {list(map(int, runner.prune_steps))} at "
        f"sparsity {sparsity}: launches per micro-batch "
        f"{ {k: v / micro for k, v in counts.items()} } (expected {n_layers} "
        f"each), {time.perf_counter() - t0:.2f} s")
    for i, e in enumerate(runner.prune_event_log):
        log("timing", f"prune event {i + 1} at step {e['step']} on the host "
            f"(fold, the masks of ~85 M entries by global_magnitude_prune, to "
            f"the card): {e['seconds']:.3f} s [{gpu}]")
    if any(v != n_layers * micro for v in counts.values()):
        raise AssertionError(f"launch counts {counts}, want "
                             f"{n_layers * micro} each")
    if not (runner.compute_dtype == torch.bfloat16
            and runner.wp_state.pruning_times == WP_SHORT["n_iters"]
            and len(runner.log_history) == WP_STEPS):
        raise AssertionError(f"weight-pruning run: {runner.wp_state}, log "
                             f"{runner.log_history}")

    # each event from its artifacts: fired after exactly `step` updates, its
    # masks (in the next file) a host recompute on the folded weights
    t0 = time.perf_counter()
    files = prune_event_files(expdir, sparsity)
    states = [read_prune_state(f) for f in files]
    for i, (before, after) in enumerate(zip(states, states[1:])):
        step = WP_SHORT["warnup"] + i * WP_SHORT["period"]
        params, old, meta, updates = before
        want = wp.global_magnitude_prune(wp.fold_masks(params, old),
                                         sparsity[i])
        got = tree_leaves(after[1])
        same = all(np.array_equal(a, b)
                   for a, b in zip(got, tree_leaves(want)))
        n = sum(m.size for m in got)
        masked = n - sum(int(np.count_nonzero(m)) for m in got)
        log("weight prune", f"event {i + 1} ({files[i].name}): Step "
            f"{meta['Step']}, after {updates} updates; {masked} of {n} "
            f"prunable entries masked (round(amount n) = "
            f"{round(sparsity[i] * n)}); masks equal to the host recompute "
            f"on the folded weights: {same}")
        if not (same and masked == round(sparsity[i] * n) and updates == step
                and meta["Step"] == step):
            raise AssertionError(f"prune event {i + 1} is wrong")
    last = states[-1][2]
    log("weight prune", f"artifacts {[f.name for f in files]}; "
        f"last-step.npz: TotalStep {last.get('TotalStep')}, Pruning "
        f"{last.get('Pruning')}, {time.perf_counter() - t0:.2f} s")
    if not (last.get("TotalStep") == WP_STEPS and states[-1][1]
            and last["Pruning"]["pruning_times"] == WP_SHORT["n_iters"]):
        raise AssertionError("last-step.npz lacks the pruning state")
    del states

    # the masked grad step: masked gradients exactly 0 (bf16), then the
    # kernels against impl="dense" in f32
    t0 = time.perf_counter()
    batch = runner._device_batch(runner._get_dataloader().get_batch(0))
    mask = fixed_span_mask(runner, batch)
    _, grads, _ = runner.grad_step(runner.params, batch, runner.rng,
                                   mask_indices=mask, masks=runner.masks)
    named = dict(zip(runner.params, grads))
    zero = all(bool((named[k][m == 0] == 0).all())
               for k, m in runner.masks.items())
    del grads, named
    results = {}
    for impl in ("auto", "dense"):
        step = make_melhubert_grad_step(runner.model, attn_impl=impl,
                                        deterministic=True)
        fa.reset_launch_counts()
        with matmul_precision("highest"):
            loss, grads, _ = step(runner.params, batch, torch.Generator(),
                                  mask_indices=mask, masks=runner.masks)
        torch.cuda.synchronize()
        results[impl] = (loss, grads, dict(fa.launch_counts))
    (loss_k, grads_k, counts_k), (loss_d, grads_d, counts_d) = (
        results["auto"], results["dense"])
    del results
    loss_rel = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    names = list(runner.params)
    errs = grad_errors(names, grads_k, grads_d)
    worst = int(np.argmax(errs))
    log("weight prune", f"masked grad step: every masked entry's gradient "
        f"exactly 0 (bf16): {zero}; kernels vs impl='dense' (f32, TF32 off, "
        f"dropout off, fixed span mask): loss rel {loss_rel:.3e}, worst of "
        f"{len(errs)} gradients rel L2 {errs[worst]:.3e} ({names[worst]}), "
        f"bar {GRAD_BAR:g}; launches {counts_k} and {counts_d}, "
        f"{time.perf_counter() - t0:.2f} s")
    del grads_k, grads_d
    if not (zero and loss_rel < GRAD_BAR and max(errs) < GRAD_BAR):
        raise AssertionError("the masked grad step is wrong")
    if set(counts_k.values()) != {n_layers} or any(counts_d.values()):
        raise AssertionError("the masked parity run took the wrong path")

    # serving the pruned checkpoint against the weights masked by hand
    t0 = time.perf_counter()
    hand = {k: p * runner.masks[k] if k in runner.masks else p
            for k, p in runner.params.items()}
    hand_ckpt = str(root / "masked_by_hand.npz")
    save_checkpoint(hand_ckpt, jax_tree_from_named(hand), meta={
        "Upstream_Config": {"melhubert": runner.cfg.to_dict()}})
    del hand
    wavs = synthetic_wavs(seed=0)
    outs = []
    for path in (str(expdir / "last-step.npz"), hand_ckpt):
        ext = MelHuBERTExtractor(path, fp=20, mean_std_npy_path=str(MEAN_STD),
                                 matmul_precision="highest", device=dev)
        out = ext.forward_packed(wavs)
        outs.append(out["hidden_states"] + [out["last_hidden_state"]])
        del ext
    lengths = torch.tensor(out["lengths"], device=dev)
    valid = (torch.arange(outs[0][0].shape[1], device=dev)[None, :]
             < lengths[:, None])
    finite = all(torch.isfinite(h.float()[valid]).all() for h in outs[0])
    err = max(rel_err(a, b, valid) for a, b in zip(*outs))
    log("weight prune", f"MelHuBERTExtractor on last-step.npz (masks "
        f"folded) vs the weights masked by hand, f32, all hidden states: "
        f"max|d|/mean|ref| {err:.3e} (bar {SLICE_BAR:g}), finite {finite}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (finite and err < SLICE_BAR):
        raise AssertionError("the pruned checkpoint serves wrong")

    # one update with the masks against one without (8 micro-batches + the
    # apply, bf16), in turns
    accum = runner.accum_steps

    def update(masks):
        def run():
            acc = None
            for _ in range(accum):
                _, grads, _ = runner.grad_step(runner.params, batch,
                                               runner.rng, masks=masks)
                acc = accumulate_grads(acc, grads)
            runner.apply(acc, float(accum))
        return run

    masked, plain = alternate(update(runner.masks), update(None), reps=1,
                              turns=1)
    b, t = batch["feat"].shape[:2]
    log("timing", f"one weight-pruning update ({accum} micro-batches + "
        f"apply, {runner.compute_dtype}, B={b} T={t}): with masks "
        f"{masked:.2f} ms, without {plain:.2f} ms, "
        f"{(masked / plain - 1) * 100:+.2f}% [{gpu}]")
    return by_dtype


def structured_prune_config(runner_yaml: pathlib.Path, csv: str,
                            **prune) -> dict:
    """A head or row runner YAML with its prune: section cut to
    STRUCTURED_SHORT and ``prune``, as many updates as events (the last
    event fires before the last update), a log line per update, ``csv``
    as the set."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    cfg = read_yaml(runner_yaml)
    cfg["prune"].update(STRUCTURED_SHORT, **prune)
    cfg["runner"].update(total_steps=cfg["prune"]["total_steps"], log_step=1)
    cfg["datarc"]["sets"] = [csv]
    return cfg


def run_trainer(mode: str, model_yaml, cfg: dict, root: pathlib.Path,
                start: str, name: str = "exp"):
    """``python -m speech_ssl_compression_tpu_torch.train -m <mode>`` from
    the checkpoint ``start`` with the runner config ``cfg``."""
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train

    runner_yaml = root / f"config_runner_{name}.yaml"
    runner_yaml.write_text(to_yaml(cfg) + "\n")
    return train(["-m", mode, "-g", str(model_yaml), "-c", str(runner_yaml),
                  "-n", str(root / name), "-i", start, "--device", "cuda",
                  "--seed", "0"])


def read_layers(path: pathlib.Path, modules) -> dict:
    """The encoder layers' ``modules`` of a checkpoint (JAX layout, numpy),
    read alone."""
    layers = collections.defaultdict(dict)
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            parts = key.split("/")
            if key.startswith("params/encoder/layers/") and (
                    parts[4] in modules):
                layers[int(parts[3][1:-1])].setdefault(
                    parts[4], {})[parts[5]] = data[key]
    return {"encoder": {"layers": [layers[i] for i in sorted(layers)]}}


def ragged_head_cases(dev, scored, updated):
    """The attention shapes of a head-pruning run at head counts H a layer
    holds, as (name, q shape, mask kwargs, valid query rows, valid keys,
    dtype): the f32 scoring pass (a stacked group of B = 32, the training
    lengths tiled, dropout 0.1) at each H in ``scored`` and the bf16
    updates (TRAIN_SHAPE with H heads, its key padding, dropout 0 and 0.1)
    at each H in ``updated``."""
    b, _, t, d = TRAIN_SHAPE
    cases = []
    for dtype, heads, reps, dropouts in (
            (torch.float32, scored, 32 // b, (DROPOUT_P,)),
            (torch.bfloat16, updated, 1, (0.0, DROPOUT_P))):
        lens = torch.tensor(TRAIN_LENGTHS * reps, device=dev)
        pad = torch.arange(t, device=dev)[None, :] >= lens[:, None]
        valid = torch.ones_like(pad)
        for h in heads:
            for p in dropouts:
                masks = dict(key_padding_mask=pad)
                if p:
                    masks.update(dropout_p=p, dropout_seed=DROPOUT_SEED)
                cases.append((f"heads_{h}_p{p:g}", (b * reps, h, t, d), masks,
                              valid, ~pad, dtype))
    return cases


def check_event_memory(phase: str, runner) -> None:
    """Device memory around each structured prune event: the bytes the
    live tensors requested must fall by exactly the params and Adam
    moments pruned away (12 bytes a parameter), give or take 1 MiB; a
    handle on the old model, its Adam state or its gradients would hold
    hundreds of MB more. memory_allocated is printed beside it: it counts
    whole allocator blocks, and a sliced tensor may take the freed block
    of its larger predecessor."""
    for i, e in enumerate(runner.prune_event_log):
        (n_old, n_new) = e["params"]
        (alloc_before, before), (alloc_after, after) = e["memory"]
        want = 12 * (n_old - n_new)
        log(phase, f"event {i + 1} at step {e['step']}: scoring "
            f"{e['score_seconds']:.3f} s, slicing and rebuild "
            f"{e['slice_seconds']:.3f} s on the host; params {n_old} -> "
            f"{n_new}; live tensors' requested bytes {before} -> {after} "
            f"(fell {before - after}, params and Adam moments pruned away "
            f"{want}); memory_allocated {alloc_before} -> {alloc_after}")
        if not abs(before - after - want) < 2**20:
            raise AssertionError(f"event {i + 1} left {before - after - want}"
                                 " bytes astray: a stale handle on the old "
                                 "model?")


def additivity_error(dev, path: pathlib.Path, zero, prune) -> float:
    """The model of checkpoint ``path`` sliced by ``prune(named, cfg) ->
    (named, cfg)`` against the unsliced one with the pruned units zeroed
    by ``zero(model)``: max |d| / mean |ref| over every hidden state and
    the logits of a fixed batch (f32, TF32 off, dropout off)."""
    from speech_ssl_compression_tpu_torch.extract import (
        load_any_checkpoint, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import (
        melhubert_forward,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        load_model, model_from_named,
    )

    params, cfg, _ = load_any_checkpoint(str(path))
    full = load_model(params, cfg).to(dev).requires_grad_(False)
    sliced = model_from_named(*prune(dict(full.named_parameters()), cfg))
    with torch.no_grad():
        zero(full)
    rng = np.random.default_rng(0)
    lengths = np.array([768, 700, 512, 301])
    feat = torch.from_numpy(rng.standard_normal((4, 768, 80)).astype(
        np.float32)).to(dev)
    pad = torch.from_numpy((np.arange(768)[None, :] < lengths[:, None])
                           .astype(np.float32)).to(dev)
    valid = pad.bool()
    with matmul_precision("highest"), torch.no_grad():
        outs = [melhubert_forward(m, feat, pad, get_hidden=True)
                for m in (sliced, full)]
    got, ref = ([o["pre_feat"], *o["layer_hiddens"], o["hidden"],
                 o["logits"]] for o in outs)
    return max(rel_err(a, b, valid) for a, b in zip(got, ref))


def serve_against_memory(dev, path: pathlib.Path, model, wavs) -> float:
    """MelHuBERTExtractor.forward_packed (f32) on checkpoint ``path``
    against the same extractor running the trainer's in-memory ``model``:
    max |d| / mean |ref| over every hidden state."""
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor

    ext = MelHuBERTExtractor(str(path), fp=20,
                             mean_std_npy_path=str(MEAN_STD),
                             matmul_precision="highest", device=dev)
    outs = [ext.forward_packed(wavs)]
    ext.model = model
    outs.append(ext.forward_packed(wavs))
    lengths = torch.tensor(outs[0]["lengths"], device=dev)
    valid = (torch.arange(outs[0]["last_hidden_state"].shape[1],
                          device=dev)[None, :] < lengths[:, None])
    got, ref = (o["hidden_states"] + [o["last_hidden_state"]] for o in outs)
    if not all(torch.isfinite(h.float()[valid]).all() for h in got):
        raise AssertionError(f"{path.name} serves non-finite features")
    return max(rel_err(a, b, valid) for a, b in zip(got, ref))


def phase_head_prune(dev, gpu: str, tmp: str):
    """-m head-pruning, data-driven and by_whole, from the train phase's
    checkpoint through the trainer's entry point, full width, to one head
    a layer; then the checks on its events, its scoring pass, its slicing
    and its artifacts, and a short l1 by_layer run. Returns the launch
    counts of the data-driven run per dtype and its last checkpoint."""
    from speech_ssl_compression_tpu_torch.compress import head_pruning as hp
    from speech_ssl_compression_tpu_torch.extract import (
        load_any_checkpoint, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.runner import _stack_buckets
    from speech_ssl_compression_tpu_torch.utils.weights import load_model

    t_phase = t0 = time.perf_counter()
    start = str(pathlib.Path(tmp) / "train" / "exp" / "last-step.npz")
    root = pathlib.Path(tmp) / "head_prune"
    csv = write_dataset(root / "data", n_utts=HP_UTTS, seed=1)
    cfg = structured_prune_config(HP_DIR / "data_driven" /
                                  "config_runner_20ms.yaml", csv,
                                  total_steps=HP_EVENTS,
                                  num_heads_each_step=HP_HEADS,
                                  data_ratio=HP_DATA_RATIO)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    runner = run_trainer("head-pruning", HP_DIR / "data_driven" /
                         "config_model_20ms.yaml", cfg, root, start)
    torch.cuda.synchronize()
    counts = dtype_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_layers = runner.cfg.encoder_layers
    heads = runner.cfg.encoder_attention_heads
    expdir = root / "exp"
    log("head prune", f"-m head-pruning (data-driven, by_whole) -i "
        f"last-step.npz, {runner.compute_dtype} updates, f32 scoring over "
        f"{HP_UTTS // 4} buckets in {HP_GROUPS} stacked groups of B = 32, "
        f"{HP_EVENTS} events at steps {runner.prune_steps}: heads per layer "
        f"{heads}; launches {counts}; peak memory_allocated {peak} B; "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    heads_each = cfg["prune"]["num_heads_each_step"]
    left = [sum(heads) + heads_each * (HP_EVENTS - i)
            for i in range(HP_EVENTS + 1)]  # heads before each event
    scoring = HP_EVENTS * HP_GROUPS
    want = {"flash_attn_fwd": {"f32": scoring * n_layers,
                               "bf16": HP_EVENTS * n_layers}}
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        # the first layer's context lies past its attention
        want[name] = {"f32": scoring * (n_layers - 1),
                      "bf16": HP_EVENTS * n_layers}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    if not (heads == (1,) * n_layers
            and len(runner.pruned_heads) == HP_EVENTS
            and len(runner.log_history) == HP_EVENTS
            and np.isfinite([e["loss"] for e in runner.log_history]).all()):
        raise AssertionError(f"head-pruning run: heads {heads}, "
                             f"{runner.pruned_heads}, {runner.log_history}")
    check_event_memory("head prune", runner)

    # the attention kernels against their plain versions at the shapes the
    # run gave them (each head count has its own TMA maps): f32 where it
    # scores, at every count from 12 to 1 a layer can hold whichever the
    # run's events held, and bf16 at every count the run updated at
    t0 = time.perf_counter()
    held = [[left[0] // n_layers] * n_layers]
    for group in runner.pruned_heads:
        held.append([h - len(group.get(l, ()))
                     for l, h in enumerate(held[-1])])
    scored = list(range(1, left[0] // n_layers + 1))
    updated = sorted({h for hs in held[1:] for h in hs})
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, qs, masks, valid_q, valid_k, dtype in ragged_head_cases(
            dev, scored, updated):
        check_forward(fa, name, qs, qs, masks, valid_q, dtype, gen,
                      straddles=True)
        check_backward(fa, name, qs, qs, masks, valid_q, valid_k, dtype, gen)
    log("head prune", f"attention fwd, dQ and dK/dV kernels vs plain at the "
        f"scoring pass's shape, f32 (B = 32, dropout {DROPOUT_P:g}) at H = "
        f"{scored} (the run scored at "
        f"{sorted({h for hs in held[:-1] for h in hs})}), and at the "
        f"run's, bf16 (B = {TRAIN_SHAPE[0]}, dropout 0 and {DROPOUT_P:g}) "
        f"at H = {updated}, each within the bars of the kernels and backward"
        f" phases (bf16 forward: straddles explained as in the serving case)"
        f"; {time.perf_counter() - t0:.2f} s")

    # each event's heads: a host recompute of the selection on the scores
    # it wrote
    t0 = time.perf_counter()
    for i, group in enumerate(runner.pruned_heads):
        rows = np.load(expdir / f"heads_and_score_{left[i]}.npy")
        scores = [((int(l), int(h)), float(s)) for l, h, s in rows]
        again = hp.select_heads_to_prune(scores, heads_each, "by_whole",
                                         n_layers)
        if again != group:
            raise AssertionError(f"event {i + 1}: {group}, recomputed "
                                 f"{again}")
    log("head prune", f"the {HP_EVENTS} events' heads equal to a host "
        f"recompute of select_heads_to_prune on heads_and_score_*.npy; "
        f"artifacts states_prune_{left[0]} ... states_prune_{left[-1]}.npz, "
        f"{time.perf_counter() - t0:.2f} s")

    # the scoring pass, kernels against impl="dense": a stacked group of
    # B = 32 at 12 heads a layer (the first event) and at the ragged heads
    # of the 2nd
    t0 = time.perf_counter()
    dataset = runner._get_dataloader()
    stacked = _stack_buckets([dataset.get_batch(i) for i in range(8)])
    batch = runner._device_batch(stacked)
    b, t = batch["feat"].shape[:2]
    for path in (expdir / f"states_prune_{left[0]}.npz",
                 expdir / f"states_prune_{left[1]}.npz"):
        params, ckpt_cfg, _ = load_any_checkpoint(str(path))
        model = load_model(params, ckpt_cfg).to(dev)
        named = dict(model.named_parameters())
        mask = torch.from_numpy(span_mask(ckpt_cfg, stacked["length"], t,
                                          np.random.default_rng(0))).to(dev)
        scores, launched, grown = {}, {}, {}
        for impl in ("auto", "dense"):
            reset_launch_counts()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            ts = time.perf_counter()
            with matmul_precision("highest"):
                _, scores[impl] = hp.context_scores(
                    model, named, batch, mask, torch.Generator(),
                    deterministic=True, attn_impl=impl)
            torch.cuda.synchronize()
            grown[impl] = (torch.cuda.max_memory_allocated(dev) - base,
                           time.perf_counter() - ts)
            launched[impl] = dict(fa.launch_counts)
        errs = [float(torch.linalg.vector_norm(a.double() - r.double())
                      / torch.linalg.vector_norm(r.double()))
                for a, r in zip(scores["auto"], scores["dense"])]
        log("head prune", f"scoring pass on {path.name} (heads "
            f"{ckpt_cfg.encoder_attention_heads}), B = {b}, T = {t}, f32, "
            f"TF32 off, dropout off, fixed span mask: kernels vs "
            f"impl='dense' per layer rel. L2 max {max(errs):.3e} (bar "
            f"{GRAD_BAR:g}); launches {launched['auto']}; peak memory above "
            f"the model {grown['auto'][0]} B with the kernels, "
            f"{grown['dense'][0]} B dense; {grown['auto'][1]:.3f} s and "
            f"{grown['dense'][1]:.3f} s [{gpu}]")
        if not max(errs) < GRAD_BAR:
            raise AssertionError("kernel head scores disagree with dense")
        if (launched["auto"]["flash_attn_bwd_dq"] != n_layers - 1
                or any(launched["dense"].values())):
            raise AssertionError("the scoring parity run took the wrong path")
        del model, named, scores
    del batch

    # the slicing: the additivity identity at the first and last events
    t0 = time.perf_counter()
    hd = runner.cfg.head_dim

    def zero_heads(group):
        def zero(model):
            for layer, gone in group.items():
                w = model.encoder.layers[int(layer)].self_attn.out_proj.weight
                for h in gone:
                    w[:, h * hd:(h + 1) * hd] = 0.0
        return zero

    errs = [additivity_error(
        dev, expdir / f"states_prune_{left[i]}.npz",
        zero_heads(runner.pruned_heads[i]),
        lambda named, c, g=runner.pruned_heads[i]: hp.prune_heads(named, c,
                                                                  g))
        for i in (0, HP_EVENTS - 1)]
    log("head prune", f"sliced forward vs unsliced with the pruned heads' "
        f"out_proj input columns zeroed (f32, TF32 off), events 1 and "
        f"{HP_EVENTS}: max|d|/mean|ref| {errs[0]:.3e}, {errs[1]:.3e} (bar "
        f"{SLICE_BAR:g}), {time.perf_counter() - t0:.2f} s")
    if not max(errs) < SLICE_BAR:
        raise AssertionError("the sliced heads break the additivity identity")

    t0 = time.perf_counter()
    final = expdir / f"states_prune_{left[-1]}.npz"
    err = serve_against_memory(dev, final, runner.model, synthetic_wavs(0))
    log("head prune", f"MelHuBERTExtractor.forward_packed on {final.name} "
        f"vs the in-memory model (f32): max|d|/mean|ref| {err:.3e} (bar "
        f"{SLICE_BAR:g}), {time.perf_counter() - t0:.2f} s")
    if not err < SLICE_BAR:
        raise AssertionError("the head-pruned checkpoint serves wrong")
    del runner

    # l1, by_layer: HP_L1_EVENTS events of one head a layer, each
    # recomputed on the host from the weights its artifact holds
    t0 = time.perf_counter()
    cfg = structured_prune_config(HP_DIR / "l1" / "config_runner_20ms.yaml",
                                  csv, total_steps=HP_L1_EVENTS)
    l1 = run_trainer("head-pruning", HP_DIR / "l1" / "config_model_20ms.yaml",
                     cfg, root, start, name="l1")
    per_layer = left[0] // n_layers  # the checkpoint's heads a layer
    for i, group in enumerate(l1.pruned_heads):
        n = n_layers * (per_layer - i)
        params = read_layers(root / "l1" / f"states_prune_{n}.npz",
                             ("q_proj", "k_proj", "v_proj"))
        scores = hp.l1_head_scores(
            params, l1.cfg.with_heads((per_layer - i,) * n_layers))
        written = np.load(root / "l1" / f"heads_and_score_{n}.npy")
        same = np.array_equal(written, np.array(
            [(l, h, s) for (l, h), s in scores], np.float64))
        again = hp.select_heads_to_prune(scores, n_layers, "by_layer",
                                         n_layers)
        if not (same and again == group):
            raise AssertionError(f"l1 event {i + 1}: {group}, recomputed "
                                 f"{again}, scores equal {same}")
    log("head prune", f"-m head-pruning (l1, by_layer), {HP_L1_EVENTS} "
        f"events: heads per layer {l1.cfg.encoder_attention_heads}; each "
        f"event's scores and heads equal to a host recompute on its "
        f"artifact; {time.perf_counter() - t0:.2f} s")
    if l1.cfg.encoder_attention_heads != (
            per_layer - HP_L1_EVENTS,) * n_layers:
        raise AssertionError("the l1 run pruned the wrong heads")
    del l1
    for path in list(expdir.glob("states_prune_*.npz")) + list(
            (root / "l1").glob("states_prune_*.npz")):
        if path != final:
            path.unlink()
    log("head prune", f"phase {time.perf_counter() - t_phase:.2f} s")
    return counts, final


def phase_row_prune(dev, gpu: str, tmp: str, one_head: pathlib.Path):
    """-m row-pruning from the train phase's checkpoint through the
    trainer's entry point, full width, to FFN 512; then the checks on its
    events, its slicing and its artifacts, and the serve batch's frames/s
    of the full, the one-head and the FFN-512 model. Returns the launch
    counts of the run per dtype."""
    from speech_ssl_compression_tpu_torch.compress import row_pruning as rp
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor

    t_phase = t0 = time.perf_counter()
    train_root = pathlib.Path(tmp) / "train"
    start = str(train_root / "exp" / "last-step.npz")
    root = pathlib.Path(tmp) / "row_prune"
    root.mkdir()
    cfg = structured_prune_config(RP_DIR / "config_runner_20ms.yaml",
                                  str(train_root / "data" / "train.csv"),
                                  total_steps=RP_EVENTS,
                                  num_rows_each_step=RP_ROWS)
    step = cfg["prune"]["num_rows_each_step"]
    reset_launch_counts()
    runner = run_trainer("row-pruning", RP_DIR / "config_model_20ms.yaml",
                         cfg, root, start)
    torch.cuda.synchronize()
    counts = dtype_launch_counts()
    n_layers = runner.cfg.encoder_layers
    ffn = runner.cfg.encoder_ffn_embed_dim
    log("row prune", f"-m row-pruning -i last-step.npz, "
        f"{runner.compute_dtype}, {RP_EVENTS} events of {step} rows at steps "
        f"{runner.prune_steps}: FFN widths {ffn}; launches {counts}; "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    want = {name: {"f32": 0, "bf16": RP_EVENTS * n_layers} for name in
            ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    if not (ffn == (512,) * n_layers
            and len(runner.prune_event_log) == RP_EVENTS
            and np.isfinite([e["loss"] for e in runner.log_history]).all()):
        raise AssertionError(f"row-pruning run: {ffn}, "
                             f"{runner.log_history}")
    check_event_memory("row prune", runner)

    t0 = time.perf_counter()
    expdir = root / "exp"
    left = [ffn[0] + step * (RP_EVENTS - i) for i in range(RP_EVENTS + 1)]
    for i, e in enumerate(runner.prune_event_log):
        layers = read_layers(expdir / f"states_prune_{left[i]}.npz",
                             ("fc1", "fc2"))["encoder"]["layers"]
        again = [rp.rows_to_keep(rp.ffn_row_scores(l), step) for l in layers]
        if not all(np.array_equal(a, k) for a, k in zip(again, e["kept"])):
            raise AssertionError(f"row event {i + 1} kept other rows than "
                                 "the host recompute")
    log("row prune", f"the {RP_EVENTS} events' rows equal to a host "
        f"recompute of ffn_row_scores on the artifact before each, "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()

    def zero_rows(kept):
        def zero(model):
            for layer, keep in zip(model.encoder.layers, kept):
                gone = torch.from_numpy(np.setdiff1d(
                    np.arange(layer.fc1.out_features), keep)).to(dev)
                layer.fc1.weight[gone] = 0.0
                layer.fc1.bias[gone] = 0.0
                layer.fc2.weight[:, gone] = 0.0
        return zero

    errs = []
    for i in (0, RP_EVENTS - 1):
        kept = runner.prune_event_log[i]["kept"]
        errs.append(additivity_error(
            dev, expdir / f"states_prune_{left[i]}.npz",
            zero_rows(kept),
            lambda named, c, k=kept: rp.prune_rows(named, c, k)))
    log("row prune", f"sliced forward vs unsliced with the pruned rows' fc1 "
        f"rows and fc2 columns zeroed (f32, TF32 off), events 1 and "
        f"{RP_EVENTS}: max|d|/mean|ref| {errs[0]:.3e}, {errs[1]:.3e} (bar "
        f"{SLICE_BAR:g}), {time.perf_counter() - t0:.2f} s")
    if not max(errs) < SLICE_BAR:
        raise AssertionError("the sliced rows break the additivity identity")

    t0 = time.perf_counter()
    final = expdir / f"states_prune_{ffn[0]}.npz"
    wavs = synthetic_wavs(0)
    err = serve_against_memory(dev, final, runner.model, wavs)
    log("row prune", f"MelHuBERTExtractor.forward_packed on {final.name} "
        f"vs the in-memory model (f32): max|d|/mean|ref| {err:.3e} (bar "
        f"{SLICE_BAR:g}), {time.perf_counter() - t0:.2f} s")
    if not err < SLICE_BAR:
        raise AssertionError("the row-pruned checkpoint serves wrong")
    del runner

    # what the compression is for: the serve batch's frames/s (from
    # features, the GPU path) of the three models, in turns
    frames = sum(SERVE_LENGTHS)
    models = {"full": pathlib.Path(start), "1 head a layer": one_head,
              "FFN 512": final}
    for dtype in (torch.float32, torch.bfloat16):
        exts = {k: MelHuBERTExtractor(str(p), fp=20, dtype=dtype,
                                      mean_std_npy_path=str(MEAN_STD),
                                      device=dev)
                for k, p in models.items()}
        feat = next(iter(exts.values())).featurize(wavs)
        ms = {k: [] for k in exts}
        for order in (list(exts), list(exts)[::-1]):
            for k in order:
                ms[k].append(cuda_ms(lambda: exts[k]._pack_and_dispatch(
                    *feat)))
        log("timing", f"serve batch from features, {dtype}, "
            + ", ".join(f"{k} ({exts[k].num_params()} params) "
                        f"{np.mean(v):.2f} ms ({v[0]:.2f}, {v[1]:.2f}), "
                        f"{frames / np.mean(v) * 1e3:.0f} frames/s"
                        for k, v in ms.items()) + f" [{gpu}]")
        del exts
    log("row prune", f"phase {time.perf_counter() - t_phase:.2f} s")
    return counts


def distill_configs(root: pathlib.Path, name: str, csv: str, steps: int,
                    **model) -> tuple:
    """configs/distillation/config_model_20ms.yaml with ``model``'s
    sections updated key by key (loss_param, student) and
    config_runner_20ms.yaml cut to ``steps`` updates on ``csv`` with a log
    line per update, written under ``root``. Returns (model YAML path,
    runner config)."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    cfg = read_yaml(DISTILL_DIR / "config_model_20ms.yaml")
    for section, changes in model.items():
        cfg[section].update(changes)
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"config_model_{name}.yaml"
    path.write_text(to_yaml(cfg) + "\n")
    rc = read_yaml(DISTILL_DIR / "config_runner_20ms.yaml")
    rc["runner"].update(n_epochs=0, total_steps=steps, log_step=1)
    rc["datarc"]["sets"] = [csv]
    return path, rc


def check_distill_run(phase: str, runner, counts, updates: int,
                      t0: float, gpu: str) -> None:
    """A distillation run's launches (per micro-batch, each teacher layer
    one bf16 forward, each student layer a forward, a dQ and a dK/dV) and
    its log lines."""
    cfg, tcfg = runner.cfg, runner.teacher_cfg
    micro = updates * runner.accum_steps
    log(phase, f"teacher {tcfg.encoder_layers}L/{tcfg.encoder_embed_dim}, "
        f"heads {set(tcfg.encoder_attention_heads)} a layer -> student "
        f"{cfg.encoder_layers}L/{cfg.encoder_embed_dim}, "
        f"{runner.compute_dtype}, loss {runner.loss_type} T = "
        f"{runner.loss_temp:g} alpha = {runner.loss_alpha:g}, {updates} "
        f"updates x {runner.accum_steps} micro-batches: launches {counts} "
        f"({ {k: v['bf16'] / micro for k, v in counts.items()} } per "
        f"micro-batch); losses "
        f"{[round(e['loss'], 6) for e in runner.log_history]}; "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    per = {"flash_attn_fwd": tcfg.encoder_layers + cfg.encoder_layers,
           "flash_attn_bwd_dq": cfg.encoder_layers,
           "flash_attn_bwd_dkv": cfg.encoder_layers}
    want = {k: {"f32": 0, "bf16": n * micro} for k, n in per.items()}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    hist = runner.log_history
    if [e["step"] for e in hist] != list(range(1, updates + 1)) or not all(
            np.isfinite([e["loss"], e["grad_norm"]]).all() for e in hist):
        raise AssertionError(f"trainer log {hist}")


def phase_distill(dev, gpu: str, tmp: str, one_head: pathlib.Path,
                  profile: bool = False):
    """-m distillation through the trainer's entry point, full width: A, the
    shipped recipe, from the train phase's checkpoint; B, masked with the
    student copied from the teacher; C, from the head prune phase's
    one-head checkpoint; then the checks on the teacher, the copy, the
    kernels, the checkpoint, and the times and memory (with ``profile``,
    the device busy time of the micro-step and of its teacher forward).
    Returns the launch counts of A per dtype."""
    from speech_ssl_compression_tpu_torch.compress.distillation import (
        teacher_forward,
    )
    from speech_ssl_compression_tpu_torch.configs import read_yaml
    from speech_ssl_compression_tpu_torch.extract import (
        load_any_checkpoint, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.__main__ import get_args
    from speech_ssl_compression_tpu_torch.train.runner import Runner
    from speech_ssl_compression_tpu_torch.train.steps import (
        accumulate_grads, fused_apply, init_opt_state, make_distill_grad_step,
        make_melhubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_params_np, load_model,
    )

    t_phase = t0 = time.perf_counter()
    train_root = pathlib.Path(tmp) / "train"
    start = str(train_root / "exp" / "last-step.npz")
    csv = str(train_root / "data" / "train.csv")
    root = pathlib.Path(tmp) / "distill"

    # A: the shipped recipe (nomasked, T = 1, alpha = 1, a seeded student)
    model_yaml, rc = distill_configs(root, "a", csv, DISTILL_STEPS)
    reset_launch_counts()
    runner = run_trainer("distillation", model_yaml, rc, root, start, "a")
    torch.cuda.synchronize()
    counts = dtype_launch_counts()
    check_distill_run("distill", runner, counts, DISTILL_STEPS, t0, gpu)

    t0 = time.perf_counter()
    tparams, tcfg, _ = load_any_checkpoint(start)
    loaded = load_model(tparams, tcfg)
    del tparams
    untouched = all(torch.equal(p.cpu(), q) for p, q in zip(
        runner.teacher.parameters(), loaded.parameters()))
    no_grad = not any(p.requires_grad or p.grad is not None
                      for p in runner.teacher.parameters())
    del loaded
    final = root / "a" / "last-step.npz"
    _, ckpt_cfg, meta = load_any_checkpoint(str(final))
    err = serve_against_memory(dev, final, runner.model, synthetic_wavs(0))
    n_teacher = len(list(runner.teacher.parameters()))
    log("distill", f"after A the teacher's {n_teacher} "
        f"parameters bitwise as loaded: {untouched}, none requires or holds a "
        f"grad: {no_grad}; last-step.npz read back by load_any_checkpoint as "
        f"{ckpt_cfg.encoder_layers} layers (Step {meta['Step']}), served by "
        f"MelHuBERTExtractor.forward_packed against the in-memory student "
        f"(f32): max|d|/mean|ref| {err:.3e} (bar {SLICE_BAR:g}), "
        f"{time.perf_counter() - t0:.2f} s")
    if not (untouched and no_grad and ckpt_cfg.encoder_layers
            == runner.cfg.encoder_layers and meta["Step"] == DISTILL_STEPS
            and err < SLICE_BAR):
        raise AssertionError("run A's teacher or checkpoint is wrong")

    # B: masked, T = 2, alpha = 0.5, the student's pos-conv and first
    # layers copied from the teacher; checked before its first update
    t0 = time.perf_counter()
    model_yaml, rc = distill_configs(
        root, "b", csv, 1, loss_param=dict(type="masked", T=2, alpha=0.5),
        student=dict(initial_from_teacher=True))
    runner_yaml = root / "config_runner_b.yaml"
    runner_yaml.write_text(to_yaml(rc) + "\n")
    args = get_args(["-m", "distillation", "-g", str(model_yaml), "-c",
                     str(runner_yaml), "-n", str(root / "b"), "-i", start,
                     "--device", "cuda", "--seed", "0"])
    copy = Runner(args, read_yaml(args.runner_config),
                  read_yaml(args.upstream_config))
    fresh = dict(load_model(init_params_np(copy.cfg, 0), copy.cfg)
                 .named_parameters())
    teacher = dict(copy.teacher.named_parameters())
    copied = tuple(["encoder.pos_conv."] + [
        f"encoder.layers.{i}." for i in range(copy.cfg.encoder_layers)])
    n_copied = n_fresh = 0
    for name, p in copy.params.items():
        if name.startswith(copied):
            ok = (torch.equal(p, teacher[name])
                  and p.data_ptr() != teacher[name].data_ptr())
            n_copied += 1
        else:
            ok = torch.equal(p.detach().cpu(), fresh[name].detach())
            n_fresh += 1
        if not ok:
            raise AssertionError(f"B's student {name} is not as it should be")
    del fresh, teacher
    reset_launch_counts()
    copy.train()
    torch.cuda.synchronize()
    check_distill_run("distill", copy, dtype_launch_counts(), 1, t0, gpu)
    log("distill", f"B before its update: {n_copied} student tensors "
        f"(encoder.pos_conv.*, encoder.layers.0-"
        f"{copy.cfg.encoder_layers - 1}.*) bitwise the teacher's, not "
        f"shared; the other {n_fresh} bitwise a seeded fresh init")
    del copy

    # C: the one-head teacher, the shipped recipe, one update
    t0 = time.perf_counter()
    model_yaml, rc = distill_configs(root, "c", csv, 1)
    reset_launch_counts()
    one = run_trainer("distillation", model_yaml, rc, root, str(one_head), "c")
    torch.cuda.synchronize()
    check_distill_run("distill", one, dtype_launch_counts(), 1, t0, gpu)
    if one.teacher_cfg.encoder_attention_heads != (1,) * 12:
        raise AssertionError(f"C's teacher {one.teacher_cfg}")

    # the kernels at the shapes of this path: the teacher's forwards (12 and
    # 1 heads, no dropout), the student's (dropout), the student's backward
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, qs, masks, valid_q, valid_k, dtype in ragged_head_cases(
            dev, (), (1, TRAIN_SHAPE[1])):
        check_forward(fa, name, qs, qs, masks, valid_q, dtype, gen,
                      straddles=True)
        check_backward(fa, name, qs, qs, masks, valid_q, valid_k, dtype, gen)
    log("distill", f"attention fwd, dQ and dK/dV kernels vs plain at "
        f"(4, H, 768, 64) bf16, H = 1 and 12, dropout 0 and {DROPOUT_P:g}, "
        f"within the bars of the kernels and backward phases, "
        f"{time.perf_counter() - t0:.2f} s")

    # one distill grad step with the kernels against impl="dense": f32,
    # TF32 off, dropout off, at 12 teacher heads and at 1, nomasked and
    # masked with one fixed host mask
    t0 = time.perf_counter()
    batch = runner._device_batch(runner._get_dataloader().get_batch(0))
    t = batch["feat"].shape[1]
    names = list(runner.params)
    worst = 0.0
    for label, teacher_model in (("12 heads", runner.teacher),
                                 ("1 head", one.teacher)):
        for loss_type in ("nomasked", "masked"):
            mask = None
            if loss_type == "masked":  # drawn from the teacher's config
                mask = torch.from_numpy(span_mask(
                    teacher_model.cfg, batch["length"], t,
                    np.random.default_rng(0))).to(dev)
            out = {}
            for impl in ("auto", "dense"):
                step = make_distill_grad_step(
                    teacher_model, runner.model, temperature=2.0, alpha=0.5,
                    loss_type=loss_type, attn_impl=impl, deterministic=True)
                fa.reset_launch_counts()
                with matmul_precision("highest"):
                    out[impl] = step(runner.params, batch, torch.Generator(),
                                     mask_indices=mask)
                torch.cuda.synchronize()
                out[impl] += (dict(fa.launch_counts),)
                del step
            (loss_k, grads_k, logs_k, n_k), (loss_d, grads_d, logs_d, n_d) = (
                out["auto"], out["dense"])
            rels = {k: abs(float(a) - float(r)) / abs(float(r)) for k, a, r in
                    [("loss", loss_k, loss_d)] + [
                        (k, logs_k[k], logs_d[k]) for k in (
                            "hard_loss", "soft_loss", "teacher_loss")]}
            errs = grad_errors(names, grads_k, grads_d)
            i = int(np.argmax(errs))
            log("distill", f"grad step, teacher {label}, {loss_type}, "
                f"kernels vs impl='dense' (f32, TF32 off, dropout off): "
                f"{ {k: f'{v:.3e}' for k, v in rels.items()} } rel; worst of "
                f"{len(errs)} student gradients rel L2 {errs[i]:.3e} "
                f"({names[i]}), bar {GRAD_BAR:g}; launches {n_k}")
            worst = max(worst, errs[i], *rels.values())
            layers = (teacher_model.cfg.encoder_layers
                      + runner.cfg.encoder_layers)
            if not (max(errs) < GRAD_BAR and max(rels.values()) < GRAD_BAR):
                raise AssertionError("distill gradients disagree with dense")
            if n_k != {"flash_attn_fwd": layers,
                       "flash_attn_bwd_dq": runner.cfg.encoder_layers,
                       "flash_attn_bwd_dkv": runner.cfg.encoder_layers} or any(
                           n_d.values()):
                raise AssertionError("the parity run took the wrong path")
            del out, grads_k, grads_d
    log("distill", f"the four parity steps' worst rel. error {worst:.3e}, "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    del one

    # times and memory: the distill micro-step (bf16, dropout on) and one
    # update against the train phase's bf16 pretrain grad step and update,
    # in turns; the teacher's forward alone; the student's own pretrain
    # grad step; the grad step's peak and the teacher forward's footprint
    t0 = time.perf_counter()
    frames = int(batch["length"].sum())
    dtype = runner.compute_dtype
    params, cfg, _ = load_any_checkpoint(start)
    pretrain = load_model(params, cfg).to(dev)
    del params
    pretrain_step = make_melhubert_grad_step(
        pretrain, accum_steps=runner.accum_steps, compute_dtype=dtype)
    pretrain_params = dict(pretrain.named_parameters())
    pretrain_state = init_opt_state(list(pretrain_params.values()))

    def distill_micro():
        return runner.grad_step(runner.params, batch, runner.rng)

    def pretrain_micro():
        return pretrain_step(pretrain_params, batch, runner.rng)

    def update(micro, apply):
        acc = None
        for _ in range(runner.accum_steps):
            acc = accumulate_grads(acc, micro()[1])
        apply(acc)

    distill_ms, pretrain_ms = alternate(distill_micro, pretrain_micro,
                                        reps=1, turns=1)
    update_ms, pretrain_update_ms = alternate(
        lambda: update(distill_micro, lambda acc: runner.apply(
            acc, float(runner.accum_steps))),
        lambda: update(pretrain_micro, lambda acc: fused_apply(
            runner.optimizer, list(pretrain_params.values()),
            pretrain_state, acc, float(runner.accum_steps))), reps=1,
        turns=1)
    del pretrain, pretrain_step, pretrain_params, pretrain_state
    t_params = {k: v.detach().to(dtype)
                for k, v in runner.teacher.named_parameters()}
    feat = batch["feat"].to(dtype)
    teacher_ms = cuda_ms(lambda: teacher_forward(
        runner.teacher, feat, batch["pad_mask"], mask=False,
        params=t_params))
    student_step = make_melhubert_grad_step(
        runner.model, accum_steps=runner.accum_steps, compute_dtype=dtype)
    student_ms = cuda_ms(lambda: student_step(runner.params, batch,
                                              runner.rng))
    del student_step
    log("timing", f"distill micro-step B=4 T={t} {dtype} (the teacher's "
        f"forward + the student's grad step): {distill_ms:.2f} ms against the "
        f"train phase's pretrain grad step {pretrain_ms:.2f} ms in turns "
        f"({distill_ms / pretrain_ms:.3f}x); one update "
        f"({runner.accum_steps} micro-batches + apply) {update_ms:.2f} ms "
        f"against the pretrain update's {pretrain_update_ms:.2f} ms in turns "
        f"({update_ms / pretrain_update_ms:.3f}x), "
        f"{runner.accum_steps * frames / update_ms * 1e3:.0f} frames/s; the "
        f"teacher's forward alone {teacher_ms:.2f} ms; the 6-layer "
        f"student's own pretrain grad step {student_ms:.2f} ms; "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    if profile:
        profile_calls("distill micro-step (bf16)", distill_micro, gpu)
        profile_calls("its teacher forward (bf16)", lambda: teacher_forward(
            runner.teacher, feat, batch["pad_mask"], mask=False,
            params=t_params), gpu)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    runner.grad_step(runner.params, batch, runner.rng)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    before = runner._allocated()
    out = teacher_forward(runner.teacher, feat, batch["pad_mask"], mask=False,
                          params=t_params)
    torch.cuda.synchronize()
    after = runner._allocated()
    kept = after[1] - before[1]  # the bytes the live tensors requested
    logits = out["logits"].numel() * out["logits"].element_size()
    mask_bytes = out["mask_indices"].numel()
    log("distill", f"one distill grad step's peak above what was allocated "
        f"before it: {peak} B; across the teacher's forward memory_allocated "
        f"{before[0]} -> {after[0]} B, the live tensors' requested bytes "
        f"+{kept} B: its logits {tuple(out['logits'].shape)} "
        f"{out['logits'].dtype} {logits} B and mask_indices {mask_bytes} B")
    if not 0 <= kept - logits - mask_bytes < 2**16:
        raise AssertionError(f"the teacher's forward left {kept} B of live "
                             f"tensors, not its logits' {logits} B and its "
                             f"mask's {mask_bytes} B")
    del out, t_params, feat, batch, runner
    for path in root.glob("*/*.npz"):
        path.unlink()
    log("distill", f"phase {time.perf_counter() - t_phase:.2f} s")
    return counts


def long_launch_counts():
    """The attention kernels' launches with max(Tq, Tk) past the stream
    threshold (JAX's streamed kernels' calls), per input dtype, a copy."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    return {name: dict(c) for name, c in fa.long_launch_counts.items()}


def long_wav(seed: int) -> np.ndarray:
    """LONG_SAMPLES samples of 16 kHz tones and noise."""
    return tones_and_noise(np.random.default_rng(seed), LONG_SAMPLES)


def long_10ms_train(dev, gpu: str, tmp: str, root: pathlib.Path):
    """The 10 ms recipe through the trainer's entry point (one update of the
    shipped 8 micro-batches of B = 4 x T = 1500, bf16, dropout 0.1) on the
    train phase's set, then the checks on its model: the f32 grad step with
    the kernels against impl="dense", and the bf16 grad step with and
    without remat. Returns (runner, launch counts per dtype, those past the
    stream threshold)."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        accumulate_grads, make_melhubert_grad_step,
    )

    t0 = time.perf_counter()
    rc = read_yaml(TEN_MS_RUNNER_YAML)
    rc["runner"].update(n_epochs=0, total_steps=1, log_step=1)
    rc["datarc"].update(sets=[str(pathlib.Path(tmp) / "train" / "data" /
                                  "train.csv")], num_workers=1)
    runner_yaml = root / "config_runner_10ms.yaml"
    runner_yaml.write_text(to_yaml(rc) + "\n")
    reset_launch_counts()
    runner = train(["-m", "melhubert", "-f", "10", "-g",
                    str(TEN_MS_MODEL_YAML), "-c", str(runner_yaml), "-n",
                    str(root / "exp"), "--device", dev.type, "--seed", "0"])
    torch.cuda.synchronize()
    counts, long_counts = dtype_launch_counts(), long_launch_counts()
    cfg, accum = runner.cfg, runner.accum_steps
    batch = runner._device_batch(runner._get_dataloader().get_batch(0))
    b, t, f = batch["feat"].shape
    hist = runner.log_history
    log("long", f"-m melhubert -f 10 (config_{{model,runner}}_10ms.yaml): "
        f"{cfg.encoder_layers}L/{cfg.encoder_embed_dim}, {f}-d input, "
        f"{runner.compute_dtype}, dropout {cfg.dropout:g}, 1 update x "
        f"{accum} micro-batches of B = {b}, T = {t} (crops of "
        f"{int(batch['length'].max())}); launches {counts}; loss "
        f"{hist[-1]['loss']:.6f}, grad norm {hist[-1]['grad_norm']:.6f}; "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    tag = "bf16" if runner.compute_dtype == torch.bfloat16 else "f32"
    want = {k: {"f32": 0, "bf16": 0} for k in fa.launch_counts}
    for k in want:
        want[k][tag] = cfg.encoder_layers * accum
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"10 ms launch counts {counts}, want {want}")
    if (f, cfg.feat_emb_dim) != (40, 40) or int(batch["length"].max()) != (
            read_yaml(TEN_MS_MODEL_YAML)["task"]["sequence_length"]):
        raise AssertionError(f"10 ms batch {tuple(batch['feat'].shape)}")
    if [e["step"] for e in hist] != [1] or not np.isfinite(
            [hist[0]["loss"], hist[0]["grad_norm"]]).all():
        raise AssertionError(f"trainer log {hist}")

    # the f32 grad step with the kernels against impl="dense"
    t0 = time.perf_counter()
    mask = torch.from_numpy(span_mask(cfg, batch["length"], t,
                                      np.random.default_rng(0))).to(dev)
    results = {}
    for impl in ("auto", "dense"):
        step = make_melhubert_grad_step(runner.model, attn_impl=impl,
                                        deterministic=True)
        fa.reset_launch_counts()
        with matmul_precision("highest"):
            loss, grads, _ = step(runner.params, batch, torch.Generator(),
                                  mask_indices=mask)
        torch.cuda.synchronize()
        results[impl] = (loss, grads, dict(fa.launch_counts))
    (loss_k, grads_k, n_k), (loss_d, grads_d, n_d) = results.values()
    loss_rel = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    names = list(runner.params)
    errs = grad_errors(names, grads_k, grads_d)
    worst = int(np.argmax(errs))
    log("long", f"10 ms grad step B = {b}, T = {t}, kernels vs impl='dense' "
        f"(f32, TF32 off, dropout off, fixed span mask of mask_length "
        f"{cfg.mask_length}): loss rel {loss_rel:.3e}; worst of {len(errs)} "
        f"gradients rel L2 {errs[worst]:.3e} ({names[worst]}), bar "
        f"{GRAD_BAR:g}; launches {n_k} and {n_d}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (loss_rel < GRAD_BAR and max(errs) < GRAD_BAR):
        raise AssertionError("10 ms gradients disagree with the dense path")
    if set(n_k.values()) != {cfg.encoder_layers} or any(n_d.values()):
        raise AssertionError("the 10 ms parity run took the wrong path")
    del results, grads_k, grads_d

    # remat: the bf16 grad step (dropout on) with and without it, from the
    # same generators, cuDNN deterministic: bitwise gradients, peak memory,
    # the forwards the recompute adds, times
    t0 = time.perf_counter()
    frames = int(batch["length"].sum())
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    out, steps = {}, {}
    try:
        for remat in (False, True):
            steps[remat] = make_melhubert_grad_step(
                runner.model, compute_dtype=runner.compute_dtype,
                remat=remat)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            loss, grads, _ = steps[remat](runner.params, batch,
                                          torch.Generator().manual_seed(11),
                                          mask_indices=mask)
            torch.cuda.synchronize()
            out[remat] = (loss, grads, launch_counts(),
                          torch.cuda.max_memory_allocated(dev) - base)
        ms = {remat: cuda_ms(lambda s=s: s(
            runner.params, batch, torch.Generator().manual_seed(11),
            mask_indices=mask)) for remat, s in steps.items()}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            flags)
    (loss_a, grads_a, n_a, peak_a), (loss_b, grads_b, n_b, peak_b) = (
        out[False], out[True])
    bitwise = [bool(torch.equal(x, y)) for x, y in zip(grads_a, grads_b)]
    extra = {k: n_b[k] - n_a[k] for k in fa.launch_counts}
    log("long", f"remat, one {runner.compute_dtype} 10 ms grad step (B = "
        f"{b}, T = {t}, dropout {cfg.dropout:g}, the same generators): loss "
        f"{float(loss_a):.6f} off, {float(loss_b):.6f} on; {sum(bitwise)} of "
        f"{len(bitwise)} gradients bitwise equal; peak memory above the "
        f"model {peak_a} B off, {peak_b} B on ({peak_b / peak_a:.3f}x); the "
        f"recompute's launches {extra}; {time.perf_counter() - t0:.2f} s")
    if not (torch.equal(loss_a, loss_b) and all(bitwise)):
        raise AssertionError("remat changes the 10 ms gradients")
    if extra != {"flash_attn_fwd": cfg.encoder_layers, "flash_attn_bwd_dq": 0,
                 "flash_attn_bwd_dkv": 0} or not peak_b < peak_a:
        raise AssertionError("remat did not recompute the layers or saved "
                             "no memory")
    del out, grads_a, grads_b

    def update():
        acc = None
        for _ in range(accum):
            acc = accumulate_grads(acc, steps[False](
                runner.params, batch, runner.rng, mask_indices=mask)[1])
        runner.apply(acc, float(accum))

    update_ms = cuda_ms(update, reps=1, warm=False)
    log("timing", f"10 ms {runner.compute_dtype} grad step B = {b}, T = {t} "
        f"({frames} frames): remat off {ms[False]:.2f} ms "
        f"({frames / ms[False] * 1e3:.0f} frames/s), on {ms[True]:.2f} ms "
        f"({frames / ms[True] * 1e3:.0f} frames/s, {ms[True] / ms[False]:.3f}"
        f"x); one update ({accum} micro-batches + apply) {update_ms:.2f} ms, "
        f"{accum * frames / update_ms * 1e3:.0f} frames/s [{gpu}]")
    del steps
    return runner, counts, long_counts


def long_serve(dev, gpu: str, ckpt: str, refs: dict):
    """T = LONG_T extraction from the 10 ms checkpoint ``ckpt``: one
    utterance through MelHuBERTExtractor.forward in f32 (host featurizer)
    and bf16, and in f32 with featurizer="device", and the fp = 10 serve
    batch (bench.py's 16 utterances) through forward_packed, f32; then the
    kernel route against impl="dense" at full T, bf16 against f32, the
    device featurizer against the host's, and the rates. The f32
    device-featurizer output goes to ``refs["serve"]`` (on the host), the
    1-process yardstick of the parallel phase's sequence-parallel serving,
    and the f32 extractor's model (the checkpoint's) to
    ``refs["teacher"]``. Returns (launch counts per dtype, those past the
    stream threshold)."""
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    exts = {dtype: MelHuBERTExtractor(
        ckpt, fp=10, mean_std_npy_path=str(MEAN_STD), dtype=dtype,
        matmul_precision="highest", device=dev)
        for dtype in (torch.float32, torch.bfloat16)}
    ext = exts[torch.float32]
    n_layers = ext.cfg.encoder_layers
    wav, wavs = long_wav(1), synthetic_wavs(0)
    log("long", f"10 ms checkpoint served by two extractors (f32, bf16); "
        f"one utterance of {LONG_SAMPLES} samples "
        f"({LONG_SAMPLES / 16000:.2f} s), {time.perf_counter() - t0:.2f} s")

    # the main path: counts from exactly these forwards
    t0 = time.perf_counter()
    reset_launch_counts()
    out = ext.forward([wav])
    out_dev = ext.forward([wav], featurizer="device")
    out_bf16 = exts[torch.bfloat16].forward([wav])
    packed = ext.forward_packed(wavs)
    torch.cuda.synchronize()
    counts, long_counts = dtype_launch_counts(), long_launch_counts()
    t = out["last_hidden_state"].shape[1]
    log("long", f"forward f32 (host and device featurizer) and bf16 of one "
        f"utterance: lengths {out['lengths']}, {t} frames, hidden "
        f"{tuple(out['last_hidden_state'].shape)}; forward_packed f32 of "
        f"the fp = 10 serve batch ({len(wavs)} utterances, "
        f"{sum(packed['lengths'])} frames in {packed['n_packed_rows']} rows "
        f"of {packed['last_hidden_state'].shape[1]}); launches "
        f"{counts['flash_attn_fwd']}, past the stream threshold "
        f"{long_counts['flash_attn_fwd']}, {time.perf_counter() - t0:.2f} s")
    if out["lengths"] != [LONG_T]:
        raise AssertionError(f"{out['lengths']} frames, want [{LONG_T}]")
    if (counts["flash_attn_fwd"] != {"f32": 3 * n_layers, "bf16": n_layers}
            or long_counts["flash_attn_fwd"] != {"f32": 2 * n_layers,
                                                 "bf16": n_layers}):
        raise AssertionError(f"long serve launches {counts}, past the "
                             f"threshold {long_counts}")

    t0 = time.perf_counter()
    valid = torch.arange(t, device=dev)[None, :] < LONG_T
    states = lambda o: o["hidden_states"] + [o["last_hidden_state"]]
    if not all(torch.isfinite(s.float()[valid]).all()
               for o in (out, out_dev, out_bf16) for s in states(o)):
        raise AssertionError("non-finite long output")
    ext.attn_impl = "dense"
    ref = ext.forward([wav])
    ref_packed = ext.forward_packed(wavs)
    ext.attn_impl = "auto"
    torch.cuda.synchronize()
    err = max(rel_err(a, b, valid) for a, b in zip(states(out), states(ref)))
    err_bf16 = max(rel_l2(a, b, valid) for a, b in zip(states(out_bf16),
                                                       states(ref)))
    err_dev = max(rel_err(a, b, valid) for a, b in zip(states(out_dev),
                                                       states(out)))
    lengths = torch.tensor(packed["lengths"], device=dev)
    valid_p = (torch.arange(packed["last_hidden_state"].shape[1],
                            device=dev)[None, :] < lengths[:, None])
    err_packed = max(rel_err(a, b, valid_p) for a, b in zip(
        states(packed), states(ref_packed)))
    log("long", f"T = {t}, all hidden states: kernel vs impl='dense' (f32, "
        f"TF32 off) max|d|/mean|ref| {err:.3e} (bar {SLICE_BAR:g}); bf16 vs "
        f"f32 |d|_2/|ref|_2 {err_bf16:.3e} (bar {BF16_SLICE_BAR:g}); device "
        f"featurizer vs host max|d|/mean|ref| {err_dev:.3e} (bar "
        f"{WAVE_BAR:g}); the fp = 10 batch kernel vs impl='dense' "
        f"{err_packed:.3e} (bar {SLICE_BAR:g}), "
        f"{time.perf_counter() - t0:.2f} s")
    if not (err < SLICE_BAR and err_bf16 < BF16_SLICE_BAR
            and err_dev < WAVE_BAR and err_packed < SLICE_BAR):
        raise AssertionError("long serving disagrees")
    refs["serve"] = out_dev["last_hidden_state"].float().cpu()
    # the checkpoint's model, the teacher of the yardstick distill steps
    # (the 10 ms run's own model has taken a timed update since it wrote)
    refs["teacher"] = ext.model
    del ref, ref_packed, out, out_dev, out_bf16, packed

    # the first and last layers' attention calls of the f32 and bf16
    # forwards, as captured, against the plain version
    t0 = time.perf_counter()
    for dtype, e in exts.items():
        captured, undo = capture_attention("flash_attention")
        try:
            e.forward([wav])
        finally:
            undo()
        for i in (0, n_layers - 1):
            q, k, v, pad, _ = captured[i]
            check_forward(fa, f"long_serve_layer{i}", tuple(q.shape),
                          tuple(k.shape), dict(key_padding_mask=pad),
                          ~pad, dtype, None, straddles=True,
                          inputs=(q, k, v))
        del captured
    log("long", f"T = {LONG_T} serving's attention calls of layers 0 and "
        f"{n_layers - 1}, f32 and bf16, as captured: within the bars of "
        f"the kernels phase, {time.perf_counter() - t0:.2f} s")

    frames = int(lengths.sum())
    ms = {dtype: cuda_ms(lambda e=e: e.forward([wav], featurizer="device"))
          for dtype, e in exts.items()}
    batch_ms = cuda_ms(lambda: ext.forward_packed(wavs, featurizer="device"))
    log("timing", ", ".join(
        f"T = {LONG_T} from a waveform, device featurizer, {dtype}: "
        f"{m:.2f} ms, {LONG_T / m * 1e3:.0f} frames/s, "
        f"{LONG_SAMPLES / 16000 / m * 1e3:.1f}x realtime"
        for dtype, m in ms.items())
        + f"; the fp = 10 serve batch f32 {batch_ms:.2f} ms, "
        f"{frames / batch_ms * 1e3:.0f} frames/s [{gpu}]")
    return counts, long_counts


def long_kernels(dev, gpu: str, heads: int, record: dict) -> None:
    """The attention kernels at (1, heads, LONG_T, 64), the shape of the
    long paths, on random inputs: the forward against its plain version
    (f32 in float64, bf16 in its key tiles), the dQ and dK/dV kernels
    against the plain backward, f32 and bf16, and the times of each kernel
    and its plain version into record[kernel, "long_8192", tag]."""
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)
    shape = (1, heads, LONG_T, 64)
    rows = torch.ones((1, LONG_T), dtype=torch.bool, device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        # 8192 keys a row: a few p that straddle a bf16 rounding point can
        # move an entry past one ulp, as at the ragged heads' shapes
        q, k, v, max_abs = check_forward(fa, "long_8192", shape, shape, {},
                                         rows, dtype, gen, straddles=True)
        args = fa.forward_args(q, k, v)
        kernel_ms, plain_ms = alternate(
            lambda: fa.launch_fwd(*args),
            lambda: fa.flash_attention_reference(q, k, v))
        wrapper_ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
        record["flash_attn_fwd", "long_8192", tag] = dict(
            max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms,
            wrapper_ms=wrapper_ms)
        log("timing", f"flash_attn_fwd long_8192 {tag} {shape}: kernel "
            f"{kernel_ms:.3f} ms, wrapper {wrapper_ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms [{gpu}]")
        del q, k, v, args
        args, abs_errs = check_backward(fa, "long_8192", shape, shape, {},
                                        rows, rows, dtype, gen)
        record.setdefault(("flash_attn_bwd_dq", "long_8192", tag), {})[
            "max_abs_err"] = abs_errs[0]
        record.setdefault(("flash_attn_bwd_dkv", "long_8192", tag), {})[
            "max_abs_err"] = max(abs_errs[1:])
        backward_timing(args, "long_8192", tag, record, gpu, inner=1)
        del args
    log("long", f"attention kernels at {shape}, f32 and bf16: forward, dQ "
        f"and dK/dV within the bars of the kernels and backward phases, "
        f"timed, {time.perf_counter() - t0:.2f} s")


def long_distill_inputs(tcfg, dev):
    """The T = LONG_T distillation's student (the 10 ms recipe's 6 layers,
    dropouts 0, seeded), batch (B = 1, seeded) and a span mask of the
    teacher's config (seeded): what long_distill and the parallel phase's
    sequence-parallel distillation, on its ranks, both build."""
    from speech_ssl_compression_tpu_torch.configs import (
        MelHuBERTConfig, read_yaml,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import span_mask
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_params_np, load_model,
    )

    scfg = MelHuBERTConfig.from_dict(dict(
        read_yaml(DISTILL_10MS_YAML)["student"], dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0))
    student = load_model(init_params_np(scfg, 1), scfg).to(dev)
    rng = np.random.default_rng(3)
    batch = {"feat": torch.from_numpy(rng.standard_normal(
        (1, LONG_T, scfg.feat_emb_dim)).astype(np.float32)).to(dev),
        "label": torch.from_numpy(rng.integers(
            0, tcfg.num_cluster, (1, LONG_T))).to(dev),
        "pad_mask": torch.ones((1, LONG_T), device=dev),
        "length": np.array([LONG_T])}
    mask = torch.from_numpy(span_mask(tcfg, batch["length"], LONG_T,
                                      np.random.default_rng(SEQPAR_MASK_SEED)
                                      )).to(dev)
    return student, batch, mask


def long_distill(dev, gpu: str, teacher, refs: dict):
    """T = LONG_T distillation, B = 1, nomasked, dropouts 0 (bench.py's
    long-form row): ``teacher`` (the 10 ms run's model, 12 layers) into
    the 10 ms recipe's 6-layer student, LONG_DISTILL_STEPS updates through
    make_distill_grad_step and the fused apply in f32 and in bf16; then
    each captured student attention call against the plain backward, the
    whole f32 step against impl="dense", the times and the peak memory.
    Before the updates, the 1-process f32 grad step of each loss type on
    the seeded student with the checkpoint's model as the teacher
    (``refs.pop("teacher")``; SEQPAR_TEMPERATURE, SEQPAR_ALPHA, the seeded
    span mask, TF32 off) goes to ``refs["distill"]``: the yardstick of the
    parallel phase's sequence-parallel step. Returns (launch counts per
    dtype, those past the stream threshold)."""
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.steps import (
        fused_apply, init_opt_state, make_distill_grad_step, make_optimizer,
    )

    t0 = time.perf_counter()
    tcfg = teacher.cfg
    student, batch, mask = long_distill_inputs(tcfg, dev)
    scfg = student.cfg
    refs["distill"] = {}
    params = dict(student.named_parameters())
    ckpt_teacher = refs.pop("teacher")
    for loss_type in ("nomasked", "masked"):
        step = make_distill_grad_step(
            ckpt_teacher, student, temperature=SEQPAR_TEMPERATURE,
            alpha=SEQPAR_ALPHA, loss_type=loss_type, deterministic=True)
        with matmul_precision("highest"):
            loss, grads, logs = step(params, batch, torch.Generator(),
                                     mask_indices=(mask if loss_type ==
                                                   "masked" else None))
        refs["distill"][loss_type] = (
            float(loss), {k: float(v) for k, v in logs.items()},
            {k: g.detach().float().cpu() for k, g in zip(params, grads)})
        del step, grads
    del ckpt_teacher
    log("long", f"the 1-process f32 distill grad steps at T = {LONG_T} "
        f"(nomasked, masked; T {SEQPAR_TEMPERATURE:g}, alpha "
        f"{SEQPAR_ALPHA:g}, {int(mask.sum())} masked frames) kept for the "
        f"sequence-parallel step, {time.perf_counter() - t0:.2f} s")
    hyper = make_optimizer(lr=1e-4)
    dtypes = (torch.float32, torch.bfloat16)
    steps = {dtype: make_distill_grad_step(
        teacher, student, temperature=1.0, alpha=1.0, loss_type="nomasked",
        compute_dtype=dtype) for dtype in dtypes}
    state = {dtype: {k: torch.nn.Parameter(p.detach().clone())
                     for k, p in student.named_parameters()}
             for dtype in dtypes}
    opt = {dtype: init_opt_state(list(state[dtype].values()))
           for dtype in dtypes}

    def update(dtype):
        loss, grads, logs = steps[dtype](state[dtype], batch,
                                         torch.Generator())
        fused_apply(hyper, list(state[dtype].values()), opt[dtype], grads,
                    1.0)
        return loss

    # the main path: counts from exactly these updates
    reset_launch_counts()
    losses = {dtype: [float(update(dtype)) for _ in range(
        LONG_DISTILL_STEPS)] for dtype in dtypes}
    torch.cuda.synchronize()
    counts, long_counts = dtype_launch_counts(), long_launch_counts()
    n = LONG_DISTILL_STEPS
    want = {"flash_attn_fwd": n * (tcfg.encoder_layers + scfg.encoder_layers),
            "flash_attn_bwd_dq": n * scfg.encoder_layers,
            "flash_attn_bwd_dkv": n * scfg.encoder_layers}
    log("long", f"distillation at T = {LONG_T}, B = 1, nomasked, dropouts 0: "
        f"teacher {tcfg.encoder_layers}L/{tcfg.encoder_embed_dim} -> student "
        f"{scfg.encoder_layers}L, {n} updates in f32 and in bf16: losses "
        f"{ {str(d): [round(x, 6) for x in v] for d, v in losses.items()} }; "
        f"launches {counts}, past the stream threshold {long_counts}; "
        f"{time.perf_counter() - t0:.2f} s")
    for name, k in want.items():
        if not (counts[name] == long_counts[name] == {"f32": k, "bf16": k}):
            raise AssertionError(f"long distill launches {counts}, past the "
                                 f"threshold {long_counts}, want {want}")
    if not np.isfinite([x for v in losses.values() for x in v]).all():
        raise AssertionError(f"long distill losses {losses}")

    # each student attention call of one grad step per dtype, as captured
    # (q, k, v and dO per layer), against the plain backward
    t0 = time.perf_counter()
    rows = torch.ones((1, LONG_T), dtype=torch.bool, device=dev)
    for dtype in dtypes:
        captured, undo = capture_attention("flash_attention")
        try:
            steps[dtype](state[dtype], batch, torch.Generator())
        finally:
            undo()
        torch.cuda.synchronize()
        # the student's calls: the teacher's record no graph, and no dO
        captured = [e for e in captured if len(e) == 6]
        if len(captured) != scfg.encoder_layers:
            raise AssertionError(f"{len(captured)} student calls captured")
        for i, (q, k, v, pad, _, do) in enumerate(captured):
            check_backward(fa, f"long_distill_layer{i}", tuple(q.shape),
                           tuple(k.shape), dict(key_padding_mask=pad), rows,
                           ~pad, dtype, None, inputs=(q, k, v, do))
        del captured
    log("long", f"the {scfg.encoder_layers} student layers' attention calls "
        f"of one grad step, f32 and bf16, as captured: dQ and dK/dV within "
        f"the bars of the backward phase, {time.perf_counter() - t0:.2f} s")

    # the whole f32 step with the kernels against impl="dense": the plain
    # autograd keeps each student layer's softmax output, (1, H, T, T) f32
    t0 = time.perf_counter()
    heads = scfg.encoder_attention_heads[0]
    p_bytes = heads * LONG_T * LONG_T * 4
    free, total = torch.cuda.mem_get_info(dev)
    # what the caching allocator holds and no tensor uses is free to it
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    need = (scfg.encoder_layers + 4) * p_bytes
    log("long", f"the dense f32 step at T = {LONG_T} keeps "
        f"{scfg.encoder_layers} x {p_bytes / 2**30:.2f} GiB of softmax "
        f"outputs and holds ~4 more of them at once: ~{need / 2**30:.1f} GiB "
        f"against {free / 2**30:.1f} GiB free of {total / 2**30:.1f}")
    if need > 0.9 * free:
        raise AssertionError("no room for the dense f32 step at T = "
                             f"{LONG_T}")
    out = {}
    for impl in ("auto", "dense"):
        step = make_distill_grad_step(
            teacher, student, temperature=1.0, alpha=1.0,
            loss_type="nomasked", attn_impl=impl, deterministic=True)
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with matmul_precision("highest"):
            loss, grads, logs = step(state[torch.float32], batch,
                                     torch.Generator())
        torch.cuda.synchronize()
        out[impl] = (loss, grads, logs, dict(fa.launch_counts),
                     torch.cuda.max_memory_allocated(dev) - base)
        del step
    (loss_k, grads_k, logs_k, n_k, peak_k), (loss_d, grads_d, logs_d, n_d,
                                             peak_d) = out.values()
    rels = {k: abs(float(a) - float(r)) / abs(float(r)) for k, a, r in
            [("loss", loss_k, loss_d)] + [(k, logs_k[k], logs_d[k]) for k in (
                "hard_loss", "soft_loss", "teacher_loss")]}
    names = list(state[torch.float32])
    errs = grad_errors(names, grads_k, grads_d)
    i = int(np.argmax(errs))
    log("long", f"distill grad step at T = {LONG_T}, kernels vs impl='dense' "
        f"(f32, TF32 off): {({k: f'{v:.3e}' for k, v in rels.items()})} rel; "
        f"worst of {len(errs)} student gradients rel L2 {errs[i]:.3e} "
        f"({names[i]}), bar {GRAD_BAR:g}; launches {n_k} and {n_d}; peak "
        f"above what was allocated {peak_k} B with the kernels, {peak_d} B "
        f"dense; {time.perf_counter() - t0:.2f} s")
    if not (max(errs) < GRAD_BAR and max(rels.values()) < GRAD_BAR):
        raise AssertionError("long distill gradients disagree with dense")
    if n_k != {k: v // n for k, v in want.items()} or any(n_d.values()):
        raise AssertionError("the long parity run took the wrong path")
    del out, grads_k, grads_d

    # the times and the peak memory of one update (grad step + apply)
    t0 = time.perf_counter()
    report = []
    for dtype in dtypes:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        update(dtype)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        ms = cuda_ms(lambda d=dtype: update(d), reps=1, warm=False)
        report.append(f"{dtype} {ms:.2f} ms ({1e3 / ms:.3f} steps/s, "
                      f"{LONG_T / ms * 1e3:.0f} frames/s), peak above the "
                      f"model {peak / 2**30:.2f} GiB")
    log("timing", f"one distillation update at T = {LONG_T}, B = 1 "
        f"(teacher forward, student forward and backward, apply): "
        + "; ".join(report) + f"; {time.perf_counter() - t0:.2f} s [{gpu}]")
    return counts, long_counts


def phase_long(dev, gpu: str, tmp: str, record: dict):
    """The long-sequence paths at full width: the 10 ms recipe, T = LONG_T
    extraction and distillation, and the attention kernels at their
    shape. Returns ({path: launch counts per dtype}, {path: those past the
    stream threshold}, the parallel phase's sequence-parallel references:
    {"ckpt": the 10 ms checkpoint, "serve", "distill"}); fails unless the
    forward, dQ and dK/dV kernels each launched past it on these paths."""
    t_phase = time.perf_counter()
    root = pathlib.Path(tmp) / "long"
    root.mkdir()
    paths, long_paths = {}, {}
    runner, *counts = long_10ms_train(dev, gpu, tmp, root)
    paths["melhubert 10ms train"], long_paths["melhubert 10ms train"] = counts
    teacher = runner.model
    heads = runner.cfg.encoder_attention_heads[0]
    del runner
    gc.collect()
    refs = {"ckpt": str(root / "exp" / "last-step.npz")}
    counts = long_serve(dev, gpu, refs["ckpt"], refs)
    paths["melhubert long serve"], long_paths["melhubert long serve"] = counts
    long_kernels(dev, gpu, heads, record)
    counts = long_distill(dev, gpu, teacher, refs)
    paths["melhubert long distill"], long_paths["melhubert long distill"] = (
        counts)
    del teacher
    for path in root.glob("*/*.npz"):
        if str(path) != refs["ckpt"]:  # the parallel phase serves it
            path.unlink()
    past = {name: sum(c[name][tag] for c in long_paths.values()
                      for tag in ("f32", "bf16"))
            for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                         "flash_attn_bwd_dkv")}
    log("long", f"launches past the stream threshold on the long paths: "
        f"{past}; phase {time.perf_counter() - t_phase:.2f} s")
    if not all(past.values()):
        raise AssertionError(f"a kernel launched nothing past T = 4096 on "
                             f"the long paths: {past}")
    return paths, long_paths, refs


def tones_and_noise(rng, samples: int) -> np.ndarray:
    """``samples`` of 16 kHz audio: three tones drawn from ``rng`` and
    noise, f32."""
    t = np.arange(samples) / 16000.0
    tone = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
               for _ in range(3))
    return (tone + 0.02 * rng.standard_normal(samples)).astype(np.float32)


def synthetic_wavs(seed: int):
    """16 kHz noise + tones whose stacked 20 ms frame counts are
    SERVE_LENGTHS (n frames <- 400 + 160 * (2n - 2) samples)."""
    rng = np.random.default_rng(seed)
    return [tones_and_noise(rng, 400 + 160 * (2 * n - 2))
            for n in SERVE_LENGTHS]


def phase_slice(dev, gpu: str, tmp: str):
    from speech_ssl_compression_tpu_torch.configs import (
        melhubert_config_from_yaml,
    )
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.utils.checkpoint import save_checkpoint
    from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

    t0 = time.perf_counter()
    cfg = melhubert_config_from_yaml(CONFIG_YAML)
    ckpt = str(pathlib.Path(tmp) / SLICE_CKPT)
    save_checkpoint(ckpt, init_params_np(cfg, seed=0),
                    meta={"Upstream_Config": {"melhubert": cfg.to_dict()},
                          "Step": 0})

    def extractor(dtype, impl):
        return MelHuBERTExtractor(
            ckpt, fp=20, mean_std_npy_path=str(MEAN_STD), dtype=dtype,
            matmul_precision="highest", device=dev, attn_impl=impl,
        )

    ext = extractor(torch.float32, "auto")
    wavs = synthetic_wavs(seed=0)
    log("slice", f"MelHuBERT-20ms {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {ext.num_params()} params, "
        f"checkpoint written and loaded, {len(wavs)} utterances, "
        f"{time.perf_counter() - t0:.2f} s")

    # the main path: counts from exactly one forward_packed call
    t0 = time.perf_counter()
    reset_launch_counts()
    out = ext.forward_packed(wavs)
    torch.cuda.synchronize()
    launches = fa.launch_counts["flash_attn_fwd"]
    by_dtype = dtype_launch_counts()
    n_layers = cfg.encoder_layers
    log("slice", f"forward_packed f32: {out['n_packed_rows']} rows of "
        f"{CAPACITY}, flash_attn_fwd launches {launches} (expected "
        f"{n_layers}), {time.perf_counter() - t0:.2f} s")
    if launches != n_layers:
        raise AssertionError(f"{launches} kernel launches, want {n_layers}")
    if out["n_packed_rows"] != 8:
        raise AssertionError(f"{out['n_packed_rows']} packed rows, want 8")

    lengths = torch.tensor(out["lengths"], device=dev)
    t = out["last_hidden_state"].shape[1]
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    states = out["hidden_states"] + [out["last_hidden_state"]]
    if not all(torch.isfinite(s.float()[valid]).all() for s in states):
        raise AssertionError("non-finite output")

    def worst(other, metric=rel_err):
        others = other["hidden_states"] + [other["last_hidden_state"]]
        return max(metric(a, b, valid) for a, b in zip(others, states))

    t0 = time.perf_counter()
    ext_dense = extractor(torch.float32, "dense")
    fa.reset_launch_counts()
    out_dense = ext_dense.forward_packed(wavs)
    torch.cuda.synchronize()
    if fa.launch_counts["flash_attn_fwd"]:
        raise AssertionError("impl='dense' launched the kernel")
    err_dense = worst(out_dense)
    log("slice", f"kernel vs impl='dense' (f32, TF32 off), all hidden "
        f"states: max|d|/mean|ref| {err_dense:.3e} (bar {SLICE_BAR:g}), "
        f"{time.perf_counter() - t0:.2f} s")
    if not err_dense < SLICE_BAR:
        raise AssertionError("slice disagrees with the dense path")

    t0 = time.perf_counter()
    err_unpacked = worst(ext.forward(wavs))
    log("slice", f"packed vs unpacked forward (f32): max|d|/mean|ref| "
        f"{err_unpacked:.3e} (bar {PACKED_BAR:g}), "
        f"{time.perf_counter() - t0:.2f} s")
    if not err_unpacked < PACKED_BAR:
        raise AssertionError("packed output disagrees with unpacked")

    t0 = time.perf_counter()
    ext_bf16 = extractor(torch.bfloat16, "auto")
    out_bf16 = ext_bf16.forward_packed(wavs)
    bf16_states = out_bf16["hidden_states"] + [out_bf16["last_hidden_state"]]
    if not all(torch.isfinite(s.float()[valid]).all() for s in bf16_states):
        raise AssertionError("non-finite bf16 output")
    err_bf16 = worst(out_bf16, rel_l2)
    log("slice", f"bf16 vs f32, all hidden states: |d|_2/|ref|_2 "
        f"{err_bf16:.3e} (bar {BF16_SLICE_BAR:g}), max|d|/mean|ref| "
        f"{worst(out_bf16):.3e}, {time.perf_counter() - t0:.2f} s")
    if not err_bf16 < BF16_SLICE_BAR:
        raise AssertionError("bf16 output disagrees with f32")

    extractors = {
        ("f32", "kernel"): ext, ("f32", "dense"): ext_dense,
        ("bf16", "kernel"): ext_bf16,
        ("bf16", "dense"): extractor(torch.bfloat16, "dense"),
    }
    return by_dtype, extractors, wavs


def phase_timing(extractors, wavs, gpu: str):
    frames = sum(SERVE_LENGTHS)
    feats = {}
    for (tag, impl), ext in extractors.items():
        if tag not in feats:
            feats[tag] = ext.featurize(wavs)
        feat, pad_mask, lengths = feats[tag]
        end_to_end = cuda_ms(lambda: ext.forward_packed(wavs))
        encoder = cuda_ms(
            lambda: ext._pack_and_dispatch(feat, pad_mask, lengths))
        log("timing", f"forward_packed {tag} attn={impl}: "
            f"{frames / end_to_end * 1e3:.0f} frames/s from waveforms "
            f"({end_to_end:.2f} ms), {frames / encoder * 1e3:.0f} frames/s "
            f"from features ({encoder:.2f} ms), {frames} frames [{gpu}]")


def device_busy_us(events) -> float:
    """Length of the union of the events' device time intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profile_calls(label: str, fn, gpu: str, calls: int = 3,
                  warm: int = 2, host: bool = True) -> tuple:
    """torch.profiler through utils/profiling.py::trace (no trace file)
    over ``calls`` calls of ``fn`` (after ``warm`` warm-ups): device busy
    time per call, idle share against the CUDA-event wall time, the
    largest device kernels, the port's own kernels with their share of
    the busy time, and the device time each of the port's ``sslc.*``
    spans launched (host traced only); ``host=False`` traces the device
    alone (a trace of thousands of host ops takes seconds to read).
    Returns (the idle share, the device busy ms per call)."""
    from torch.autograd import DeviceType

    from speech_ssl_compression_tpu_torch.utils.profiling import (
        span_device_seconds,
        trace,
    )

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with trace(None, host=host) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
    wall = start.elapsed_time(end) / calls
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        raise AssertionError("the profiler saw no device activity")
    busy = device_busy_us(device) / 1e3 / calls
    per_name = collections.Counter()
    for e in device:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / calls
    top = "; ".join(f"{name[:72]} {ms:.2f} ms"
                    for name, ms in per_name.most_common(6))
    ours = "; ".join(
        f"{next(k for k in KERNEL_SYMBOLS if k in name)} {ms:.2f} ms "
        f"({ms / busy:.1%})" for name, ms in per_name.most_common()
        if any(k in name for k in KERNEL_SYMBOLS))
    spans = "; ".join(f"{name} {1e3 * s / calls:.2f} ms" for name, s in
                      sorted(span_device_seconds(prof).items()))
    log("profile", f"{label}: wall {wall:.2f} ms/call (profiler on), device "
        f"busy {busy:.2f} ms/call, idle {1 - busy / wall:.1%}; largest "
        f"device kernels per call: {top}; the port's kernels: "
        f"{ours or 'none'}; the port's spans' device time per call: "
        f"{spans or 'none'} [{gpu}]")
    return 1 - busy / wall, busy


def phase_profile(extractors, wavs, gpu: str):
    """forward_packed from features, per path."""
    for (tag, impl), ext in extractors.items():
        feat, pad_mask, lengths = ext.featurize(wavs)
        profile_calls(f"forward_packed from features {tag} attn={impl}",
                      lambda: ext._pack_and_dispatch(feat, pad_mask, lengths),
                      gpu)


def fbank_against(ext, wavs, fp: int) -> tuple:
    """The card's featurize_batch on the extractor's batch assembly at
    frame period ``fp``, against the host fbank in float64 (wav_to_mel,
    precision "high", every FBANK_EVERY-th utterance) and the port's plain
    CPU featurize_batch on the same batch: (upload dtype, max |d| / max
    |ref| against each). n_valid must equal the host's frame counts and
    every row past it must be 0."""
    from speech_ssl_compression_tpu_torch.extract import wav_to_mel
    from speech_ssl_compression_tpu_torch.ops.fbank import featurize_batch
    from speech_ssl_compression_tpu_torch.utils.device import upload

    ext = copy.copy(ext)  # the same weights at another frame period
    ext.fp = fp
    batch, n_samp, max_frames, stack, lengths, _ = (
        ext._assemble_wave_batch(wavs))
    feat, n_valid = featurize_batch(
        upload(batch, ext.device), upload(np.asarray(n_samp), ext.device),
        ext._mean, ext._std, max_frames, stack=stack)
    plain, plain_n = featurize_batch(
        torch.from_numpy(batch), torch.tensor(n_samp), ext._mean.cpu(),
        ext._std.cpu(), max_frames, stack=stack)
    feat, n_valid = feat.cpu(), n_valid.cpu()
    if n_valid.tolist() != lengths or plain_n.tolist() != lengths:
        raise AssertionError(f"fbank n_valid {n_valid.tolist()}, plain "
                             f"{plain_n.tolist()}, want {lengths}")
    past = torch.arange(feat.shape[1])[None, :] >= n_valid[:, None]
    if feat[past].any():
        raise AssertionError("device fbank rows past n_valid are not 0")
    err_plain = float((feat - plain).abs().max() / plain.abs().max())
    worst, top = 0.0, 0.0
    for i, w in list(enumerate(wavs))[::FBANK_EVERY]:
        ref = torch.from_numpy(wav_to_mel(w, ext.mean, ext.std, fp,
                                          precision="high"))
        worst = max(worst, float((feat[i, :len(ref)] - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
    return batch.dtype, worst / top, err_plain


def wall_s(fn) -> float:
    """Host seconds of ``fn()``, the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_wave_serve(dev, gpu: str, tmp: str, extractors):
    """Serving from waveforms on the slice phase's full-width MelHuBERT:
    the card's fbank against the host's, forward_packed with
    featurizer="device" (f32 and bf16) against featurizer="host", one
    hubconf factory's UpstreamExpert, forward_stream over WAVE_BATCHES
    batches against sequential forward_packed (bitwise), frames/s from
    waveforms streamed and fence-per-call with the idle share, then the
    stream's last layer dumped and clustered by the cluster CLI (K = 500,
    2 epochs) against the CPU kmeans_assign. Returns the launches of the
    serve path (the two forward_packed calls and the expert's) and of the
    stream."""
    import contextlib
    import io

    from speech_ssl_compression_tpu_torch import cluster
    from speech_ssl_compression_tpu_torch.extract_feature import dump_features
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.ops.kmeans import kmeans_assign
    from speech_ssl_compression_tpu_torch.s3prl import hubconf

    ext, ext_bf16 = extractors["f32", "kernel"], extractors["bf16", "kernel"]
    n_layers = ext.cfg.encoder_layers
    wavs = synthetic_wavs(seed=0)
    t0 = time.perf_counter()
    exact = [(np.round(w * 32767) / 32768).astype(np.float32) for w in wavs]
    for fp, case, batch in ((20, "float", wavs), (10, "float", wavs),
                            (20, "int16-exact", exact)):
        dtype, err_host, err_plain = fbank_against(ext, batch, fp)
        log("wave serve", f"featurize_batch fp {fp}, {case} audio "
            f"(uploaded as {dtype}): max|d|/max|ref| {err_host:.3e} against "
            f"the host fbank in float64, {err_plain:.3e} against the plain "
            f"CPU version (bar {FBANK_BAR:g})")
        if not (err_host < FBANK_BAR and err_plain < FBANK_BAR):
            raise AssertionError("the device fbank disagrees")
        if (dtype == np.int16) != (case == "int16-exact"):
            raise AssertionError(f"{case} audio uploaded as {dtype}")
    log("wave serve", f"fbank checks {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    expert = hubconf.compression_20ms_melhubert_960hours_local(
        str(pathlib.Path(tmp) / SLICE_CKPT), packed=True, featurizer="device",
        device=dev)
    log("wave serve", f"hubconf.compression_20ms_melhubert_960hours_local "
        f"loaded, {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    reset_launch_counts()
    out = ext.forward_packed(wavs, featurizer="device")
    out_bf16 = ext_bf16.forward_packed(wavs, featurizer="device")
    out_expert = expert(wavs)
    torch.cuda.synchronize()
    serve = dtype_launch_counts()
    got = serve["flash_attn_fwd"]
    log("wave serve", f"forward_packed(featurizer='device') f32 and bf16 "
        f"and the expert: flash_attn_fwd launches {got} (expected f32 "
        f"{2 * n_layers}, bf16 {n_layers}), "
        f"{time.perf_counter() - t0:.2f} s")
    if got != {"f32": 2 * n_layers, "bf16": n_layers}:
        raise AssertionError(f"flash_attn_fwd launches {got}")
    del expert
    lengths = torch.tensor(out["lengths"], device=dev)
    valid = (torch.arange(out["last_hidden_state"].shape[1], device=dev)
             [None, :] < lengths[:, None])

    def states(o):
        return o["hidden_states"] + [o["last_hidden_state"]]

    if not all(torch.equal(a, b) for a, b in zip(states(out_expert),
                                                 states(out))):
        raise AssertionError("the hubconf expert differs from forward_packed")
    host = ext.forward_packed(wavs)
    err = max(rel_err(a, b, valid) for a, b in zip(states(out), states(host)))
    host_bf16 = ext_bf16.forward_packed(wavs)
    err_bf16 = max(rel_l2(a, b, valid)
                   for a, b in zip(states(out_bf16), states(host_bf16)))
    log("wave serve", f"featurizer 'device' vs 'host', all hidden states: "
        f"f32 max|d|/mean|ref| {err:.3e} (bar {WAVE_BAR:g}), bf16 "
        f"|d|_2/|ref|_2 {err_bf16:.3e} (bar {BF16_SLICE_BAR:g}); the "
        "expert bitwise forward_packed")
    if not (err < WAVE_BAR and err_bf16 < BF16_SLICE_BAR):
        raise AssertionError("device featurizer serving disagrees")
    del out, out_bf16, out_expert, host, host_bf16

    t0 = time.perf_counter()
    batches = [synthetic_wavs(seed=i) for i in range(WAVE_BATCHES)]
    want = [ext.forward_packed(b, featurizer="device") for b in batches]
    reset_launch_counts()
    got = list(ext.forward_stream(iter(batches), featurizer="device"))
    torch.cuda.synchronize()
    stream = dtype_launch_counts()
    launches = fa.launch_counts["flash_attn_fwd"]
    same = all(torch.equal(a, b) for g, w in zip(got, want)
               for a, b in zip(states(g), states(w)))
    log("wave serve", f"forward_stream over {len(batches)} batches of "
        f"{len(wavs)}: flash_attn_fwd launches {launches} (expected "
        f"{n_layers * len(batches)}), bitwise sequential forward_packed "
        f"{same}, {time.perf_counter() - t0:.2f} s")
    if launches != n_layers * len(batches) or len(got) != len(batches):
        raise AssertionError("forward_stream launched the wrong kernels")
    if not same:
        raise AssertionError("forward_stream differs from forward_packed")
    t0 = time.perf_counter()
    dump = pathlib.Path(tmp) / "wave_dump"
    for i, o in enumerate(got):
        dump_features(dump / f"b{i}", [f"u{j}" for j in range(len(wavs))],
                      o["last_hidden_state"].cpu().numpy(), o["lengths"])
    del want, got
    gc.collect()
    torch.cuda.empty_cache()
    log("wave serve", f"last layer dumped, {time.perf_counter() - t0:.2f} s")

    frames = sum(SERVE_LENGTHS) * len(batches)

    def streamed(featurizer):
        for o in ext.forward_stream(iter(batches), featurizer=featurizer):
            o["last_hidden_state"].cpu()

    def fenced(featurizer):
        for b in batches:
            ext.forward_packed(b, featurizer=featurizer)[
                "last_hidden_state"].cpu()

    # the same device work both ways: the busy time of one streamed run
    # under the profiler gives each way's idle share against its wall time
    # with the profiler off
    t0 = time.perf_counter()
    _, busy_ms = profile_calls(f"{len(batches)} batches from waveforms, "
                               "streamed, featurizer 'device'",
                               lambda: streamed("device"), gpu, calls=1,
                               warm=0, host=False)
    log("wave serve", f"profiled, {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    times = collections.defaultdict(list)
    for name, fn in (("fence-per-call", fenced), ("streamed", streamed),
                     ("streamed", streamed), ("fence-per-call", fenced)):
        times[name, "device"].append(wall_s(lambda: fn("device")))
    times["streamed", "host"].append(wall_s(lambda: streamed("host")))
    for (name, feat), ts in times.items():
        log("wave serve", f"{frames} frames from waveforms, {name}, "
            f"featurizer {feat!r}, f32: " + ", ".join(
                f"{t:.4f} s ({frames / t:.0f} frames/s)" for t in ts)
            + (f"; idle {1 - busy_ms / 1e3 / min(ts):.1%} against the "
               f"streamed run's device busy {busy_ms:.2f} ms"
               if feat == "device" else "") + f" [{gpu}]")
    log("wave serve", f"timed, {time.perf_counter() - t0:.2f} s")

    out_dir = pathlib.Path(tmp) / "wave_labels"
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cluster.main(["-f", str(dump / "*" / "*.npy"), "-k", str(KMEANS_K),
                      "-o", str(out_dir), "--epochs", str(KMEANS_EPOCHS),
                      "--chunk-rows", str(KMEANS_CHUNK), "--device",
                      str(dev)])
    seconds = time.perf_counter() - t0
    for line in printed.getvalue().splitlines():
        log("wave serve", line)
    log("wave serve", f"cluster CLI {seconds:.2f} s in all [{gpu}]")
    t0 = time.perf_counter()
    paths = cluster._feature_paths(str(dump / "*" / "*.npy"))
    x = torch.from_numpy(np.concatenate([np.load(p) for p in paths]))
    centers = torch.from_numpy(np.load(out_dir / "centers.npy"))
    labels = np.asarray([int(v) for line in
                         (out_dir / "labels.km").read_text().splitlines()
                         for v in line.split()])
    lens = [int(v) for v in (out_dir / "labels.len").read_text().split()]
    if lens != [len(np.load(p, mmap_mode="r")) for p in paths]:
        raise AssertionError("labels.len disagrees with the dump")
    cpu = kmeans_assign(x, centers).numpy()
    top = torch.topk(2 * x @ centers.T - (centers ** 2).sum(-1), 2).values
    tie = ((top[:, 0] - top[:, 1])
           <= KMEANS_TIE * top[:, 0].abs().clamp_min(1.0)).numpy()
    differ = int(((labels != cpu) & ~tie).sum())
    log("wave serve", f"k-means K = {KMEANS_K}, {len(x)} frames of "
        f"{x.shape[1]}: labels on the card against the CPU kmeans_assign: "
        f"{differ} differ of {int((~tie).sum())} away from near-ties "
        f"({int(tie.sum())} near-ties, {int((labels != cpu).sum())} differ "
        f"in all), {len(np.unique(labels))} clusters used, "
        f"{time.perf_counter() - t0:.2f} s")
    if differ or len(labels) != len(x):
        raise AssertionError("k-means labels disagree with the CPU")
    return serve, stream


def stream_work(cfg, batch: int, chunk: int, cap: int, dtype) -> tuple:
    """(FLOPs, bytes) of one lockstep step, attention counted at the full
    cache capacity as the step computes it (bench.py's count, JAX package,
    :513-523): per row and layer the q/k/v/out projections 8 C D^2, scores
    and context 4 C cap D, the FFN 4 C D F; the pos-conv 2 C K D^2 / g.
    Bytes: the weights, both caches of every layer read once, the window
    of features in and the chunk's hidden state out (f32)."""
    d, c = cfg.encoder_embed_dim, chunk
    flops = batch * (sum(8 * c * d * d + 4 * c * cap * d + 4 * c * d * f
                         for f in cfg.encoder_ffn_embed_dim)
                     + 2 * c * cfg.conv_pos * d * d // cfg.conv_pos_groups)
    size = torch.tensor([], dtype=dtype).element_size()
    weights = (cfg.feat_emb_dim * d + d + d * d // cfg.conv_pos_groups
               * cfg.conv_pos + sum(
                   4 * d * h * cfg.head_dim + 2 * d * f + 8 * d + f
                   for h, f in zip(cfg.encoder_attention_heads,
                                   cfg.encoder_ffn_embed_dim)))
    caches = sum(2 * batch * h * cap * cfg.head_dim
                 for h in cfg.encoder_attention_heads)
    io = batch * ((c + cfg.conv_pos - 1) * cfg.feat_emb_dim + c * d) * 4
    return flops, (weights + caches) * size + io


def windowed_forward(model, cfg, feat, window: int):
    """The ring stream's oracle: the full forward of one utterance ``feat``
    (T, F) built from the encoder's components, with dense attention over
    keys in (q - window, q] (tests/test_streaming.py::_full_windowed of the
    JAX package). Scores and context in f32 from the compute dtype.
    Returns the last hidden state (T, D)."""
    from speech_ssl_compression_tpu_torch.models.encoder import (
        encoder_layer_forward, encoder_prologue, layer_norm,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import pre_project
    from speech_ssl_compression_tpu_torch.ops.activations import at_least_f32
    from speech_ssl_compression_tpu_torch.ops.attention import (
        output_projection, project_to_heads,
    )
    from speech_ssl_compression_tpu_torch.ops.flash_attention import NEG_INF

    enc = model.encoder
    dtype = enc.layer_norm.weight.dtype
    h = encoder_prologue(pre_project(model, feat[None].to(dtype)), enc, cfg)
    pos = torch.arange(h.shape[1], device=h.device)
    banned = ((pos[None, :] > pos[:, None])
              | (pos[None, :] <= pos[:, None] - window))  # (Tq, Tk)
    scale = torch.reciprocal(torch.sqrt(torch.tensor(float(cfg.head_dim),
                                                     dtype=dtype)))

    def attend(x, attn, heads):
        q, k, v = (project_to_heads(x, proj, heads, cfg.head_dim)
                   for proj in (attn.q_proj, attn.k_proj, attn.v_proj))
        s = torch.matmul(at_least_f32(q * scale),
                         at_least_f32(k).transpose(-1, -2))
        p = torch.softmax(s.masked_fill(banned, NEG_INF), dim=-1)
        ctx = torch.matmul(at_least_f32(p.to(dtype)),
                           at_least_f32(v)).to(dtype)
        return output_projection(ctx, attn.out_proj), ctx

    for i, layer in enumerate(enc.layers):
        h, _ = encoder_layer_forward(
            h, layer, layer_norm_first=cfg.layer_norm_first,
            activation_fn=cfg.activation_fn,
            attn_fn=lambda x, layer=layer, i=i: attend(
                x, layer.self_attn, cfg.encoder_attention_heads[i]))
    return (layer_norm(h, enc.layer_norm) if cfg.layer_norm_first
            else h)[0]


def stream_wav(rng, seconds: float) -> np.ndarray:
    """16 kHz tones and noise, as synthetic_wavs."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    tone = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
               for _ in range(3))
    return (tone + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


def drive_lockstep(sb, plan, rng) -> dict:
    """Feed each slot's utterances (``plan[i]``, waveforms) through
    push_wav in ragged pieces of 0.3-3 s, one piece per live slot and a
    poll() a round; a slot with another utterance is opened again once
    its stream is finished and drained. Returns {(slot, k): output of the
    slot's k-th stream}."""
    from speech_ssl_compression_tpu_torch.streaming import _merge_out

    b = sb.batch
    k, pos = [0] * b, [0] * b
    feeding = [True] * b
    outs = {(i, 0): [] for i in range(b)}

    def take(polled):
        for i, o in enumerate(polled):
            outs[i, k[i]].append(o)

    while any(feeding) or any(k[i] + 1 < len(plan[i]) for i in range(b)):
        for i in range(b):
            if feeding[i]:
                wav = plan[i][k[i]]
                n = int(rng.uniform(0.3, 3.0) * 16000)
                sb.push_wav(i, wav[pos[i]:pos[i] + n])
                pos[i] += n
                if pos[i] >= len(wav):
                    sb.finish(i)
                    feeding[i] = False
            elif k[i] + 1 < len(plan[i]) and sb.slot_finished(i):
                sb.open_stream(i)
                k[i], pos[i], feeding[i] = k[i] + 1, 0, True
                outs[i, k[i]] = []
        take(sb.poll())
    take(sb.flush())
    return {key: _merge_out(*o) for key, o in outs.items()}


def stream_against(got, ref) -> tuple:
    """(max |d| / (STREAM_ATOL + STREAM_RTOL |ref|), the check passing at
    <= 1; max |d|; max |d| / mean |ref|) of a stream's output (host) and
    its reference (device)."""
    got = torch.from_numpy(got).to(ref.device)
    d = (got - ref.float()).abs()
    return (float((d / (STREAM_ATOL + STREAM_RTOL * ref.abs())).max()),
            float(d.max()), float(d.max() / ref.abs().mean()))


def check_lockstep(sb, gpu: str, rng):
    """The f32 lockstep run at full width and its references: every
    stream's hidden states against the full causal forward of its whole
    utterance with impl="dense" (STREAM_ATOL, STREAM_RTOL) and with the
    flash kernel (SLICE_BAR); the launches of both. Returns (the stream's
    launches, the kernel reference's)."""
    from speech_ssl_compression_tpu_torch.extract import (
        matmul_precision, wav_to_mel,
    )
    from speech_ssl_compression_tpu_torch.models.melhubert import (
        melhubert_forward,
    )

    t0 = time.perf_counter()
    lo, hi = STREAM_SECONDS
    plan = [[stream_wav(rng, rng.uniform(lo, lo + 2) if i in STREAM_REOPEN
                        else rng.uniform(lo, hi))] for i in range(sb.batch)]
    for i in STREAM_REOPEN:
        plan[i].append(stream_wav(rng, rng.uniform(12.0, 20.0)))
    reset_launch_counts()
    got = drive_lockstep(sb, plan, rng)
    torch.cuda.synchronize()
    stream_counts = dtype_launch_counts()
    n_frames = sum(len(o["last_hidden_state"]) for o in got.values())
    log("stream", f"f32 lockstep B = {sb.batch}: {len(got)} streams "
        f"({len(STREAM_REOPEN)} slots opened again), {n_frames} frames "
        f"from push_wav, {time.perf_counter() - t0:.2f} s; launches "
        f"{ {k: v for k, v in stream_counts.items() if sum(v.values())} }")
    if any(sum(v.values()) for v in stream_counts.values()):
        raise AssertionError("the stream launched a kernel")

    t0 = time.perf_counter()
    cfg, worst = sb.cfg, {"dense": (0.0, 0.0, 0.0), "auto": (0.0, 0.0, 0.0)}
    reset_launch_counts()
    for (i, k), out in got.items():
        feat = wav_to_mel(plan[i][k], sb.mean, sb.std, fp=20)
        if len(out["last_hidden_state"]) != len(feat):
            raise AssertionError(f"slot {i} stream {k}: "
                                 f"{len(out['last_hidden_state'])} frames "
                                 f"of {len(feat)}")
        x = torch.from_numpy(feat[None]).to(sb.device)
        for impl in ("dense", "auto"):
            with matmul_precision("highest"), torch.inference_mode():
                ref = melhubert_forward(sb.model, x, torch.ones(x.shape[:2],
                                        device=x.device), no_pred=True,
                                        get_hidden=True, attn_impl=impl)
            refs = [ref["pre_feat"]] + ref["layer_hiddens"] + [ref["hidden"]]
            for a, r in zip(out["hidden_states"] + [out["last_hidden_state"]],
                            refs):
                worst[impl] = tuple(map(max, worst[impl],
                                        stream_against(a, r[0])))
    torch.cuda.synchronize()
    causal_counts = dtype_launch_counts()
    launches = causal_counts["flash_attn_fwd"]["f32"]
    log("stream", f"f32 streams against the full causal forward, every "
        f"hidden state: impl='dense' max |d| {worst['dense'][1]:.3e}, "
        f"max |d| / (atol + rtol |ref|) {worst['dense'][0]:.3f} (atol "
        f"{STREAM_ATOL:g}, rtol {STREAM_RTOL:g}), max|d|/mean|ref| "
        f"{worst['dense'][2]:.3e}; the flash kernel (flash_attn_fwd "
        f"launches {launches}) max|d|/mean|ref| {worst['auto'][2]:.3e} "
        f"(bar {SLICE_BAR:g}), max |d| {worst['auto'][1]:.3e}, "
        f"{time.perf_counter() - t0:.2f} s [{gpu}]")
    if not worst["dense"][0] <= 1.0:
        raise AssertionError("the f32 stream disagrees with the dense "
                             "full causal forward")
    if not worst["auto"][2] < SLICE_BAR:
        raise AssertionError("the f32 stream disagrees with the kernel's "
                             "full causal forward")
    if launches != cfg.encoder_layers * len(got):
        raise AssertionError(f"{launches} flash_attn_fwd launches in the "
                             f"causal forwards, want "
                             f"{cfg.encoder_layers * len(got)}")
    return stream_counts, causal_counts


def check_ring(sb, model_f32, gpu: str, rng):
    """The bf16 ring at full width: slot 0 runs RING_LONG frames, past the
    ring's wrap; slot 1 a short stream, then (after the wrap) RING_REUSED
    frames in the same slot; the others RING_LENGTHS. Every stream against
    windowed_forward on the f32 model (TF32 off) by rel. L2."""
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.streaming import _merge_out

    t0 = time.perf_counter()
    cfg, b, cap = sb.cfg, sb.batch, sb._cap
    lengths = rng.integers(*RING_LENGTHS, b)
    lengths[0], lengths[1] = RING_LONG, RING_LENGTHS[0] // 2
    feats = [rng.standard_normal((n, cfg.feat_emb_dim)).astype(np.float32)
             for n in lengths]
    reused = rng.standard_normal((RING_REUSED, cfg.feat_emb_dim)).astype(
        np.float32)
    # slot 0's frames before slot 1 is reused: the first poll() carries
    # the clock past the ring's capacity and every other slot's stream
    right = cfg.conv_pos - 1 - cfg.conv_pos // 2
    head = max(cap, int(lengths[2:].max())) + 2 * sb.chunk + right
    if head >= RING_LONG:
        raise AssertionError(f"RING_LONG {RING_LONG} <= {head}")
    for i in range(b):
        sb.push_feat(i, feats[i][:head] if i == 0 else feats[i])
        if i:
            sb.finish(i)
    first = sb.poll()
    clock = len(first[0]["last_hidden_state"])
    if not (clock > cap and all(sb.slot_finished(i) for i in range(1, b))):
        raise AssertionError(f"clock {clock} not past the ring's {cap} or "
                             "a finished slot not drained")
    sb.open_stream(1)
    sb.push_feat(1, reused)
    sb.push_feat(0, feats[0][head:])
    tail = sb.flush()
    streams = [(feats[0], _merge_out(first[0], tail[0])),
               (feats[1], first[1]), (reused, tail[1])]
    streams += [(feats[i], first[i]) for i in range(2, b)]
    worst_l2 = worst_max = 0.0
    for feat, out in streams:
        with matmul_precision("highest"), torch.inference_mode():
            ref = windowed_forward(model_f32, cfg, torch.from_numpy(
                feat).to(sb.device), sb.window)
        got = torch.from_numpy(out["last_hidden_state"]).to(ref.device)
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"ring stream {tuple(got.shape)} against "
                                 f"{tuple(ref.shape)}, or not finite")
        worst_l2 = max(worst_l2, float(torch.linalg.vector_norm(got - ref)
                                       / torch.linalg.vector_norm(ref)))
        worst_max = max(worst_max, float((got - ref).abs().max()
                                         / ref.abs().max()))
    log("stream", f"bf16 ring B = {b}, window {sb.window}, capacity {cap}: "
        f"{len(streams)} streams, the longest {RING_LONG} frames, slot 1 "
        f"reused at frame {clock}; against the f32 windowed forward |d|_2/"
        f"|ref|_2 {worst_l2:.3e} (bar {BF16_SLICE_BAR:g}), max|d|/max|ref| "
        f"{worst_max:.3e}, {time.perf_counter() - t0:.2f} s [{gpu}]")
    if not worst_l2 < BF16_SLICE_BAR:
        raise AssertionError("the bf16 ring disagrees with the windowed "
                             "forward")


def stream_timing(sb, tag: str, gpu: str, rng) -> None:
    """CUDA-event times of STREAM_STEPS lockstep steps (one poll() each,
    from features; the host's window assembly, the copies to and from the
    card and the step), after 2 warm-ups, and the idle share of 3 steps
    under the profiler; the realtime factor and the FLOP bound."""
    from speech_ssl_compression_tpu_torch.utils.flops import peak_flops

    cfg, b, c = sb.cfg, sb.batch, sb.chunk
    block = rng.standard_normal((c, cfg.feat_emb_dim)).astype(np.float32)
    right = cfg.conv_pos - 1 - cfg.conv_pos // 2

    def feed(n):
        for i in range(b):
            sb.push_feat(i, block[:n])

    def step():
        feed(c)
        if len(sb.poll()[0]["last_hidden_state"]) != c:
            raise AssertionError("a timed poll() ran no step")

    sb.get_hidden = False  # serving reads the last hidden state only
    sb.reset()
    feed(right)
    step()
    step()
    times = []
    for _ in range(STREAM_STEPS):
        feed(c)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sb.poll()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    sb.reset()
    feed(right)
    idle, _ = profile_calls(f"stream {tag} lockstep step B={b}", step, gpu)
    ms = statistics.median(times)
    flops, n_bytes = stream_work(cfg, b, c, sb._cap, sb.dtype)
    # f32 with TF32 off runs on the CUDA cores, bf16 on the tensor cores
    cuda_cores = sb.dtype == torch.float32
    bound_ms, by = bound(flops, n_bytes, sb.dtype, cuda_cores)
    log("stream", f"{tag} B = {b}, chunk {c} ({c * 0.02:.2f} s), capacity "
        f"{sb._cap}: step {ms:.3f} ms median of {STREAM_STEPS} (min "
        f"{min(times):.3f}, max {max(times):.3f}), realtime "
        f"{b * c * 0.02 / ms * 1e3:.1f}x aggregate, idle {idle:.1%} of 3 "
        f"steps; bound {bound_ms:.3f} ms by {by} ({flops / 1e12:.3f} TFLOP "
        f"at {peak_flops(sb.dtype, cuda_cores=cuda_cores) / 1e12:g} "
        f"TFLOP/s, "
        f"{n_bytes / 1e9:.3f} GB) [{gpu}]")


def phase_stream(dev, gpu: str):
    """Streaming causal serving at full width (bench.py's streaming rows):
    a causal MelHuBERT-20ms (CONFIG_YAML with attention_type causal,
    seeded random weights handed over as params=, cfg=) through
    StreamingCausalBatchExtractor: the f32 lockstep check and the bf16
    ring check, each with its timing. Returns (the stream's launches, the
    causal forwards')."""
    from speech_ssl_compression_tpu_torch.configs import (
        melhubert_config_from_yaml,
    )
    from speech_ssl_compression_tpu_torch.streaming import (
        StreamingCausalBatchExtractor,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import init_params_np

    t0 = time.perf_counter()
    cfg = dataclasses.replace(melhubert_config_from_yaml(CONFIG_YAML),
                              attention_type="causal")
    params = init_params_np(cfg, seed=1)
    rng = np.random.default_rng(7)
    sb = StreamingCausalBatchExtractor(
        params=params, cfg=cfg, fp=20, mean_std_npy_path=str(MEAN_STD),
        get_hidden=True, device=dev, **STREAM_F32)
    log("stream", f"causal MelHuBERT-20ms {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, weights drawn and loaded, "
        f"{time.perf_counter() - t0:.2f} s")
    counts = check_lockstep(sb, gpu, rng)
    stream_timing(sb, "f32", gpu, rng)
    model_f32 = sb.model
    del sb
    ring = StreamingCausalBatchExtractor(
        params=params, cfg=cfg, fp=20, mean_std_npy_path=str(MEAN_STD),
        device=dev, **STREAM_BF16)
    check_ring(ring, model_f32, gpu, rng)
    stream_timing(ring, "bf16 ring", gpu, rng)
    del ring, model_f32, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_train_profile(runner, batch, gpu: str):
    """The bf16 grad step, with the kernels and with impl="dense", and the
    f32 grad step with the kernels."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    for dtype, impl in ((runner.compute_dtype, "auto"),
                        (runner.compute_dtype, "dense"),
                        (torch.float32, "auto")):
        step = make_melhubert_grad_step(
            runner.model, accum_steps=runner.accum_steps,
            compute_dtype=dtype, attn_impl=impl)
        tag = "f32" if dtype == torch.float32 else "bf16"
        profile_calls(f"grad step B=4 T=768 {tag} attn={impl}",
                      lambda: step(runner.params, batch, runner.rng), gpu)


def hubert_cfg(impl: str):
    """HuBERT-base from configs/hubert/config_model.yaml with the given
    conv_frontend_impl."""
    from speech_ssl_compression_tpu_torch.configs import hubert_config_from_yaml

    return dataclasses.replace(hubert_config_from_yaml(HUBERT_YAML),
                               conv_frontend_impl=impl)


def conv_layer_shapes(b: int, t_wave: int, conv_layers):
    """(B, T_in, C, K, O, stride) of the frontend layers the conv kernels
    take (both channel counts multiples of 128)."""
    shapes, t, c = [], t_wave, 1
    for dim, k, s in conv_layers:
        if c % 128 == 0 and dim % 128 == 0:
            shapes.append((b, t, c, k, dim, s))
        t, c = (t - k) // s + 1, dim
    return shapes


def conv_work(shape, dtype):
    """{kernel: (FLOPs, bytes)} at one layer shape: 2 B T_out K C O FLOPs
    each; bytes for every input read once and every output written once
    (dW written in f32)."""
    b, t, c, k, o, s = shape
    t_out = (t - k) // s + 1
    flops = 2.0 * b * t_out * k * c * o
    size = torch.tensor([], dtype=dtype).element_size()
    x, w, y = b * t * c * size, k * c * o * size, b * t_out * o * size
    return {"conv1d_fwd": (flops, x + w + y),
            "conv1d_dw": (flops, x + y + k * c * o * 4),
            "conv1d_dx": (flops, y + w + x)}


def halves_rounded(x, w, dy, stride):
    """The control of the bf16 conv check, (forward, dW, dX): the plain
    sums with the two halves of their reduction each rounded to bf16 before
    the final add (forward: channels; dW: time, or the batch where there is
    one output row; dX: outputs)."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    dt = x.dtype
    c, o = x.shape[2], w.shape[2]
    fwd = (tc.conv1d_strided_plain(x[..., :c // 2], w[:, :c // 2], stride)
           .float() + tc.conv1d_strided_plain(x[..., c // 2:],
                                              w[:, c // 2:], stride).float())
    dx = sum(tc.plain_grads(x, w[..., half], stride, dy[..., half])[0].float()
             for half in (slice(0, o // 2), slice(o // 2, o)))
    h = dy.shape[1] // 2
    k = w.shape[0]
    if h:
        x_lo = x[:, : (h - 1) * stride + k]
        dw = (tc.plain_grads(x_lo, w, stride, dy[:, :h])[1].float()
              + tc.plain_grads(x[:, h * stride:], w, stride,
                               dy[:, h:])[1].float())
    else:  # one output row: the halves of the batch
        h = x.shape[0] // 2
        dw = (tc.plain_grads(x[:h], w, stride, dy[:h])[1].float()
              + tc.plain_grads(x[h:], w, stride, dy[h:])[1].float())
    return fwd.to(dt), dw.to(dt), dx.to(dt)


def conv_kernels(x, w, dy, stride):
    """(forward, dW, dX) of the conv kernels: their launchers, or past
    SM90_MAX_STRIDE conv1d_strided (the stride folded into the channels)
    and autograd through it, as the frontend takes such a layer (dW then
    comes in w's dtype)."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    k, t = w.shape[0], x.shape[1]
    if stride <= tc.SM90_MAX_STRIDE:
        return (tc.launch_fwd(x, w, stride), tc.launch_dw(x, dy, k, stride),
                tc.launch_dx(dy, w, t, stride))
    xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
    with torch.enable_grad():
        y = tc.conv1d_strided(xx, ww, stride)
        dx, dw = torch.autograd.grad(y, (xx, ww), dy)
    return y.detach(), dw, dx


def check_conv(name, shape, dtype, gen, record=None):
    """One case of the conv kernels against their plain version: f32
    against the plain version in float64 (each kernel bitwise repeatable;
    the worst max |d| of each kernel into ``record``), bf16 within one ulp
    and BF16_SHARE_BAR differing, with a control that must fail the share;
    dX zero past the last row an output reaches. Logs the comparison,
    raises where they disagree, and returns (x, w, dy)."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc

    names = ("conv1d_fwd", "conv1d_dw", "conv1d_dx")
    b, t, c, k, o, s = shape
    t0 = time.perf_counter()
    x = torch.randn((b, t, c), generator=gen, device=gen.device).to(dtype)
    w = (torch.randn((k, c, o), generator=gen, device=gen.device)
         / (k * c) ** 0.5).to(dtype)
    dy = torch.randn((b, tc.output_length(t, k, s), o), generator=gen,
                     device=gen.device).to(dtype)
    got = conv_kernels(x, w, dy, s)
    got_y = got[0]
    torch.cuda.synchronize()
    last = (got_y.shape[1] - 1) * s + k
    tail_zero = bool((got[2][:, last:] == 0).all())
    tag = "f32" if dtype == torch.float32 else "bf16"
    if dtype == torch.float32:
        x64, w64, dy64 = x.double(), w.double(), dy.double()
        ref = ((tc.conv1d_strided_plain(x64, w64, s),)
               + tuple(reversed(tc.plain_grads(x64, w64, s, dy64))))
        errs = [rel_err(got[0], ref[0], ...), rel_l2(got[1], ref[1], ...),
                rel_err(got[2], ref[2], ...)]
        # the split-TF32 forward, dW and dX give the same bits again
        repeat = all(map(torch.equal, conv_kernels(x, w, dy, s), got))
        ok = max(errs) < CONV_F32_BAR and repeat
        detail = (f"fwd max|d|/mean|ref| {errs[0]:.3e}, dW rel L2 "
                  f"{errs[1]:.3e} (max|d|/mean|ref| "
                  f"{rel_err(got[1], ref[1], ...):.3e}), dX max|d|/"
                  f"mean|ref| {errs[2]:.3e} (bar {CONV_F32_BAR:g}); "
                  f"fwd, dW and dX bitwise repeatable: {repeat}")
        for n, g, r in zip(names, got, ref if record is not None else ()):
            rec = record[n]
            rec["max_abs_err"] = max(rec["max_abs_err"], float(
                (g.double() - r).abs().max()))
    else:
        ref_y = tc.conv1d_strided_plain(x, w, s)
        ref_dx, ref_dw = tc.plain_grads(x, w, s, dy)
        ref = (ref_y, ref_dw, ref_dx)
        # the tensor-core forward, dW and dX give the same bits again
        repeat = all(map(torch.equal, conv_kernels(x, w, dy, s), got))
        got = (got[0], got[1].to(dtype), got[2])
        diffs = [bf16_diff(g, r, ...) for g, r in zip(got, ref)]
        ctl = [bf16_diff(cc, r, ...)[0]
               for cc, r in zip(halves_rounded(x, w, dy, s), ref)]
        ok = repeat and all(u <= BF16_ULP_BAR and sh < BF16_SHARE_BAR
                            for sh, u in diffs)
        detail = ", ".join(
            f"{n[7:]} differ {sh:.3%} max {u:g} ulp (control "
            f"{cs:.2%})" for n, (sh, u), cs in zip(names, diffs, ctl))
        detail += (f"; bars {BF16_SHARE_BAR:.0%}, {BF16_ULP_BAR:g} "
                   f"ulp; fwd, dW and dX bitwise repeatable: "
                   f"{repeat}")
        if not all(cs >= BF16_SHARE_BAR for cs in ctl):
            raise AssertionError(
                f"bf16 conv check at {name} cannot tell kernels that "
                "round inside their sums apart")
    finite = all(torch.isfinite(g.float()).all() for g in got)
    log("conv", f"{name} {tag} x{(b, t, c)} K={k} s={s} O={o}: "
        f"kernels vs plain, {detail}; dX zero past row {last}: "
        f"{tail_zero}, {time.perf_counter() - t0:.2f} s")
    if not (ok and finite and tail_zero):
        raise AssertionError(f"conv kernels disagree at {name} {tag}")
    return x, w, dy


def phase_conv(dev, gpu: str):
    """The three conv kernels against their plain version (and cuDNN's
    time) at the training batch's layer shapes, at T = 777 / 515, at
    CONV_EDGE_CASES and, through the stride fold, at CONV_FOLD_CASES.
    Returns the record for the kernels line: per kernel the worst f32
    max |d| and, summed over the six training layers, kernel, plain,
    library and bound ms in f32 and (keys ending in _bf16) in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train = conv_layer_shapes(*HUBERT_TRAIN, hubert_cfg("tc_pallas")
                              .conv_feature_layers)
    cases = [(f"layer{i + 1}", s) for i, s in enumerate(train)]
    cases += [("t777", (2, 777, 512, 2, 512, 2)),
              ("t515", (2, 515, 512, 3, 512, 2)), *CONV_EDGE_CASES,
              *CONV_FOLD_CASES]
    names = ("conv1d_fwd", "conv1d_dw", "conv1d_dx")
    sums = ("ms", "plain_ms", "library_ms", "bound_ms", "ops_ms")
    record = {n: dict(max_abs_err=0.0, **{k + sfx: 0.0 for k in sums
                                          for sfx in ("", "_bf16")})
              for n in names}
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = check_conv(name, shape, dtype, gen, record)
            tag = "f32" if dtype == torch.float32 else "bf16"
            if name.startswith("layer"):
                conv_timing(shape, x, w, dy, tag, record, gpu)
    for n in names:
        rec = record[n]
        for sfx, tag in (("", "f32"), ("_bf16", "bf16")):
            rec["bound_by" + sfx] = (
                "operations" if rec.pop("ops_ms" + sfx) >= rec["bound_ms" + sfx]
                else "bytes")
            log("timing", f"{n}, HuBERT frontend layers 1-6 at B="
                f"{HUBERT_TRAIN[0]} x {HUBERT_TRAIN[1]} samples, {tag} summed: "
                f"kernel {rec['ms' + sfx]:.3f} ms, plain "
                f"{rec['plain_ms' + sfx]:.3f} ms, cuDNN "
                f"{rec['library_ms' + sfx]:.3f} ms, bound "
                f"{rec['bound_ms' + sfx]:.3f} ms ({rec['bound_by' + sfx]}) "
                f"[{gpu}]")
    return record


def conv_timing(shape, x, w, dy, tag, record, gpu: str):
    """CUDA-event times at one layer shape: each kernel against its plain
    version (dW and dX: autograd through the plain forward, which that
    includes) in turns, and cuDNN's call for the same function on the
    (B, C, T) / (O, C, K) layout (the transposes are made beforehand).
    Times and bounds add into ``record``, bf16's under keys ending in
    _bf16."""
    from torch.nn.grad import conv1d_input, conv1d_weight
    import torch.nn.functional as F
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.utils.flops import peak_flops

    b, t, c, k, o, s = shape
    x_nct = x.transpose(1, 2).contiguous()
    w_oik = w.permute(2, 1, 0).contiguous()
    dy_nct = dy.transpose(1, 2).contiguous()

    def plain_grad(wrt):
        def run():
            with torch.enable_grad():
                xx = x.detach().requires_grad_(wrt == "x")
                ww = w.detach().requires_grad_(wrt == "w")
                y = tc.conv1d_strided_plain(xx, ww, s)
                return torch.autograd.grad(y, xx if wrt == "x" else ww, dy)
        return run

    runs = {
        "conv1d_fwd": (lambda: tc.launch_fwd(x, w, s),
                       lambda: tc.conv1d_strided_plain(x, w, s),
                       lambda: F.conv1d(x_nct, w_oik, stride=s)),
        "conv1d_dw": (lambda: tc.launch_dw(x, dy, k, s), plain_grad("w"),
                      lambda: conv1d_weight(x_nct, w_oik.shape, dy_nct,
                                            stride=s)),
        "conv1d_dx": (lambda: tc.launch_dx(dy, w, t, s), plain_grad("x"),
                      lambda: conv1d_input(x_nct.shape, w_oik, dy_nct,
                                           stride=s)),
    }
    work = conv_work(shape, x.dtype)
    for name, (kernel, plain, library) in runs.items():
        kernel_ms, plain_ms = alternate(kernel, plain, inner=3)
        library_ms = cuda_ms(library, inner=3)
        bound_ms, by = bound(*work[name], x.dtype)
        log("timing", f"{name} {tag} x{(b, t, c)} K={k} s={s}: kernel "
            f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({by}) [{gpu}]")
        rec, sfx = record[name], "" if tag == "f32" else "_bf16"
        rec["ms" + sfx] += kernel_ms
        rec["plain_ms" + sfx] += plain_ms
        rec["library_ms" + sfx] += library_ms
        rec["bound_ms" + sfx] += bound_ms
        rec["ops_ms" + sfx] += work[name][0] / peak_flops(x.dtype) * 1e3


def cudnn_grouped(x, w, groups: int, pad: tuple, bias=None):
    """The route every grouped pos-conv took before ops/grouped_conv.py:
    F.conv1d in x's dtype on the (K, C/G, O) weight, pad (lo, lo) (its
    bf16 sums rounded to bf16), and autograd's cuDNN backward. The grouped
    conv phase times the module against it and takes its bf16 forward as
    a control; no path of the port calls it."""
    import torch.nn.functional as F

    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), bias,
                    padding=pad[0], groups=groups).transpose(1, 2)


def cudnn_samepad(x, w, bias, groups: int, kernel_size: int):
    """models/encoder.py::_grouped_conv_samepad as it was on cudnn_grouped:
    the torch (D, D/g, K) weight, the bias inside the conv, the SamePad
    crop."""
    half = kernel_size // 2
    out = cudnn_grouped(x, w.to(x.dtype).permute(2, 1, 0), groups,
                        (half, half), bias.to(x.dtype))
    return out[:, :-1] if kernel_size % 2 == 0 else out


@contextlib.contextmanager
def cudnn_pos_conv():
    """Every grouped pos-conv of the encoder on cudnn_samepad for the
    duration. Yields the list its calls append to."""
    from speech_ssl_compression_tpu_torch.models import encoder

    calls = []

    def route(*args):
        calls.append(1)
        return cudnn_samepad(*args)

    saved = encoder._grouped_conv_samepad
    encoder._grouped_conv_samepad = route
    try:
        yield calls
    finally:
        encoder._grouped_conv_samepad = saved


def grouped_conv_taps(x, w, dy, groups: int, pad: tuple):
    """The grouped conv's plain version, (forward, dX, dW) of x (B, T, C),
    w (K, C/G, O) and dy (B, T_out, O), one einsum per tap, in x's dtype
    (the phase runs it in float64)."""
    import torch.nn.functional as F

    b, t, c = x.shape
    k, cg, o = w.shape
    og = o // groups
    xp = F.pad(x, (0, 0, *pad)).reshape(b, -1, groups, cg)
    t_out = xp.shape[1] - k + 1
    wg = w.reshape(k, cg, groups, og)
    dyg = dy.reshape(b, t_out, groups, og)
    y = xp.new_zeros((b, t_out, groups, og))
    dxp = torch.zeros_like(xp)
    dw = xp.new_empty((k, cg, groups, og))
    for j in range(k):
        xs = xp[:, j:j + t_out]
        y += torch.einsum("btgi,igo->btgo", xs, wg[j])
        dxp[:, j:j + t_out] += torch.einsum("btgo,igo->btgi", dyg, wg[j])
        dw[j] = torch.einsum("btgi,btgo->igo", xs, dyg)
    dx = dxp[:, pad[0]:pad[0] + t].reshape(b, t, c)
    return y.reshape(b, t_out, o), dx, dw.reshape(k, cg, o)


def check_grouped_conv(name, shape, dtype, gen):
    """One case of ops/grouped_conv.py against its plain version run in
    float64 on the same operands (TF32 off around the call). f32:
    forward, dX and dW within GC_BAR. bf16 inputs: the f32 forward and
    the f32 dW sums (grouped_conv1d_dw, whose cast autograd's dW is, bit
    for bit) within GC_BAR, dX within BF16_ULP_BAR ulps, f32 out and the
    gradients in bf16.
    Planted controls must fail the forward's bar: one tap dropped, and for
    bf16 the old route's forward (its sums rounded to bf16). dy is any f32,
    as a bf16 input's f32 output may get. Raises where a bar fails or a
    control passes; returns (x, w, dy) and {"errors": ..., "controls": ...},
    each rel. L2 by name."""
    from speech_ssl_compression_tpu_torch.ops.grouped_conv import (
        grouped_conv1d, grouped_conv1d_dw,
    )
    from speech_ssl_compression_tpu_torch.utils.device import matmul_precision

    b, t, c, g, k, pad = shape
    t0 = time.perf_counter()
    x = torch.randn((b, t, c), generator=gen, device=gen.device).to(dtype)
    w = (torch.randn((k, c // g, c), generator=gen, device=gen.device)
         / (k * c // g) ** 0.5).to(dtype)
    dy = torch.randn((b, t + pad[0] + pad[1] - k + 1, c), generator=gen,
                     device=gen.device)
    bf16 = dtype == torch.bfloat16
    with matmul_precision("highest"), torch.enable_grad():
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = grouped_conv1d(xx, ww, g, pad)
        dx, dw = torch.autograd.grad(y, (xx, ww), dy)
    with matmul_precision("highest"):
        sums = grouped_conv1d_dw(x, dy, k, g, pad)
        w_drop = w.clone()
        w_drop[k // 2] = 0
        controls = {"one tap dropped": grouped_conv1d(x, w_drop, g, pad)}
        if bf16:
            controls["bf16 sums"] = cudnn_grouped(x, w, g, pad)
    y = y.detach()
    ref_y, ref_dx, ref_dw = grouped_conv_taps(x.double(), w.double(),
                                              dy.double(), g, pad)
    errs = {"fwd": rel_l2(y, ref_y, ...),
            "dW": rel_l2(sums if bf16 else dw, ref_dw, ...)}
    ok = all(torch.isfinite(a.float()).all() for a in (y, dx, dw))
    if bf16:
        ulps = float(((dx.double() - ref_dx).abs() / bf16_ulp(ref_dx)).max())
        cast = torch.equal(dw, sums.to(dtype))
        ok &= (ulps <= BF16_ULP_BAR and cast and y.dtype == torch.float32
               and dx.dtype == dw.dtype == dtype)
        extra = (f", dX max {ulps:.3f} ulp (bar {BF16_ULP_BAR:g}), dW the "
                 f"f32 sums' cast: {cast}, out {y.dtype}")
    else:
        errs["dX"] = rel_l2(dx, ref_dx, ...)
        ok &= y.dtype == dx.dtype == dw.dtype == dtype
        extra = ""
    ok &= all(e < GC_BAR for e in errs.values())
    ctl = {n: rel_l2(v, ref_y, ...) for n, v in controls.items()}
    tag = "bf16" if bf16 else "f32"
    log("grouped conv", f"{name} {tag} x{(b, t, c)} G={g} K={k} pad={pad}: "
        f"module vs float64, rel. L2 "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (bar {GC_BAR:g}){extra}; controls "
        + ", ".join(f"{n} {e:.3e}" for n, e in ctl.items())
        + f" (must fail the bar), {time.perf_counter() - t0:.2f} s")
    if any(e < GC_BAR for e in ctl.values()):
        raise AssertionError(f"grouped conv check at {name} {tag} passes "
                             f"a planted control: {ctl}")
    if not ok:
        raise AssertionError(f"grouped conv disagrees at {name} {tag}")
    return (x, w, dy), dict(errors=errs, controls=ctl)


def grouped_conv_timing(name, shape, x, w, dy, gpu: str) -> dict:
    """CUDA-event times at one shape, the module against cudnn_grouped in
    turns (medians of 3, TF32 off): the
    forward, and the forward and backward (dX and dW), with the bound of
    each, 2 B T_out C (C/G) K FLOPs a pass at the dtype's peak (or its
    bytes over HBM bandwidth, where larger)."""
    from speech_ssl_compression_tpu_torch.ops.grouped_conv import (
        grouped_conv1d,
    )
    from speech_ssl_compression_tpu_torch.utils.device import matmul_precision

    b, t, c, g, k, pad = shape
    t_out = dy.shape[1]
    flops = 2.0 * b * t_out * c * (c // g) * k
    size, out_size = x.element_size(), dy.element_size()
    io = {"x": x.numel() * size, "w": w.numel() * size,
          "y": dy.numel() * out_size}
    fwd_bytes = io["x"] + io["w"] + io["y"]
    dys = {grouped_conv1d: dy, cudnn_grouped: dy.to(x.dtype)}

    def fwd(route):
        return lambda: route(x, w, g, pad)

    def fwd_bwd(route):
        def run():
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                ww = w.detach().requires_grad_()
                torch.autograd.grad(route(xx, ww, g, pad), (xx, ww),
                                    dys[route])
        return run

    tag = "bf16" if x.dtype == torch.bfloat16 else "f32"
    rec = {}
    with matmul_precision("highest"):
        for what, make, passes, n_bytes in (
                ("fwd", fwd, 1, fwd_bytes),
                # the backward reads dy, x and w and writes dX and dW
                ("fwd+bwd", fwd_bwd, 3,
                 2 * fwd_bytes + io["x"] + io["w"])):
            mod_ms, old_ms = alternate(make(grouped_conv1d),
                                       make(cudnn_grouped))
            bound_ms, by = bound(passes * flops, n_bytes, x.dtype)
            rec[what] = dict(ms=mod_ms, cudnn_ms=old_ms, bound_ms=bound_ms,
                             bound_by=by)
            log("timing", f"grouped conv {what} {name} {tag} x{(b, t, c)} "
                f"G={g} K={k}: module {mod_ms:.3f} ms, F.conv1d autograd "
                f"route {old_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}; "
                f"{passes * flops / 1e9:.1f} GFLOP) [{gpu}]")
    return rec


def phase_grouped_conv(dev, gpu: str) -> dict:
    """ops/grouped_conv.py at GC_CASES, f32 and bf16: each case checked
    against float64 with its planted controls (check_grouped_conv), then
    timed against the F.conv1d route (grouped_conv_timing). Returns
    {(case, dtype tag): times, the check's errors and controls}."""
    gen = torch.Generator(device=dev).manual_seed(5)
    record = {}
    for name, shape in GC_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args, check = check_grouped_conv(name, shape, dtype, gen)
            tag = "f32" if dtype == torch.float32 else "bf16"
            record[name, tag] = dict(check, **grouped_conv_timing(
                name, shape, *args, gpu))
            del args
    return record


def grouped_conv_serve(extractors, wavs, gpu: str) -> None:
    """The f32 serve batch from features (phase_timing's encoder call) on
    the module and on cudnn_pos_conv, one CUDA-event median of 3 each."""
    ext = extractors["f32", "kernel"]
    feat, pad_mask, lengths = ext.featurize(wavs)

    def run():
        return ext._pack_and_dispatch(feat, pad_mask, lengths)

    def cudnn():
        with cudnn_pos_conv():
            return run()

    with cudnn_pos_conv() as calls:
        run()
    if not calls:
        raise AssertionError("the serve batch took no grouped pos-conv")
    mod_ms, old_ms = alternate(run, cudnn, turns=1)
    frames = sum(SERVE_LENGTHS)
    log("timing", f"grouped conv: f32 serve batch from features, pos-conv "
        f"module {mod_ms:.2f} ms ({frames / mod_ms * 1e3:.0f} frames/s), "
        f"F.conv1d route {old_ms:.2f} ms ({frames / old_ms * 1e3:.0f} "
        f"frames/s) [{gpu}]")


def grouped_conv_grad_step(runner, batch, gpu: str) -> None:
    """The bf16 MelHuBERT grad step (B = 4, T = 768) on the module and on
    cudnn_pos_conv, one time each after a warm-up (the train phase's
    yardstick order)."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    step = make_melhubert_grad_step(runner.model,
                                    accum_steps=runner.accum_steps,
                                    compute_dtype=torch.bfloat16)

    def run():
        return step(runner.params, batch, runner.rng)

    def cudnn():
        with cudnn_pos_conv() as calls:
            run()
        if not calls:
            raise AssertionError("the grad step took no grouped pos-conv")

    mod_ms, old_ms = alternate(run, cudnn, reps=1, turns=1)
    log("timing", f"grouped conv: bf16 grad step B=4 T=768, pos-conv module "
        f"{mod_ms:.2f} ms, F.conv1d route {old_ms:.2f} ms [{gpu}]")


def launch_counts():
    """Every kernel's launch count, attention and conv."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    return {**fa.launch_counts, **tc.launch_counts}


def dtype_launch_counts():
    """Every kernel's launch count per input dtype: {name: {"f32": n,
    "bf16": n}}, a copy."""
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    return {name: dict(counts) for name, counts in
            {**fa.dtype_launch_counts, **tc.dtype_launch_counts}.items()}


def reset_launch_counts():
    from speech_ssl_compression_tpu_torch.ops import conv1d as tc
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    tc.reset_launch_counts()


def hubert_source(b: int, t_wave: int, seed: int):
    """(source (B, T) f32 normal noise, as train/wave_bench.py makes it,
    host lengths): the rows are cut to a mix of lengths, zero past each."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, t_wave)).astype(np.float32)
    lengths = np.full(b, t_wave, np.int64)
    lengths[1::2] = t_wave - rng.integers(t_wave // 32, t_wave // 2, b // 2)
    src[np.arange(t_wave)[None, :] >= lengths[:, None]] = 0.0
    return src, lengths


def phase_hubert_serve(dev, gpu: str):
    """HuBERT-base extraction at the bench's batch: returns the launch
    counts of the one main-path call per dtype."""
    import copy

    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.hubert import hubert_forward
    from speech_ssl_compression_tpu_torch.utils.weights import (
        init_hubert_params_np, load_wave_model,
    )

    t0 = time.perf_counter()
    cfg = hubert_cfg("tc_pallas")
    params = init_hubert_params_np(cfg, (HUBERT_CLASSES,), seed=0)
    models = {"kernels": load_wave_model(params, cfg, "hubert"),
              "cudnn": load_wave_model(
                  params, dataclasses.replace(cfg, conv_frontend_impl="auto"),
                  "hubert")}
    for m in models.values():
        m.to(dev).eval().requires_grad_(False)
    b, t_wave = HUBERT_SERVE
    src_np, lengths = hubert_source(b, t_wave, seed=0)
    src = torch.from_numpy(src_np).to(dev)
    n_params = sum(p.numel() for p in models["kernels"].parameters())
    log("hubert serve", f"HuBERT-base {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {n_params} params, {b} x {t_wave} samples "
        f"(lengths {lengths.tolist()}), {time.perf_counter() - t0:.2f} s")

    def run(model, dtype=torch.float32):
        with matmul_precision("highest"), torch.inference_mode():
            return hubert_forward(model, src.to(dtype), lengths, mask=False,
                                  features_only=True)

    # the main path: counts from exactly one hubert_forward call
    t0 = time.perf_counter()
    reset_launch_counts()
    out = run(models["kernels"])
    torch.cuda.synchronize()
    counts = launch_counts()
    by_dtype = dtype_launch_counts()
    want = dict(conv1d_fwd=len(conv_layer_shapes(b, t_wave,
                                                 cfg.conv_feature_layers)),
                flash_attn_fwd=cfg.encoder_layers)
    log("hubert serve", f"hubert_forward(features_only=True) f32: x "
        f"{tuple(out['x'].shape)}, launches {counts} (expected {want}, the "
        f"rest 0), {time.perf_counter() - t0:.2f} s")
    if counts != {**dict.fromkeys(counts, 0), **want}:
        raise AssertionError(f"hubert serve launches {counts}")
    valid = ~out["padding_mask"]
    frames = int(valid.sum())
    if not all(torch.isfinite(out[k].float()[valid]).all()
               for k in ("x", "features")):
        raise AssertionError("non-finite HuBERT output")

    ref = run(models["cudnn"])
    errs = {k: rel_err(out[k], ref[k], valid) for k in ("x", "features")}
    log("hubert serve", f"conv kernels vs cuDNN (f32, TF32 off), valid "
        f"frames: encoder output max|d|/mean|ref| {errs['x']:.3e}, frontend "
        f"features {errs['features']:.3e} (bar {SLICE_BAR:g})")
    if not max(errs.values()) < SLICE_BAR:
        raise AssertionError("HuBERT with the conv kernels disagrees with cuDNN")

    for name in list(models):
        models[name + " bf16"] = copy.deepcopy(models[name]).to(torch.bfloat16)
    out_bf16 = run(models["kernels bf16"], torch.bfloat16)
    err_bf16 = rel_l2(out_bf16["x"], out["x"], valid)
    log("hubert serve", f"bf16 vs f32, encoder output: |d|_2/|ref|_2 "
        f"{err_bf16:.3e} (bar {BF16_SLICE_BAR:g})")
    if not (err_bf16 < BF16_SLICE_BAR
            and torch.isfinite(out_bf16["x"].float()[valid]).all()):
        raise AssertionError("HuBERT bf16 output disagrees with f32")
    del out, ref, out_bf16

    for dtype in (torch.float32, torch.bfloat16):
        tag = "" if dtype == torch.float32 else " bf16"
        k_ms, c_ms = alternate(lambda: run(models["kernels" + tag], dtype),
                               lambda: run(models["cudnn" + tag], dtype),
                               reps=1)
        log("timing", f"hubert_forward {dtype} B={b} x {t_wave} samples: "
            f"conv kernels {k_ms:.2f} ms ({frames / k_ms * 1e3:.0f} frames/s)"
            f", cuDNN {c_ms:.2f} ms ({frames / c_ms * 1e3:.0f} frames/s), "
            f"{frames} valid frames [{gpu}]")
    return by_dtype


def write_wav_dataset(root: pathlib.Path, n_utts: int, min_samples: int,
                      seed: int = 0):
    """A HuBERT pre-training set as tests/test_wave_runner.py builds one: a
    TSV manifest of 16 kHz WAVs up to 2 s longer than ``min_samples`` (the
    crop), train.km with 50 Hz labels < 500 and dict.km.txt."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lines, labels = [], []
    for i in range(n_utts):
        n = min_samples + int(rng.integers(0, 32000))
        pcm = (rng.uniform(-0.3, 0.3, n) * 32767).astype(np.int16)
        wavfile.write(root / f"u{i}.wav", 16000, pcm)
        lines.append(f"u{i}.wav\t{n}")
        labels.append(" ".join(map(str, rng.integers(0, 500, n // 320))))
    (root / "train.tsv").write_text(f"{root}\n" + "\n".join(lines) + "\n")
    (root / "train.km").write_text("\n".join(labels) + "\n")
    (root / "dict.km.txt").write_text("".join(f"{c} 1\n" for c in range(500)))


HUBERT_RUNNER_YAML = """runner:
  total_steps: 3
  gradient_clipping: 10.0
  gradient_accumulate_steps: {accum}
  log_step: 1
  save_every_x_epochs: 10
  bf16: true
optimizer:
  lr: 0.0005
  betas:
  - 0.9
  - 0.98
  eps: 1.0e-06
  weight_decay: 0.01
datarc:
  train_batch_size: {batch}
task:
  data: {data}
  labels:
  - km
  label_rate: 50
  sample_rate: 16000
  max_sample_size: {samples}
  min_sample_size: 32000
  pad_audio: false
  random_crop: true
"""


def hubert_bench_batch(runner, dev, seed: int = 0):
    """The bench recipe's batch (train/wave_bench.py): B x 245,760 samples
    of normal noise, full lengths, uniform random targets."""
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length,
    )

    b, t_wave = HUBERT_TRAIN
    rng = np.random.default_rng(seed)
    t_frames = conv_output_length(t_wave, runner.cfg.conv_feature_layers)
    return {
        "source": torch.from_numpy(rng.standard_normal((b, t_wave))
                                   .astype(np.float32)).to(dev),
        "length": np.full(b, t_wave),
        "target_list": [torch.from_numpy(rng.integers(
            0, runner.num_classes[0], (b, t_frames))).to(dev)],
        "target_valid": torch.ones((b, t_frames), dtype=torch.bool,
                                   device=dev),
    }


def phase_hubert_train(dev, gpu: str, tmp: str):
    """HuBERT-base pre-training through the trainer's entry point, then the
    checks on its model. Returns (runner, launch counts of the run per
    dtype, the cuDNN-route model, the bench batch)."""
    from speech_ssl_compression_tpu_torch.configs import HuBERTConfig
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.hubert import (
        HuBERTModel, span_mask,
    )
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_hubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import load_wave_model

    t0 = time.perf_counter()
    b, t_wave = HUBERT_TRAIN
    root = pathlib.Path(tmp) / "hubert"
    write_wav_dataset(root / "data", 3 * HUBERT_ACCUM * b, t_wave)
    # the model config as shipped, with the kernel route and without
    # LayerDrop, so that every grad step runs all 12 layers' kernels
    text = HUBERT_YAML.read_text()
    if "encoder_layerdrop: 0.05" not in text:
        raise AssertionError(f"{HUBERT_YAML} changed: update this phase")
    model_yaml = root / "config_model.yaml"
    model_yaml.write_text(text.replace("encoder_layerdrop: 0.05",
                                       "encoder_layerdrop: 0.0")
                          + "  conv_frontend_impl: tc_pallas\n")
    runner_yaml = root / "config_runner.yaml"
    runner_yaml.write_text(HUBERT_RUNNER_YAML.format(
        accum=HUBERT_ACCUM, batch=b, data=root / "data", samples=t_wave))
    expdir = root / "exp"
    log("hubert train", f"synthetic set written ({3 * HUBERT_ACCUM * b} "
        f"WAVs, labels < 500), {time.perf_counter() - t0:.2f} s")

    # the main path: counts from exactly one run of the trainer
    t0 = time.perf_counter()
    reset_launch_counts()
    runner = train(["-m", "melhubert", "-u", "hubert", "-g", str(model_yaml),
                    "-c", str(runner_yaml), "-n", str(expdir), "--device",
                    str(dev), "--seed", "0"])
    torch.cuda.synchronize()
    counts = launch_counts()
    by_dtype = dtype_launch_counts()
    cfg = runner.cfg
    steps = 3 * runner.accum_steps
    per_step = {k: v / steps for k, v in counts.items()}
    n_conv = len(conv_layer_shapes(b, t_wave, cfg.conv_feature_layers))
    want = {**dict.fromkeys(("conv1d_fwd", "conv1d_dw", "conv1d_dx"), n_conv),
            **dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                             "flash_attn_bwd_dkv"), cfg.encoder_layers)}
    log("hubert train", f"HuBERT-base {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {runner.num_classes[0]} classes, "
        f"{runner.compute_dtype}, 3 updates x {runner.accum_steps} "
        f"micro-batches of {b} x {t_wave} samples: launches per grad step "
        f"{per_step} (expected {want}), {time.perf_counter() - t0:.2f} s")
    if per_step != want:
        raise AssertionError(f"hubert train launches {counts}")
    hist = runner.log_history
    for entry in hist:
        log("hubert train", f"update {entry['step']}: loss {entry['loss']:.6f}"
            f", grad norm {entry['grad_norm']:.6f}")
    if [e["step"] for e in hist] != [1, 2, 3] or not all(
            np.isfinite([e["loss"], e["grad_norm"]]).all() for e in hist):
        raise AssertionError(f"trainer log {hist}")

    state = load_checkpoint(str(expdir / "last-step.npz"), load_opt=False)
    back = load_wave_model(state["params"],
                           HuBERTConfig.from_dict(state["meta"]["Config"]),
                           "hubert")
    same = all(torch.equal(v, runner.params[k].detach().cpu())
               for k, v in back.named_parameters())
    log("hubert train", f"last-step.npz read back: Step "
        f"{state['meta']['Step']}, weights equal to the trainer's: {same}")
    if not (same and state["meta"]["Step"] == 3):
        raise AssertionError("HuBERT checkpoint does not read back")

    # kernels vs cuDNN + dense attention: f32, TF32 off, no dropout, one
    # fixed span mask, the bench recipe's batch; both against that plain
    # route run in float64
    t0 = time.perf_counter()
    batch = hubert_bench_batch(runner, dev)
    t_frames = batch["target_valid"].shape[1]
    mask = torch.from_numpy(span_mask(cfg, np.full(b, t_frames), t_frames,
                                      np.random.default_rng(0))).to(dev)
    cudnn_model = HuBERTModel(dataclasses.replace(
        cfg, conv_frontend_impl="auto"), runner.num_classes).to(dev)
    results = {}
    for name, model, impl, dtype in (
            ("kernels", runner.model, "auto", torch.float32),
            ("cudnn+dense", cudnn_model, "dense", torch.float32),
            ("cudnn+dense f64", cudnn_model, "dense", torch.float64)):
        step = make_hubert_grad_step(model, attn_impl=impl, deterministic=True,
                                     compute_dtype=dtype)
        reset_launch_counts()
        with matmul_precision("highest"):
            loss, n, grads, _ = step(runner.params, batch, torch.Generator(),
                                     mask_indices=mask)
        torch.cuda.synchronize()
        results[name] = (float(loss), int(n), grads, launch_counts())
    (loss_k, n_k, grads_k, counts_k), (loss_d, n_d, grads_d, counts_d), (
        loss_64, n_64, grads_64, counts_64) = results.values()
    names = list(runner.params)

    def compare(loss, grads, ref_loss, ref_grads):
        errs = grad_errors(names, grads, ref_grads)
        worst = int(np.argmax(errs))
        return (abs(loss - ref_loss) / abs(ref_loss), errs[worst],
                names[worst])

    k64, d64, kd = (compare(loss_k, grads_k, loss_64, grads_64),
                    compare(loss_d, grads_d, loss_64, grads_64),
                    compare(loss_k, grads_k, loss_d, grads_d))
    log("hubert train", f"grad step (TF32 off, dropout off, fixed span mask, "
        f"{n_k} masked frames), loss rel and worst of {len(names)} "
        f"gradients rel L2: kernels vs cuDNN + impl='dense' in float64 "
        f"{k64[0]:.3e}, {k64[1]:.3e} ({k64[2]}), bar {GRAD_BAR:g}; the f32 "
        f"cuDNN + dense route vs float64 {d64[0]:.3e}, {d64[1]:.3e} "
        f"({d64[2]}); kernels vs the f32 cuDNN + dense route {kd[0]:.3e}, "
        f"{kd[1]:.3e} ({kd[2]}), bar {GRAD_BAR:g}; losses {loss_k:.6f}, {loss_d:.6f}, "
        f"{loss_64:.6f}; launches {counts_k}, {counts_d}, {counts_64}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (max(k64[:2]) < GRAD_BAR and max(kd[:2]) < GRAD_BAR
            and n_k == n_d == n_64):
        raise AssertionError("HuBERT kernel gradients disagree with the "
                             "plain route (float64 or f32)")
    if (counts_k != want or any(counts_d.values())
            or any(counts_64.values())):
        raise AssertionError("the HuBERT parity run took the wrong path")
    del results, grads_k, grads_d, grads_64
    return runner, by_dtype, cudnn_model, batch


def phase_hubert_train_timing(runner, cudnn_model, batch, gpu: str):
    """CUDA-event medians at the bench recipe: the grad step and one update
    (HUBERT_ACCUM grad steps + apply) with the conv kernels and with cuDNN,
    f32 (TF32 off) and bf16, dropout on."""
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.train.steps import (
        accumulate_grads, make_hubert_grad_step,
    )

    b, t_wave = HUBERT_TRAIN
    frames = int(batch["target_valid"].sum())
    models = {"conv kernels": runner.model, "cuDNN": cudnn_model}
    for dtype in (torch.float32, torch.bfloat16):
        steps = {name: make_hubert_grad_step(
            m, accum_steps=HUBERT_ACCUM, compute_dtype=dtype)
            for name, m in models.items()}

        def grad(name):
            return lambda: steps[name](runner.params, batch, runner.rng)

        def update(name):
            def run():
                acc, total = None, 0
                for _ in range(HUBERT_ACCUM):
                    _, n, grads, _ = steps[name](runner.params, batch,
                                                 runner.rng)
                    acc = accumulate_grads(acc, grads)
                    total = total + n
                runner.apply(acc, torch.clamp_min(total.float(), 1.0))
            return run

        with matmul_precision("highest"):
            k_ms, c_ms = alternate(grad("conv kernels"), grad("cuDNN"),
                                   reps=1, turns=1)
            ku_ms, cu_ms = alternate(update("conv kernels"), update("cuDNN"),
                                     reps=1, turns=1)
        log("timing", f"HuBERT grad step B={b} x {t_wave} samples {dtype}: "
            f"conv kernels {k_ms:.2f} ms, cuDNN {c_ms:.2f} ms; one update "
            f"({HUBERT_ACCUM} grad steps + apply): conv kernels {ku_ms:.2f} ms"
            f" ({1e3 / ku_ms:.3f} updates/s, "
            f"{HUBERT_ACCUM * frames / ku_ms * 1e3:.0f} frames/s), cuDNN "
            f"{cu_ms:.2f} ms ({1e3 / cu_ms:.3f} updates/s) [{gpu}]")


def phase_hubert_profile(runner, cudnn_model, batch, gpu: str):
    """The bf16 HuBERT grad step with the conv kernels and with cuDNN."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_hubert_grad_step,
    )

    for name, model in (("conv kernels", runner.model),
                        ("cuDNN", cudnn_model)):
        step = make_hubert_grad_step(model, accum_steps=HUBERT_ACCUM,
                                     compute_dtype=torch.bfloat16)
        profile_calls(f"HuBERT grad step bf16 {name}",
                      lambda: step(runner.params, batch, runner.rng), gpu)


def w2v2_batch(dev, b: int, t_wave: int, seed: int, short=None):
    """B x t_wave samples of uniform noise in [-0.3, 0.3) (the synthetic
    set's), row 1 cut to ``short`` valid samples when given."""
    rng = np.random.default_rng(seed)
    source = rng.uniform(-0.3, 0.3, (b, t_wave)).astype(np.float32)
    lengths = np.full(b, t_wave)
    if short is not None:
        source[1, short:] = 0.0
        lengths[1] = short
    return {"source": torch.from_numpy(source).to(dev), "length": lengths}


def w2v2_draws(cfg, batch, seed: int):
    """A fixed span mask, negative counts and Gumbel uniforms for a batch:
    (mask, counts, uniform, valid frames), all on its device."""
    from speech_ssl_compression_tpu_torch.models import wav2vec2 as w2v
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length, frame_lengths,
    )

    dev = batch["source"].device
    b, t_wave = batch["source"].shape
    t = conv_output_length(t_wave, cfg.conv_feature_layers)
    n = frame_lengths(batch["length"], cfg.conv_feature_layers, t)
    valid = torch.from_numpy(np.arange(t)[None, :] < n[:, None]).to(dev)
    mask = torch.from_numpy(w2v.span_mask(
        cfg, n, t, np.random.default_rng(seed))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    counts = w2v.sample_negative_counts(gen, mask & valid, cfg.num_negatives)
    uniform = torch.rand((b * t * cfg.latent_groups, cfg.latent_vars),
                         generator=gen, device=dev)
    return mask, counts, uniform, valid


def capture_attention(name: str = "dense_attention"):
    """Patches ``ops.attention.<name>`` (dense_attention or
    flash_attention) to keep, per call, [q, k, v, key padding, O] and, once
    the backward has run, the gradient dO of O (calls that record no graph
    keep none). Returns (the list it fills, a function that undoes the
    patch)."""
    from speech_ssl_compression_tpu_torch.ops import attention

    attend, captured = getattr(attention, name), []

    def capturing(q, k, v, *, key_padding_mask=None, **kwargs):
        o = attend(q, k, v, key_padding_mask=key_padding_mask, **kwargs)
        pad = (key_padding_mask if key_padding_mask is not None else
               torch.zeros(q.shape[0], q.shape[2], dtype=torch.bool,
                           device=q.device))
        entry = [q.detach(), k.detach(), v.detach(), pad, o.detach()]
        captured.append(entry)
        if o.requires_grad:
            o.register_hook(lambda g: entry.append(g.detach()))
        return o

    setattr(attention, name, capturing)

    def undo():
        setattr(attention, name, attend)

    return captured, undo


def ds_cancellation(captured):
    """Per encoder layer, from the float64 route's q, k, v, O and dO
    (dropout off): the softmax backward dS = P o (dP - D), dP = dO V^T,
    D = rowsum(dO o O), that the q and k gradients are made of. Returns
    [(|P o dP| / |dS|, the rel. L2 change of dS when P, dP and D are each
    rounded once to f32)] by layer: the first is how far dP and D cancel,
    the second what one f32 rounding of them does to dS."""
    norm = lambda t: float(torch.linalg.vector_norm(t))
    r = lambda t: t.float().double()
    out = []
    for q, k, v, pad, o, do in captured:
        s = (q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2)
        p = torch.softmax(s.masked_fill(pad[:, None, None, :],
                                        float("-inf")), -1)
        dp = do @ v.transpose(-1, -2)
        d = (do * o).sum(-1, keepdim=True)
        ds = p * (dp - d)
        out.append((norm(p * dp) / norm(ds),
                    norm(r(p) * (r(dp) - r(d)) - ds) / norm(ds)))
        del s, p, dp, ds
    return out


def phase_w2v2_train(dev, gpu: str, tmp: str):
    """wav2vec 2.0 base pre-training through the trainer's entry point at
    the shipped recipe, then the checks on its model. Returns (runner,
    launch counts of the run per dtype, the cuDNN-route model, a batch of
    the recipe's shape)."""
    import speech_ssl_compression_tpu_torch.models.encoder as encoder
    from speech_ssl_compression_tpu_torch.configs import Wav2Vec2Config
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_wav2vec2_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        load_wave_model,
    )

    t0 = time.perf_counter()
    b, t_wave = W2V2_TRAIN
    root = pathlib.Path(tmp) / "w2v2"
    write_wav_dataset(root / "data", 3 * b, t_wave)
    # the configs as shipped, with the conv kernels and 3 updates
    model_text = (W2V2_DIR / "config_model.yaml").read_text()
    runner_text = (W2V2_DIR / "config_runner.yaml").read_text()
    for text, old in ((runner_text, "total_steps: -1"),
                      (runner_text, "data: data/w2v_manifest"),
                      (runner_text, f"train_batch_size: {b}"),
                      (runner_text, f"max_sample_size: {t_wave}")):
        if old not in text:
            raise AssertionError(f"{W2V2_DIR} changed ({old!r}): update this "
                                 "phase")
    model_yaml, runner_yaml = root / "config_model.yaml", root / "runner.yaml"
    model_yaml.write_text(model_text + "  conv_frontend_impl: tc_pallas\n")
    runner_yaml.write_text(runner_text.replace(
        "total_steps: -1", "total_steps: 3").replace(
        "data: data/w2v_manifest", f"data: {root / 'data'}"))
    expdir = root / "exp"
    log("w2v2 train", f"synthetic set written ({3 * b} WAVs of >= {t_wave} "
        f"samples), {time.perf_counter() - t0:.2f} s")

    # the main path: counts from exactly one run of the trainer; the
    # encoder layers it ran (LayerDrop 0.05 skips some) are counted by a
    # wrapper around the layer forward
    t0 = time.perf_counter()
    layer_forward = encoder.encoder_layer_forward
    kept = []

    def counting(*args, **kwargs):
        kept.append(1)
        return layer_forward(*args, **kwargs)

    encoder.encoder_layer_forward = counting
    reset_launch_counts()
    try:
        runner = train(["-m", "melhubert", "-u", "wav2vec2", "-g",
                        str(model_yaml), "-c", str(runner_yaml), "-n",
                        str(expdir), "--device", str(dev), "--seed", "0"])
        torch.cuda.synchronize()
    finally:
        encoder.encoder_layer_forward = layer_forward
    counts, by_dtype = launch_counts(), dtype_launch_counts()
    cfg = runner.cfg
    steps = 3 * runner.accum_steps
    n_conv = len(conv_layer_shapes(b, t_wave, cfg.conv_feature_layers))
    want = {**dict.fromkeys(("conv1d_fwd", "conv1d_dw", "conv1d_dx"),
                            steps * n_conv),
            **dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                             "flash_attn_bwd_dkv"), len(kept))}
    log("w2v2 train", f"wav2vec 2.0 base {cfg.encoder_layers}L/"
        f"{cfg.encoder_embed_dim}, {cfg.latent_groups}x{cfg.latent_vars} "
        f"codebook, {cfg.num_negatives} negatives, {runner.compute_dtype}, "
        f"3 updates of B={b} x {t_wave} samples: {len(kept)} encoder layers "
        f"run in {steps} grad steps (LayerDrop {cfg.encoder_layerdrop}); "
        f"launches per grad step "
        f"{ {k: v / steps for k, v in counts.items()} } (expected "
        f"{ {k: v / steps for k, v in want.items()} }), per dtype {by_dtype}"
        f", {time.perf_counter() - t0:.2f} s")
    if counts != want or any(c["f32"] for c in by_dtype.values()):
        raise AssertionError(f"w2v2 train launches {counts}")
    hist = runner.log_history
    for entry in hist:
        log("w2v2 train", f"update {entry['step']}: loss {entry['loss']:.6f}"
            f", grad norm {entry['grad_norm']:.6f}")
    if [e["step"] for e in hist] != [3] or not all(
            np.isfinite([e["loss"], e["grad_norm"]]).all() for e in hist):
        raise AssertionError(f"trainer log {hist}")
    # the temperature the quantizer ran at in each grad step, against the
    # host's anneal of the update count (reference set_num_updates)
    t_max, t_min, decay = cfg.latent_temp
    want_temps = [(s, max(t_max * decay ** s, t_min)) for s in range(3)]
    log("w2v2 train", f"Gumbel temperature per grad step "
        f"{list(runner.temp_history)} (host anneal {want_temps})")
    if list(runner.temp_history) != want_temps:
        raise AssertionError("the Gumbel temperature is not annealed per step")

    # read back through the strict load of the weight bridge: every
    # parameter of the trainer's, none left over
    state = load_checkpoint(str(expdir / "last-step.npz"), load_opt=False)
    saved_cfg = Wav2Vec2Config.from_dict(state["meta"]["Config"])
    back = dict(load_wave_model(state["params"],
                                    saved_cfg, "wav2vec2").named_parameters())
    same = back.keys() == runner.params.keys() and all(
        torch.equal(v, runner.params[k].detach().cpu())
        for k, v in back.items())
    log("w2v2 train", f"last-step.npz read back: Step {state['meta']['Step']}"
        f", {len(back)} tensors bitwise the trainer's: {same}, its Config "
        f"the trainer's: {saved_cfg == cfg}")
    if not (same and saved_cfg == cfg and state["meta"]["Step"] == 3):
        raise AssertionError("wav2vec 2.0 checkpoint does not read back")
    del state, back

    # kernels vs cuDNN + dense attention: f32, TF32 off, dropouts off, one
    # fixed span mask, negative counts and Gumbel noise, B = 2 at full
    # width; both against that plain route run in float64
    t0 = time.perf_counter()
    pb, pt, short = W2V2_PARITY
    batch = w2v2_batch(dev, pb, pt, seed=1, short=short)
    nodrop = dataclasses.replace(
        cfg, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        dropout_input=0.0, dropout_features=0.0, encoder_layerdrop=0.0)
    mask, counts_fixed, uniform, valid = w2v2_draws(nodrop, batch, seed=2)
    kernel_model = Wav2Vec2Model(nodrop).to(dev)
    cudnn_model = Wav2Vec2Model(dataclasses.replace(
        nodrop, conv_frontend_impl="auto")).to(dev)
    # the witness of cancellation: every f32 master moved one ulp up or
    # down at random, run in float64 (no rounding of its own to speak of)
    gen = torch.Generator(device=dev).manual_seed(8)
    nudged = {}
    for k, v in runner.params.items():
        up = torch.rand(v.shape, generator=gen, device=dev) < 0.5
        nudged[k] = torch.where(
            up, torch.nextafter(v.detach(), torch.full_like(v, np.inf)),
            torch.nextafter(v.detach(), torch.full_like(v, -np.inf))
        ).requires_grad_(True)
    results = {}
    for name, model, impl, dtype, precision, params in (
            ("kernels", kernel_model, "auto", torch.float32, "highest",
             runner.params),
            ("cudnn+dense", cudnn_model, "dense", torch.float32, "highest",
             runner.params),
            ("cudnn+dense f64", cudnn_model, "dense", torch.float64,
             "highest", runner.params),
            # the control: the plain route with TF32 on must fail the bar
            ("cudnn+dense tf32", cudnn_model, "dense", torch.float32, "high",
             runner.params),
            ("cudnn+dense f64 nudged", cudnn_model, "dense", torch.float64,
             "highest", nudged)):
        step = make_wav2vec2_grad_step(model, attn_impl=impl,
                                       compute_dtype=dtype)
        if name == "cudnn+dense f64":
            captured, undo = capture_attention()
        reset_launch_counts()
        try:
            with matmul_precision(precision):
                loss, n, grads, logs = step(
                    params, batch, torch.Generator(), runner.temp_history[
                        -1][1], mask_indices=mask, gumbel_uniform=uniform,
                    negative_counts=counts_fixed)
            torch.cuda.synchronize()
        finally:
            if name == "cudnn+dense f64":
                undo()
        results[name] = (float(loss), int(n), grads, launch_counts(),
                         {k: float(v) for k, v in logs.items()})
    del nudged
    cancel = ds_cancellation(captured)
    del captured
    (loss_k, n_k, grads_k, counts_k, logs_k), (
        loss_d, n_d, grads_d, counts_d, logs_d), (
        loss_64, n_64, grads_64, counts_64, logs_64), (
        loss_t, _, grads_t, counts_t, logs_t), (
        _, _, grads_u, counts_u, _) = results.values()
    names = list(runner.params)

    def compare(loss, grads, logs, ref_loss, ref_grads, ref_logs):
        errs = grad_errors(names, grads, ref_grads)
        worst = int(np.argmax(errs))
        log_err = max(abs(logs[k] - ref_logs[k]) / max(abs(ref_logs[k]),
                                                       1e-30)
                      for k in ("loss_infonce", "loss_prob_perplexity",
                                "loss_features_pen"))
        return (abs(loss - ref_loss) / abs(ref_loss), errs[worst],
                names[worst], log_err, errs)

    k64 = compare(loss_k, grads_k, logs_k, loss_64, grads_64, logs_64)
    d64 = compare(loss_d, grads_d, logs_d, loss_64, grads_64, logs_64)
    kd = compare(loss_k, grads_k, logs_k, loss_d, grads_d, logs_d)
    t64 = compare(loss_t, grads_t, logs_t, loss_64, grads_64, logs_64)
    # how far one ulp of the weights moves each gradient, in float64
    nudge = grad_errors(names, grads_u, grads_64)
    # a gradient whose exact value is a small difference of large terms
    # (the last layers' q/k projections: a softmax row's dS sums to 0) is
    # missed by f32 arithmetic itself: the plain f32 route's own distance
    # from float64 there is the measure, and the one-ulp nudge shows
    # which gradients are so conditioned
    def beyond(errs):  # (name, distance, the f32 route's, the nudge's)
        return [(n, e, d, u) for n, e, d, u in zip(names, errs, d64[4],
                                                   nudge) if e >= GRAD_BAR]

    past, ctl_past = beyond(k64[4]), beyond(t64[4])
    grads_ok = all(e < W2V2_CANCEL_FACTOR * d for _, e, d, _ in past)
    ctl_ratio = max((e / max(d, 1e-30) for _, e, d, _ in ctl_past),
                    default=0.0)
    ctl_on_past = [t64[4][names.index(n)] / max(d, 1e-30)
                   for n, _, d, _ in past]
    order = np.argsort(nudge)[::-1]
    rank = {names[i]: r + 1 for r, i in enumerate(order)}
    want_parity = {**dict.fromkeys(("conv1d_fwd", "conv1d_dw", "conv1d_dx"),
                                   n_conv),
                   **dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                                    "flash_attn_bwd_dkv"), cfg.encoder_layers)}
    log("w2v2 train", f"grad step (B={pb} x {pt} samples, row 1 {short} "
        f"valid; TF32 off, dropouts off, fixed span mask, counts and Gumbel "
        f"noise, {n_k} masked frames), loss rel, worst of {len(names)} "
        f"gradients rel L2 and worst log rel: kernels vs cuDNN + "
        f"impl='dense' in float64 {k64[0]:.3e}, {k64[1]:.3e} ({k64[2]}), "
        f"{k64[3]:.3e}, bar {GRAD_BAR:g}; the f32 cuDNN + dense route vs "
        f"float64 {d64[0]:.3e}, {d64[1]:.3e} ({d64[2]}), {d64[3]:.3e}; "
        f"kernels vs the f32 cuDNN + dense route {kd[0]:.3e}, {kd[1]:.3e} "
        f"({kd[2]}), {kd[3]:.3e}; losses {loss_k:.6f}, {loss_d:.6f}, "
        f"{loss_64:.6f}; accuracy {logs_k['accuracy']:.4f}, "
        f"{logs_d['accuracy']:.4f}, {logs_64['accuracy']:.4f}; launches "
        f"{counts_k} (expected {want_parity}), {counts_d}, {counts_64}, "
        f"{time.perf_counter() - t0:.2f} s")
    log("w2v2 train", f"{len(past)} of {len(names)} gradients past "
        f"{GRAD_BAR:g} of float64 with the kernels, each against the f32 "
        f"cuDNN + dense route's own distance (bar: less than "
        f"{W2V2_CANCEL_FACTOR:g} times it), the ratio, and the float64 "
        f"gradient's move under a one-ulp nudge of the weights with its "
        f"rank of {len(names)}: "
        + (", ".join(f"{n} {e:.3e} / {d:.3e} = {e / max(d, 1e-30):.3f}x, "
                     f"nudge "
                     f"{u:.3e} #{rank[n]}" for n, e, d, u in past)
           or "none"))
    log("w2v2 train", f"one-ulp nudge of the weights, float64: median "
        f"gradient move {np.median(nudge):.3e}, the largest "
        + ", ".join(f"{names[i]} {nudge[i]:.3e}" for i in order[:12]))
    log("w2v2 train", f"control, the f32 cuDNN + dense route with TF32 on: "
        f"loss rel {t64[0]:.3e}, worst gradient {t64[1]:.3e} ({t64[2]}), "
        f"{len(ctl_past)} gradients past {GRAD_BAR:g} of float64, the "
        f"largest ratio to the TF32-off route's distance {ctl_ratio:.3f}x "
        f"(must reach {W2V2_CANCEL_FACTOR:g}), on the gradients the "
        f"kernels put past {GRAD_BAR:g} "
        f"{min(ctl_on_past, default=0.0):.3f}x to "
        f"{max(ctl_on_past, default=0.0):.3f}x; launches {counts_t}")
    log("w2v2 train", "the softmax backward in float64 per encoder layer, "
        "|P o dP| / |dS| (how far dP and D cancel) and the rel. L2 change "
        "of dS when P, dP and D are each rounded once to f32: "
        + ", ".join(f"layer {i} {a:.1f}, {e:.3e}"
                    for i, (a, e) in enumerate(cancel)))
    if not (max(k64[0], k64[3]) < GRAD_BAR and grads_ok
            and max(kd[0], kd[3]) < GRAD_BAR and n_k == n_d == n_64):
        raise AssertionError("wav2vec 2.0 kernel gradients disagree with the "
                             "plain route (float64 or f32)")
    if ctl_ratio < W2V2_CANCEL_FACTOR:
        raise AssertionError("the TF32 control passes the cancellation bar: "
                             "the bar cannot tell")
    if (counts_k != want_parity or any(counts_d.values())
            or any(counts_64.values()) or any(counts_t.values())
            or any(counts_u.values())):
        raise AssertionError("the wav2vec 2.0 parity run took the wrong path")
    del results, grads_k, grads_d, grads_64, grads_t, grads_u, kernel_model

    # the path's kernels against their plain versions at its shapes: the
    # attention pair at (B, 12, 782, 64) bf16 with dropout and the
    # encoder's pad key, the conv kernels at frontend layers 1-6
    t_frames = conv_output_length(t_wave, cfg.conv_feature_layers)
    t_enc = t_frames + (-t_frames % cfg.required_seq_len_multiple)
    shape = (b, cfg.encoder_attention_heads[0], t_enc, cfg.head_dim)
    pad = torch.zeros((b, t_enc), dtype=torch.bool, device=dev)
    pad[:, t_frames:] = True
    rows = torch.ones((b, t_enc), dtype=torch.bool, device=dev)
    masks = dict(key_padding_mask=pad, dropout_p=cfg.attention_dropout,
                 dropout_seed=DROPOUT_SEED)
    gen = torch.Generator(device=dev).manual_seed(6)
    check_forward(fa, "w2v2_train", shape, shape, masks, rows,
                  torch.bfloat16, gen)
    check_backward(fa, "w2v2_train", shape, shape, masks, rows, ~pad,
                   torch.bfloat16, gen)
    gen = torch.Generator(device=dev).manual_seed(7)
    for i, conv_shape in enumerate(conv_layer_shapes(
            b, t_wave, cfg.conv_feature_layers)):
        check_conv(f"w2v2 layer{i + 1}", conv_shape, torch.bfloat16, gen)

    # 10 updates on one fixed batch (the trainer's dtype, dropouts on, a
    # fixed span mask, counts and Gumbel noise): the loss falls
    t0 = time.perf_counter()
    batch = w2v2_batch(dev, b, t_wave, seed=3)
    mask, counts_fixed, uniform, _ = w2v2_draws(cfg, batch, seed=4)
    step = make_wav2vec2_grad_step(runner.model,
                                   compute_dtype=runner.compute_dtype)
    losses = []
    for _ in range(10):
        loss, n, grads, _ = step(runner.params, batch, runner.rng,
                                 runner.temp_history[-1][1],
                                 mask_indices=mask, gumbel_uniform=uniform,
                                 negative_counts=counts_fixed)
        runner.apply(grads, torch.clamp_min(n.float(), 1.0))
        losses.append(float(loss) / float(n))
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    log("w2v2 train", f"10 updates on one fixed batch ({runner.compute_dtype}"
        f", dropouts on), loss per masked frame "
        f"{' '.join(f'{x:.4f}' for x in losses)}; mean of the first 3 "
        f"{first:.4f}, of the last 3 {last:.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError("the wav2vec 2.0 loss does not fall on a fixed "
                             "batch")
    cudnn_model = Wav2Vec2Model(dataclasses.replace(
        cfg, conv_frontend_impl="auto")).to(dev)
    return runner, by_dtype, cudnn_model, batch


def phase_w2v2_train_timing(runner, cudnn_model, batch, gpu: str):
    """CUDA-event medians at the shipped recipe's batch: the grad step and
    one update (a grad step + apply) with the kernels and with cuDNN +
    impl="dense", f32 (TF32 off) and bf16, dropouts on; frames/s and each
    grad step's peak memory above what was allocated before it."""
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length,
    )
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_wav2vec2_grad_step,
    )

    b, t_wave = W2V2_TRAIN
    frames = b * conv_output_length(t_wave, runner.cfg.conv_feature_layers)
    temp = runner.temp_history[-1][1]
    routes = {"kernels": (runner.model, "auto"),
              "cuDNN + dense": (cudnn_model, "dense")}
    for dtype in (torch.float32, torch.bfloat16):
        steps = {name: make_wav2vec2_grad_step(
            m, compute_dtype=dtype, attn_impl=impl,
            mask_shared_rounding=True) for name, (m, impl) in routes.items()}

        def grad(name):
            return lambda: steps[name](runner.params, batch, runner.rng, temp)

        def update(name):
            def run():
                _, n, grads, _ = steps[name](runner.params, batch, runner.rng,
                                             temp)
                runner.apply(grads, torch.clamp_min(n.float(), 1.0))
            return run

        peaks = {}
        with matmul_precision("highest"):
            for name in routes:
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                grad(name)()
                torch.cuda.synchronize()
                peaks[name] = (torch.cuda.max_memory_allocated() - before) / 1e9
            k_ms, c_ms = alternate(grad("kernels"), grad("cuDNN + dense"),
                                   reps=1, turns=1)
            ku_ms, cu_ms = alternate(update("kernels"),
                                     update("cuDNN + dense"), reps=1,
                                     turns=1)
        log("timing", f"wav2vec 2.0 grad step B={b} x {t_wave} samples "
            f"{dtype}: kernels {k_ms:.2f} ms ({frames / k_ms * 1e3:.0f} "
            f"frames/s, peak {peaks['kernels']:.2f} GB above the live "
            f"{before / 1e9:.2f} GB), cuDNN + dense {c_ms:.2f} ms "
            f"({frames / c_ms * 1e3:.0f} frames/s, peak "
            f"{peaks['cuDNN + dense']:.2f} GB); one update (grad step + "
            f"apply): kernels {ku_ms:.2f} ms ({1e3 / ku_ms:.3f} updates/s), "
            f"cuDNN + dense {cu_ms:.2f} ms ({1e3 / cu_ms:.3f} updates/s); "
            f"{frames} frames [{gpu}]")


def phase_w2v2_profile(runner, cudnn_model, batch, gpu: str):
    """The bf16 wav2vec 2.0 grad step with the kernels and with cuDNN +
    impl="dense"."""
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_wav2vec2_grad_step,
    )

    temp = runner.temp_history[-1][1]
    for name, model, impl in (("kernels", runner.model, "auto"),
                              ("cuDNN + dense", cudnn_model, "dense")):
        step = make_wav2vec2_grad_step(model, compute_dtype=torch.bfloat16,
                                       attn_impl=impl,
                                       mask_shared_rounding=True)
        profile_calls(f"wav2vec 2.0 grad step bf16 {name}",
                      lambda: step(runner.params, batch, runner.rng, temp),
                      gpu)


def wave_prune_config(upstream: str, mode: str, data: str,
                      events: int) -> dict:
    """The shipped runner YAML of ``upstream``'s ``mode``
    (configs/{weight_pruning,head_pruning/l1,row_pruning}/
    <upstream>_config_runner.yaml) with its events moved to consecutive
    updates from the first on: weight pruning warnup 0, period 1,
    n_iters ``events`` (its sparsity ladder cut to as many entries),
    pruning_condition always; head and row pruning warm_up 0, interval 1,
    total_steps ``events``. As many updates as events, a log line each,
    ``data`` as the manifest (and the labels)."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    cfg = read_yaml(WAVE_RECIPES[mode] / f"{upstream}_config_runner.yaml")
    pc = cfg["prune"]
    if mode == "weight-pruning":
        pc.update(warnup=0, period=1, n_iters=events,
                  pruning_condition="always")
        pc["sparsity"] = pc["sparsity"][:events]
    else:
        pc.update(STRUCTURED_SHORT, total_steps=events)
    cfg["runner"].update(total_steps=events, log_step=1)
    cfg["task"]["data"] = data
    if "label_dir" in cfg["task"]:
        cfg["task"]["label_dir"] = data
    return cfg


def run_wave_trainer(upstream: str, mode: str, model_yaml, cfg: dict,
                     root: pathlib.Path, start: str):
    """``python -m speech_ssl_compression_tpu_torch.train -m <mode> -u
    <upstream>`` from ``start`` with the runner config ``cfg``, the launch
    counts from 0 just before it. Returns (runner, launch counts per dtype,
    the encoder layers it ran (LayerDrop may skip some), seconds)."""
    import speech_ssl_compression_tpu_torch.models.encoder as encoder
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train

    name = f"{upstream}_{mode}"
    runner_yaml = root / f"{name}.yaml"
    runner_yaml.write_text(to_yaml(cfg) + "\n")
    layer_forward, kept = encoder.encoder_layer_forward, []

    def counting(*args, **kwargs):
        kept.append(1)
        return layer_forward(*args, **kwargs)

    encoder.encoder_layer_forward = counting
    # the trainers hold reference cycles: an earlier phase's may still be
    # on the card until the collector runs, and must not run mid-event
    # (check_event_memory)
    gc.collect()
    t0 = time.perf_counter()
    reset_launch_counts()
    try:
        runner = train(["-m", mode, "-u", upstream, "-g", str(model_yaml),
                        "-c", str(runner_yaml), "-n", str(root / name), "-i",
                        start, "--device", "cuda", "--seed", "0"])
        torch.cuda.synchronize()
    finally:
        encoder.encoder_layer_forward = layer_forward
    return runner, dtype_launch_counts(), len(kept), time.perf_counter() - t0


def check_wave_run(upstream: str, mode: str, runner, counts, layers: int,
                   seconds: float, events: int, gpu: str) -> None:
    """What every run of the wave prune phase must show: its events, one
    finite log line an update, and every grad step through the kernels
    (bf16): an attention forward, dQ and dK/dV per encoder layer run and
    the conv kernels per frontend layer 1-6."""
    cfg = runner.cfg
    n_conv = len(conv_layer_shapes(1, W2V2_TRAIN[1], cfg.conv_feature_layers))
    want = {**dict.fromkeys(("conv1d_fwd", "conv1d_dw", "conv1d_dx"),
                            {"f32": 0, "bf16": events * n_conv}),
            **dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                             "flash_attn_bwd_dkv"), {"f32": 0,
                                                     "bf16": layers})}
    fired = (runner.wp_state.pruning_times if mode == "weight-pruning"
             else len(runner.prune_event_log))
    hist = runner.log_history
    log("wave prune", f"-m {mode} -u {upstream} -i last-step.npz "
        f"({runner.compute_dtype}, B = {runner._batch_size()}): {fired} "
        f"events at steps {list(map(int, runner.prune_steps))}, "
        f"{len(hist)} updates, losses "
        f"{[round(e['loss'], 4) for e in hist]}, heads "
        f"{cfg.encoder_attention_heads}, FFN {cfg.encoder_ffn_embed_dim}; "
        f"{layers} encoder layers run; launches {counts}; "
        f"{seconds:.2f} s [{gpu}]")
    for e in runner.prune_event_log:
        log("wave prune", f"{upstream} {mode} event at step {e['step']} on "
            f"the host: its artifact's save {e['save_seconds']:.3f} s, "
            + (f"the masks {e['seconds']:.3f} s" if "seconds" in e else
               f"scoring {e['score_seconds']:.3f} s, slicing and rebuild "
               f"{e['slice_seconds']:.3f} s") + f" [{gpu}]")
    if counts != want:
        raise AssertionError(f"{upstream} {mode} launches {counts}, want "
                             f"{want}")
    if not (runner.compute_dtype == torch.bfloat16 and fired == events
            and len(hist) == events
            and np.isfinite([[e["loss"], e["grad_norm"]]
                             for e in hist]).all()):
        raise AssertionError(f"{upstream} {mode} run: {fired} events, log "
                             f"{hist}")


def check_hubert_head_prune(dev, gpu: str, runner, expdir: pathlib.Path,
                            events: int) -> None:
    """Each event's heads against a host recompute of the l1 scores on the
    JAX-layout view of the artifact before it; the live bytes around each
    event; the bf16 attention kernels against their plain versions at
    every head count the run held, at the path's shape (B, h, 782, 64)
    with its pad key, dropout 0 and 0.1."""
    from speech_ssl_compression_tpu_torch.compress import head_pruning as hp
    from speech_ssl_compression_tpu_torch.models.conv_frontend import (
        conv_output_length,
    )
    from speech_ssl_compression_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg = runner.cfg
    n_layers = cfg.encoder_layers
    per_layer = cfg.encoder_attention_heads[0] + events
    for i, group in enumerate(runner.pruned_heads):
        h = per_layer - i
        params = read_layers(expdir / f"states_prune_{n_layers * h}.npz",
                             ("q_proj", "k_proj", "v_proj"))
        scores = hp.l1_head_scores(params, cfg.with_heads((h,) * n_layers))
        again = hp.select_heads_to_prune(scores, n_layers, "by_layer",
                                         n_layers)
        if again != group:
            raise AssertionError(f"hubert l1 event {i + 1}: {group}, "
                                 f"recomputed {again}")
    log("wave prune", f"the {events} HuBERT events' heads equal to a host "
        f"recompute of l1_head_scores on the JAX-layout view of the "
        f"artifact before each (states_prune_{n_layers * per_layer} ... "
        f"states_prune_{n_layers * (per_layer - events + 1)}.npz); heads "
        f"a layer {cfg.encoder_attention_heads}, "
        f"{time.perf_counter() - t0:.2f} s")
    if cfg.encoder_attention_heads != (per_layer - events,) * n_layers:
        raise AssertionError(f"HuBERT head pruning did not reach "
                             f"{per_layer - events} heads a layer")
    check_event_memory("wave prune", runner)

    t0 = time.perf_counter()
    b, t_wave = W2V2_TRAIN
    t_frames = conv_output_length(t_wave, cfg.conv_feature_layers)
    t_enc = t_frames + (-t_frames % cfg.required_seq_len_multiple)
    pad = torch.zeros((b, t_enc), dtype=torch.bool, device=dev)
    pad[:, t_frames:] = True
    rows = torch.ones_like(pad)
    gen = torch.Generator(device=dev).manual_seed(9)
    held = range(per_layer, per_layer - events - 1, -1)
    for h in held:
        shape = (b, h, t_enc, cfg.head_dim)
        for p in (0.0, DROPOUT_P):
            masks = dict(key_padding_mask=pad)
            if p:
                masks.update(dropout_p=p, dropout_seed=DROPOUT_SEED)
            name = f"hubert_heads_{h}_p{p:g}"
            check_forward(fa, name, shape, shape, masks, rows,
                          torch.bfloat16, gen, straddles=True)
            check_backward(fa, name, shape, shape, masks, rows, ~pad,
                           torch.bfloat16, gen)
    log("wave prune", f"bf16 attention fwd, dQ and dK/dV kernels vs plain "
        f"at (B, h, T, d) = ({b}, h, {t_enc}, {cfg.head_dim}), h = "
        f"{held[0]} ... {held[-1]}, the pad key, dropout 0 and "
        f"{DROPOUT_P:g}: each "
        f"within the bars of the kernels and backward phases, "
        f"{time.perf_counter() - t0:.2f} s")


def serve_pruned_hubert(dev, gpu: str, up: dict, data: str, pruned: str,
                        model, full) -> None:
    """The HuBERT expert on the head-pruned checkpoint ``pruned``: it loads
    at its widths with the trainer's ``model``'s weights and takes a
    training step; then it serves hubert_forward(features_only=True) on
    the hubert serve phase's batch beside the full model ``full`` (the
    start checkpoint's), f32 (TF32 off, the extractors' default), in
    turns."""
    from speech_ssl_compression_tpu_torch.data.dictionary import Dictionary
    from speech_ssl_compression_tpu_torch.extract import matmul_precision
    from speech_ssl_compression_tpu_torch.models.hubert import hubert_forward
    from speech_ssl_compression_tpu_torch.upstream import get_pretrain_expert

    t0 = time.perf_counter()
    dicts = [Dictionary.load(f"{data}/dict.km.txt")]
    expert_cls = get_pretrain_expert("hubert")
    one = expert_cls(up, initial_weight=pruned, device=dev, dicts=dicts)
    same = all(torch.equal(v, p.detach()) for (_, v), p in zip(
        one.model.named_parameters(), model.parameters()))
    rng = np.random.default_rng(0)
    n = 32000
    labels = [rng.integers(0, 500, n // 320) for _ in range(2)]
    data_in = {"net_input": {"source": rng.uniform(-0.3, 0.3, (2, n)).astype(
        np.float32), "padding_mask": np.zeros((2, n), bool)},
        "target_list": [labels]}
    loss, frames_masked = one.forward(data_in)
    loss.backward()
    log("wave prune", f"HuBERT expert on the head-pruned last-step.npz: heads "
        f"{one.cfg.encoder_attention_heads}, weights bitwise the trainer's: "
        f"{same}; a training forward on 2 x {n} samples: loss "
        f"{float(loss):.4f} over {frames_masked} masked frames, "
        f"{time.perf_counter() - t0:.2f} s")
    heads = one.cfg.encoder_attention_heads
    if not (same and heads == model.cfg.encoder_attention_heads
            and torch.isfinite(loss)):
        raise AssertionError("the HuBERT expert does not load the "
                             "head-pruned checkpoint")
    del loss
    b, t_wave = HUBERT_SERVE
    src_np, lengths = hubert_source(b, t_wave, seed=0)
    src = torch.from_numpy(src_np).to(dev)
    label = f"{heads[0]} heads a layer"
    models = {label: one.model.eval(), "full": full.eval()}

    def run(model):
        with matmul_precision("highest"), torch.inference_mode():
            return hubert_forward(model, src, lengths, mask=False,
                                  features_only=True)

    frames = int((~run(models["full"])["padding_mask"]).sum())
    one_ms, full_ms = alternate(lambda: run(models[label]),
                                lambda: run(models["full"]), reps=1)
    log("timing", f"HuBERT expert models serving hubert_forward "
        f"{torch.float32}, B={b} x {t_wave} samples: {label} "
        f"{one_ms:.2f} ms ({frames / one_ms * 1e3:.0f} frames/s), full "
        f"{full_ms:.2f} ms ({frames / full_ms * 1e3:.0f} frames/s), "
        f"{full_ms / one_ms:.3f}x [{gpu}]")
    del models


def check_remat(dev, gpu: str, start: str, batch):
    """One bf16 HuBERT grad step at the recipe's batch with
    checkpoint_activations off and on, from the same generators and
    weights, cuDNN deterministic: the loss and every gradient (bitwise
    expected), the peak memory of each, the forward launches the
    recompute adds, and the step's time with and without it.
    Returns the model of ``start`` it ran (f32)."""
    from speech_ssl_compression_tpu_torch.configs import HuBERTConfig
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_hubert_grad_step,
    )
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )
    from speech_ssl_compression_tpu_torch.utils.weights import (
        load_wave_model, wave_model_from_named,
    )

    t0 = time.perf_counter()
    state = load_checkpoint(start, load_opt=False)
    cfg = HuBERTConfig.from_dict(state["meta"]["Config"])
    model = load_wave_model(state["params"], cfg, "hubert").to(dev)
    del state
    named = dict(model.named_parameters())
    models = {"off": model, "on": wave_model_from_named(
        named, dataclasses.replace(cfg, checkpoint_activations=True),
        "hubert")}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    results = {}
    try:
        for name, m in models.items():
            step = make_hubert_grad_step(m, compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            loss, n, grads, _ = step(named, batch,
                                     torch.Generator().manual_seed(11))
            torch.cuda.synchronize()
            results[name] = (float(loss), int(n), grads, launch_counts(),
                             torch.cuda.max_memory_allocated(dev) - base)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            flags)
    (loss_a, n_a, grads_a, counts_a, peak_a), (
        loss_b, n_b, grads_b, counts_b, peak_b) = results.values()
    names = list(named)
    bitwise = [bool(torch.equal(a, b)) for a, b in zip(grads_a, grads_b)]
    errs = grad_errors(names, grads_b, grads_a)
    worst = int(np.argmax(errs))
    extra = {k: counts_b[k] - counts_a[k] for k in counts_a}
    b, t_wave = batch["source"].shape
    log("wave prune", f"checkpoint_activations, one bf16 HuBERT grad step "
        f"(B={b} x {t_wave} samples, {n_a} masked frames, dropouts on, the "
        f"same generators): loss {loss_a:.6f} off, {loss_b:.6f} on, equal "
        f"{loss_a == loss_b}; {sum(bitwise)} of {len(names)} gradients "
        f"bitwise equal, worst rel L2 {errs[worst]:.3e} ({names[worst]}); "
        f"peak memory above the model {peak_a} B off, {peak_b} B on "
        f"({peak_b / peak_a:.3f}x); launches off {counts_a}, on {counts_b},"
        f" the recompute's {extra}; {time.perf_counter() - t0:.2f} s [{gpu}]")
    want_extra = {**dict.fromkeys(extra, 0),
                  "flash_attn_fwd": cfg.encoder_layers}
    if not (n_a == n_b and extra == want_extra and peak_b < peak_a):
        raise AssertionError("checkpoint_activations did not recompute the "
                             "layers, or saved no memory")
    if not (loss_a == loss_b and all(bitwise)):
        # a kernel that is not bitwise repeatable: within the bf16 bar
        if not (abs(loss_b - loss_a) <= BF16_SLICE_BAR * abs(loss_a)
                and max(errs) < BF16_SLICE_BAR):
            raise AssertionError("checkpoint_activations changes the "
                                 "gradients")
    del grads_a, grads_b, results
    # the grad step with and without the recompute, one CUDA-event time
    # each after a warm-up
    ms = {}
    for k, m in models.items():
        step = make_hubert_grad_step(m, compute_dtype=torch.bfloat16)
        ms[k] = cuda_ms(lambda: step(named, batch,
                                     torch.Generator().manual_seed(11)),
                        reps=1)
    log("timing", f"HuBERT bf16 grad step B={b} x {t_wave} samples, dropouts "
        f"on: checkpoint_activations off {ms['off']:.2f} ms, on "
        f"{ms['on']:.2f} ms, {ms['on'] / ms['off']:.3f}x [{gpu}]")
    return model


def check_w2v2_weight_prune(runner, expdir: pathlib.Path, sparsity) -> None:
    """Each event's masks against a host recompute by
    global_magnitude_prune on the folded weights of the artifact before
    it (the first on the start checkpoint's), every masked entry's
    gradient exactly 0 in a bf16 grad step of the run's model."""
    from speech_ssl_compression_tpu_torch.compress import weight_pruning as wp
    from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves

    t0 = time.perf_counter()
    files = [expdir / f"before-pruning-{i}.npz" for i in range(len(sparsity))]
    states = [read_prune_state(f) for f in files + [expdir / "last-step.npz"]]
    for i, (before, after) in enumerate(zip(states, states[1:])):
        params, old, meta, updates = before
        want = wp.global_magnitude_prune(wp.fold_masks(params, old or None),
                                         sparsity[i])
        got = tree_leaves(after[1])
        same = all(np.array_equal(a, b)
                   for a, b in zip(got, tree_leaves(want)))
        n = sum(m.size for m in got)
        masked = n - sum(int(np.count_nonzero(m)) for m in got)
        log("wave prune", f"wav2vec 2.0 weight event {i + 1} "
            f"({files[i].name}): Step {meta['Step']}, after {updates} "
            f"updates; {masked} of {n} prunable entries masked "
            f"(round(amount n) = {round(sparsity[i] * n)}); masks equal to "
            f"the host recompute: {same}")
        if not (same and masked == round(sparsity[i] * n)
                and meta["Step"] == updates == i):
            raise AssertionError(f"wav2vec 2.0 weight event {i + 1} is wrong")
    last = states[-1][2]
    if last.get("Pruning", {}).get("pruning_times") != len(sparsity):
        raise AssertionError("last-step.npz lacks the pruning state")
    del states

    dataset = runner._get_dataset()
    batch = runner._collate(next(iter(dataset.epoch(shuffle=False))))
    _, _, grads, _ = runner.grad_step(runner.params, batch, runner.rng,
                                      masks=runner.masks,
                                      gumbel_temp=runner.temp_history[-1][1])
    named = dict(zip(runner.params, grads))
    zero = all(bool((named[k][m == 0] == 0).all())
               for k, m in runner.masks.items())
    log("wave prune", f"wav2vec 2.0 masked grad step (bf16): every masked "
        f"entry's gradient exactly 0: {zero}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not zero:
        raise AssertionError("a masked wav2vec 2.0 weight has a gradient")


def check_w2v2_row_prune(runner, expdir: pathlib.Path, rows: int) -> None:
    """Each event's rows against a host recompute of ffn_row_scores on
    the artifact before it; the live bytes around each event."""
    from speech_ssl_compression_tpu_torch.compress import row_pruning as rp

    t0 = time.perf_counter()
    ffn = runner.cfg.encoder_ffn_embed_dim[0]
    events = len(runner.prune_event_log)
    for i, e in enumerate(runner.prune_event_log):
        layers = read_layers(expdir / f"states_prune_{ffn + rows * (events - i)}"
                             ".npz", ("fc1", "fc2"))["encoder"]["layers"]
        again = [rp.rows_to_keep(rp.ffn_row_scores(l), rows) for l in layers]
        if not all(np.array_equal(a, k) for a, k in zip(again, e["kept"])):
            raise AssertionError(f"wav2vec 2.0 row event {i + 1} kept other "
                                 "rows than the host recompute")
    log("wave prune", f"the {events} wav2vec 2.0 row events' rows equal to "
        f"a host recompute of ffn_row_scores on the artifact before each; "
        f"FFN {runner.cfg.encoder_ffn_embed_dim}, "
        f"{time.perf_counter() - t0:.2f} s")
    if runner.cfg.encoder_ffn_embed_dim != (3072 - rows * events,) * len(
            runner.cfg.encoder_ffn_embed_dim):
        raise AssertionError("wav2vec 2.0 row pruning left other widths")
    check_event_memory("wave prune", runner)


def phase_wave_prune(dev, gpu: str, tmp: str):
    """The pruning modes of HuBERT and wav2vec 2.0 through the trainer's
    entry point, full width, bf16, from the hubert train and w2v2 train
    phases' checkpoints on the w2v2 train phase's WAVs (with its labels
    for HuBERT): the six (upstream, mode) pairs at their shipped recipes
    with the events moved to consecutive updates (WAVE_EVENTS), each with
    its checks; activation checkpointing on a HuBERT grad step. Returns
    the launch counts of each run per dtype, by path."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    t_phase = time.perf_counter()
    root = pathlib.Path(tmp) / "wave_prune"
    root.mkdir()
    data = str(pathlib.Path(tmp) / "w2v2" / "data")
    starts = {"hubert": str(pathlib.Path(tmp) / "hubert" / "exp" /
                            "last-step.npz"),
              "wav2vec2": str(pathlib.Path(tmp) / "w2v2" / "exp" /
                              "last-step.npz")}
    model_yamls = {"hubert": pathlib.Path(tmp) / "hubert" /
                   "config_model.yaml",
                   "wav2vec2": pathlib.Path(tmp) / "w2v2" /
                   "config_model.yaml"}
    paths = {}
    for (upstream, mode), events in WAVE_EVENTS.items():
        cfg = wave_prune_config(upstream, mode, data, events)
        reads = WAVE_READS.get((upstream, mode), ())
        with unread_saves_skipped("wave prune", lambda p: any(
                p.split("/")[-1].startswith(r) for r in reads)):
            runner, counts, layers, seconds = run_wave_trainer(
                upstream, mode, model_yamls[upstream], cfg, root,
                starts[upstream])
        check_wave_run(upstream, mode, runner, counts, layers, seconds,
                       events, gpu)
        paths[f"{upstream} {mode}"] = counts
        expdir = root / f"{upstream}_{mode}"
        if (upstream, mode) == ("hubert", "head-pruning"):
            check_hubert_head_prune(dev, gpu, runner, expdir, events)
            # a batch of the recipe's shape, as the run's dataset gives it
            batch = runner._collate(next(iter(
                runner._get_dataset().epoch(shuffle=False))))
            pruned = runner.model
            del runner
            full = check_remat(dev, gpu, starts["hubert"], batch)
            del batch
            serve_pruned_hubert(
                dev, gpu, {"hubert": read_yaml(model_yamls["hubert"])[
                    "hubert"]}, data, str(expdir / "last-step.npz"), pruned,
                full)
            del pruned, full
        elif (upstream, mode) == ("wav2vec2", "weight-pruning"):
            check_w2v2_weight_prune(runner, expdir, cfg["prune"]["sparsity"])
        elif (upstream, mode) == ("wav2vec2", "row-pruning"):
            check_w2v2_row_prune(runner, expdir,
                                 cfg["prune"]["num_rows_each_step"])
        elif mode == "head-pruning":
            if set(runner.cfg.encoder_attention_heads) != {12 - events}:
                raise AssertionError(f"{upstream} head pruning left heads "
                                     f"{runner.cfg.encoder_attention_heads}")
        elif mode == "row-pruning":
            if set(runner.cfg.encoder_ffn_embed_dim) != {
                    3072 - events * cfg["prune"]["num_rows_each_step"]}:
                raise AssertionError(f"{upstream} row pruning left FFN "
                                     f"{runner.cfg.encoder_ffn_embed_dim}")
        else:
            from speech_ssl_compression_tpu_torch.compress.weight_pruning \
                import sparsity_of
            got = sparsity_of(runner.masks)
            if abs(got - cfg["prune"]["sparsity"][-1]) > 1e-6:
                raise AssertionError(f"{upstream} weight pruning left "
                                     f"sparsity {got}")
        runner = None
        gc.collect()
        for path in expdir.glob("*.npz"):
            path.unlink()
    log("wave prune", f"phase {time.perf_counter() - t_phase:.2f} s")
    return paths


PAR_RANKS = 2          # ranks of the parallel phase, sharing the one card
PAR_F32_UPDATES = 3    # the f32 data-parallel run, held to the replay
PAR_BF16_UPDATES = 2   # the bf16 data-parallel run, dropout on, timed
PAR_ONE_UPDATES = 2    # the f32 tensor- and pipeline-parallel runs and the
                       # 1-process run they are held to; the bf16 pipeline
PAR_PP_MICROBATCHES = 4  # the pipeline's M (GPipe: (S - 1) / (M + S - 1)
                         # of a stage's time idle in the fill and drain)
PAR_TIMEOUT = 300      # seconds the ranks may take once they have the spec
PAR_WAIT = 900         # seconds a rank waits for the spec
PAR_PARAM_RTOL, PAR_PARAM_ATOL = 1e-4, 1e-6  # JAX's bars
PAR_LOSS_RTOL = 2e-4   # (tests/test_multiprocess_train.py:308-319)
# the replicated leaf whose rank-local gradient the f32 data-parallel run
# also dumps: the planted fault "left unreduced" that update_check must fail
PAR_CONTROL_LEAF = "encoder.layers.0.final_layer_norm.bias"


def parallel_child_command(spec: pathlib.Path, rank: int, port: int):
    """(argv, env) of one rank of the parallel phase: this script with
    ``--child`` (which runs the runs of ``spec`` through the trainer CLI's
    entry point, ``python -m speech_ssl_compression_tpu_torch.train``'s
    ``main``), and torchrun's variables for a gloo group of PAR_RANKS on
    this host."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK=str(rank), WORLD_SIZE=str(PAR_RANKS),
               LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(PAR_RANKS))
    return ([sys.executable, str(ROOT / "chip_smoke.py"), "--child",
             str(spec)], env)


def parallel_runs(root: pathlib.Path, starts: dict, csv: str,
                  hubert: pathlib.Path, seqpar_ckpt: str) -> list:
    """The phase's runs, each a CLI argv (every one with --multi_host
    --dist_backend gloo) and what the child records: (a) data parallel f32
    (TF32 off, dropout 0) for PAR_F32_UPDATES updates, each update's
    gradient dumped, then bf16 with the shipped dropouts; (b) tensor
    parallel (--model_parallel 2) f32 for PAR_ONE_UPDATES updates, its
    gradients gathered and dumped, then (``bf16_step``) one bf16 grad step
    of its model timed; (c) HuBERT data parallel, bf16, tc_pallas, one
    update; (d) pipeline parallel (--pipeline_parallel 2, 6 layers a
    stage, PAR_PP_MICROBATCHES microbatches) f32 for PAR_ONE_UPDATES
    updates, its gradients gathered from the stages and dumped, then bf16
    with the shipped dropouts, timed; (e) ``kind`` "seqpar": no CLI run,
    but sequence-parallel serving of one LONG_T utterance and T = LONG_T
    distillation from the long phase's 10 ms checkpoint (seqpar_rank). A
    MelHuBERT run starts from the checkpoint of its dtype in ``starts``
    (-i: the model config is the checkpoint's, f32 without dropout); each
    rank reads 4 utterances a micro-batch. A run writes only the
    checkpoints in its ``save``: the f32 runs' final last-step.npz, which
    the phase reads (not the trainer's states-epoch-0 at step 0, nor the
    bf16 runs', which nothing reads)."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml

    base = root / "runner_base.yaml"
    base.write_text(RUNNER_YAML.format(csv=csv))
    runner = read_yaml(base)
    runner["runner"].update(gradient_accumulate_steps=1,
                            save_every_x_epochs=1000)
    files = {}
    for name, updates, bf16 in (("f32_3", PAR_F32_UPDATES, False),
                                ("bf16_2", PAR_BF16_UPDATES, True),
                                ("f32_2", PAR_ONE_UPDATES, False)):
        tree = copy.deepcopy(runner)
        tree["runner"].update(total_steps=updates, bf16=bf16)
        files[name] = root / f"runner_{name}.yaml"
        files[name].write_text(to_yaml(tree) + "\n")
    files["hubert"] = root / "runner_hubert.yaml"
    files["hubert"].write_text(
        (hubert / "config_runner.yaml").read_text()
        .replace("total_steps: 3", "total_steps: 1")
        .replace(f"gradient_accumulate_steps: {HUBERT_ACCUM}",
                 "gradient_accumulate_steps: 1"))

    def mel(tag, dtype, runner_file, updates, dump, grid=()):
        return dict(tag=tag, updates=updates, tf32=False,
                    save=["last-step.npz"] if dump else [],
                    dump=str(root / f"grads_{tag}") if dump else None,
                    argv=["-m", "melhubert", "-g", str(CONFIG_YAML),
                          "-c", str(files[runner_file]), "-n", f"exp_{tag}",
                          "-i", starts[dtype], "--device", "cuda", "--seed",
                          "0", *grid])

    tp, pp = ("--model_parallel", "2"), (
        "--pipeline_parallel", str(PAR_RANKS), "--pp_microbatches",
        str(PAR_PP_MICROBATCHES))
    runs = [dict(mel("dp_f32", "f32", "f32_3", PAR_F32_UPDATES, True),
                 control=True),
            mel("dp_bf16", "bf16", "bf16_2", PAR_BF16_UPDATES, False),
            dict(mel("tp_f32", "f32", "f32_2", PAR_ONE_UPDATES, True, tp),
                 bf16_step=True),
            dict(tag="hubert_dp_bf16", updates=1, tf32=False, dump=None,
                 save=[],
                 argv=["-m", "melhubert", "-u", "hubert", "-g",
                       str(hubert / "config_model.yaml"), "-c",
                       str(files["hubert"]), "-n", "exp_hubert",
                       "--device", "cuda", "--seed", "0"]),
            mel("pp_f32", "f32", "f32_2", PAR_ONE_UPDATES, True, pp),
            dict(mel("pp_bf16", "bf16", "bf16_2", PAR_BF16_UPDATES, False,
                     pp), keep=True)]
    for run in runs:
        run["argv"] += ["--multi_host", "--dist_backend", "gloo"]
    runs += [dict(tag="seqpar", kind="seqpar", mode="parity",
                  ckpt=seqpar_ckpt, out=str(root / "seqpar.pt")),
             dict(tag="seqpar_timing", kind="seqpar", mode="timing",
                  ckpt=seqpar_ckpt),
             dict(tag="pp_timing", kind="timing", of="pp_bf16",
                  updates=PAR_BF16_UPDATES)]
    return runs


def child_main(spec_path: str) -> None:
    """One rank of the parallel phase: each run of the spec through the
    trainer CLI's entry point, with the launch counts set to 0 just before
    it and read just after; per run the peak memory, the seconds its
    checkpoint saves take (the gathers included), and per update its
    CUDA-synchronized wall time, its grad steps' times, and the time of
    its collectives (the window's gradient all-reduce and, under tensor
    parallel, the activations' all-reduces inside the grad steps). Gloo
    runs a collective on the host, between copies to and from the card, so
    the collectives' share of an update is time the card does no work of
    this rank: the rank's idle share, at least (no profiler: it costs more
    than the updates). Where the spec asks (``dump``), each update's
    gradient as the apply takes it (gathered under tensor parallel) is
    dumped with its sample size, and under data parallel also this rank's
    own gradient of PAR_CONTROL_LEAF before the all-reduce; the dumps'
    seconds are not the update's. A run writes only the checkpoints its
    ``save`` names. Where it asks for ``bf16_step``, one bf16 grad step of
    the run's model is timed after the run (its launches are not the
    run's); a run of kind "seqpar" is seqpar_rank's. The spec may name a
    ``next`` spec, which the rank waits for once its runs are done.
    Writes each spec's records to ``<spec>.<rank>.json``; prints no result
    line."""
    from speech_ssl_compression_tpu_torch.parallel import mesh, pipeline
    from speech_ssl_compression_tpu_torch.train import optim_mixin
    from speech_ssl_compression_tpu_torch.train import parallel_mixin
    from speech_ssl_compression_tpu_torch.train.runner import Runner
    from speech_ssl_compression_tpu_torch.train.wave_runner import WaveRunner

    torch.zeros((), device="cuda")  # the CUDA context, while the parent works
    rank = int(os.environ["RANK"])
    state = {}

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    def timed(key, fn):
        def run(*a, **k):
            t0 = now()
            out = fn(*a, **k)
            state[key] += 1e3 * (now() - t0)
            return out
        return run

    for cls in (Runner, WaveRunner):
        def build(self, _orig=cls._build_grad_step):
            _orig(self)
            step = self.grad_step

            def first_timed(*a, **k):
                if state["t_update"] is None:
                    state["t_update"] = now()
                return timed("step_ms", step)(*a, **k)

            self.grad_step = first_timed
        cls._build_grad_step = build
        def save(self, step, name, *a, _orig=cls.save, **k):
            if name in state["save"]:
                timed("save_ms", _orig)(self, step, name, *a, **k)

        cls.save = save

    mesh._all_reduce_f32 = timed("collective_ms", mesh._all_reduce_f32)
    # the pipeline's sums over the world and the data group, and its
    # point-to-point sends and receives (a stage blocked in one does no
    # work: its share of the step is the stage's idle share, the bubble)
    pipeline.all_reduce_tensors = timed("collective_ms",
                                        pipeline.all_reduce_tensors)
    pipeline.send = timed("p2p_ms", pipeline.send)
    pipeline.recv = timed("p2p_ms", pipeline.recv)
    reduce_window = timed("reduce_ms",
                          parallel_mixin.ParallelMixin._reduce_window)

    def reduce_hooked(self, grads, scalars):
        if state["control_leaf"]:
            own = dict(zip(self.params, grads))[PAR_CONTROL_LEAF]
            state["control"] = own.detach().float().cpu()
        return reduce_window(self, grads, scalars)

    parallel_mixin.ParallelMixin._reduce_window = reduce_hooked
    apply = optim_mixin.OptimizerScheduleMixin.apply

    def apply_hooked(self, grads, sample_size):
        if state["dump"]:
            t_dump = now()
            named = dict(zip(self.params, grads))
            if self._sharded:
                named = mesh.gather_named([named], self.cfg, self.mesh)[0]
            elif self.mesh.pp > 1:
                named = (pipeline.gather_stages([named], self.cfg, self.mesh,
                                                to_primary=True) or [None])[0]
            if self.primary:
                torch.save(dict(
                    grads={k: v.detach().float().cpu()
                           for k, v in named.items()},
                    sample_size=float(sample_size),
                    control=state["control"]),
                    f"{state['dump']}_{len(state['updates'])}.pt")
            state["t_update"] += now() - t_dump
        out = apply(self, grads, sample_size)
        wall = 1e3 * (now() - state["t_update"])
        state["updates"].append(dict(
            update_ms=wall, step_ms=state["step_ms"],
            reduce_ms=state["reduce_ms"],
            collective_ms=state["collective_ms"], p2p_ms=state["p2p_ms"],
            idle=(state["reduce_ms"] + state["collective_ms"]
                  + state["p2p_ms"]) / wall))
        state.update(t_update=None, step_ms=0.0, reduce_ms=0.0,
                     collective_ms=0.0, p2p_ms=0.0)
        return out

    optim_mixin.OptimizerScheduleMixin.apply = apply_hooked
    while spec_path:
        spec = json.loads(wait_for(spec_path, "spec").read_text())
        records = []
        for run in spec["runs"]:
            recs = child_run(run, state, now)
            # each run's records as soon as it ends (the verifier waits)
            pathlib.Path(f"{spec_path}.{rank}.{run['tag']}.json").write_text(
                json.dumps(recs))
            records += recs
        pathlib.Path(f"{spec_path}.{rank}.json").write_text(
            json.dumps(records))
        spec_path = spec.get("next")


def child_run(run: dict, state: dict, now) -> list:
    """One run of a rank of the parallel phase (child_main): its records."""
    from speech_ssl_compression_tpu_torch.train.__main__ import main as train
    from speech_ssl_compression_tpu_torch.train.steps import (
        make_melhubert_grad_step,
    )

    if run.get("kind") == "seqpar":
        return seqpar_rank(run, now, state)
    if run.get("kind") == "timing":
        return pipeline_timing(run, state, now)
    state.update(updates=[], dump=run["dump"], save=run["save"],
                 control=None, control_leaf=run.get("control", False),
                 t_update=None, step_ms=0.0, reduce_ms=0.0,
                 collective_ms=0.0, p2p_ms=0.0, save_ms=0.0,
                 bf16_step=None)
    torch.backends.cuda.matmul.allow_tf32 = run["tf32"]
    torch.backends.cudnn.allow_tf32 = run["tf32"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launch_counts()
    runner = train(run["argv"])
    torch.cuda.synchronize()
    counts, long_counts = dtype_launch_counts(), long_launch_counts()
    if run.get("bf16_step"):
        # one bf16 grad step of the run's model on its first batch,
        # timed after a warm-up (all ranks in step: it all-reduces)
        batch = runner._device_batch(
            runner._get_dataloader().get_batch(0))
        step = make_melhubert_grad_step(runner.model,
                                        compute_dtype=torch.bfloat16)
        for _ in range(2):
            state["collective_ms"] = 0.0
            t1 = now()
            step(runner.params, batch, runner.rng)
            bf16_ms = 1e3 * (now() - t1)
        state["bf16_step"] = (bf16_ms, state["collective_ms"])
    record = dict(
        tag=run["tag"], counts=counts, long_counts=long_counts,
        log=runner.log_history, updates=state["updates"],
        bf16_step=state["bf16_step"],
        save_s=state["save_ms"] / 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        seconds=time.perf_counter() - t0, grid=runner.mesh.shape,
        local_heads=list(runner.model.cfg.encoder_attention_heads))
    if run.get("keep"):  # a later run of this rank times it again
        state.setdefault("kept", {})[run["tag"]] = runner
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    return [record]


def pipeline_timing(run: dict, state: dict, now) -> list:
    """``run["updates"]`` more updates (grad step, the window's reduce,
    apply) of the run ``run["of"]`` kept by this rank (child_run's
    ``keep``), on its first batch, with the per-update breakdown of
    child_main's hooks: the timed pipeline, run with the card to the
    ranks (its CLI run shared it with this process's other phases). The
    first update warms; its launches are not counted."""
    runner = state["kept"].pop(run["of"])
    state.update(updates=[], dump=None, save=[], control=None,
                 control_leaf=False, t_update=None, step_ms=0.0,
                 reduce_ms=0.0, collective_ms=0.0, p2p_ms=0.0, save_ms=0.0,
                 bf16_step=None)
    torch.cuda.reset_peak_memory_stats()
    batch = runner._device_batch(runner._get_dataloader().get_batch(0))
    for _ in range(run["updates"]):
        loss, grads, _ = runner.grad_step(runner.params, batch, runner.rng)
        grads, _ = runner._reduce_window(grads, [loss])
        runner.apply(grads, 1.0)
    record = dict(tag=run["tag"], kind="timing", of=run["of"],
                  updates=state["updates"],
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del runner, batch, grads
    gc.collect()
    torch.cuda.empty_cache()
    return [record]


def seqpar_rank(run: dict, now, state: dict) -> list:
    """One rank's sequence-parallel work of the parallel phase (the time
    axis sharded over the data group of both ranks, parallel/seqpar.py),
    from the long phase's 10 ms checkpoint ``run["ckpt"]``:

      serve    one LONG_T utterance (long_wav(1)) through
               MelHuBERTExtractor.forward_seqpar with the device
               featurizer, f32 (TF32 off) and bf16;
      distill  T = LONG_T, B = 1: the checkpoint's 12-layer model teaches
               the 10 ms recipe's seeded 6-layer student
               (long_distill_inputs), one f32 grad step of each loss type
               and one bf16 masked step (SEQPAR_TEMPERATURE,
               SEQPAR_ALPHA, the seeded span mask).

    ``run["mode"]`` "parity" runs each with the launch counts set to 0
    just before it and read just after, and rank 0 writes the outputs
    (hidden states; f32 losses, logs and gradients) to ``run["out"]``;
    "timing" times each again once warm (CUDA-synchronized wall time: the
    gathers run on the host), the serving in both dtypes and the bf16
    distill step, with the share of that time in the host collectives
    (the K/V gathers, their gradients' reduce-scatter, the pad and output
    gathers); it reuses the parity run's models and inputs, which stay in
    ``state["seqpar"]`` in between. Returns the records ("seqpar_serve"
    and "seqpar_distill", or "seqpar_timing")."""
    from speech_ssl_compression_tpu_torch.extract import (
        MelHuBERTExtractor, matmul_precision,
    )
    from speech_ssl_compression_tpu_torch.parallel import mesh as pmesh
    from speech_ssl_compression_tpu_torch.parallel import seqpar
    from speech_ssl_compression_tpu_torch.parallel.multihost import (
        initialize,
    )

    initialize(backend="gloo", device_type="cuda")  # a no-op after a run
    dev = torch.device("cuda", torch.cuda.current_device())
    coll = {"ms": 0.0}

    def timed_coll(fn):
        def run_(*args, **kwargs):
            t0 = now()
            out = fn(*args, **kwargs)
            coll["ms"] += 1e3 * (now() - t0)
            return out
        return run_

    timing_mode = run["mode"] == "timing"
    if timing_mode:
        pmesh.gather_parts = seqpar.gather_parts = timed_coll(
            pmesh.gather_parts)
        pmesh._sum_over_data = timed_coll(pmesh._sum_over_data)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_run = time.perf_counter()
    if "seqpar" not in state:
        ext = MelHuBERTExtractor(run["ckpt"], fp=10,
                                 mean_std_npy_path=str(MEAN_STD),
                                 matmul_precision="highest", device=dev)
        ext16 = copy.copy(ext)
        ext16.model = copy.deepcopy(ext.model).to(torch.bfloat16)
        ext16.dtype = torch.bfloat16
        student, batch, mask = long_distill_inputs(ext.model.cfg, dev)
        state["seqpar"] = dict(
            mesh=pmesh.make_mesh(), exts={"f32": ext, "bf16": ext16},
            student=student, batch=batch, mask=mask)
    mesh, exts, student, batch, mask = (state["seqpar"][k] for k in (
        "mesh", "exts", "student", "batch", "mask"))
    wav = long_wav(1)
    params = dict(student.named_parameters())
    keys = [("nomasked", torch.float32), ("masked", torch.float32),
            ("masked", torch.bfloat16)][2 if timing_mode else 0:]
    steps = {key: seqpar.make_melhubert_seqpar_distill_step(
        exts["f32"].model, student, mesh, temperature=SEQPAR_TEMPERATURE,
        alpha=SEQPAR_ALPHA, loss_type=key[0], compute_dtype=key[1])
        for key in keys}

    def serve(e):
        return e.forward_seqpar(wav, mesh, featurizer="device")

    def step(key):
        with matmul_precision("highest"):
            return steps[key](params, batch, None, mask_indices=(
                mask if key[0] == "masked" else None))

    def timing(fn):
        fn()  # warm
        coll["ms"] = 0.0
        t0 = now()
        fn()
        ms = 1e3 * (now() - t0)
        return ms, coll["ms"] / ms

    if timing_mode:
        torch.cuda.reset_peak_memory_stats()
        times = {tag: timing(lambda e=e: serve(e))
                 for tag, e in exts.items()}
        times["distill bf16"] = timing(lambda: step(keys[0]))
        return [dict(tag="seqpar_timing", kind="seqpar", times=times,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     seconds=time.perf_counter() - t_run)]

    out, records = {}, []
    reset_launch_counts()
    out["serve"] = {tag: serve(e)["last_hidden_state"].float().cpu()
                    for tag, e in exts.items()}
    torch.cuda.synchronize()
    records.append(dict(tag="seqpar_serve", kind="seqpar",
                        counts=dtype_launch_counts(),
                        long_counts=long_launch_counts(),
                        seconds=time.perf_counter() - t_run))
    t_run = time.perf_counter()
    reset_launch_counts()
    out["distill"] = {}
    for key in keys:
        loss, grads, logs = step(key)
        if key[1] == torch.float32:
            out["distill"][key[0]] = (
                float(loss), {k: float(v) for k, v in logs.items()},
                {k: g.float().cpu() for k, g in zip(params, grads)})
        del grads
    torch.cuda.synchronize()
    records.append(dict(tag="seqpar_distill", kind="seqpar",
                        counts=dtype_launch_counts(),
                        long_counts=long_launch_counts(),
                        seconds=time.perf_counter() - t_run))
    if mesh.rank == 0:
        torch.save(out, run["out"])
    return records


def parallel_reference(argv, expdir: pathlib.Path, replay: bool):
    """The 1-process run of a phase run's argv in this process (no
    --multi_host) into ``expdir``, f32 with TF32 off; with ``replay`` on
    the dataset's replay of the data ranks' global batches
    (process_index None): (runner, each update's gradient by name and
    sample size as its apply took them)."""
    from speech_ssl_compression_tpu_torch.configs import read_yaml
    from speech_ssl_compression_tpu_torch.train.__main__ import get_args
    from speech_ssl_compression_tpu_torch.train.runner import Runner

    args = get_args([a for a in argv if a not in (
        "--multi_host", "--dist_backend", "gloo")])
    args.expdir, args.model_parallel = str(expdir), 1
    grads = []

    class Reference(Runner):
        def _data_shard(self):
            return (dict(process_index=None, process_count=PAR_RANKS)
                    if replay else super()._data_shard())

        def apply(self, update, sample_size):
            grads.append(({k: g.detach().float().clone() for k, g in
                           zip(self.params, update)}, float(sample_size)))
            return super().apply(update, sample_size)

        def save(self, *args, **kwargs):
            pass  # a yardstick: its parameters are read in memory

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        runner = Reference(args, read_yaml(args.runner_config),
                           read_yaml(args.upstream_config))
        runner.train()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return runner, grads


def named_params(tree: dict, dev) -> dict:
    """A checkpoint's MelHuBERT tree as {name: f32 tensor on ``dev``} under
    the trainer's names."""
    from speech_ssl_compression_tpu_torch.utils.torch_convert import (
        params_to_state_dict,
    )

    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in params_to_state_dict(tree).items()}


def plain_adam(start: dict, grads: list, hyper: dict,
               corrected: bool = True) -> dict:
    """{name: f32 tensor}: the parameters after one Adam update from
    ``start`` for each (``{name: gradient}``, sample size) of ``grads``,
    written here apart from the port's fused apply with the arithmetic of
    JAX's ``_fused_apply``: the clip on the norm of the whole gradient over
    the sample size, L2 (``weight_decay``) added after the clip, the
    moments, and the bias corrections and schedule on the step's count
    (``corrected=False`` drops the corrections: a planted fault). ``hyper``
    is the trainer's (``runner.optimizer``)."""
    b1, b2, eps = hyper["b1"], hyper["b2"], hyper["eps"]
    wd, clip = hyper["weight_decay"], hyper["clip"]
    schedule = hyper.get("schedule")
    p = {k: v.detach().float().clone() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    for t, (g, size) in enumerate(grads, 1):
        norm = torch.sqrt(sum(torch.sum(torch.square(g[k].float()))
                              for k in p)) / size
        scale = clip / norm if 0 < clip <= norm else 1.0
        lr = (float(schedule(torch.tensor(t, dtype=torch.int32)))
              if schedule is not None else hyper["lr"])
        c1, c2 = ((1.0 - b1 ** t, 1.0 - b2 ** t) if corrected
                  else (1.0, 1.0))
        for k in p:
            ge = g[k].float() * (scale / size)
            if wd > 0:
                ge = ge + wd * p[k]
            m[k] = b1 * m[k] + (1.0 - b1) * ge
            v[k] = b2 * v[k] + (1.0 - b2) * torch.square(ge)
            p[k] = p[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
    return p


def update_check(start: dict, got: dict, ref: dict, grads_got: list,
                 grads_ref: list, hyper: dict) -> dict:
    """How a parallel run's parameters after its updates (``got``) agree
    with the 1-process run's from the same ``start`` (``ref``), all
    {name: tensor} on one device; ``grads_*``: each run's updates as
    plain_adam takes them. Three checks, each of every entry or leaf:

      grads   every update's gradients within GRAD_BAR (rel. L2, as
              grad_errors takes it) of the 1-process run's;
      follow  each run's parameters within JAX's elementwise bar (|d| <=
              PAR_PARAM_ATOL + PAR_PARAM_RTOL |p|) of plain_adam on that
              run's own gradients: the update itself, no allowance;
      past    ``got`` within JAX's bar of ``ref``, but for the entries that
              rounding decides: those where plain_adam of the two runs'
              gradients already lie past the bar. Adam moves an entry by
              about lr whatever its gradient's size, so where a gradient is
              within rounding of 0 (softmax ignores a shift of a row's
              scores: the k_proj biases'; a few entries anywhere) two sums
              of it in other orders step it apart. Their count is returned.

    Returns the worst gradient error with its leaf and update, the counts
    past each bar, and the worst unexplained entry's excess and leaf."""
    names = list(ref)
    out = dict(grad_err=0.0, grad_at=None, n=0, follow_got=0, follow_ref=0,
               follow_excess=0.0, past=0, decided=0, unexplained=0,
               unexplained_excess=0.0, unexplained_at=None)
    if len(grads_got) != len(grads_ref):
        raise ValueError(f"{len(grads_got)} updates against "
                         f"{len(grads_ref)}")
    for t, ((g, _), (r, _)) in enumerate(zip(grads_got, grads_ref), 1):
        errs = grad_errors(names, [g[k] for k in names],
                           [r[k] for k in names])
        i = int(np.argmax(errs))
        if errs[i] >= out["grad_err"]:
            out.update(grad_err=errs[i], grad_at=(names[i], t))
    adam_got = plain_adam(start, grads_got, hyper)
    adam_ref = plain_adam(start, grads_ref, hyper)

    def excess(a, b):  # |a - b| over JAX's bar about b
        return (a - b).abs() / (PAR_PARAM_ATOL + PAR_PARAM_RTOL * b.abs())

    for k in names:
        g, r = got[k].float(), ref[k].float()
        out["n"] += r.numel()
        for key, e in (("follow_got", excess(g, adam_got[k])),
                       ("follow_ref", excess(r, adam_ref[k]))):
            out[key] += int((e > 1.0).sum())
            out["follow_excess"] = max(out["follow_excess"], float(e.max()))
        past = excess(g, r) > 1.0
        decided = excess(adam_got[k], adam_ref[k]) > 1.0
        loose = past & ~decided
        out["past"] += int(past.sum())
        out["decided"] += int(decided.sum())
        if loose.any():
            out["unexplained"] += int(loose.sum())
            worst = float(excess(g, r)[loose].max())
            if worst > out["unexplained_excess"]:
                out.update(unexplained_excess=worst, unexplained_at=k)
    return out


def update_failures(check: dict) -> list:
    """The bars update_check's result misses, as sentences (none: it
    agrees)."""
    fails = []
    if not check["grad_err"] < GRAD_BAR:
        fails.append(f"gradient {check['grad_at']} rel L2 "
                     f"{check['grad_err']:.3e} >= {GRAD_BAR:g}")
    if check["follow_got"] or check["follow_ref"]:
        fails.append(f"{check['follow_got']} + {check['follow_ref']} "
                     "entries past JAX's bar of plain Adam on their own "
                     "gradients")
    if check["unexplained"]:
        fails.append(f"{check['unexplained']} entries past JAX's bar that "
                     f"rounding does not decide ({check['unexplained_at']}, "
                     f"{check['unexplained_excess']:.3g}x)")
    return fails


def describe_update_check(check: dict) -> str:
    return (f"gradients of every update worst rel L2 {check['grad_err']:.3e}"
            f" ({check['grad_at']}, bar {GRAD_BAR:g}); entries past JAX's "
            f"bar (rtol {PAR_PARAM_RTOL:g}, atol {PAR_PARAM_ATOL:g}) of "
            f"plain Adam on the run's own gradients "
            f"{check['follow_got']}, on the 1-process run's "
            f"{check['follow_ref']} (largest |d| over the bound "
            f"{check['follow_excess']:.3g}); of the 1-process run's "
            f"parameters {check['past']} of {check['n']}, rounding decides "
            f"{check['decided']}, the rest {check['unexplained']}")


PAR_PATHS = {"pp_f32": "melhubert pipeline train",
             "pp_bf16": "melhubert pipeline train",
             "seqpar_serve": "melhubert seqpar serve",
             "seqpar_distill": "melhubert seqpar distill"}


def parallel_paths(records: list) -> tuple:
    """({path: {kernel: {"f32": n, "bf16": n}}}, {path: the attention
    kernels' launches past the stream threshold}) of the ranks' records
    ([{tag: record}] per rank), every rank's launches summed: a run's path
    is "parallel <tag>", but the pipeline's two runs and the sequence
    parallel work (PAR_PATHS)."""
    paths, long_paths = {}, {}
    for tag in records[0]:
        if "counts" not in records[0][tag]:
            continue  # seqpar_timing: times only
        path = PAR_PATHS.get(tag, f"parallel {tag}")
        for key, into in (("counts", paths), ("long_counts", long_paths)):
            counts = into.setdefault(path, {})
            for rec in (r[tag] for r in records):
                for name, by in rec[key].items():
                    for k, n in by.items():
                        counts.setdefault(name, {"f32": 0, "bf16": 0})[k] += n
    return paths, long_paths


@contextlib.contextmanager
def parallel_ranks(tmp: str):
    """The PAR_RANKS ranks of the parallel phase and its verifier
    (verify_main), started now (their imports and CUDA contexts overlap
    the phases before it), each rank in ``<tmp>/parallel/rank<r>``, the
    verifier in ``<tmp>/parallel``, their outputs in ``rank<r>.log`` and
    ``verifier.log``; they wait for ``spec.json``, which start_parallel
    writes. Yields {"root", "spec", "procs" (the ranks), "verifier"};
    every process still running on exit is killed."""
    root = pathlib.Path(tmp) / "parallel"
    root.mkdir()
    spec = root / "spec.json"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    try:
        for rank in range(PAR_RANKS):
            cwd = root / f"rank{rank}"
            cwd.mkdir()
            argv, env = parallel_child_command(spec, rank, port)
            logs.append(open(root / f"rank{rank}.log", "w"))
            procs.append(subprocess.Popen(argv, env=env, cwd=cwd,
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        logs.append(open(root / "verifier.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--verify",
             str(spec)], cwd=root, stdout=logs[-1],
            stderr=subprocess.STDOUT))
        yield dict(root=root, spec=spec, procs=procs[:PAR_RANKS],
                   verifier=procs[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


# the runs after wave prune, timed with the card to the ranks
PAR_LATE = ("seqpar_timing", "pp_timing")


def start_parallel(tmp: str, ranks: dict) -> dict:
    """The first half of the parallel phase, run before the w2v2 train
    phase: the f32 and bf16 start checkpoints from the train phase's, and
    the spec of the runs that the ranks run while w2v2 train and wave prune
    run in this process (their times share the card with those phases:
    the data- and tensor-parallel runs, the pipeline's f32 and bf16 runs
    and the sequence-parallel parity run), naming the spec of the rest
    (PAR_LATE, the timings of the new paths), which phase_parallel writes
    once wave prune is done, so that they have the card to the ranks. The
    verifier reads the spec's ``train_ckpt``. Returns what phase_parallel
    needs."""
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    root = ranks["root"]
    train_root = pathlib.Path(tmp) / "train"
    state = load_checkpoint(str(train_root / "exp" / "last-step.npz"),
                            load_opt=False)
    starts = {}
    for dtype in ("f32", "bf16"):
        up = copy.deepcopy(state["meta"]["Upstream_Config"])
        if dtype == "f32":  # the parity runs: no dropout
            up["melhubert"].update(dropout=0.0, attention_dropout=0.0,
                                   activation_dropout=0.0)
        starts[dtype] = str(root / f"start_{dtype}.npz")
        save_checkpoint(starts[dtype], state["params"],
                        meta={"Upstream_Config": up, "Step": 0})
    del state
    csv = str(train_root / "data" / "train.csv")
    # the long phase's 10 ms checkpoint, which seqpar_rank serves
    runs = parallel_runs(root, starts, csv, pathlib.Path(tmp) / "hubert",
                         str(pathlib.Path(tmp) / "long" / "exp" /
                             "last-step.npz"))
    spec, late = ranks["spec"], ranks["root"] / "spec_late.json"
    early = [r for r in runs if r["tag"] not in PAR_LATE]
    spec.with_suffix(".tmp").write_text(json.dumps(
        {"runs": early, "next": str(late),
         "train_ckpt": str(train_root / "exp" / "last-step.npz")}))
    spec.with_suffix(".tmp").rename(spec)  # the ranks poll for it
    log("parallel", f"{PAR_RANKS} ranks sharing cuda:0, backend gloo "
        "(NCCL refuses two ranks on one device), torchrun's variables, "
        f"each from its own directory, started before the w2v2 train phase: "
        f"{len(early)} runs ({', '.join(r['tag'] for r in early)}) while "
        f"w2v2 train and wave prune run, the other "
        f"{len(runs) - len(early)} after them; all "
        f"but seqpar through the CLI's main, e.g. "
        f"{' '.join(runs[0]['argv'])}")
    return dict(runs=runs, late=late, t0=time.perf_counter())


def wait_for(path, what: str) -> pathlib.Path:
    """``path`` once it exists (within PAR_WAIT s)."""
    path = pathlib.Path(path)
    deadline = time.perf_counter() + PAR_WAIT
    while not path.exists():
        if time.perf_counter() > deadline:
            raise SystemExit(f"no {what} at {path} in {PAR_WAIT} s")
        time.sleep(0.2)
    return path


def verify_main(spec_path: str) -> None:
    """The parallel phase's verifier, a process of its own beside the
    ranks (not one of them), started with them: once the first spec is
    written it computes the 1-process yardsticks (the data-parallel replay
    of PAR_F32_UPDATES updates of the global batches, and one run of
    PAR_ONE_UPDATES updates that the tensor- and pipeline-parallel runs
    are both held to), then holds each f32 run to them as soon as both
    ranks have written its records: update_check, the planted faults of
    the data-parallel run, the TP checkpoint served by a 1-process
    extractor. All of it while this script's parent runs w2v2 train and
    wave prune, so that none of it waits in line after them. Writes
    ``<spec>.verify.json``: {"lines": its log lines, "error": the first
    failed check or None}; prints no result line."""
    from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
    from speech_ssl_compression_tpu_torch.utils.checkpoint import (
        load_checkpoint,
    )

    dev = torch.device("cuda", 0)
    torch.zeros((), device=dev)  # the CUDA context, while the parent works
    lines, error = [], None
    try:
        spec = json.loads(wait_for(spec_path, "spec").read_text())
        root = pathlib.Path(spec_path).parent
        by_tag = {r["tag"]: r for r in spec["runs"]}
        start = named_params(load_checkpoint(
            spec["train_ckpt"], load_opt=False)["params"], dev)

        def records(tag):
            return [json.loads(wait_for(f"{spec_path}.{rank}.{tag}.json",
                                        f"{tag} records").read_text())[0]
                    for rank in range(PAR_RANKS)]

        def dumps(run, n):
            dumped = [torch.load(f"{run['dump']}_{i}.pt") for i in range(n)]
            return dumped, [({k: v.to(dev) for k, v in d["grads"].items()},
                             d["sample_size"]) for d in dumped]

        def params_of(tag):
            return named_params(load_checkpoint(str(
                root / "rank0" / f"exp_{tag}" / "last-step.npz"),
                load_opt=False)["params"], dev)

        t0 = time.perf_counter()
        replay, replay_grads = parallel_reference(by_tag["dp_f32"]["argv"],
                                                  root / "replay", True)
        one, one_grads = parallel_reference(by_tag["tp_f32"]["argv"],
                                            root / "one", False)
        lines.append(f"the 1-process yardsticks (the DP replay, "
                     f"{PAR_F32_UPDATES} updates of B = {4 * PAR_RANKS}; one "
                     f"run of {PAR_ONE_UPDATES} updates of B = 4 for TP and "
                     f"the pipeline), in the verifier while the ranks run, "
                     f"{time.perf_counter() - t0:.1f} s")

        # (a) f32 data parallel against the 1-process replay of its batches
        dp = by_tag["dp_f32"]
        recs = records("dp_f32")
        t0 = time.perf_counter()
        got = [h["loss"] for h in recs[0]["log"]]
        want = [h["loss"] for h in replay.log_history]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        dumped, run_grads = dumps(dp, PAR_F32_UPDATES)
        params = params_of("dp_f32")
        check = update_check(start, params, replay.params, run_grads,
                             replay_grads, replay.optimizer)
        fails = update_failures(check)
        lines.append(
            f"dp_f32 against the 1-process replay (B = {4 * PAR_RANKS} a "
            f"step, TF32 off): losses {got} vs {want}, worst rel "
            f"{loss_err:.3e} (bar {PAR_LOSS_RTOL:g}); after "
            f"{PAR_F32_UPDATES} updates: {describe_update_check(check)}, "
            f"{time.perf_counter() - t0:.1f} s")
        if not (len(got) == len(want) == PAR_F32_UPDATES
                and loss_err < PAR_LOSS_RTOL) or fails:
            raise AssertionError(f"data parallel disagrees with the replay: "
                                 f"{fails}")
        # planted faults, from this run's own data, that the check must
        # fail: PAR_CONTROL_LEAF's gradient left at rank 0's own (its
        # updates as a run that skipped its all-reduce takes them; judged
        # with the gradients that run would dump, and with this run's),
        # and Adam without its bias corrections
        t0 = time.perf_counter()
        unreduced = [({**g, PAR_CONTROL_LEAF: d["control"].to(dev)}, n)
                     for (g, n), d in zip(run_grads, dumped)]
        hyper = replay.optimizer
        planted = {
            f"{PAR_CONTROL_LEAF} unreduced": (
                plain_adam(start, unreduced, hyper), unreduced),
            f"{PAR_CONTROL_LEAF} unreduced, judged on the sound gradients": (
                plain_adam(start, unreduced, hyper), run_grads),
            "Adam without bias corrections": (
                plain_adam(start, run_grads, hyper, corrected=False),
                run_grads)}
        for fault, (params, grads) in planted.items():
            missed = update_failures(update_check(
                start, params, replay.params, grads, replay_grads, hyper))
            lines.append(f"dp_f32 planted fault, {fault}: fails {missed}")
            if not missed:
                raise AssertionError(f"the update check passes a planted "
                                     f"fault: {fault}")
        lines.append(f"planted faults checked, "
                     f"{time.perf_counter() - t0:.1f} s")
        del replay, replay_grads, dumped, run_grads, unreduced, planted
        del params

        # (b) f32 tensor and (d) pipeline parallel against the 1-process
        # run
        for tag, grid in (("tp_f32", "heads {} + {} a layer"),
                          ("pp_f32", "layers {} + {} a stage")):
            recs = records(tag)
            t0 = time.perf_counter()
            _, run_grads = dumps(by_tag[tag], PAR_ONE_UPDATES)
            params = params_of(tag)
            check = update_check(start, params, one.params, run_grads,
                                 one_grads, one.optimizer)
            fails = update_failures(check)
            got = [h["loss"] for h in recs[0]["log"]]
            want = [h["loss"] for h in one.log_history]
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            split = ((recs[0]["local_heads"][0], recs[1]["local_heads"][0])
                     if tag == "tp_f32" else
                     (one.cfg.encoder_layers // PAR_RANKS,) * 2)
            lines.append(
                f"{tag} ({grid.format(*split)}) against the 1-process run: "
                f"losses {got} vs {want}, worst rel {loss_err:.3e} (bar "
                f"{PAR_LOSS_RTOL:g}); the gathered gradients and checkpoint "
                f"after {PAR_ONE_UPDATES} updates: "
                f"{describe_update_check(check)}, "
                f"{time.perf_counter() - t0:.1f} s")
            if not (len(got) == len(want) == PAR_ONE_UPDATES
                    and loss_err < PAR_LOSS_RTOL) or fails:
                raise AssertionError(f"{tag} disagrees with the 1-process "
                                     f"run: {fails}")
            del run_grads, params

        # the TP checkpoint serves in a 1-process extractor as the
        # 1-process run's parameters do
        ckpt = root / "rank0" / "exp_tp_f32" / "last-step.npz"
        ext = MelHuBERTExtractor(str(ckpt), device=dev)
        wavs = [np.random.default_rng(i).standard_normal(16000).astype(
            np.float32) * 0.1 for i in range(2)]
        out = ext.forward_packed(wavs)["last_hidden_state"]
        named = dict(ext.model.named_parameters())
        if set(named) != set(one.params):
            raise AssertionError("the extractor's parameters are not the "
                                 "trainer's")
        with torch.no_grad():
            for k, v in named.items():
                v.copy_(one.params[k])
        ref = ext.forward_packed(wavs)["last_hidden_state"]
        err = float((out - ref).abs().max() / ref.abs().mean())
        lines.append(f"the TP checkpoint served by MelHuBERTExtractor: "
                     f"{tuple(out.shape)}, against the 1-process run's "
                     f"parameters max|d|/mean|ref| {err:.3e} (bar "
                     f"{SLICE_BAR:g})")
        if not (bool(out.isfinite().all()) and err < SLICE_BAR):
            raise AssertionError("the TP checkpoint serves other values")
    except AssertionError as e:
        error = str(e)
    pathlib.Path(f"{spec_path}.verify.json").write_text(json.dumps(
        {"lines": lines, "error": error}))


def phase_parallel(dev, gpu: str, tmp: str, ranks: dict, refs: dict,
                   started: dict):
    """Data-, tensor-, pipeline- and sequence-parallel work on the one card:
    PAR_RANKS ranks of the trainer's CLI (--multi_host, gloo, torchrun's
    variables) sharing it, through the flash kernels (and the conv kernels
    in HuBERT's run), from the train phase's checkpoint at full width,
    and the ranks' sequence-parallel serving and distillation from the
    long phase's 10 ms checkpoint (seqpar_rank). ``started``:
    start_parallel's, whose runs the ranks ran during w2v2 train and wave
    prune while the verifier (verify_main) held the f32 runs to their
    1-process yardsticks; now the ranks run PAR_LATE, with the card to
    themselves, and the sequence-parallel outputs are held to the long
    phase's 1-process forward and grad steps (``refs``). Returns {path:
    launch counts per kernel and dtype}, both ranks summed, and {path:
    those past the stream threshold}."""
    t_phase = time.perf_counter()
    root = ranks["root"]
    runs, procs = started["runs"], ranks["procs"]
    by_tag = {r["tag"]: r for r in runs}
    if refs["ckpt"] != by_tag["seqpar"]["ckpt"]:
        raise AssertionError(f"seqpar serves {by_tag['seqpar']['ckpt']}, the "
                             f"long phase wrote {refs['ckpt']}")
    late = started["late"]
    late.with_suffix(".tmp").write_text(json.dumps(
        {"runs": [r for r in runs if r["tag"] in PAR_LATE]}))
    late.with_suffix(".tmp").rename(late)

    t0 = time.perf_counter()
    deadline = t0 + PAR_TIMEOUT
    for p in procs + [ranks["verifier"]]:
        p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    for name, p in [(f"rank{r}", p) for r, p in enumerate(procs)] + [
            ("verifier", ranks["verifier"])]:
        if p.returncode != 0:
            tail = (root / f"{name}.log").read_text()[-6000:]
            raise AssertionError(f"{name} exited {p.returncode}:\n{tail}")
    ranks_s = time.perf_counter() - started["t0"]
    records = [{r["tag"]: r for spec in (ranks["spec"], late)
                for r in json.loads(pathlib.Path(
                    f"{spec}.{rank}.json").read_text())}
               for rank in range(PAR_RANKS)]
    wrote = sorted(os.listdir(root / "rank0"))
    cli_runs = [r for r in runs if "argv" in r]
    if os.listdir(root / "rank1") or len(wrote) != len(cli_runs):
        raise AssertionError(f"rank 1 wrote {os.listdir(root / 'rank1')}, "
                             f"rank 0 {wrote}")
    log("parallel", f"ranks done {ranks_s:.1f} s after the first spec, "
        f"{time.perf_counter() - t0:.1f} s after the second; only "
        f"rank 0 wrote: {wrote}, rank 1's directory empty")
    for tag in records[0]:
        if records[0][tag].get("kind"):
            continue
        for rank, rec in enumerate(r[tag] for r in records):
            last = rec["updates"][-1]
            log("parallel", f"{tag} rank {rank} grid {rec['grid']} local "
                f"heads {rec['local_heads'][0]}: updates "
                f"{[round(u['update_ms'], 1) for u in rec['updates']]} ms; "
                f"the last: grad steps {last['step_ms']:.1f} ms (activation "
                f"all-reduces or the pipeline's sums in them "
                f"{last['collective_ms']:.1f} ms, its sends and receives "
                f"{last['p2p_ms']:.1f} ms), gradient all-reduce "
                f"{last['reduce_ms']:.1f} ms, idle (the host collectives' "
                f"share) {last['idle']:.1%}; peak {rec['peak_gib']:.2f} GiB, "
                f"run {rec['seconds']:.1f} s (saves {rec['save_s']:.1f} s), "
                f"losses {[round(h['loss'], 6) for h in rec['log']]} [{gpu}]")
            if rec["bf16_step"]:
                log("parallel", f"{tag} rank {rank}: one bf16 grad step of "
                    f"its model (dropout 0), after a warm-up: "
                    f"{rec['bf16_step'][0]:.1f} ms, its activation "
                    f"all-reduces {rec['bf16_step'][1]:.1f} ms [{gpu}]")
        if records[0][tag]["log"] != records[1][tag]["log"]:
            raise AssertionError(f"{tag}: the ranks logged different losses")
    for rank in range(PAR_RANKS):
        updates = records[rank]["pp_timing"]["updates"]
        last = updates[-1]
        log("parallel", f"pipeline bf16 (dropout on, S = {PAR_RANKS}, M = "
            f"{PAR_PP_MICROBATCHES}, B = 4 x T = 768) stage {rank}, the card "
            f"to the ranks: updates {[round(u['update_ms'], 1) for u in updates]}"
            f" ms; the last: its grad step {last['step_ms']:.1f} ms, blocked "
            f"in sends and receives {last['p2p_ms']:.1f} ms, in the sums over "
            f"the world {last['collective_ms']:.1f} ms: idle "
            f"{last['idle']:.1%} of the update (GPipe's fill and drain "
            f"alone: "
            f"{(PAR_RANKS - 1) / (PAR_PP_MICROBATCHES + PAR_RANKS - 1):.0%})"
            f" [{gpu}]")

    # (a), (b), (d): the verifier's checks of the f32 runs
    verified = json.loads(pathlib.Path(f"{ranks['spec']}.verify.json")
                          .read_text())
    for line in verified["lines"]:
        log("parallel", line)
    if verified["error"]:
        raise AssertionError(verified["error"])

    # (e) sequence parallel against the long phase's 1-process steps
    check_seqpar(dev, gpu, records, by_tag["seqpar"]["out"], refs)

    paths, long_paths = parallel_paths(records)
    for tag in ("dp_f32", "dp_bf16", "tp_f32"):
        if not all(sum(c.values()) for name, c in paths[f"parallel {tag}"]
                   .items() if name.startswith("flash_attn")):
            raise AssertionError(f"{tag} launched no attention kernel")
    hub = paths["parallel hubert_dp_bf16"]
    if not all(hub.get(n, {}).get("bf16") for n in
               ("conv1d_fwd", "conv1d_dw", "conv1d_dx")):
        raise AssertionError(f"HuBERT's DP run launched no conv kernel: {hub}")
    for path, dtypes, long in (
            ("melhubert pipeline train", ("f32", "bf16"), False),
            ("melhubert seqpar serve", ("f32", "bf16"), True),
            ("melhubert seqpar distill", ("f32", "bf16"), True)):
        for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                     "flash_attn_bwd_dkv"):
            if name != "flash_attn_fwd" and path.endswith("serve"):
                continue
            got = (long_paths if long else paths)[path][name]
            if not all(got[d] for d in dtypes):
                raise AssertionError(f"{path}: {name} launches {got}")
    seq = {k: v for k, v in long_paths.items() if "seqpar" in k}
    log("parallel", f"launches, both ranks: {paths}; the sequence-parallel "
        f"paths' past T = 4096: {seq}; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{gpu}]")
    return paths, long_paths


def check_seqpar(dev, gpu: str, records: list, out_path: str,
                 refs: dict) -> None:
    """The ranks' sequence-parallel serving against the long phase's
    1-process f32 forward of the same utterance and checkpoint (f32
    max|d|/mean|ref| < SLICE_BAR, bf16 rel. L2 < BF16_SLICE_BAR), and its
    f32 distill grad steps against the long phase's 1-process steps
    (loss and logs rel < GRAD_BAR, every gradient rel. L2 < GRAD_BAR,
    grad_errors); the times."""
    t0 = time.perf_counter()
    got = torch.load(out_path)
    ref = refs["serve"].to(dev)
    valid = torch.ones(ref.shape[:2], dtype=torch.bool, device=dev)
    err = rel_err(got["serve"]["f32"].to(dev), ref, valid)
    err16 = rel_l2(got["serve"]["bf16"].to(dev), ref, valid)
    timing = [r["seqpar_timing"] for r in records]
    log("parallel", f"seqpar serve, one {LONG_T}-frame 10 ms utterance on "
        f"{PAR_RANKS} ranks ({LONG_T // PAR_RANKS} query rows a rank "
        f"against all {LONG_T} keys): f32 against the 1-process forward "
        f"max|d|/mean|ref| {err:.3e} (bar {SLICE_BAR:g}), bf16 rel L2 "
        f"{err16:.3e} (bar {BF16_SLICE_BAR:g}); warm, the card to the "
        "ranks: " + "; ".join(f"rank {i}: " + ", ".join(
            f"{tag} {ms:.1f} ms ({LONG_T / ms * 1e3:.0f} frames/s, "
            f"{LONG_SAMPLES / 16000 / ms * 1e3:.1f}x realtime), host "
            f"gathers {share:.1%}" for tag, (ms, share) in r["times"].items()
            if tag in ("f32", "bf16")) for i, r in enumerate(timing))
        + f" [{gpu}]")
    if not (err < SLICE_BAR and err16 < BF16_SLICE_BAR):
        raise AssertionError("sequence-parallel serving disagrees")
    worst = {}
    for loss_type, (ref_loss, ref_logs, ref_grads) in refs["distill"].items():
        loss, logs, grads = got["distill"][loss_type]
        names = list(ref_grads)
        errs = grad_errors(names, [grads[k].to(dev) for k in names],
                           [ref_grads[k].to(dev) for k in names])
        i = int(np.argmax(errs))
        rels = [abs(loss - ref_loss) / abs(ref_loss)] + [
            abs(logs[k] - ref_logs[k]) / max(abs(ref_logs[k]), 1e-30)
            for k in ("hard_loss", "soft_loss")]
        worst[loss_type] = (max(rels), errs[i], names[i])
        if not (max(rels) < GRAD_BAR and errs[i] < GRAD_BAR):
            raise AssertionError(f"seqpar distill {loss_type}: loss/logs rel "
                                 f"{rels}, gradient {names[i]} {errs[i]:.3e}")
    log("parallel", f"seqpar distill at T = {LONG_T}, B = 1, 12 -> 6 layers "
        f"on {PAR_RANKS} ranks, f32 against the 1-process steps (TF32 off): "
        + ", ".join(f"{k}: loss and logs worst rel {a:.3e}, gradients worst "
                    f"rel L2 {b:.3e} ({c})" for k, (a, b, c) in worst.items())
        + f" (bar {GRAD_BAR:g}); the bf16 masked step warm, the card to the "
        "ranks: " + "; ".join(
            f"rank {i} {r['times']['distill bf16'][0]:.1f} ms (host "
            f"collectives {r['times']['distill bf16'][1]:.1%}), peak "
            f"{r['peak_gib']:.2f} GiB" for i, r in enumerate(timing))
        + f"; {time.perf_counter() - t0:.1f} s [{gpu}]")


# the journey phase's JourneySettings; None: the defaults, full width (12
# layers of 768, FFN 3072, 12 heads, K = 512, 64 crops of B = 4 x T = 768,
# 20 ms)
JOURNEY_SETTINGS = None


def journey_schedule():
    """The journey phase's schedule: journey.py's FULL prune sections with
    their events moved to consecutive updates from the first (weight
    pruning under ``always``, the ladder's three rungs at steps 1-3 of 4;
    two head events of 12 heads and two row events of 512 rows, the first
    before any update), 3 pretrain and 2 distill updates, 5 serving
    repeats: a cut in depth for the script's time."""
    from speech_ssl_compression_tpu_torch.journey import FULL

    return dataclasses.replace(
        FULL, pretrain_steps=3, distill_steps=2,
        wp_prune=dict(FULL.wp_prune, pruning_condition="always", warnup=1,
                      period=1),
        wp_total=4, hp_prune=dict(FULL.hp_prune, warm_up=0, interval=1),
        hp_total=2, rp_prune=dict(FULL.rp_prune, warm_up=0, interval=1),
        rp_total=2, serve_reps=5)


def journey_launches(stage: str, layers: int, schedule, heads_scored: int,
                     student: int) -> dict:
    """The attention launches (all f32) one journey stage makes: each
    update a forward per layer (the teacher's too, in distillation) and a
    dQ and dK/dV per trained layer; each data-driven scoring pass a
    forward per layer and a dQ and dK/dV for all but the first layer (its
    context lies past its attention); the held-out evaluation a forward
    per layer of the stage's model; serving, per model, a forward per
    layer for the warm call and each repeat."""
    updates = {"pretrain": schedule.pretrain_steps,
               "weight-prune": schedule.wp_total,
               "head-prune": schedule.hp_total,
               "row-prune": schedule.rp_total,
               "distill-6L": schedule.distill_steps}
    if stage == "serve":
        fwd, bwd = (1 + schedule.serve_reps) * (3 * layers + student), 0
    elif stage == "distill-6L":
        u = updates[stage]
        fwd, bwd = u * (layers + student) + student, u * student
    else:
        u = updates[stage]
        fwd, bwd = u * layers + layers, u * layers
        if stage == "head-prune":
            fwd += heads_scored * layers
            bwd += heads_scored * (layers - 1)
    return {"flash_attn_fwd": {"f32": fwd, "bf16": 0},
            "flash_attn_bwd_dq": {"f32": bwd, "bf16": 0},
            "flash_attn_bwd_dkv": {"f32": bwd, "bf16": 0}}


def same_leaves(a: dict, b: dict) -> bool:
    """Two JAX-layout trees equal bit for bit, leaf by leaf."""
    from speech_ssl_compression_tpu_torch.utils.checkpoint import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(la, lb))


class JourneyChecks:
    """journey.py's ``hook`` in the journey phase: the launch counts of
    each stage (counted from 0 once its trainer is built, read once its
    held-out CE is recorded) and the checks of each stage's artifacts,
    which launch nothing that is counted."""

    def __init__(self, dev, gpu: str, workdir: pathlib.Path, settings,
                 schedule, go=None):
        self.dev, self.gpu, self.workdir = dev, gpu, workdir
        self.settings, self.schedule = settings, schedule
        self.go = go
        self.paths: dict = {}   # {"journey <stage>": per-dtype counts}
        self.rows: dict = {}    # {stage: summary row}
        self.t0 = time.perf_counter()

    def __call__(self, stage: str, when: str, runner, row) -> None:
        if when == "built":
            getattr(self, f"built_{stage.split('-')[0]}", lambda r: None)(
                runner)
            torch.cuda.synchronize()
            reset_launch_counts()
            self.t0 = time.perf_counter()
            return
        torch.cuda.synchronize()
        counts = dtype_launch_counts()
        self.paths[f"journey {stage}"] = counts
        seconds = time.perf_counter() - self.t0
        log("journey", f"{stage}: {seconds:.2f} s counted (a trainer's "
            f"build to its held-out CE; the timed serving); f32 launches "
            + ", ".join(f"{k} {v['f32']}" for k, v in counts.items()
                        if k.startswith("flash")) + f" [{self.gpu}]")
        if stage != "serve":
            self.rows[stage] = row
            self.check_ce(stage, row)
        getattr(self, f"done_{stage.split('-')[0]}", lambda r, w: None)(
            runner, row)
        want = journey_launches(
            stage, self.settings.layers, self.schedule, self.scoring_passes(),
            self.rows.get("distill-6L", {}).get("layers", 0))
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"journey {stage}: launches {counts}, want "
                                 f"{want}")

    def scoring_passes(self) -> int:
        """The head-prune run's scoring forwards: per event, data_ratio of
        the epoch's buckets (N_UTTS / BATCH of equal length) stacked into
        groups of >= 32 rows (Runner._data_driven_head_scores)."""
        pc = self.schedule.hp_prune
        buckets = max(1, int(self.settings.n_utts // self.settings.batch
                             * pc["data_ratio"]))
        group = min(-(-32 // self.settings.batch), buckets)
        return pc["total_steps"] * -(-buckets // group)

    def eval_batch(self) -> dict:
        from speech_ssl_compression_tpu_torch.journey import load_eval_batch

        return load_eval_batch(self.workdir)

    def check_ce(self, stage: str, row: dict) -> None:
        """The stage's CE finite, and the kernels' CE within GRAD_BAR of
        impl="dense" on its checkpoint (f32, TF32 off, the saved mask)."""
        from speech_ssl_compression_tpu_torch.journey import eval_ckpt

        t0 = time.perf_counter()
        got = row["heldout_masked_ce_unrounded"]
        dense, _, _ = eval_ckpt(row["ckpt"], self.eval_batch(),
                                device=self.dev, attn_impl="dense")
        rel = abs(got - dense) / abs(dense)
        log("journey", f"{stage}: held-out masked CE {got:.6f} (kernels) vs "
            f"{dense:.6f} (impl='dense'), rel {rel:.3e} (bar {GRAD_BAR:g}); "
            f"{row['params_m']} M params, heads {row['heads']}, FFN "
            f"{row['ffn']}, {row['layers']} layers; "
            f"{time.perf_counter() - t0:.2f} s")
        if not (np.isfinite(got) and rel < GRAD_BAR):
            raise AssertionError(f"journey {stage}: CE {got} vs dense {dense}")

    def done_weight(self, runner, row) -> None:
        """Each rung's masks in its artifact: exactly round(amount n) of
        the n prunable entries masked."""
        expdir = pathlib.Path(runner.expdir)
        ladder = runner.wp_state.sparsity
        seen = []
        for path in sorted(expdir.glob("*.npz")):
            with np.load(path, allow_pickle=False) as data:
                meta = json.loads(data["meta_json"].tobytes().decode())
                masks = [data[k] for k in data.files
                         if k.startswith("masks/")]
            k = meta["Pruning"]["pruning_times"]
            n = sum(m.size for m in masks)
            masked = n - sum(int(np.count_nonzero(m)) for m in masks)
            want = round(ladder[k - 1] * n) if k else 0
            seen.append(k)
            log("journey", f"weight-prune {path.name}: {k} rungs, {masked} "
                f"of {n} prunable entries masked (round(amount n) = {want})")
            if masked != want:
                raise AssertionError(f"{path.name}: {masked} masked, want "
                                     f"{want}")
        if not (sorted(seen) == list(range(len(ladder) + 1))
                and row["prune_events_fired"] == len(ladder)):
            raise AssertionError(f"the ladder's rungs {seen}, {row}")

    def built_head(self, runner) -> None:
        """The head-prune run starts from stage 2's weights with its masks
        folded, bit for bit, and no live masks."""
        from speech_ssl_compression_tpu_torch.extract import (
            load_any_checkpoint,
        )
        from speech_ssl_compression_tpu_torch.utils.weights import (
            jax_tree_from_named,
        )

        params, _, _ = load_any_checkpoint(self.rows["weight-prune"]["ckpt"])
        same = same_leaves(jax_tree_from_named(runner.params), params)
        log("journey", f"head-prune: its first parameters bitwise stage 2's "
            f"folded weights: {same}; live masks {runner.masks is not None}")
        if not same or runner.masks is not None:
            raise AssertionError("head pruning did not start from stage 2's "
                                 "folded weights")

    def done_head(self, runner, row) -> None:
        """Each event's heads: a host recompute of select_heads_to_prune on
        the scores it wrote."""
        from speech_ssl_compression_tpu_torch.compress import (
            head_pruning as hp,
        )

        pc = self.schedule.hp_prune
        layers = runner.cfg.encoder_layers
        left = sum(self.rows["weight-prune"]["heads"])
        for i, group in enumerate(runner.pruned_heads):
            rows = np.load(pathlib.Path(runner.expdir)
                           / f"heads_and_score_{left}.npy")
            scores = [((int(l), int(h)), float(s)) for l, h, s in rows]
            again = hp.select_heads_to_prune(
                scores, pc["num_heads_each_step"], pc["target"], layers)
            if again != group:
                raise AssertionError(f"head event {i + 1}: {group}, "
                                     f"recomputed {again}")
            left -= pc["num_heads_each_step"]
        log("journey", f"head-prune: the {len(runner.pruned_heads)} events' "
            f"heads equal to a host recompute on heads_and_score_*.npy; heads "
            f"a layer {row['heads']} (ragged: {len(set(row['heads'])) > 1})")
        if (len(runner.pruned_heads) != pc["total_steps"]
                or sum(row["heads"]) != left):
            raise AssertionError(f"head pruning left heads {row['heads']}")

    def done_row(self, runner, row) -> None:
        """Each event's rows: a host recompute of ffn_row_scores on the
        artifact before it; the heads as stage 3 left them."""
        from speech_ssl_compression_tpu_torch.compress import (
            row_pruning as rp,
        )

        step = self.schedule.rp_prune["num_rows_each_step"]
        left = min(self.rows["head-prune"]["ffn"])
        for i, e in enumerate(runner.prune_event_log):
            layers = read_layers(pathlib.Path(runner.expdir)
                                 / f"states_prune_{left}.npz",
                                 ("fc1", "fc2"))["encoder"]["layers"]
            again = [rp.rows_to_keep(rp.ffn_row_scores(l), step)
                     for l in layers]
            if not all(np.array_equal(a, k) for a, k in zip(again,
                                                            e["kept"])):
                raise AssertionError(f"row event {i + 1} kept other rows "
                                     "than the host recompute")
            left -= step
        log("journey", f"row-prune: the {len(runner.prune_event_log)} "
            f"events' rows equal to a host recompute on the artifact before "
            f"each; FFN {row['ffn']}, heads {row['heads']}")
        if (row["ffn"] != [left] * row["layers"]
                or row["heads"] != self.rows["head-prune"]["heads"]):
            raise AssertionError(f"row pruning: {row}")

    def built_distill(self, runner) -> None:
        """A 6-layer student; the teacher bitwise stage 1's weights."""
        from speech_ssl_compression_tpu_torch.extract import (
            load_any_checkpoint,
        )
        from speech_ssl_compression_tpu_torch.utils.weights import (
            jax_tree_from_named,
        )

        params, _, _ = load_any_checkpoint(self.rows["pretrain"]["ckpt"])
        same = same_leaves(jax_tree_from_named(dict(
            runner.teacher.named_parameters())), params)
        want = self.rows["pretrain"]["layers"] // 2
        log("journey", f"distill: student {runner.cfg.encoder_layers} "
            f"layers, teacher {runner.teacher_cfg.encoder_layers} layers "
            f"bitwise stage 1: {same}")
        if not same or runner.cfg.encoder_layers != want:
            raise AssertionError("distillation's teacher or student is wrong")

    def built_serve(self, runner) -> None:
        """Before the timed serving: the quality curve over every
        checkpoint (journey_curve.curve, its launches counted as "journey
        curve"), then each served model's forward with the kernels
        against impl="dense" (f32, TF32 off, every hidden state):
        SLICE_BAR. With ``go`` (the journey in a process of its own, beside
        the parent's phases), ``<go>.ready`` is written and the serving
        waits for ``go``: the parent writes it once the card is its."""
        self.check_curve()
        self.check_serving()
        if self.go is not None:
            torch.cuda.empty_cache()
            pathlib.Path(f"{self.go}.ready").touch()
            wait_for(self.go, "go for the journey's timed serving")

    def check_curve(self) -> None:
        from speech_ssl_compression_tpu_torch import journey, journey_curve

        t0 = time.perf_counter()
        reset_launch_counts()
        points = journey_curve.curve(self.workdir, device=self.dev)
        torch.cuda.synchronize()
        self.paths["journey curve"] = dtype_launch_counts()
        ces = [p["heldout_masked_ce"] for p in points]
        log("journey", f"quality curve: {len(points)} checkpoints, CE "
            f"{min(ces)}-{max(ces)}, {time.perf_counter() - t0:.2f} s "
            f"[{self.gpu}]")
        if not (len(points) > len(self.rows) and np.isfinite(ces).all()
                and {p["stage"] for p in points} == {
                    s for s, _ in journey.STAGE_DIRS}):
            raise AssertionError(f"the quality curve: {points}")

    def check_serving(self) -> None:
        from speech_ssl_compression_tpu_torch.extract import MelHuBERTExtractor
        from speech_ssl_compression_tpu_torch.journey import serve_forward

        batch = self.eval_batch()
        feat, pad = (torch.from_numpy(batch[k]).to(self.dev)
                     for k in ("feat", "pad_mask"))
        valid = pad.bool()
        errs = {}
        for stage in ("pretrain", "weight-prune", "row-prune", "distill-6L"):
            ext = MelHuBERTExtractor(self.rows[stage]["ckpt"],
                                     fp=self.settings.frame_period,
                                     device=self.dev)
            got = serve_forward(ext, feat, pad)
            ext.attn_impl = "dense"
            errs[stage] = rel_err(got, serve_forward(ext, feat, pad), valid)
            if not torch.isfinite(got).all():
                raise AssertionError(f"{stage} serves non-finite features")
            del ext
        log("journey", "serving, kernels vs impl='dense' (f32, TF32 off), "
            "max|d|/mean|ref|: " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
            + f" (bar {SLICE_BAR:g})")
        if not max(errs.values()) < SLICE_BAR:
            raise AssertionError("a served journey model disagrees with "
                                 "impl='dense'")


def phase_journey(dev, gpu: str, tmp: str, go=None) -> dict:
    """journey.py's run_journey at full width (JourneySettings: 12 layers
    of 768, FFN 3072, 12 heads, K = 512, B = 4 x T = 768, f32) with
    journey_schedule, every stage checked by JourneyChecks, the quality
    curve over every checkpoint before the timed serving (which waits for
    ``go`` where given). Returns the launch counts per stage, {"journey
    <stage>": per-dtype counts}."""
    from speech_ssl_compression_tpu_torch import journey

    t0 = time.perf_counter()
    workdir = pathlib.Path(tmp) / "journey"
    settings = JOURNEY_SETTINGS or journey.JourneySettings()
    schedule = journey_schedule()
    checks = JourneyChecks(dev, gpu, workdir, settings, schedule, go)
    summary = journey.run_journey(workdir, settings, schedule, device=dev,
                                  hook=checks)
    stages = summary["stages"]
    log("journey", "stages: " + "; ".join(
        f"{r['stage']} CE {r['heldout_masked_ce_unrounded']:.6f}, "
        f"{r['params_m']} M params, {r['wall_sec']} s"
        + (f", sparsity {r['sparsity']}" if "sparsity" in r else "")
        for r in stages) + f"; k-means {summary['data']['kmeans_sec']} s "
        f"(inertia/row {summary['data']['kmeans_inertia_per_row']:.4f}), "
        f"data {summary['data']['wall_sec']} s; serving frames/s "
        f"{summary['serving_frames_per_sec']} ({summary['serving_clock']}, "
        f"the card to itself); workdir {summary['workdir_bytes']} bytes "
        f"[{gpu}]")
    shutil.rmtree(workdir)
    log("journey", f"phase {time.perf_counter() - t0:.2f} s")
    return checks.paths


JOURNEY_WAIT = 600  # seconds the parent waits for the journey's process


@contextlib.contextmanager
def journey_process(tmp: str):
    """The journey phase in a process of its own (this script with
    --journey, journey_main), started now: its imports and CUDA context
    overlap the phase running meanwhile, and it waits for
    journey_start. Its stages, checks and curve then share the card with
    the phases that follow, as the parallel ranks do, and its timed
    serving waits for ``go``, which phase_journey_join writes once the
    card is the journey's. Output in ``journey.log``. Yields {"root",
    "proc", "go"}; the process is killed on exit if it still runs."""
    root = pathlib.Path(tmp) / "journey_process"
    root.mkdir()
    go = root / "go"
    with open(root / "journey.log", "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--journey",
             str(go)], cwd=root, stdout=out, stderr=subprocess.STDOUT)
        try:
            yield dict(root=root, proc=proc, go=go)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def journey_main(go: str) -> None:
    """The journey phase's process: its imports and CUDA context, then,
    once ``<go>.start`` exists, phase_journey in ``go``'s directory, its
    launch counts per stage written to ``<go>.json``."""
    from speech_ssl_compression_tpu_torch import journey  # noqa: F401
    from speech_ssl_compression_tpu_torch.train import runner  # noqa: F401

    dev = torch.device("cuda", 0)
    torch.zeros((), device=dev)
    gpu = gpu_name_and_power()
    go = pathlib.Path(go)
    wait_for(f"{go}.start", "start for the journey")
    paths = phase_journey(dev, gpu, str(go.parent), go=go)
    pathlib.Path(f"{go}.json").write_text(json.dumps(paths))


def journey_wait(run: dict, path: pathlib.Path, what: str) -> None:
    """``path`` once it exists; fails with the tail of the journey's log
    if its process ends first or JOURNEY_WAIT s pass."""
    deadline = time.perf_counter() + JOURNEY_WAIT
    while not path.exists():
        if run["proc"].poll() is not None or time.perf_counter() > deadline:
            tail = (run["root"] / "journey.log").read_text()[-4000:]
            raise AssertionError(f"the journey's process gave no {what} "
                                 f"(exit {run['proc'].poll()}):\n{tail}")
        time.sleep(0.2)


def journey_start(run: dict) -> None:
    """Lets the journey's process start its stages."""
    pathlib.Path(f"{run['go']}.start").touch()


def journey_ready(run: dict) -> None:
    """Waits until the journey's process has done all but its timed
    serving (before the phases that time with the card to themselves)."""
    journey_wait(run, pathlib.Path(f"{run['go']}.ready"), "ready signal")


def phase_journey_join(run: dict) -> dict:
    """Gives the journey's process the card for its timed serving, waits
    for it to end, prints its journey lines and returns its launch counts
    per stage."""
    journey_ready(run)
    run["go"].touch()
    journey_wait(run, pathlib.Path(f"{run['go']}.json"), "result")
    run["proc"].wait(timeout=JOURNEY_WAIT)
    for line in (run["root"] / "journey.log").read_text().splitlines():
        if line.startswith(("[journey]", "[curve]", "|")):
            print(line, flush=True)
    if run["proc"].returncode != 0:
        raise AssertionError(f"the journey's process exited "
                             f"{run['proc'].returncode}")
    return json.loads(pathlib.Path(f"{run['go']}.json").read_text())


def attention_library_ms(dev, gpu: str, dtype):
    """F.scaled_dot_product_attention's times in ``dtype`` (f32 with TF32
    off), the flash kernels' library yardstick (timed here, never called by
    the port): {(kernel, case): ms}. The forward at the serving shape with
    the packed segments as a boolean mask, at the training shape with key
    padding and dropout 0.1 (its own random mask), at T = 5000 and T =
    LONG_T and at 1024 x 5000 with key padding; the backward (dq, dk and dv
    in one call, the yardstick of the dQ and dK/dV pair) at the training
    shape with key padding and dropout 0.1, at T = 5000 and T = LONG_T and
    at 1024 x 5000."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(5)
    seg = packed_segments(SERVE_LENGTHS, CAPACITY, dev)

    def randn(shape, grad=False):
        return (torch.randn(shape, generator=gen, device=dev).to(dtype)
                .requires_grad_(grad))

    def keep(pad):  # (B, Tk) padding -> a mask that keeps the valid keys
        return ~pad[:, None, None, :]

    pad_rect = rect_padding(dev)
    cases = {
        "serving": ((seg.shape[0], 12, CAPACITY, 64), None,
                    (seg[:, None, :, None] == seg[:, None, None, :])
                    & (seg != 0)[:, None, None, :], 0.0),
        "training_dropout": (TRAIN_SHAPE, None, keep(train_padding(dev)),
                             DROPOUT_P),
        "long": ((1, 12, 5000, 64), None, None, 0.0),
        "rectangular": ((1, 12, 1024, 64), (1, 12, 5000, 64), keep(pad_rect),
                        0.0),
        "long_8192": ((1, 12, LONG_T, 64), None, None, 0.0),
    }
    out = {}
    for case, (qs, ks, mask, p) in cases.items():
        q = randn(qs, True)
        k, v = randn(ks or qs, True), randn(ks or qs, True)

        def fwd():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  dropout_p=p)

        with torch.no_grad():
            out["flash_attn_fwd", case] = cuda_ms(fwd, reps=1, inner=5)
        if case == "serving":
            continue
        o = fwd()
        dout = randn(qs)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), dout,
                                                     retain_graph=True),
                         reps=1, inner=5)
        out["flash_attn_bwd_dq", case] = out["flash_attn_bwd_dkv", case] = (
            bwd_ms)
        del o, q, k, v, dout
    log("timing", f"F.scaled_dot_product_attention {dtype}: " + ", ".join(
        f"{'forward' if n == 'flash_attn_fwd' else 'backward'} at {c} "
        f"{ms:.3f} ms" for (n, c), ms in out.items()
        if n != "flash_attn_bwd_dkv") + f" [{gpu}]")
    return out


def attention_work(q_shape, tk: int, pairs: float, dtype,
                   segments: bool = False) -> dict:
    """{kernel: (FLOPs, bytes)} of the forward, dQ and dK/dV kernels for q
    (B, H, Tq, d) against tk keys, where ``pairs`` (query, key) pairs per
    head, summed over the batch, survive the masks: 4 d (QK^T and PV),
    6 d (QK^T, dO V^T, dS K) and 8 d (and dS^T Q, Pd^T dO) FLOPs per pair
    and head. Bytes: every input read once and every output written once,
    q/k/v/dO/out and their gradients in ``dtype``, the bias, LSE and D in
    f32, segment ids in int32."""
    b, h, tq, d = q_shape
    size = torch.tensor([], dtype=dtype).element_size()
    q_t, k_t = b * h * tq * d * size, b * h * tk * d * size
    row_f32, key_f32 = b * h * tq * 4, b * tk * 4  # LSE or D; the bias
    masks = key_f32 + (4 * b * (tq + tk) if segments else 0)
    return {"flash_attn_fwd": (4 * d * h * pairs,
                               2 * q_t + 2 * k_t + masks + row_f32),
            "flash_attn_bwd_dq": (6 * d * h * pairs,
                                  3 * q_t + 2 * k_t + masks + 2 * row_f32),
            "flash_attn_bwd_dkv": (8 * d * h * pairs,
                                   2 * q_t + 4 * k_t + masks + 2 * row_f32)}


def attention_bounds(dtype) -> dict:
    """{(kernel, case): (ms, bound_by)} of the flash kernels in ``dtype`` at
    the line's shapes: the forward at the serving batch, counting only the
    (query, key) pairs of one segment; every kernel at the training shape
    (every query row against the valid keys), at T = 5000 and at T =
    LONG_T (every pair) and at 1024 x 5000 (every query against the 4,800
    valid keys)."""
    seg = packed_segments(SERVE_LENGTHS, CAPACITY, "cpu")
    serving = (seg.shape[0], 12, CAPACITY, 64)
    work = {
        "serving": attention_work(serving, CAPACITY,
                                  float(sum(n * n for n in SERVE_LENGTHS)),
                                  dtype, segments=True),
        "training_dropout": attention_work(
            TRAIN_SHAPE, TRAIN_SHAPE[2],
            float(TRAIN_SHAPE[2] * sum(TRAIN_LENGTHS)), dtype),
        "long": attention_work((1, 12, 5000, 64), 5000, 5000.0 * 5000, dtype),
        "rectangular": attention_work((1, 12, 1024, 64), 5000,
                                      1024.0 * RECT_VALID_KEYS, dtype),
        "long_8192": attention_work((1, 12, LONG_T, 64), LONG_T,
                                    float(LONG_T) * LONG_T, dtype),
    }
    out = {}
    for case, per_kernel in work.items():
        for name, (flops, n_bytes) in per_kernel.items():
            if case == "serving" and name != "flash_attn_fwd":
                continue
            out[name, case] = bound(flops, n_bytes, dtype)
    return out


def launch_fields(name: str, paths: dict, long_paths=None) -> dict:
    """A kernel's launches on the main paths, from {path: {kernel: {"f32":
    n, "bf16": n}}}: in all (launches), per dtype (launches_by_dtype) and
    per path and dtype (launches_by_path); with ``long_paths``, the same
    counts of its launches past the stream threshold, per dtype
    (launches_past_4096) and per path and dtype
    (launches_past_4096_by_path)."""
    def per_path(counts_by_path):
        by_path = {p: dict(counts.get(name, {"f32": 0, "bf16": 0}))
                   for p, counts in counts_by_path.items()}
        return by_path, {tag: sum(c[tag] for c in by_path.values())
                         for tag in ("f32", "bf16")}

    by_path, by_dtype = per_path(paths)
    out = dict(launches=sum(by_dtype.values()), launches_by_dtype=by_dtype,
               launches_by_path=by_path)
    if long_paths is not None:
        long_by_path, long_by_dtype = per_path(long_paths)
        out.update(launches_past_4096=long_by_dtype,
                   launches_past_4096_by_path=long_by_path)
    return out


def merge(into: dict, more: dict) -> None:
    """Adds the fields of ``more``'s records to ``into``'s, key by key."""
    for key, fields in more.items():
        into.setdefault(key, {}).update(fields)


def check_tensor_cores(kernels) -> dict:
    """HGMMA instructions (Hopper's warpgroup tensor-core products) per
    kernel of the built library, from cuobjdump -sass; fails unless every
    instance of each TENSOR_CORE_KERNELS kernel (the attention forward, dQ
    and dK/dV and the conv forward, dW and dX, bf16 and f32) has some.
    Returns {(kernel, "bf16" or "f32"): count, summed over its instances
    (the attention forwards have four: with and without dropout, with and
    without segment ids)}."""
    counts = kernels.sass_instruction_counts("HGMMA")
    for symbol, n in counts.items():
        short = next((k for k in KERNEL_SYMBOLS if k in symbol), symbol[:80])
        flags = re.search(r"ILb([01])ELb([01])E", symbol)
        if "I13__nv_bfloat16" in symbol:
            short += "<bf16>"
        elif "IfE" in symbol:
            short += "<f32>"
        elif flags:  # the bf16 forward's <dropout, segments>
            short += "<{}, {}>".format(
                *(("no " if f == "0" else "") + what for f, what in
                  zip(flags.groups(), ("dropout", "segments"))))
        log("build", f"SASS: {n} HGMMA in {short}")
    out = {}
    for (name, tag), symbol in TENSOR_CORE_KERNELS.items():
        found = [n for sym, n in counts.items() if symbol in sym]
        if not found or not all(found):
            raise AssertionError(f"{symbol} has no HGMMA instruction: the "
                                 f"{tag} {name} does not run on the tensor "
                                 "cores")
        out[name, tag] = sum(found)
    return out


def attention_entry(name: str, record: dict, bounds: dict,
                    library: dict) -> dict:
    """The kernels-line entry of one flash kernel: at its main case (the
    serving batch for the forward, the training shape with dropout for the
    backward) its f32 numbers and, under keys ending in _bf16, its bf16
    ones; every other timed case under "cases", per dtype."""
    def numbers(case, dtype, tag):
        ms, by = bounds[dtype][name, case]
        return dict(record[name, case, tag], bound_ms=ms, bound_by=by,
                    library_ms=library[dtype].get((name, case)))

    main = "serving" if name == "flash_attn_fwd" else "training_dropout"
    entry = dict(name=name, source=ATTN_SOURCES[name],
                 replaces=ATTN_REPLACES[name],
                 **numbers(main, torch.float32, "f32"))
    entry.update({k + "_bf16": v for k, v in
                  numbers(main, torch.bfloat16, "bf16").items()})
    entry["cases"] = {
        case: {tag: numbers(case, dtype, tag) for dtype, tag in
               ((torch.float32, "f32"), (torch.bfloat16, "bf16"))}
        for case in TIMED_CASES
        if case != main and (name, case, "f32") in record
        and "ms" in record[name, case, "f32"]}
    return entry


PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall time added to PHASE_SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = (PHASE_SECONDS.get(name, 0.0)
                               + time.perf_counter() - t0)
        log("clock", f"{name}: {time.perf_counter() - t0:.1f} s, "
            f"{time.perf_counter() - T_START:.1f} s since torch's import")


@contextlib.contextmanager
def unread_saves_skipped(phase: str, keep):
    """The trainers' checkpoint saves skipped for the duration where
    ``keep("<expdir name>/<file>")`` is false: writes of ~0.6-1.1 GB that
    no check of ``phase`` reads, cut for the script's time. The
    skips are logged."""
    from speech_ssl_compression_tpu_torch.train.runner import Runner
    from speech_ssl_compression_tpu_torch.train.wave_runner import WaveRunner

    saves = {cls: cls.save for cls in (Runner, WaveRunner)}
    skipped = []

    def make(orig):
        def save(self, step, name, *args, **kwargs):
            path = f"{os.path.basename(str(self.expdir))}/{name}"
            if keep(path):
                return orig(self, step, name, *args, **kwargs)
            skipped.append(path)
        return save

    for cls, orig in saves.items():
        cls.save = make(orig)
    try:
        yield skipped
    finally:
        for cls, orig in saves.items():
            cls.save = orig
        if skipped:
            log(phase, f"skipped {len(skipped)} checkpoint saves that no "
                f"check reads: {skipped}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile forward_packed per path and the "
                        "grad step")
    parser.add_argument("--child", default=None, metavar="SPEC",
                        help="run as one rank of the parallel phase "
                        "(parallel_child_command)")
    parser.add_argument("--verify", default=None, metavar="SPEC",
                        help="run as the parallel phase's verifier "
                        "(verify_main)")
    parser.add_argument("--journey", default=None, metavar="GO",
                        help="run the journey phase in this process "
                        "(journey_main)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    if args.child:
        child_main(args.child)
        return
    if args.verify:
        verify_main(args.verify)
        return
    if args.journey:
        journey_main(args.journey)
        return
    from speech_ssl_compression_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    gpu = gpu_name_and_power()
    print(f"gpu: {gpu}", flush=True)
    bound(0, 0, torch.float32)  # the card's peaks are known, or it raises

    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.load()
    log("build", f"nvcc {' '.join(_kernels.NVCC_FLAGS)} -> {lib.name}, "
        f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in "
        f"parallel)")
    for line in _kernels.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", line.strip())
    hgmma = check_tensor_cores(_kernels)

    PHASE_SECONDS["build"] = time.perf_counter() - t0
    record = timed("kernels", phase_kernels, dev, gpu)
    merge(record, timed("backward", phase_backward, dev, gpu))
    conv = timed("conv", phase_conv, dev, gpu)
    timed("grouped conv", phase_grouped_conv, dev, gpu)
    library = {dtype: timed("library", attention_library_ms, dev, gpu, dtype)
               for dtype in (torch.float32, torch.bfloat16)}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as journey_stack, \
            contextlib.ExitStack() as stack:
        serve, extractors, wavs = timed("slice", phase_slice, dev, gpu, tmp)
        timed("slice", phase_timing, extractors, wavs, gpu)
        timed("grouped conv", grouped_conv_serve, extractors, wavs, gpu)
        if args.profile:
            timed("profile", phase_profile, extractors, wavs, gpu)
        wave_serve, wave_stream = timed("wave serve", phase_wave_serve, dev,
                                        gpu, tmp, extractors)
        del extractors
        stream, causal_serve = timed("stream", phase_stream, dev, gpu)
        csv = timed("preprocess", phase_preprocess, dev, gpu, tmp)
        with unread_saves_skipped("train", lambda p: not p.endswith(
                "states-epoch-0.npz")):
            runner, batch, train, snapshot = timed("train", phase_train, dev,
                                                   gpu, tmp, csv)
        merge(record, timed("train", phase_train_timing, runner, batch, gpu))
        timed("grouped conv", grouped_conv_grad_step, runner, batch, gpu)
        if args.profile:
            timed("profile", phase_train_profile, runner, batch, gpu)
        timed("resume", phase_resume, dev, gpu, tmp, runner, snapshot, batch)
        fairseq = timed("fairseq dump", phase_fairseq_dump, dev, gpu, tmp,
                        runner)
        device_masks = timed("device masks", phase_device_masks, dev, gpu,
                             runner, batch)
        deep_serve, deep_train = timed("deep pos-conv", phase_deep_pos_conv,
                                       dev, gpu, tmp, batch)
        del runner, batch, snapshot
        weight_prune = timed("weight prune", phase_weight_prune, dev, gpu,
                             tmp)
        with unread_saves_skipped("head prune", lambda p: p != (
                f"l1/states_prune_{12 * (12 - HP_L1_EVENTS)}.npz")):
            head_prune, one_head = timed("head prune", phase_head_prune,
                                         dev, gpu, tmp)
        row_prune = timed("row prune", phase_row_prune, dev, gpu, tmp,
                          one_head)
        with unread_saves_skipped("distill",
                                  lambda p: p == "a/last-step.npz"):
            distill = timed("distill", phase_distill, dev, gpu, tmp,
                            one_head, args.profile)
        journey_run = journey_stack.enter_context(journey_process(tmp))
        with unread_saves_skipped("long", lambda p: p == "exp/last-step.npz"):
            long_counts, long_paths, seqpar_refs = timed(
                "long", phase_long, dev, gpu, tmp, record)
        journey_start(journey_run)
        hubert_serve = timed("hubert serve", phase_hubert_serve, dev, gpu)
        runner, hubert_train, cudnn_model, batch = timed(
            "hubert train", phase_hubert_train, dev, gpu, tmp)
        timed("hubert train", phase_hubert_train_timing, runner, cudnn_model,
              batch, gpu)
        if args.profile:
            timed("profile", phase_hubert_profile, runner, cudnn_model,
                  batch, gpu)
        del runner, cudnn_model, batch
        wave_bench = timed("wave_bench", phase_wave_bench, dev, gpu)
        ranks = stack.enter_context(parallel_ranks(tmp))
        started = timed("parallel", start_parallel, tmp, ranks)
        runner, w2v2_train, cudnn_model, batch = timed(
            "w2v2 train", phase_w2v2_train, dev, gpu, tmp)
        timed("w2v2 train", phase_w2v2_train_timing, runner, cudnn_model,
              batch, gpu)
        if args.profile:
            timed("profile", phase_w2v2_profile, runner, cudnn_model, batch,
                  gpu)
        del runner, cudnn_model, batch
        wave_prune = timed("wave prune", phase_wave_prune, dev, gpu, tmp)
        gc.collect()
        torch.cuda.empty_cache()  # the ranks share the card with us
        timed("journey", journey_ready, journey_run)
        parallel, parallel_long = timed("parallel", phase_parallel, dev,
                                        gpu, tmp, ranks, seqpar_refs,
                                        started)
        stack.close()  # every rank still running is killed
        long_paths.update(parallel_long)
        journey = timed("journey", phase_journey_join, journey_run)

    # launches of each kernel on each main path per dtype, counted from 0
    # just before the path ran and read just after
    paths = {"melhubert serve": serve, "melhubert stream": stream,
             "melhubert wave serve": wave_serve,
             "melhubert wave stream": wave_stream,
             "melhubert causal serve": causal_serve,
             "melhubert train": train,
             "melhubert fairseq dump train": fairseq,
             "melhubert device-mask forward": device_masks,
             "melhubert deep pos-conv serve": deep_serve,
             "melhubert deep pos-conv train": deep_train,
             "melhubert weight-pruning": weight_prune,
             "melhubert head-pruning": head_prune,
             "melhubert row-pruning": row_prune,
             "melhubert distillation": distill,
             "hubert serve": hubert_serve, "hubert train": hubert_train,
             "wav2vec2 train": w2v2_train, **wave_bench, **wave_prune,
             **long_counts, **parallel}
    paths.update(journey)
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if not head_prune[name]["f32"]:
            raise AssertionError(f"no f32 {name} launch on head pruning")
    bounds = {dtype: attention_bounds(dtype)
              for dtype in (torch.float32, torch.bfloat16)}
    entries = [attention_entry(name, record, bounds, library)
               for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                            "flash_attn_bwd_dkv")]
    for e in entries:
        e["source_bf16"] = (FWD_SM90_SOURCE if e["name"] == "flash_attn_fwd"
                            else BWD_SM90_SOURCE)
    entries += [dict(name=name, source=CONV_SOURCES[name],
                     replaces=CONV_REPLACES[name], **conv[name],
                     source_bf16=CONV_SM90_SOURCE)
                for name in ("conv1d_fwd", "conv1d_dw", "conv1d_dx")]
    for e in entries:
        e["hgmma"] = hgmma.get((e["name"], "f32"), 0)
        e["hgmma_bf16"] = hgmma.get((e["name"], "bf16"), 0)
        e.update(route="cuda", **launch_fields(
            e["name"], paths,
            long_paths if e["name"].startswith("flash_attn") else None))
    assert set(launch_counts()) == {e["name"] for e in entries}
    missing = [e["name"] for e in entries if not e["launches"]]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")
    log("total", f"{time.perf_counter() - T_START:.1f} s of wall time from "
        f"torch's import, the build included; per phase "
        + ", ".join(f"{k} {v:.1f} s" for k, v in PHASE_SECONDS.items())
        + f" [{gpu}]")
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
