#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; needs one CUDA card

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the port's CUDA kernels from ``bigdl_tpu_torch/csrc`` (timed), load
   the library (which runs the probe kernel once and raises if it fails or
   is wrong; its verdict is logged; a ``ptxas`` line saying that it
   serialized a kernel's wgmma (C7514) fails the run) and launch each
   kernel once (the backward's dQ and dK/dV entry points also alone);
   beside nvcc, g++ builds the host library (``bigdl_tpu_torch/native.py``;
   timed; a failed build raises);
3. each kernel against its plain PyTorch version on the card, over the
   serving/training shape and the masking/shape edge cases, with stated
   tolerances: the forward [3] (on contiguous tensors and on the
   ``split_heads`` views the LM hands it; a repeat of the serving shape
   must give the same bits) and the backward kernels dQ and dK/dV [3b]
   (also on ``split_heads`` views, at both head dims and on ragged 128-row
   work items; a repeat of the training shape must give the same bits),
   both also at the translation mode's two masks at (8, 8, 2048, 2048, 64)
   bf16 with source lengths drawn from [1024, 2048]: the encoder's
   (non-causal, lengths, ``mask_q=True``) and the cross-attention's
   (non-causal, lengths, ``mask_q=False``);
4. kernel, plain-version and library times beside the card's bound (the
   probe kernel's too, through its C entry point, beside the same entry
   point launching one element: the launch floor;
   ``rms_norm_fwd`` and ``F.rms_norm`` also in turns; SDPA's backward timed
   under each backend that takes the shape, and the one it picks by default
   named; the host's time of one backward call; #1-#3 at the translation's
   two masks beside their bound from the visible pairs and beside SDPA
   given the same key mask as a boolean ``attn_mask``);
5. serving: the full-width Transformer-LM (vocab 8192, hidden 512, 8
   heads, filter 2048, 6 layers, T=2048, random weights from a seed) served
   through ``ModelServer`` — 16 single-record requests from 4 threads, each
   answer checked against a direct forward on the card and one against an
   fp32 CPU forward, and the flash kernel's launches counted;
6. training: the same LM trained through ``LocalOptimizer`` (SGD, lr 0.1,
   ``CrossEntropyCriterion``, batch 8 of 40 records, 10 iterations across
   an epoch boundary) with finite losses and 6 launches per iteration of
   each flash kernel, then 3 steps on the flash route held against 3 steps
   on the dense route from the same weights;
7. flagship training: ResNet-50 (``stem="s2d"``, 1000 classes, random
   weights from a seed) trained through ``LocalOptimizer`` at the repo's
   flagship configuration (batch 128 of 224x224 images drawn as
   ``flagship_model`` draws them, bf16 compute and bf16 activations,
   ``ClassNLLCriterion`` on the raw logits, SGD lr 0.1 momentum 0.9) for 10
   iterations: finite losses, one max-pool backward kernel launch per
   iteration, every BN running statistic moved, device memory flat from
   iteration 3 to 10; then 3 SGD steps of an f32 ResNet-50 on the card
   (kernel route) held against the same 3 steps on the CPU (plain route);
8. VGG-16 training with the fused-kernel switch on: VGG-16 (ImageNet, 1000
   classes, random weights from a seed) with every conv's and hidden fc's
   ReLU declared as its ``activation="relu"`` epilogue, trained through
   ``LocalOptimizer`` (batch 64 of 224x224 images drawn as
   ``flagship_model`` draws them, bf16 compute and activations, dropout on,
   ``ClassNLLCriterion`` on the ``LogSoftMax`` output, SGD lr 0.01 momentum
   0.9) for 10 iterations: finite losses, 15 forward, 13 row-backward and 2
   feature-backward epilogue launches and 5 max-pool backward launches per
   iteration, device memory flat; then 3 f32 SGD steps on the card (kernel
   route) held against the same 3 steps on the CPU (plain route); then
   ``model.evaluate([Top1Accuracy, Top5Accuracy])`` of the trained model
   over one batch of 64 with the switch on (its own path: 15 epilogue
   forward launches and no backward), held against ``model.forward`` on
   the same batch (the same launches and counts);
9. norm-LM training with the fused-kernel switch on: the pipeline example's
   pre-norm block-stack LM (``LookupTable(8192, 512)``, ``PipelinedBlocks``
   of 6 stages of norm -> ``FeedForwardNetwork(512, 2048)`` -> residual add,
   a final norm, ``Linear(512, 8192)``; random weights from a seed) in two
   variants, ``LayerNormalization`` (norm-LM/LN) and ``RMSNorm``
   (norm-LM/RMS), each trained through ``LocalOptimizer`` (``Adam(3e-3)``,
   ``TimeDistributedCriterion(CrossEntropyCriterion(), size_average=True)``,
   batch 8 of 2048 planted-bigram tokens, 24 sequences, bf16 compute and
   activations) for 10 iterations: finite losses, the last below the first,
   7 forward and 7 backward launches of the variant's norm kernels per
   iteration and none of any other kernel, device memory flat; then one
   eval-mode probe forward (7 forward launches); then, per variant, 3 f32
   Adam steps on the card (kernel route) held against the same 3 steps on
   the CPU (plain route) at V 8192, H 512, S 2, batch 2, T 128;
10. the flagship validated, checkpointed and resumed: ResNet-50 as in [7]
   (640 records, 5 batches an epoch) trained 6 iterations through
   ``LocalOptimizer`` with ``set_validation`` every 3 iterations on a
   300-record set at batch 128 (a ragged tail of 44; ``Top1Accuracy``,
   ``Top5Accuracy``, ``Loss(ClassNLLCriterion())``) and ``set_checkpoint``
   every 3 iterations (``keep_last=1``), cuDNN deterministic; then a fresh
   model ``resume()`` s from the step-4 checkpoint and trains iterations
   4-6: losses, parameters and BN state equal to the uninterrupted run's to
   the bit, one max-pool backward launch per training step and no other
   kernel, device memory flat across iterations and validations, one
   checkpoint left on disk after each save, an ``Evaluator`` sweep equal to
   the optimizer's own last validation, and the padded tail's counters
   equal to an unpadded forward of its 44 records (f32); it prints the
   eval images/s at batch 128, each validation's and checkpoint's wall
   time, the checkpoint's size and the resume's load time;
11. BASELINE's five parity configs (``models.parity_config``, the recipe
   of ``bench.py::_measure_one_config``: bf16 compute and activations,
   ``ClassNLLCriterion``, SGD lr 0.01 momentum 0.9, random weights from a
   seed, the bench's one batch every iteration): LeNet-5 at batch 512,
   VGG-for-CIFAR-10 at batch 128 of 32x32 with dropout on, Inception-v1 at
   batch 128 of 224x224 with dropout on, the BiLSTM classifier (vocab
   20001, embedding and hidden 128, T 200) at batch 128, and Wide&Deep
   (wide 5000, embeddings (100, 100, 50) x 16, MLP 64-32) at batch 2048 of
   ``load_criteo``'s synthetic log, a ``Table`` of a ``SparseTensor`` and
   a dense matrix, each trained 10 iterations through ``LocalOptimizer``:
   step ms and records/s, finite losses, 2 / 5 / 13 / 0 / 0 max-pool
   backward launches per iteration and no other kernel, device memory flat
   from iteration 3 to 10; then each one's 3 f32 SGD steps on the card
   (kernel route) held against the same 3 steps on the CPU (plain
   route);
12. the flagship served at ``bench.py::_measure_serving``'s configuration:
   ResNet-50 (``stem="conv7"``, 1000 classes, random weights from a seed,
   bf16 compute) behind ``ModelServer(telemetry=Telemetry())`` with
   ``batch_size=128, max_delay_ms=5``; mix A, the bench's (8 synchronous
   clients, 1024 single-record requests drawn as the bench draws them), with
   a hot-swap (``update``) to a second weight set half-way through, and mix
   B, saturating (256 synchronous clients x 4): requests/s, p50/p99 of
   ``spans()["total_s"]`` by the nearest rank, the mean queue, assembly,
   dispatch and materialize spans, the serve records' flushes and mean
   ``batch_fill``, ``warmup_s``; every request served, each row its
   record's and its version's (nearer its own record's same-geometry row
   than any other's, and within a bf16 limit of a direct batch-1 card
   forward), one row against an f32 CPU forward, one ``serve`` record per
   flush accounting for every request, no flush mixing versions, a 1 ms
   deadline failing typed and counted, an over-``max_pending`` submit
   rejected and counted, device memory flat, and no kernel of this repo
   launched (``flagship_serving`` in the kernels record, all 0);
13. the rest of ``optim/`` and the ``shift`` max-pool gradient, driven by
   the port's ResNet ImageNet recipe (``bigdl_tpu_torch/examples/
   resnet_train.py``, ``examples/resnet/train.py --dataset imagenet``'s
   counterpart): [13a] its ``main()`` at ResNet-50 conv7, 224x224, batch
   128, bf16 activations, lr 0.01, 384 synthetic records (3 iterations an
   epoch), one warmup epoch, 3 epochs, once with ``--lr-schedule
   multistep`` and once with ``poly``: the rate of every iteration equal
   to the schedule's closed form, finite losses, one max-pool backward
   launch a step and none in the 3 validations, Top-1/Top-5 read at each
   epoch end, memory flat after step 2, the step ms, and the card's busy
   share over 2 more profiled iterations; [13b] 3 recipe steps under
   ``BIGDL_MAXPOOL_GRAD_IMPL=shift`` (no kernel launch), then the shift
   gradient at the stem pool (128, 64, 112, 112) 3x3/s2/p1 against kernel
   #10 on tie-free f32 input and card against CPU on post-ReLU bf16 input
   (bit for bit), timed beside #10, ATen's backward and #10's bound;
   [13c] ``ParallelAdam``, ``Adagrad``, ``Adadelta``, ``Adamax``,
   ``RMSprop``, ``Lamb`` and ``LarsSGD`` 3 steps each of the recipe's
   model, ``Ftrl`` 3 steps of Wide&Deep (batch 2048), each step-3 update
   repeated on the CPU from the same f32 gradients, parameters and slots
   (within OPT_ROUTE_REL of the update) and timed alone on the card, and
   ``Adamax`` on an all-zero gradient (the leaf unchanged, no NaN); [13d]
   ``LBFGS`` (lswolfe, 5 iterations, max_eval 40) full batch on LeNet-5 at
   512 records: a non-increasing loss history, at most max_eval feval
   calls, 2 max-pool launches a call; [13e] a LeNet-5 of the port's layers
   with ``L1L2Regularizer`` on every convolution and linear layer, 3
   ``LocalOptimizer`` steps: each logged loss equal to the criterion's
   loss plus the penalty, both recomputed apart;
14. the Transformer's translation mode, rotary positions, decode cache and
   beam search, ``SpatialDilatedConvolution`` and the dropout variants, at
   the LM's full width (``bench.py:929-933``: V 8192, H 512, 8 heads,
   filter 2048, 6 layers, T 2048, batch 8): [14a] ``Transformer(mode=
   "translation")`` (6 + 6 blocks, one shared embedding) trained 10
   iterations through ``LocalOptimizer`` on ``Table [src, tgt]`` batches
   (sources trailing-padded to lengths drawn from [1024, 2048],
   ``pad_masking="lengths"``, attention dropout 0, postprocess and relu
   dropout 0.1, bf16, ``Adam(1e-3)``, ``TimeDistributedCriterion``): finite
   losses, exactly 18 launches of each flash kernel an iteration and
   nothing else, memory flat from iteration 3, step ms, target tokens/s and
   the busy share; then 3 f32 steps on the card held against the CPU at 2 +
   2 blocks, batch 2, T 1024, at two seeds, the card's dense route logged
   beside them as a witness of f32 rounding without the kernel; [14b] the
   rotary LM trained 3 steps (6 of each flash kernel a step), then 64
   ``decode_step_fn`` steps held against one full T = 2048 forward in f32
   (flash route; the decode launches nothing);
   [14c] the port's ``examples/transformer_train.py`` ``main()`` at the LM's
   width (one epoch cut to 4 iterations, a validation, beam 4 over 2 prompts
   for 32 steps): launches a step and in the validation, the decode's ms a
   step and its launches (none), the same beam search on the CPU from the
   same f32 weights (equal sequences, scores within BEAM_SCORE_TOL), and
   ``SequenceBeamSearch`` over [14a]'s trained model (2 sources, beam 4, 16
   steps); [14d] DeepLab-v3's ASPP branches (three 3x3
   ``SpatialDilatedConvolution`` s at dilation 6, 12, 18 on (8, 2048, 33,
   33) bf16, relu, the switch on) forward and backward: 3 #8 and 3 #9b
   launches, card vs CPU in f32 at batch 2 and one SAME-padded case (#8 and
   #9b are held against their plain versions at a branch's (8, 256, 33, 33)
   bf16 in [3d] and timed there in [4]); [14e]
   the five dropout variants on the card (kept shares, whole cells, noise
   statistics, eval identity);
15. the rest of ``models/``, each at the size its users run, with the
   port's card policy (bf16 products, f32 activations): [15a]
   ``bigdl_tpu_torch/examples/alexnet_train.py`` ``main()`` at the
   example's recipe (AlexNet, 1000 classes, 227x227, batch 64, SGD 0.01
   momentum 0.9, one epoch with its validation; 640 synthetic records, the
   one cut): step ms, images/s, the busy share, #10 three times a step
   (pool1/pool2/pool5) and never in the validation, memory flat; [15b]
   ``ncf_train.main()`` at its defaults (Top-1, HitRatio@10 and NDCG@10 in
   [0, 1]) and NeuralCF at MovieLens-1M's tables (6040 users, 3952 items)
   trained one epoch through ``LocalOptimizer``; [15c] ``ptb_train.main
   --vocab-size 10000`` (PTBModel, hidden 200, 2 layers, T 35, batch 32);
   [15d] ``autoencoder_train.main()``; [15e] ``CNNTextClassifier`` (vocab
   20000, T 1000, batch 128, 20 classes) 10 SGD iterations. [15b]-[15e]:
   finite losses, no kernel launched, memory flat. Each model's 3 f32 steps
   on the card then held against the same steps on the CPU at a cut batch
   (``MODEL_ROUTE_ROWS``), within limits fixed before the first run
   (``MODEL_ROUTE_TOL``);
16. the other recurrent cells, the table ops and the rest of activations,
   math_ops and criterion (no kernel of this repo among them: every path
   launches 0): [16a] BASELINE config 4's classifier with a ``GRU``, an
   ``LSTMPeephole`` and an ``RnnCell`` in place of its LSTM, at
   ``parity_config("bilstm")``'s data and recipe (T 200, batch 128, bf16
   compute and activations, SGD 0.01 momentum 0.9; one warm-up iteration,
   then 5); [16b] two ``ConvLSTMPeephole`` layers of 64 channels predicting
   the next 10 of Moving MNIST-sized 64x64 frames (batch 16, seeded values
   in [0, 1], ``BCECriterion``, Adam 1e-3); [16c] a sequence autoencoder,
   ``Recurrent(GRU)`` -> ``Select`` -> ``RecurrentDecoder(200, LSTM)`` at
   width 128, batch 128 (MSE, Adam 1e-3); each with step ms, the host/device
   split, finite losses, 0 launches a step and memory flat, then its 3 f32
   steps on the card held against the CPU at a cut batch
   (``CELL_ROUTE_ROWS``; [16b] without peepholes in its first layer, [16c]
   also with a ``GRU`` decoder); [16d] every new activation, math op, table
   op and criterion forward and backward on the card against the CPU from
   the same weights and inputs (>= 1e6 elements an input; f32, and bf16
   where the module takes it; ``MODULE_TOL``), the clip family at its exact
   bounds and ``RReLU``'s training draws on the card, then 3 SGD steps of a
   ``ConcatTable -> JoinTable``, a ``ParallelTable`` into a
   ``ParallelCriterion`` and a ``MapTable -> CAveTable`` into a
   ``MultiCriterion`` model, card vs CPU;
17. graphs with shared modules, the static analysis and the model file:
   [17a] a Siamese ResNet-50 (the flagship's trunk, conv7, a 128-wide
   embedding, wired at two nodes of an outer ``Graph``;
   ``CosineEmbeddingCriterion(margin=0.5)`` on +-1 targets; 64 seeded
   pairs a step, 128 images of 224x224, bf16 compute and activations, SGD
   0.01 momentum 0.9; one warm-up iteration, then 10) trained through
   ``LocalOptimizer``: one parameter set (a lone trunk's count), exactly
   two max-pool backward launches a step, finite losses, memory flat, step
   ms and the busy share; ``ParamAudit`` passes it; then, in f32 with
   deterministic cuDNN at 8 pairs, its shared gradient against the sum of
   two unshared copies' and its BN running statistics against the second
   copy's, and its 3 f32 steps card vs CPU at 2 pairs; [17b] the trained
   model written by ``save_module`` (topology record included) and loaded
   by ``nn.load_module`` on the card in a fresh process (``jax`` and
   ``bigdl_tpu`` blocked), its eval outputs of a fixed pair batch equal to
   the parent's to the bit; then the flagship ResNet-50's file loaded in
   the parent and served through ``ModelServer`` (16 requests, each row
   within [12]'s limit of the loaded model's direct forward); [17c] the
   passes on the flagship before its first step: GraphValidator, ShapeProp
   (0 launches, no device memory, the real forward's shape and dtype) and
   ParamAudit timed; a flagship whose ``fc`` is declared a wrong input
   width stopped by ``ShapeInferenceError`` naming ``Linear(fc)`` before
   any step or allocation; two ``Linear`` s handed one weight refused by
   ``ParamAudit``; ``validate=False`` trains;
18. detection (no kernel of this repo on these paths: each launches 0):
   [18a] ``MaskRCNN(81)`` at the class's defaults (backbone (32, 64, 128,
   256), FPN 128, 256 pre-NMS and 64 post-NMS proposals, 16 detections,
   box pool 7, mask pool 14; random f32 weights from a seed, eval mode)
   served batch 2 of 800x1344 images (COCO's inference size:
   maskrcnn-benchmark's MIN_SIZE_TEST 800, MAX_SIZE_TEST 1333 padded to a
   multiple of 32) at the port's default policy: 10 timed forwards (host
   and CUDA-event ms, images/s), device memory flat, the peak, one forward
   under ``torch.profiler`` (device events and ms) and one under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), valid
   detections (shapes, corner boxes inside the image, scores non-increasing
   and zero on the padding, labels in [0, 80]); [18a'] the same widths at
   one 256x256 image, card vs CPU in f32 with TF32 off, stage by stage
   within ``DET_ROUTE_TOL`` (backbone and FPN features, the RPN's logits and
   deltas, RoiAlign of the same rois, the heads on the same input), the
   proposals from the CPU's logits and NMS of the same boxes equal, and the
   share of agreeing detections against ``DET_AGREE_MIN``; [18b]
   ``bigdl_tpu_torch/examples/maskrcnn_infer.py`` at its defaults; [18c] a
   COCO ``instances.json`` (polygon and compressed-RLE masks, crowd and
   not) through ``COCODataset.load``, the ground truth padded to
   ``DET_GT`` rows, ``rpn_loss`` and ``fast_rcnn_loss`` on [18a']'s detector
   and their gradients, card vs CPU from the same draws and proposals
   (``DET_LOSS_TOL``); [18d] [18a']'s detector through ``save_module`` /
   ``nn.load_module``: the same detections to the bit;
19. the int8/fp8 serving tiers, MoE, Remat and the tree LSTM: [19a] the
   flagship at ``bench.py::_measure_int8``'s configuration (ResNet-50
   conv7, weights from seed 1, eval mode, batch 128 of 224x224, bf16
   compute): float, ``quantize("int8")`` and ``quantize("fp8")`` forwards
   timed by CUDA events (images/s), one each under
   ``set_sync_debug_mode("error")``, the logits against the float model's,
   and every quantized layer's weight and input codes, scales and
   accumulators on the card's own input (8 of 64x64) against the CPU route
   (int8 to the bit, fp8 within ``FP8_ACC_REL``); [19a'] each tier served
   through ``ModelServer.register(quantize=...)`` at [12]'s mixes, every
   serve record tagged with the family, each checked flush re-forwarded at
   the same geometry and its rows equal to the served ones; [19b]
   ``bench.py``'s MoE model (``Linear(1024, 1024)`` -> ``MoE(4,
   ffn_size=4096, capacity_factor=2.0)`` -> ``Linear(1024, 1000)`` ->
   ``LogSoftMax``, batch 128, ``ClassNLLCriterion``, SGD 0.05 momentum
   0.9) trained top-1 and top-2 10 iterations each on the dense path with
   the load-balancing term in the objective (0 launches, memory flat, the
   busy share), step 1 card vs CPU with equal dropped entries, then the
   model, data and optimizer of ``bigdl_tpu_torch/examples/moe_train.py``
   (its ``build``, on the layer's dense path; the main itself trains
   expert-parallel over spawned ranks in [23e]) at the norm-LM's widths (V
   8192, T 2048, H 512, 8 experts, capacity 1.5, batch 8, the switch on: 2
   #4 and 2 #5 a step) and its graph's step 1 card vs CPU; [19c] [9]'s
   norm-LM/LN trained 10 iterations unwrapped twice (the run-to-run
   difference) and with its stage as ``PipelinedBlocks(nn.Remat(stage,
   policy), 6)`` for ``None`` and ``"dots_saveable"``: step ms, peak
   memory, the busy share, 13 #4 (6 recomputed) and 7 #5 a step, losses and
   weights within the unwrapped run-to-run difference; [19d]
   ``bigdl_tpu_torch/examples/treelstm_train.py`` at its defaults (root
   accuracy, step ms, 0 launches) and its step 1 card vs CPU;
20. the keras API and the rest of ``nn/``: [20a]
   ``bigdl_tpu_torch/examples/keras_train.py`` at its defaults (the keras
   ``Sequential`` CNN, 2048 synthetic digits, batch 64, 2 epochs: 64 steps
   through ``fit``, a validation each epoch, ``evaluate``, then ``predict``
   and ``predict_classes``) with a forward hook on the first convolution
   stashing its output's mean into the state at every step (held against
   the mean recomputed without the hook, then removed: the forward
   unchanged to the bit); #10 exactly 2 a step and none in the
   validations, memory flat, the busy share over 2 more profiled steps; 3
   SGD steps of its model card vs CPU (dropout 0); [20b] C3D (Tran et al. 2015) through ``LocalOptimizer`` at its
   widths (78 M parameters, 3x16x112x112 clips drawn from the seed, batch
   30, 101 classes, bf16 compute and activations, SGD 0.003/0.9) 10
   iterations: step ms, the busy share, peak memory, 0 launches, memory
   flat, the host's batch gather and copy to the card; 3 f32 steps card vs CPU at widths (8, 16, 16, 32, 32), fc 64 and a
   16x32x32 clip, dropout 0; [20c] the U-Net (Ronneberger et al. 2015)
   built with the keras functional API (base 64, 2 classes) served by
   ``Model.predict`` on 8 tiles of 1x572x572 in batches of 4 (bf16):
   CUDA-event ms a call, tiles/s, peak memory, 0 launches, output (8, 2,
   388, 388), one more call's device ms under ``torch.profiler``; card (f32) vs CPU at 188x188 and base 8 (``UNET_ROUTE_REL``);
   [20d] every other class of the slice and the keras breadth table's
   wrappers forward and backward card vs CPU (``MODULE_TOL``), 0
   launches; the three host-scalar divisions of ROADMAP Queue 3 (the beam
   search's length penalty, the attention logits' ``/ sqrt(d)`` at d 48 and
   80, ``SoftPlus(3)``) card vs CPU, plain and through
   ``precision.true_div``, and a beam search at alpha 0.6;
21. the host data path: [21a] 1,280 seeded 224x224x3 uint8 records written
   into 8 record shards, then ``bigdl_tpu_torch/examples/resnet_train.py
   --dataset imagenet --depth 50 --data-dir`` (conv7, batch 128, bf16
   activations) one epoch of 10 steps, the shards decoded by a
   ``ShardedRecordDataSet`` 's threads, batched by a ``DataPipeline`` of 4
   workers and copied by ``LocalOptimizer`` 's prefetch thread: step ms
   (median and range), images/s, the thread's input wait, peak memory,
   exactly one max-pool backward launch a step, memory flat (less the
   staged batches), every step's input on the card equal to the CPU's
   reading of the same epoch, and the device work a step over 2 more
   profiled steps; [21b] a ``DataPipeline`` with ``RandomCrop(224)``, a
   random ``HFlip``, ``ChannelNormalize``, ``MatToTensor`` and
   ``ImageFrameToSample`` over 512 256x256 uint8 records at 0, 4 and 8
   workers: the host's images/s, the streams at 0 and 8 workers equal by
   a hash; [21c] the host library (built by g++ in [2], beside nvcc): the
   build time, ``gather_rows`` at C3D's batch (69 MiB) against numpy (bit
   for bit), its route threshold measured from 64 KiB to 64 MiB,
   ``u8hwc_to_f32chw`` at 128x224x224x3 (within 1e-5) and ``crc32c`` over
   1 MiB against their plain versions, all timed. [13a] and [20b] also
   print the prefetch thread's wait and the host's gather (native and
   numpy) and copy of their batch;
22. data-parallel training across processes: [22a] the ResNet recipe
   (``resnet_train.build``: conv7, 224x224, batch 128, bf16 activations,
   nesterov SGD with ``("_bn", "bias")`` excluded from weight decay)
   through ``Optimizer.apply(model, DataSet.distributed(base, 1), ...)``,
   which gives ``DistriOptimizer`` (sharded), after
   ``Engine.init_distributed`` over NCCL at world size 1: 10 steps (ms a
   step, images/s, peak memory, the flat master's and slots' bytes, one
   max-pool backward launch a step and nothing else, memory flat), one
   update's device kernels on the flat layout against the tree, the device
   work a step over 2 profiled steps; then 3 steps of it against the tree
   and the flat ``LocalOptimizer`` from the same weights under
   deterministic cuDNN (``DISTRI_LOCAL_REL``); [22b] two ranks spawned
   from here sharing the card over gloo (each ``Engine.init_distributed``
   through a file; a rank that fails prints its exit code and the end of
   its stderr, one that outlives ``RANK_DEADLINE_S`` is killed; either
   fails the run): the recipe at global batch 128 and
   ``vgg_train.py``'s VGG-for-CIFAR-10 at 128, 3 steps each (ms a step and
   peak memory a rank, the collectives' operand bytes, #10 1 and 5 a step
   a rank), the ranks'
   parameters and BN state bit-equal after every step, the averaged BN
   state the mean of the ranks' own to the bit, and each run against the
   plain simulation of the 2-rank step (``simulate_step``) on the card
   from rank 0's initial weights (``DISTRI_SIM_REL``); [22c] VGG-for-
   CIFAR-10 at 2 ranks, 4 steps a policy: ``comms_dtype`` bfloat16 and
   int8 with error feedback (the gradient exchange's operand bytes a step
   >= 2x and >= 3.5x under f32), ``master_dtype``/``slot_dtype``
   bfloat16 (the stored master and slot bytes halved), each run's
   parameters held against the f32 run's update (``POLICY_BETA``,
   ``POLICY_REL``; a run that never moves must fail them) and its losses
   within ``POLICY_LOSS_ATOL`` of the f32 run's; ``replicated`` with
   ``flat_update=True`` (``REPLICATED_LOSS_ATOL``); one step clipped by
   the global norm against the simulation (``DISTRI_CLIP_REL``); [22d]
   the 2-rank VGG run checkpointed at step 2 and resumed at 2 ranks,
   equal to the uninterrupted run at step 4 to the bit, and the file
   resumed by a 1-rank ``LocalOptimizer``; and
   ``tools/torch_multiprocess_smoke.py --device cuda``, started beside
   [23e]'s examples. Rehearse [22] on
   the CPU by importing ``chip_smoke`` from a script guarded by
   ``if __name__ == "__main__"`` (the ranks are spawned), setting
   ``DISTRI_DEVICE = "cpu"``, cutting ``DISTRI_RECIPE`` (``--depth 18
   --image-size 32 -b 8 --class-num 10 --synthetic-size 80``) and
   ``DISTRI_VGG`` (``-b 8 --synthetic-size 32``), widening
   ``POLICY_LOSS_ATOL`` (batches of 4 a rank) and ``POLICY_BETA`` and
   ``POLICY_REL`` to what those batches read, and calling
   ``phase_slice23("cpu")`` (~70 s; the launch checks are the card's).
23. the mesh parallelisms, each on ranks spawned here that share the card
   over gloo (NCCL refuses two ranks on one device), from seeded weights
   and planted-bigram or seeded data: [23a] the norm-LM/LN at [9]'s width
   through ``PipelineOptimizer`` on ``make_mesh({"pipe": 6})``, 6 ranks,
   ``n_micro`` 8, bf16, the fused-kernel switch on, ``Adam(3e-3)``, 6
   iterations: finite falling losses equal on every rank, each rank 1/6 of
   every stacked leaf and twice that in Adam slots (its held bytes), 9
   #4 and 9 #5 launches a step a rank (8 microbatches' stage norm and the
   final one) and nothing else, then 3 f32 SGD steps against the
   sequential stack through ``LocalOptimizer`` on rank 0 from the same
   weights (``MESH_TOL``; each f32 check of [23] also runs with one split
   leaf's gradient doubled, which must fail its limits); [23b] the LM at
   [5]/[6]'s width through ``LocalOptimizer`` on every rank of
   ``make_mesh({"sp": 4})`` with the ring registered, bf16, 3 SGD steps:
   0 launches, the ppermute bytes a rank equal to 3 hops x K, V x 6
   layers x the bf16 chunk, forward and backward, a step; after
   ``set_sequence_parallel(None)`` one step on rank 0 launches 6 of each
   flash kernel; then 3 f32 steps of the ring
   against the dense route on rank 0; [23c] the bench's MoE model
   (``MOE_BENCH``) through ``ExpertParallelOptimizer`` on
   ``make_mesh({"expert": 4})``, top-1 and top-2, f32: one expert a rank
   (held bytes), the all-to-all operand bytes a rank equal to 2 hops x E
   x C x D x 4 B forward and backward a step, 3 steps against the dense
   ``MoE`` through ``LocalOptimizer`` on rank 0 (``MESH_TOL``);
   [23d] the LM under ``megatron_transformer_plan()`` through
   ``HybridParallelOptimizer`` on ``make_mesh({"data": 2, "model": 2})``,
   bf16, SGD 0.1, 3 steps: each rank holds the replicated leaves and half
   of every Megatron-sharded one, 6 of each flash kernel a step a rank
   (its data rows), ``ShardedParamAudit`` passes, and with a NaN planted
   in rank 1's block rank 1's audit names the leaf, the block and the
   rank while every other rank stops naming rank 1; then 3 f32 steps
   against ``LocalOptimizer`` on rank 0 (``MESH_TOL``, tighter than the
   JAX test's loss 1e-4 and parameters 2e-4 absolute); [23e]
   ``examples/{pipeline,longctx,moe}_train.py`` at their JAX mains'
   defaults but one epoch of the two over half their default tokens
   (``MESH_EXAMPLE_TOKENS``; 8, 8 and 4 spawned ranks), each exit 0 with
   its bigram-map recovery. Rehearse on the CPU by importing
   ``chip_smoke`` from a guarded script, setting ``MESH_DEVICE = "cpu"``,
   cutting ``MESH_PIPE``, ``MESH_LM`` and ``MESH_MOE`` and calling
   ``phase_mesh_pipe("cpu")`` and ``phase_mesh_four("cpu")`` (the launch
   checks are the card's).
24. the training drive loop's observability and resilience, the full-width
   LM of [6] through ``LocalOptimizer`` (SGD 0.1 momentum 0.9, bf16): [24a]
   ``Telemetry`` (the JSONL under ``Engine.set_run_dir``, the ring),
   ``TrainSummary``, ``ValidationSummary`` with a validation,
   ``set_health``, ``set_perf``, ``set_checkpoint()`` under the run dir and
   a ``FailurePolicy``, all at once, with a ``FaultPlan`` raising once at
   ``dispatch`` and once at ``checkpoint``: the recovered run's final
   parameters equal a clean run's bit for bit; the step records' ``mfu``
   and ``achieved_flops_s``, the health norms of the embedding and of the
   last block, and #1-#3's launches with the replayed steps (6 a step and
   a validation forward) printed; [24b] a NaN planted in the loss at
   (epoch 1, batch 5): the records retry (divergence), rollback (the LR
   halved), retry (poison_batch), the position skipped; [24c] SIGTERM at
   the 5th batch with ``set_preemption``: ``TrainingPreempted`` (exit
   code 0), then ``resume()`` in a fresh process, bit-equal to an
   uninterrupted run; [24d] device-to-host copies and synchronisations a
   step under ``torch.profiler`` over 5 steps, bare loop and every extra
   attached, equal, with each one's step time; [24e] one ``set_profile``
   window: its trace holds the seams ``dispatch``, ``prefetch``,
   ``pad_mask``, ``checkpoint`` and the three flash kernels; [24f] a
   terminal failure (budget 0) leaves a postmortem bundle that
   ``verify_bundle`` accepts.
25. serving's remaining surface, the full-width LM of [5] (bf16, batch 8,
   random weights from a seed): [25a] a cold boot in a fresh process with
   an empty ``BIGDL_COMPILE_CACHE_DIR`` under ``build/``: ``register(...,
   drift=True, drift_every=1)`` on ``ModelServer(metrics_port=0)``, 16
   requests from 4 threads while a thread scrapes ``/healthz`` and
   ``/metrics`` over 127.0.0.1, then ``export_artifacts``: the warmup's
   ``fresh_compiles`` 1 (one nvcc build), the bundle's files and bytes,
   the serve records' drift and cost fields; [25b] a warm boot in a second
   fresh process with its own empty directory: ``warm_start(bundle)`` and
   ``register(..., artifacts=bundle)``: 0 builds, ``fresh_compiles`` 0, the
   warmup record naming the bundle, the 16 rows bit-equal to [25a]'s (row
   hashes), 6 #1 launches a forward; [25c] five rejected bundles (a
   tampered hash, a truncated library, a fingerprint naming another torch,
   a batch-size drift, an architecture drift at the same record shape):
   each registration boots cold, serves, and leaves one
   ``artifact_incompatible`` warn, the cache directory empty or holding
   the whole library; [25d] in-distribution records then a shifted stream
   with ``drift_every=2``: an ``activation_drift`` warn naming a layer, and
   under ``torch.profiler`` the device-to-host copies and synchronisations
   a flush with drift off and on: one more copy every 2 flushes; [25e]
   ``PredictionService`` from 4 threads: rows bit-equal to ``Predictor``'s;
   [25f] 2 LM steps through ``LocalOptimizer`` with a checkpoint, then
   ``export_step_artifact``; a fresh process with an empty cache directory
   ``warm_start`` s, ``resume`` s and trains to step 4 with 0 builds,
   bit-equal to an uninterrupted 4-step run; [25g] an exception escaping
   ``with ModelServer()`` leaves a postmortem bundle that ``verify_bundle``
   accepts, its reason naming the class. [25f]'s fresh process runs beside
   [25c]-[25g], which read counts, bits and records, not times.
26. the elastic fleet: [26a] the LM of [5]/[6] (bf16, batch 12 of 48
   seeded records, SGD 0.1, ``set_health``) through
   ``DistriOptimizer(parameter_sync="sharded")`` with ``set_elastic`` on 4
   ranks spawned beside [23e], sharing the card over gloo, on the JAX
   package's chaos schedule (a fake clock a second an ``end_when`` call;
   rank 0 holds a thread-free ``SimulatedFleet`` whose peers beat for the
   other ranks' hosts): host 3 silent after step 2 and back after step 5,
   3 epochs. One ``host_lost`` and one ``mesh_shrunk`` (members [3], the
   processes [0, 1, 2], generation 1, restored at its own step) and one
   ``mesh_rejoin`` (generation 2) record with the JAX package's fields;
   the generation-1 fleet checkpoint of 4 shards at the shrink's step
   bit-equal to a clean 4-rank run's checkpoint there, the generation-2 one
   of 3 shards; two layouts on the survivors (the ZeRO-1 step cache); every
   rank's health finite and rank 0's global gradient norm within
   ``ELASTIC_NORM_REL`` of the clean run's at every common step, a planted
   reading (the largest leaf's gradient doubled, from the records' own
   rows) over it; every rank whole and equal at the end; #1-#3 6 each a
   dispatched step on every rank; no rank left running. [26b] rides
   [23a]'s and [23d]'s spawns: their bf16 runs with ``Telemetry`` and
   ``set_health`` (every rank's records finite, each step record's
   ``collective_bytes`` with its all-to-all and ppermute parts equal to the
   step's delta of ``parallel._comm`` 's counters, [23a]'s
   ``pipe_bubble_frac`` equal to (S-1)/(n_micro+S-1)), their f32 checks'
   health norms against the one-rank run's (``MESH_HEALTH_TOL``, the
   planted run over it) and [23d]'s f32 steps with ``donate=False`` equal
   to the donated run's to the bit.
27. the configurations the port once refused: [27a] the Siamese
   ResNet-50 of [17a] with ``set_micro_batches(2)`` on its ``Table`` of
   pairs: one f32 step at 8 pairs (TF32 off, deterministic cuDNN) against
   a hand-written accumulation on the card (the two halves' train-mode
   passes, BN state carried, gradients summed and halved, the same SGD
   update) within ``SIAMESE_PAIR_TOL``, the planted accumulation (summed,
   not halved) over it; then at 64 pairs of 224x224 in bf16, micro 2 and
   unsplit in turns, 1 warm-up and 5 steps each: the median step and
   ``max_memory_allocated`` of each (micro 2's peak under the unsplit
   one's), 4 #10 launches a micro-batched step; [27b] rides [23d]'s spawn:
   3 f32 SGD steps of data 2 x model 2 with ``set_micro_batches(2)``, (i)
   under ``megatron_transformer_plan()`` and (ii) with the embedding's rows
   over ``"data"`` too, each against ``LocalOptimizer`` on one rank with
   the same micro-batches (``SLICE28_TOL``; planted: (i) block 0's query
   gradient doubled, (ii) the embedding's block of a rank's own rows
   without the sum over the data axis), 36 of each flash kernel a run a
   rank; [27c] ``lenet_train --summary-dir --model-save`` (one ``Loss``
   event an iteration read back, one ``Top1Accuracy`` event),
   ``lenet_test --model`` on its file, ``alexnet_train --model-save`` and
   its file's eval forward in a fresh process equal to this process's;
   [27d] ``DLClassifier`` over LeNet-5 fitted, predicting and scoring on
   held-out digits on the card. Rehearse [27a], [27c] and [27d] on the CPU
   by importing ``chip_smoke`` from a guarded script, setting
   ``SIAMESE_DEVICE`` and ``SLICE28_DEVICE`` to ``"cpu"``, cutting
   ``SIAMESE`` and the ``SLICE28_*`` sizes and calling their phases; [27b]
   by ``_spawn_mesh(["hybrid"], 4)`` under [23]'s CPU settings and
   ``_check_slice28_mesh``.
28. the concurrency auditor and lock tracer on the serving path, and the
   interop loaders: [28a] ``concurrency.audit_paths(["bigdl_tpu_torch"])``
   on this checkout (no finding), then the LM of [5] (bf16, batch 1) served
   through ``ModelServer`` under ``BIGDL_LOCK_DEBUG=1`` with the server's,
   its batcher's and its queue's locks instrumented against
   ``load_static_edges``: 16 single-record requests from 4 threads, an
   ``update`` to a second seeded version after the 8th answer; no
   inversion, both static nestings (``ContinuousBatcher._swap_lock ->
   _acct_lock``, ``ModelServer._mgmt_lock -> _lock``) observed, every
   answer bit-equal to a direct forward on the card of the version that
   served it, #1 6 a forward, each traced lock's longest hold logged;
   [28b] BVLC GoogLeNet written as its deploy prototxt (layers and widths
   of BVLC Caffe's ``models/bvlc_googlenet``) with a seeded binary
   ``.caffemodel`` (``WireWriter``), ``nn.load_caffe`` onto the card, an
   eval forward at batch 128 of 224² (f32, TF32 off) whose first 8 rows
   are held against the same files on the CPU (``GOOGLENET_TOL``), then 5
   ``LocalOptimizer`` steps at batch 128 (bf16, ``ClassNLLCriterion`` on
   ``prob``, SGD 0.01 momentum 0.9): finite losses, #10 13 a step, 9 of
   them at 3x3/s1 (the library's entry point spied); [28c] VGG-16 (1000
   classes, plain ReLU modules) through ``save_tf`` to a frozen GraphDef
   and ``nn.load_tf`` onto the card: the eval forward at batch 64 (f32,
   TF32 off) against the source model's (``TF_VGG_TOL``), 3
   ``TFSession(trainable=True).train`` steps at batch 64 (bf16) with
   finite losses, its weights through ``save_t7``/``load_t7`` equal to the
   bit, no launch; the write, parse and .t7 times logged. Rehearse on the
   CPU by importing ``chip_smoke`` from a guarded script, setting
   ``SLICE29_DEVICE = "cpu"``, cutting ``SLICE29_LM`` (V 64, H 32, 4 heads,
   filter 64, 2 layers, T 16), ``GOOGLENET`` (batch 2, 2 steps; the image
   stays 224) and ``SLICE29_VGG`` (32x32, batch 4), replacing
   ``_tf_source_model`` by a narrow convnet, and calling
   ``phase_slice29("cpu")`` (~10 s; the launch checks are the card's).

The max-pool backward kernel is held against its plain version in [3c]
(the flagship's stem pool, VGG-16's five pools, the parity configs' pools:
Inception-v1's ceil-mode 3x3/s2 pools with the overhang on the high side
only and its 3x3/s1/p1 branch pools, LeNet-5's 2x2/s2 pools on 24- and
8-wide planes, VGG-for-CIFAR-10's five 2x2/s2 pools on 32- to 2-wide
planes, AlexNet's three 3x3/s2 pools without padding on 55-, 27- and
13-wide planes at batch 64 in both dtypes, post-ReLU, with integer ties,
with NaN and -inf, and at an offset of one element, the Siamese tower's
stem pool at batch 64, the keras example's two 2x2/s2 pools on 24- and
8-wide planes at batch 64 in both dtypes; edge geometries, and its alignment traps: rows of 56 and 28
bytes, part-full plane groups, x and dy at a storage offset of one element,
the stem at an odd size; the 3x3/s1 instance's at the branch pools' widths:
7-wide rows, offsets, row bands, NaN and -inf inputs; repeats
bit-identical) and timed in [4] at the stem, VGG-16's five pools and the
parity configs' pools beside ATen's backward and the bound, with a line a
branch-pool shape on ATen and the 4x-bound target, and at AlexNet's three
pools and the keras example's two in f32 (their examples') and bf16
beside the launch floor; its four instances
(3x3/s2, 2x2/s2, 3x3/s1, general) launch in [2], where a spill in any of
them fails the run; the
bias+activation epilogue kernels likewise in [3d] and [4]; the LayerNorm
and RMSNorm kernels in [3e] and [4]. Each main path (serving,
LM training, flagship training, VGG-16 training (``vgg16`` in the kernels
record), VGG-16 evaluation, norm-LM training, the flagship
validated/checkpointed/resumed, the five parity configs' training,
each under its ``parity_config`` name, the flagship served,
``flagship_serving``, and [13]'s ``recipe_multistep``, ``recipe_poly``,
``recipe_shift``, ``optimizers``, ``lbfgs`` and ``regularizers``, and
[14]'s ``translation``, ``rope_lm``, ``rope_decode``,
``transformer_example``, ``transformer_example_decode``,
``translation_beam``, ``aspp`` and ``dropout_variants``, and [15]'s
``alexnet``, ``ncf_example``, ``ncf_ml1m``, ``ptb_example``,
``autoencoder_example`` and ``cnntext``, and [16]'s ``cells_gru``,
``cells_lstmpeephole``, ``cells_rnncell``, ``convlstm``,
``seq_autoencoder`` and ``modules``, and [17]'s ``siamese``,
``module_file`` and ``validate``, and [18]'s ``maskrcnn_coco``,
``maskrcnn_example``, ``detection_losses`` and ``maskrcnn_file``, and
[19]'s ``quant_float``, ``quant_int8``, ``quant_fp8``,
``quant_serving_int8``, ``quant_serving_fp8``, ``moe_bench_top1``,
``moe_bench_top2``, ``moe_example``, ``remat_unwrapped``,
``remat_unwrapped_again``, ``remat_none``, ``remat_dots_saveable`` and
``treelstm_example``, and [20]'s ``keras_example``, ``c3d``,
``unet_predict`` and ``modules_slice21``, and [21]'s ``imagenet_shards`` and
``augment_pipeline``, and [22]'s ``distri_recipe``, ``distri_resnet_2rank``,
``distri_vgg_2rank``, ``distri_policies`` and ``distri_resume``, the last
four counted in the ranks' processes and summed, and [24]'s ``obs_lm``,
and [25]'s ``surface_cold`` and ``surface_warm`` (counted in their
processes), ``surface_rejections``, ``surface_drift``,
``prediction_service``, ``step_export`` and ``step_resume`` (counted in its
process) and ``server_postmortem``, and [26]'s ``elastic_zero1``, counted in
the ranks' processes and summed, and [27]'s ``siamese_micro``,
``mesh_hybrid_micro`` and ``mesh_hybrid_data`` (counted in the ranks'
processes and summed), ``examples_flags`` and ``estimator``, and [28]'s
``lock_serving``, ``caffe_googlenet`` and ``tf_vgg16``) runs with every kernel's launch count set to 0 just
before it and read just after. The flat-memory checks read the device
memory less the batches ``LocalOptimizer`` 's prefetch thread has staged
(``staged_device_bytes``).

The last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Neither JAX nor the JAX
package is imported (both are blocked below).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.modules["jax"] = None  # the port must run without JAX: any import fails
sys.modules["bigdl_tpu"] = None

ROOT = Path(__file__).resolve().parent
SEED = 0

# Card peaks for bound_ms (NVIDIA data sheets, dense): (bf16 FLOP/s, fp32
# non-tensor-core FLOP/s, memory bytes/s). SXM is the default part.
PEAKS = {
    "sxm": (989e12, 67e12, 3.35e12),
    "pcie": (756e12, 51e12, 2.0e12),
}

# Tolerances of the kernel against its plain version (|err| <= atol + rtol*|ref|):
# bf16 out: the output is rounded to bf16 (2^-8 relative steps) and P is
#   rounded to bf16 before P·V (as in the TPU kernel), so one bf16 step of
#   the largest values is allowed;
# f32 out: fp32 sums over <= 2048 keys taken in another order;
# lse: fp32 in both, summation order and exp2/log2 rounding only.
TOL = {
    "bf16_out": (1e-2, 1e-2),
    "f32_out": (2e-5, 2e-5),
    "lse": (1e-3, 1e-5),
}

# Tolerances of the backward kernels against their plain version (dq, dk, dv):
# bf16: both round P and dS to bf16 before the second products (as the TPU
#   kernels do) but from fp32 values summed in another order, so a rare entry
#   rounds one bf16 step apart, and each gradient is rounded to bf16 once
#   (2^-8 relative steps): two bf16 steps of the largest values are allowed;
# f32: fp32 sums over <= 2048 keys or rows taken in another order, through
#   the cancellation dP - delta.
TOL_BWD = {
    "bf16": (2e-2, 2e-2),
    "f32": (1e-4, 1e-4),
}


NORM_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "rms_norm_fwd", "rms_norm_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str):
    return PEAKS["pcie" if "PCIe" in name else "sxm"]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, tensors, card: str, math_dtype=None):
    """Least time for one call: max(bytes / memory rate, FLOPs / peak rate for
    the arithmetic's type, by default the first operand's), each of
    ``tensors`` (the inputs and outputs) moved once."""
    import torch

    bf16_peak, f32_peak, mem = peaks(card)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    peak = bf16_peak if (math_dtype or tensors[0].dtype) == torch.bfloat16 else f32_peak
    t_ops, t_bytes = flops / peak, nbytes / mem
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound_ms(q, k, v, out, lse, vis_pairs: int, card: str):
    """Forward: QK^T and P·V (2 FLOP per MAC) over the (query, key) pairs
    these inputs make visible."""
    return bound_ms(4 * q.shape[-1] * vis_pairs, (q, k, v, out, lse), card)


def _counters():
    """Each kernel's name -> (module, attribute) of its wrapper's launch count."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops import fused_epilogue as fe
    from bigdl_tpu_torch.ops import fused_norm as fn
    from bigdl_tpu_torch.ops import maxpool as mp
    from bigdl_tpu_torch.ops import probe

    return {"probe_add_one": (probe, "launches"), "flash_attention_fwd": (fa, "launches"),
            "flash_attention_bwd_dq": (fa, "launches_dq"),
            "flash_attention_bwd_dkv": (fa, "launches_dkv"), "maxpool2d_bwd": (mp, "launches"),
            "bias_act_fwd": (fe, "launches_fwd"),
            "bias_act_bwd_feature": (fe, "launches_bwd_feature"),
            "bias_act_bwd_row": (fe, "launches_bwd_row"),
            **{k: (fn, f"launches_{k}") for k in NORM_KERNELS}}


def reset_counts() -> None:
    """Every count to 0, just before a main path. Cyclic garbage of earlier
    phases is collected first: a collection inside the path would free
    tensors that are not the path's, and its memory checks would read that
    as the path's memory moving (seen as -200 MiB inside [11] and [13a])."""
    import gc

    before = _mem()
    found = gc.collect()
    if before - _mem() > 16 * 2 ** 20:
        log(f"    (a garbage collection before this path found {found} objects and freed "
            f"{(before - _mem()) / 2**20:.1f} MiB of device memory)")
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


# ------------------------------------------------------------------ phases
def phase_card():
    import torch

    card = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability sm_{cap[0]}{cap[1]}, kernels built for sm_90a")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    return card


def phase_build():
    import torch
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_bwd, flash_attention_fwd

    from bigdl_tpu_torch import native

    host_errors = []

    def build_host():  # g++ beside the nvcc processes
        try:
            native.build(force=True)
        except BaseException as e:  # raised below, on the main thread
            host_errors.append(e)

    host = threading.Thread(target=build_host)
    t0 = time.perf_counter()
    host.start()
    path = _build.build(force=True)
    lib = _build.load()  # loads and probes: raises if the probe kernel fails or is wrong
    log(f"[2] built {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    host.join()
    if host_errors:
        raise host_errors[0]
    native._load()  # raises if it does not load or has another ABI
    log(f"    built the host library {Path(native.BUILD_DIR, native.LIB_NAME).relative_to(ROOT)} "
        f"from {native.SOURCE.relative_to(ROOT)} with g++ in {native.build_s:.2f} s (beside nvcc)")
    from bigdl_tpu_torch.ops import probe

    log(f"    probe (y = x + 1 on an {probe.SHAPE} f32 block, at the library's first load): "
        f"kernels_available('cuda') = {probe.kernels_available('cuda')}, reason "
        f"{probe.unavailable_reason()!r}, {probe.launches} launch")
    serialized, pool_spills, entry = [], [], ""
    for line in _build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "warning" in line):
            log("    ptxas: " + line.strip())
        if "C7514" in line:
            serialized.append(line.strip())
        if "Compiling entry" in line:
            entry = line
        elif ("spill stores" in line and "maxpool2d_bwd" in entry
              and "0 bytes spill stores, 0 bytes spill loads" not in line):
            pool_spills.append(line.strip())
    if serialized:  # a branch or register read between a wgmma and its wait (~2x slower)
        raise AssertionError(f"ptxas serialized wgmma (C7514): {serialized}")
    if pool_spills:
        raise AssertionError(f"ptxas spilled registers of a max-pool instance: {pool_spills}")
    from bigdl_tpu_torch.ops.fused_epilogue import fused_bias_act_bwd, fused_bias_act_fwd
    from bigdl_tpu_torch.ops.fused_norm import (layer_norm_bwd, layer_norm_fwd, rms_norm_bwd,
                                                rms_norm_fwd)
    from bigdl_tpu_torch.ops.maxpool import maxpool_grad

    g = torch.Generator(device="cuda").manual_seed(SEED)
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 1, 64, 64), generator=g, device="cuda").to(dt)
        out, lse = flash_attention_fwd(q, q, q, causal=True)
        flash_attention_bwd(q, q, q, out, lse, q, causal=True)
        # the dQ and dK/dV entry points alone, as [4] times them
        head, tail, keep = fa._bwd_kernel_args(q, q, q, out, lse, q, True, None, None, True)
        grads = [torch.empty_like(q) for _ in range(3)]
        for rc in (lib.bigdl_flash_attention_bwd_dq(*head, grads[0].data_ptr(), *tail),
                   lib.bigdl_flash_attention_bwd_dkv(*head, grads[1].data_ptr(),
                                                     grads[2].data_ptr(), *tail)):
            if rc != 0:
                raise RuntimeError(f"backward entry point failed with CUDA error {rc}")
        torch.cuda.synchronize()
        del keep, grads
        # the max-pool kernel's four instances: 3x3/s2, 2x2/s2, 3x3/s1 and the general one
        maxpool_grad(q, q[:, :, :32, :32].contiguous(), (3, 3), (2, 2), ((1, 1), (1, 1)))
        maxpool_grad(q, q[:, :, :32, :32].contiguous(), (2, 2), (2, 2), ((0, 0), (0, 0)))
        maxpool_grad(q, q, (3, 3), (1, 1), ((1, 1), (1, 1)))
        maxpool_grad(q, q[:, :, :31, :63].contiguous(), (3, 2), (2, 1), ((0, 0), (0, 0)))
        b = q[0, 0, 0].float()
        for axis, bias in ((-1, b), (1, b[:1])):
            fused_bias_act_fwd(q, bias, "gelu", axis)
            fused_bias_act_bwd(q, bias, q, "gelu", axis)
        layer_norm_fwd(q, b, b)
        layer_norm_bwd(q, b, q.float())
        rms_norm_fwd(q, b)
        rms_norm_bwd(q, b, q)
    torch.cuda.synchronize()
    log("    flash_attention_fwd, flash_attention_bwd (dQ, dK/dV, and each alone), maxpool_grad "
        "(3x3/s2, 2x2/s2, 3x3/s1 and the general instance), "
        "fused_bias_act (forward, feature and row backward) and the LayerNorm and RMSNorm "
        "forward and backward launched once in bf16 and f32")


def _rand(shape, dtype, g):
    import torch

    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _split_heads(shape, dtype, g):
    """An (N, H, T, d) view of an (N, T, H*d) tensor, as ``split_heads`` makes."""
    n, h, t, d = shape
    return _rand((n, t, h * d), dtype, g).view(n, t, h, d).permute(0, 2, 1, 3)


def _visible_pairs(n, h, tq, tk, causal, lengths, mask_q):
    from bigdl_tpu_torch.ops.flash_attention import visible_mask

    return int(visible_mask(n, tq, tk, causal, lengths, mask_q, "cuda").sum()) * (
        h if lengths is not None else n * h)


# The translation mode's two masks at the full-width shape (8, 8, 2048, 2048,
# 64) bf16 on split_heads views, each sequence's source length drawn from a
# seed in [1024, 2048] as [14a] draws them: the encoder's self-attention
# (non-causal, key lengths, padded query rows zeroed) and the decoder's
# cross-attention (non-causal, key lengths, every query row kept).
TRANSLATION_MASKS = ("translation encoder: lengths + mask_q", "translation cross: lengths")


def _src_lengths(n: int, lo: int, hi: int, seed: int):
    """n source lengths drawn uniformly from [lo, hi]."""
    import numpy as np

    return [int(v) for v in np.random.default_rng(seed).integers(lo, hi + 1, n)]


def _translation_cases():
    import torch

    bf = torch.bfloat16
    lens = _src_lengths(8, 1024, 2048, SEED + 14)
    return [(TRANSLATION_MASKS[0], 8, 8, 2048, 2048, 64, bf, False, lens, True, True),
            (TRANSLATION_MASKS[1], 8, 8, 2048, 2048, 64, bf, False, lens, False, True)]


def phase_parity():
    """Kernel vs plain version on the card; returns the serving-shape record
    (with the translation cases' errors under ``mask_errs``)."""
    import torch
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_reference)

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 reference stays fp32
    torch.backends.cudnn.allow_tf32 = False
    bf, f32 = torch.bfloat16, torch.float32
    # (label, N, H, Tq, Tk, d, dtype, causal, lengths, mask_q, views): with
    # views, q, k and v are split_heads views of (N, T, H*d) tensors, the
    # layout the LM hands the kernel (T stride H*d, not d)
    cases = [
        ("serving shape", 8, 8, 2048, 2048, 64, bf, True, None, None, False),
        ("serving shape f32", 8, 8, 2048, 2048, 64, f32, True, None, None, False),
        ("ragged lengths + mask_q", 4, 2, 1000, 1000, 64, bf, True, [1000, 517, 1, 0], True,
         False),
        ("ragged lengths, no causal", 4, 2, 777, 777, 128, f32, False, [700, 33, 0, 777], True,
         False),
        ("rectangular Tq<Tk causal", 2, 4, 300, 1100, 64, bf, True, None, None, False),
        ("rectangular Tq<Tk, key lengths", 2, 4, 300, 1100, 64, f32, False, [1100, 90], False,
         False),
        ("Tq>Tk causal (rows with no key)", 2, 2, 200, 130, 64, bf, True, None, None, False),
        ("odd T=1000 causal", 2, 4, 1000, 1000, 64, bf, True, None, None, False),
        ("odd T=2047 causal", 1, 8, 2047, 2047, 64, bf, True, None, None, False),
        ("odd T=2047 non-causal", 1, 4, 2047, 2047, 64, bf, False, None, None, False),
        ("d=128 causal", 2, 4, 1024, 1024, 128, bf, True, None, None, False),
        ("d=128 f32 causal", 2, 4, 1024, 1024, 128, f32, True, [1024, 300], True, False),
        ("views: serving shape", 8, 8, 2048, 2048, 64, bf, True, None, None, True),
        ("views: T=1000 causal", 2, 8, 1000, 1000, 64, bf, True, None, None, True),
        ("views: T=2047 causal", 1, 8, 2047, 2047, 64, bf, True, None, None, True),
        ("views: d=128 T=1000 causal", 2, 4, 1000, 1000, 128, bf, True, None, None, True),
        ("views: lengths + mask_q", 4, 2, 1000, 1000, 64, bf, True, [1000, 517, 1, 0], True,
         True),
        *_translation_cases(),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    log("[3] kernel vs plain version on the card "
        f"(|err| <= atol + rtol*|ref|; {TOL})")
    record, mask_errs = None, {}
    for label, n, h, tq, tk, d, dt, causal, lens, mask_q, views in cases:
        make = _split_heads if views else _rand
        q, k, v = make((n, h, tq, d), dt, g), make((n, h, tk, d), dt, g), make((n, h, tk, d), dt, g)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        out, lse = flash_attention_fwd(q, k, v, causal, lengths=lengths, mask_q=mask_q)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, causal, lengths=lengths,
                                                         mask_q=mask_q)
        atol, rtol = TOL["bf16_out" if dt == bf else "f32_out"]
        err_out = (out.float() - ref_out.float()).abs()
        ok_out = bool((err_out <= atol + rtol * ref_out.float().abs()).all())
        la, lr = TOL["lse"]
        err_lse = (lse - ref_lse).abs()
        ok_lse = bool((err_lse <= la + lr * ref_lse.abs()).all())
        finite = bool(torch.isfinite(out).all())
        log(f"    {label:34s} {str(dt)[6:]:8s} out max err {err_out.max().item():.3e}  "
            f"lse max err {err_lse.max().item():.3e}  "
            f"{'ok' if ok_out and ok_lse and finite else 'FAIL'}")
        if not (ok_out and ok_lse and finite):
            raise AssertionError(f"flash_attention_fwd disagrees with its plain version: {label}")
        if label in TRANSLATION_MASKS:
            mask_errs[label] = err_out.max().item()
        if record is None:
            again = flash_attention_fwd(q, k, v, causal, lengths=lengths, mask_q=mask_q)
            same = torch.equal(again[0], out) and torch.equal(again[1], lse)
            log(f"    repeated serving-shape forward bit-identical: {same}")
            if not same:
                raise AssertionError("two runs of the forward kernel gave different bits")
            record = dict(q=q, k=k, v=v, out=out, lse=lse,
                          max_abs_err=err_out.max().item(),
                          pairs=_visible_pairs(n, h, tq, tk, causal, lengths, mask_q))
            del again
        del q, k, v, out, lse, ref_out, ref_lse, err_out, err_lse
    torch.cuda.empty_cache()
    record["mask_errs"] = mask_errs
    return record


def phase_bwd_parity():
    """Backward kernels vs their plain version on the card; returns the
    training-shape record (with the translation cases' tensors under
    ``masks``)."""
    import torch
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd)

    bf, f32 = torch.bfloat16, torch.float32
    # (label, N, H, Tq, Tk, d, dtype, causal, lengths, mask_q, views): with
    # views, q, k, v and d_out are split_heads views of (N, T, H*d) tensors
    cases = [
        ("training shape", 8, 8, 2048, 2048, 64, bf, True, None, None, False),
        ("training shape f32", 8, 8, 2048, 2048, 64, f32, True, None, None, False),
        ("ragged lengths + mask_q", 4, 2, 1000, 1000, 64, bf, True, [1000, 517, 1, 0], True,
         False),
        ("ragged lengths, no causal", 4, 2, 777, 777, 128, f32, False, [700, 33, 0, 777], True,
         False),
        ("rectangular Tq<Tk causal", 2, 4, 300, 1100, 64, bf, True, None, None, False),
        ("rectangular Tq<Tk, key lengths", 2, 4, 300, 1100, 64, f32, False, [1100, 90], False,
         False),
        ("Tq>Tk causal (rows with no key)", 2, 2, 200, 130, 64, bf, True, None, None, False),
        ("Tq>Tk causal f32", 2, 2, 200, 130, 128, f32, True, None, None, False),
        ("odd T=1000 causal", 2, 4, 1000, 1000, 64, bf, True, None, None, False),
        ("odd T=2047 causal", 1, 8, 2047, 2047, 64, bf, True, None, None, False),
        ("odd T=2047 non-causal", 1, 4, 2047, 2047, 64, bf, False, None, None, False),
        ("d=128 causal", 2, 4, 1024, 1024, 128, bf, True, None, None, False),
        ("d=128 ragged + mask_q", 2, 4, 1024, 1024, 128, bf, True, [1024, 300], True, False),
        ("d=128 f32 causal", 2, 4, 1024, 1024, 128, f32, True, [1024, 300], True, False),
        # the layout the LM hands the kernels (T stride H*d) and ragged 128-row items
        ("views: training shape", 8, 8, 2048, 2048, 64, bf, True, None, None, True),
        ("views: d=128 T=1000 causal", 2, 4, 1000, 1000, 128, bf, True, None, None, True),
        ("d=128 T=2048 causal", 2, 8, 2048, 2048, 128, bf, True, None, None, False),
        ("d=128 T=2047 non-causal", 1, 4, 2047, 2047, 128, bf, False, None, None, False),
        ("odd T=129 causal", 4, 4, 129, 129, 64, bf, True, None, None, False),
        ("odd T=129 d=128 causal", 4, 4, 129, 129, 128, bf, True, None, None, False),
        # key tiles past the horizon see no row (zero dK/dV), rows past it no key
        ("Tq<Tk causal, lengths + mask_q", 2, 4, 300, 1100, 64, bf, True, [1100, 1000], True,
         False),
        ("Tq<Tk, lengths + mask_q, d=128", 2, 4, 300, 1100, 128, bf, False, [1100, 1000], True,
         False),
        *_translation_cases(),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    log("[3b] backward kernels (dQ, dK/dV) vs plain version on the card "
        f"(|err| <= atol + rtol*|ref|; {TOL_BWD})")
    record, masks = None, {}
    for label, n, h, tq, tk, d, dt, causal, lens, mask_q, views in cases:
        make = _split_heads if views else _rand
        q, k, v = make((n, h, tq, d), dt, g), make((n, h, tk, d), dt, g), make((n, h, tk, d), dt, g)
        d_out = make((n, h, tq, d), dt, g)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
        out, lse = flash_attention_fwd(q, k, v, causal, lengths=lengths, mask_q=mask_q)
        grads = flash_attention_bwd(q, k, v, out, lse, d_out, causal, lengths=lengths,
                                    mask_q=mask_q)
        torch.cuda.synchronize()
        refs = flash_attention_bwd_reference(q, k, v, out, lse, d_out, causal,
                                             lengths=lengths, mask_q=mask_q)
        atol, rtol = TOL_BWD["bf16" if dt == bf else "f32"]
        errs, ok = [], True
        for got, ref in zip(grads, refs):
            err = (got.float() - ref.float()).abs()
            ok &= bool((err <= atol + rtol * ref.float().abs()).all())
            ok &= bool(torch.isfinite(got).all())
            errs.append(err.max().item())
        log(f"    {label:34s} {str(dt)[6:]:8s} max err dq {errs[0]:.3e}  dk {errs[1]:.3e}  "
            f"dv {errs[2]:.3e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {label}")
        if label in TRANSLATION_MASKS:  # kept for [4]'s times at the translation's masks
            masks[label] = dict(q=q, k=k, v=v, out=out, lse=lse, d_out=d_out, lengths=lengths,
                                mask_q=mask_q, err_dq=errs[0], err_dkv=max(errs[1:]),
                                pairs=_visible_pairs(n, h, tq, tk, causal, lengths, mask_q))
        if record is None:
            again = flash_attention_bwd(q, k, v, out, lse, d_out, causal)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            log(f"    repeated training-shape backward bit-identical: {same}")
            if not same:
                raise AssertionError("two runs of the backward kernels gave different bits")
            record = dict(q=q, k=k, v=v, out=out, lse=lse, d_out=d_out,
                          err_dq=errs[0], err_dkv=max(errs[1:]),
                          pairs=_visible_pairs(n, h, tq, tk, causal, lengths, mask_q))
            del again
        del q, k, v, d_out, out, lse, grads, refs
    torch.cuda.empty_cache()
    record["masks"] = masks
    return record


def phase_probe_times(card):
    """The probe kernel against its plain version at its one shape, and its time
    through its C entry point into a buffer made once (no Python wrapper, no
    allocation), beside the same entry point launching one element (an all
    but empty kernel: the launch floor, since the bound is 8 KiB of traffic)
    and launching nothing (n = 0: the ctypes call alone)."""
    import torch
    from bigdl_tpu_torch.ops import _build, probe

    x = torch.randn(probe.SHAPE, generator=torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda")
    y = probe.add_one(x)
    torch.cuda.synchronize()
    err = (y - probe.probe_reference(x)).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"probe kernel disagrees with x + 1 by {err}")
    lib = _build.load()

    def launch():
        rc = probe._launch(lib, x, y)
        if rc != 0:
            raise RuntimeError(f"probe kernel launch failed with CUDA error {rc}")

    stream = torch.cuda.current_stream().cuda_stream

    def launch_n(n):  # the same C entry point: n = 1 is an all but empty kernel, 0 none
        rc = lib.bigdl_probe_add_one(x.data_ptr(), y.data_ptr(), n, stream)
        if rc != 0:
            raise RuntimeError(f"probe kernel launch failed with CUDA error {rc}")

    ms = cuda_ms(launch, iters=200, warmup=10)
    empty_ms = cuda_ms(lambda: launch_n(1), iters=200, warmup=10)
    call_ms = cuda_ms(lambda: launch_n(0), iters=200, warmup=10)
    wrapper_ms = cuda_ms(lambda: probe.add_one(x), iters=200, warmup=10)
    plain_ms = cuda_ms(lambda: probe.probe_reference(x), iters=200, warmup=10)
    b_ms, by = bound_ms(x.numel(), (x, y), card)  # one add an element; read x, write y
    log(f"[4] kernels: probe_add_one {tuple(x.shape)} f32: max err {err} (exact), kernel_ms "
        f"{ms:.4f} (C entry point), empty_kernel_ms {empty_ms:.4f} (the same entry point on "
        f"one element, one block: the launch floor), ctypes_call_ms {call_ms:.4f} (the same "
        f"entry point with n = 0: no launch), wrapper_ms {wrapper_ms:.4f} (probe.add_one), "
        f"plain_ms {plain_ms:.4f}, bound_ms {b_ms:.7f} ({by}); card {card}")
    return {"name": "probe_add_one", "route": "cuda", "source": "bigdl_tpu_torch/csrc/probe.cu",
            "replaces": "bigdl_tpu/ops/pallas_probe.py:40", "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "wrapper_ms": wrapper_ms, "empty_kernel_ms": empty_ms,
            "ctypes_call_ms": call_ms}


def phase_times(rec, card):
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_reference)

    q, k, v = rec["q"], rec["k"], rec["v"]
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, True))
    plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(q, k, v, True), iters=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_ms, bound_by = attention_bound_ms(q, k, v, rec["out"], rec["lse"], rec["pairs"], card)
    kernel = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/flash_attention.py:50",
        "launches": None,  # filled from the main path's run
        "max_abs_err": rec["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    log(f"[4] kernels: flash_attention_fwd (8,8,2048,64) bf16 causal: verdict ok, "
        f"kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, bound_ms {bound_ms:.4f} "
        f"({bound_by}), library_ms {library_ms:.4f} "
        f"(torch scaled_dot_product_attention, yardstick only); card {card}")
    return kernel


def phase_bwd_times(rec, card):
    """Times of the dQ and dK/dV kernels at the training shape (each launched
    through its C entry point alone, so the wrapper's counts stay those of
    the main paths), the plain backward, and the library's backward."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa

    q, k, v, out, lse, d_out = (rec[n] for n in ("q", "k", "v", "out", "lse", "d_out"))
    lib = _build.load()
    head, tail, keep = fa._bwd_kernel_args(q, k, v, out, lse, d_out, True, None, None, True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def run(rc):
        if rc != 0:
            raise RuntimeError(f"backward kernel launch failed with CUDA error {rc}")

    ms_dq = cuda_ms(lambda: run(lib.bigdl_flash_attention_bwd_dq(*head, dq.data_ptr(), *tail)))
    ms_dkv = cuda_ms(lambda: run(lib.bigdl_flash_attention_bwd_dkv(
        *head, dk.data_ptr(), dv.data_ptr(), *tail)))
    ms_wrapper = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, d_out, True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, d_out, True),
                       iters=3)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, d_out, retain_graph=True))
    default = type(lib_out.grad_fn).__name__
    # SDPA's backward under each backend that takes the shape, by name (the
    # backend is fixed when the forward records its node)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    by_backend = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                out_b = F.scaled_dot_product_attention(*leaves, is_causal=True)
            by_backend[name] = cuda_ms(
                lambda: torch.autograd.grad(out_b, leaves, d_out, retain_graph=True))
            del out_b
        except (RuntimeError, AttributeError) as e:  # the backend refuses the shape or is absent
            by_backend[name] = None
            log(f"    SDPA backend {name}: not available here ({str(e).splitlines()[0][:120]})")
    log(f"    SDPA backward (dq+dk+dv) by backend: "
        + ", ".join(f"{k} {v:.4f} ms" if v is not None else f"{k} n/a"
                    for k, v in by_backend.items())
        + f"; by default SDPA records {default} ({library_ms:.4f} ms); card {card}")
    del keep, lib_out, leaves
    # host time of one flash_attention_bwd call (delta, outputs, the four tensor
    # maps, both launches), at a shape small enough that the card never holds
    # the host back: the least of 5 blocks of 100 calls enqueued back to back
    # (the host's clock is shared with other work; the least is the call's own)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    small = [_rand((1, 1, 128, 64), torch.bfloat16, gen) for _ in range(4)]
    s_out, s_lse = fa.flash_attention_fwd(*small[:3], True)
    blocks = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fa.flash_attention_bwd(*small[:3], s_out, s_lse, small[3], True)
        blocks.append((time.perf_counter() - t0) / 100 * 1e6)
    host_us = min(blocks[1:])  # the first block warms up
    torch.cuda.synchronize()
    del small, s_out, s_lse

    d, pairs = q.shape[-1], rec["pairs"]
    io = (q, k, v, d_out, lse, lse)  # lse and delta: (N, H, T) f32 each
    b_dq = bound_ms(6 * d * pairs, io + (dq,), card)  # S, dP, dS·K
    b_dkv = bound_ms(8 * d * pairs, io + (dk, dv), card)  # S^T, dP^T, P^T·dO, dS^T·Q
    b_least = bound_ms(10 * d * pairs, io + (dq, dk, dv), card)  # five products
    kernels = []
    for name, ms, (b, by), err, line in (
            ("flash_attention_bwd_dq", ms_dq, b_dq, rec["err_dq"], 263),
            ("flash_attention_bwd_dkv", ms_dkv, b_dkv, rec["err_dkv"], 315)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"bigdl_tpu/ops/flash_attention.py:{line}",
            "launches": None,  # filled from the main path's run
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,  # the plain backward computes dq, dk and dv together
            "bound_ms": b,
            "bound_by": by,
            "library_ms": library_ms,  # backward of scaled_dot_product_attention: the pair
            "library_ms_by_backend": by_backend, "library_default": default,
            "host_us_per_backward_call": host_us,
        })
        log(f"[4] kernels: {name} (8,8,2048,64) bf16 causal: verdict ok, kernel_ms {ms:.4f}, "
            f"plain_ms {plain_ms:.4f} (dq+dk+dv), bound_ms {b:.4f} ({by}), library_ms "
            f"{library_ms:.4f} (torch scaled_dot_product_attention backward, dq+dk+dv, "
            f"yardstick only); card {card}")
    log(f"    backward pair: kernels {ms_dq + ms_dkv:.4f} ms, wrapper with delta "
        f"{ms_wrapper:.4f} ms, least work (five products) bound {b_least[0]:.4f} ms "
        f"({b_least[1]}); host {host_us:.1f} us a flash_attention_bwd call; card {card}")
    return kernels


def phase_mask_times(fwd_rec, bwd_rec, kernels, card):
    """#1-#3 at the translation's two masks ([3b]'s tensors): each kernel's
    ms beside its bound from the visible pairs, and SDPA's forward and
    backward given the same key mask as a boolean ``attn_mask`` (N, 1, 1,
    Tk) (a yardstick: it does not zero the padded query rows, which only
    lowers its work). Adds ``translation_masks`` to each of the three
    kernels' records."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa

    lib = _build.load()
    fwd, dq_k, dkv_k = kernels

    def run(rc):
        if rc != 0:
            raise RuntimeError(f"backward kernel launch failed with CUDA error {rc}")

    for label, r in bwd_rec["masks"].items():
        q, k, v, out, lse, d_out = (r[n] for n in ("q", "k", "v", "out", "lse", "d_out"))
        lengths, mask_q, pairs, d = r["lengths"], r["mask_q"], r["pairs"], q.shape[-1]
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, False, lengths=lengths,
                                                     mask_q=mask_q))
        head, tail, keep = fa._bwd_kernel_args(q, k, v, out, lse, d_out, False, None, lengths,
                                               mask_q)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        ms_dq = cuda_ms(lambda: run(lib.bigdl_flash_attention_bwd_dq(*head, dq.data_ptr(),
                                                                       *tail)))
        ms_dkv = cuda_ms(lambda: run(lib.bigdl_flash_attention_bwd_dkv(
            *head, dk.data_ptr(), dv.data_ptr(), *tail)))
        key_mask = (torch.arange(k.shape[-2], device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=key_mask)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, d_out,
                                                      retain_graph=True))
        lib_name = type(lib_out.grad_fn).__name__
        io = (q, k, v, d_out, lse, lse)
        bounds = (attention_bound_ms(q, k, v, out, lse, pairs, card),
                  bound_ms(6 * d * pairs, io + (dq,), card),
                  bound_ms(8 * d * pairs, io + (dk, dv), card))
        errs = (fwd_rec["mask_errs"][label], r["err_dq"], r["err_dkv"])
        for kern, t, (b, by), err, lib_ms in zip((fwd, dq_k, dkv_k), (ms, ms_dq, ms_dkv),
                                                   bounds, errs, (lib_fwd, lib_bwd, lib_bwd)):
            kern.setdefault("translation_masks", {})[label] = {
                "ms": t, "bound_ms": b, "bound_by": by, "max_abs_err": err,
                "library_ms": lib_ms, "visible_pairs": pairs}
            log(f"[4] kernels: {kern['name']} (8,8,2048,64) bf16 {label} (lengths "
                f"{lengths.tolist()}): kernel_ms {t:.4f}, bound_ms {b:.4f} ({by}; "
                f"kernel/bound {t / b:.2f}), library_ms {lib_ms:.4f} (SDPA "
                f"{'forward' if kern is fwd else 'backward, dq+dk+dv'} with the key mask as "
                f"attn_mask, {lib_name}; yardstick only); card {card}")
        del keep, leaves, lib_out
    torch.cuda.empty_cache()


def phase_slice(card):
    """Serve the full-width LM through ModelServer; returns every kernel's
    launches of that run."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import ModelServer
    from bigdl_tpu_torch.utils.convert import load_jax_params

    vocab, hidden, heads, filt, layers, T = 8192, 512, 8, 2048, 6, 2048
    n_req, n_threads = 16, 4
    Engine.set_compute_dtype("bfloat16")
    RandomGenerator.set_seed(SEED)
    records = np.random.RandomState(SEED).randint(1, vocab, size=(n_req, T)).astype(np.int64)
    model = Transformer(vocab, hidden, heads, filt, layers, 0.0, 0.0, 0.0,
                        mode="lm", device="cuda").eval()

    reset_counts()  # the main path starts here
    results, lat = [None] * n_req, [None] * n_req
    with ModelServer() as server:
        t0 = time.perf_counter()
        server.register("lm", model, sample_input=records[0], batch_size=8, max_delay_ms=5)
        log(f"[5] registered + warmed the LM in {time.perf_counter() - t0:.2f} s "
            f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")

        def client(idx):
            futs = [(i, server.infer("lm", records[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(timeout=300)
                lat[i] = f.t_materialize - f.t_enqueue

        threads = [threading.Thread(target=client, args=(range(c, n_req, n_threads),))
                   for c in range(n_threads)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            raise RuntimeError("not every request was served")
        flushes = server.models()["lm"]["flushes"]
    counts = read_counts()  # the main path ends here
    launches = counts["flash_attention_fwd"]
    if any(n for k, n in counts.items() if k != "flash_attention_fwd"):
        raise AssertionError(f"serving launched another kernel than the flash forward: {counts}")
    expect = layers * (1 + flushes)  # one warmup forward + one forward per flush
    log(f"    served {n_req} requests in {wall:.3f} s over {flushes} flushes: "
        f"{n_req / wall:.2f} requests/s, p50 {np.percentile(lat, 50) * 1e3:.1f} ms, "
        f"p99 {np.percentile(lat, 99) * 1e3:.1f} ms; card {card}")
    log(f"    flash_attention_fwd launches: {launches} (expected {layers} per forward "
        f"x (1 warmup + {flushes} flushes) = {expect})")
    if launches != expect:
        raise AssertionError(f"flash kernel launched {launches} times, expected {expect}")

    # Each answer against a direct forward of that record on the card. Rows
    # served in a batch of 8 and forwards of one record run the same bf16
    # arithmetic through GEMMs of other shapes, so the sums' order differs:
    # logits (std ~1) may differ by a few bf16 steps (2^-7 at 1..2).
    atol = 0.1
    worst, flips = 0.0, 0
    with torch.inference_mode():
        for i in range(n_req):
            ref = model.forward(records[i][None])[0].float().cpu()
            got = results[i]
            if got.shape != (T, vocab) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"request {i}: shape {tuple(got.shape)} or non-finite")
            worst = max(worst, (got - ref).abs().max().item())
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * atol  # argmax decided beyond tolerance
            flips += int((got.argmax(-1) != ref.argmax(-1))[clear].sum())
    log(f"    served vs direct forward (card, bf16): max |logit diff| {worst:.4f} "
        f"(tol {atol}), argmax flips where the margin > {2 * atol}: {flips}")
    if worst > atol or flips:
        raise AssertionError("served logits disagree with the direct forward")

    # One record against an fp32 forward on the CPU through the dense plain
    # attention path: bf16 operands in every matmul of 6 layers plus the
    # LM head give logits a few hundredths off (std ~1); 0.25 is ~30 bf16
    # steps at 1.0.
    cpu_tol = 0.25
    Engine.set_compute_dtype("float32")
    try:
        cpu_model = Transformer(vocab, hidden, heads, filt, layers, 0.0, 0.0, 0.0,
                                mode="lm", device="cpu").eval()
        cpu_model.init(sample_input=records[:1])
        load_jax_params(cpu_model, {k: v.detach().cpu().numpy()
                                    for k, v in model.named_parameters()})
        with torch.inference_mode():
            ref = cpu_model.forward(records[:1])[0]
    finally:
        Engine.set_compute_dtype("bfloat16")
    err = (results[0] - ref).abs()
    agree = (results[0].argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"    served vs fp32 CPU forward (record 0): max |logit diff| {err.max().item():.4f}, "
        f"mean {err.mean().item():.5f} (tol {cpu_tol}), argmax agreement {agree:.4f}")
    if err.max().item() > cpu_tol:
        raise AssertionError("served logits disagree with the fp32 CPU forward")
    return counts


# Flash route vs dense route over 3 SGD steps from the same weights (bf16
# operands in both, fixed before the first run): the two routes round
# attention's products at other places (the dense route keeps bf16 scores
# and weights; the kernels keep fp32 P and round it once), which moves the
# loss (~9.0) by ~1e-3; the weights after 3 steps differ from each other by
# far less than the steps themselves moved them.
TRAIN_TOL = {
    "loss": 2e-2,    # |loss_flash - loss_dense| per step
    "params": 1e-3,  # ||p_flash - p_dense|| / ||p_dense||
    "update": 1e-1,  # ||(p_flash - p0) - (p_dense - p0)|| / ||p_dense - p0||
}


def phase_training(card):
    """Train the full-width LM through LocalOptimizer; returns every kernel's
    launches of that run."""
    import os
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params

    vocab, hidden, heads, filt, layers, T = 8192, 512, 8, 2048, 6, 2048
    batch, n_records, iters = 8, 40, 10
    Engine.set_compute_dtype("bfloat16")
    RandomGenerator.set_seed(SEED)
    gen = np.random.default_rng(SEED)
    ids = gen.integers(0, vocab, (n_records, T))
    targets = gen.integers(0, vocab, (n_records, T))

    def lm():
        return Transformer(vocab, hidden, heads, filt, layers, 0.0, 0.0, 0.0,
                           mode="lm", device="cuda")

    def trainer(model, n, steps):
        opt = LocalOptimizer(model, DataSet.array(ids[:n], targets[:n], batch_size=batch),
                             CrossEntropyCriterion())
        return opt.set_optim_method(SGD(learningrate=0.1)).set_end_when(
            Trigger.max_iteration(steps))

    model = lm()
    opt = trainer(model, n_records, iters)
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    all_counts = read_counts()  # the main path ends here
    counts = tuple(all_counts[k] for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                           "flash_attention_bwd_dkv"))
    hist = opt.history
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3  # iterations 3-10
    log(f"[6] trained the LM ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"params) through LocalOptimizer: {len(hist)} iterations over epochs "
        f"{sorted({h['epoch'] for h in hist})} in {wall:.2f} s; step {step_ms:.2f} ms "
        f"(median of iterations 3-{iters}), {batch * T / step_ms * 1e3:.0f} tokens/s; "
        f"card {card}")
    log("    losses: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"    launches: flash_attention_fwd {counts[0]}, dq {counts[1]}, dkv {counts[2]} "
        f"(expected {layers} per iteration each = {layers * iters})")
    if len(hist) != iters or not all(np.isfinite(losses)) or len({h["epoch"] for h in hist}) < 2:
        raise AssertionError(f"training: {len(hist)} iterations, losses {losses}")
    if counts != (layers * iters,) * 3 or sum(all_counts.values()) != sum(counts):
        raise AssertionError(f"LM training launched {all_counts}, expected {layers * iters} of "
                             "each flash kernel and nothing else")
    del opt, model
    torch.cuda.empty_cache()

    # Flash route vs dense route: 3 SGD steps on one batch from the same weights.
    init = lm()
    init.init(sample_input=ids[:batch])
    w0 = {k: v.detach().cpu().numpy() for k, v in init.named_parameters()}
    del init
    runs = {}
    prev = os.environ.get("BIGDL_ATTN_IMPL")
    try:
        for impl in ("flash", "dense"):
            os.environ["BIGDL_ATTN_IMPL"] = impl
            m = lm()
            m.init(sample_input=ids[:batch])
            load_jax_params(m, w0)
            o = trainer(m, batch, 3)
            o.optimize()
            runs[impl] = ([h["loss"] for h in o.history],
                          torch.cat([p.detach().float().flatten() for p in m.parameters()]))
            del m, o
            torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("BIGDL_ATTN_IMPL", None)
        else:
            os.environ["BIGDL_ATTN_IMPL"] = prev
    p0 = torch.cat([torch.from_numpy(w0[k]).flatten() for k in w0]).to("cuda")
    (lf, pf), (ld, pd) = runs["flash"], runs["dense"]
    d_loss = max(abs(a - b) for a, b in zip(lf, ld))
    d_params = ((pf - pd).norm() / pd.norm()).item()
    d_update = ((pf - pd).norm() / (pd - p0).norm()).item()
    log(f"    flash vs dense route, 3 SGD steps from the same weights (card, bf16): losses "
        f"{[round(x, 4) for x in lf]} vs {[round(x, 4) for x in ld]}, max diff {d_loss:.2e} "
        f"(tol {TRAIN_TOL['loss']}); params rel diff {d_params:.2e} (tol "
        f"{TRAIN_TOL['params']}); update rel diff {d_update:.2e} (tol {TRAIN_TOL['update']})")
    if (len(lf) != 3 or d_loss > TRAIN_TOL["loss"] or d_params > TRAIN_TOL["params"]
            or d_update > TRAIN_TOL["update"]):
        raise AssertionError("the flash route's training disagrees with the dense route")
    return all_counts


# Tolerances of the max-pool backward kernel against its plain version, per
# element (fixed before the first run). Both recompute the same first argmax
# and route each window's dy once; a position sums at most
# ceil(kh/sh)*ceil(kw/sw) of them in fp32 (4 at the stem), in another order:
# f32: 1e-6 of that sum's magnitude (n·dy_max), the fp32 rounding of a few
#   additions in another order;
# bf16: both round the fp32 sum to bf16 once, so one bf16 step of |ref|
#   (2^-7 relative at most) plus the same fp32 allowance.
TOL_MAXPOOL = {"f32_rel_sum": 1e-6, "bf16_steps": 2.0 ** -7}


def _maxpool_case(shape, kernel, stride, padding, dtype, kind, g, offset=0):
    """x and dy of one case; with an offset, both are contiguous tensors whose
    storage starts that many elements earlier (data_ptr not 16-byte aligned)."""
    import torch
    from bigdl_tpu_torch.ops.maxpool import pooled_size

    n, c, h, w = shape
    x = torch.randn(shape, generator=g, device="cuda")
    if kind == "zeros":
        x.zero_()
    elif kind == "ints":
        x = torch.randint(0, 3, shape, generator=g, device="cuda").float()
    elif kind == "relu":
        x = torch.relu(x)
    elif kind == "nan":  # 5% NaN and 10% -inf cells
        u = torch.rand(shape, generator=g, device="cuda")
        x = x.masked_fill(u < 0.05, float("nan")).masked_fill((u >= 0.05) & (u < 0.15),
                                                               float("-inf"))
    ho, wo = pooled_size((h, w), kernel, stride, padding)
    dy = torch.randn((n, c, ho, wo), generator=g, device="cuda")
    if offset:
        x, dy = (torch.cat([t.new_zeros(offset), t.ravel()])[offset:].view(t.shape)
                 for t in (x.to(dtype), dy.to(dtype)))
        if x.data_ptr() % 16 == 0 or dy.data_ptr() % 16 == 0:
            raise AssertionError("an offset case's tensors are 16-byte aligned")
    return x.to(dtype), dy.to(dtype)


INCEPTION_S2 = ((3, 3), (2, 2), ((0, 1), (0, 1)))  # ceil mode: the overhang high only
INCEPTION_S1 = ((3, 3), (1, 1), ((1, 1), (1, 1)))
VGG_POOL = ((2, 2), (2, 2), ((0, 0), (0, 0)))
# (label, x shape, geometry, input kind): every distinct pool shape of
# [11]'s configs, at their batch (Inception 128, LeNet 512, VGG-for-CIFAR
# 128), in the order the networks run them
PARITY_CONFIG_POOLS = [
    ("Inception pool1 3x3/s2 ceil", (128, 64, 112, 112), INCEPTION_S2, "relu"),
    ("Inception pool2 3x3/s2 ceil", (128, 192, 56, 56), INCEPTION_S2, "relu"),
    ("Inception 3a branch pool 3x3/s1/p1", (128, 192, 28, 28), INCEPTION_S1, "relu"),
    ("Inception 3b branch pool 3x3/s1/p1", (128, 256, 28, 28), INCEPTION_S1, "relu"),
    ("Inception pool3 3x3/s2 ceil", (128, 480, 28, 28), INCEPTION_S2, "relu"),
    ("Inception 4a branch pool 3x3/s1/p1", (128, 480, 14, 14), INCEPTION_S1, "relu"),
    ("Inception 4b-4d branch pools 3x3/s1/p1", (128, 512, 14, 14), INCEPTION_S1, "relu"),
    ("Inception 4e branch pool 3x3/s1/p1", (128, 528, 14, 14), INCEPTION_S1, "relu"),
    ("Inception pool4 3x3/s2 ceil", (128, 832, 14, 14), INCEPTION_S2, "relu"),
    ("Inception 5a/5b branch pools 3x3/s1/p1", (128, 832, 7, 7), INCEPTION_S1, "relu"),
    ("LeNet-5 pool1 2x2/s2", (512, 6, 24, 24), VGG_POOL, "normal"),
    ("LeNet-5 pool2 2x2/s2", (512, 12, 8, 8), VGG_POOL, "normal"),
    # VGG-for-CIFAR-10 (batch 128): 32x32 down to 2x2 planes, pooled rows of
    # 16, 8, 4, 2 and 1 elements (the last two narrower than a 16-byte chunk)
    ("VGG-CIFAR pool2 2x2/s2", (128, 64, 32, 32), VGG_POOL, "relu"),
    ("VGG-CIFAR pool5 2x2/s2", (128, 128, 16, 16), VGG_POOL, "relu"),
    ("VGG-CIFAR pool9 2x2/s2", (128, 256, 8, 8), VGG_POOL, "relu"),
    ("VGG-CIFAR pool13 2x2/s2", (128, 512, 4, 4), VGG_POOL, "relu"),
    ("VGG-CIFAR pool17 2x2/s2", (128, 512, 2, 2), VGG_POOL, "relu"),
]
# launches a step of each shape that more than one pool has
POOLS_SHARING_A_SHAPE = {"Inception 4b-4d branch pools 3x3/s1/p1": 3,
                         "Inception 5a/5b branch pools 3x3/s1/p1": 2}
# AlexNet's three pools ([15a]) at the example's batch of 64: 3x3/s2 without
# padding on odd planes (55, 27 and 13 wide; pooled rows of 27, 13 and 6),
# their inputs post-ReLU (pool1 and pool2 after an LRN, which keeps the
# zeros); the example trains them in f32 on the card (f32 activations)
ALEX_POOL = ((3, 3), (2, 2), ((0, 0), (0, 0)))
ALEXNET_POOLS = [
    ("AlexNet pool1 3x3/s2", (64, 96, 55, 55), ALEX_POOL, "relu"),
    ("AlexNet pool2 3x3/s2", (64, 256, 27, 27), ALEX_POOL, "relu"),
    ("AlexNet pool5 3x3/s2", (64, 256, 13, 13), ALEX_POOL, "relu"),
]
# the keras example's two pools ([20a]) at its batch of 64: 2x2/s2 on 24- and
# 8-wide planes of 8 and 16 channels (pooled rows of 12 and 4), post-ReLU;
# the example trains in f32 activations on the card
KERAS_POOLS = [
    ("keras CNN pool1 2x2/s2", (64, 8, 24, 24), VGG_POOL, "relu"),
    ("keras CNN pool2 2x2/s2", (64, 16, 8, 8), VGG_POOL, "relu"),
]


def phase_maxpool_parity():
    """Max-pool backward kernel vs its plain version on the card; returns the
    flagship-shape record."""
    import torch
    from bigdl_tpu_torch.ops.maxpool import maxpool_grad, maxpool_grad_reference

    bf, f32 = torch.bfloat16, torch.float32
    stem = ((3, 3), (2, 2), ((1, 1), (1, 1)))
    vgg = ((2, 2), (2, 2), ((0, 0), (0, 0)))
    # (label, x shape, (kernel, stride, padding), dtype, input kind); the
    # first case is the one [4] times
    cases = [
        ("flagship stem pool", (128, 64, 112, 112), stem, bf, "normal"),
        # VGG-16's five 2x2/s2 pools at batch 64 (their inputs are ReLU outputs)
        ("VGG-16 pool2 batch 64", (64, 64, 224, 224), vgg, bf, "normal"),
        ("VGG-16 pool2, relu(normal) (zero windows)", (64, 64, 224, 224), vgg, bf, "relu"),
        ("VGG-16 pool5, relu(normal)", (64, 128, 112, 112), vgg, bf, "relu"),
        ("VGG-16 pool9, relu(normal)", (64, 256, 56, 56), vgg, bf, "relu"),
        ("VGG-16 pool13, relu(normal)", (64, 512, 28, 28), vgg, bf, "relu"),
        ("VGG-16 pool17, relu(normal)", (64, 512, 14, 14), vgg, bf, "relu"),
        # [17a]'s Siamese tower: the stem pool once a site, each at 64 images
        ("Siamese tower stem pool batch 64", (64, 64, 112, 112), stem, bf, "normal"),
        ("flagship stem pool f32", (128, 64, 112, 112), stem, f32, "normal"),
        ("flagship, relu(normal) (zero windows)", (128, 64, 112, 112), stem, bf, "relu"),
        ("2x2/s2 ceil overhang, odd size", (8, 16, 57, 57), ((2, 2), (2, 2), ((0, 1), (0, 1))),
         f32, "normal"),
        ("3x3/s1/p1", (8, 32, 56, 56), ((3, 3), (1, 1), ((1, 1), (1, 1))), bf, "normal"),
        ("(3,2)/(2,1) asymmetric padding", (4, 16, 31, 29), ((3, 2), (2, 1), ((1, 0), (0, 1))),
         f32, "normal"),
        ("2x2/s3 (rows no window touches)", (4, 8, 50, 50), ((2, 2), (3, 3), ((0, 0), (0, 0))),
         f32, "normal"),
        ("constant input (all tie)", (16, 64, 112, 112), stem, bf, "zeros"),
        ("integer duplicates", (16, 64, 112, 112), stem, f32, "ints"),
        ("N*C=21, W=520 (column tiles)", (3, 7, 300, 520), stem, bf, "normal"),
        ("5x4/s(1,3) asymmetric, f32", (2, 5, 30, 17), ((5, 4), (1, 3), ((2, 1), (0, 2))), f32,
         "normal"),
    ]
    # the redesigned kernel's alignment traps, each in both dtypes: rows of 56
    # and 28 bytes (VGG's pool13/pool17 at a small batch), a last plane group
    # or row band left part-full, x and dy at a storage offset of 1 element
    # (the label's "+1"), the stem at an odd size
    for dt in (bf, f32):
        name = str(dt)[6:]
        cases += [
            (f"pool13 rows W=28 batch 4, {name}", (4, 512, 28, 28), vgg, dt, "relu"),
            (f"pool17 rows W=14 batch 4, {name}", (4, 512, 14, 14), vgg, dt, "relu"),
            (f"W=14, 21 planes (part-full group), {name}", (3, 7, 14, 14), vgg, dt, "normal"),
            (f"W=28 +1 offset, {name}", (2, 24, 28, 28), vgg, dt, "relu"),
            (f"stem +1 offset, {name}", (4, 64, 112, 112), stem, dt, "normal"),
            (f"stem H=W=113 (odd), {name}", (8, 64, 113, 113), stem, dt, "normal"),
        ]
    # the 3x3/s1 instance's traps at the branch pools' widths, each in both
    # dtypes and repeated: 7-wide rows (5a/5b) and 28-wide rows (3a) at a
    # storage offset of 1 element, NaN and -inf inputs (a NaN at a window's
    # offset 0 keeps it there), planes larger than an item (row bands that
    # share window rows at their edges)
    s1_cases = []
    for dt in (bf, f32):
        name = str(dt)[6:]
        s1_cases += [
            (f"5a/5b branch pool +1 offset, {name}", (128, 832, 7, 7), INCEPTION_S1, dt, "relu"),
            (f"3a branch pool +1 offset, {name}", (128, 192, 28, 28), INCEPTION_S1, dt, "relu"),
            (f"5a/5b branch pool NaN and -inf, {name}", (128, 832, 7, 7), INCEPTION_S1, dt, "nan"),
            (f"3a branch pool NaN and -inf, {name}", (128, 192, 28, 28), INCEPTION_S1, dt, "nan"),
            (f"3x3/s1/p1 row bands 100x100, {name}", (4, 16, 100, 100), INCEPTION_S1, dt,
             "normal"),
        ]
    cases += s1_cases
    # every pool shape of the BASELINE parity configs [11] trains, each in
    # both dtypes and each repeated, their inputs as in the models (ReLU or
    # pooled ReLU outputs in Inception-v1 and VGG-for-CIFAR-10, tanh outputs
    # in LeNet-5): Inception's four ceil-mode 3x3/s2 pools, whose overhang is
    # on the high side only, its branch pools 3x3/s1/p1 (the 3x3/s1
    # instance) at all six shapes, LeNet-5's 2x2/s2 pools on 24- and 8-wide
    # planes (pooled rows of 12 and 4), VGG-for-CIFAR-10's five on 32- to
    # 2-wide planes (pooled rows of 16 down to 1)
    config_cases = [(f"{label}, {str(dt)[6:]}", shape, geometry, dt, kind)
                    for label, shape, geometry, kind in PARITY_CONFIG_POOLS for dt in (bf, f32)]
    cases += config_cases
    # AlexNet's three pools in both dtypes (f32 is the example's), each
    # post-ReLU (zero ties), with integer duplicates (planted ties), with NaN
    # and -inf cells, and at a storage offset of one element, each repeated
    alex_cases = [(f"{label}, {kind}, {str(dt)[6:]}" + (" +1 offset" if kind == "offset" else ""),
                   shape, geometry, dt, "relu" if kind == "offset" else kind)
                  for label, shape, geometry, _ in ALEXNET_POOLS for dt in (f32, bf)
                  for kind in ("relu", "ints", "nan", "offset")]
    cases += alex_cases
    # the keras example's two pools in both dtypes (f32 is the example's), each repeated
    keras_cases = [(f"{label}, {str(dt)[6:]}", shape, geometry, dt, kind)
                   for label, shape, geometry, kind in KERAS_POOLS for dt in (f32, bf)]
    cases += keras_cases
    repeated = {"flagship stem pool", "VGG-16 pool2 batch 64", "Siamese tower stem pool batch 64",
                "VGG-16 pool2, relu(normal) (zero windows)", *(c[0] for c in config_cases),
                *(c[0] for c in s1_cases), *(c[0] for c in alex_cases),
                *(c[0] for c in keras_cases)}
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    log(f"[3c] max-pool backward kernel vs plain version on the card "
        f"(|err| <= bf16_steps*|ref| [bf16] + f32_rel_sum*n*max|dy|; {TOL_MAXPOOL})")
    record = None
    for label, shape, (kernel, stride, padding), dt, kind in cases:
        x, dy = _maxpool_case(shape, kernel, stride, padding, dt, kind, g,
                              1 if "+1 offset" in label else 0)
        got = maxpool_grad(x, dy, kernel, stride, padding)
        torch.cuda.synchronize()
        ref = maxpool_grad_reference(x, dy, kernel, stride, padding)
        n_terms = -(-kernel[0] // stride[0]) * -(-kernel[1] // stride[1])
        allow = TOL_MAXPOOL["f32_rel_sum"] * n_terms * dy.float().abs().max().item()
        err = (got.float() - ref.float()).abs()
        if dt == bf:
            bound = allow + TOL_MAXPOOL["bf16_steps"] * ref.float().abs()
        else:
            bound = torch.full_like(err, allow)
        ok = bool((err <= bound).all()) and bool(torch.isfinite(got).all())
        mass = abs(got.float().sum().item() - dy.float().sum().item()) / max(
            dy.float().abs().sum().item(), 1e-30)  # every window routes its dy once
        log(f"    {label:40s} {str(dt)[6:]:8s} max err {err.max().item():.3e}  "
            f"gradient mass drift {mass:.1e}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"maxpool_grad disagrees with its plain version: {label}")
        if label in repeated:
            again = maxpool_grad(x, dy, kernel, stride, padding)
            same = torch.equal(got, again)
            log(f"    repeated backward bit-identical: {same}")
            if not same:
                raise AssertionError(f"two runs of the max-pool kernel gave different bits: {label}")
            del again
        if record is None:
            record = dict(x=x, dy=dy, dx=got, geometry=(kernel, stride, padding),
                          max_abs_err=err.max().item())
        del x, dy, got, ref, err, bound
    torch.cuda.empty_cache()
    return record


# the shapes [4] times the max-pool backward at: the flagship's stem pool
# (the record's headline), VGG-16's five 2x2/s2 pools at batch 64 (their
# inputs are ReLU outputs) and the parity configs' new geometries
MAXPOOL_SHAPES = [
    ("stem", (128, 64, 112, 112), ((3, 3), (2, 2), ((1, 1), (1, 1))), "normal"),
    ("VGG-16 pool2", (64, 64, 224, 224), VGG_POOL, "relu"),
    ("VGG-16 pool5", (64, 128, 112, 112), VGG_POOL, "relu"),
    ("VGG-16 pool9", (64, 256, 56, 56), VGG_POOL, "relu"),
    ("VGG-16 pool13", (64, 512, 28, 28), VGG_POOL, "relu"),
    ("VGG-16 pool17", (64, 512, 14, 14), VGG_POOL, "relu"),
    ("Siamese tower stem (a site)", (64, 64, 112, 112), ((3, 3), (2, 2), ((1, 1), (1, 1))),
     "normal"),
    *PARITY_CONFIG_POOLS,
    *((f"{label} f32", shape, geometry, kind, "float32")
      for label, shape, geometry, kind in ALEXNET_POOLS),
    *((f"{label} bf16", shape, geometry, kind, "bfloat16")
      for label, shape, geometry, kind in ALEXNET_POOLS),
    *((f"{label} {name}", shape, geometry, kind, dt)
      for label, shape, geometry, kind in KERAS_POOLS
      for name, dt in (("f32", "float32"), ("bf16", "bfloat16"))),
]


def phase_maxpool_times(rec, card, floor_ms):
    """Times of the max-pool backward kernel (launched through its C entry
    point, so the wrapper's count stays the main paths'), its plain version
    and ATen's max-pool backward from saved indices, beside the bound, at
    the stem (the parity phase's inputs), VGG-16's five pools and the parity
    configs' pools (bf16), and AlexNet's three and the keras example's two
    in f32 (their examples') and bf16, each beside ``floor_ms``, the launch
    floor. ATen takes a
    high-side-only overhang as its ceil mode with no padding."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.maxpool import maxpool_grad_reference

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = []
    for label, shape, (kernel, stride, padding), kind, *dtype in MAXPOOL_SHAPES:
        dt = getattr(torch, dtype[0]) if dtype else torch.bfloat16
        if label == "stem":
            x, dy, dx = rec["x"], rec["dy"], torch.empty_like(rec["dx"])
        else:
            x, dy = _maxpool_case(shape, kernel, stride, padding, dt, kind, g)
            dx = torch.empty_like(x)
        n, c, h, w = x.shape
        ho, wo = dy.shape[2:]

        def launch():
            rc = lib.bigdl_maxpool2d_bwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                         1 if x.dtype == torch.bfloat16 else 0, n * c, h, w, ho,
                                         wo, *kernel, *stride, padding[0][0], padding[1][0],
                                         stream)
            if rc != 0:
                raise RuntimeError(f"maxpool kernel launch failed with CUDA error {rc}")

        ms = cuda_ms(launch, iters=50)
        plain_ms = cuda_ms(lambda: maxpool_grad_reference(x, dy, kernel, stride, padding),
                           iters=3, warmup=1)
        ceil = padding[0][1] > padding[0][0]
        _, idx = F.max_pool2d(x, kernel, stride, padding[0][0], ceil_mode=ceil,
                              return_indices=True)
        if idx.shape != dy.shape:
            raise AssertionError(f"ATen's pool of {label} is {tuple(idx.shape)}, not "
                                 f"{tuple(dy.shape)}")
        library_ms = cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            dy, x, list(kernel), list(stride), [padding[0][0], padding[1][0]], [1, 1], ceil,
            idx), iters=50)
        b, by = bound_ms(0.0, (x, dy, dx), card)
        idx_mb = idx.numel() * idx.element_size() / 1e6
        del idx
        geometry = (f"{kernel[0]}x{kernel[1]}/s{stride[0]}/p{padding[0][0]}"
                    + ("/ceil" if ceil else ""))
        log(f"[4] kernels: maxpool2d_bwd {label} {tuple(x.shape)} {str(x.dtype)[6:]} "
            f"{geometry}: verdict ok, "
            f"kernel_ms {ms:.4f}, plain_ms {plain_ms:.4f}, bound_ms {b:.4f} ({by}; x, dy read "
            f"and dx written once; kernel/bound {ms / b:.2f}), library_ms {library_ms:.4f} "
            f"(ATen max_pool2d_with_indices_backward, which also reads {idx_mb:.1f} MB of saved "
            f"int64 indices; yardstick only; ATen/kernel {library_ms / ms:.2f}); card {card}")
        if ms >= library_ms:
            log(f"    maxpool2d_bwd {label}: the kernel is not faster than ATen's backward")
        rows.append({"shape": label, "x": list(x.shape), "dtype": str(x.dtype)[6:],
                     "geometry": geometry, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": library_ms})
        if label != "stem":
            del x, dy
        del dx
    for net, n_pools in (("VGG-16", 5), ("Inception", 13), ("VGG-CIFAR", 5),
                         ("AlexNet", 3), ("keras CNN", 2)):
        per_step = [(r, POOLS_SHARING_A_SHAPE.get(r["shape"], 1)) for r in rows
                    if r["shape"].startswith(net) and r["dtype"] == (
                        "float32" if net in ("AlexNet", "keras CNN") else "bfloat16")]
        if sum(k for _, k in per_step) != n_pools:
            raise AssertionError(f"[4] times {net}'s pools at {per_step}, not its {n_pools}")
        log(f"    {net}'s {n_pools} pools a step: " + ", ".join(
            f"{name} {sum(r[key] * k for r, k in per_step):.4f} ms"
            for name, key in (("kernel", "ms"), ("ATen", "library_ms"), ("bound", "bound_ms"))))
    branch = [(r, POOLS_SHARING_A_SHAPE.get(r["shape"], 1)) for r in rows
              if "branch pool" in r["shape"]]
    if sum(k for _, k in branch) != 9:
        raise AssertionError(f"[4] times Inception's branch pools at {branch}, not its nine")
    log("    Inception's nine branch pools (3x3/s1/p1) a step: " + ", ".join(
        f"{name} {sum(r[key] * k for r, k in branch):.4f} ms"
        for name, key in (("kernel", "ms"), ("ATen", "library_ms"), ("bound", "bound_ms"))))
    for r, _ in branch:
        log(f"    {r['shape']}: the kernel "
            f"{'beats' if r['ms'] < r['library_ms'] else 'does NOT beat'} ATen's backward "
            f"(ATen/kernel {r['library_ms'] / r['ms']:.2f}); 4x-bound target "
            f"{'met' if r['ms'] <= 4 * r['bound_ms'] else 'missed'} "
            f"(kernel/bound {r['ms'] / r['bound_ms']:.2f})")
    for r in rows:
        if r["shape"].startswith(("AlexNet", "keras CNN")):
            log(f"    {r['shape']}: kernel/bound {r['ms'] / r['bound_ms']:.2f}, ATen/kernel "
                f"{r['library_ms'] / r['ms']:.2f}; the bound is "
                f"{'below' if r['bound_ms'] < floor_ms else 'above'} the launch floor, "
                f"{floor_ms:.4f} ms (an all but empty kernel through the probe's C entry "
                f"point, [4])")
    site = next(r for r in rows if r["shape"].startswith("Siamese"))
    log(f"    Siamese tower: two sites a step, kernel {2 * site['ms']:.4f} ms, ATen "
        f"{2 * site['library_ms']:.4f} ms, bound {2 * site['bound_ms']:.4f} ms (the stem at "
        f"batch 128: kernel {rows[0]['ms']:.4f}, bound {rows[0]['bound_ms']:.4f})")
    log(f"    stem half-bound target (<= 2x bound) "
        f"{'met' if rows[0]['ms'] <= 2 * rows[0]['bound_ms'] else 'missed'}")
    torch.cuda.empty_cache()
    head = rows[0]
    return {
        "name": "maxpool2d_bwd",
        "route": "cuda",
        "source": "bigdl_tpu_torch/csrc/maxpool_bwd.cu",
        "replaces": "bigdl_tpu/ops/maxpool.py:51",
        "launches": None,  # filled from the main path's run
        "max_abs_err": rec["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shapes": rows,
    }


# Kernel route (card, f32, TF32 off) vs plain route (CPU, f32) over 3 SGD
# steps of ResNet-50 from the same weights, fixed before the first run. The
# gradient of a ReLU network is piecewise: a gate whose input lies within the
# two routes' summation-order difference of zero opens on one side only, and
# a few such flips move the whole gradient by a few percent, which SGD then
# carries into the weights. So the check is at lr 0.01 (the flagship's 0.1
# turns those flips into a different trajectory within 3 steps). The losses
# of steps 2-3 are the most sensitive reading: on an H100 the two routes'
# step-3 losses were 6.6e-2 apart (relative) while their parameters were
# 1.3e-3 apart, so that tolerance is 1.5e-1:
ROUTE_TOL = {
    "loss_first": 1e-3,  # step 1, same weights: |loss_card - loss_cpu|
    "loss": 1.5e-1,      # steps 2-3: |loss_card - loss_cpu| / max(1, |loss_cpu|)
    "params": 1e-2,      # ||p_card - p_cpu|| / ||p_cpu||
    "state": 2e-1,       # ||s_card - s_cpu|| / ||s_cpu - s0|| (BN running statistics)
}


def _tree_to_numpy(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_to_numpy(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().float().cpu().numpy()
    return out


def _nest(flat):
    out = {}
    for path, a in flat.items():
        node = out
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = a
    return out


def phase_flagship(card):
    """Train the flagship ResNet-50 through LocalOptimizer; returns every
    kernel's launches of that run."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import flagship_model
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    batch, n_records, iters = 128, 384, 10
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    RandomGenerator.set_seed(1)
    t0 = time.perf_counter()
    model, images, labels, name = flagship_model(batch=n_records, seed=SEED, stem="s2d",
                                                 device="cuda")
    model.init(sample_input=images[:batch])  # what optimize() would build from
    s0 = _tree_to_numpy(model.get_state())
    log(f"[7] {name}: {model.n_parameters() / 1e6:.3f} M params, {n_records} records of "
        f"{tuple(images.shape[1:])} f32, built in {time.perf_counter() - t0:.1f} s")
    opt = LocalOptimizer(model, DataSet.array(images, labels, batch_size=batch),
                         ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(iters))
    mem = []  # device memory after each iteration (LocalOptimizer sets the state once per step)
    set_state = model.set_state
    model.set_state = lambda st: (set_state(st), mem.append(_mem()))[0]
    reset_counts()  # the main path starts here
    t0, cpu0 = time.perf_counter(), (time.thread_time(), time.process_time())
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = [(now - then) / wall for now, then in zip((time.thread_time(), time.process_time()),
                                                      cpu0)]
    counts = read_counts()  # the main path ends here
    launches = counts["maxpool2d_bwd"]
    others = sum(counts.values()) - launches
    del model.set_state
    hist = opt.history
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3  # iterations 3-10
    log(f"    trained {len(hist)} iterations over epochs {sorted({h['epoch'] for h in hist})} "
        f"in {wall:.2f} s: step {step_ms:.2f} ms (median of iterations 3-{iters}), "
        f"{batch / step_ms * 1e3:.1f} images/s (batch {batch}, bf16 compute and activations); "
        f"card {card}")
    log("    losses: " + ", ".join(f"{x:.4f}" for x in losses))
    log(f"    maxpool2d_bwd launches: {launches} (expected 1 per iteration = {iters}); other "
        f"kernels: {others}")
    if len(hist) != iters or not all(np.isfinite(losses)):
        raise AssertionError(f"flagship training: {len(hist)} iterations, losses {losses}")
    if launches != iters or others:
        raise AssertionError(f"flagship training launched {counts}, expected {iters} of "
                             "maxpool2d_bwd and nothing else")
    state = model.get_state()
    s1 = _tree_to_numpy(state)
    on_card = all(t.is_cuda for t in _flat_tensors(state))
    moved = [k for k in s0 if not np.array_equal(s0[k], s1[k])]
    finite = all(np.isfinite(v).all() for v in s1.values())
    log(f"    BN running statistics: {len(moved)} of {len(s0)} moved, all finite: {finite}, "
        f"all on the card: {on_card}")
    if len(moved) != len(s0) or not finite or not on_card:
        raise AssertionError("flagship training: BN running statistics did not all advance")
    # memory_allocated counts live tensors only; a state that held its step's
    # graph would grow by that step's saved activations (GBs) per iteration.
    # Allowed: 100 MB, about one f32 image batch (77 MB) in flight.
    drift = mem[iters - 1] - mem[2]
    log(f"    device memory allocated after iteration 3: {mem[2] / 2**20:.1f} MiB, after "
        f"iteration {iters}: {mem[iters - 1] / 2**20:.1f} MiB (drift {drift / 2**20:+.1f} MiB, "
        f"allowed +-100 MiB); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if abs(drift) > 100 * 2 ** 20:
        raise AssertionError("device memory grew over the flagship iterations")
    del opt, model, images, state
    torch.cuda.empty_cache()
    _flagship_routes()
    return counts


def _flat_tensors(tree):
    for v in tree.values():
        yield from (_flat_tensors(v) if isinstance(v, dict) else (v,))


def _flagship_routes():
    """3 SGD steps of an f32 ResNet-50 on the card (the max-pool kernel) vs
    on the CPU (its plain version), from one numpy-made set of weights."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.ops import maxpool as mp
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

    prev = (Engine.compute_dtype(), Engine.activation_dtype(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 on the card is full f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(SEED + 3)
        x = rng.standard_normal((8, 3, 112, 112)).astype(np.float32)
        y = rng.integers(0, 1000, 8)
        RandomGenerator.set_seed(SEED + 3)
        init = ResNet(50, stem="s2d", device="cpu")
        init.init(sample_input=x)
        w0 = {k: v.detach().numpy().copy() for k, v in init.named_parameters()}
        s0 = _tree_to_numpy(init.get_state())
        runs = {}
        for device in ("cuda", "cpu"):
            RandomGenerator.set_seed(SEED + 3)
            m = ResNet(50, stem="s2d", device=device)
            m.init(sample_input=x)
            load_jax_params(m, _nest(w0))
            load_jax_state(m, _nest(s0))
            o = LocalOptimizer(m, DataSet.array(x, y, batch_size=8), ClassNLLCriterion())
            o.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
            before = mp.launches
            t0 = time.perf_counter()
            o.set_end_when(Trigger.max_iteration(3)).optimize()
            runs[device] = ([h["loss"] for h in o.history], _tree_to_numpy(m.get_parameters()),
                            _tree_to_numpy(m.get_state()), mp.launches - before,
                            time.perf_counter() - t0)
            del m, o
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[2:]
    (lc, pc, sc, kc, tc), (lp, pp, sp, kp, tp) = runs["cuda"], runs["cpu"]

    def dist(a, b):
        return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b)))

    d_first = abs(lc[0] - lp[0])
    d_loss = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lc[1:], lp[1:]))
    d_params = dist(pc, pp) / dist(pp, {k: np.zeros_like(v) for k, v in pp.items()})
    d_state = dist(sc, sp) / dist(sp, s0)
    log(f"    kernel route (card, f32, TF32 off) vs plain route (CPU, f32), ResNet-50 s2d, "
        f"(8, 3, 112, 112), 3 steps of SGD lr 0.01 momentum 0.9: losses "
        f"{[round(v, 5) for v in lc]} vs {[round(v, 5) for v in lp]}; step 1 diff "
        f"{d_first:.2e} (tol {ROUTE_TOL['loss_first']}), steps 2-3 rel diff {d_loss:.2e} "
        f"(tol {ROUTE_TOL['loss']}); params rel diff {d_params:.2e} (tol "
        f"{ROUTE_TOL['params']}); BN state diff / its change {d_state:.2e} (tol "
        f"{ROUTE_TOL['state']}); maxpool2d_bwd launches card {kc}, CPU {kp}; "
        f"{tc:.1f} s card, {tp:.1f} s CPU")
    if (len(lc) != 3 or kc != 3 or kp != 0 or d_first > ROUTE_TOL["loss_first"]
            or d_loss > ROUTE_TOL["loss"] or d_params > ROUTE_TOL["params"]
            or d_state > ROUTE_TOL["state"]):
        raise AssertionError("the kernel route's training disagrees with the plain route")


# [10] resumed flagship vs the uninterrupted run, fixed before the first run:
# both runs take cuDNN's deterministic algorithms (benchmark off), the
# max-pool backward kernel repeats to the bit ([3c]), every other op of the
# step is a deterministic torch op (the loss's gather backward adds once to
# each element), and the checkpoint holds every f32 parameter, slot and BN
# statistic exactly; so iterations 4-6 of the resumed run recompute the
# uninterrupted run's arithmetic on the same values, and their losses,
# parameters and BN state must be equal to the bit.
# The padded ragged tail (44 of a 300-record set at batch 128) against an
# unpadded forward of its 44 records is held in f32 (TF32 off): there the
# two batch sizes differ by fp32 summation order only (~1e-6 relative),
# while in bf16 cuDNN may pick other algorithms at batch 44 than at 128 whose
# sums round to other bf16 values, moving a logit near a rank boundary for a
# reason that is not the pad. Counts exactly; Loss's numerator (the sum of
# the rows' losses) 1e-5 relative.
# The counters of a validation (and of Evaluator) against a plain numpy
# computation over the same outputs (the trained model's eval forward of the
# 300 records at the sweep's batches): Top-1 (first max) and Top-5 (the last
# five of a stable ascending sort) exactly; Loss's numerator 1e-5 relative
# (the card's fp32 means per batch against one float64 sum). A third of the
# records take the model's own top-1 class as label and a third its
# 3rd-ranked, so both counts are well above zero.
TAIL_LOSS_RTOL = 1e-5


def phase_flagship_val(card):
    """Train the flagship ResNet-50 with validation and checkpoints, then a
    fresh model resumed from the mid-run checkpoint; returns every kernel's
    launches of that path (both runs and an ``Evaluator`` sweep)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet, to_device
    from bigdl_tpu_torch.models import ResNet, flagship_model
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, Evaluator, LocalOptimizer, Loss, Top1Accuracy,
                                       Top5Accuracy, Trigger)
    from bigdl_tpu_torch.utils.serialization import _checkpoint_steps, tree_items

    batch, n_train, n_val, iters, every = 128, 640, 300, 6, 3
    methods = [Top1Accuracy(), Top5Accuracy(), Loss(ClassNLLCriterion())]
    prev = (Engine.compute_dtype(), Engine.activation_dtype(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build"))
    ckpt_dir, resume_dir = str(tmp / "run"), str(tmp / "resume")
    try:
        RandomGenerator.set_seed(1)
        t0 = time.perf_counter()
        model, images, labels, name = flagship_model(batch=n_train, seed=SEED, stem="s2d",
                                                     device="cuda")
        vx = np.random.default_rng(SEED + 10).standard_normal(
            (n_val, 3, 224, 224)).astype(np.float32)
        vy = np.random.default_rng(SEED + 11).integers(0, 1000, n_val)
        model.init(sample_input=images[:batch])
        log(f"[10] {name} validated and checkpointed: {n_train} training records (5 batches an "
            f"epoch), {n_val} validation records (batches of {batch}, a ragged tail of "
            f"{n_val % batch}), bf16 compute and activations, cuDNN deterministic; built in "
            f"{time.perf_counter() - t0:.1f} s")
        val = DataSet.array(vx, vy, batch_size=batch)

        def optimizer(m, path, val):
            o = LocalOptimizer(m, DataSet.array(images, labels, batch_size=batch),
                               ClassNLLCriterion())
            o.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
            o.set_validation(Trigger.several_iteration(every), val, methods)
            o.set_checkpoint(path, Trigger.several_iteration(every), keep_last=1)
            return o.set_end_when(Trigger.max_iteration(iters))

        vals, ckpts, mem = [], [], []

        def instrument(o, m):
            """Time each validation event and checkpoint write; device memory
            after each iteration, and what each validation leaves allocated;
            a copy of the mid-run checkpoint (step every + 1) for the resume."""
            run_validation, write_checkpoint, set_state = (o._run_validation,
                                                           o._write_checkpoint, m.set_state)

            def timed_validation():
                t, before = time.perf_counter(), _mem()
                res = run_validation()
                if res is not None:
                    vals.append((o.optim_method.state["neval"], res, time.perf_counter() - t,
                                 _mem() - before))
                return res

            def timed_checkpoint(state, slots):
                t = time.perf_counter()
                manifest = write_checkpoint(state, slots)
                ckpts.append((state["neval"], time.perf_counter() - t,
                              sum(f["bytes"] for f in manifest["files"].values()),
                              _checkpoint_steps(o.checkpoint_path)))
                if o.checkpoint_path == ckpt_dir and state["neval"] == every + 1:
                    shutil.copytree(ckpt_dir, resume_dir)
                return manifest

            o._run_validation, o._write_checkpoint = timed_validation, timed_checkpoint
            m.set_state = lambda st: (set_state(st), mem.append(_mem()))[0]

        opt = optimizer(model, ckpt_dir, val)
        instrument(opt, model)
        reset_counts()  # the path starts here
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first_counts = read_counts()
        first_vals, first_ckpts, first_mem = list(vals), list(ckpts), list(mem)
        # the instrumenting closures refer to their optimizer and model: each
        # instance attribute removed, or optimizer -> closure -> optimizer
        # (and its model and slots) waits for the cyclic collector
        del model.set_state, opt._run_validation, opt._write_checkpoint
        # the trained model's outputs over the validation set, the labels
        # planted from them for the resumed run's validation and Evaluator
        out = _sweep_outputs(model, vx, batch)
        vy2 = _planted_labels(out, np.random.default_rng(SEED + 12))
        val2 = DataSet.array(vx, vy2, batch_size=batch)

        model2 = ResNet(50, class_num=1000, dataset="imagenet", stem="s2d", device="cuda")
        model2.init(sample_input=images[:batch])
        opt2 = optimizer(model2, resume_dir, val2)
        t0 = time.perf_counter()
        opt2.resume()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        instrument(opt2, model2)
        opt2.optimize()
        del model2.set_state, opt2._run_validation, opt2._write_checkpoint
        t0 = time.perf_counter()
        ev = Evaluator(model).evaluate(val2, methods)
        sweep_s = time.perf_counter() - t0
        counts = read_counts()  # the path ends here

        xb = to_device(vx[:batch], torch.device("cuda"))
        with torch.inference_mode():
            eval_ms = cuda_ms(lambda: model.apply(model.get_parameters(), model.get_state(), xb,
                                                  training=False), iters=10)
        tail = _tail_check(model, methods, vx[2 * batch:], vy2[2 * batch:], batch)
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2:]
        shutil.rmtree(tmp, ignore_errors=True)

    def nums(res):
        return {k: (r.correct if hasattr(r, "correct") else r.loss_sum, r.count)
                for k, r in res.items()}

    def same(a, b):
        return nums(a) == nums(b)

    def like_host(res, want):
        got = nums(res)
        return got.keys() == want.keys() and all(
            got[k][1] == want[k][1] and (abs(got[k][0] - want[k][0]) <= TAIL_LOSS_RTOL * abs(
                want[k][0]) if k == "Loss" else got[k][0] == want[k][0]) for k in want)

    host1, host2 = _host_counters(out, vy, batch), _host_counters(out, vy2, batch)
    second_vals = vals[len(first_vals):]

    losses, losses2 = [h["loss"] for h in opt.history], [h["loss"] for h in opt2.history]
    n_params = sum(1 for _ in model.parameters())
    p_diff = [k for (k, a), (_, b) in zip(model.named_parameters(), model2.named_parameters())
              if not torch.equal(a, b)]
    s1, s2 = tree_items(model.get_state()), tree_items(model2.get_state())
    s_diff = [k for k in s1 if not torch.equal(s1[k], s2[k])]
    log(f"    trained {len(losses)} iterations in {wall:.2f} s (validation and checkpoints "
        f"included); losses " + ", ".join(f"{x:.6f}" for x in losses))
    log(f"    resumed from step {every + 1} in {load_s:.3f} s (load, verify, copy to the card); "
        f"iterations {every + 1}-{iters} losses " + ", ".join(f"{x:.6f}" for x in losses2)
        + f"; equal to the bit: losses {losses2 == losses[every:]}, parameters "
        f"{len(p_diff)} of {n_params} differ, BN state "
        f"{len(s_diff)} of {len(s1)} differ (limit: 0)")
    for neval, res, sec, _ in first_vals:
        log(f"    validation at neval {neval}: {res} in {sec * 1e3:.1f} ms "
            f"({n_val / sec:.1f} images/s)")
    for neval, sec, size, steps in first_ckpts:
        log(f"    checkpoint {neval}: {size / 1e6:.1f} MB written in {sec:.3f} s; checkpoints "
            f"on disk after it: {steps}")
    log(f"    counters against numpy over the same outputs: first run's validation at neval "
        f"{2 * every + 1} {nums(first_vals[-1][1]) if first_vals else None} vs {host1} (random "
        f"labels); resumed run's {nums(second_vals[-1][1]) if second_vals else None} and "
        f"Evaluator's {nums(ev)} vs "
        f"{host2} (planted labels; Loss rtol {TAIL_LOSS_RTOL}, counts exact)")
    log(f"    Evaluator sweep: {ev} in {sweep_s * 1e3:.1f} ms ({n_val / sweep_s:.1f} images/s); "
        f"eval forward at batch {batch} {eval_ms:.2f} ms ({batch / eval_ms * 1e3:.1f} images/s, "
        f"bf16); card {card}")
    log(f"    padded tail vs unpadded forward of its {n_val % batch} records (f32, TF32 off): "
        f"{tail[0]} vs {tail[1]}")
    n_steps = iters + (iters - every)
    want = {k: (n_steps if k == "maxpool2d_bwd" else 0) for k in counts}
    log(f"    launches: first run {_nonzero(first_counts)}, whole path {_nonzero(counts)} "
        f"(expected {_nonzero(want)})")
    # 100 MiB allowed, as for [7]: memory after each iteration (the step's
    # batch still alive) flat from iteration 3 on, across the validation and
    # checkpoint after it; and what each validation event leaves allocated
    base = first_mem[every - 1]
    drift = [m - base for m in first_mem[every:]] + [v[3] for v in first_vals]
    log(f"    device memory after iteration {every}: {base / 2**20:.1f} MiB; after iterations "
        f"{every + 1}-{iters}: {[round((m - base) / 2**20, 1) for m in first_mem[every:]]} MiB "
        f"from it; left by each validation: {[round(v[3] / 2**20, 1) for v in first_vals]} MiB "
        f"(allowed +-100 MiB)")
    problems = []
    if losses2 != losses[every:] or p_diff or s_diff or len(losses2) != iters - every:
        problems.append("the resumed run differs from the uninterrupted run")
    if [v[0] for v in first_vals] != [every + 1, 2 * every + 1] or [
            v[0] for v in second_vals] != [2 * every + 1] or not same(second_vals[0][1], ev):
        problems.append("validation events or Evaluator disagree")
    if not (first_vals and like_host(first_vals[-1][1], host1) and second_vals
            and like_host(second_vals[-1][1], host2) and like_host(ev, host2)):
        problems.append("validation counters disagree with numpy over the same outputs")
    if host2["Top1Accuracy"][0] < n_val // 3 or host2["Top5Accuracy"][0] < 2 * (n_val // 3):
        problems.append(f"planted labels gave too few hits: {host2}")
    if not tail[2]:
        problems.append("the padded tail disagrees with the unpadded forward")
    if not all(tail[0][k][0] > 0 for k in ("Top1Accuracy", "Top5Accuracy")):
        problems.append(f"the padded tail's counts are zero: {tail[0]}")
    if [c[3] for c in first_ckpts] != [[every + 1], [2 * every + 1]]:
        problems.append(f"checkpoints on disk {[c[3] for c in first_ckpts]}, expected one each")
    if first_counts != {k: (iters if k == "maxpool2d_bwd" else 0) for k in counts} or \
            counts != want:
        problems.append(f"launches {counts}, expected {want}")
    if any(abs(d) > 100 * 2 ** 20 for d in drift):
        problems.append("device memory grew across iterations or validations")
    if not all(np.isfinite(losses + losses2)):
        problems.append("non-finite losses")
    if problems:
        raise AssertionError("flagship validate/checkpoint/resume: " + "; ".join(problems))
    return counts


def _sweep_outputs(model, vx, batch):
    """The eval forward's outputs over ``vx`` at the sweep's batches (the
    tail padded to ``batch``), as f32 on the host."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import to_device
    from bigdl_tpu_torch.optim.predictor import forward_padded

    dev = torch.device("cuda")
    return np.concatenate([
        forward_padded(model, model.get_parameters(), model.get_state(),
                       to_device(vx[s:s + batch], dev), batch).float().cpu().numpy()
        for s in range(0, len(vx), batch)])


def _planted_labels(out, rng):
    """Record i's label: its top-1 class (i % 3 == 0), its 3rd-ranked class
    (i % 3 == 1, in the top five but not first), else a random class."""
    import numpy as np

    rank = np.argsort(out, axis=-1, kind="stable")
    labels = rng.integers(0, out.shape[1], out.shape[0])
    labels[0::3] = np.argmax(out[0::3], axis=-1)
    labels[1::3] = rank[1::3, -3]
    return labels


def _host_counters(out, labels, batch):
    """Top1Accuracy, Top5Accuracy and Loss(ClassNLLCriterion) numerators and
    counts over ``out`` (log-probabilities), in plain numpy."""
    import numpy as np

    n = len(labels)
    top5 = np.argsort(out, axis=-1, kind="stable")[:, -5:]
    return {"Top1Accuracy": (float(np.sum(np.argmax(out, axis=-1) == labels)), n),
            "Top5Accuracy": (float(np.sum(np.any(top5 == labels[:, None], axis=-1))), n),
            "Loss": (float(-np.sum(out[np.arange(n), labels].astype(np.float64))), n)}


def _tail_check(model, methods, tx, ty, batch):
    """The sweep's tail step (the 44 records padded to ``batch`` by row 0,
    the output sliced back) against the same step on the unpadded records,
    in f32 with TF32 off; returns (padded counters, unpadded counters, ok)."""
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.dataset import to_device
    from bigdl_tpu_torch.optim.predictor import forward_padded

    prev = (Engine.compute_dtype(), Engine.activation_dtype(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        dev = torch.device("cuda")
        x, t, n = to_device(tx, dev), to_device(ty, dev), len(tx)
        p, s = model.get_parameters(), model.get_state()
        with torch.inference_mode():
            got = [(float(a), c) for a, c in (m.metric(forward_padded(model, p, s, x, batch), t)
                                              for m in methods)]
            ref = [(float(a), c) for a, c in (m.metric(forward_padded(model, p, s, x, n), t)
                                              for m in methods)]
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[2:]
    ok = n < batch and all(
        g[1] == r[1] == n and (abs(g[0] - r[0]) <= TAIL_LOSS_RTOL * abs(r[0])
                               if m.name == "Loss" else g[0] == r[0])
        for m, g, r in zip(methods, got, ref))
    return ({m.name: g for m, g in zip(methods, got)},
            {m.name: r for m, r in zip(methods, ref)}, ok)


# Tolerances of the bias+activation kernels against their plain version,
# per element (fixed before the first run): both compute z = x + b and the
# activation in fp32 in the same order, so they differ only where ATen's
# tanh and the kernel's tanhf differ (a few units in the last place of t),
# amplified by the formula: |dy/dt| = |z|/2 for GELU's output, |dg/dt| =
# |0.5 - z*t*du| (GELU) or 2|t| (tanh) for dx = dy*g(t):
# y, dx: 1e-6 + 1e-5*|ref| + TANH_ULPS*|d/dt| (+ one bf16 step, 2^-7*|ref|,
#   for bf16, as both round an fp32 value once);
# db: 1e-5 * sum|dz| + the summed tanh terms (fp32 sums in another order).
TOL_EPILOGUE = {"atol": 1e-6, "rtol": 1e-5, "bf16_steps": 2.0 ** -7, "tanh_ulps": 4 * 2.0 ** -24}


def _epilogue_allowances(x, b, dy, act, axis):
    """Allowances of y and dx (per element) and of db (per bias entry)."""
    import math

    import torch
    from bigdl_tpu_torch.ops import fused_epilogue as fe

    mode = "feature" if axis == -1 else "row"
    z = fe._z(x, b, mode)
    c = math.sqrt(2 / math.pi)
    if act == "gelu":
        t = torch.tanh(c * (z + 0.044715 * z * z * z))
        dy_dt, dg_dt = (0.5 * z).abs(), (0.5 - z * t * c * (1 + 3 * 0.044715 * z * z)).abs()
    elif act == "tanh":
        dy_dt, dg_dt = torch.ones_like(z), 2 * torch.tanh(z).abs()
    else:
        dy_dt = dg_dt = torch.zeros_like(z)
    del z
    tol = TOL_EPILOGUE
    rel = tol["rtol"] + (tol["bf16_steps"] if x.dtype == torch.bfloat16 else 0.0)
    y_ref = fe.fused_bias_act_reference(x, b, act, axis).float()
    a_y = tol["atol"] + rel * y_ref.abs() + tol["tanh_ulps"] * dy_dt
    del y_ref, dy_dt
    dz = fe.fused_bias_act_bwd_reference(x, b, dy, act, axis)[0].float()  # dz rounded to x's dtype
    tanh_dx = tol["tanh_ulps"] * dy.float().abs() * dg_dt
    a_dx = tol["atol"] + rel * dz.abs() + tanh_dx
    per = tol["rtol"] * dz.abs() + tanh_dx
    a_db = (per.reshape(-1, b.numel()).sum(0) if axis == -1 else
            per.reshape(x.shape[0], b.numel(), -1).sum((0, 2))) + tol["atol"]
    return a_y, a_dx, a_db


def _epilogue_case(shape, axis, dtype, g, kind="normal", offset=0):
    """x, b (fp32 master bias), dy on the card; ``kind="zeros"`` puts z == 0
    exactly at every third element; ``offset`` elements of storage offset
    make the pointers unaligned."""
    import math

    import torch

    n = math.prod(shape)
    x = (2 * torch.randn(n + offset, generator=g, device="cuda")).to(dtype)[offset:].view(shape)
    c = shape[-1] if axis == -1 else shape[1]
    b = torch.randn(c, generator=g, device="cuda")
    if kind == "zeros":
        b = b.to(dtype).float()  # representable in x's dtype, so x = -b gives z == 0
        bb = (b if axis == -1 else b.reshape((1, -1) + (1,) * (len(shape) - 2))).expand(shape)
        third = torch.arange(n, device="cuda").reshape(shape) % 3 == 0
        x = torch.where(third, -bb.to(dtype), x)
    dy = torch.randn(n + offset, generator=g, device="cuda").to(dtype)[offset:].view(shape)
    return x, b, dy


def phase_epilogue_parity():
    """Bias+activation kernels vs their plain versions on the card; returns
    the records of the shapes [4] times (x, b, dy and the largest error)."""
    import torch
    from bigdl_tpu_torch.ops import fused_epilogue as fe

    bf, f32 = torch.bfloat16, torch.float32
    acts = [None, "relu", "gelu", "tanh"]
    # (label, act, shape, axis, dtype, kind, storage offset)
    cases = [(f"{act} {m}", act, shape, axis, dt, "normal", 0)
             for act in acts for dt in (bf, f32)
             for m, shape, axis in (("feature (999, 1000)", (999, 1000), -1),
                                    ("row (8, 24, 37, 41)", (8, 24, 37, 41), 1))]
    # (label, act, shape, axis, dtype, kind, storage offset)
    cases += [
        ("VGG-16 conv0 batch 64", "relu", (64, 64, 224, 224), 1, bf, "normal", 0),
        ("VGG-16 conv3 batch 64 (112x112)", "relu", (64, 128, 112, 112), 1, bf, "normal", 0),
        ("VGG-16 conv6 batch 64 (56x56)", "relu", (64, 256, 56, 56), 1, bf, "normal", 0),
        ("VGG-16 conv14 batch 64 (H*W=196)", "relu", (64, 512, 14, 14), 1, bf, "normal", 0),
        ("VGG-16 fc6 batch 64", "relu", (64, 4096), -1, bf, "normal", 0),
        ("ASPP branch (8, 256, 33, 33)", "relu", (8, 256, 33, 33), 1, bf, "normal", 0),
        ("wide feature (16384, 2048) gelu", "gelu", (16384, 2048), -1, bf, "normal", 0),
        ("ragged feature (37, 200)", "tanh", (37, 200), -1, f32, "normal", 0),
        ("ragged feature H odd (333, 1001)", "gelu", (333, 1001), -1, bf, "normal", 0),
        ("ragged feature H=4098 (2-wide vectors)", "relu", (70, 4098), -1, bf, "normal", 0),
        ("ragged row H*W odd (3, 5, 7, 9)", "gelu", (3, 5, 7, 9), 1, bf, "normal", 0),
        ("row 7x7 maps (16, 512, 7, 7)", "relu", (16, 512, 7, 7), 1, f32, "normal", 0),
        ("unaligned feature (storage offset 1)", "gelu", (257, 512), -1, bf, "normal", 1),
        ("unaligned row (storage offset 1)", "relu", (4, 32, 28, 28), 1, f32, "normal", 1),
        ("relu, z == 0 at every third element", "relu", (31, 520), -1, bf, "zeros", 0),
        ("relu, z == 0 at every third element, row", "relu", (4, 33, 15, 15), 1, f32, "zeros", 0),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    log(f"[3d] bias+activation kernels vs plain versions on the card (|err| <= atol + (rtol "
        f"[+ bf16_steps]) * |ref| + tanh_ulps * |d/dt|; db <= rtol * sum|dz|; {TOL_EPILOGUE}); "
        f"every backward run twice")
    records = {}
    for label, act, shape, axis, dt, kind, offset in cases:
        x, b, dy = _epilogue_case(shape, axis, dt, g, kind, offset)
        y = fe.fused_bias_act_fwd(x, b, act, axis)
        dx, db = fe.fused_bias_act_bwd(x, b, dy, act, axis)
        again = fe.fused_bias_act_bwd(x, b, dy, act, axis)
        torch.cuda.synchronize()
        same = torch.equal(again[0], dx) and torch.equal(again[1], db)
        refs = (fe.fused_bias_act_reference(x, b, act, axis),
                *fe.fused_bias_act_bwd_reference(x, b, dy, act, axis))
        errs, ok = [], same
        for got, ref, allow in zip((y, dx, db), refs, _epilogue_allowances(x, b, dy, act, axis)):
            err = (got.float() - ref.float()).abs()
            ok &= bool((err <= allow).all()) and bool(torch.isfinite(got).all())
            errs.append(err.max().item())
        if kind == "zeros":  # the kernels' rule: y = 0 and dx = 0 where z == 0
            third = torch.arange(x.numel(), device="cuda").reshape(shape) % 3 == 0
            ok &= not bool(y[third].any()) and not bool(dx[third].any())
        log(f"    {label:42s} {str(dt)[6:]:8s} max err y {errs[0]:.3e}  dx {errs[1]:.3e}  "
            f"db {errs[2]:.3e}  repeat bit-identical {same}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_bias_act kernels disagree with their plain versions: "
                                 f"{label}")
        if label.startswith(("VGG-16 conv0", "VGG-16 fc6", "wide feature", "ASPP branch")):
            records[label.split(" batch")[0].split(" (")[0]] = dict(
                x=x, b=b, dy=dy, act=act, axis=axis, err_y=errs[0], err_dx=max(errs[1:]))
        del x, b, dy, y, dx, db, again, refs
    torch.cuda.empty_cache()
    return records


def phase_epilogue_times(recs, card):
    """Kernel, plain-version and eager-chain times of the epilogue at conv0's
    shape (row mode) and (16384, 2048) (feature mode), forward and backward,
    at fc6's shape and at an ASPP branch's (row mode); returns the three
    kernels' records."""
    import torch
    from bigdl_tpu_torch.ops import fused_epilogue as fe

    def chain(x, b, act, axis):
        """The switch-off route: act(x + b rounded to x's dtype), torch ops."""
        bb = b.to(x.dtype) if axis == -1 else b.to(x.dtype).reshape(1, -1, 1, 1)
        return fe.act_reference(act)(x + bb)

    timed = {}
    for key, rec in recs.items():
        x, b, dy, act, axis = (rec[k] for k in ("x", "b", "dy", "act", "axis"))
        y = fe.fused_bias_act_fwd(x, b, act, axis)
        dx = torch.empty_like(x)
        fwd = (cuda_ms(lambda: fe.fused_bias_act_fwd(x, b, act, axis)),
               cuda_ms(lambda: fe.fused_bias_act_reference(x, b, act, axis), iters=5),
               cuda_ms(lambda: chain(x, b, act, axis)), *bound_ms(0.0, (x, y), card))
        xl, bl = x.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True)
        out = chain(xl, bl, act, axis)
        bwd = (cuda_ms(lambda: fe.fused_bias_act_bwd(x, b, dy, act, axis)),
               cuda_ms(lambda: fe.fused_bias_act_bwd_reference(x, b, dy, act, axis), iters=5),
               cuda_ms(lambda: torch.autograd.grad(out, (xl, bl), dy, retain_graph=True)),
               *bound_ms(0.0, (x, dy, dx), card))
        del out, xl, bl, y, dx
        torch.cuda.empty_cache()
        timed[key] = (fwd, bwd)
        shape = f"{tuple(x.shape)} {str(x.dtype)[6:]} {act} {'feature' if axis == -1 else 'row'}"
        for what, (ms, plain, ch, b_ms, by), chained in (
                ("forward", fwd, "act(x + b)"),
                ("backward", bwd, "act(x + b)'s autograd backward")):
            log(f"[4] kernels: fused_bias_act {what} {shape}: kernel_ms {ms:.4f}, plain_ms "
                f"{plain:.4f}, bound_ms {b_ms:.4f} ({by}), chain_ms {ch:.4f} (the switch-off "
                f"route's eager torch chain, {chained}; no single PyTorch call computes it); "
                f"card {card}")

    def entry(name, line, t, err, shape, extra=None):
        ms, plain, ch, b_ms, by = t
        out = {"name": name, "route": "cuda", "source": "bigdl_tpu_torch/csrc/fused_epilogue.cu",
               "replaces": f"bigdl_tpu/ops/fused_epilogue.py:{line}", "launches": None,
               "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
               "library_ms": None, "chain_ms": ch, "shape": shape}
        return {**out, **(extra or {})}

    conv0, wide, aspp_t = timed["VGG-16 conv0"], timed["wide feature"], timed["ASPP branch"]

    def at_aspp(t, err):
        """[14d]'s shape: each ASPP branch's epilogue."""
        return {"ms_aspp": t[0], "plain_ms_aspp": t[1], "bound_ms_aspp": t[3],
                "bound_by_aspp": t[4], "chain_ms_aspp": t[2], "max_abs_err_aspp": err,
                "shape_aspp": "(8, 256, 33, 33) bf16 relu row"}

    return [
        entry("bias_act_fwd", 87, conv0[0], recs["VGG-16 conv0"]["err_y"],
              "(64, 64, 224, 224) bf16 relu row",
              {"ms_feature_16384x2048_gelu": wide[0][0], "bound_ms_feature_16384x2048_gelu":
               wide[0][3], "plain_ms_feature_16384x2048_gelu": wide[0][1],
               "chain_ms_feature_16384x2048_gelu": wide[0][2],
               **at_aspp(aspp_t[0], recs["ASPP branch"]["err_y"])}),
        entry("bias_act_bwd_feature", 92, wide[1], recs["wide feature"]["err_dx"],
              "(16384, 2048) bf16 gelu feature"),
        entry("bias_act_bwd_row", 108, conv0[1], recs["VGG-16 conv0"]["err_dx"],
              "(64, 64, 224, 224) bf16 relu row",
              at_aspp(aspp_t[1], recs["ASPP branch"]["err_dx"])),
    ]


def vgg16_declared(has_dropout: bool, device, class_num: int = 1000):
    """VGG-16 (the JAX package's ``Vgg_16`` layer for layer) with each ReLU
    that follows a conv or a hidden fc declared as that layer's
    ``activation="relu"`` epilogue; the same parameter paths as ``Vgg_16``."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.vgg import _VGG16

    seq, c_in = nn.Sequential(device=device), 3
    for i, v in enumerate(_VGG16):
        if v == "M":
            seq.add(nn.SpatialMaxPooling(2, 2, 2, 2, device=device).set_name(f"pool{i}"))
        else:
            seq.add(nn.SpatialConvolution(c_in, v, 3, 3, 1, 1, 1, 1, activation="relu",
                                          device=device).set_name(f"conv{i}"))
            c_in = v
    seq.add(nn.Reshape([512 * 7 * 7], device=device).set_name("flatten"))
    for fc, n_in in (("fc6", 512 * 7 * 7), ("fc7", 4096)):
        seq.add(nn.Linear(n_in, 4096, activation="relu", device=device).set_name(fc))
        if has_dropout:
            seq.add(nn.Dropout(0.5, device=device).set_name(f"drop{fc[2:]}"))
    seq.add(nn.Linear(4096, class_num, device=device).set_name("fc8"))
    seq.add(nn.LogSoftMax(device=device).set_name("logsoftmax"))
    return seq


# Per VGG-16 iteration: 13 convs (row mode) and fc6, fc7 (feature mode) run
# the epilogue; 5 max pools (2x2/s2) run the max-pool backward.
VGG_PER_ITER = {"bias_act_fwd": 15, "bias_act_bwd_row": 13, "bias_act_bwd_feature": 2,
                "maxpool2d_bwd": 5}


def phase_vgg(card):
    """Train the declared-epilogue VGG-16 through LocalOptimizer with the
    fused-kernel switch on; returns every kernel's launches of that run."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    batch, n_records, iters = 64, 192, 10
    prev = (Engine.compute_dtype(), Engine.activation_dtype(), Engine._fused_kernels)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(True)
    try:
        RandomGenerator.set_seed(SEED)
        t0 = time.perf_counter()
        images = np.random.default_rng(SEED).standard_normal(
            (n_records, 3, 224, 224)).astype(np.float32)
        labels = np.random.default_rng(SEED + 1).integers(0, 1000, n_records)
        model = vgg16_declared(has_dropout=True, device="cuda")
        model.init(sample_input=images[:batch])  # what optimize() would build from
        torch.cuda.reset_peak_memory_stats()
        log(f"[8] VGG-16 (conv/fc ReLUs as fused epilogues, dropout on): "
            f"{model.n_parameters() / 1e6:.3f} M params, {n_records} records of "
            f"{tuple(images.shape[1:])} f32, built in {time.perf_counter() - t0:.1f} s; "
            f"fused-kernel switch on")
        opt = LocalOptimizer(model, DataSet.array(images, labels, batch_size=batch),
                             ClassNLLCriterion())
        opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(iters))
        mem = []  # device memory after each iteration (LocalOptimizer sets the state once per step)
        set_state = model.set_state
        model.set_state = lambda st: (set_state(st), mem.append(_mem()))[0]
        reset_counts()  # the main path starts here
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()  # the main path ends here
        del model.set_state
        eval_counts = _vgg_evaluate(model, images[:batch], labels[:batch])
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        Engine.set_fused_kernels(prev[2])
    hist = opt.history
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3  # iterations 3-10
    log(f"    trained {len(hist)} iterations over epochs {sorted({h['epoch'] for h in hist})} "
        f"in {wall:.2f} s ({wall / iters * 1e3:.2f} ms per iteration, epoch set-up included): "
        f"step {step_ms:.2f} ms (median of iterations 3-{iters}), {batch / step_ms * 1e3:.1f} "
        f"images/s (batch {batch}, bf16 compute and activations); card {card}")
    log("    losses: " + ", ".join(f"{x:.4f}" for x in losses))
    want = {k: VGG_PER_ITER.get(k, 0) * iters for k in counts}
    log(f"    launches: {counts} (expected {want})")
    if len(hist) != iters or not all(np.isfinite(losses)):
        raise AssertionError(f"VGG-16 training: {len(hist)} iterations, losses {losses}")
    if counts != want:
        raise AssertionError(f"VGG-16 training launched {counts}, expected {want}")
    # 100 MiB allowed, as for the flagship: a step's graph held across steps
    # would add GBs of saved activations per iteration.
    drift = mem[iters - 1] - mem[2]
    log(f"    device memory allocated after iteration 3: {mem[2] / 2**20:.1f} MiB, after "
        f"iteration {iters}: {mem[iters - 1] / 2**20:.1f} MiB (drift {drift / 2**20:+.1f} MiB, "
        f"allowed +-100 MiB); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if abs(drift) > 100 * 2 ** 20:
        raise AssertionError("device memory grew over the VGG-16 iterations")
    del opt, model, images
    torch.cuda.empty_cache()
    _vgg_routes()
    return counts, eval_counts


def _vgg_evaluate(model, x, y):
    """``model.evaluate`` of the trained VGG-16 over one batch of 64 with the
    switch on (the eval path: its launches are returned), held against
    ``model.forward`` on the same batch: the same kernel launches (15 of the
    epilogue forward, no backward) and the same Top-1/Top-5 counts."""
    import torch
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy

    methods = [Top1Accuracy(), Top5Accuracy()]
    reset_counts()  # the eval path starts here
    t0 = time.perf_counter()
    res = model.evaluate(DataSet.array(x, y, batch_size=len(x)), methods)
    wall = time.perf_counter() - t0
    counts = read_counts()  # the eval path ends here
    reset_counts()
    with torch.no_grad():
        out = model.forward(x)  # eval mode: evaluate() switched it
    fwd_counts = read_counts()
    ref = {m.name: m(out, y) for m in methods}
    want = {k: VGG_PER_ITER["bias_act_fwd"] if k == "bias_act_fwd" else 0 for k in counts}
    log(f"    model.evaluate over one batch of {len(x)} (switch on): {res} in {wall * 1e3:.1f} ms; "
        f"launches {_nonzero(counts)} (expected {_nonzero(want)}), model.forward on the same "
        f"batch: {ref}, launches {_nonzero(fwd_counts)}")
    if (counts != want or fwd_counts != counts or model.training
            or {k: (r.correct, r.count) for k, r in res.items()}
            != {k: (r.correct, r.count) for k, r in ref.items()}):
        raise AssertionError("VGG-16 evaluate disagrees with its forward or launched other "
                             "kernels than 15 epilogue forwards")
    return counts


# Kernel route (card, f32, TF32 off) vs plain route (CPU, f32) over 3 SGD
# steps of the declared-epilogue VGG-16 from the same weights. VGG has no BN
# state, and the update is held besides the parameters, whose norm the
# barely moving fc6 weights dominate. On an H100 (two runs) the readings
# were: step-1 losses equal, steps 2-3 equal to 5 decimals, parameters
# 1.6e-8 apart relative, the update 4.0e-4; each limit sits 25x or more
# above its reading, so that a fault confined to db or to one layer (which
# moves the update by a tenth or more) fails:
VGG_ROUTE_TOL = {
    "loss_first": 1e-4,  # step 1, same weights: |loss_card - loss_cpu|
    "loss": 1e-3,        # steps 2-3: |loss_card - loss_cpu| / max(1, |loss_cpu|)
    "params": 1e-5,      # ||p_card - p_cpu|| / ||p_cpu||
    "update": 1e-2,      # ||p_card - p_cpu|| / ||p_cpu - p0||
}


def _vgg_routes():
    """3 SGD steps of the f32 declared-epilogue VGG-16 on the card (the
    epilogue and max-pool kernels) vs on the CPU (their plain versions)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    x = rng.standard_normal((4, 3, 224, 224)).astype(np.float32)
    y = rng.integers(0, 1000, 4)
    r = _sgd_routes(lambda device: vgg16_declared(has_dropout=False, device=device), x, y,
                    SEED + 5, fused=True)
    _check_routes("VGG-16 with declared epilogues", x, r, VGG_ROUTE_TOL,
                  {k: VGG_PER_ITER.get(k, 0) * 3 for k in r["launches"][0]})


def _sgd_routes(build, x, y, seed, fused=False, criterion=None, method=None):
    """3 f32 steps (SGD lr 0.01, momentum 0.9, ClassNLL unless ``method()``
    and ``criterion()`` make others; all of ``x`` a batch) of
    ``build(device)`` on the card (TF32 off: full f32) and on the CPU from
    one set of weights (the CPU build's initial ones, drawn after seeding
    with ``seed``), the fused-kernel switch set to ``fused``. Returns both
    routes' losses, launches and seconds, and their distances: step 1's
    loss, steps 2-3's relative loss, the parameters relative to their norm
    and relative to the update."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet, rows_of
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params

    prev = (Engine.compute_dtype(), Engine.activation_dtype(), Engine._fused_kernels,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    Engine.set_fused_kernels(fused)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 on the card is full f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        RandomGenerator.set_seed(seed)
        init = build("cpu")
        init.init(sample_input=x)
        w0 = {k: v.detach().numpy().copy() for k, v in init.named_parameters()}
        del init
        runs = {}
        for device in ("cuda", "cpu"):
            m = build(device)
            m.init(sample_input=x)
            load_jax_params(m, _nest(w0))
            o = LocalOptimizer(m, DataSet.array(x, y, batch_size=rows_of(x)),
                               criterion() if criterion else ClassNLLCriterion())
            o.set_optim_method(method() if method else SGD(learningrate=0.01, momentum=0.9))
            reset_counts()
            t0 = time.perf_counter()
            o.set_end_when(Trigger.max_iteration(3)).optimize()
            runs[device] = ([h["loss"] for h in o.history], _tree_to_numpy(m.get_parameters()),
                            read_counts(), time.perf_counter() - t0)
            del m, o
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        Engine.set_fused_kernels(prev[2])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[3:]
    (lc, pc, kc, tc), (lp, pp, kp, tp) = runs["cuda"], runs["cpu"]

    def dist(a, b):
        return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b)))

    return {"losses": (lc, lp), "launches": (kc, kp), "seconds": (tc, tp),
            "loss_first": abs(lc[0] - lp[0]),
            "loss": max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lc[1:], lp[1:])),
            "params": dist(pc, pp) / dist(pp, {k: np.zeros_like(v) for k, v in pp.items()}),
            "update": dist(pc, pp) / dist(pp, w0)}


def _check_routes(label, x, r, tol, want_card, recipe="SGD lr 0.01 momentum 0.9"):
    """Log ``_sgd_routes``' readings against ``tol``; fail beyond any limit,
    on launches other than ``want_card`` on the card, or any on the CPU."""
    from bigdl_tpu_torch.dataset import rows_of

    (lc, lp), (kc, kp), (tc, tp) = r["losses"], r["launches"], r["seconds"]
    log(f"    kernel route (card, f32, TF32 off) vs plain route (CPU, f32), {label}, "
        f"{rows_of(x)} x {_describe(x)}, 3 steps of {recipe}: losses "
        f"{[round(v, 6) for v in lc]} vs {[round(v, 6) for v in lp]}; step 1 diff "
        f"{r['loss_first']:.2e} (tol {tol['loss_first']}), steps 2-3 rel diff {r['loss']:.2e} "
        f"(tol {tol['loss']}); params rel diff {r['params']:.2e} (tol {tol['params']}); "
        f"update rel diff {r['update']:.2e} (tol {tol['update']}); launches card "
        f"{_nonzero(kc)}, CPU {sum(kp.values())}; {tc:.1f} s card, {tp:.1f} s CPU")
    if (len(lc) != 3 or kc != want_card or any(kp.values())
            or any(r[k] > tol[k] for k in ("loss_first", "loss", "params", "update"))):
        raise AssertionError(f"the kernel route's {label} training disagrees with the plain "
                             "route")


# Tolerances of the norm kernels against their plain versions, per element
# of y and dx and per entry of dw and db (fixed before the first run, from
# the dtype and H; the same allowances as tests/test_torch_fused_norm.py):
# atol + rtol * the magnitude of the terms that make up the value: fp32
#   arithmetic in another order (row sums of up to 8192 values, column sums
#   of up to 16384 rows);
# mean_noise * sqrt(H) * max|x| of the row, times r: two fp32 sums of a
#   LayerNorm row's H values in other orders differ by about that much (four
#   standard deviations of their rounding noise), which moves x_hat, and
#   through it y (|w| * d_xhat), dx (r * d_xhat * (|m2| + |x_hat| * mean|g|))
#   and dw (sum |dy| * d_xhat). It matters where |mean| >> std (mean 1e3,
#   std 1e-2) and for constant rows;
# bf16_steps * |ref| for a bf16 output (RMSNorm's y, a bf16 x's dx): both
#   round an fp32 value once, so they may land one bf16 step apart.
TOL_NORM = {"atol": 1e-6, "rtol": 1e-5, "mean_noise": 4 * 2.0 ** -24, "bf16_steps": 2.0 ** -7}
NORM_EPS = {"ln": 1e-5, "rms": 1e-6}


def _norm_allowances(kind, x, w, b, dy):
    """Allowances of y, dx, dw (and db for LayerNorm), float64 on the card."""
    import torch

    tol, h = TOL_NORM, x.shape[-1]
    x2, d2, w, b = (t.reshape(-1, h).double() for t in (x, dy, w, b))
    step = tol["bf16_steps"] if x.dtype == torch.bfloat16 else 0.0
    at, rt = tol["atol"], tol["rtol"]
    if kind == "ln":
        xc = x2 - x2.mean(-1, keepdim=True)
        r = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + NORM_EPS["ln"])
        xh = xc * r
        del xc
        dxh = tol["mean_noise"] * h ** 0.5 * x2.abs().amax(-1, keepdim=True) * r
        g = d2 * w
        m1 = g.mean(-1, keepdim=True)
        m2 = (g * xh).mean(-1, keepdim=True)
        a_y = at + rt * ((xh * w).abs() + b.abs()) + w.abs() * dxh
        dx = r * (g - m1 - xh * m2)
        a_dx = (at + rt * r * (g.abs() + m1.abs() + (xh * m2).abs()) + step * dx.abs()
                + r * dxh * (m2.abs() + xh.abs() * g.abs().mean(-1, keepdim=True)))
        del dx, g
        a_dw = at + (rt * (d2 * xh).abs() + d2.abs() * dxh).sum(0)
        a_db = at + rt * d2.abs().sum(0)
        return [a_y.reshape(x.shape), a_dx.reshape(x.shape), a_dw, a_db]
    r = torch.rsqrt((x2 * x2).mean(-1, keepdim=True) + NORM_EPS["rms"])
    a_y = at + (rt + step) * (x2 * r * w).abs()
    g = d2 * w
    dot = (g * x2).abs().sum(-1, keepdim=True)
    dx = r * g - x2 * r ** 3 * (g * x2).sum(-1, keepdim=True) / h
    a_dx = at + rt * r * (g.abs() + x2.abs() * r * r * dot / h) + step * dx.abs()
    a_dw = at + rt * (d2 * x2 * r).abs().sum(0)
    return [a_y.reshape(x.shape), a_dx.reshape(x.shape), a_dw]


def _norm_case(kind, shape, dtype, data, offset, g):
    """x, w, b (fp32 masters), dy on the card; ``offset`` elements of storage
    offset make the pointers unaligned."""
    import math

    import torch

    n, h = math.prod(shape), shape[-1]
    x = torch.randn(n + offset, generator=g, device="cuda")
    if data == "offset":
        x = 1e3 + 1e-2 * x
    elif data == "constant":  # each row one value; the first row zeros
        x = torch.randn(n // h + 1, 1, generator=g, device="cuda").expand(-1, h).reshape(-1)
        x = x[: n + offset].clone()
        x[offset: offset + h] = 0.0
    else:
        x = 0.5 + 2 * x
    x = x.to(dtype)[offset:].view(shape)
    w = 1 + 0.1 * torch.randn(h, generator=g, device="cuda")
    b = 0.1 * torch.randn(h, generator=g, device="cuda")
    dy_dtype = dtype if kind == "rms" else torch.float32  # LayerNorm's y, so its dy, is fp32
    dy = torch.randn(n + offset, generator=g, device="cuda").to(dy_dtype)[offset:].view(shape)
    return x, w, b, dy


def phase_norm_parity():
    """LayerNorm and RMSNorm kernels vs their plain versions on the card;
    returns the records of the shapes [4] times."""
    import torch
    from bigdl_tpu_torch.ops import fused_norm as fn

    bf, f32 = torch.bfloat16, torch.float32
    # (label, shape, dtype, data kind, storage offset); the first two are timed in [4]
    shapes = [
        ("main path (8, 2048, 512)", (8, 2048, 512), f32, "normal", 0),
        ("wide (16384, 4096)", (16384, 4096), bf, "normal", 0),
        ("main path, bf16 x", (8, 2048, 512), bf, "normal", 0),
        ("mean 1e3, std 1e-2", (4096, 512), f32, "offset", 0),
        ("constant rows, row 0 zeros", (1000, 512), f32, "constant", 0),
        ("constant rows, bf16", (1000, 512), bf, "constant", 0),
        ("H=97 (no vector width)", (3001, 97), f32, "normal", 0),
        ("H=1000", (2000, 1000), bf, "normal", 0),
        ("H=1024 (warp, 32 a lane)", (999, 1024), f32, "normal", 0),
        ("H=2000 (block)", (777, 2000), bf, "normal", 0),
        ("H=8192 (block, 32 a thread)", (300, 8192), f32, "normal", 0),
        ("16385 rows (ragged last tile)", (16385, 512), f32, "normal", 0),
        ("unaligned (storage offset 1)", (1001, 512), bf, "normal", 1),
        ("unaligned f32, 3-D", (3, 333, 256), f32, "normal", 1),
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    log(f"[3e] LayerNorm and RMSNorm kernels vs plain versions on the card (|err| <= atol + "
        f"rtol * |terms| + mean_noise * sqrt(H) * max|x_row| * r terms [LayerNorm] + "
        f"bf16_steps * |ref| [bf16 outputs]; {TOL_NORM}); every backward run twice")
    records = {}
    for kind in ("ln", "rms"):
        fwd, bwd = ((fn.layer_norm_fwd, fn.layer_norm_bwd) if kind == "ln"
                    else (fn.rms_norm_fwd, fn.rms_norm_bwd))
        ref_f, ref_b = ((fn.layer_norm_reference, fn.layer_norm_bwd_reference) if kind == "ln"
                        else (fn.rms_norm_reference, fn.rms_norm_bwd_reference))
        for label, shape, dt, data, offset in shapes:
            if data == "offset" and kind == "rms":
                continue  # RMSNorm does not centre: no cancellation to probe
            x, w, b, dy = _norm_case(kind, shape, dt, data, offset, g)
            fargs = (x, w, b) if kind == "ln" else (x, w)
            eps = NORM_EPS[kind]
            got = [fwd(*fargs, eps), *bwd(x, w, dy, eps)]
            again = bwd(x, w, dy, eps)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(again, got[1:]))
            refs = [ref_f(*fargs, eps), *ref_b(x, w, dy, eps)]
            errs, ok = [], same
            for out, ref, allow in zip(got, refs, _norm_allowances(kind, x, w, b, dy)):
                err = (out.double() - ref.double()).abs()
                ok &= (out.dtype == ref.dtype and bool((err <= allow).all())
                       and bool(torch.isfinite(out).all()))
                errs.append(err.max().item())
                del err, allow
            names = ("y", "dx", "dw", "db") if kind == "ln" else ("y", "dx", "dw")
            log(f"    {kind:3s} {label:32s} {str(dt)[6:]:8s} max err "
                + "  ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
                + f"  repeat bit-identical {same}  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kind} norm kernels disagree with their plain versions: "
                                     f"{label}")
            if label.startswith(("main path (", "wide")):
                records[(kind, label.split(" (")[0])] = dict(
                    x=x, w=w, b=b, dy=dy, err_fwd=errs[0], err_bwd=max(errs[1:]))
            del x, w, b, dy, got, again, refs
        torch.cuda.empty_cache()
    return records


def phase_norm_times(recs, card):
    """Kernel (through its C entry point, so the wrappers' counts stay the
    main paths'), wrapper, plain-version and library times of the four norm
    kernels at the main path's (8, 2048, 512) f32 and at (16384, 4096) bf16;
    returns the four kernels' records."""
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import fused_norm as fn

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def run(rc):
        if rc != 0:
            raise RuntimeError(f"norm kernel launch failed with CUDA error {rc}")

    out = {}
    for (kind, which), rec in sorted(recs.items()):
        x, w, b, dy = rec["x"], rec["w"], rec["b"], rec["dy"]
        eps, h = NORM_EPS[kind], x.shape[-1]
        rows, code = x.numel() // h, 1 if x.dtype == torch.bfloat16 else 0
        tile = fn.norm_row_tile(rows)
        n_tiles = -(-rows // tile)
        dx = torch.empty_like(x)
        f32 = dict(dtype=torch.float32, device="cuda")
        if kind == "ln":
            y = torch.empty(x.shape, **f32)
            partial, dwdb = torch.empty((n_tiles, 2 * h), **f32), torch.empty((2 * h,), **f32)
            k_fwd = lambda: run(lib.bigdl_layer_norm_fwd(  # noqa: E731
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), code, rows, h, eps,
                stream))
            k_bwd = lambda: run(lib.bigdl_layer_norm_bwd(  # noqa: E731
                x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                dwdb.data_ptr(), code, rows, h, tile, eps, stream))
            w_fwd, w_bwd = (lambda: fn.layer_norm_fwd(x, w, b, eps),
                            lambda: fn.layer_norm_bwd(x, w, dy, eps))
            p_fwd, p_bwd = (lambda: fn.layer_norm_reference(x, w, b, eps),
                            lambda: fn.layer_norm_bwd_reference(x, w, dy, eps))
            io_fwd, io_bwd = (x, w, b, y), (x, w, dy, dx, dwdb)
            flops = (7, 16)  # per element: centre, square, sums, scale, shift / the backward's
            lib_f = lambda t, wl, bl: F.layer_norm(t, (h,), wl, bl, eps)  # noqa: E731
        else:
            y = torch.empty_like(x)
            partial, dws = torch.empty((n_tiles, h), **f32), torch.empty((h,), **f32)
            k_fwd = lambda: run(lib.bigdl_rms_norm_fwd(  # noqa: E731
                x.data_ptr(), w.data_ptr(), y.data_ptr(), code, rows, h, eps, stream))
            k_bwd = lambda: run(lib.bigdl_rms_norm_bwd(  # noqa: E731
                x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                dws.data_ptr(), code, rows, h, tile, eps, stream))
            w_fwd, w_bwd = (lambda: fn.rms_norm_fwd(x, w, eps),
                            lambda: fn.rms_norm_bwd(x, w, dy, eps))
            p_fwd, p_bwd = (lambda: fn.rms_norm_reference(x, w, eps),
                            lambda: fn.rms_norm_bwd_reference(x, w, dy, eps))
            io_fwd, io_bwd = (x, w, y), (x, w, dy, dx, dws)
            flops = (4, 10)
            lib_f = lambda t, wl, bl: F.rms_norm(t, (h,), wl, eps)  # noqa: E731
        t = {"fwd": [cuda_ms(k_fwd, iters=50), cuda_ms(w_fwd, iters=50),
                     cuda_ms(p_fwd, iters=5)],
             "bwd": [cuda_ms(k_bwd, iters=50), cuda_ms(w_bwd, iters=50),
                     cuda_ms(p_bwd, iters=5)]}
        t["fwd"] += bound_ms(flops[0] * x.numel(), io_fwd, card, torch.float32)
        t["bwd"] += bound_ms(flops[1] * x.numel(), io_bwd, card, torch.float32)
        # the library computes this function only for fp32 x; for a bf16 x its
        # nearest call takes bf16 weights and returns a bf16 y (a yardstick)
        wl, bl = (w, b) if x.dtype == torch.float32 else (w.to(x.dtype), b.to(x.dtype))
        lib_fwd = cuda_ms(lambda: lib_f(x, wl, bl), iters=50)
        leaves = [a.detach().clone().requires_grad_(True) for a in (x, wl, bl)]
        lo = lib_f(*leaves)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lo, leaves[:2] if kind == "rms" else leaves, dy.to(lo.dtype), retain_graph=True),
            iters=50)
        del lo, leaves, wl, bl
        t["fwd"].append(lib_fwd)
        t["bwd"].append(lib_bwd)
        if kind == "rms" and x.dtype == torch.float32:  # is the kernel slower than F.rms_norm?
            turns = [(cuda_ms(k_fwd, iters=200), cuda_ms(lambda: lib_f(x, w, b), iters=200))
                     for _ in range(3)]
            k_min, l_min = min(k for k, _ in turns), min(v for _, v in turns)
            log(f"    rms_norm_fwd {tuple(x.shape)} vs F.rms_norm in turns (ms): "
                + ", ".join(f"{k:.4f} / {v:.4f}" for k, v in turns)
                + f"; least {k_min:.4f} / {l_min:.4f}: the kernel is "
                + (f"slower by {k_min / l_min:.3f}x" if k_min > l_min
                   else f"not slower ({k_min / l_min:.3f}x)"))
        name = {"ln": "layer_norm", "rms": "rms_norm"}[kind]
        shape = f"{tuple(x.shape)} {str(x.dtype)[6:]}"
        for what in ("fwd", "bwd"):
            ms, wrapper, plain, b_ms, by, lib_ms = t[what]
            libtxt = (f"{lib_ms:.4f} (torch {'F.layer_norm' if kind == 'ln' else 'F.rms_norm'}"
                      f"{'' if what == 'fwd' else ' autograd backward'}, yardstick only"
                      + ("" if x.dtype == torch.float32 else "; bf16 weights, a bf16 y: no "
                         "PyTorch call takes a bf16 x with fp32 weights and statistics")
                      + ")")
            log(f"[4] kernels: {name}_{what} {shape}: verdict ok, kernel_ms {ms:.4f}, "
                f"wrapper_ms {wrapper:.4f}, plain_ms {plain:.4f}, bound_ms {b_ms:.4f} ({by}), "
                f"library_ms {libtxt}; card {card}")
        out[(kind, which)] = (t, rec, shape)
        del x, w, b, dy, dx, y, partial, rec
        torch.cuda.empty_cache()

    kernels = []
    for kind, name, lines in (("ln", "layer_norm", (45, 55)), ("rms", "rms_norm", (177, 184))):
        main, wide = out[(kind, "main path")], out[(kind, "wide")]
        for what, line in zip(("fwd", "bwd"), lines):
            ms, wrapper, plain, b_ms, by, lib_ms = main[0][what]
            kernels.append({
                "name": f"{name}_{what}", "route": "cuda",
                "source": "bigdl_tpu_torch/csrc/fused_norm.cu",
                "replaces": f"bigdl_tpu/ops/fused_norm.py:{line}",
                "launches": None,  # filled from the main paths' runs
                "max_abs_err": main[1]["err_fwd" if what == "fwd" else "err_bwd"],
                "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": by,
                "library_ms": lib_ms, "wrapper_ms": wrapper, "shape": main[2],
                "ms_wide": wide[0][what][0], "plain_ms_wide": wide[0][what][2],
                "bound_ms_wide": wide[0][what][3], "library_ms_wide": wide[0][what][5],
                "shape_wide": wide[2]})
    return kernels


def norm_lm(variant: str, vocab: int, hidden: int, stages: int, device, wrap=None):
    """The pipeline example's pre-norm block-stack LM (``examples/pipeline/
    train.py``) on its sequential path: ``variant`` "ln" builds it with
    ``LayerNormalization`` as the example does, "rms" with ``RMSNorm`` in each
    of those places; ``wrap`` (a callable) wraps the stage, as [19c] wraps it
    in ``nn.Remat``."""
    from bigdl_tpu_torch import nn

    def norm():
        return (nn.LayerNormalization(hidden, device=device) if variant == "ln"
                else nn.RMSNorm(hidden, device=device))

    inp = nn.Input()
    ln = norm().inputs(inp)
    ffn = nn.FeedForwardNetwork(hidden, filter_size=4 * hidden, device=device).inputs(ln)
    add = nn.CAddTable(device=device).inputs(inp, ffn)
    stage = nn.Graph(inp, add, device=device)
    return nn.Sequential(nn.LookupTable(vocab, hidden, device=device),
                         nn.PipelinedBlocks(stage if wrap is None else wrap(stage), stages,
                                            device=device),
                         norm(), nn.Linear(hidden, vocab, device=device), device=device)


NORM_LM = {"vocab": 8192, "hidden": 512, "stages": 6, "seq": 2048, "batch": 8, "n_seq": 24,
           "iters": 10}


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


def _nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def phase_norm_lm(card):
    """Train norm-LM/LN and norm-LM/RMS through LocalOptimizer with the
    fused-kernel switch on, each with an eval-mode probe forward; returns
    every kernel's launches of that run."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    c = NORM_LM
    vocab, seq, batch, iters = c["vocab"], c["seq"], c["batch"], c["iters"]
    ids = planted_bigram_ids(c["n_seq"] * seq + 1, vocab, seed=SEED)
    x, y = ids[:-1].reshape(c["n_seq"], seq), ids[1:].reshape(c["n_seq"], seq)
    probe = np.arange(2, vocab, dtype=np.int32)[None, :]  # every token once
    n_norms = c["stages"] + 1
    prev = (Engine.compute_dtype(), Engine.activation_dtype(), Engine._fused_kernels)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(True)
    try:
        models, t0 = {}, time.perf_counter()
        for variant in ("ln", "rms"):
            RandomGenerator.set_seed(SEED)
            models[variant] = norm_lm(variant, vocab, c["hidden"], c["stages"], device="cuda")
            models[variant].init(sample_input=x[:batch])  # what optimize() would build from
        log(f"[9] norm-LM/LN and norm-LM/RMS: {models['ln'].n_parameters():,} and "
            f"{models['rms'].n_parameters():,} params, {c['n_seq']} sequences of {seq} "
            f"planted-bigram tokens, both built in {time.perf_counter() - t0:.1f} s; "
            "fused-kernel switch on")
        reset_counts()  # the main path starts here
        for variant in ("ln", "rms"):
            kname = {"ln": "layer_norm", "rms": "rms_norm"}[variant]
            model = models.pop(variant)
            torch.cuda.reset_peak_memory_stats()
            log(f"[9] norm-LM/{variant.upper()} ({model.n_parameters():,} params):")
            opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch),
                                 TimeDistributedCriterion(CrossEntropyCriterion(),
                                                          size_average=True))
            opt.set_optim_method(Adam(learningrate=3e-3))
            opt.set_end_when(Trigger.max_iteration(iters))
            mem = []  # device memory after each iteration (the state is set once per step)
            set_state = model.set_state
            model.set_state = lambda st: (set_state(st),
                                          mem.append(_mem()))[0]
            before = read_counts()
            t0 = time.perf_counter()
            opt.optimize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            trained = _diff(read_counts(), before)
            del model.set_state
            hist = opt.history
            losses = [h["loss"] for h in hist]
            step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3  # iterations 3-10
            log(f"    trained {len(hist)} iterations over epochs "
                f"{sorted({h['epoch'] for h in hist})} in {wall:.2f} s ({wall / iters * 1e3:.2f} "
                f"ms per iteration, epoch set-up included): step {step_ms:.2f} ms (median of "
                f"iterations 3-{iters}), {batch * seq / step_ms * 1e3:.0f} tokens/s (batch "
                f"{batch} x {seq}, bf16 compute and activations); card {card}")
            log("    losses: " + ", ".join(f"{v:.4f}" for v in losses)
                + f" (ln {vocab} = {np.log(vocab):.2f})")
            want = {k: (n_norms * iters if k in (f"{kname}_fwd", f"{kname}_bwd") else 0)
                    for k in trained}
            log(f"    launches: {_nonzero(trained)} (expected {_nonzero(want)}, nothing else)")
            if (len(hist) != iters or not all(np.isfinite(losses))
                    or not losses[-1] < losses[0]):
                raise AssertionError(f"norm-LM/{variant}: {len(hist)} iterations, losses {losses}")
            if trained != want:
                raise AssertionError(f"norm-LM/{variant} training launched {trained}, "
                                     f"expected {want}")
            # 100 MiB allowed, as for the other paths: a step's graph held
            # across steps would add GBs of saved activations per iteration.
            drift = mem[iters - 1] - mem[2]
            log(f"    device memory allocated after iteration 3: {mem[2] / 2**20:.1f} MiB, "
                f"after iteration {iters}: {mem[iters - 1] / 2**20:.1f} MiB (drift "
                f"{drift / 2**20:+.1f} MiB, allowed +-100 MiB); peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if abs(drift) > 100 * 2 ** 20:
                raise AssertionError(f"device memory grew over the norm-LM/{variant} iterations")
            model.eval()
            before = read_counts()
            with torch.no_grad():
                logits = model.forward(probe)
            torch.cuda.synchronize()
            probed = _diff(read_counts(), before)
            pred = logits.float().argmax(-1)[0].cpu().numpy()
            hit = float((pred == (3 * probe[0] + 1) % (vocab - 2) + 2).mean())
            want = {k: (n_norms if k == f"{kname}_fwd" else 0) for k in probed}
            log(f"    eval probe forward (1, {probe.shape[1]}): logits {tuple(logits.shape)} "
                f"{str(logits.dtype)[6:]}, finite {bool(torch.isfinite(logits).all())}, "
                f"bigram-map recovery {hit:.4f}; launches {_nonzero(probed)} (expected "
                f"{_nonzero(want)}, nothing else)")
            if probed != want or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"norm-LM/{variant} probe launched {probed} or gave "
                                     "non-finite logits")
            del opt, model, logits
            torch.cuda.empty_cache()
        counts = read_counts()  # the main path ends here
        per_iter = (c["stages"] + 1) * iters
        want = {k: {"layer_norm_fwd": per_iter + n_norms, "layer_norm_bwd": per_iter,
                    "rms_norm_fwd": per_iter + n_norms, "rms_norm_bwd": per_iter}.get(k, 0)
                for k in counts}
        log(f"    norm-LM path launches: {_nonzero(counts)} (expected {_nonzero(want)}, "
            "nothing else)")
        if counts != want:
            raise AssertionError(f"the norm-LM path launched {counts}, expected {want}")
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        Engine.set_fused_kernels(prev[2])
    for variant in ("ln", "rms"):
        _norm_lm_routes(variant)
    return counts


# Kernel route (card, f32, TF32 off) vs plain route (CPU, f32) over 3 Adam
# steps of a 2-stage norm-LM (V 8192, H 512, batch 2, T 128) from the same
# weights: the same f32 function with sums in other orders. Adam steps every
# weight by about lr whatever its gradient's size, so a weight whose
# gradient is near zero may step the other way: that moves the update far
# more than the losses. Limits first fixed before any run (step 1 1e-4,
# steps 2-3 1e-3, parameters 1e-5, update 1e-2); on an H100 the readings
# were (LN / RMS): step 1 0 / 9.5e-7, steps 2-3 3.2e-7 / 1.1e-6, parameters
# 4.0e-7 / 5.0e-6, update 4.4e-5 / 5.4e-4. Each limit now sits 25x or more
# above the larger reading (the step-1 limit stays as fixed, 100x), so a
# fault confined to dw, db or one stage (which moves the update by a tenth
# or more) still fails:
NORM_ROUTE_TOL = {
    "loss_first": 1e-4,  # step 1, same weights: |loss_card - loss_cpu|
    "loss": 5e-5,        # steps 2-3: |loss_card - loss_cpu| / max(1, |loss_cpu|)
    "params": 1.5e-4,    # ||p_card - p_cpu|| / ||p_cpu||
    "update": 2e-2,      # ||p_card - p_cpu|| / ||p_cpu - p0||
}


def _norm_lm_routes(variant):
    """3 Adam steps of an f32 norm-LM on the card (the norm kernels) vs on
    the CPU (their plain versions), from one set of weights."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params

    vocab, hidden, stages, seq, batch = 8192, 512, 2, 128, 2
    prev = (Engine.compute_dtype(), Engine.activation_dtype(), Engine._fused_kernels,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    Engine.set_fused_kernels(True)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 on the card is full f32
    torch.backends.cudnn.allow_tf32 = False
    kname = {"ln": "layer_norm", "rms": "rms_norm"}[variant]
    try:
        ids = planted_bigram_ids(batch * seq + 1, vocab, seed=SEED + 7)
        x, y = ids[:-1].reshape(batch, seq), ids[1:].reshape(batch, seq)
        RandomGenerator.set_seed(SEED + 7)
        init = norm_lm(variant, vocab, hidden, stages, device="cpu")
        init.init(sample_input=x)
        w0 = {k: v.detach().numpy().copy() for k, v in init.named_parameters()}
        del init
        runs = {}
        for device in ("cuda", "cpu"):
            m = norm_lm(variant, vocab, hidden, stages, device=device)
            m.init(sample_input=x)
            load_jax_params(m, _nest(w0))
            o = LocalOptimizer(m, DataSet.array(x, y, batch_size=batch),
                               TimeDistributedCriterion(CrossEntropyCriterion(),
                                                        size_average=True))
            o.set_optim_method(Adam(learningrate=3e-3))
            reset_counts()
            t0 = time.perf_counter()
            o.set_end_when(Trigger.max_iteration(3)).optimize()
            runs[device] = ([h["loss"] for h in o.history], _tree_to_numpy(m.get_parameters()),
                            read_counts(), time.perf_counter() - t0)
            del m, o
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        Engine.set_fused_kernels(prev[2])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[3:]
    (lc, pc, kc, tc), (lp, pp, kp, tp) = runs["cuda"], runs["cpu"]

    def dist(a, b):
        return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b)))

    d_first = abs(lc[0] - lp[0])
    d_loss = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lc[1:], lp[1:]))
    d_params = dist(pc, pp) / dist(pp, {k: np.zeros_like(v) for k, v in pp.items()})
    d_update = dist(pc, pp) / dist(pp, w0)
    want_card = {k: ((stages + 1) * 3 if k in (f"{kname}_fwd", f"{kname}_bwd") else 0)
                 for k in kc}
    tol = NORM_ROUTE_TOL
    log(f"    kernel route (card, f32, TF32 off) vs plain route (CPU, f32), norm-LM/"
        f"{variant.upper()} at V {vocab}, H {hidden}, S {stages}, batch {batch}, T {seq}, 3 "
        f"steps of Adam lr 3e-3: losses {[round(v, 6) for v in lc]} vs "
        f"{[round(v, 6) for v in lp]}; step 1 diff {d_first:.2e} (tol {tol['loss_first']}), "
        f"steps 2-3 rel diff {d_loss:.2e} (tol {tol['loss']}); params rel diff "
        f"{d_params:.2e} (tol {tol['params']}); update rel diff {d_update:.2e} (tol "
        f"{tol['update']}); launches card {_nonzero(kc)}, CPU {sum(kp.values())}; {tc:.1f} s card, "
        f"{tp:.1f} s CPU")
    if (len(lc) != 3 or kc != want_card or any(kp.values()) or d_first > tol["loss_first"]
            or d_loss > tol["loss"] or d_params > tol["params"] or d_update > tol["update"]):
        raise AssertionError(f"the kernel route's norm-LM/{variant} training disagrees with "
                             "the plain route")


# [11] BASELINE's five parity configs (``models.parity_config``, the recipe
# of bench.py::_measure_one_config): max-pool backward launches a step.
# LeNet-5 has two 2x2/s2 pools; VGG-for-CIFAR-10 five; Inception-v1 four
# ceil-mode 3x3/s2 pools and nine 3x3/s1/p1 branch pools; the BiLSTM and
# Wide&Deep none (Wide&Deep's sparse product is torch's gather and
# index_add_, as the JAX package's is segment_sum, no Pallas kernel). No
# other kernel runs on these paths (the fused-kernel switch stays off).
PARITY_CONFIGS = ("lenet", "vgg", "inception", "bilstm", "widedeep")
PARITY_POOLS_PER_ITER = {"lenet": 2, "vgg": 5, "inception": 13, "bilstm": 0, "widedeep": 0}
# Kernel route (card, f32, TF32 off) vs plain route (CPU, f32) over 3 SGD
# steps (lr 0.01, momentum 0.9) from one numpy-made set of weights, at small
# batches: LeNet-5 at 16, Inception-v1 at 2 of 224x224 with dropout off, the
# BiLSTM at 4 with T 200 and its full widths. Fixed before the first run,
# from the VGG-16 route's limits and readings (VGG_ROUTE_TOL: losses and
# parameters within 1e-8 to 4e-4 of each other) and each network's kind:
# LeNet-5 (tanh) and the BiLSTM (sigmoid and tanh, a contracting recurrence
# of 200 steps whose loss reads the last) are smooth, so fp32 sums in
# another order are all that part the routes, and VGG-16's limits hold
# them 25x or more above such differences. On an H100 (two runs) the
# readings were: losses 0 to 2.4e-7 apart, parameters 1.4e-11 to 8.6e-8,
# the update 2.8e-6 (BiLSTM), 7.4e-5 to 9.0e-5 (LeNet-5) and 2.3e-4 to
# 2.4e-4 (Inception-v1, a ReLU network like VGG-16 whose gates may open on
# one side only). Inception-v1's update limit, 5e-3, is about 20x its
# readings (LeNet-5's is 100x); the others keep VGG-16's.
# Wide&Deep (batch 256 of its synthetic log, at its widths): a gather, a
# scatter-add and a small ReLU MLP; fixed before its first run at VGG-16's
# limits (the same f32 sums in another order; its card route's index_add_
# sums with atomics, so its bits may differ from run to run: no repeat is
# held to the bit). VGG-for-CIFAR-10 (batch 16, dropout off): fixed before
# its first run, from the port against the JAX package on the CPU (two f32
# implementations, tests/test_torch_vgg.py): sixteen conv/BN layers leave
# the activations ~3e-5 apart at the deep pools, where a 2x2 window whose
# two largest values lie that close routes its dy to another cell in each
# route, moving every gradient below it by ~5e-3 relative L2; over four
# seeds at batch 16 those runs read step-1 losses within 3.4e-6, steps 2-3
# within 1.5e-3 relative, parameters within 3.5e-4 relative and updates
# 0.048-0.114 apart. So 1e-4 at step 1 (as all), 1e-2, 2e-3 and 0.3, each
# about 2-7x those readings and still under the 0.5 or more that a wrong
# gradient or update rule moves the update by.
PARITY_ROUTE_TOL = {
    name: {"loss_first": 1e-4,  # step 1, same weights: |loss_card - loss_cpu|
           "loss": 1e-2 if name == "vgg" else 1e-3,  # steps 2-3, / max(1, |loss_cpu|)
           "params": 2e-3 if name == "vgg" else 1e-5,  # ||p_card - p_cpu|| / ||p_cpu||
           "update": {"inception": 5e-3, "vgg": 0.3}.get(name, 1e-2)}  # / ||p_cpu - p0||
    for name in PARITY_CONFIGS}
PARITY_ROUTE_BATCH = {"lenet": 16, "vgg": 16, "inception": 2, "bilstm": 4, "widedeep": 256}


def _describe(x) -> str:
    """A batch's shape and dtype after its rows; a Table's entries, each so."""
    from bigdl_tpu_torch.tensor import SparseTensor
    from bigdl_tpu_torch.utils.table import Table

    if isinstance(x, Table):
        return "Table(" + ", ".join(_describe(v) for v in x) + ")"
    if isinstance(x, SparseTensor):
        return f"SparseTensor({x.shape[1]} wide, {x.nnz} entries, {x.values.dtype})"
    return f"{tuple(x.shape[1:])} {x.dtype}"


def phase_parity_configs(card):
    """[11] Train LeNet-5, VGG-for-CIFAR-10, Inception-v1, the BiLSTM
    classifier and Wide&Deep through LocalOptimizer, then hold each one's
    card route against its CPU route; returns each config's kernel launches
    of its training run. The route checks come after all five runs: the
    BiLSTM's host-bound step read
    12% slower right after a route check (medians of four interleaved runs,
    tools/torch_host_step_spread.py on an H100), inside its run-to-run
    spread but in every call that tried it."""
    by_config = {name: _train_parity_config(name, card)[0] for name in PARITY_CONFIGS}
    for name in PARITY_CONFIGS:
        _parity_config_routes(name)
    return by_config


def _train_parity_config(name, card):
    """10 iterations of one parity config at its bench batch, bf16 compute
    and activations, ClassNLL, SGD lr 0.01 momentum 0.9 (its one batch
    every iteration, as the bench feeds it). Returns the kernel launches, the
    step's median ms and the CPU time of the main thread and of the process
    (all threads) over the run's wall."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import parity_config
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    iters = 10
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    RandomGenerator.set_seed(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, x, y, batch = parity_config(name, device="cuda")
    model.init(sample_input=x)  # what optimize() would build from
    log(f"[11] {name}: {model.n_parameters() / 1e6:.3f} M params, batch {batch} of "
        f"{_describe(x)}, built in {time.perf_counter() - t0:.1f} s")
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(iters))
    mem = []  # device memory after each iteration (LocalOptimizer sets the state once per step)
    set_state = model.set_state
    model.set_state = lambda st: (set_state(st), mem.append(_mem()))[0]
    reset_counts()  # the main path starts here
    t0, cpu0 = time.perf_counter(), (time.thread_time(), time.process_time())
    opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu = [(now - then) / wall for now, then in zip((time.thread_time(), time.process_time()),
                                                      cpu0)]
    counts = read_counts()  # the main path ends here
    del model.set_state
    hist = opt.history
    losses = [h["loss"] for h in hist]
    step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3  # iterations 3-10
    launches, want = counts["maxpool2d_bwd"], PARITY_POOLS_PER_ITER[name] * iters
    others = sum(counts.values()) - launches
    log(f"    trained {len(hist)} iterations in {wall:.2f} s: step {step_ms:.2f} ms (median of "
        f"iterations 3-{iters}), {batch / step_ms * 1e3:.1f} records/s (batch {batch}, bf16 "
        f"compute and activations); card {card}")
    log("    iteration walls (ms): " + ", ".join(f"{h['wall_s'] * 1e3:.2f}" for h in hist)
        + f"; CPU time over the run's wall: the main thread {100 * cpu[0]:.1f}% (autograd "
        f"runs the backward on its device thread), the process {100 * cpu[1]:.1f}% (all threads)")
    log("    losses: " + ", ".join(f"{v:.4f}" for v in losses))
    log(f"    maxpool2d_bwd launches: {launches} (expected {PARITY_POOLS_PER_ITER[name]} per "
        f"iteration = {want}); other kernels: {others}")
    if len(hist) != iters or not all(np.isfinite(losses)):
        raise AssertionError(f"{name} training: {len(hist)} iterations, losses {losses}")
    if launches != want or others:
        raise AssertionError(f"{name} training launched {counts}, expected {want} of "
                             "maxpool2d_bwd and nothing else")
    # as in [7]: a state or graph kept alive from step to step would grow by
    # that step's saved activations; allowed 100 MB, about one f32 input
    # batch (Inception's 77 MB; VGG-for-CIFAR-10's 1.6 MB, Wide&Deep's 0.2
    # MB) in flight
    drift = mem[iters - 1] - mem[2]
    log(f"    device memory allocated after iteration 3: {mem[2] / 2**20:.1f} MiB, after "
        f"iteration {iters}: {mem[iters - 1] / 2**20:.1f} MiB (drift {drift / 2**20:+.1f} MiB, "
        f"allowed +-100 MiB); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if abs(drift) > 100 * 2 ** 20:
        raise AssertionError(f"device memory grew over the {name} iterations")
    del opt, model
    torch.cuda.empty_cache()
    return counts, step_ms, cpu


def _parity_config_routes(name):
    """3 f32 SGD steps of one parity config on the card (the max-pool kernel
    where it has pools) vs on the CPU (its plain version), from one set of
    weights; Inception-v1 and VGG-for-CIFAR-10 with dropout off (the routes
    draw other masks)."""
    from bigdl_tpu_torch.models import Inception_v1, VggForCifar10, parity_config

    batch = PARITY_ROUTE_BATCH[name]
    _, x, y, _ = parity_config(name, batch, device="cpu")

    def build(device):
        if name == "inception":
            return Inception_v1(1000, has_dropout=False, device=device)
        if name == "vgg":
            return VggForCifar10(10, has_dropout=False, device=device)
        return parity_config(name, batch, device=device)[0]

    r = _sgd_routes(build, x, y, SEED + 7)
    _check_routes(name, x, r, PARITY_ROUTE_TOL[name],
                  {k: (PARITY_POOLS_PER_ITER[name] * 3 if k == "maxpool2d_bwd" else 0)
                   for k in r["launches"][0]})


# [12] the flagship served at bench.py::_measure_serving's configuration
# (bench.py:714): flagship_model(batch=128, stem="conv7"), bf16 compute
# (activations at the default policy, as the bench leaves them), registered
# with batch_size=128 and max_delay_ms=5. Limits, fixed before the first run:
# - each served row against its record's same-geometry forward (the 128
#   records in one Predictor.forward_batch of the served version): the
#   served row must lie nearer its own record's row than any other record's
#   by a factor SERVE_NEAREST. With the initial BN statistics every record's
#   logits share most of their direction (records' rows 2.1-2.3% apart,
#   relative L2, in a CPU f32 forward of 4 of them), so a tolerance alone
#   could not tell a crossed row from its own; at the same geometry cuDNN
#   takes the same algorithms, so a row's own distance is ~0.
# - each served row against a direct card forward of its record at batch 1
#   (as [5]): relative L2 SERVE_DIRECT_REL. Both round the same operands to
#   bf16; at batch 1 cuDNN may order a product's fp32 sums otherwise, which
#   moves a bf16-rounded output by one step (2^-8) where the two sums
#   straddle a rounding boundary; the whole bf16-vs-f32 difference is
#   6.0e-3 to 6.5e-3 (the same CPU forward), so two bf16 routes differ by
#   less than sqrt(2) x that.
# - one served row against an f32 CPU forward of the same weights and
#   record: relative L2 SERVE_CPU_REL, 3x the CPU's own bf16-vs-f32 reading
#   (the card sums the fp32 products in other orders).
SERVE_NEAREST = 4.0
SERVE_DIRECT_REL = 1e-2
SERVE_CPU_REL = 2e-2
SERVE_BATCH, SERVE_DELAY_MS = 128, 5.0
MIX_A = (8, 128)    # bench.py's: 8 synchronous clients, 1024 requests
MIX_B = (256, 4)    # saturating: 256 synchronous clients x 4 requests


def _rel(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _serve_mix(server, x, clients, per_client, seed0, on_half=None):
    """``clients`` threads, each sending ``per_client`` single-record
    requests and waiting on each before the next (records drawn as
    ``_measure_serving`` draws them: ``default_rng(seed0 + k)``). Returns
    (wall s, [(record index, future)]). ``on_half`` runs on its own thread
    once half the requests are served."""
    import numpy as np

    done, lock, half = [], threading.Lock(), threading.Event()
    n_total = clients * per_client
    errors = []

    def client(k):
        gen = np.random.default_rng(seed0 + k)
        try:
            for _ in range(per_client):
                i = int(gen.integers(len(x)))
                fut = server.infer("flagship", x[i])
                fut.result(timeout=300)
                with lock:
                    done.append((i, fut))
                    if len(done) * 2 >= n_total:
                        half.set()
        except Exception as e:  # re-raised on the main thread below
            errors.append(e)

    side = None
    if on_half is not None:
        side = threading.Thread(target=lambda: (half.wait(600), on_half()))
        side.start()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if side is not None:
        side.join(600)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(done) != n_total:
        raise AssertionError(f"{len(done)} of {n_total} requests served")
    return wall, done


# A request slower than obs.trace's slow threshold (250 ms) is promoted: its
# five span records join the ring beside the serve records, and [12]'s and
# [19a']'s mix B hold many such requests. The ring must keep every serve
# record for _settled to count them.
SERVE_RING = 1 << 16


def _settled(server, tel, n_served):
    """The model's flush count once its serve records account for
    ``n_served`` requests (a flush emits its record just after it resolves
    its futures, so the last one may still be on its way)."""
    end = time.perf_counter() + 30
    while time.perf_counter() < end:
        recs = [r for r in tel.ring.records
                if r["type"] == "serve" and r["model"] == "flagship"]
        if sum(r["records"] for r in recs) == n_served:
            flushes = server.models()["flagship"]["flushes"]
            if flushes == len(recs):
                return flushes
        time.sleep(0.01)
    raise AssertionError(f"the serve records never accounted for {n_served} requests")


def phase_flagship_serving(card):
    """[12] Serve the flagship ResNet-50 through ModelServer at bench.py's
    serving configuration (mix A), a saturating mix (mix B), a hot-swap
    under mix A's traffic, a deadline and admission control; returns every
    kernel's launches of that run (all must be 0)."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.models import ResNet, flagship_model
    from bigdl_tpu_torch.obs import Telemetry
    from bigdl_tpu_torch.optim import Predictor
    from bigdl_tpu_torch.serving import AdmissionRejected, DeadlineExceeded, ModelServer
    from bigdl_tpu_torch.serving.batcher import _nearest_rank
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(1)
    t0 = time.perf_counter()
    v1, x, _, name = flagship_model(batch=SERVE_BATCH, seed=SEED, stem="conv7", device="cuda")
    v1.init(sample_input=x)
    RandomGenerator.set_seed(2)  # the hot-swap's second weight set
    v2 = ResNet(50, class_num=1000, stem="conv7", device="cuda")
    v2.init(sample_input=x[:1])
    models = {1: v1.eval(), 2: v2.eval()}  # eval: the direct forwards below move no BN state
    log(f"[12] {name}, stem conv7: {v1.n_parameters() / 1e6:.3f} M params, two weight sets "
        f"from seeds 1 and 2, {len(x)} records of {tuple(x.shape[1:])} f32, bf16 compute; "
        f"built in {time.perf_counter() - t0:.1f} s")
    tel = Telemetry(ring_capacity=SERVE_RING)
    swap = {}
    torch.cuda.synchronize()
    reset_counts()  # the main path starts here
    with ModelServer(telemetry=tel) as server:
        server.register("flagship", v1, sample_input=x[0], batch_size=SERVE_BATCH,
                        max_delay_ms=SERVE_DELAY_MS)
        warmup_s = server.models()["flagship"]["warmup_s"]
        mem = {"registered": torch.cuda.memory_allocated()}
        mixes = {}

        def hot_swap():
            swap["t0"] = time.perf_counter()
            swap["version"] = server.update("flagship", v2)
            swap["t1"] = time.perf_counter()

        n_served, f0 = 0, 0
        for label, (clients, per), seed0, side in (("A", MIX_A, 0, hot_swap),
                                                    ("B", MIX_B, 1000, None)):
            wall, done = _serve_mix(server, x, clients, per, seed0, side)
            n_served += len(done)
            f1 = _settled(server, tel, n_served)
            mixes[label] = (clients, wall, done, f0, f1)
            f0 = f1
            mem[label] = torch.cuda.memory_allocated()
        # a deadline shorter than one forward: it expires in the queue (5 ms
        # delay bound) or in flight, typed, and the counters see it
        late = server.infer("flagship", x[1], deadline_ms=1.0)
        try:
            late.result(timeout=60)
            raise AssertionError("a 1 ms deadline was served")
        except DeadlineExceeded as e:
            late_stage = e.stage
        # the future keeps its error, whose traceback holds this frame: drop
        # it, or this frame (v1, v2: two ResNet-50 weight sets) waits for the
        # cyclic collector after the phase returns
        del late
        after = server.infer("flagship", x[2])  # its flush's serve record carries the miss
        after.result(timeout=60)
        flushes = _settled(server, tel, n_served + 1)
        health = server.health()["flagship"]
        # admission: the same weights under a bounded second name whose delay
        # bound never fires (close() drains it)
        server.register("bounded", v1, sample_input=x[0], batch_size=SERVE_BATCH,
                        max_delay_ms=60_000, max_pending=2)
        held = [server.infer("bounded", x[i]) for i in (3, 4)]
        try:
            server.infer("bounded", x[5])
            raise AssertionError("the over-limit submit was admitted")
        except AdmissionRejected:
            pass
        info = server.models()
    for f in held:
        f.result(timeout=60)
    torch.cuda.synchronize()
    counts = read_counts()  # the main path ends here
    serves = [r for r in tel.ring.records if r["type"] == "serve"]
    warmups = [r for r in tel.ring.records if r["type"] == "warmup"]

    # ---- what each mix measured
    for label, (clients, wall, done, f0, f1) in mixes.items():
        spans = [f.spans() for _, f in done]
        lats = sorted(s["total_s"] for s in spans)
        recs = [r for r in serves if r["model"] == "flagship" and f0 < r["iteration"] <= f1]
        log(f"    mix {label} ({clients} synchronous clients, {len(done)} requests): "
            f"{len(done) / wall:.2f} requests/s over {wall:.3f} s; total_s p50 "
            f"{_nearest_rank(lats, 50) * 1e3:.3f} ms, p99 "
            f"{_nearest_rank(lats, 99) * 1e3:.3f} ms; mean queue_s "
            f"{np.mean([s['queue_s'] for s in spans]) * 1e3:.3f} ms, assembly_s "
            f"{np.mean([s['assembly_s'] for s in spans]) * 1e3:.3f} ms, dispatch_s "
            f"{np.mean([s['dispatch_s'] for s in spans]) * 1e3:.3f} ms, materialize_s "
            f"{np.mean([s['materialize_s'] for s in spans]) * 1e3:.3f} ms; {len(recs)} flushes, "
            f"mean batch_fill {np.mean([r['batch_fill'] for r in recs]):.4f}, triggers "
            f"{sorted({r['trigger'] for r in recs})}; warmup_s {warmup_s:.3f}; card {card}")
        if len(recs) != f1 - f0 or sum(r["records"] for r in recs) != len(done):
            raise AssertionError(f"mix {label}: {len(recs)} serve records for {f1 - f0} "
                                 f"flushes, {sum(r['records'] for r in recs)} records for "
                                 f"{len(done)} requests")
    log(f"    hot-swap to version {swap.get('version')} during mix A took "
        f"{(swap['t1'] - swap['t0']) * 1e3:.1f} ms (the new version built and warmed off the "
        f"serving path); warmup records (model, version, library loads): "
        f"{[(r['model'], r['version'], r['compiles']) for r in warmups]}")
    ours = [r for r in serves if r["model"] == "flagship"]
    served = sum(len(m[2]) for m in mixes.values()) + 1
    if len(ours) != flushes or sum(r["records"] for r in ours) != served:
        raise AssertionError(f"{len(ours)} serve records for {flushes} flushes; "
                             f"{sum(r['records'] for r in ours)} records for {served} served")
    bounded = [r for r in serves if r["model"] == "bounded"]
    log(f"    serve records: {len(ours)} for {flushes} flushes, {served} records for {served} "
        f"served requests; the 1 ms deadline failed at the {late_stage!r} seam, "
        f"deadline_missed {health['deadline_missed']} (health), "
        f"{ours[-1].get('deadline_missed')} (the last serve record); admission: rejected "
        f"{info['bounded']['rejected']}, on the bounded model's serve records "
        f"{[r['rejected'] for r in bounded]}")
    if (health["deadline_missed"] != 1 or ours[-1].get("deadline_missed") != 1
            or info["bounded"]["rejected"] != 1 or [r["rejected"] for r in bounded] != [1]
            or sum(r["records"] for r in bounded) != 2):
        raise AssertionError("deadline or admission accounting is off")

    # ---- the hot-swap: each future on one version, no flush mixes versions
    done_a, done_b = mixes["A"][2], mixes["B"][2]
    by_flush = {}
    for _, f in done_a + done_b:
        by_flush.setdefault(f.t_batch, set()).add(f.version)
    versions = [f.version for _, f in done_a]
    last_v1 = max(f.t_batch for _, f in done_a if f.version == 1)
    first_v2 = min(f.t_batch for _, f in done_a if f.version == 2)
    log(f"    hot-swap: mix A {versions.count(1)} requests on version 1, {versions.count(2)} on "
        f"version 2, mix B all on {sorted({f.version for _, f in done_b})}; flushes "
        f"holding two versions: {sum(len(v) > 1 for v in by_flush.values())}; retired versions "
        f"left {info['flagship']['retired_versions']}")
    if (swap.get("version") != 2 or not versions.count(1) or not versions.count(2)
            or last_v1 > first_v2 or any(len(v) > 1 for v in by_flush.values())
            or {f.version for _, f in done_b} != {2}
            or info["flagship"]["retired_versions"]):
        raise AssertionError("the hot-swap did not resolve each future on one version")

    # ---- every served row: its record's, its version's
    with torch.inference_mode():
        same = {v: Predictor(m, SERVE_BATCH).forward_batch(x).float().cpu().numpy()
                for v, m in models.items()}
        direct = {v: np.stack([m.forward(x[i:i + 1])[0].float().cpu().numpy()
                               for i in range(len(x))]) for v, m in models.items()}
    worst_own, worst_ratio, worst_direct = 0.0, float("inf"), 0.0
    for i, f in done_a + done_b:
        got = f.result().float().numpy()
        if got.shape != (1000,) or not np.isfinite(got).all():
            raise AssertionError(f"a served row has shape {got.shape} or is not finite")
        refs = np.concatenate([same[1], same[2]])
        d = np.linalg.norm(refs - got, axis=1)
        own = (f.version - 1) * len(x) + i
        others = np.delete(d, own)
        worst_own = max(worst_own, d[own] / np.linalg.norm(refs[own]))
        worst_ratio = min(worst_ratio, others.min() / d[own] if d[own] else float("inf"))
        worst_direct = max(worst_direct, _rel(got, direct[f.version][i]))
    log(f"    served rows vs their record's same-geometry forward (2 x {len(x)} candidate rows): "
        f"own distance at most {worst_own:.2e} relative, the nearest other row at least "
        f"{worst_ratio:.3g}x farther (limit {SERVE_NEAREST}); vs a direct batch-1 card forward "
        f"of the record: relative L2 at most {worst_direct:.2e} (limit {SERVE_DIRECT_REL})")
    if worst_ratio < SERVE_NEAREST or worst_direct > SERVE_DIRECT_REL:
        raise AssertionError("served rows disagree with their records' forwards")

    # ---- one served row against an f32 CPU forward of the same weights
    i, f = next((i, f) for i, f in done_a if f.version == 1)
    Engine.set_compute_dtype("float32")
    try:
        cpu = ResNet(50, class_num=1000, stem="conv7", device="cpu")
        cpu.init(sample_input=x[i:i + 1])
        load_jax_params(cpu, {k: v.detach().float().cpu().numpy()
                              for k, v in v1.named_parameters()})
        load_jax_state(cpu, _nest(_tree_to_numpy(v1.get_state())))
        with torch.inference_mode():
            ref = cpu.eval().forward(x[i:i + 1])[0].numpy()
    finally:
        Engine.set_compute_dtype("bfloat16")
    got = f.result().float().numpy()
    err = _rel(got, ref)
    log(f"    served row (record {i}, version 1) vs an f32 CPU forward: relative L2 {err:.2e} "
        f"(limit {SERVE_CPU_REL}), argmax {int(got.argmax())} vs {int(ref.argmax())}")
    if err > SERVE_CPU_REL:
        raise AssertionError("the served row disagrees with the f32 CPU forward")

    # ---- memory flat across the mixes; no kernel of this repo launched
    drift = max(abs(mem["A"] - mem["registered"]), abs(mem["B"] - mem["registered"]))
    log(f"    device memory allocated after registration {mem['registered'] / 2**20:.1f} MiB, "
        f"after mix A {mem['A'] / 2**20:.1f}, after mix B {mem['B'] / 2**20:.1f} (drift "
        f"{drift / 2**20:.1f} MiB, allowed 100 MiB: about one f32 input batch in flight)")
    if drift > 100 * 2 ** 20:
        raise AssertionError("device memory grew across the serving mixes")
    log(f"    kernel launches on the path: {counts}")
    if any(counts.values()):
        raise AssertionError(f"flagship serving launched a kernel of this repo: {counts}")
    del models, v1, v2, same, direct
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- [13]
# [13] the rest of optim/ and the shift max-pool gradient, driven through the
# port's ResNet ImageNet recipe (bigdl_tpu_torch/examples/resnet_train.py,
# the counterpart of examples/resnet/train.py --dataset imagenet): ResNet-50
# conv7 at 224x224, batch 128, bf16 activations (the recipe's card rule),
# lr 0.01 (the recipe's default), 384 synthetic records (3 iterations an
# epoch), one warmup epoch, 3 epochs, run once with multistep and once with
# poly. Device memory may drift +-100 MiB after step 2 (about one f32 image
# batch in flight, as [7]).
RECIPE_ARGS = ["--dataset", "imagenet", "--depth", "50", "--stem", "conv7", "--image-size",
               "224", "-b", "128", "--synthetic-size", "384", "--warmup-epochs", "1",
               "--max-epoch", "3", "--learning-rate", "0.01"]
RECIPE_DEVICE = "cuda"  # the CPU rehearsal sets "cpu" and cuts RECIPE_ARGS
MEM_DRIFT = 100 * 2 ** 20
# [13b] the shift gradient against kernel #10 at the stem pool on tie-free f32
# input (each plane a permutation, so no window holds two equal values): a
# cell sums at most 4 windows' dy (3x3/s2) in fp32 in another order, so
# |err| <= SHIFT_F32_REL_SUM * 4 * max|dy| (as TOL_MAXPOOL's f32 term); on
# post-ReLU bf16 input the card's shift against the CPU's: the same compares
# and bf16 adds in the same order, so equal to the bit.
SHIFT_F32_REL_SUM = 1e-6
STEM_POOL = ((128, 64, 112, 112), (3, 3), (2, 2), ((1, 1), (1, 1)))
# [13c] one update from identical float32 gradients, parameters and slots,
# card against CPU, fixed before the first run: ||p_card - p_cpu|| over the
# update's own norm ||p_cpu - p_before||. Both run the same elementwise ops
# (IEEE division and square root on both); the card may fuse a multiply-add
# (addcmul) and sums Lamb's/LARS's per-leaf norms in another order, each a
# unit in the last place of a parameter (~6e-8 of it), which is ~1e-5 of an
# update at these rates: the limit 1e-4. (Its first reading on an H100 failed
# it for LarsSGD, 2.19e-4, and Lamb read 1.72e-5: the CPU's float32
# vector_norm accumulates an error that grows with a leaf's size. The
# methods now sum their norms in float64, optim_method._norm.)
OPT_ROUTE_REL = 1e-4
OPT_STEPS = 3
LBFGS_RECORDS, LBFGS_ITERS, LBFGS_MAX_EVAL = 512, 5, 40
# [13e] the logged loss against the criterion's loss plus the penalty, both
# recomputed apart from the step's starting weights (f32, TF32 off: the same
# forward): 1e-5 relative of the logged loss.
REG_REL = 1e-5


def _recipe_optimizers():
    """(name, factory) of the eight new methods at rates that keep 3 steps
    of the recipe's model finite; Ftrl is trained on Wide&Deep."""
    from bigdl_tpu_torch import optim as O

    ex = ("_bn", "bias")
    return [("ParallelAdam", lambda: O.ParallelAdam(learningrate=1e-4)),
            ("Adagrad", lambda: O.Adagrad(learningrate=1e-3, weightdecay=1e-4)),
            ("Adadelta", lambda: O.Adadelta()),
            ("Adamax", lambda: O.Adamax(learningrate=2e-4)),
            ("RMSprop", lambda: O.RMSprop(learningrate=1e-5)),
            ("Lamb", lambda: O.Lamb(learningrate=1e-3, weightdecay=0.01,
                                    weightdecay_exclude=ex)),
            ("LarsSGD", lambda: O.LarsSGD(trust=1e-3, learningrate=0.1, momentum=0.9,
                                          weightdecay=1e-4, weightdecay_exclude=ex)),
            ("Ftrl", lambda: O.Ftrl(learningrate=0.1, l1_regularization_strength=1e-4,
                                    l2_regularization_strength=1e-4))]


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _mem() -> int:
    """Device memory allocated, less the input batches that ``LocalOptimizer``'s
    prefetch threads have staged and no step has taken yet
    (``staged_device_bytes``; up to three batches, with depth 2): the memory
    that a step leaves behind, which the flat-memory checks compare."""
    import torch
    from bigdl_tpu_torch.optim.local_optimizer import staged_device_bytes

    if not torch.cuda.is_available():
        return 0
    return torch.cuda.memory_allocated() - staged_device_bytes()


class _ClassPatch:
    """Replaces attributes of the optimizer classes (``LocalOptimizer`` and
    ``DistriOptimizer``) and restores them on exit, as they were: set on the
    class or inherited."""

    def __init__(self):
        from bigdl_tpu_torch.optim import LocalOptimizer
        from bigdl_tpu_torch.parallel import DistriOptimizer

        self.classes = (LocalOptimizer, DistriOptimizer)
        self._saved = []

    def patch(self, name, make):
        """``setattr(cls, name, make(original))`` on each class."""
        for cls in self.classes:
            self._saved.append((cls, name, cls.__dict__.get(name)))
            setattr(cls, name, make(getattr(cls, name)))

    def restore(self):
        for cls, name, old in reversed(self._saved):
            if old is None:
                delattr(cls, name)
            else:
                setattr(cls, name, old)
        self._saved = []


class _StepProbe:
    """Wraps ``_train_step`` and ``_run_validation`` of ``LocalOptimizer``
    and ``DistriOptimizer`` (class attributes, restored on exit): each step's
    kernel launches and the device memory after it, each validation's
    launches and results; ``before_step(opt)`` runs before each step when
    given."""

    def __init__(self, before_step=None):
        self.before_step = before_step

    def __enter__(self):
        self.steps, self.validations = [], []
        self._patch = _ClassPatch()
        probe = self

        def wrap_step(step0):
            def step(opt, *a, **k):
                if probe.before_step is not None:
                    probe.before_step(opt)
                before = read_counts()
                out = step0(opt, *a, **k)
                after = read_counts()
                probe.steps.append({"launches": {n: after[n] - before[n] for n in after},
                                    "mem": _mem()})
                return out

            return step

        def wrap_validation(val0):
            def validation(opt):
                before = read_counts()
                res = val0(opt)
                after = read_counts()
                if res is not None:
                    probe.validations.append({
                        "epoch": opt.optim_method.state["epoch"],
                        "results": {k: v.result() for k, v in res.items()},
                        "launches": sum(after.values()) - sum(before.values())})
                return res

            return validation

        self._patch.patch("_train_step", wrap_step)
        self._patch.patch("_run_validation", wrap_validation)
        return self

    def __exit__(self, *exc):
        self._patch.restore()
        return False


def _check_launch_steps(label, probe, n_steps, want, mem_from):
    """Exact launches each step (``want``), device memory flat from step
    ``mem_from`` to the last (+-100 MiB, as the other paths)."""
    if len(probe.steps) != n_steps:
        raise AssertionError(f"{label}: {len(probe.steps)} steps, expected {n_steps}")
    for i, s in enumerate(probe.steps, 1):
        if s["launches"] != want:
            raise AssertionError(f"{label}: step {i} launched {_nonzero(s['launches'])}, "
                                 f"expected {_nonzero(want)}")
    if n_steps > mem_from:
        m0, m1 = probe.steps[mem_from - 1]["mem"], probe.steps[-1]["mem"]
        log(f"    device memory after step {mem_from}: {m0 / 2**20:.1f} MiB, after step "
            f"{n_steps}: {m1 / 2**20:.1f} MiB (drift {(m1 - m0) / 2**20:+.1f} MiB, allowed "
            "+-100 MiB)")
        if abs(m1 - m0) > MEM_DRIFT:
            raise AssertionError(f"{label}: device memory grew over the steps")


def _check_steps(label, probe, n_steps, pools_per_step, want_validations=None):
    """Exact launches a step (``maxpool2d_bwd`` ``pools_per_step`` times,
    nothing else), none in the validations, memory flat after step 2."""
    want = {n: (pools_per_step if n == "maxpool2d_bwd" else 0) for n in read_counts()}
    _check_launch_steps(label, probe, n_steps, want, mem_from=2)
    if any(v["launches"] for v in probe.validations):
        raise AssertionError(f"{label}: a validation launched a kernel: {probe.validations}")
    if want_validations is not None and len(probe.validations) != want_validations:
        raise AssertionError(f"{label}: {len(probe.validations)} validations, expected "
                             f"{want_validations}")


def _recipe_lr(n: int, schedule: str, lr: float, ipe: int, warmup_epochs: int,
               max_epoch: int) -> float:
    """The recipe's rate at 0-based iteration ``n``, its closed form."""
    warmup = warmup_epochs * ipe
    if n < warmup:
        return lr * (n + 1) / warmup
    if schedule == "poly":
        total = max_epoch * ipe
        return 0.0 if n >= total else lr * (1 - n / total) ** 2.0
    return lr * 0.1 ** sum(n >= e * ipe for e in (30, 60, 80))


def _recipe_argv(*extra):
    return RECIPE_ARGS + (["--platform", "cpu"] if RECIPE_DEVICE == "cpu" else []) + list(extra)


def phase_recipe(card):
    """[13a] The recipe twice (multistep, poly) through its ``main()``;
    returns each run's launches and the recipes (for [13c]'s model and the
    busy share)."""
    import statistics

    import numpy as np
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.examples import resnet_train

    by_path, recipes = {}, {}
    args = resnet_train.parser().parse_args(_recipe_argv())
    for schedule in ("multistep", "poly"):
        Engine.set_compute_dtype(None)  # the recipe's policy, as in a fresh process
        Engine.set_activation_dtype(None)
        t0 = time.perf_counter()
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            recipe = resnet_train.main(_recipe_argv("--lr-schedule", schedule))
            _sync()
            counts = read_counts()  # the main path ends here
        wall = time.perf_counter() - t0
        opt = recipe.optimizer
        hist = opt.history
        ipe = recipe.iters_per_epoch
        n_steps = args.max_epoch * ipe
        lrs = [h["lr"] for h in hist]
        want = [_recipe_lr(n, schedule, args.learning_rate, ipe, args.warmup_epochs,
                           args.max_epoch) for n in range(n_steps)]
        losses = [h["loss"] for h in hist]
        step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3
        batch = args.batch_size
        log(f"[13a] recipe --lr-schedule {schedule}: ResNet-{args.depth} {args.stem}, "
            f"{recipe.model.n_parameters() / 1e6:.3f} M params, {args.synthetic_size} records of "
            f"3x{args.image_size}x{args.image_size}, batch {batch}, {ipe} iterations an epoch, "
            f"{args.max_epoch} epochs, activations {Engine.activation_dtype()}, compute "
            f"{Engine.compute_dtype()}; {len(hist)} iterations in {wall:.2f} s (build, data "
            f"and validations included): step {step_ms:.2f} ms (median of iterations "
            f"3-{n_steps}; two of them also hold an epoch end), {batch / step_ms * 1e3:.1f} "
            f"images/s; card {card}")
        log("    lr: " + ", ".join(f"{v:.6g}" for v in lrs))
        log("    losses: " + ", ".join(f"{v:.4f}" for v in losses))
        if lrs != want:
            raise AssertionError(f"[13a] {schedule}: rates {lrs} are not the closed form {want}")
        if len(hist) != n_steps or not all(np.isfinite(losses)):
            raise AssertionError(f"[13a] {schedule}: {len(hist)} iterations, losses {losses}")
        _check_steps(f"[13a] {schedule}", probe, n_steps, 1, want_validations=args.max_epoch)
        for v in probe.validations:
            top1, top5 = v["results"]["Top1Accuracy"], v["results"]["Top5Accuracy"]
            log(f"    validation at the end of epoch {v['epoch'] - 1}: Top-1 {top1[0]:.4f}, "
                f"Top-5 {top5[0]:.4f} (n={top1[1]}), kernel launches {v['launches']}")
            if not (0 <= top1[0] <= top5[0] <= 1) or top1[1] != top5[1] or top1[1] < 1:
                raise AssertionError(f"[13a] {schedule}: validation {v}")
        if sorted(v["epoch"] for v in probe.validations) != list(range(2, args.max_epoch + 2)):
            raise AssertionError(f"[13a] {schedule}: validations {probe.validations}")
        log(f"    maxpool2d_bwd launches {counts['maxpool2d_bwd']} (1 a step, 0 in the "
            f"{len(probe.validations)} validations and the final evaluation); others "
            f"{sum(counts.values()) - counts['maxpool2d_bwd']}")
        if counts["maxpool2d_bwd"] != n_steps or sum(counts.values()) != n_steps:
            raise AssertionError(f"[13a] {schedule}: launches {counts}")
        by_path[f"recipe_{schedule}"] = counts
        recipes[schedule] = recipe
    busy = _busy_share(recipes["multistep"].optimizer, 2)
    log(f"    busy share (multistep recipe, 2 more iterations under torch.profiler, no "
        f"validation): device {busy[0]:.2f} ms of {busy[1]:.2f} ms a step under the profiler "
        f"({100 * busy[2]:.1f}% busy); card {card}")
    _log_input_wait("[13a] multistep", recipes["multistep"].optimizer.history[:-2])
    rng = np.random.default_rng(0)  # the recipe's draw: its host data path, timed alone
    x = rng.standard_normal((args.synthetic_size, 3, args.image_size, args.image_size)).astype(
        np.float32)
    _host_batch_ms(x, rng.integers(0, args.class_num, len(x)), args.batch_size, "cuda")
    return by_path, recipes


def _log_input_wait(label, hist):
    """The prefetch thread's wait for each batch from the dataset (the host
    time the data path failed to stay ahead of the steps), from ``history``."""
    import statistics

    waits = [h["input_wait_s"] * 1e3 for h in hist]
    log(f"    {label}: the prefetch thread's wait for a batch from the dataset, median "
        f"{statistics.median(waits):.2f} ms (range {min(waits):.2f}-{max(waits):.2f}) over "
        f"{len(waits)} steps")


def _busy_share(opt, iters):
    """(device ms, wall ms, share) a step over ``iters`` more iterations of
    ``opt`` under ``torch.profiler`` (the sum of the kernels' device time
    over the profiled wall; the profiler slows the host, so the share is a
    floor). The device time is summed over the profiler's raw events:
    ``key_averages()`` first parses every event into a ``FunctionEvent``,
    ~30 s for the ~200k events of two iterations of a 200-step recurrence,
    against ~1 s for the raw walk."""
    import torch
    from bigdl_tpu_torch.optim import Trigger
    from torch.profiler import ProfilerActivity, profile

    state = opt.optim_method.state
    opt.set_end_when(Trigger.max_iteration(state["neval"] - 1 + iters))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        opt.optimize()
        _sync()
        wall = time.perf_counter() - t0
    dev_us = sum(ev.duration_ns() for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == torch.autograd.DeviceType.CUDA) / 1e3
    dev_ms, wall_ms = dev_us / 1e3 / iters, wall * 1e3 / iters
    return dev_ms, wall_ms, dev_ms / wall_ms


def phase_shift(card):
    """[13b] 3 recipe steps under BIGDL_MAXPOOL_GRAD_IMPL=shift (no kernel
    launch), then the shift gradient against kernel #10 at the stem pool and
    timed beside it, ATen's backward and #10's bound."""
    import os

    import numpy as np
    import torch
    import torch.nn.functional as F
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.examples import resnet_train
    from bigdl_tpu_torch.ops import maxpool as mp

    prev = os.environ.get("BIGDL_MAXPOOL_GRAD_IMPL")
    os.environ["BIGDL_MAXPOOL_GRAD_IMPL"] = "shift"
    try:
        if mp.grad_impl() != "shift":
            raise AssertionError("[13b] BIGDL_MAXPOOL_GRAD_IMPL=shift does not select shift")
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
        args = resnet_train.parser().parse_args(_recipe_argv("--max-epoch", "1"))
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            recipe = resnet_train.main(_recipe_argv("--max-epoch", "1"))
            _sync()
            counts = read_counts()  # the main path ends here
    finally:
        if prev is None:
            del os.environ["BIGDL_MAXPOOL_GRAD_IMPL"]
        else:
            os.environ["BIGDL_MAXPOOL_GRAD_IMPL"] = prev
    hist = recipe.optimizer.history
    losses = [h["loss"] for h in hist]
    n_steps = recipe.iters_per_epoch
    log(f"[13b] recipe under BIGDL_MAXPOOL_GRAD_IMPL=shift: {len(hist)} iterations, losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; launches {counts}")
    if len(hist) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[13b] shift: {len(hist)} iterations, losses {losses}")
    _check_steps("[13b] shift", probe, n_steps, 0, want_validations=args.max_epoch)
    if sum(counts.values()):
        raise AssertionError(f"[13b] shift launched {counts}; expected no kernel")
    del recipe
    _free()

    shape, kernel, stride, padding = STEM_POOL
    dev = RECIPE_DEVICE
    n, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    # tie-free f32: each plane a permutation of 0..h*w-1
    x = torch.argsort(torch.rand((n * c, h * w), generator=g, device=dev), dim=1).float()
    x = x.reshape(shape)
    ho, wo = mp.pooled_size((h, w), kernel, stride, padding)
    dy = torch.randn((n, c, ho, wo), generator=g, device=dev)
    shift = mp.maxpool_grad_shift(x, dy, kernel, stride, padding)
    ref = mp.maxpool_grad(x, dy, kernel, stride, padding)
    err = (shift - ref).abs().max().item()
    tol = SHIFT_F32_REL_SUM * 4 * dy.abs().max().item()
    log(f"[13b] shift vs kernel #10 at the stem pool {shape} f32 3x3/s2/p1, tie-free: max "
        f"|err| {err:.3g} (limit {tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"[13b] shift and kernel #10 disagree at the stem pool: {err}")
    del x, dy, shift, ref
    # post-ReLU bf16, the training input: card against CPU, bit for bit
    xb = torch.relu(torch.randn(shape, generator=g, device=dev)).to(torch.bfloat16)
    dyb = torch.randn((n, c, ho, wo), generator=g, device=dev).to(torch.bfloat16)
    got = mp.maxpool_grad_shift(xb, dyb, kernel, stride, padding)
    t0 = time.perf_counter()
    want = mp.maxpool_grad_shift(xb.cpu(), dyb.cpu(), kernel, stride, padding)
    cpu_s = time.perf_counter() - t0
    same = torch.equal(got.cpu(), want)
    nz_shift = int((want != 0).sum())
    nz_first = int((mp.maxpool_grad(xb, dyb, kernel, stride, padding) != 0).sum())
    log(f"[13b] shift on the card vs on the CPU, post-ReLU bf16 {shape}: bit-identical "
        f"{same} (CPU {cpu_s:.1f} s); cells receiving dy: shift {nz_shift}, first maximum "
        f"{nz_first} (ties spread)")
    if not same:
        raise AssertionError("[13b] the shift gradient differs between the card and the CPU")
    del want
    rec = {"shape": list(shape), "geometry": "3x3/s2/p1", "dtype": "bfloat16",
           "max_abs_err_vs_kernel_f32": err}
    if dev == "cuda":
        rec["shift_ms"] = cuda_ms(lambda: mp.maxpool_grad_shift(xb, dyb, kernel, stride,
                                                                padding), iters=10)
        rec["kernel_ms"] = cuda_ms(lambda: mp.maxpool_grad(xb, dyb, kernel, stride, padding),
                                   iters=50)
        _, idx = F.max_pool2d(xb, kernel, stride, padding[0][0], return_indices=True)
        rec["aten_ms"] = cuda_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            dyb, xb, list(kernel), list(stride), [padding[0][0], padding[1][0]], [1, 1], False,
            idx), iters=50)
        del idx
        rec["bound_ms"], rec["bound_by"] = bound_ms(0.0, (xb, dyb, got), card)
        log(f"[13b] A/B at the stem pool {shape} bf16 3x3/s2/p1 (post-ReLU): shift "
            f"{rec['shift_ms']:.4f} ms, kernel #10 {rec['kernel_ms']:.4f} ms, ATen backward "
            f"from saved indices {rec['aten_ms']:.4f} ms, #10's bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}); shift/kernel {rec['shift_ms'] / rec['kernel_ms']:.2f}; "
            f"card {card}")
    del xb, dyb, got
    _free()
    return {"recipe_shift": counts}, rec


def _free():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _clone(tree, device):
    return {k: (_clone(v, device) if isinstance(v, dict) else v.detach().to(device, copy=True))
            for k, v in tree.items()}


def _tree_dist(a, b) -> float:
    """||a - b|| over two trees of one structure, in float64 on the CPU."""
    import torch

    total = 0.0
    for (_, x), (_, y) in zip(_flat_items(a), _flat_items(b)):
        d = x.detach().cpu().double() - y.detach().cpu().double()
        total += float(torch.sum(d * d))
    return total ** 0.5


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


class _UpdateCapture:
    """Wraps ``method.update`` on the instance: at call ``at`` it keeps a
    host copy of the parameters, slots and gradients before the update and
    of the parameters after it (and the rate and step); host copies leave
    the card's memory as the step left it."""

    def __init__(self, method, at: int):
        self.method, self.at, self.calls, self.kept = method, at, 0, None
        self._update = method.update
        method.update = self

    def __call__(self, grads, params, slots, lr, step):
        self.calls += 1
        if self.calls == self.at:
            self.kept = {"grads": _clone(grads, "cpu"), "params": _clone(params, "cpu"),
                         "slots": _clone(slots, "cpu"), "lr": lr, "step": step}
        out = self._update(grads, params, slots, lr, step)
        if self.calls == self.at:
            self.kept["after"] = _clone(params, "cpu")
        return out

    def restore(self):
        del self.method.update


def phase_optimizers(card, recipes):
    """[13c] Each new method 3 steps of the recipe's model (Ftrl: of
    Wide&Deep) through LocalOptimizer, then one update from identical f32
    gradients on the card against the CPU, and its update ms on the card."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch import optim as O
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.examples import resnet_train
    from bigdl_tpu_torch.models import parity_config
    from bigdl_tpu_torch.nn import ClassNLLCriterion

    recipe = recipes["multistep"]
    model = recipe.model
    criterion = recipe.optimizer.criterion
    train_ds = recipe.optimizer.dataset
    p0, s0 = _clone(model.get_parameters(), "cpu"), _clone(model.get_state(), "cpu")
    wd_model = None
    counts_all = {}
    for name, make in _recipe_optimizers():
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype("bfloat16" if RECIPE_DEVICE == "cuda" else None)
        if name == "Ftrl":
            RandomGenerator.set_seed(1)
            batch = None if RECIPE_DEVICE == "cuda" else 256
            wd_model, table, labels, batch = parity_config("widedeep", batch, device=RECIPE_DEVICE)
            wd_model.init(sample_input=table)
            m, ds, crit, pools, what = (wd_model, DataSet.array(table, labels, batch_size=batch),
                                        ClassNLLCriterion(), 0, f"Wide&Deep, batch {batch}")
        else:
            with torch.no_grad():  # every method starts from the recipe model's weights
                for (_, p), (_, v) in zip(_flat_items(model.get_parameters()), _flat_items(p0)):
                    p.copy_(v)
            model.set_state(_clone(s0, model.device))
            m, ds, crit, pools, what = model, train_ds, criterion, 1, "the recipe's ResNet-50"
        method = make()
        cap = _UpdateCapture(method, OPT_STEPS)
        opt = O.LocalOptimizer(m, ds, crit).set_optim_method(method)
        opt.set_end_when(O.Trigger.max_iteration(OPT_STEPS))
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            opt.optimize()
            _sync()
            counts = read_counts()  # the main path ends here
        cap.restore()
        losses = [h["loss"] for h in opt.history]
        if len(losses) != OPT_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"[13c] {name}: losses {losses}")
        _check_steps(f"[13c] {name}", probe, OPT_STEPS, pools)
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        kept = cap.kept
        # the same update on the CPU from the same f32 values
        cpu_after = _clone(kept["params"], "cpu")
        make().update(_clone(kept["grads"], "cpu"), cpu_after, _clone(kept["slots"], "cpu"),
                      kept["lr"], kept["step"])
        upd = _tree_dist(cpu_after, kept["params"])
        rel = _tree_dist(kept["after"], cpu_after) / max(upd, 1e-30)
        finite = all(bool(torch.isfinite(v).all()) for _, v in _flat_items(kept["after"]))
        ms = None
        if RECIPE_DEVICE == "cuda":  # the update alone on the card, on copies of its inputs
            g, p, s = (_clone(kept[k], "cuda") for k in ("grads", "params", "slots"))
            ms = cuda_ms(lambda: method.update(g, p, s, kept["lr"], kept["step"]), iters=5,
                         warmup=1)
            del g, p, s
        log(f"[13c] {name} on {what}: {OPT_STEPS} steps, losses "
            + ", ".join(f"{v:.4f}" for v in losses)
            + f"; step-{OPT_STEPS} update card vs CPU from identical f32 gradients: "
            f"{rel:.3g} of the update (limit {OPT_ROUTE_REL}; update norm {upd:.4g}), finite "
            f"{finite}; update " + (f"{ms:.3f} ms on the card" if ms is not None else
                                    "not timed (CPU)") + f"; card {card}")
        if not (rel <= OPT_ROUTE_REL and finite and upd > 0):
            raise AssertionError(f"[13c] {name}: card and CPU updates differ by {rel}")
        del opt, cap, kept, cpu_after
        _free()
    # Adamax's subnormal epsilon on a leaf whose gradient is all zero from the
    # first step: m / u = 0 / 1e-38 must stay 0 (no flush to zero)
    p = {"w": torch.randn(4096, device=RECIPE_DEVICE)}
    before = p["w"].clone()
    ax = O.Adamax()
    ax.update({"w": torch.zeros_like(p["w"])}, p, ax.init_slots(p), 2e-3, 1)
    ok = torch.equal(p["w"], before)
    log(f"[13c] Adamax, an all-zero gradient from the first step: the leaf unchanged and "
        f"finite {ok}")
    if not ok:
        raise AssertionError("[13c] Adamax moved (or NaN'd) a leaf whose gradient is zero")
    del wd_model
    _free()
    return {"optimizers": counts_all}


def _lenet_regularized(device, l1, l2):
    """LeNet-5's layers with L1L2Regularizer(l1, l2) on every convolution's
    and linear layer's weight and bias."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import L1L2Regularizer

    def r():
        return {"w_regularizer": L1L2Regularizer(l1, l2),
                "b_regularizer": L1L2Regularizer(l1, l2)}

    d = {"device": device}
    return nn.Sequential(
        nn.Reshape([1, 28, 28], **d), nn.SpatialConvolution(1, 6, 5, 5, **r(), **d), nn.Tanh(**d),
        nn.SpatialMaxPooling(2, 2, 2, 2, **d), nn.SpatialConvolution(6, 12, 5, 5, **r(), **d),
        nn.Tanh(**d), nn.SpatialMaxPooling(2, 2, 2, 2, **d), nn.Reshape([12 * 4 * 4], **d),
        nn.Linear(12 * 4 * 4, 100, **r(), **d), nn.Tanh(**d), nn.Linear(100, 10, **r(), **d),
        nn.LogSoftMax(**d), **d)


def phase_lbfgs(card):
    """[13d] LBFGS, full batch, line search lswolfe, on LeNet-5."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.models import parity_config
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import LBFGS

    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(1)
    model, x, y, _ = parity_config("lenet", LBFGS_RECORDS, device=RECIPE_DEVICE)
    xt = torch.from_numpy(x).to(RECIPE_DEVICE)
    yt = torch.from_numpy(np.asarray(y)).to(RECIPE_DEVICE)
    model.init(sample_input=xt)
    state = model.get_state()
    crit = ClassNLLCriterion()
    evals = []

    def feval(params):
        leaves = [v.requires_grad_() for _, v in _flat_items(params)]
        out, _ = model.apply(params, state, xt, training=True)
        loss = crit._apply(out, yt)
        grads = iter(torch.autograd.grad(loss, leaves))
        evals.append(float(loss.detach()))
        return loss.detach(), _map_tree(lambda _: next(grads), params)

    method = LBFGS(max_iter=LBFGS_ITERS, max_eval=LBFGS_MAX_EVAL, line_search="lswolfe")
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            reset_counts()  # the main path starts here
            t0 = time.perf_counter()
            new_params, hist = method.optimize(feval, model.get_parameters())
            _sync()
            wall = time.perf_counter() - t0
            counts = read_counts()  # the main path ends here
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    log(f"[13d] LBFGS (lswolfe, max_iter {LBFGS_ITERS}, max_eval {LBFGS_MAX_EVAL}) on LeNet-5, "
        f"full batch {LBFGS_RECORDS}, f32: loss history " + ", ".join(f"{v:.5f}" for v in hist)
        + f"; {len(evals)} feval calls in {wall:.2f} s; launches {counts}; card {card}")
    if any(b > a for a, b in zip(hist, hist[1:])) or not hist[-1] < hist[0]:
        raise AssertionError(f"[13d] LBFGS's loss history increased or did not fall: {hist}")
    if len(evals) > LBFGS_MAX_EVAL:
        raise AssertionError(f"[13d] LBFGS made {len(evals)} feval calls, max_eval "
                             f"{LBFGS_MAX_EVAL}")
    want = {n: (2 * len(evals) if n == "maxpool2d_bwd" else 0) for n in counts}
    if counts != want:
        raise AssertionError(f"[13d] launches {counts}, expected {want} (2 pools a feval)")
    if not all(v.device == xt.device for _, v in _flat_items(new_params)):
        raise AssertionError("[13d] LBFGS's parameters left the card")
    del model, new_params
    _free()
    return {"lbfgs": counts}


def _map_tree(fn, tree):
    return {k: (_map_tree(fn, v) if isinstance(v, dict) else fn(v)) for k, v in tree.items()}


def phase_regularizers(card):
    """[13e] A LeNet-5 of the port's layers with L1L2Regularizer on every
    convolution and linear layer: 3 LocalOptimizer steps; each logged loss
    minus the criterion's loss of the same forward equals the penalty."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import parity_config
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(1)
    _, x, y, batch = parity_config("lenet", device="cpu")
    model = _lenet_regularized(RECIPE_DEVICE, 1e-4, 5e-3)
    xt = torch.from_numpy(x[:batch]).to(RECIPE_DEVICE)
    yt = torch.from_numpy(np.asarray(y[:batch])).to(RECIPE_DEVICE)
    model.init(sample_input=xt)
    crit = ClassNLLCriterion()
    apart = []  # (criterion loss, penalty) at each step's starting weights, float64
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), crit)

    def before_step(_):
        with torch.no_grad():
            out, _ = model.apply(model.get_parameters(), model.get_state(), xt, training=True)
            apart.append((float(crit._apply(out, yt)),
                          float(model.regularization_loss_tree(model.get_parameters()))))

    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(OPT_STEPS))
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            with _StepProbe(before_step) as probe:
                reset_counts()  # the main path starts here
                opt.optimize()
                _sync()
                counts = read_counts()  # the main path ends here
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    logged = [h["loss"] for h in opt.history]
    log(f"[13e] regularized LeNet-5 (L1L2Regularizer(1e-4, 5e-3) on every conv and linear "
        f"weight and bias), batch {batch}, f32, SGD 0.01/0.9: {len(logged)} steps; card {card}")
    for i, (loss, (c, pen)) in enumerate(zip(logged, apart), 1):
        rel = abs(loss - (c + pen)) / abs(loss)
        log(f"    step {i}: logged {loss:.6f} = criterion {c:.6f} + penalty {pen:.6f} "
            f"(|diff| {rel:.2g} of it, limit {REG_REL})")
        if not rel <= REG_REL or pen <= 0:
            raise AssertionError(f"[13e] step {i}: logged {loss} is not {c} + {pen}")
    if len(logged) != OPT_STEPS:
        raise AssertionError(f"[13e] {len(logged)} steps")
    _check_steps("[13e]", probe, OPT_STEPS, 2)
    del opt, model
    _free()
    return {"regularizers": counts}


def phase_optim(card):
    """[13] The recipe, the shift gradient, the optimizers, LBFGS and the
    regularizers; returns their main paths' launches and the shift A/B."""
    by_path, recipes = phase_recipe(card)
    counts, shift_rec = phase_shift(card)
    by_path.update(counts)
    by_path.update(phase_optimizers(card, recipes))
    del recipes
    _free()
    by_path.update(phase_lbfgs(card))
    by_path.update(phase_regularizers(card))
    return by_path, shift_rec


# [14] the Transformer's translation mode, rotary positions, decode cache and
# beam search (with the port's transformer example), SpatialDilatedConvolution
# under the fused-kernel switch and the dropout variants, at the LM's full
# width (bench.py:929-933: V 8192, H 512, 8 heads, filter 2048, 6 layers,
# T 2048, batch 8), bf16 compute and activations unless a phase says f32.
LM_WIDTH = {"vocab": 8192, "hidden": 512, "heads": 8, "filt": 2048, "layers": 6, "seq": 2048,
            "batch": 8}
# [14a] 24 records (3 iterations an epoch), 10 iterations; sources padded to
# lengths drawn from [1024, 2048]; postprocess and relu dropout 0.1,
# attention dropout 0 (the flash route). Per iteration 6 encoder self, 6
# decoder self and 6 cross attentions: 18 launches of each flash kernel.
TRANSLATION = {"records": 24, "iters": 10, "src_len": (1024, 2048)}
# [14a] kernel route (card, f32, TF32 off) vs plain route (CPU, f32) over 3
# Adam steps of a 2 + 2-block translation model (V 8192, H 512, batch 2, T
# 1024 so the card still takes the flash route, sources padded to lengths
# from [512, 1024], dropout off) from the same weights, at two seeds. The
# same f32 function with sums in other orders, through the same Adam as
# [9]'s norm-LM route, so [9]'s loss and update limits and their reasons
# hold (Adam steps a weight whose gradient is near zero by about lr either
# way, which moves the update far more than the losses; padded keys and
# query rows get exact zeros on both routes). [9]'s parameter limit (1.5e-4
# of ||p||) read 1.52e-4 here at the first seed, with the losses 6.8e-7 and
# the update 2.84e-3 apart: the update is 5.4% of ||p|| here against ~1% in
# [9], and ||p|| is not the scale of the drift: the update is, and the
# update's limit holds the parameters. Beside it each seed also runs the
# card's dense route (cuBLAS and torch softmax, no kernel), a second plain
# route, and logs its distance from the CPU: what f32 rounding through 3
# Adam steps of this model gives between two routes without the kernel.
TRANSLATION_ROUTE_TOL = {
    "loss_first": 1e-4,  # step 1, same weights: |loss_card - loss_cpu|
    "loss": 5e-5,        # steps 2-3: |loss_card - loss_cpu| / max(1, |loss_cpu|)
    "update": 2e-2,      # ||p_card - p_cpu|| / ||p_cpu - p0||
}
TRANSLATION_ROUTE_SEEDS = (SEED + 15, SEED + 20)
# [14b] decode-cache parity, f32 with TF32 off on the card: 64 decode_step_fn
# steps (a 1-row query against the cache, the dense route) against the same
# positions of one full T = 2048 forward (the flash route): fp32 sums in
# other orders through 6 blocks and the 512-term head (readings expected
# near 1e-5 on logits of unit scale); a key rotated twice, or at the wrong
# slot, moves the logits by O(1). |err| <= atol + rtol * |full|:
DECODE_TOL = (1e-3, 1e-3)
DECODE_STEPS = 64
# [14c] the example's arguments: the LM's full width, one epoch of 40
# planted-bigram sequences (the cut: --synthetic-size 40 * 2048 + 1 tokens,
# so 36 train at 4 iterations and 4 validate in one padded batch), then beam
# 4 over its 2 prompts for 32 steps.
EXAMPLE_ARGS = ["--vocab-size", "8192", "--seq-len", "2048", "--hidden-size", "512",
                "--num-layers", "6", "--num-heads", "8", "--batch-size", "8", "--max-epoch", "1",
                "--synthetic-size", str(40 * 2048 + 1), "--beam-size", "4", "--decode-len", "32"]
# [14c] the beam search on the card against the CPU, both f32 (TF32 off) from
# the same weights: equal sequences, scores within 1e-4 absolute + relative
# (a sum of 32 log-probabilities, each from fp32 logits that differ by sums
# in other orders, ~1e-6 each).
BEAM_SCORE_TOL = 1e-4
# [14d] DeepLab-v3's ASPP (Chen et al. 2017, arXiv 1706.05587): three 3x3
# branches of 256 outputs at dilation 6, 12 and 18 (padding = dilation) on
# an (8, 2048, 33, 33) bf16 input, activation relu, the switch on: per
# forward and backward 3 #8 and 3 #9b launches. Card vs CPU in f32 (TF32
# off) at batch 2, each branch and one SAME-padded case (dilation 6):
# ||card - cpu|| / ||cpu|| of y, dx, dw and db within 1e-4, fixed before the
# first run: fp32 sums of 18,432 products in other orders (cuDNN's
# algorithms, the CPU's), ~1e-6 relative, and ReLU gates near zero that such
# differences flip.
ASPP = {"shape": (8, 2048, 33, 33), "out": 256, "dilations": (6, 12, 18), "route_batch": 2}
ASPP_ROUTE_REL = 1e-4
# [14e] the dropout variants on the card, f32, p = 0.3: kept cells within 5
# binomial standard deviations of 1 - p; the Gaussian variants' mean and
# standard deviation within 5 standard errors.
DROPOUT_P = 0.3


def translation_model(layers: int, device, dropout=(0.1, 0.0, 0.1), **kw):
    from bigdl_tpu_torch.nn import Transformer

    w = LM_WIDTH
    return Transformer(w["vocab"], w["hidden"], w["heads"], w["filt"], layers, *dropout,
                       mode="translation", device=device, **kw)


def _translation_data(n: int, seq: int, lo: int, hi: int, seed: int):
    """(src, tgt, labels, lengths): targets the planted-bigram stream and its
    next tokens; sources the next n * seq tokens of the stream, trailing
    padded with id 0 to lengths drawn from [lo, hi]."""
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids

    stream = planted_bigram_ids(2 * n * seq + 1, LM_WIDTH["vocab"], seed=seed)
    tgt, y = stream[:n * seq].reshape(n, seq), stream[1:n * seq + 1].reshape(n, seq)
    src = stream[n * seq:2 * n * seq].reshape(n, seq).copy()
    lengths = _src_lengths(n, lo, hi, seed)
    for i, length in enumerate(lengths):
        src[i, length:] = 0
    return src, tgt, y, lengths


def _flash_want(per_step: int, counts) -> dict:
    return {n: (per_step if n.startswith("flash_attention") else 0) for n in counts}


def _lm_criterion():
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, TimeDistributedCriterion

    return TimeDistributedCriterion(CrossEntropyCriterion(), size_average=True)


def phase_translation(card):
    """[14a] Train the full-width translation model through LocalOptimizer on
    Table [src, tgt] batches; returns its launches, the trained model and
    the sources (for [14c]'s SequenceBeamSearch)."""
    import statistics

    import numpy as np
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.table import T

    w, c = LM_WIDTH, TRANSLATION
    batch, seq, iters, layers = w["batch"], w["seq"], c["iters"], w["layers"]
    src, tgt, y, lengths = _translation_data(c["records"], seq, *c["src_len"], SEED + 14)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    RandomGenerator.set_seed(SEED)
    try:
        model = translation_model(layers, "cuda")
        opt = LocalOptimizer(model, DataSet.array(T(src, tgt), y, batch_size=batch),
                             _lm_criterion())
        opt.set_optim_method(Adam(learningrate=1e-3)).set_end_when(Trigger.max_iteration(iters))
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            t0 = time.perf_counter()
            opt.optimize()
            _sync()
            wall = time.perf_counter() - t0
            counts = read_counts()  # the main path ends here
        hist = opt.history
        losses = [h["loss"] for h in hist]
        step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3
        # an epoch is 3 iterations here and the gap that closes one reads
        # ~0.5 ms (the one-step-late pull meets the epoch's end), so 3 of the
        # median's 8 gaps are near 0; beside it, the mean gap over the whole
        # epochs after the first (iterations 4-9), where no gap is cut off
        per_epoch = c["records"] // batch
        whole, span = (per_epoch + 1, iters // per_epoch * per_epoch), "whole epochs"
        if whole[1] < whole[0]:
            whole, span = (3, iters), "no whole epoch after the first"
        mean_ms = statistics.fmean(h["wall_s"] for h in hist[whole[0] - 1:whole[1]]) * 1e3
        log(f"[14a] translation Transformer ({model.n_parameters() / 1e6:.1f} M params: "
            f"{layers} + {layers} blocks, V {w['vocab']}, H {w['hidden']}, {w['heads']} heads, "
            f"filter {w['filt']}, one shared embedding) trained through LocalOptimizer on "
            f"{c['records']} Table [src, tgt] records of T {seq} (source lengths "
            f"{min(lengths)}-{max(lengths)}, pad_masking='lengths'), batch {batch}, bf16 "
            f"compute and activations, Adam 1e-3: {len(hist)} iterations in {wall:.2f} s; step "
            f"{step_ms:.2f} ms (median of iterations 3-{iters}; mean of iterations "
            f"{whole[0]}-{whole[1]}, {span}, {mean_ms:.2f}), "
            f"{batch * seq / step_ms * 1e3:.0f} target tokens/s; card {card}")
        log("    losses: " + ", ".join(f"{v:.4f}" for v in losses))
        if len(hist) != iters or not all(np.isfinite(losses)):
            raise AssertionError(f"[14a]: {len(hist)} iterations, losses {losses}")
        per_step = 3 * layers
        _check_launch_steps("[14a]", probe, iters, _flash_want(per_step, counts), mem_from=3)
        log(f"    launches: {_nonzero(counts)} (expected {per_step} of each flash kernel an "
            f"iteration = {per_step * iters}, nothing else)")
        if counts != _flash_want(per_step * iters, counts):
            raise AssertionError(f"[14a] launched {counts}")
        busy = _busy_share(opt, 2)
        log(f"    busy share (2 more iterations under torch.profiler): device {busy[0]:.2f} ms "
            f"of {busy[1]:.2f} ms a step under the profiler ({100 * busy[2]:.1f}% busy, a "
            f"floor: the profiler slows the host); device ms over the unprofiled step "
            f"{busy[0]:.2f} / {step_ms:.2f} = {100 * busy[0] / step_ms:.1f}%; iteration walls "
            f"ms " + ", ".join(f"{h['wall_s'] * 1e3:.2f}" for h in hist) + f"; card {card}")
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
    del opt
    _free()
    _translation_routes()
    return counts, model, src


def _translation_routes():
    """[14a] 3 Adam steps of an f32 2 + 2-block translation model on the card
    (the flash kernels), on the card's dense route (no kernel) and on the
    CPU (the dense route), from one set of weights, at each seed of
    TRANSLATION_ROUTE_SEEDS."""
    for seed in TRANSLATION_ROUTE_SEEDS:
        _translation_route(seed)


def _translation_route(seed):
    import os

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params
    from bigdl_tpu_torch.utils.table import T

    layers, batch, seq = 2, 2, 1024
    src, tgt, y, lengths = _translation_data(batch, seq, 512, 1024, seed)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            os.environ.get("BIGDL_ATTN_IMPL"))
    Engine.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        RandomGenerator.set_seed(seed)
        init = translation_model(layers, "cpu", dropout=(0.0, 0.0, 0.0))
        init.init(sample_input=[src, tgt])
        w0 = {k: v.detach().numpy().copy() for k, v in init.named_parameters()}
        del init
        runs = {}
        for route, device, impl in (("card", "cuda", "auto"), ("dense", "cuda", "dense"),
                                    ("cpu", "cpu", "auto")):
            os.environ["BIGDL_ATTN_IMPL"] = impl
            m = translation_model(layers, device, dropout=(0.0, 0.0, 0.0))
            m.init(sample_input=[src, tgt])
            load_jax_params(m, _nest(w0))
            o = LocalOptimizer(m, DataSet.array(T(src, tgt), y, batch_size=batch),
                               _lm_criterion())
            o.set_optim_method(Adam(learningrate=1e-3))
            reset_counts()
            t0 = time.perf_counter()
            o.set_end_when(Trigger.max_iteration(3)).optimize()
            _sync()
            runs[route] = ([h["loss"] for h in o.history], _tree_to_numpy(m.get_parameters()),
                           read_counts(), time.perf_counter() - t0)
            del m, o
            _free()
    finally:
        Engine.set_compute_dtype(None)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        if prev[2] is None:
            os.environ.pop("BIGDL_ATTN_IMPL", None)
        else:
            os.environ["BIGDL_ATTN_IMPL"] = prev[2]
    (lc, pc, kc, tc), (ld, pd, kd, td), (lp, pp, kp, tp) = (
        runs["card"], runs["dense"], runs["cpu"])

    def dist(a, b):
        return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b)))

    p_norm = dist(pp, {k: np.zeros_like(v) for k, v in pp.items()})
    d_first = abs(lc[0] - lp[0])
    d_loss = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lc[1:], lp[1:]))
    d_card, d_dense = dist(pc, pp), dist(pd, pp)
    d_update = d_card / dist(pp, w0)
    want_card = _flash_want(3 * 3 * layers, kc)
    tol = TRANSLATION_ROUTE_TOL
    # where the routes part: each leaf's share of ||p_card - p_cpu||^2, and the
    # share held by elements whose update has opposite signs on the two routes
    d2 = {k: float(np.sum((pc[k] - pp[k]) ** 2)) for k in pp}
    total = max(sum(d2.values()), 1e-300)
    flips = {k: np.sign(pc[k] - w0[k]) != np.sign(pp[k] - w0[k]) for k in pp}
    flip = sum(float(np.sum(((pc[k] - pp[k]) ** 2)[flips[k]])) for k in pp)
    n_flip = sum(int(flips[k].sum()) for k in pp)
    top = sorted(d2, key=d2.get, reverse=True)[:4]
    log(f"    seed {seed}, where the kernel and plain routes part: {n_flip} of "
        f"{sum(v.size for v in pp.values())} weights moved the other way and hold "
        f"{flip / total:.1%} of ||p_card - p_cpu||^2; by leaf "
        + ", ".join(f"{k} {d2[k] / total:.1%}" for k in top)
        + f"; ||update|| / ||p_cpu|| {dist(pp, w0) / p_norm:.3f}")
    log(f"    kernel route (card, f32, TF32 off) vs plain route (CPU, f32), translation "
        f"{layers} + {layers} blocks, batch {batch}, T {seq}, seed {seed}, source lengths "
        f"{lengths}, 3 Adam steps: losses {[round(v, 6) for v in lc]} vs "
        f"{[round(v, 6) for v in lp]} (card dense route {[round(v, 6) for v in ld]}); step 1 "
        f"diff {d_first:.2e} (tol {tol['loss_first']}), steps 2-3 rel diff {d_loss:.2e} (tol "
        f"{tol['loss']}); update rel diff {d_update:.2e} (tol {tol['update']}); "
        f"||p - p_cpu|| / ||p_cpu||: kernel route {d_card / p_norm:.3e}, card dense route "
        f"{d_dense / p_norm:.3e} (the witness), kernel vs card dense {dist(pc, pd) / p_norm:.3e}; "
        f"kernel / witness {d_card / max(d_dense, 1e-300):.2f}; launches card "
        f"{_nonzero(kc)}, card dense {sum(kd.values())}, CPU {sum(kp.values())}; {tc:.1f} s "
        f"card, {td:.1f} s card dense, {tp:.1f} s CPU")
    if (any(len(r[0]) != 3 for r in runs.values()) or kc != want_card or any(kd.values())
            or any(kp.values()) or d_first > tol["loss_first"] or d_loss > tol["loss"]
            or d_update > tol["update"]):
        raise AssertionError(f"the kernel route's translation training disagrees with the "
                             f"plain route (seed {seed})")


def phase_rope(card):
    """[14b] 3 training steps of the full-width rotary LM, then decode-cache
    parity; returns the launches of both paths."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    w = LM_WIDTH
    batch, seq, layers = w["batch"], w["seq"], w["layers"]
    ids = planted_bigram_ids(3 * batch * seq + 1, w["vocab"], seed=SEED + 16)
    x, y = ids[:-1].reshape(3 * batch, seq), ids[1:].reshape(3 * batch, seq)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    RandomGenerator.set_seed(SEED + 16)
    try:
        model = Transformer(w["vocab"], w["hidden"], w["heads"], w["filt"], layers, 0.1, 0.0,
                            0.1, mode="lm", position_encoding="rope", device="cuda")
        opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), _lm_criterion())
        opt.set_optim_method(Adam(learningrate=1e-3)).set_end_when(Trigger.max_iteration(3))
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            opt.optimize()
            _sync()
            counts = read_counts()  # the main path ends here
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
    losses = [h["loss"] for h in opt.history]
    log(f"[14b] rotary LM ({model.n_parameters() / 1e6:.1f} M params, {layers} layers, "
        f"position_encoding='rope') trained 3 steps through LocalOptimizer, batch {batch} x "
        f"{seq}, bf16: losses {', '.join(f'{v:.4f}' for v in losses)}; launches "
        f"{_nonzero(counts)} (expected {layers} of each flash kernel a step); card {card}")
    _check_launch_steps("[14b]", probe, 3, _flash_want(layers, counts), mem_from=3)
    if not all(np.isfinite(losses)) or counts != _flash_want(3 * layers, counts):
        raise AssertionError(f"[14b] losses {losses}, launches {counts}")
    del opt

    # decode-cache parity, f32 with TF32 off
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model.eval()
        ids2 = torch.as_tensor(x[:2], device="cuda")
        with torch.no_grad():
            reset_counts()  # the decode path starts here
            full = model.forward(ids2)
            _sync()
            full_counts = read_counts()
            fn = model.decode_step_fn(model.get_parameters(), max_len=seq)
            cache, steps = model.init_decode_cache(2), []
            t0 = time.perf_counter()
            for i in range(DECODE_STEPS):
                logits, cache = fn(ids2[:, :i + 1], i, cache)
                steps.append(logits)
            _sync()
            step_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
            path_counts = read_counts()  # the decode path ends here
            decode_counts = _diff(path_counts, full_counts)
    finally:
        Engine.set_compute_dtype(None)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    got, want = torch.stack(steps, dim=1), full[:, :DECODE_STEPS]
    err = (got - want).abs()
    atol, rtol = DECODE_TOL
    ok = bool((err <= atol + rtol * want.abs()).all()) and bool(torch.isfinite(got).all())
    log(f"    decode-cache parity (f32, TF32 off): {DECODE_STEPS} decode_step_fn steps vs "
        f"positions 0-{DECODE_STEPS - 1} of one full T={seq} forward, batch 2: max |err| "
        f"{err.max().item():.3e} (|err| <= {atol} + {rtol}*|full|) {'ok' if ok else 'FAIL'}; "
        f"full forward launches {_nonzero(full_counts)} (expected flash_attention_fwd "
        f"{layers}), decode launches {_nonzero(decode_counts)} (expected none: Tq = 1 routes "
        f"dense); {step_ms:.2f} ms a decode step (batch 2, f32); cache "
        f"{tuple(cache['block0']['k'].shape)} {str(cache['block0']['k'].dtype)[6:]}")
    if not ok or any(decode_counts.values()) or full_counts != {
            n: (layers if n == "flash_attention_fwd" else 0) for n in full_counts}:
        raise AssertionError("[14b] the decode cache disagrees with the full forward, or a "
                             "path launched other kernels")
    del model
    _free()
    return {"rope_lm": counts, "rope_decode": path_counts}


def _cpu_twin(model, sample):
    """An f32 CPU copy of ``model`` (the same class and arguments) holding
    its weights."""
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.utils.convert import load_jax_params

    m = Transformer(model.vocab_size, model.hidden_size, model.num_heads, model.filter_size,
                    model.num_hidden_layers, model.postprocess_dropout,
                    model.attention_dropout, model.relu_dropout, mode=model.mode,
                    position_encoding=model.position_encoding, norm=model.norm, device="cpu")
    m.init(sample_input=sample)
    load_jax_params(m, _nest(_tree_to_numpy(model.get_parameters())))
    return m.eval()


def phase_example(card, trans_model, src):
    """[14c] The port's transformer example through its ``main()``, its beam
    search timed and held against the CPU's, and SequenceBeamSearch over
    [14a]'s trained translation model; returns the paths' launches."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.examples import transformer_train
    from bigdl_tpu_torch.nn import SequenceBeamSearch

    Engine.set_compute_dtype(None)  # the example's policy, as in a fresh process
    Engine.set_activation_dtype(None)
    t0 = time.perf_counter()
    with _StepProbe() as probe:
        reset_counts()  # the main path starts here
        run = transformer_train.main(EXAMPLE_ARGS)
        _sync()
        counts = read_counts()  # the main path ends here
    wall = time.perf_counter() - t0
    args, hist = run.args, run.optimizer.history
    losses = [h["loss"] for h in hist]
    layers, n_steps = args.num_layers, len(probe.steps)
    n_seq = (args.synthetic_size - 1) // args.seq_len
    want_steps = int(0.9 * n_seq) // args.batch_size  # the example's 90% training split
    log(f"[14c] transformer_train.main({' '.join(EXAMPLE_ARGS)}): {n_steps} iterations in "
        f"{wall:.2f} s (data, build, validation and decode included), losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; validations "
        f"{[(v['results'], v['launches']) for v in probe.validations]}; launches "
        f"{_nonzero(counts)}; compute {Engine.compute_dtype()}; card {card}")
    val_launches = [v["launches"] for v in probe.validations]
    _check_launch_steps("[14c]", probe, want_steps, _flash_want(layers, counts), mem_from=2)
    if (not all(np.isfinite(losses)) or val_launches != [layers]
            or counts != {n: (layers * (n_steps + 1) if n == "flash_attention_fwd"
                              else layers * n_steps if n.startswith("flash_attention")
                              else 0) for n in counts}):
        raise AssertionError(f"[14c] losses {losses}, validation launches {val_launches}, "
                             f"launches {counts}")
    seqs, scores = run.sequences, run.scores
    log(f"    beam {args.beam_size} over prompts {run.prompts.tolist()}, {args.decode_len} "
        f"steps: sequences {tuple(seqs.shape)}, beam-0 {seqs[:, 0].tolist()}, scores "
        f"{[[round(float(s), 4) for s in row] for row in scores]}")
    if (tuple(seqs.shape) != (2, args.beam_size, args.decode_len + 1)
            or not bool(torch.isfinite(scores).all())
            or not bool((scores[:, :-1] >= scores[:, 1:]).all())):
        raise AssertionError("[14c] beam search output malformed")
    # the decode path again, timed and counted
    reset_counts()  # the decode path starts here
    t0 = time.perf_counter()
    seqs2, _ = transformer_train.beam_search(run.model, run.prompts, args)
    _sync()
    decode_ms = (time.perf_counter() - t0) / args.decode_len * 1e3
    decode_counts = read_counts()  # the decode path ends here
    log(f"    decode: {decode_ms:.2f} ms a step (beam {args.beam_size} x 2 prompts, cache to "
        f"{args.decode_len} positions, {Engine.compute_dtype()} compute), launches "
        f"{_nonzero(decode_counts)} (expected none: Tq = 1 routes dense); the same sequences "
        f"again: {bool(torch.equal(seqs2, seqs))}; card {card}")
    if any(decode_counts.values()):
        raise AssertionError(f"[14c] the decode launched {decode_counts}")
    # the same beam search, f32, on the card and on the CPU from the same weights
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card_out = transformer_train.beam_search(run.model, run.prompts, args)
        t0 = time.perf_counter()
        cpu_model = _cpu_twin(run.model, run.x[:1, :1])
        cpu_out = transformer_train.beam_search(cpu_model, run.prompts.cpu(), args)
        cpu_s = time.perf_counter() - t0
    finally:
        Engine.set_compute_dtype(None)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    same = torch.equal(card_out[0].cpu(), cpu_out[0])
    d_scores = (card_out[1].cpu() - cpu_out[1]).abs()
    ok = same and bool((d_scores <= BEAM_SCORE_TOL * (1 + cpu_out[1].abs())).all())
    log(f"    beam search card vs CPU (f32, TF32 off, same weights): sequences equal {same}, "
        f"max |score diff| {d_scores.max().item():.3e} (tol {BEAM_SCORE_TOL} abs + rel); "
        f"CPU {cpu_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[14c] the card's beam search disagrees with the CPU's")
    del run, cpu_model
    _free()
    # SequenceBeamSearch in translation mode over [14a]'s trained model
    layer = SequenceBeamSearch(trans_model, beam_size=4, max_decode_length=16)
    trans_model.eval()
    reset_counts()  # the translation beam path starts here
    t0 = time.perf_counter()
    tseqs, tscores = layer.forward(src[:2])
    _sync()
    beam_s = time.perf_counter() - t0
    beam_counts = read_counts()  # the translation beam path ends here
    log(f"    SequenceBeamSearch (translation, [14a]'s model, 2 sources of lengths "
        f"{[int((r != 0).sum()) for r in src[:2]]}, beam 4, 16 steps): sequences "
        f"{tuple(tseqs.shape)}, beam-0 {tseqs[:, 0].tolist()}, scores "
        f"{[[round(float(s), 4) for s in row] for row in tscores]}; {beam_s:.2f} s (the "
        f"encoder's padding bias routes it dense); launches {_nonzero(beam_counts)}")
    if (tuple(tseqs.shape) != (2, 4, 17) or not bool(torch.isfinite(tscores).all())
            or not bool((tscores[:, :-1] >= tscores[:, 1:]).all())
            or any(beam_counts.values())):
        raise AssertionError("[14c] SequenceBeamSearch output malformed or launched a kernel")
    return {"transformer_example": counts, "transformer_example_decode": decode_counts,
            "translation_beam": beam_counts}


def aspp(batch_shape, dilations, out, device, same=False):
    """DeepLab-v3's atrous branches: a Concat of 3x3 SpatialDilatedConvolution
    s at ``dilations`` (padding = dilation, or SAME), relu epilogues."""
    from bigdl_tpu_torch import nn

    cin = batch_shape[1]
    m = nn.Concat(2, device=device)
    for d in dilations:
        pad = -1 if same else d
        m.add(nn.SpatialDilatedConvolution(cin, out, 3, 3, 1, 1, pad, pad, dilation_w=d,
                                           dilation_h=d, activation="relu", device=device)
              .set_name(f"aspp_d{d}{'_same' if same else ''}"))
    return m


def phase_aspp(card):
    """[14d] The ASPP branches forward and backward under the switch (3 #8
    and 3 #9b launches), then card vs CPU in f32 at batch 2."""
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator

    a = ASPP
    prev = (Engine.compute_dtype(), Engine.activation_dtype(), Engine._fused_kernels)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(True)
    try:
        RandomGenerator.set_seed(SEED + 17)
        g = torch.Generator(device="cuda").manual_seed(SEED + 17)
        x = _rand(a["shape"], torch.bfloat16, g).requires_grad_(True)
        model = aspp(a["shape"], a["dilations"], a["out"], "cuda")
        model.init(sample_input=x)  # builds each branch from an eval forward
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() == 1:
                    p.normal_(0.0, 0.1, generator=g)  # a bias the epilogue can see
        dy = _rand((a["shape"][0], a["out"] * 3) + a["shape"][2:], torch.bfloat16, g)
        reset_counts()  # the main path starts here
        y = model.forward(x)
        y.backward(dy)
        _sync()
        counts = read_counts()  # the main path ends here

        def step():
            model.forward(x).backward(dy)

        ms = cuda_ms(step, iters=10)
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        Engine.set_fused_kernels(prev[2])
    n_br = len(a["dilations"])
    want = {n: (n_br if n in ("bias_act_fwd", "bias_act_bwd_row") else 0) for n in counts}
    finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(x.grad).all()) and all(
        bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    log(f"[14d] ASPP (DeepLab-v3, arXiv 1706.05587): {n_br} SpatialDilatedConvolution 3x3 "
        f"branches {a['shape'][1]} -> {a['out']} at dilations {a['dilations']} (padding = "
        f"dilation), relu epilogues, on {a['shape']} bf16, switch on: y {tuple(y.shape)} "
        f"{str(y.dtype)[6:]}, finite {finite}; launches {_nonzero(counts)} (expected "
        f"{_nonzero(want)}); forward + backward {ms:.2f} ms; card {card}")
    if counts != want or not finite:
        raise AssertionError(f"[14d] launched {counts} or non-finite")
    del model, x, y, dy
    _free()
    _aspp_routes()
    return counts


def _aspp_routes():
    """[14d] card (cuDNN, #8/#9b) vs CPU (plain versions), f32 with TF32 off,
    at batch 2: each ASPP branch and one SAME-padded branch."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.utils.convert import load_jax_params

    a = ASPP
    shape = (a["route_batch"],) + a["shape"][1:]
    rng = np.random.default_rng(SEED + 18)
    x = rng.standard_normal(shape).astype(np.float32)
    prev = (Engine._fused_kernels, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_fused_kernels(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dilations, same in ((a["dilations"], False), ((6,), True)):
            RandomGenerator.set_seed(SEED + 18)
            models = {d: aspp(shape, dilations, a["out"], d, same=same) for d in ("cuda", "cpu")}
            for m in models.values():
                m.init(sample_input=x)
            w0 = {k: v.detach().numpy().copy() for k, v in models["cpu"].named_parameters()}
            for k in w0:
                if w0[k].ndim == 1:
                    w0[k] = rng.normal(0.0, 0.1, w0[k].shape).astype(np.float32)
            dy = rng.standard_normal((shape[0], a["out"] * len(dilations)) + shape[2:]).astype(
                np.float32)
            outs = {}
            for device, m in models.items():
                load_jax_params(m, _nest(w0))
                xt = torch.from_numpy(x).to(device).requires_grad_(True)
                reset_counts()
                y = m.forward(xt)
                y.backward(torch.from_numpy(dy).to(device))
                _sync()
                outs[device] = ({"y": y.detach().cpu(), "dx": xt.grad.cpu(),
                                 **{n: p.grad.cpu() for n, p in m.named_parameters()}},
                                read_counts())
            (card_t, kc), (cpu_t, kp) = outs["cuda"], outs["cpu"]
            rel = {k: float((card_t[k] - cpu_t[k]).norm() / cpu_t[k].norm()) for k in cpu_t}
            n_br = len(dilations)
            want = {n: (n_br if n in ("bias_act_fwd", "bias_act_bwd_row") else 0) for n in kc}
            worst = max(rel, key=rel.get)
            log(f"    card vs CPU (f32, TF32 off, batch {shape[0]}), dilations {dilations}"
                f"{' SAME' if same else ''}: y {tuple(card_t['y'].shape)}, ||card - cpu|| / "
                f"||cpu|| y {rel['y']:.2e}, dx {rel['dx']:.2e}, worst {worst} {rel[worst]:.2e} "
                f"(tol {ASPP_ROUTE_REL}); launches card {_nonzero(kc)}, CPU {sum(kp.values())}")
            if max(rel.values()) > ASPP_ROUTE_REL or kc != want or any(kp.values()):
                raise AssertionError(f"[14d] the card's dilated convolutions disagree with the "
                                     f"CPU's ({dilations}, same={same})")
            del outs, models
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_fused_kernels(prev[0])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[1:]


def phase_dropout_variants(card):
    """[14e] The dropout variants on the card in train and eval mode."""
    import torch
    from bigdl_tpu_torch import nn

    p = DROPOUT_P
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    reset_counts()  # the main path starts here
    results = []
    for name, shape, spans in (("SpatialDropout1D", (64, 256, 512), (1,)),
                               ("SpatialDropout2D", (64, 256, 33, 33), (2, 3)),
                               ("SpatialDropout3D", (16, 256, 8, 8, 8), (2, 3, 4))):
        x = torch.rand(shape, generator=g, device="cuda") + 0.5  # no zeros
        m = getattr(nn, name)(p, device="cuda")
        y = m.apply({}, {}, x, training=True, rng=torch.Generator().manual_seed(SEED))[0]
        keep_dims = [d for d in range(x.dim()) if d not in spans]
        cells = y.permute(*keep_dims, *spans).reshape(-1, int(torch.tensor(
            [shape[d] for d in spans]).prod()))
        xc = x.permute(*keep_dims, *spans).reshape(cells.shape)
        kept = (cells != 0).any(dim=1)
        whole = bool(torch.equal((cells != 0).all(dim=1), kept))
        scaled = bool(torch.allclose(cells[kept], xc[kept] / (1 - p), rtol=1e-6, atol=0))
        share, n = kept.float().mean().item(), kept.numel()
        bound = 5 * ((p * (1 - p) / n) ** 0.5)
        m.eval()
        ident = torch.equal(m.forward(x), x)
        ok = (whole and scaled and abs(share - (1 - p)) < bound and ident
              and y.device == x.device)
        results.append(ok)
        log(f"[14e] {name}({p}) on {shape} f32: kept share {share:.4f} of {n} cells (1 - p = "
            f"{1 - p}, 5-sigma bound {bound:.4f}), whole cells dropped {whole}, kept scaled by "
            f"1/(1-p) {scaled}, eval identity {ident} {'ok' if ok else 'FAIL'}")
    for name, arg in (("GaussianNoise", 0.5), ("GaussianDropout", p)):
        x = torch.full((4096, 4096), 2.0, device="cuda")
        m = getattr(nn, name)(arg, device="cuda")
        y = m.apply({}, {}, x, training=True, rng=torch.Generator().manual_seed(SEED))[0]
        z = (y - x) if name == "GaussianNoise" else y / x - 1.0
        std = arg if name == "GaussianNoise" else (arg / (1 - arg)) ** 0.5
        n = z.numel()
        mean, sd = z.double().mean().item(), z.double().std().item()
        m.eval()
        ident = torch.equal(m.forward(x), x)
        ok = (abs(mean) < 5 * std / n ** 0.5 and abs(sd - std) < 5 * std / (2 * n) ** 0.5
              and ident)
        results.append(ok)
        log(f"[14e] {name}({arg}) on (4096, 4096) f32: noise mean {mean:.2e} (bound "
            f"{5 * std / n ** 0.5:.2e}), std {sd:.5f} (expected {std:.5f} +- "
            f"{5 * std / (2 * n) ** 0.5:.5f}), eval identity {ident} {'ok' if ok else 'FAIL'}")
    _sync()
    counts = read_counts()  # the main path ends here
    if not all(results) or any(counts.values()):
        raise AssertionError(f"[14e] a dropout variant failed its check, or a kernel "
                             f"launched: {counts}")
    return counts


def phase_attention_slice(card):
    """[14] Translation, rotary LM, the example and beam search, ASPP and the
    dropout variants; returns their main paths' launches."""
    counts, trans_model, src = phase_translation(card)
    by_path = {"translation": counts}
    by_path.update(phase_rope(card))
    by_path.update(phase_example(card, trans_model, src))
    del trans_model
    _free()
    by_path["aspp"] = phase_aspp(card)
    by_path["dropout_variants"] = phase_dropout_variants(card)
    return by_path


# [15] the rest of models/: AlexNet, NeuralCF, PTBModel, the Autoencoder and
# CNNTextClassifier, each at the size its users run, trained through the
# port's examples (bigdl_tpu_torch/examples/*_train.py, the counterparts of
# examples/{alexnet,ncf,ptb,autoencoder}/train.py) or LocalOptimizer, with
# the port's card policy (bf16 products, f32 activations) as a fresh
# process has it. Only AlexNet runs a kernel of this repo: #10 at its three
# pools (3x3/s2 without padding on 55-, 27- and 13-wide planes).
MODELS_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes below
ALEXNET_ARGS = ["--max-epoch", "1", "--synthetic-size", "640"]  # cut: records (default 256)
ALEXNET_POOLS_PER_STEP = 3
NCF_ARGS = []  # the example's defaults: 4096 synthetic positives, 2 epochs
ML1M = {"n_users": 6040, "n_items": 3952}  # MovieLens-1M's table sizes
NCF_ML1M_EPOCHS = 1
PTB_ARGS = ["--vocab-size", "10000"]  # PTB's vocabulary; hidden 200, 2 layers, T 35, batch 32
AUTOENCODER_ARGS = []  # the example's defaults: 4096 images, batch 128, 2 epochs
# the reference text-classification example's sizes; the model's widths its defaults
CNNTEXT = {"vocab": 20000, "seq": 1000, "batch": 128, "classes": 20, "iters": 10}
# Card-vs-CPU routes: 3 f32 steps at a cut size from one set of weights
# (label -> rows of the route's batch). Their limits, fixed before the first
# run: AlexNet is VGG-16's kind (ReLU convolutions, no BN, #10 at its pools,
# fc weights dominating the parameters' norm) and the CNN text classifier
# a smaller one (ReLU temporal convolutions, torch's max pools), both SGD:
# VGG_ROUTE_TOL, whose readings on VGG-16 sat 25x or more under it.
# NeuralCF, PTBModel and the Autoencoder train with Adam, whose first step
# moves every weight that has a gradient by the rate, whatever the
# gradient's size: a gradient entry at f32 noise on both routes (a sum that
# cancels) may step either way, and its weight then parts by twice the
# rate. So their parameters are held at 1e-4 of their norm (the
# Autoencoder's 52,000 weights at lr 0.01 have a norm of ~16: one such
# entry moves it by ~1e-3 of that, NeuralCF's and PTB's norms are ~100x
# larger) and their update at 5e-2 (a few such entries); losses as VGG-16's.
MODEL_ROUTE_ROWS = {"alexnet": 4, "ncf": 256, "ptb": 4, "autoencoder": 32, "cnntext": 4}
ADAM_ROUTE_TOL = {"loss_first": 1e-4, "loss": 1e-3, "params": 1e-4, "update": 5e-2}
MODEL_ROUTE_TOL = {"alexnet": VGG_ROUTE_TOL, "cnntext": VGG_ROUTE_TOL, "ncf": ADAM_ROUTE_TOL,
                   "ptb": ADAM_ROUTE_TOL, "autoencoder": ADAM_ROUTE_TOL}


def _example_argv(args):
    return list(args) + (["--platform", "cpu"] if MODELS_DEVICE == "cpu" else [])


def _models_device():
    """The device argument of [15]'s own models: the card's default."""
    return "cpu" if MODELS_DEVICE == "cpu" else None


def _run_example(module, args, label):
    """``module.main(args)`` under a ``_StepProbe`` with the counts set to 0
    just before it and read just after; returns (run, probe, counts, wall)."""
    from bigdl_tpu_torch import Engine

    Engine.set_compute_dtype(None)  # the example's policy, as in a fresh process
    Engine.set_activation_dtype(None)
    Engine.set_fused_kernels(None)
    t0 = time.perf_counter()
    with _StepProbe() as probe:
        reset_counts()  # the main path starts here
        run = module.main(_example_argv(args))
        _sync()
        counts = read_counts()  # the main path ends here
    wall = time.perf_counter() - t0
    hist = run.optimizer.history
    losses = [h["loss"] for h in hist]
    log(f"    {label}: {len(hist)} iterations in {wall:.2f} s (data, build, validations and "
        f"the final evaluation included); launches {_nonzero(counts)}")
    log("    losses: " + ", ".join(f"{v:.4f}" for v in losses))
    return run, probe, counts, wall


def _step_ms(hist, batch, unit, card):
    """The median gap between loss pulls over iterations 3 on, and the rate."""
    import statistics

    step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3
    log(f"    step {step_ms:.2f} ms (median of iterations 3-{len(hist)}), "
        f"{batch / step_ms * 1e3:.1f} {unit}/s (batch {batch}); card {card}")
    return step_ms


def _check_no_launch_run(label, probe, counts, losses, n_steps, want_validations=None):
    """Finite losses, no kernel launched anywhere in the run, memory flat."""
    import numpy as np

    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: {len(losses)} iterations (expected {n_steps}), "
                             f"losses {losses}")
    _check_steps(label, probe, n_steps, 0, want_validations)
    if any(counts.values()):
        raise AssertionError(f"{label} launched {_nonzero(counts)}")


def phase_alexnet(card):
    """[15a] AlexNet through ``alexnet_train.main`` at the example's recipe
    (1000 classes, 227x227, batch 64, SGD 0.01 momentum 0.9, one epoch,
    validation on; 640 records): #10 three times a step and never in the
    validation, memory flat, the step's busy share; then card vs CPU."""
    import numpy as np
    from bigdl_tpu_torch.examples import alexnet_train
    from bigdl_tpu_torch.models import AlexNet

    run, probe, counts, _ = _run_example(alexnet_train, ALEXNET_ARGS,
                                         f"[15a] alexnet_train.main({' '.join(ALEXNET_ARGS)})")
    args, opt = run.args, run.optimizer
    split = max(args.batch_size, int(0.75 * args.synthetic_size))
    n_steps = args.max_epoch * (split // args.batch_size)
    log(f"    AlexNet {run.model.n_parameters() / 1e6:.3f} M params, {args.class_num} classes, "
        f"{split} training records of 3x227x227 at batch {args.batch_size}, "
        f"{args.synthetic_size - split} validation records")
    _step_ms(opt.history, args.batch_size, "images", card)
    _check_steps("[15a]", probe, n_steps, ALEXNET_POOLS_PER_STEP, want_validations=args.max_epoch)
    for v in probe.validations:
        top1, top5 = v["results"]["Top1Accuracy"], v["results"]["Top5Accuracy"]
        log(f"    validation: Top-1 {top1[0]:.4f}, Top-5 {top5[0]:.4f} (n={top1[1]}), kernel "
            f"launches {v['launches']}")
        if not (0 <= top1[0] <= top5[0] <= 1) or top1[1] != args.synthetic_size - split:
            raise AssertionError(f"[15a] validation {v}")
    want = ALEXNET_POOLS_PER_STEP * n_steps
    log(f"    maxpool2d_bwd launches {counts['maxpool2d_bwd']} ({ALEXNET_POOLS_PER_STEP} a step "
        f"x {n_steps}, 0 in the validation); others {sum(counts.values()) - counts['maxpool2d_bwd']}")
    if counts["maxpool2d_bwd"] != want or sum(counts.values()) != want:
        raise AssertionError(f"[15a] launches {counts}")
    losses = [h["loss"] for h in opt.history]
    if len(losses) != n_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"[15a] losses {losses}")
    if MODELS_DEVICE == "cuda":
        busy = _busy_share(opt, 2)
        log(f"    busy share (2 more iterations under torch.profiler): device {busy[0]:.2f} ms "
            f"of {busy[1]:.2f} ms a step under the profiler ({100 * busy[2]:.1f}% busy); "
            f"card {card}")
    del run, opt
    _free()
    x, y = alexnet_train.synthetic_images(MODEL_ROUTE_ROWS["alexnet"], 1000)
    r = _sgd_routes(lambda device: AlexNet(1000, has_dropout=False, device=device), x, y,
                    SEED + 21)
    _check_routes("AlexNet (dropout off)", x, r, MODEL_ROUTE_TOL["alexnet"],
                  {k: (ALEXNET_POOLS_PER_STEP * 3 if k == "maxpool2d_bwd" else 0)
                   for k in r["launches"][0]})
    return counts


def _adam(lr):
    from bigdl_tpu_torch.optim import Adam

    return lambda: Adam(learningrate=lr)


def phase_ncf(card):
    """[15b] ``ncf_train.main`` at its defaults, then NeuralCF through
    LocalOptimizer at MovieLens-1M's table sizes; card vs CPU."""
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet, load_movielens
    from bigdl_tpu_torch.examples import ncf_train
    from bigdl_tpu_torch.models import NeuralCF
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    run, probe, counts, _ = _run_example(ncf_train, NCF_ARGS,
                                         f"[15b] ncf_train.main({' '.join(NCF_ARGS)})")
    args, hist = run.args, run.optimizer.history
    n = 2 * (args.synthetic_size or 4096)
    n_steps = args.max_epoch * (int(0.8 * n) // args.batch_size)
    _step_ms(hist, args.batch_size, "records", card)
    log("    " + ", ".join(f"{k} {v:.4f}" for k, v in run.results.items()))
    _check_no_launch_run("[15b] example", probe, counts, [h["loss"] for h in hist], n_steps,
                         args.max_epoch)
    if not all(0.0 <= run.results[k] <= 1.0 for k in ("Top1Accuracy", "HitRatio@10",
                                                      "NDCG@10")):
        raise AssertionError(f"[15b] results {run.results}")
    by_path = {"ncf_example": counts}
    del run
    # the same model at MovieLens-1M's table sizes, the example's widths and batch
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(42)
    x, y, users, items = load_movielens(None, seed=0, **ML1M)
    e, batch = args.embed_dim, args.batch_size

    def ml1m(device):
        return NeuralCF(users, items, class_num=2, user_embed=e, item_embed=e,
                        hidden_layers=(4 * e, 2 * e, e), mf_embed=args.mf_embed, device=device)

    model = ml1m(_models_device())
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), ClassNLLCriterion())
    opt.set_optim_method(Adam(learningrate=1e-3)).set_end_when(Trigger.max_epoch(NCF_ML1M_EPOCHS))
    with _StepProbe() as probe:
        reset_counts()  # the main path starts here
        opt.optimize()
        _sync()
        counts = read_counts()  # the main path ends here
    n_steps = NCF_ML1M_EPOCHS * (len(x) // batch)
    log(f"    [15b] NeuralCF at MovieLens-1M's tables ({users} users, {items} items, "
        f"{model.n_parameters() / 1e6:.3f} M params), {len(x)} records of load_movielens's "
        f"synthetic log, batch {batch}, Adam 1e-3: {len(opt.history)} iterations, losses "
        + ", ".join(f"{h['loss']:.4f}" for h in opt.history[:3]) + " ... "
        + f"{opt.history[-1]['loss']:.4f}; launches {_nonzero(counts)}")
    _step_ms(opt.history, batch, "records", card)
    _check_no_launch_run("[15b] MovieLens-1M tables", probe, counts,
                         [h["loss"] for h in opt.history], n_steps)
    by_path["ncf_ml1m"] = counts
    del model, opt
    _free()
    xr, yr, _, _ = load_movielens(None, n=MODEL_ROUTE_ROWS["ncf"] // 2, seed=1, **ML1M)
    r = _sgd_routes(ml1m, xr, yr, SEED + 22, method=_adam(1e-3))
    _check_routes("NeuralCF at MovieLens-1M's tables", xr, r, MODEL_ROUTE_TOL["ncf"],
                  {k: 0 for k in r["launches"][0]}, recipe="Adam 1e-3")
    return by_path


def phase_ptb(card):
    """[15c] ``ptb_train.main --vocab-size 10000`` (hidden 200, 2 layers, T
    35, batch 32); card vs CPU at batch 4."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.examples import ptb_train
    from bigdl_tpu_torch.models import PTBModel

    run, probe, counts, _ = _run_example(ptb_train, PTB_ARGS,
                                         f"[15c] ptb_train.main({' '.join(PTB_ARGS)})")
    args, hist = run.args, run.optimizer.history
    n_seq = ((args.synthetic_size or 20000) - 1) // args.seq_len
    n_steps = args.max_epoch * (max(1, int(0.9 * n_seq)) // args.batch_size)
    log(f"    PTBModel vocab {args.vocab_size + 1}, hidden {args.hidden_size}, "
        f"{args.num_layers} layers, T {args.seq_len}: {run.model.n_parameters() / 1e6:.3f} M "
        f"params; validation loss {run.results.get('Loss', float('nan')):.4f}")
    _step_ms(hist, args.batch_size, "sequences", card)
    _check_no_launch_run("[15c]", probe, counts, [h["loss"] for h in hist], n_steps,
                         args.max_epoch)
    del run
    _free()
    ids, _, vocab = ptb_train.load_corpus(None, args.vocab_size, 2000, seed=0)
    x, y = ptb_train.windows(ids, args.seq_len)
    rows = MODEL_ROUTE_ROWS["ptb"]
    r = _sgd_routes(lambda device: PTBModel(vocab + 1, args.hidden_size, args.hidden_size,
                                            args.num_layers, device=device),
                    x[:rows], y[:rows], SEED + 23, method=_adam(1e-3),
                    criterion=lambda: nn.TimeDistributedCriterion(
                        nn.ClassNLLCriterion(one_based_label=True), size_average=True))
    _check_routes("PTBModel", x[:rows], r, MODEL_ROUTE_TOL["ptb"],
                  {k: 0 for k in r["launches"][0]}, recipe="Adam 1e-3")
    return counts


def phase_autoencoder(card):
    """[15d] ``autoencoder_train.main`` at its defaults; card vs CPU."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import load_mnist
    from bigdl_tpu_torch.examples import autoencoder_train
    from bigdl_tpu_torch.models import Autoencoder

    run, probe, counts, _ = _run_example(autoencoder_train, AUTOENCODER_ARGS,
                                         "[15d] autoencoder_train.main()")
    args, hist = run.args, run.optimizer.history
    n_steps = args.max_epoch * ((args.synthetic_size or 4096) // args.batch_size)
    log(f"    reconstruction MSE {run.results['mse']:.4f} (data variance "
        f"{run.results['variance']:.4f})")
    _step_ms(hist, args.batch_size, "images", card)
    _check_no_launch_run("[15d]", probe, counts, [h["loss"] for h in hist], n_steps)
    del run
    _free()
    x, _ = load_mnist(None, normalize=False, synthetic_size=MODEL_ROUTE_ROWS["autoencoder"])
    t = x.reshape(len(x), 784)
    r = _sgd_routes(lambda device: Autoencoder(class_num=32, device=device), x, t, SEED + 24,
                    method=_adam(args.learning_rate), criterion=nn.MSECriterion)
    _check_routes("Autoencoder", x, r, MODEL_ROUTE_TOL["autoencoder"],
                  {k: 0 for k in r["launches"][0]}, recipe=f"Adam {args.learning_rate}, MSE")
    return counts


def phase_cnntext(card):
    """[15e] CNNTextClassifier through LocalOptimizer at the reference
    text-classification example's sizes (vocab 20000, T 1000, batch 128, 20
    classes; SGD 0.01 momentum 0.9, the one batch every iteration, as [11]
    feeds its configs); card vs CPU at batch 4."""
    import numpy as np
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import CNNTextClassifier
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    c = CNNTEXT
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(1)
    rng = np.random.default_rng(SEED + 25)
    x = rng.integers(0, c["vocab"], (c["batch"], c["seq"])).astype(np.int32)
    y = rng.integers(0, c["classes"], c["batch"])
    model = CNNTextClassifier(c["vocab"], class_num=c["classes"],
                              device=_models_device())
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=c["batch"]), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(c["iters"]))
    with _StepProbe() as probe:
        reset_counts()  # the main path starts here
        opt.optimize()
        _sync()
        counts = read_counts()  # the main path ends here
    hist = opt.history
    log(f"[15e] CNNTextClassifier (vocab {c['vocab']}, embedding 128, {c['classes']} classes; "
        f"{model.n_parameters() / 1e6:.3f} M params), batch {c['batch']} x T {c['seq']}: "
        f"{len(hist)} iterations, losses " + ", ".join(f"{h['loss']:.4f}" for h in hist)
        + f"; launches {_nonzero(counts)}")
    _step_ms(hist, c["batch"], "records", card)
    _check_no_launch_run("[15e]", probe, counts, [h["loss"] for h in hist], c["iters"])
    del model, opt
    _free()
    rows = MODEL_ROUTE_ROWS["cnntext"]
    r = _sgd_routes(lambda device: CNNTextClassifier(c["vocab"], class_num=c["classes"],
                                                     device=device),
                    x[:rows], y[:rows], SEED + 26)
    _check_routes("CNNTextClassifier", x[:rows], r, MODEL_ROUTE_TOL["cnntext"],
                  {k: 0 for k in r["launches"][0]})
    return counts


def phase_models(card):
    """[15] AlexNet, NeuralCF, PTBModel, the Autoencoder and
    CNNTextClassifier; returns their main paths' launches."""
    t0 = time.perf_counter()
    by_path = {"alexnet": phase_alexnet(card)}
    by_path.update(phase_ncf(card))
    by_path["ptb_example"] = phase_ptb(card)
    by_path["autoencoder_example"] = phase_autoencoder(card)
    by_path["cnntext"] = phase_cnntext(card)
    log(f"[15] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# [16] the other recurrent cells (GRU, LSTMPeephole, RnnCell, ConvLSTMPeephole,
# RecurrentDecoder), the table ops and the rest of activations, math_ops and
# criterion. None of them runs a kernel of this repo: every path launches 0.
CELLS_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes below
# [16a] BASELINE config 4's classifier (bigdl_tpu/models/textclassifier.py's
# BiLSTMClassifier) with the LSTM replaced, at parity_config("bilstm")'s data
# and recipe: T 200, batch 128, bf16 compute and activations, ClassNLL, SGD
# 0.01 momentum 0.9; one warm-up iteration, then 5
CELL_CLASSIFIERS = ("GRU", "LSTMPeephole", "RnnCell")
CELL_ITERS = 6
CELL_BATCH = None  # parity_config's (128)
# [16b] Moving MNIST's frames (Srivastava et al. 2015, arXiv 1502.04681:
# 64x64, 10 input steps predicting the next 10) through two ConvLSTM layers
# (Shi et al. 2015, arXiv 1506.04214) of 64 channels; the frames are seeded
# values in [0, 1] (no dataset in the repo); BCE, Adam 1e-3
MOVING_MNIST = {"batch": 16, "steps": 10, "hw": 64, "hidden": 64, "iters": 6}
# [16c] a sequence autoencoder at config 4's widths: GRU encoder, the last
# step's code decoded for 200 steps by RecurrentDecoder(LSTM); MSE, Adam 1e-3
SEQ_AE = {"batch": 128, "seq": 200, "width": 128, "iters": 6}
# [16d] every other new module at >= 1e6 elements an input
MODULE_ROWS, MODULE_WIDTH = 256, 4096
# Card-vs-CPU routes: 3 f32 steps at a cut batch from one set of weights.
# Limits, fixed before the first run: [16a]'s classifiers are the BiLSTM's
# kind (sigmoid/tanh cells, a contracting recurrence of 200 steps whose
# loss reads the last, SGD), so [11]'s BiLSTM limits and batch hold them.
# [16b] (sigmoid/tanh ConvLSTM gates, BCE) and [16c] (GRU/LSTM, MSE) train
# with Adam, whose first step moves a weight by the rate whatever its
# gradient's size: [15]'s Adam limits (ADAM_ROUTE_TOL) and their reasons.
# [16d]'s three container models train with SGD through small Linear
# layers: VGG-16's limits (VGG_ROUTE_TOL).
CELL_ROUTE_ROWS = {"classifier": PARITY_ROUTE_BATCH["bilstm"], "convlstm": 2, "seq_ae": 4,
                   "containers": 64}
# [16d] each module on the card against the CPU, the same weights and
# inputs, its outputs and the gradients of sum(y * dy) (fixed before the
# first run): f32 |card - cpu| <= 1e-5 + 1e-4 |cpu| + 1e-5 max|cpu| (the
# same formula: CUDA's exp, tanh and log against the CPU's within a few
# units in the last place, and sums of up to 4096 terms (512 x 512 in
# Bilinear) in another order, whose rounding grows with the largest term);
# bf16 1e-5 + 2^-6 |cpu| + 2^-6 max|cpu| (both round each op's fp32 result
# to bf16; two fp32 values a few units apart may round to neighbouring
# bf16 values, and a following op carries that step); a loss 1e-5
# relative. The clip family's gradient at its exact bounds must be 1/2 on
# the card (jnp.clip's), Abs's at 0 must be 1 (jnp.abs's).
MODULE_TOL = {"float32": (1e-5, 1e-4, 1e-5), "bfloat16": (1e-5, 2.0 ** -6, 2.0 ** -6)}
MODULE_LOSS_RTOL = 1e-5


def _cells_device():
    return "cpu" if CELLS_DEVICE == "cpu" else None


def cell_classifier(cell: str, device, vocab: int = 20001, width: int = 128,
                    class_num: int = 20):
    """BiLSTMClassifier's structure with ``cell`` in place of the LSTM:
    LookupTable -> BiRecurrent(cell, concat) -> Select(2, -1) -> Linear ->
    LogSoftMax."""
    from bigdl_tpu_torch import nn

    d = {"device": device}
    return nn.Sequential(
        nn.LookupTable(vocab, width, **d).set_name("embedding"),
        nn.BiRecurrent(getattr(nn, cell)(width, width, **d), merge_mode="concat", **d)
        .set_name("birnn"),
        nn.Select(2, -1, **d).set_name("last_step"),
        nn.Linear(2 * width, class_num, **d).set_name("fc"),
        nn.LogSoftMax(**d).set_name("logsoftmax"), **d)


def convlstm_predictor(device, hidden: int = 64, first_peephole: bool = True):
    """Recurrent(ConvLSTMPeephole(1, hidden)) -> Recurrent(ConvLSTMPeephole(
    hidden, hidden)) -> TimeDistributed(1x1 SpatialConvolution to 1) ->
    Sigmoid: (N, T, 1, H, W) frames -> (N, T, 1, H, W) next frames."""
    from bigdl_tpu_torch import nn

    d = {"device": device}
    return nn.Sequential(
        nn.Recurrent(nn.ConvLSTMPeephole(1, hidden, 3, 3, with_peephole=first_peephole, **d),
                     **d).set_name("convlstm1"),
        nn.Recurrent(nn.ConvLSTMPeephole(hidden, hidden, 3, 3, **d), **d).set_name("convlstm2"),
        nn.TimeDistributed(nn.SpatialConvolution(hidden, 1, 1, 1, **d), **d).set_name("readout"),
        nn.Sigmoid(**d).set_name("sigmoid"), **d)


def moving_mnist_frames(n: int, steps: int, hw: int, seed: int):
    """(inputs, targets): 2 x ``steps`` seeded frames in [0, 1] a sequence,
    the first ``steps`` in, the next ``steps`` to predict."""
    import numpy as np

    frames = np.random.default_rng(seed).random((n, 2 * steps, 1, hw, hw), dtype=np.float32)
    return frames[:, :steps].copy(), frames[:, steps:].copy()


def seq_autoencoder(device, decoder: str = "LSTM", width: int = 128, seq: int = 200):
    """Recurrent(GRU) -> Select(2, -1) -> RecurrentDecoder(seq, <decoder>):
    (N, seq, width) -> its reconstruction."""
    from bigdl_tpu_torch import nn

    d = {"device": device}
    return nn.Sequential(
        nn.Recurrent(nn.GRU(width, width, **d), **d).set_name("encoder"),
        nn.Select(2, -1, **d).set_name("code"),
        nn.RecurrentDecoder(seq, getattr(nn, decoder)(width, width, **d), **d)
        .set_name("decoder"), **d)


def _train_cells_path(label, model, x, y, batch, criterion, method, iters, card, unit):
    """``iters`` iterations of ``model`` through LocalOptimizer, its one
    batch every iteration, with the counts set to 0 just before and read
    just after: finite losses, 0 launches every step, memory flat from step
    2; the step's median ms over iterations 3 on and the device's busy share
    over 2 more profiled iterations. Returns the counts."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger

    t0 = time.perf_counter()
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), criterion)
    opt.set_optim_method(method).set_end_when(Trigger.max_iteration(iters))
    with _StepProbe() as probe:
        reset_counts()  # the main path starts here
        opt.optimize()
        _sync()
        counts = read_counts()  # the main path ends here
    hist = opt.history
    losses = [h["loss"] for h in hist]
    log(f"{label}: {model.n_parameters() / 1e6:.3f} M params, batch {batch} of {_describe(x)}: "
        f"{len(hist)} iterations in {time.perf_counter() - t0:.2f} s (build included), losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; launches {_nonzero(counts)}")
    _step_ms(hist, batch, unit, card)
    _log_input_wait(label.split(" ")[0], hist)
    _check_no_launch_run(label, probe, counts, losses, iters)
    dev_ms, wall_ms, share = _busy_share(opt, 2)
    log(f"    host/device split (2 more iterations under torch.profiler): device {dev_ms:.2f} ms "
        f"of {wall_ms:.2f} ms a step ({100 * share:.1f}% busy); card {card}")
    del opt
    return counts


def phase_cell_classifiers(card):
    """[16a] config 4's classifier with a GRU, an LSTMPeephole and an RnnCell
    in place of the LSTM; card vs CPU at batch 4."""
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.models import parity_config
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD

    by_path = {}
    _, x, y, batch = parity_config("bilstm", CELL_BATCH, device="cpu")
    for cell in CELL_CLASSIFIERS:
        Engine.set_compute_dtype("bfloat16")
        Engine.set_activation_dtype("bfloat16")
        RandomGenerator.set_seed(1)
        try:
            by_path[f"cells_{cell.lower()}"] = _train_cells_path(
                f"[16a] BiRecurrent({cell}) classifier (vocab 20001, width 128, 20 classes, "
                "bf16 compute and activations, SGD 0.01 momentum 0.9)",
                cell_classifier(cell, _cells_device()), x, y, batch, ClassNLLCriterion(),
                SGD(learningrate=0.01, momentum=0.9), CELL_ITERS, card, "records")
        finally:
            Engine.set_compute_dtype(None)
            Engine.set_activation_dtype(None)
        _free()
        rows = CELL_ROUTE_ROWS["classifier"]
        r = _sgd_routes(lambda device, c=cell: cell_classifier(c, device), x[:rows], y[:rows],
                        SEED + 31)
        _check_routes(f"BiRecurrent({cell}) classifier", x[:rows], r,
                      PARITY_ROUTE_TOL["bilstm"], {k: 0 for k in r["launches"][0]})
    return by_path


def phase_convlstm(card):
    """[16b] two ConvLSTMPeephole layers at Moving MNIST's frame size;
    card vs CPU at batch 2, the first layer without peepholes."""
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.optim import Adam

    c = MOVING_MNIST
    Engine.set_compute_dtype(None)  # the card's policy: bf16 products, f32 activations
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(2)
    x, y = moving_mnist_frames(c["batch"], c["steps"], c["hw"], SEED + 32)
    counts = _train_cells_path(
        f"[16b] ConvLSTMPeephole x2 ({c['hidden']} channels) predicting {c['steps']} frames of "
        f"{c['hw']}x{c['hw']} (BCE, Adam 1e-3)",
        convlstm_predictor(_cells_device(), c["hidden"]), x, y, c["batch"], nn.BCECriterion(),
        Adam(learningrate=1e-3), c["iters"], card, "sequences")
    _free()
    rows = CELL_ROUTE_ROWS["convlstm"]
    r = _sgd_routes(lambda device: convlstm_predictor(device, c["hidden"], first_peephole=False),
                    x[:rows], y[:rows], SEED + 33, method=_adam(1e-3),
                    criterion=nn.BCECriterion)
    _check_routes("ConvLSTM predictor (first layer without peepholes)", x[:rows], r,
                  ADAM_ROUTE_TOL, {k: 0 for k in r["launches"][0]}, recipe="Adam 1e-3, BCE")
    return counts


def phase_seq_autoencoder(card):
    """[16c] GRU encoder -> RecurrentDecoder(LSTM) at config 4's widths;
    card vs CPU at batch 4 with an LSTM and with a GRU decoder."""
    import numpy as np
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.optim import Adam

    c = SEQ_AE
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(3)
    x = (0.5 * np.random.default_rng(SEED + 34).standard_normal(
        (c["batch"], c["seq"], c["width"]))).astype(np.float32)
    counts = _train_cells_path(
        f"[16c] sequence autoencoder Recurrent(GRU) -> RecurrentDecoder({c['seq']}, LSTM), width "
        f"{c['width']} (MSE, Adam 1e-3)",
        seq_autoencoder(_cells_device(), "LSTM", c["width"], c["seq"]), x, x, c["batch"],
        nn.MSECriterion(), Adam(learningrate=1e-3), c["iters"], card, "sequences")
    _free()
    rows = CELL_ROUTE_ROWS["seq_ae"]
    for decoder in ("LSTM", "GRU"):
        r = _sgd_routes(lambda device, dec=decoder: seq_autoencoder(device, dec, c["width"],
                                                                    c["seq"]),
                        x[:rows], x[:rows], SEED + 35, method=_adam(1e-3),
                        criterion=nn.MSECriterion)
        _check_routes(f"sequence autoencoder, {decoder} decoder", x[:rows], r, ADAM_ROUTE_TOL,
                      {k: 0 for k in r["launches"][0]}, recipe="Adam 1e-3, MSE")
    return counts


# ------------------------------------------------------------------ [16d]
_BOUNDS = [0.0, 6.0, -1.0, 1.0, -2.5, 2.5, 1e-6, 30.0, -30.0]


def _module_cases():
    """(label, module or criterion maker (device -> object), input maker
    (rng -> numpy arrays; a list is a Table), target maker or None, dtypes)
    of every module [16d] runs, at MODULE_ROWS x MODULE_WIDTH (>= 1e6
    elements an input) unless the module's shape says otherwise."""
    import numpy as np
    from bigdl_tpu_torch import nn

    R, W = MODULE_ROWS, MODULE_WIDTH
    both, f32 = ("float32", "bfloat16"), ("float32",)

    def normal(scale=3.0, shape=(R, W)):
        def make(rng):
            x = (scale * rng.standard_normal(shape)).astype(np.float32)
            x.reshape(-1)[:len(_BOUNDS)] = _BOUNDS
            return x
        return make

    def positive(shape=(R, W)):
        return lambda rng: (0.1 + 3 * rng.random(shape)).astype(np.float32)

    def probs(shape=(R, W)):
        def make(rng):
            p = rng.random(shape).astype(np.float32)
            p.reshape(-1)[:4] = [0.0, 1.0, 0.0, 1.0]
            return p
        return make

    def bits(shape=(R, W)):
        def make(rng):
            t = (rng.random(shape) > 0.5).astype(np.float32)
            t.reshape(-1)[:4] = [1.0, 0.0, 0.0, 1.0]
            return t
        return make

    def table(*makers):
        return lambda rng: [m(rng) for m in makers]

    def ties(rng):
        a, b, c = (normal()(rng) for _ in range(3))
        b[0], b[1, :64], c[1, :64] = a[0], a[1, :64], a[1, :64]
        return [a, b, c]

    def signs(n):
        return lambda rng: np.where(rng.random(n) > 0.5, 1, -1).astype(np.float32)

    def log_probs(rng):
        x = rng.standard_normal((R, W)).astype(np.float32)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    def dist(rng):
        t = rng.random((R, W)).astype(np.float32)
        t[:, 0] = 0.0
        return t / t.sum(-1, keepdims=True)

    def multi_label(rng):
        t = rng.integers(1, W + 1, (R, 8))
        t[:, 5:] = 0
        t[0] = 0
        t[1, 2:] = 0
        return t

    def m(make):
        return lambda device: make({"device": device})

    def c(make):
        return lambda device: make()

    n = R * W
    cases = [
        ("ReLU6", m(lambda d: nn.ReLU6(**d)), normal(), None, both),
        ("Threshold", m(lambda d: nn.Threshold(0.5, -2.0, **d)), normal(), None, both),
        ("HardSigmoid", m(lambda d: nn.HardSigmoid(**d)), normal(), None, both),
        ("HardTanh", m(lambda d: nn.HardTanh(**d)), normal(), None, both),
        ("ELU", m(lambda d: nn.ELU(0.7, **d)), normal(), None, both),
        ("SELU", m(lambda d: nn.SELU(**d)), normal(), None, both),
        ("LeakyReLU", m(lambda d: nn.LeakyReLU(0.1, **d)), normal(), None, both),
        ("PReLU", m(lambda d: nn.PReLU(**d)), normal(), None, both),
        ("PReLU(4096 planes)", m(lambda d: nn.PReLU(W, **d)), normal(), None, both),
        ("RReLU (eval)", m(lambda d: nn.RReLU(**d)), normal(), None, both),
        ("SoftMax", m(lambda d: nn.SoftMax(**d)), normal(), None, both),
        ("SoftPlus", m(lambda d: nn.SoftPlus(2.0, **d)), normal(), None, both),
        ("SoftSign", m(lambda d: nn.SoftSign(**d)), normal(), None, both),
        ("SoftMin", m(lambda d: nn.SoftMin(**d)), normal(), None, both),
        ("GELU", m(lambda d: nn.GELU(**d)), normal(), None, both),
        ("Swish", m(lambda d: nn.Swish(**d)), normal(), None, both),
        ("ThresholdedReLU", m(lambda d: nn.ThresholdedReLU(**d)), normal(), None, both),
        ("SReLU", m(lambda d: nn.SReLU(**d)), normal(), None, both),
        ("Abs", m(lambda d: nn.Abs(**d)), normal(), None, both),
        ("Power", m(lambda d: nn.Power(2.0, 1.5, 0.5, **d)), normal(), None, both),
        ("Square", m(lambda d: nn.Square(**d)), normal(), None, both),
        ("Sqrt", m(lambda d: nn.Sqrt(**d)), positive(), None, both),
        ("Log", m(lambda d: nn.Log(**d)), positive(), None, both),
        ("Exp", m(lambda d: nn.Exp(**d)), normal(1.0), None, both),
        ("Clamp", m(lambda d: nn.Clamp(-1.0, 2.5, **d)), normal(), None, both),
        ("MulConstant", m(lambda d: nn.MulConstant(-1.5, **d)), normal(), None, both),
        ("AddConstant", m(lambda d: nn.AddConstant(0.75, **d)), normal(), None, both),
        ("Neg", m(lambda d: nn.Neg(**d)), normal(), None, both),
        ("Mul", m(lambda d: nn.Mul(**d)), normal(), None, both),
        ("Add", m(lambda d: nn.Add(W, **d)), normal(), None, both),
        ("CMul", m(lambda d: nn.CMul((1, W), **d)), normal(), None, both),
        ("CAdd", m(lambda d: nn.CAdd((1, W), **d)), normal(), None, both),
        ("Scale", m(lambda d: nn.Scale(W, **d)), normal(), None, both),
        ("Bilinear 512x512->64", m(lambda d: nn.Bilinear(512, 512, 64, **d)),
         table(normal(1.0, (R, 512)), normal(1.0, (R, 512))), None, f32),
        ("Euclidean 4096->16", m(lambda d: nn.Euclidean(W, 16, **d)), normal(1.0), None, f32),
        ("Cosine 4096->64", m(lambda d: nn.Cosine(W, 64, **d)), normal(), None, f32),
        ("ConcatTable", m(lambda d: nn.ConcatTable(nn.Linear(W, 64, **d), nn.Tanh(**d), **d)),
         normal(), None, f32),
        ("ParallelTable", m(lambda d: nn.ParallelTable(nn.Linear(W, 64, **d),
                                                      nn.Linear(W, 64, **d), **d)),
         table(normal(), normal()), None, f32),
        ("MapTable", m(lambda d: nn.MapTable(nn.Linear(W, 64, **d), **d)),
         table(normal(), normal(), normal()), None, f32),
        ("JoinTable", m(lambda d: nn.JoinTable(2, **d)), table(normal(), normal()), None, both),
        ("CAddTable", m(lambda d: nn.CAddTable(**d)), ties, None, both),
        ("CSubTable", m(lambda d: nn.CSubTable(**d)), table(normal(), normal()), None, both),
        ("CMulTable", m(lambda d: nn.CMulTable(**d)), ties, None, both),
        ("CDivTable", m(lambda d: nn.CDivTable(**d)), table(normal(), positive()), None, both),
        ("CMaxTable", m(lambda d: nn.CMaxTable(**d)), ties, None, both),
        ("CMinTable", m(lambda d: nn.CMinTable(**d)), ties, None, both),
        ("CAveTable", m(lambda d: nn.CAveTable(**d)), ties, None, both),
        ("SelectTable", m(lambda d: nn.SelectTable(-1, **d)), ties, None, both),
        ("FlattenTable", m(lambda d: nn.FlattenTable(**d)),
         lambda rng: (lambda t: [t[0], [t[1], [t[2]]]])(ties(rng)), None, both),
        ("MixtureTable", m(lambda d: nn.MixtureTable(**d)),
         lambda rng: [rng.random((R, 3)).astype(np.float32), ties(rng)], None, f32),
        ("DotProduct", m(lambda d: nn.DotProduct(**d)), table(normal(), normal()), None, f32),
        ("CosineDistance", m(lambda d: nn.CosineDistance(**d)), table(normal(), normal()), None,
         f32),
        ("PairwiseDistance", m(lambda d: nn.PairwiseDistance(2, **d)),
         table(normal(), normal()), None, f32),
        ("MM (32, 256, 256)", m(lambda d: nn.MM(**d)),
         table(normal(1.0, (32, 256, 256)), normal(1.0, (32, 256, 256))), None, f32),
        ("MM transposed", m(lambda d: nn.MM(True, True, **d)),
         table(normal(1.0, (32, 256, 256)), normal(1.0, (32, 256, 256))), None, f32),
        ("MV (32, 256, 256)", m(lambda d: nn.MV(True, **d)),
         table(normal(1.0, (32, 256, 256)), normal(1.0, (32, 256))), None, f32),
        ("AbsCriterion", c(lambda: nn.AbsCriterion()), normal(), normal(), f32),
        ("SmoothL1Criterion", c(lambda: nn.SmoothL1Criterion()), normal(), normal(1.0), f32),
        ("BCECriterion", c(lambda: nn.BCECriterion()), probs(), bits(), f32),
        ("BCECriterionWithLogits", c(lambda: nn.BCECriterionWithLogits()), normal(), bits(),
         f32),
        ("DistKLDivCriterion", c(lambda: nn.DistKLDivCriterion()), log_probs, dist, f32),
        ("MarginRankingCriterion", c(lambda: nn.MarginRankingCriterion(0.5)),
         table(normal(1.0, (n,)), normal(1.0, (n,))), signs(n), f32),
        ("HingeEmbeddingCriterion", c(lambda: nn.HingeEmbeddingCriterion(1.5)),
         lambda rng: np.abs(normal(2.0, (n,))(rng)), signs(n), f32),
        ("CosineEmbeddingCriterion", c(lambda: nn.CosineEmbeddingCriterion(0.2)),
         table(normal(), normal()), signs(R), f32),
        ("MultiLabelSoftMarginCriterion", c(lambda: nn.MultiLabelSoftMarginCriterion()),
         normal(), bits(), f32),
        ("L1Cost", c(lambda: nn.L1Cost()), normal(), normal(), f32),
        ("ParallelCriterion", c(lambda: nn.ParallelCriterion().add(nn.AbsCriterion(), 0.5)
                                .add(nn.MSECriterion(), 2.0)),
         table(normal(), normal()), table(normal(), normal()), f32),
        ("MultiCriterion", c(lambda: nn.MultiCriterion().add(nn.MSECriterion(), 0.7)
                             .add(nn.AbsCriterion())), normal(), normal(), f32),
        ("MarginCriterion", c(lambda: nn.MarginCriterion(0.8, True, True)),
         normal(1.0, (n,)), signs(n), f32),
        ("MultiLabelMarginCriterion", c(lambda: nn.MultiLabelMarginCriterion()), normal(),
         multi_label, f32),
        ("DiceCoefficientCriterion", c(lambda: nn.DiceCoefficientCriterion()),
         probs((R, 64, 64)), bits((R, 64, 64)), f32),
        ("ClassSimplexCriterion", c(lambda: nn.ClassSimplexCriterion(W)), normal(0.01),
         lambda rng: rng.integers(1, W + 1, R), f32),
    ]
    return cases


def _leaves(x):
    from bigdl_tpu_torch.utils.table import Table

    if isinstance(x, (Table, list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


def _to_device(x, device, dtype):
    """Numpy arrays (a list: a Table) as tensors on ``device``, float ones in
    ``dtype`` and requiring grad."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.utils.table import T

    if isinstance(x, list):
        return T(*[_to_device(v, device, dtype) for v in x])
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if t.is_floating_point():
        t = t.to(dtype).requires_grad_(True)
    return t


def _run_module(obj, is_criterion, x, t, seed, device, dtype):
    """Outputs (or the loss) and the gradients of sum(y * dy) (of the loss)
    for every float input and parameter, all on the host in f32; dy drawn
    from ``seed`` at the outputs' shapes."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.utils.table import T

    xin = _to_device(x, device, dtype)
    xs = [v for v in _leaves(xin) if v.is_floating_point()]
    if is_criterion:
        tgt = (T(*[torch.from_numpy(v).to(device) for v in t]) if isinstance(t, list)
               else torch.from_numpy(t).to(device))
        loss = obj._apply(xin, tgt)
        ys, params = [loss], []
    else:
        params = list(obj.parameters())
        ys = _leaves(obj.apply(obj.get_parameters(), obj.get_state(), xin)[0])
        rng = np.random.default_rng(seed)
        loss = sum((y.float() * torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
            np.float32)).to(device)).sum() for y in ys)
    grads = torch.autograd.grad(loss, xs + params, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g for g, w in zip(grads, xs + params)]
    host = [v.detach().float().cpu() for v in ys + grads]
    return host[:len(ys)], host[len(ys):], [str(y.dtype) for y in ys]


def _module_diff(label, got, want, dtype, what):
    """The worst |card - cpu| over its allowance (<= 1 passes)."""
    import torch

    atol, rtol, share = MODULE_TOL[dtype]
    if got.shape != want.shape:
        raise AssertionError(f"[16d] {label} {dtype} {what}: shape {tuple(got.shape)} on the card,"
                             f" {tuple(want.shape)} on the CPU")
    if not torch.isfinite(got).all() or not torch.isfinite(want).all():
        raise AssertionError(f"[16d] {label} {dtype} {what}: non-finite values")
    allow = atol + rtol * want.abs() + share * want.abs().max()
    return float(((got - want).abs() / allow).max())


def phase_module_sweep(card):
    """[16d] every new activation, math op, table op and criterion forward
    and backward on the card and on the CPU (same weights and inputs), the
    clip family at its exact bounds on the card, RReLU's training draws on
    the card; the counts 0 just before and read just after (no kernel
    launched). Then 3 LocalOptimizer steps of one model per container."""
    import copy

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator

    device = "cpu" if CELLS_DEVICE == "cpu" else "cuda"
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    t0 = time.perf_counter()
    worst, n_runs, cases = {}, 0, _module_cases()
    try:
        reset_counts()  # the main path starts here
        for i, (label, make, data, target, dtypes) in enumerate(cases):
            RandomGenerator.set_seed(SEED + 40 + i)
            rng = np.random.default_rng(SEED + 40 + i)
            x, t = data(rng), (target(rng) if target is not None else None)
            is_crit = target is not None
            host = make("cpu")
            if not is_crit:
                host.init(sample_input=_to_device(x, "cpu", torch.float32))
            card_obj = host if is_crit else copy.deepcopy(host).to(device)
            for dtype in dtypes:
                dt = getattr(torch, dtype)
                y_cpu, g_cpu, dts_cpu = _run_module(host, is_crit, x, t, SEED + 90 + i, "cpu", dt)
                y_dev, g_dev, dts_dev = _run_module(card_obj, is_crit, x, t, SEED + 90 + i,
                                                    device, dt)
                if dts_cpu != dts_dev:
                    raise AssertionError(f"[16d] {label} {dtype}: output dtypes {dts_dev} on the "
                                         f"card, {dts_cpu} on the CPU")
                if is_crit:
                    a, b = y_dev[0].item(), y_cpu[0].item()
                    w = (abs(a - b) / (MODULE_LOSS_RTOL * max(1.0, abs(b))) if np.isfinite(a)
                         else float("inf"))
                else:
                    w = max(_module_diff(label, a, b, dtype, "output")
                            for a, b in zip(y_dev, y_cpu))
                w = max([w] + [_module_diff(label, a, b, dtype, "gradient")
                               for a, b in zip(g_dev, g_cpu)])
                if w > 1.0:
                    raise AssertionError(f"[16d] {label} {dtype}: card vs CPU at {w:.2f} of the "
                                         "allowance")
                worst[(label, dtype)] = w
                n_runs += 1
            del host, card_obj
        bounds = _exact_bounds_on(device)
        rrelu = _rrelu_on(device)
        _sync()
        counts = read_counts()  # the main path ends here
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        Engine.set_compute_dtype(None)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log(f"[16d] {len(cases)} modules and criterions, {n_runs} (module, dtype) runs "
        f"forward and backward on the card against the CPU, inputs of {MODULE_ROWS}x"
        f"{MODULE_WIDTH} (Bilinear 512x512->64, MM/MV (32, 256, 256)): all within their "
        "allowances (f32 1e-5 + 1e-4|cpu| + 1e-5 max|cpu|, bf16 1e-5 + 2^-6|cpu| + 2^-6 "
        f"max|cpu|); the largest shares of the allowance: "
        + ", ".join(f"{k[0]} {k[1]} {v:.3f}" for k, v in top)
        + f"; {time.perf_counter() - t0:.1f} s; launches {_nonzero(counts)}")
    log(f"    exact bounds on the card: {bounds}; {rrelu}")
    if any(counts.values()):
        raise AssertionError(f"[16d] launched {_nonzero(counts)}")
    _free()
    _container_routes()
    return counts


def _exact_bounds_on(device):
    """The clip family's gradient at its exact bounds (1/2, jnp.clip's) and
    Abs's at 0 (1, jnp.abs's) on ``device``, f32 and bf16."""
    import torch
    from bigdl_tpu_torch import nn

    cases = [(nn.ReLU6, (), [0.0, 6.0], 0.5), (nn.HardTanh, (), [-1.0, 1.0], 0.5),
             (nn.HardSigmoid, (), [-2.5, 2.5], 0.1), (nn.Clamp, (-1.0, 2.5), [-1.0, 2.5], 0.5),
             (nn.ReLU, (), [0.0], 0.5), (nn.Abs, (), [0.0], 1.0)]
    out = []
    for cls, args, at, want in cases:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.tensor(at, device=device, dtype=dt, requires_grad=True)
            cls(*args, device="cpu").apply({}, {}, x)[0].sum().backward()
            got = x.grad.float().cpu().tolist()
            # 1/2 times the slope as the dtype holds it (0.2 is not exact in either)
            if any(abs(g - want) > (1e-3 if dt == torch.bfloat16 else 1e-7) for g in got):
                raise AssertionError(f"[16d] {cls.__name__}'s gradient at {at} in {dt}: {got}, "
                                     f"expected {want}")
        out.append(f"{cls.__name__} at {at}: {want}")
    return "; ".join(out)


def _rrelu_on(device):
    """RReLU's training slopes on ``device``: within [lower, upper], their
    mean near the middle, repeated under one generator seed."""
    import torch
    from bigdl_tpu_torch import nn

    m = nn.RReLU(0.1, 0.3, device="cpu")
    x = -torch.rand(MODULE_ROWS, MODULE_WIDTH, device=device) - 0.1
    y1 = m.apply({}, {}, x, training=True, rng=torch.Generator().manual_seed(5))[0]
    y2 = m.apply({}, {}, x, training=True, rng=torch.Generator().manual_seed(5))[0]
    a = (y1 / x).flatten()
    mean = float(a.mean())
    if not (torch.equal(y1, y2) and float(a.min()) >= 0.1 - 1e-6
            and float(a.max()) <= 0.3 + 1e-6
            # six standard deviations of the mean of n draws of U(0.1, 0.3)
            and abs(mean - 0.2) < 6 * 0.2 / 12 ** 0.5 / a.numel() ** 0.5):
        raise AssertionError(f"[16d] RReLU's training slopes: min {float(a.min())}, max "
                             f"{float(a.max())}, mean {mean}")
    return (f"RReLU(0.1, 0.3) training slopes over {a.numel()} elements in "
            f"[{float(a.min()):.4f}, {float(a.max()):.4f}], mean {mean:.5f}, repeated under one "
            "seed")


def _container_routes():
    """3 SGD steps, card vs CPU, of one small model per container:
    ConcatTable -> JoinTable (ClassNLL), ParallelTable into a
    ParallelCriterion(Abs, SmoothL1), MapTable(Linear) -> CAveTable into a
    MultiCriterion(MSE, Abs): their parameter trees through the optimizer."""
    import numpy as np
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils.table import T

    rows = CELL_ROUTE_ROWS["containers"]
    rng = np.random.default_rng(SEED + 36)
    a, b, c = (rng.standard_normal((rows, 256)).astype(np.float32) for _ in range(3))
    labels, target = rng.integers(0, 10, rows), rng.standard_normal((rows, 8)).astype(np.float32)

    def concat_join(device):
        d = {"device": device}
        return nn.Sequential(
            nn.ConcatTable(nn.Linear(256, 64, **d),
                           nn.Sequential(nn.Linear(256, 64, **d), nn.Tanh(**d), **d), **d),
            nn.JoinTable(2, **d), nn.Linear(128, 10, **d), nn.LogSoftMax(**d), **d)

    def parallel(device):
        d = {"device": device}
        return nn.ParallelTable(nn.Linear(256, 8, **d),
                                nn.Sequential(nn.Linear(256, 8, **d), nn.Tanh(**d), **d), **d)

    def mapped(device):
        d = {"device": device}
        return nn.Sequential(nn.MapTable(nn.Linear(256, 8, **d), **d), nn.CAveTable(**d), **d)

    runs = [("ConcatTable -> JoinTable, ClassNLL", concat_join, a, labels, None),
            ("ParallelTable, ParallelCriterion(Abs, 0.5 SmoothL1)", parallel, T(a, b), target,
             lambda: nn.ParallelCriterion(True).add(nn.AbsCriterion())
             .add(nn.SmoothL1Criterion(), 0.5)),
            ("MapTable(Linear) -> CAveTable, MultiCriterion(MSE, 0.5 Abs)", mapped, T(a, b, c),
             target, lambda: nn.MultiCriterion().add(nn.MSECriterion())
             .add(nn.AbsCriterion(), 0.5))]
    for i, (label, build, x, y, crit) in enumerate(runs):
        r = _sgd_routes(build, x, y, SEED + 37 + i, criterion=crit)
        _check_routes(label, x, r, VGG_ROUTE_TOL, {k: 0 for k in r["launches"][0]})


def phase_cells(card):
    """[16] the other cells, the table ops and the rest of activations,
    math_ops and criterion; returns their main paths' launches."""
    t0 = time.perf_counter()
    by_path = phase_cell_classifiers(card)
    by_path["convlstm"] = phase_convlstm(card)
    by_path["seq_autoencoder"] = phase_seq_autoencoder(card)
    by_path["modules"] = phase_module_sweep(card)
    log(f"[16] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# ------------------------------------------------------------------ [17]
# [17a] a Siamese ResNet-50 (Koch et al. 2015, "Siamese Neural Networks for
# One-shot Image Recognition", with the flagship as the tower): the
# flagship's trunk, conv7 stem, a 128-wide embedding, at two nodes of an
# outer Graph; CosineEmbeddingCriterion(margin=0.5) on +-1 targets; 64
# seeded pairs a step (the flagship's 128 images of 224x224), bf16 compute
# and activations, SGD 0.01 momentum 0.9; one warm-up iteration, then 10
SIAMESE = {"pairs": 64, "hw": 224, "embed": 128, "iters": 11, "margin": 0.5}
SIAMESE_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes above
# The shared model against two unshared copies of the trunk with the same
# weights, one train-mode forward and backward in f32 (TF32 off,
# deterministic cuDNN) at 8 pairs, fixed before the first run: each site's
# gradient is the same arithmetic as its copy's, and autograd adds the two
# sites' fp32 gradients once, as the check adds the copies' (an fp32 sum of
# two terms is the same in either order), so the gradients are expected
# equal to the bit; the limit, 1e-6 of each leaf's L2 norm, leaves room for
# cuDNN choosing another deterministic algorithm for the shared weight's
# accumulation and nothing more. The BN running statistics: every site
# reads the pre-step statistics and the last site's update is kept, so the
# shared model's must equal the second copy's (the same limit).
SIAMESE_PAIR_TOL = 1e-6
SIAMESE_CHECK_PAIRS = 8
# Card vs CPU over 3 f32 steps at 2 pairs of 224x224: the flagship's trunk
# and its BN state through the same ReLU gates as [7]'s route, so [7]'s
# limits and their reasons (ROUTE_TOL) hold it.
SIAMESE_ROUTE_PAIRS = 2
MODULE_FILE_DIR = "build/module_file"  # [17b]'s files, removed after


def siamese_model(device, embed: int = 128, depth: int = 50, dataset: str = "imagenet"):
    """ResNet(depth, class_num=embed) as one tower at two nodes:
    Table(images a, images b) -> Table(embedding a, embedding b)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import ResNet

    tower = ResNet(depth, class_num=embed, dataset=dataset, stem="conv7",
                   device=device).set_name("tower")
    a, b = nn.Input(), nn.Input()
    return nn.Graph([a, b], [tower.inputs(a), tower.inputs(b)], device=device)


def _unshared_model(device, embed: int):
    """Two towers, one a site: the shared model's second reading."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import ResNet

    a, b = nn.Input(), nn.Input()
    ta = ResNet(50, class_num=embed, stem="conv7", device=device).set_name("tower_a")
    tb = ResNet(50, class_num=embed, stem="conv7", device=device).set_name("tower_b")
    return nn.Graph([a, b], [ta.inputs(a), tb.inputs(b)], device=device)


def siamese_pairs(n: int, hw: int, seed: int):
    """(images a, images b, targets +-1): seeded normal images, as
    ``flagship_model`` draws its images."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xa = rng.standard_normal((n, 3, hw, hw)).astype(np.float32)
    xb = rng.standard_normal((n, 3, hw, hw)).astype(np.float32)
    return xa, xb, np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)


def _siamese_device():
    return "cpu" if SIAMESE_DEVICE == "cpu" else "cuda"


def phase_siamese(card):
    """[17a] Train the Siamese ResNet-50; returns (model, counts)."""
    import numpy as np
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.analysis import ParamAudit
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.table import T

    c = SIAMESE
    xa, xb, y = siamese_pairs(c["pairs"], c["hw"], SEED + 40)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    RandomGenerator.set_seed(40)
    t0 = time.perf_counter()
    model = siamese_model(_siamese_device(), c["embed"])
    try:
        opt = LocalOptimizer(model, DataSet.array(T(xa, xb), y, batch_size=c["pairs"]),
                             nn.CosineEmbeddingCriterion(margin=c["margin"]))
        opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(c["iters"]))
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            opt.optimize()
            _sync()
            counts = read_counts()  # the main path ends here
        hist = opt.history
        losses = [h["loss"] for h in hist]
        tower = model[0]
        log(f"[17a] Siamese ResNet-50 (conv7 tower at two nodes, {c['embed']}-wide embedding): "
            f"{model.n_parameters() / 1e6:.3f} M params in {len(list(model.children()))} "
            f"registered child ({tower.name()}: {tower.n_parameters() / 1e6:.3f} M), "
            f"{c['pairs']} pairs of {c['hw']}x{c['hw']} a step (bf16 compute and activations, "
            f"CosineEmbedding margin {c['margin']}, SGD 0.01 momentum 0.9): {len(hist)} "
            f"iterations in {time.perf_counter() - t0:.2f} s (build included), losses "
            + ", ".join(f"{v:.4f}" for v in losses) + f"; launches {_nonzero(counts)}")
        _step_ms(hist, 2 * c["pairs"], "images", card)
        if len(losses) != c["iters"] or not all(np.isfinite(losses)):
            raise AssertionError(f"[17a] losses {losses}")
        if list(model.children()) != [tower] or model.n_parameters() != tower.n_parameters():
            raise AssertionError("[17a] the shared tower is not one parameter set")
        want = {n: (2 if n == "maxpool2d_bwd" else 0) for n in read_counts()}
        _check_launch_steps("[17a] Siamese ResNet-50", probe, c["iters"], want, mem_from=2)
        if counts != {n: v * c["iters"] for n, v in want.items()}:
            raise AssertionError(f"[17a] launched {_nonzero(counts)}")
        t1 = time.perf_counter()
        found = ParamAudit(model).check()
        log(f"    ParamAudit of the trained model: {len(found)} findings in "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms (the tower at two nodes is sharing, "
            "not aliasing)")
        dev_ms, wall_ms, share = _busy_share(opt, 2)
        log(f"    host/device split (2 more iterations under torch.profiler): device "
            f"{dev_ms:.2f} ms of {wall_ms:.2f} ms a step ({100 * share:.1f}% busy); card {card}")
        del opt
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
    _free()
    _siamese_against_copies(model)
    _free()
    _siamese_routes()
    return model, counts


def _siamese_against_copies(model):
    """The shared gradient against the sum of two unshared copies', and the
    shared BN statistics against the second copy's, one train-mode forward
    in f32 (TF32 off, deterministic cuDNN) at SIAMESE_CHECK_PAIRS pairs."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, nn
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state
    from bigdl_tpu_torch.utils.table import T

    c = SIAMESE
    dev = _siamese_device()
    xa, xb, y = siamese_pairs(SIAMESE_CHECK_PAIRS, c["hw"], SEED + 41)
    x = T(torch.from_numpy(xa).to(dev), torch.from_numpy(xb).to(dev))
    yt = torch.from_numpy(y).to(dev)
    params = _tree_to_numpy(model.get_parameters()["tower"])
    state = _tree_to_numpy(model.get_state()["tower"])
    copies = _unshared_model(dev, c["embed"])
    copies.init(sample_input=T(xa[:2], xb[:2]))
    load_jax_params(copies, {"tower_a": _nest(params), "tower_b": _nest(params)})
    load_jax_state(copies, {"tower_a": _nest(state), "tower_b": _nest(state)})
    prev = (Engine.compute_dtype(), Engine.activation_dtype(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    crit = nn.CosineEmbeddingCriterion(margin=c["margin"])
    try:
        out = {}
        for label, m in (("shared", model), ("copies", copies)):
            y_out, new_state = m.apply(m.get_parameters(), m.get_state(), x, training=True)
            named = list(m.named_parameters())
            grads = torch.autograd.grad(crit._apply(y_out, yt), [p for _, p in named])
            out[label] = ({n: g.detach() for (n, _), g in zip(named, grads)},
                          _tree_to_numpy(new_state))
            del y_out, grads
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = prev[2:]
    (g_shared, s_shared), (g_copies, s_copies) = out["shared"], out["copies"]
    worst_g, equal_g = 0.0, 0
    for name, g in g_shared.items():
        leaf = name[len("tower."):]
        total = g_copies["tower_a." + leaf] + g_copies["tower_b." + leaf]
        d = float(torch.linalg.vector_norm((g - total).double()) /
                  max(float(torch.linalg.vector_norm(total.double())), 1e-30))
        worst_g = max(worst_g, d)
        equal_g += bool(torch.equal(g, total))
    worst_s, equal_s = 0.0, 0
    for name, v in s_shared.items():
        w = s_copies["tower_b." + name[len("tower."):]]
        worst_s = max(worst_s, float(np.linalg.norm(v - w) / max(np.linalg.norm(w), 1e-30)))
        equal_s += bool(np.array_equal(v, w))
    log(f"    shared vs two unshared copies (f32, TF32 off, deterministic cuDNN, "
        f"{SIAMESE_CHECK_PAIRS} pairs): gradient vs the copies' sum, worst leaf rel L2 "
        f"{worst_g:.2e} ({equal_g} of {len(g_shared)} leaves equal to the bit); BN running "
        f"statistics vs the second copy's, worst {worst_s:.2e} ({equal_s} of {len(s_shared)} "
        f"equal to the bit); limit {SIAMESE_PAIR_TOL}")
    if worst_g > SIAMESE_PAIR_TOL or worst_s > SIAMESE_PAIR_TOL:
        raise AssertionError("[17a] the shared tower disagrees with its unshared copies")
    del copies, out, g_shared, g_copies


def _siamese_routes():
    """3 f32 SGD steps of the Siamese ResNet-50 on the card (#10) vs on the
    CPU (its plain version) at SIAMESE_ROUTE_PAIRS pairs, one set of weights
    and BN state (ROUTE_TOL, [7]'s limits)."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state
    from bigdl_tpu_torch.utils.table import T

    c = SIAMESE
    xa, xb, y = siamese_pairs(SIAMESE_ROUTE_PAIRS, c["hw"], SEED + 42)
    x = T(xa, xb)
    prev = (Engine.compute_dtype(), Engine.activation_dtype(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        RandomGenerator.set_seed(SEED + 42)
        init = siamese_model("cpu", c["embed"])
        init.init(sample_input=x)
        w0 = {k: v.detach().numpy().copy() for k, v in init.named_parameters()}
        s0 = _tree_to_numpy(init.get_state())
        del init
        runs = {}
        for device in (_siamese_device(), "cpu"):
            m = siamese_model(device, c["embed"])
            m.init(sample_input=x)
            load_jax_params(m, _nest(w0))
            load_jax_state(m, _nest(s0))
            o = LocalOptimizer(m, DataSet.array(x, y, batch_size=SIAMESE_ROUTE_PAIRS),
                               nn.CosineEmbeddingCriterion(margin=c["margin"]))
            o.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
            reset_counts()
            t0 = time.perf_counter()
            o.set_end_when(Trigger.max_iteration(3)).optimize()
            runs[device] = ([h["loss"] for h in o.history], _tree_to_numpy(m.get_parameters()),
                            _tree_to_numpy(m.get_state()), read_counts()["maxpool2d_bwd"],
                            time.perf_counter() - t0)
            del m, o
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[2:]
    (lc, pc, sc, kc, tc), (lp, pp, sp, kp, tp) = runs[_siamese_device()], runs["cpu"]

    def dist(a, b):
        return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b)))

    d_first = abs(lc[0] - lp[0])
    d_loss = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(lc[1:], lp[1:]))
    d_params = dist(pc, pp) / dist(pp, {k: np.zeros_like(v) for k, v in pp.items()})
    d_update = dist(pc, pp) / dist(pp, w0)
    d_state = dist(sc, sp) / dist(sp, s0)
    log(f"    kernel route (card, f32, TF32 off) vs plain route (CPU, f32), Siamese ResNet-50, "
        f"{SIAMESE_ROUTE_PAIRS} pairs of {c['hw']}x{c['hw']}, 3 steps of SGD lr 0.01 momentum "
        f"0.9: losses {[round(v, 6) for v in lc]} vs {[round(v, 6) for v in lp]}; step 1 diff "
        f"{d_first:.2e} (tol {ROUTE_TOL['loss_first']}), steps 2-3 rel diff {d_loss:.2e} (tol "
        f"{ROUTE_TOL['loss']}); params rel diff {d_params:.2e} (tol {ROUTE_TOL['params']}); "
        f"update rel diff {d_update:.2e} (logged); BN state diff / its change {d_state:.2e} "
        f"(tol {ROUTE_TOL['state']}); maxpool2d_bwd launches card {kc}, CPU {kp}; {tc:.1f} s "
        f"card, {tp:.1f} s CPU")
    want = 6 if _siamese_device() != "cpu" else 0
    if (len(lc) != 3 or kc != want or kp != 0 or d_first > ROUTE_TOL["loss_first"]
            or d_loss > ROUTE_TOL["loss"] or d_params > ROUTE_TOL["params"]
            or d_state > ROUTE_TOL["state"]):
        raise AssertionError("the Siamese kernel route disagrees with the plain route")


# [17b] the trained model's file loaded in a fresh process on the card:
# both processes take cuDNN's deterministic algorithms (benchmark off) and
# the same bf16 policy, the file holds every f32 parameter and BN statistic
# exactly, and an eval forward reads nothing else, so the child's outputs
# must equal the parent's to the bit. The served rows: [12]'s limit against
# the loaded model's batch-1 forward (SERVE_DIRECT_REL: a flush batches other
# records, and cuDNN may take other bf16 algorithms at another batch).
MODULE_FILE_PAIRS = 4
SERVED_REQUESTS = (4, 4)  # 4 synchronous clients x 4 requests
_CHILD = """
import sys, time
sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from bigdl_tpu_torch import Engine, nn
from bigdl_tpu_torch.utils.table import T

torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
Engine.set_compute_dtype("bfloat16")
Engine.set_activation_dtype("bfloat16")
t0 = time.perf_counter()
m = nn.load_module(sys.argv[2])
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
m.evaluate()
pairs = np.load(sys.argv[3])
with torch.no_grad():
    out = m.forward(T(pairs[0], pairs[1]))
np.save(sys.argv[4], np.stack([o.float().cpu().numpy() for o in out]))
print(f"{load_s:.3f} {next(m.parameters()).device}")
"""


def phase_module_file(card, model):
    """[17b] save_module / nn.load_module in a fresh process, then the
    flagship's file served; returns the path's counts."""
    import os
    import shutil

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.models import flagship_model
    from bigdl_tpu_torch.serving import ModelServer
    from bigdl_tpu_torch.utils.table import T

    d = ROOT / MODULE_FILE_DIR
    d.mkdir(parents=True, exist_ok=True)
    path, pairs_path, out_path = d / "siamese.npz", d / "pairs.npy", d / "child_out.npy"
    xa, xb, _ = siamese_pairs(MODULE_FILE_PAIRS, SIAMESE["hw"], SEED + 43)
    np.save(pairs_path, np.stack([xa, xb]))
    prev = (Engine.compute_dtype(), Engine.activation_dtype(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    try:
        reset_counts()  # the main path starts here
        t0 = time.perf_counter()
        model.save_module(str(path))
        save_s = time.perf_counter() - t0
        with np.load(path) as z:
            if "__bigdl__" not in z.files:
                raise AssertionError("[17b] save_module wrote the arrays-only fallback")
            top = json.loads(bytes(z["__bigdl__"]).decode())["topology"]
        model.evaluate()
        with torch.no_grad():
            out = model.forward(T(xa, xb))
        parent = np.stack([o.float().cpu().numpy() for o in out])
        model.train()
        t1 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT), str(path), str(pairs_path),
                            str(out_path)], capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t1
        if r.returncode != 0:
            raise AssertionError(f"[17b] the child process failed: {r.stderr[-3000:]}")
        load_s, child_device = r.stdout.split()[-2:]
        child = np.load(out_path)
        same = bool(np.array_equal(child, parent))
        log(f"[17b] save_module: {os.path.getsize(path) / 1e6:.1f} MB (topology record: "
            f"{top['module']}.{top['class']} of {len(top['graph']['nodes'])} nodes, "
            f"{len(top['graph']['modules'])} modules) in {save_s:.2f} s; a fresh process (jax and bigdl_tpu blocked) loaded it on "
            f"{child_device} in {float(load_s):.2f} s (build from the recorded "
            f"{SIAMESE['pairs']}-pair spec, one forward, plus the copy; {child_s:.1f} s with "
            f"the process's start), its eval outputs of {MODULE_FILE_PAIRS} pairs equal to the "
            f"parent's to the bit: {same} (max |diff| "
            f"{float(np.abs(child - parent).max()):.3e}); card {card}")
        if not same or not child_device.startswith("cuda"):
            raise AssertionError("[17b] the loaded model's outputs differ from the parent's")
        # the flagship's file, loaded and served
        Engine.set_activation_dtype(None)  # [12]'s policy: bf16 products, f32 activations
        RandomGenerator.set_seed(1)
        flagship, x, _, name = flagship_model(batch=SERVE_BATCH, seed=SEED, stem="conv7",
                                              device=_siamese_device())
        flagship.init(sample_input=x)
        fpath = d / "flagship.npz"
        flagship.save_module(str(fpath))
        t2 = time.perf_counter()
        loaded = nn.load_module(str(fpath))
        _sync()
        fload_s = time.perf_counter() - t2
        same_w = all(torch.equal(a, b) for a, b in zip(flagship.parameters(), loaded.parameters()))
        del flagship
        loaded.evaluate()
        with ModelServer() as server:
            server.register("flagship", loaded, sample_input=x[0], batch_size=SERVE_BATCH,
                            max_delay_ms=SERVE_DELAY_MS)
            wall, done = _serve_mix(server, x, *SERVED_REQUESTS, seed0=2000)
        worst = 0.0
        with torch.no_grad():
            for i, fut in done:
                direct = loaded.forward(x[i:i + 1])[0].float().cpu().numpy()
                worst = max(worst, _rel(fut.result().float().numpy(), direct))
        _sync()
        counts = read_counts()  # the main path ends here
        log(f"    {name} (conv7, bf16 compute): its file {os.path.getsize(fpath) / 1e6:.1f} MB "
            f"loaded in the parent in {fload_s:.2f} s (build from the recorded "
            f"{tuple(x.shape)} spec, one forward, plus the copy), every weight equal: {same_w}; "
            f"served {len(done)} requests from {SERVED_REQUESTS[0]} clients in {wall:.2f} s, "
            f"worst row vs the loaded model's batch-1 forward {worst:.2e} (limit "
            f"{SERVE_DIRECT_REL}); launches {_nonzero(counts)}; card {card}")
        if not same_w or len(done) != SERVED_REQUESTS[0] * SERVED_REQUESTS[1] \
                or worst > SERVE_DIRECT_REL or any(counts.values()):
            raise AssertionError("[17b] the loaded flagship did not serve its own rows")
        del loaded, done
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2:]
        shutil.rmtree(d, ignore_errors=True)
    _free()
    return counts


def phase_validate(card):
    """[17c] The static passes on the flagship before its first step;
    returns the path's counts."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.analysis import (GraphValidator, ParamAudit, ParamAuditError,
                                          ShapeInferenceError, ShapeProp)
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models import ResNet, flagship_model
    from bigdl_tpu_torch.nn.module import to_spec
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    dev = _siamese_device()
    try:
        RandomGenerator.set_seed(3)
        model, x, labels, name = flagship_model(batch=SERVE_BATCH, seed=SEED + 44, stem="conv7",
                                                device=dev)
        _sync()
        reset_counts()  # the main path starts here
        mem0 = _mem()
        t0 = time.perf_counter()
        for m in model.walk():
            if isinstance(m, nn.Graph):
                GraphValidator(m).check()
        gv_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        spec = ShapeProp(model).infer(to_spec(x))
        sp_ms = (time.perf_counter() - t0) * 1e3
        _sync()
        sp_counts, mem1 = read_counts(), _mem()
        if any(sp_counts.values()) or mem1 != mem0 or model.is_built():
            raise AssertionError(f"[17c] ShapeProp launched {_nonzero(sp_counts)} or moved "
                                 f"device memory {mem0} -> {mem1} or built the model")
        opt = LocalOptimizer(model, DataSet.array(x, labels, batch_size=SERVE_BATCH),
                             nn.ClassNLLCriterion())
        opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(1)).optimize()
        t0 = time.perf_counter()
        ParamAudit(model).check()
        pa_ms = (time.perf_counter() - t0) * 1e3
        model.evaluate()
        with torch.no_grad():
            y = model.forward(x)
        model.train()
        log(f"[17c] {name} (conv7, bf16), before its first step: GraphValidator {gv_ms:.2f} ms, "
            f"ShapeProp {sp_ms:.2f} ms (launches {_nonzero(sp_counts)}, device memory "
            f"{mem0} -> {mem1} B, the model still unbuilt), ParamAudit {pa_ms:.2f} ms (161 "
            f"leaves, one host transfer); ShapeProp's spec {tuple(spec.shape)} "
            f"{str(spec.dtype)[6:]}, the real forward's {tuple(y.shape)} {str(y.dtype)[6:]}; "
            f"one step {opt.history[0]['loss']:.4f}; card {card}")
        if (tuple(spec.shape), spec.dtype) != (tuple(y.shape), y.dtype):
            raise AssertionError("[17c] ShapeProp's spec is not the forward's")
        # validate=False trains
        opt = LocalOptimizer(model, DataSet.array(x, labels, batch_size=SERVE_BATCH),
                             nn.ClassNLLCriterion(), validate=False)
        opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(2)).optimize()
        off = [h["loss"] for h in opt.history]
        del opt, model, y
        _free()
        # a wrong width: refused on the host, nothing allocated on the card
        bad = ResNet(50, class_num=1000, stem="conv7", device=dev)
        fc = next(m for m in bad.walk() if m.name() == "fc")
        fc.input_size = 2047  # the pooled trunk gives 2048
        mem2 = _mem()
        opt = LocalOptimizer(bad, DataSet.array(x, labels, batch_size=SERVE_BATCH),
                             nn.ClassNLLCriterion())
        try:
            opt.optimize()
            raise AssertionError("[17c] the broken flagship trained")
        except ShapeInferenceError as e:
            err = e
        mem3 = _mem()
        path_ok = (err.module_path[0].startswith("Graph(")
                   and err.module_path[-1] == "Linear(fc)")
        log(f"    a flagship with fc declared {fc.input_size} wide: ShapeInferenceError at "
            f"{'/'.join(err.module_path)} before any step ({len(opt.history)} steps, built "
            f"{bad.is_built()}, device memory {mem2} -> {mem3} B): {str(err)[:160]}...")
        if not path_ok or opt.history or bad.is_built() or mem3 != mem2:
            raise AssertionError("[17c] the broken flagship was not stopped before its step")
        del opt, bad, err
        # aliasing: two Linear layers handed one weight
        twin = nn.Sequential(nn.Linear(512, 512, device=dev).set_name("a"),
                             nn.Linear(512, 512, device=dev).set_name("b"), device=dev)
        twin.init(sample_input=np.zeros((4, 512), np.float32))
        twin[1]._param_tree = dict(twin[1]._param_tree, weight=twin[0]._param_tree["weight"])
        try:
            ParamAudit(twin).check()
            raise AssertionError("[17c] ParamAudit accepted an aliased weight")
        except ParamAuditError as e:
            log(f"    two Linear layers handed one weight: ParamAuditError ({e})")
        _sync()
        counts = read_counts()  # the main path ends here
        log(f"    validate=False: 2 steps, losses {[round(v, 4) for v in off]}; the path's "
            f"launches {_nonzero(counts)}")
        if not all(np.isfinite(off)) or len(off) != 2:
            raise AssertionError(f"[17c] validate=False losses {off}")
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
    _free()
    return counts


def phase_graphs(card):
    """[17] graphs with shared modules, the static analysis and the model
    file; returns their main paths' launches."""
    t0 = time.perf_counter()
    model, counts = phase_siamese(card)
    by_path = {"siamese": counts, "module_file": phase_module_file(card, model)}
    del model
    _free()
    by_path["validate"] = phase_validate(card)
    log(f"[17] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# ------------------------------------------------------------------ [18]
# [18a] MaskRCNN(n_classes=81) at the class's defaults (backbone (32, 64,
# 128, 256), FPN 128, 256 pre-NMS and 64 post-NMS proposals, 16 detections,
# box pool 7, mask pool 14; 81 = COCO's 80 classes and the background),
# random f32 weights from a seed, eval mode, served batch 2 of 800x1344
# images: maskrcnn-benchmark's test sizes (INPUT.MIN_SIZE_TEST 800,
# MAX_SIZE_TEST 1333, padded to SIZE_DIVISIBILITY 32), drawn as
# flagship_model draws its images. Nothing is cut.
DETECTION_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes below
MASKRCNN_COCO = {"n_classes": 81, "batch": 2, "hw": (800, 1344), "timed": 10}
DET_ROUTE_HW = (256, 256)  # [18a'] one image, card vs CPU, f32, TF32 off
# [18a'] limits, fixed before the first run (|card - cpu| against the CPU's
# values; "rel" is the L2 norm of the difference over the CPU's L2 norm,
# "max" the largest difference over the CPU's largest magnitude):
# * backbone and FPN features, the RPN's logits and deltas: fp32 sums of up
#   to 1152 products a convolution taken in another order (cuDNN's
#   algorithms, Winograd's transforms among them), through up to 11 stacked
#   convolutions: a few 1e-6 a layer;
# * RoiAlign of the same rois on the same features: the same gathers and
#   lerps elementwise (each division by a constant rounded once on both,
#   ``precision.true_div``), the 2x2 sample mean summed in another order;
# * the heads on the same pooled input: one matmul or convolution chain
#   (K <= 6272) in another order;
# * the proposals from the CPU's own logits and deltas, decoded on the card:
#   exp and log a unit in the last place apart, so the selection must be
#   the CPU's and each box within 1e-4 px (boxes reach 256 px);
# * NMS indices of the same boxes and scores: equal.
DET_ROUTE_TOL = {"features": (1e-4, 1e-3), "roi_align": (1e-6, 1e-5), "heads": (1e-5, 1e-4),
                 "proposal_px": 1e-4}
# End to end, the share of the card's detections that agree with the CPU's
# (the same row: same label and IoU >= 0.99), fixed before the first run:
# the card's features part from the CPU's by the limits above, so a near-tie
# in the RPN's top-256 order or in a class argmax can flip a detection
DET_AGREE_MIN = 0.75
DET_LOSS_TOL = {"loss": 1e-4, "grad": 1e-3}  # [18c] card vs CPU, same draws and proposals
DET_GT = 8  # [18c] ground truth padded to a fixed G with gt_valid
MODULE_FILE_DET_DIR = "build/module_file_det"  # [18d]'s file, removed after


def _det_device():
    return "cpu" if DETECTION_DEVICE == "cpu" else "cuda"


def _det_twin(model, sample):
    """A CPU MaskRCNN of the same arguments holding ``model``'s weights."""
    from bigdl_tpu_torch.models import MaskRCNN
    from bigdl_tpu_torch.utils.convert import load_jax_params

    m = MaskRCNN(MASKRCNN_COCO["n_classes"], device="cpu")
    m.init(sample_input=sample)
    load_jax_params(m, _nest(_tree_to_numpy(model.get_parameters())))
    return m.evaluate()


def _rel_max(got, want):
    """(L2-relative, max-relative) difference of ``got`` from ``want``, on the CPU."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    d = (g - w).abs()
    return (float(d.norm() / max(float(w.norm()), 1e-30)),
            float(d.max() / max(float(w.abs().max()), 1e-30)))


def _within(label, got, want, tol):
    rel, mx = _rel_max(got, want)
    log(f"    {label}: rel {rel:.3g}, max {mx:.3g} (limits {tol[0]:g}, {tol[1]:g})")
    if not (rel <= tol[0] and mx <= tol[1]):
        raise AssertionError(f"[18a'] {label}: card vs CPU rel {rel:.3g} max {mx:.3g} over the "
                             f"limits {tol}")


def _check_detections(label, out, n, hw, n_classes, d):
    """Shapes and dtypes, valid corner boxes inside the image, scores
    non-increasing over the valid rows (label > 0) and exactly zero on the
    padded ones, labels in [0, n_classes - 1], finite masks."""
    import torch

    boxes, scores, labels, masks = (o.detach().cpu() for o in out)
    want = [(n, d, 4), (n, d), (n, d), (n, d, n_classes, 28, 28)]
    if [tuple(o.shape) for o in (boxes, scores, labels, masks)] != want or \
            labels.dtype != torch.int32 or boxes.dtype != torch.float32:
        raise AssertionError(f"{label}: outputs {[(tuple(o.shape), o.dtype) for o in out]}, "
                             f"expected shapes {want}, int32 labels")
    h, w = hw
    valid = labels > 0
    ok = bool((boxes[..., 2] >= boxes[..., 0]).all() and (boxes[..., 3] >= boxes[..., 1]).all()
              and (boxes >= 0).all() and (boxes[..., 2] <= w).all()
              and (boxes[..., 3] <= h).all())
    ok &= bool(((labels >= 0) & (labels < n_classes)).all() and torch.isfinite(masks).all())
    ok &= bool((scores[~valid] == 0).all() and (boxes[~valid] == 0).all())
    ok &= bool(((scores[:, 1:] <= scores[:, :-1]) | ~valid[:, 1:]).all())
    ok &= bool((valid[:, 1:] <= valid[:, :-1]).all())  # the padding comes last
    if not ok:
        raise AssertionError(f"{label}: invalid detections: boxes {boxes[0, :4].tolist()}, "
                             f"scores {scores.tolist()}, labels {labels.tolist()}")
    return int(valid.sum())


def _cuda_events_ms(fn):
    """(result, device ms by CUDA events, host ms) of one call."""
    import torch

    if not torch.cuda.is_available() or DETECTION_DEVICE == "cpu":
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def _device_events(fn):
    """(device events (kernels, copies, fills), their summed device ms) of
    one call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if DETECTION_DEVICE == "cpu":
        return 0, 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    evs = [ev for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == torch.autograd.DeviceType.CUDA]
    return len(evs), sum(ev.duration_ns() for ev in evs) / 1e6


def phase_maskrcnn_coco(card):
    """[18a] The full-width detector served at COCO's inference size, at
    the port's default policy; returns the path's counts."""
    import torch

    dev = _det_device()
    cfg = MASKRCNN_COCO
    n, (h, w) = cfg["batch"], cfg["hw"]
    # torch's own TF32 defaults (earlier phases' f32 checks turn TF32 off
    # for the rest of the smoke); restored after the path
    prev_tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        return _maskrcnn_coco(card, dev, cfg, n, h, w)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _maskrcnn_coco(card, dev, cfg, n, h, w):
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.models import MaskRCNN

    RandomGenerator.set_seed(SEED + 50)
    model = MaskRCNN(cfg["n_classes"], device=dev).evaluate()
    x = torch.from_numpy(np.random.default_rng(SEED + 51).standard_normal(
        (n, 3, h, w)).astype(np.float32)).to(dev)
    policy = (f"compute dtype {Engine.compute_dtype()}, activation dtype "
              f"{Engine.activation_dtype() or 'float32'}, cuDNN TF32 "
              f"{torch.backends.cudnn.allow_tf32}, matmul TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32}")
    with torch.no_grad():
        t0 = time.perf_counter()
        model.forward(x)  # builds the model; the anchors' base is copied to the card once
        _sync()
        log(f"[18a] MaskRCNN({cfg['n_classes']}) at its defaults, {model.n_parameters():,} "
            f"parameters, batch {n} of {h}x{w} f32 images, eval mode; the port's defaults: "
            f"{policy}")
        log(f"    build and first forward: {time.perf_counter() - t0:.2f} s")
        model.forward(x)  # warm
        _sync()
        reset_counts()  # the main path starts here
        base = _mem()
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        dev_ms, host_ms, mems = [], [], []
        out = None
        for _ in range(cfg["timed"]):
            out = None
            out, dms, hms = _cuda_events_ms(lambda: model.forward(x))
            dev_ms.append(dms)
            host_ms.append(hms)
            mems.append(_mem())
        peak = (torch.cuda.max_memory_allocated() - base) if dev == "cuda" else 0
        if dev == "cuda":
            torch.cuda.set_sync_debug_mode("error")  # any host sync in the forward raises
        try:
            checked = model.forward(x)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        _sync()
        counts = read_counts()  # the main path ends here
        n_events, ev_ms = _device_events(lambda: model.forward(x))
    med = statistics.median(host_ms)
    log(f"    {cfg['timed']} forwards: host {med:.2f} ms median ({min(host_ms):.2f}-"
        f"{max(host_ms):.2f}), device by CUDA events {statistics.median(dev_ms):.2f} ms median "
        f"({min(dev_ms):.2f}-{max(dev_ms):.2f}), {n / med * 1e3:.2f} images/s; card {card}")
    log(f"    one forward under torch.profiler: {n_events} device events (kernels, copies, "
        f"fills), {ev_ms:.2f} ms of device time; device memory after each forward "
        f"{sorted(set(mems))} B above the model's {base} B, peak {peak / 2**30:.2f} GiB above "
        f"it; a forward under set_sync_debug_mode('error'): no host sync")
    if len(set(mems)) != 1:
        raise AssertionError(f"[18a] device memory moved across the timed forwards: {mems}")
    if any(counts.values()):
        raise AssertionError(f"[18a] launched kernels of this repo: {_nonzero(counts)}")
    valid = _check_detections("[18a]", checked, n, (h, w), cfg["n_classes"],
                              model.detections_per_image)
    for a, b in zip(checked, out):
        if not torch.equal(a, b):
            raise AssertionError("[18a] a repeated forward gave other detections")
    _, scores, labels, _ = checked.to_list()
    log(f"    outputs {[tuple(o.shape) for o in checked]}: {valid} valid detections of "
        f"{n * model.detections_per_image}, labels {sorted(set(labels.flatten().tolist()))}, "
        f"scores max {float(scores.max()):.4f} (random weights: softmax over 81 classes "
        f"sits near 1/81, under the 0.05 score threshold, so the scores are 0 and NMS keeps "
        f"proposals in RPN order)")
    del model, x, out, checked
    _free()
    return counts


def _det_stages(model, x):
    """The stages of one forward of ``model`` on ``x`` (f32, no gradient)."""
    import torch

    p, s = model.get_parameters(), model.get_state()
    with torch.no_grad():
        backbone, y = [], x
        for m in model[: model.n_backbone]:
            y = m.forward(y)
            backbone.append(y)
        levels, _ = model.features(p, s, x)
        rpn = model[model.n_backbone + 1]
        logits, deltas, _ = rpn.head(p[rpn.name()], s[rpn.name()], levels[0])
        props = rpn.proposals(logits, deltas)
    return {"backbone": backbone, "levels": levels, "logits": logits, "deltas": deltas,
            "proposals": props}


def _iou_rows(a, b):
    """Row i of ``a`` against row i of ``b``: (..., 4) corner boxes -> IoU."""
    from bigdl_tpu_torch.nn.detection import bbox_iou

    return bbox_iou(a[..., None, :], b[..., None, :])[..., 0, 0]


def phase_maskrcnn_route(card):
    """[18a'] The same class widths at one 256x256 image, card against
    CPU stage by stage, f32 with TF32 off."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.models import MaskRCNN
    from bigdl_tpu_torch.nn.detection import batched_multilevel_roi_align, batched_nms

    dev = _det_device()
    prev = (Engine._compute_dtype, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    Engine.set_compute_dtype("float32")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        RandomGenerator.set_seed(SEED + 52)
        hw = DET_ROUTE_HW
        x = np.random.default_rng(SEED + 53).standard_normal((1, 3) + hw).astype(np.float32)
        model = MaskRCNN(MASKRCNN_COCO["n_classes"], device=dev).evaluate()
        model.init(sample_input=x)
        twin = _det_twin(model, x)
        xc = torch.from_numpy(x)
        card_s, cpu_s = _det_stages(model, xc.to(dev)), _det_stages(twin, xc)
        log(f"[18a'] MaskRCNN(81) at 1 image of {hw[0]}x{hw[1]}, card vs CPU, f32, TF32 off")
        tol = DET_ROUTE_TOL
        for i, (a, b) in enumerate(zip(card_s["backbone"], cpu_s["backbone"])):
            _within(f"backbone level {i} {tuple(b.shape)}", a, b, tol["features"])
        for i, (a, b) in enumerate(zip(card_s["levels"], cpu_s["levels"])):
            _within(f"FPN level {i} {tuple(b.shape)}", a, b, tol["features"])
        _within("RPN logits", card_s["logits"], cpu_s["logits"], tol["features"])
        _within("RPN deltas", card_s["deltas"], cpu_s["deltas"], tol["features"])
        rpn = model[model.n_backbone + 1]
        with torch.no_grad():
            props = rpn.proposals(cpu_s["logits"].to(dev), cpu_s["deltas"].to(dev)).cpu()
        px = float((props - cpu_s["proposals"]).abs().max())
        log(f"    proposals from the CPU's logits and deltas, on the card: max |diff| {px:.3g} "
            f"px (limit {tol['proposal_px']:g})")
        if not px <= tol["proposal_px"]:
            raise AssertionError(f"[18a'] proposals from the same logits differ by {px} px")
        with torch.no_grad():
            props_f = rpn.forward(cpu_s["levels"][0].to(dev)).cpu()
        same = float((_iou_rows(props_f, cpu_s["proposals"]) >= 0.99).float().mean())
        log(f"    proposals from the CPU's FPN level 0 on the card (its own RPN convolution): "
            f"{same:.4f} of rows the CPU's (IoU >= 0.99)")
        levels_c, props_c = cpu_s["levels"], cpu_s["proposals"]
        with torch.no_grad():
            pooled = {d: batched_multilevel_roi_align([v.to(d) for v in levels_c], props_c.to(d),
                                                      model.fpn_scales, (7, 7))
                      for d in (dev, "cpu")}
        _within("RoiAlign of the same rois", pooled[dev], pooled["cpu"], tol["roi_align"])
        heads = {}
        with torch.no_grad():
            for d, m in ((dev, model), ("cpu", twin)):
                heads[d] = m.detect(m.get_parameters(), m.get_state(),
                                    [v.to(d) for v in levels_c], props_c.to(d), hw)[0]
            box_head = model[model.n_backbone + 2]
            flat = pooled["cpu"].reshape((-1,) + pooled["cpu"].shape[2:])
            sc_card, dl_card = box_head.forward(flat.to(dev))
            sc_cpu, dl_cpu = twin[twin.n_backbone + 2].forward(flat)
            mask_in = torch.randn((16, 128, 14, 14), generator=torch.Generator().manual_seed(5))
            mk_card = model[model.n_backbone + 3].forward(mask_in.to(dev))
            mk_cpu = twin[twin.n_backbone + 3].forward(mask_in)
        _within("box head scores, the same pooled input", sc_card, sc_cpu, tol["heads"])
        _within("box head deltas, the same pooled input", dl_card, dl_cpu, tol["heads"])
        _within("mask head, the same input", mk_card, mk_cpu, tol["heads"])
        # NMS on the same boxes and scores: the detector's own (all scores
        # under the threshold, so all zero: a stable order decides) and
        # random scores on the same boxes
        boxes = props_c
        for name, scores in (("zero scores", torch.zeros(boxes.shape[:2])),
                             ("random scores", torch.rand(boxes.shape[:2],
                                                          generator=torch.Generator()
                                                          .manual_seed(6)))):
            keep_card = batched_nms(boxes.to(dev), scores.to(dev), 0.5, 16).cpu()
            keep_cpu = batched_nms(boxes, scores, 0.5, 16)
            if not torch.equal(keep_card, keep_cpu):
                raise AssertionError(f"[18a'] NMS indices of the same boxes, {name}: card "
                                     f"{keep_card.tolist()} CPU {keep_cpu.tolist()}")
        log("    NMS indices of the same boxes (zero and random scores): equal")
        flips = int((heads[dev][2].cpu() != heads["cpu"][2]).sum())
        log(f"    detect() on the same levels and proposals: {flips} label(s) differ")
        with torch.no_grad():
            card_out = [o.cpu() for o in model.forward(xc.to(dev))]
            cpu_out = twin.forward(xc).to_list()
        agree = (card_out[2] == cpu_out[2]) & (_iou_rows(card_out[0], cpu_out[0]) >= 0.99)
        share = float(agree.float().mean())
        log(f"    end to end: {share:.4f} of detections agree (same label, IoU >= 0.99; limit "
            f"{DET_AGREE_MIN})")
        if share < DET_AGREE_MIN:
            raise AssertionError(f"[18a'] {share:.4f} of the card's detections agree with the "
                                 f"CPU's, under {DET_AGREE_MIN}")
    finally:
        Engine.set_compute_dtype(prev[0])
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[1:]
    return model, twin, x


def phase_maskrcnn_example(card):
    """[18b] ``examples/maskrcnn_infer.py`` at its defaults; returns the
    path's counts."""
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.examples import maskrcnn_infer

    Engine.set_compute_dtype(None)  # the example's policy, as in a fresh process
    argv = ["--platform", "cpu"] if DETECTION_DEVICE == "cpu" else []
    log(f"[18b] bigdl_tpu_torch/examples/maskrcnn_infer.py main({argv}):")
    reset_counts()  # the main path starts here
    run = maskrcnn_infer.main(argv)
    _sync()
    counts = read_counts()  # the main path ends here
    r, args = run.results, run.args
    out = [r[k] for k in ("boxes", "scores", "labels", "masks")]
    import torch

    _check_detections("[18b]", [torch.from_numpy(o) for o in out], args.batch_size,
                      (args.image_size, args.image_size), args.classes,
                      run.model.detections_per_image)
    log(f"    first batch {r['first_s']:.2f} s, steady state {r['steady_s'] * 1e3:.2f} ms a batch "
        f"of {args.batch_size}; launches {_nonzero(counts)}; card {card}")
    if any(counts.values()):
        raise AssertionError(f"[18b] launched kernels of this repo: {_nonzero(counts)}")
    return counts


def _coco_blob(hw, seed):
    """A COCO ``instances.json`` of 3 images: polygon and compressed-RLE
    masks, crowd and not, with their boxes."""
    import numpy as np
    from bigdl_tpu_torch.dataset.segmentation import rle_encode, rle_to_string

    h, w = hw
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i in range(3):
        images.append({"id": 100 + i, "file_name": f"{i:012d}.jpg", "height": h, "width": w})
        for k in range(4 + i):
            x0, y0 = rng.uniform(0, w - 64), rng.uniform(0, h - 64)
            bw, bh = rng.uniform(16, 64), rng.uniform(16, 64)
            ann = {"image_id": 100 + i, "category_id": int(rng.choice([1, 3, 18, 44, 90])),
                   "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": int(k == 3)}
            if k % 2 == 0:
                ann["segmentation"] = [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]]
            else:
                mask = np.zeros((h, w), np.uint8)
                mask[int(y0): int(y0 + bh), int(x0): int(x0 + bw)] = 1
                ann["segmentation"] = {"size": [h, w], "counts": rle_to_string(rle_encode(mask))}
            anns.append(ann)
    cats = [{"id": c, "name": f"class{c}"} for c in (1, 3, 18, 44, 90)]
    return {"images": images, "annotations": anns, "categories": cats}


def _gt_of(ds, image, g):
    """The image's non-crowd boxes (x1, y1, x2, y2), 1-based labels and the
    valid mask, padded to ``g`` rows (numpy)."""
    import numpy as np

    boxes, labels = np.zeros((g, 4), np.float32), np.zeros(g, np.int32)
    rows = [a for a in image.annotations if not a.is_crowd][:g]
    for i, a in enumerate(rows):
        x, y, bw, bh = a.bbox
        boxes[i] = [x, y, x + bw, y + bh]
        labels[i] = ds.cat_id_to_idx[a.category_id]
    return boxes, labels, (np.arange(g) < len(rows)).astype(np.float32)


def _det_losses(model, x, gt, props, draws):
    """[18c]'s losses on ``model``'s device: ``rpn_loss`` over the RPN's
    objectness and deltas against its anchors, ``fast_rcnn_loss`` over the
    box head's outputs for ``props``, and the gradients of their sum
    (the four terms' weights 1) to every parameter; returns (losses, grads,
    RPN matches)."""
    import torch
    from bigdl_tpu_torch.nn.detection import (batched_multilevel_roi_align, fast_rcnn_loss,
                                              match_targets, rpn_loss)

    dev = model.device
    p, s = model.get_parameters(), model.get_state()
    boxes, labels, valid = (torch.from_numpy(a).to(dev) for a in gt)
    with torch.enable_grad():
        levels, _ = model.features(p, s, x)
        rpn, box_head = model[model.n_backbone + 1], model[model.n_backbone + 2]
        logits, deltas, _ = rpn.head(p[rpn.name()], s[rpn.name()], levels[0])
        obj, d = rpn.flat_outputs(logits, deltas)
        anchors = rpn.anchor.generate(logits.shape[2], logits.shape[3], rpn.stride, dev)
        rc, rb = rpn_loss(obj[0], d[0], anchors, boxes, valid, [v.to(dev) for v in draws[0]])
        pr = props.to(dev)
        pooled = batched_multilevel_roi_align(levels, pr, model.fpn_scales, (7, 7))
        sc, dl = box_head.apply(p[box_head.name()], s[box_head.name()],
                                pooled.reshape((-1,) + pooled.shape[2:]))[0]
        fc, fb = fast_rcnn_loss(sc, dl, pr[0], boxes, labels, valid,
                                [v.to(dev) for v in draws[1]])
        total = rc + rb + fc + fb
        params = [q for q in model.parameters()]
        grads = torch.autograd.grad(total, params, allow_unused=True)
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        match = match_targets(anchors, boxes, valid)
    return ([float(v.detach()) for v in (rc, rb, fc, fb)],
            {k: g.detach().cpu() for k, g in zip(names, grads) if g is not None},
            match.cpu())


def phase_detection_losses(card, model, twin, x):
    """[18c] A COCO file through ``COCODataset.load``, its ground truth
    padded to a fixed G, the RPN and Fast R-CNN losses on [18a']'s detector
    and their gradients, card against CPU; returns the path's counts."""
    import json as _json
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.dataset.segmentation import COCODataset

    dev = _det_device()
    prev = (Engine._compute_dtype, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    Engine.set_compute_dtype("float32")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        hw = DET_ROUTE_HW
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "instances.json"
            path.write_text(_json.dumps(_coco_blob(hw, SEED + 54)))
            reset_counts()  # the main path starts here
            t0 = time.perf_counter()
            ds = COCODataset.load(str(path), image_root=tmp)
            load_ms = (time.perf_counter() - t0) * 1e3
        kinds = {}
        for img in ds.images:
            for a in img.annotations:
                kinds[(type(a.mask).__name__, a.is_crowd)] = kinds.get(
                    (type(a.mask).__name__, a.is_crowd), 0) + 1
        rle = [a.mask for img in ds.images for a in img.annotations
               if type(a.mask).__name__ == "RLEMasks"]
        areas = [int(m.decode().sum()) for m in rle]
        try:
            import PIL  # noqa: F401  (polygons rasterize through PIL)
            poly = [int(a.mask.decode().sum()) for img in ds.images for a in img.annotations
                    if type(a.mask).__name__ == "PolyMasks"]
            poly_note = f"{len(poly)} polygon masks decoded, areas {poly}"
        except ImportError:
            poly_note = "PIL is not installed here: the polygon masks stay undecoded"
        log(f"[18c] COCODataset.load: {len(ds)} images in {load_ms:.2f} ms, annotations by "
            f"(mask, crowd) {kinds}, {len(rle)} RLE masks decoded (areas {areas}); {poly_note}")
        gt = _gt_of(ds, ds.images[0], DET_GT)
        log(f"    image 0's ground truth: {int(gt[2].sum())} of G={DET_GT} rows valid, labels "
            f"{gt[1].tolist()}")
        xc = torch.from_numpy(x)
        with torch.no_grad():
            props = twin[twin.n_backbone + 1].forward(twin.features(
                twin.get_parameters(), twin.get_state(), xc)[0][0])
        # the ground truth joins the proposals, as the reference's training
        # does (add_gt_proposals): random weights propose no positive roi
        props = torch.cat([props, torch.from_numpy(gt[0])[None]], dim=1)
        rpn = twin[twin.n_backbone + 1]
        n_anchors = len(rpn.anchor.ratios) * (hw[0] // 2) * (hw[1] // 2)
        g = torch.Generator().manual_seed(SEED + 55)
        draws = (tuple(torch.rand((2, n_anchors), generator=g)),
                 tuple(torch.rand((2, props.shape[1]), generator=g)))
        card_l, card_g, card_m = _det_losses(model, xc.to(dev), gt, props, draws)
        _sync()
        counts = read_counts()  # the main path ends here
        cpu_l, cpu_g, cpu_m = _det_losses(twin, xc, gt, props, draws)
    finally:
        Engine.set_compute_dtype(prev[0])
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev[1:]
    names = ("rpn cls", "rpn box", "fast rcnn cls", "fast rcnn box")
    log("    losses card / CPU: " + ", ".join(f"{n} {a:.6f} / {b:.6f}"
                                             for n, a, b in zip(names, card_l, cpu_l)))
    n_pos = int((cpu_m >= 0).sum())
    log(f"    RPN matches: {n_pos} positive, {int((cpu_m == -1).sum())} negative anchors of "
        f"{len(cpu_m)}; equal on the card: {bool(torch.equal(card_m, cpu_m))}")
    if not torch.equal(card_m, cpu_m) or n_pos == 0:
        raise AssertionError("[18c] the RPN's matches differ card vs CPU, or none is positive")
    if not all(np.isfinite(card_l)) or card_l[1] <= 0:
        raise AssertionError(f"[18c] losses {card_l}")
    worst_l = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(card_l, cpu_l))
    heads = [k for k in cpu_g if k.startswith(("rpn.", "box_head."))]
    bad = [k for k in heads if not bool(torch.isfinite(card_g[k]).all())]
    zero = [k for k in heads if float(card_g[k].abs().sum()) == 0]
    worst_g = max(_rel_max(card_g[k], cpu_g[k])[0] for k in cpu_g)
    log(f"    card vs CPU: losses within {worst_l:.3g} (limit {DET_LOSS_TOL['loss']:g}), "
        f"gradients of {len(cpu_g)} leaves within {worst_g:.3g} L2-relative (limit "
        f"{DET_LOSS_TOL['grad']:g}); the heads' {len(heads)} leaves finite, {len(zero)} zero")
    if bad or zero or worst_l > DET_LOSS_TOL["loss"] or worst_g > DET_LOSS_TOL["grad"] or \
            set(card_g) != set(cpu_g):
        raise AssertionError(f"[18c] non-finite {bad} or zero {zero} head gradients, or card "
                             f"vs CPU losses {worst_l:.3g} / gradients {worst_g:.3g} over "
                             f"{DET_LOSS_TOL}")
    if any(counts.values()):
        raise AssertionError(f"[18c] launched kernels of this repo: {_nonzero(counts)}")
    return counts


def phase_maskrcnn_file(card, model, x):
    """[18d] [18a']'s detector through save_module / nn.load_module: the
    same detections to the bit; returns the path's counts."""
    import shutil

    import torch
    from bigdl_tpu_torch import Engine, nn

    dev = _det_device()
    d = ROOT / MODULE_FILE_DET_DIR
    d.mkdir(parents=True, exist_ok=True)
    path = d / "maskrcnn.npz"
    prev = Engine._compute_dtype
    Engine.set_compute_dtype("float32")
    try:
        reset_counts()  # the main path starts here
        t0 = time.perf_counter()
        model.save_module(str(path))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = nn.load_module(str(path), device=dev if dev == "cpu" else None).evaluate()
        load_s = time.perf_counter() - t0
        xt = torch.from_numpy(x).to(dev)
        with torch.no_grad():
            a, b = model.forward(xt).to_list(), loaded.forward(xt).to_list()
        _sync()
        counts = read_counts()  # the main path ends here
        size = path.stat().st_size
    finally:
        Engine.set_compute_dtype(prev)
        shutil.rmtree(d, ignore_errors=True)
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    log(f"[18d] save_module {save_s:.2f} s ({size / 2**20:.1f} MiB), nn.load_module "
        f"{load_s:.2f} s ({type(loaded).__name__} on {loaded.device}); detections equal to the "
        f"bit: {same}; launches {_nonzero(counts)}")
    if not same or type(loaded).__name__ != "MaskRCNN":
        raise AssertionError("[18d] the loaded detector gives other detections")
    if any(counts.values()):
        raise AssertionError(f"[18d] launched kernels of this repo: {_nonzero(counts)}")
    return counts


def phase_detection(card):
    """[18] detection on the card; returns its main paths' launches."""
    t0 = time.perf_counter()
    by_path = {"maskrcnn_coco": phase_maskrcnn_coco(card)}
    model, twin, x = phase_maskrcnn_route(card)
    by_path["maskrcnn_example"] = phase_maskrcnn_example(card)
    by_path["detection_losses"] = phase_detection_losses(card, model, twin, x)
    by_path["maskrcnn_file"] = phase_maskrcnn_file(card, model, x)
    del model, twin
    _free()
    log(f"[18] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# ---------------------------------------------------------------- [19]
# [19] (slice 20) the int8/fp8 serving tiers, MoE, Remat and the tree LSTM.
# None of these paths declares an epilogue or a pool with a backward, so
# only the LayerNorm kernels (#4/#5, under the switch) run: in the MoE
# example and the Remat norm-LM.
SLICE20_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes below
QUANT = {"batch": 128, "hw": 224, "timed": 10, "check_batch": 8, "check_hw": 64}
# [19a] limits, fixed before the first run:
# * int8, each quantized layer on the card's own input to it in one forward
#   of a check batch: the weight codes and scales, the input codes and scale
#   and the int32 accumulator equal the CPU route's to the bit (integer sums;
#   each scale a true division on both, precision.true_div);
# * fp8 likewise, codes and scales to the bit; the float32 accumulator within
#   FP8_ACC_REL of the layer's largest |value|: the card's fp8 tensor cores
#   add products in a narrower accumulator before cuBLASLt promotes partial
#   sums to float32 (no fast accumulation), the CPU adds in float32 in
#   another order;
# * served rows: the activation scales are per flush (the amax of the
#   padded batch), so a row depends on its flush-mates: each checked flush's
#   records are forwarded again at the same geometry, and every served row
#   must equal its row there, int8 to the bit (integer sums, elementwise
#   float ops), fp8 within SERVE_FP8_REL relative L2 (the same kernels on
#   the same shapes; the rows may sit at other positions of the batch).
FP8_ACC_REL = 1e-3
SERVE_FP8_REL = 1e-6
SERVE_FLUSHES_CHECKED = 16
MOE_BENCH = {"hidden": 1024, "experts": 4, "batch": 128, "classes": 1000, "iters": 10,
             "lr": 0.05, "capacity_factor": 2.0}  # bench.py:1046-1050, 1074
MOE_EXAMPLE = {"vocab": 8192, "seq": 2048, "hidden": 512, "experts": 8, "batch": 8,
               "capacity_factor": 1.5, "epochs": 2, "batches": 5}  # the norm-LM's widths
MOE_ROUTE = {"bench_batch": 128, "example_batch": 2, "example_seq": 512}
# [19b] step 1 card (f32, TF32 off) vs CPU from the same weights and batch,
# fixed before the first run: the loss within 1e-5 relative (f32 sums in
# another order through three layers and the experts), the updated weights
# within 1e-5 relative L2, the dropped (token, choice) entries equal (the
# routing reads f32 logits a few ulps apart: a flip needs a near-tie).
MOE_ROUTE_TOL = {"loss": 1e-5, "params": 1e-5}
REMAT_POLICIES = (None, "dots_saveable")
TREE_ARGS = []  # the example's defaults: d 16, h 32, 7 slots, batch 32, 512 trees, 2 epochs
TREE_ROUTE_TOL = {"loss": 1e-5, "params": 1e-5}  # [19d] step 1, f32, card vs CPU


def _s20_device():
    return "cpu" if SLICE20_DEVICE == "cpu" else "cuda"


def _quant_flagship(dev, family=None):
    """The flagship served at bench.py's _measure_int8 configuration:
    ResNet-50 conv7, 1000 classes, weights from seed 1, eval mode; its
    ``family`` twin when given."""
    import numpy as np
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.models import ResNet

    RandomGenerator.set_seed(1)
    m = ResNet(50, class_num=1000, stem="conv7", device=dev)
    m.init(sample_input=np.zeros((1, 3, QUANT["hw"], QUANT["hw"]), np.float32))
    m.evaluate()
    return m.quantize(family) if family else m


def _quant_inputs(model, x):
    """Each quantized layer's input in one eval forward of ``model``."""
    import torch
    from bigdl_tpu_torch.nn import quantized as pq

    seen = {}
    classes = (pq.QuantizedLinear, pq.QuantizedSpatialConvolution)
    origs = {c: c.products for c in classes}

    def wrap(orig):
        def products(self, params, xx):
            if self not in seen:
                seen[self] = xx.detach().clone()
            return orig(self, params, xx)
        return products

    for c in classes:
        c.products = wrap(origs[c])
    try:
        with torch.no_grad():
            model.forward(x)
    finally:
        for c, f in origs.items():
            c.products = f
    return seen


def _bits(t):
    import torch

    t = t.detach().cpu()
    return t.view(torch.uint8) if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) else t


def _quant_layers_card_vs_cpu(family, float_model, qmodel, x):
    """[19a] every quantized layer's weight codes, input codes, scale and
    accumulator on the card against the CPU route on the same input."""
    import torch
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.tensor import quantized as pqt

    floats = [m for m in float_model.walk()
              if type(m) in (nn.Linear, nn.SpatialConvolution, nn.SpatialDilatedConvolution)]
    inputs = _quant_inputs(qmodel, x)
    layers = [m for m in qmodel.walk() if m in inputs]
    if len(layers) != len(floats):
        raise AssertionError(f"[19a] {family}: {len(layers)} quantized layers ran, the float "
                             f"model has {len(floats)} quantizable ones")
    quantizer = pqt.quantize_symmetric if family == "int8" else pqt.quantize_fp8
    worst, n_acc = 0.0, 0
    with torch.no_grad():
        for f, q in zip(floats, layers):
            p = q.get_parameters()
            cpu = {k: v.detach().cpu() for k, v in p.items()}
            ref = quantizer(f.get_parameters()["weight"].detach().cpu(), channel_axis=0)
            if not (torch.equal(_bits(p["weight_q"]), _bits(ref.values))
                    and torch.equal(p["weight_scale"].cpu(), ref.scales)):
                raise AssertionError(f"[19a] {family} {q.name()}: the card's weight codes or "
                                     "scales differ from the CPU's")
            xq, sx, acc = q.products(p, inputs[q])
            cxq, csx, cacc = q.products(cpu, inputs[q].cpu())
            if not (torch.equal(_bits(xq), _bits(cxq)) and torch.equal(sx.cpu(), csx)):
                raise AssertionError(f"[19a] {family} {q.name()}: input codes or scale differ")
            if family == "int8":
                if acc.dtype != torch.int32 or not torch.equal(acc.cpu(), cacc):
                    raise AssertionError(f"[19a] int8 {q.name()}: the int32 accumulators "
                                         "differ from the CPU's")
            else:
                rel = float((acc.cpu() - cacc).abs().max() / cacc.abs().max().clamp_min(1e-30))
                worst = max(worst, rel)
            n_acc += acc.numel()
    return len(layers), n_acc, worst


def _timed_forwards(model, x, n):
    """(device ms median, host ms median) over ``n`` eval forwards after one warm-up."""
    import statistics

    import torch

    with torch.no_grad():
        model.forward(x)
        _sync()
        dev_ms, host_ms = [], []
        for _ in range(n):
            _, d, h = _cuda_events_ms(lambda: model.forward(x))
            dev_ms.append(d)
            host_ms.append(h)
    return statistics.median(dev_ms), statistics.median(host_ms)


def _sync_free(model, x, dev):
    """One eval forward under set_sync_debug_mode("error")."""
    import torch

    if dev != "cuda":
        return
    with torch.no_grad():
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.forward(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _sync()


def phase_quantized(card):
    """[19a] The flagship's float, int8 and fp8 eval forwards timed, each
    quantized layer held card vs CPU, and both tiers served through
    ModelServer(quantize=...) at [12]'s mixes; returns the paths' counts."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine

    dev = _s20_device()
    b, hw = QUANT["batch"], QUANT["hw"]
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(None)
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (b, 3, hw, hw)).astype(np.float32)).to(dev)
    xc = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
        (QUANT["check_batch"], 3, QUANT["check_hw"], QUANT["check_hw"])).astype(np.float32)).to(dev)
    by_path, ips, logits = {}, {}, {}
    float_model = _quant_flagship(dev)
    log(f"[19a] the flagship (ResNet-50 conv7, {float_model.n_parameters() / 1e6:.3f} M params, "
        f"seed 1, eval mode) at bench.py _measure_int8's configuration: batch {b} of {hw}x{hw}, "
        f"bf16 compute; card {card}")
    for family in (None, "int8", "fp8"):
        label = family or "float"
        model = float_model if family is None else _quant_flagship(dev, family)
        reset_counts()  # the main path starts here
        dev_ms, host_ms = _timed_forwards(model, x, QUANT["timed"])
        _sync_free(model, x, dev)
        by_path[f"quant_{label}"] = counts = read_counts()  # the main path ends here
        ips[label] = b / dev_ms * 1e3
        with torch.no_grad():
            logits[label] = model.forward(x).float().cpu()
        kinds = sorted({type(m).__name__ for m in model.walk()
                        if "Quantized" in type(m).__name__ or "Fp8" in type(m).__name__})
        log(f"    {label}: {QUANT['timed']} forwards, device {dev_ms:.3f} ms (CUDA events, "
            f"median), host {host_ms:.3f} ms, {ips[label]:.2f} images/s; {kinds or 'no'} "
            f"quantized layers; no host sync in a forward; launches {_nonzero(counts)}")
        if any(counts.values()):
            raise AssertionError(f"[19a] {label} forward launched {_nonzero(counts)}")
        if family is not None:
            n, n_acc, worst = _quant_layers_card_vs_cpu(family, float_model, model, xc)
            log(f"    {family} card vs CPU on a batch of {QUANT['check_batch']} of "
                f"{QUANT['check_hw']}x{QUANT['check_hw']}: {n} layers, weight and input codes and "
                f"scales equal to the bit, {n_acc:,} accumulator entries "
                + ("equal to the bit (int32)" if family == "int8" else
                   f"within {worst:.3g} of each layer's largest (limit {FP8_ACC_REL})"))
            if worst > FP8_ACC_REL:
                raise AssertionError(f"[19a] fp8 accumulators {worst:.3g} over {FP8_ACC_REL}")
            ref, got = logits["float"], logits[label]
            log(f"    {family} logits vs the float model's on the timed batch: relative L2 "
                f"{float((got - ref).norm() / ref.norm()):.4g}, top-1 agreement "
                f"{float((got.argmax(1) == ref.argmax(1)).float().mean()):.4f}")
            del model
    log(f"    images/s: float {ips['float']:.2f}, int8 {ips['int8']:.2f} "
        f"({ips['int8'] / ips['float']:.3f}x), fp8 {ips['fp8']:.2f} "
        f"({ips['fp8'] / ips['float']:.3f}x)")
    del float_model
    _free()
    for family in ("int8", "fp8"):
        by_path[f"quant_serving_{family}"] = _quant_serving(card, dev, family,
                                                            x.cpu().numpy())
    return by_path


def _quant_serving(card, dev, family, x):
    """[19a'] The flagship registered with quantize=family, served at [12]'s
    mixes; its serve records tagged with the family."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.obs import Telemetry
    from bigdl_tpu_torch.optim import Predictor
    from bigdl_tpu_torch.serving import ModelServer
    from bigdl_tpu_torch.serving.batcher import _nearest_rank

    model = _quant_flagship(dev)
    tel = Telemetry(ring_capacity=SERVE_RING)
    reset_counts()  # the main path starts here
    with ModelServer(telemetry=tel) as server:
        server.register("flagship", model, sample_input=x[0], batch_size=QUANT["batch"],
                        max_delay_ms=SERVE_DELAY_MS, quantize=family)
        info = server.models()["flagship"]
        mixes, n_served = {}, 0
        for label, (clients, per), seed0 in (("A", MIX_A, 0), ("B", MIX_B, 1000)):
            wall, done = _serve_mix(server, x, clients, per, seed0)
            n_served += len(done)
            _settled(server, tel, n_served)
            mixes[label] = (clients, wall, done)
    _sync()
    counts = read_counts()  # the main path ends here
    tags = {r["quantized"] for r in tel.ring.records if r["type"] == "serve"}
    log(f"[19a'] ModelServer.register(quantize={family!r}): models()['quantized'] "
        f"{info['quantized']!r}, warmup {info['warmup_s']:.3f} s, serve records tagged {tags}")
    if info["quantized"] != family or tags != {family}:
        raise AssertionError(f"[19a'] {family}: tagged {info['quantized']!r} / {tags}")
    for label, (clients, wall, done) in mixes.items():
        lats = sorted(f.spans()["total_s"] for _, f in done)
        log(f"    mix {label} ({clients} synchronous clients, {len(done)} requests): "
            f"{len(done) / wall:.2f} requests/s, total_s p50 {_nearest_rank(lats, 50) * 1e3:.3f} "
            f"ms, p99 {_nearest_rank(lats, 99) * 1e3:.3f} ms; card {card}")
    flushes = {}
    for i, f in mixes["A"][2] + mixes["B"][2]:
        flushes.setdefault(f.t_batch, []).append((i, f))
    pred, worst = Predictor(model, QUANT["batch"]), 0.0
    for members in list(flushes.values())[:SERVE_FLUSHES_CHECKED]:
        with torch.inference_mode():
            again = pred.forward_batch(np.stack([x[i] for i, _ in members])).float().cpu()
        for row, (_, f) in zip(again, members):
            got = f.result().float()
            if got.shape != (1000,) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"[19a'] a served row has shape {tuple(got.shape)} or is "
                                     "not finite")
            worst = max(worst, float((got - row).norm() / row.norm()))
    limit = 0.0 if family == "int8" else SERVE_FP8_REL
    log(f"    served rows vs their flush's records forwarded again at the same geometry "
        f"({min(len(flushes), SERVE_FLUSHES_CHECKED)} of {len(flushes)} flushes): relative L2 "
        f"at most {worst:.3g} (limit {limit}); launches {_nonzero(counts)}")
    if worst > limit or any(counts.values()):
        raise AssertionError(f"[19a'] {family}: served rows or launches off")
    del model, pred
    _free()
    return counts


def _bench_moe(k, device, c=None):
    """bench.py's MoE model (BENCH_MOE=1): Linear -> MoE(4 experts, FFN 4H,
    capacity 2.0) -> Linear -> LogSoftMax (``c``: its sizes, default
    ``MOE_BENCH``)."""
    from bigdl_tpu_torch import nn

    c = c or MOE_BENCH
    h = c["hidden"]
    return nn.Sequential(nn.Linear(h, h, device=device),
                         nn.MoE(c["experts"], ffn_size=4 * h, capacity_factor=c["capacity_factor"],
                                router_top_k=k, device=device),
                         nn.Linear(h, c["classes"], device=device), nn.LogSoftMax(device=device),
                         device=device)


def _moe_dropped(moe, tokens):
    """The (token, choice) entries past their expert's capacity in one
    forward of ``moe`` on ``tokens`` (N, D)."""
    import torch
    from bigdl_tpu_torch.parallel.moe import _route, moe_capacity

    e, k = moe.n_experts, moe.router_top_k
    t_local = tokens.shape[0] // e
    cap = moe_capacity(t_local, e, moe.capacity_factor, k)
    w = moe.get_parameters()["router_w"]
    with torch.no_grad():
        logits = tokens.float().reshape(e, t_local, -1) @ w
        return sum(int((~_route(logits[s], e, cap, k)[2]).sum()) for s in range(e))


def _moe_input(model, x):
    """The input the model's MoE sees in an eval forward on ``x`` and the MoE."""
    import torch
    from bigdl_tpu_torch import nn

    moe = next(m for m in model.walk() if isinstance(m, nn.MoE))
    seen = []
    orig = moe._apply_params
    moe._apply_params = lambda p, s, xx, t, r: (seen.append(xx.detach()), orig(p, s, xx, t, r))[1]
    try:
        with torch.no_grad():
            model.forward(x)
    finally:
        del moe._apply_params
    return moe, seen[0].reshape(-1, seen[0].shape[-1])


def _one_step_routes(label, build, x, y, criterion, method, tol):
    """Step 1 from the same weights on the card (f32, TF32 off) and on the
    CPU: losses, updated weights and the MoE's dropped entries."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params

    prev = (Engine.compute_dtype(), Engine.activation_dtype(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        RandomGenerator.set_seed(SEED + 60)
        init = build("cpu")
        init.init(sample_input=x)
        w0 = _tree_to_numpy(init.get_parameters())
        runs = {}
        for dev in (_s20_device(), "cpu"):
            m = build(dev)
            m.init(sample_input=x)
            load_jax_params(m, _nest(w0))
            dropped = _moe_dropped(*_moe_input(m, x))
            o = LocalOptimizer(m, DataSet.array(x, y, batch_size=len(x)), criterion())
            o.set_optim_method(method()).set_end_when(Trigger.max_iteration(1)).optimize()
            runs[dev] = (o.history[0]["loss"], _tree_to_numpy(m.get_parameters()), dropped)
            del m, o
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[2:]
    (lc, pc, dc), (lp, pp, dp) = runs[_s20_device()], runs["cpu"]
    dist = float(np.sqrt(sum(np.sum((pc[k] - pp[k]) ** 2) for k in pp)))
    d_params = dist / float(np.sqrt(sum(np.sum(v ** 2) for v in pp.values())))
    d_loss = abs(lc - lp) / max(1.0, abs(lp))
    log(f"    {label} step 1 card (f32, TF32 off) vs CPU from the same weights: loss {lc:.6f} vs "
        f"{lp:.6f} (rel {d_loss:.2e}, limit {tol['loss']}), updated weights rel L2 "
        f"{d_params:.2e} (limit {tol['params']}), dropped entries {dc} vs {dp}")
    if d_loss > tol["loss"] or d_params > tol["params"] or dc != dp:
        raise AssertionError(f"[19] {label}: step 1 card vs CPU off")


def phase_moe(card):
    """[19b] bench.py's MoE model trained top-1 and top-2, then the MoE
    example's graph at the norm-LM's widths with the switch on; returns the
    paths' counts."""
    import numpy as np
    from bigdl_tpu_torch import Engine, nn
    from bigdl_tpu_torch.examples import moe_train
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids
    from bigdl_tpu_torch.optim import SGD, Adam
    from bigdl_tpu_torch.parallel.moe import moe_capacity

    dev = _s20_device()
    c = MOE_BENCH
    by_path = {}
    gen = np.random.default_rng(0)  # bench.py's draws: one batch a step
    x = gen.standard_normal((c["batch"] * c["iters"], c["hidden"])).astype(np.float32)
    y = gen.integers(0, c["classes"], c["batch"] * c["iters"])
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(None)
    Engine.set_fused_kernels(None)
    for k in (1, 2):
        model = _bench_moe(k, dev)
        moe = model[1]
        label = f"[19b] bench MoE top-{k}"
        by_path[f"moe_bench_top{k}"] = _train_moe_path(
            label, model, x, y, c["batch"], nn.ClassNLLCriterion(),
            SGD(learningrate=c["lr"], momentum=0.9), c["iters"], card)
        _, tokens = _moe_input(model, x[:c["batch"]])
        cap = moe_capacity(len(tokens) // moe.n_experts, moe.n_experts, moe.capacity_factor, k)
        log(f"    capacity {moe.n_experts} shards x {moe.n_experts} experts x {cap} slots; after "
            f"training, dropped (token, choice) entries on batch 1: {_moe_dropped(moe, tokens)} "
            f"of {len(tokens) * k}")
        del model, moe
        _free()
        _one_step_routes(f"bench MoE top-{k}", lambda d, k=k: _bench_moe(k, d),
                         x[:MOE_ROUTE["bench_batch"]], y[:MOE_ROUTE["bench_batch"]],
                         nn.ClassNLLCriterion, lambda: SGD(learningrate=c["lr"], momentum=0.9),
                         MOE_ROUTE_TOL)
    e = MOE_EXAMPLE
    argv = ["--vocab-size", str(e["vocab"]), "--seq-len", str(e["seq"]), "--hidden-size",
            str(e["hidden"]), "--n-experts", str(e["experts"]), "--capacity-factor",
            str(e["capacity_factor"]), "-b", str(e["batch"]), "--max-epoch", str(e["epochs"]),
            "--synthetic-size", str(e["batch"] * e["batches"] * e["seq"] + 1)]
    if dev == "cpu":
        argv += ["--platform", "cpu"]
    Engine.set_compute_dtype(None)  # the example's policy, as in a fresh process
    Engine.set_activation_dtype(None)
    Engine.set_fused_kernels(True)
    try:
        t0 = time.perf_counter()
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            # the example's model, data and optimizer on the layer's dense path
            # (its main trains expert-parallel over spawned ranks: [23e])
            run = moe_train.build(moe_train.parser().parse_args(argv))
            run.model = run.optimizer.optimize()
            run.results["bigram_recovery"] = moe_train.probe_recovery(
                run.model, e["vocab"], e["experts"])[0]
            _sync()
            counts = read_counts()  # the main path ends here
        wall = time.perf_counter() - t0
        hist = run.optimizer.history
        losses = [h["loss"] for h in hist]
        n_steps = e["epochs"] * e["batches"]
        log(f"[19b] examples/moe_train.py's build (dense) at V {e['vocab']}, T {e['seq']}, "
            f"H {e['hidden']}, "
            f"{e['experts']} experts, capacity {e['capacity_factor']}, batch {e['batch']}, "
            f"switch on: {len(hist)} iterations in {wall:.2f} s; losses "
            + ", ".join(f"{v:.4f}" for v in losses)
            + f"; bigram recovery {run.results['bigram_recovery']:.4f}; launches "
            f"{_nonzero(counts)}")
        _step_ms(hist, e["batch"] * e["seq"], "tokens", card)
        per_step = {n: (2 if n in ("layer_norm_fwd", "layer_norm_bwd") else 0) for n in counts}
        _check_launch_steps("[19b] MoE example", probe, n_steps, per_step, mem_from=3)
        want = {n: n_steps * k for n, k in per_step.items()}
        want["layer_norm_fwd"] += 4  # the build's eval forward and the probe's after training
        if counts != want or len(losses) != n_steps or not np.isfinite(losses).all():
            raise AssertionError(f"[19b] MoE example: {len(losses)} steps, launches "
                                 f"{_nonzero(counts)}, expected {_nonzero(want)}")
        by_path["moe_example"] = counts
        ids = planted_bigram_ids(MOE_ROUTE["example_batch"] * MOE_ROUTE["example_seq"] + 1,
                                 e["vocab"], seed=SEED + 61)
        ex_x = ids[:-1].reshape(MOE_ROUTE["example_batch"], MOE_ROUTE["example_seq"])
        ex_y = ids[1:].reshape(ex_x.shape)
        _one_step_routes(
            f"MoE example graph (batch {ex_x.shape[0]} x T {ex_x.shape[1]}, switch on)",
            lambda d: moe_train.moe_lm(e["vocab"], e["hidden"], e["experts"],
                                       e["capacity_factor"], 1, device=d),
            ex_x, ex_y, lambda: nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(),
                                                            size_average=True),
            lambda: Adam(learningrate=3e-3), MOE_ROUTE_TOL)
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_fused_kernels(None)
    del run
    _free()
    return by_path


def _train_moe_path(label, model, x, y, batch, criterion, method, iters, card):
    """``iters`` LocalOptimizer steps with the counts set to 0 just before
    and read just after: finite losses, the aux loss in the objective, 0
    launches a step, memory flat; the step's median ms."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger

    t0 = time.perf_counter()
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), criterion)
    opt.set_optim_method(method).set_end_when(Trigger.max_iteration(iters))
    with _StepProbe() as probe:
        reset_counts()  # the main path starts here
        opt.optimize()
        _sync()
        counts = read_counts()  # the main path ends here
    hist = opt.history
    losses = [h["loss"] for h in hist]
    aux = float(model.auxiliary_loss_tree(model.get_state()))
    log(f"{label}: {model.n_parameters() / 1e6:.3f} M params, batch {batch} of {_describe(x)}: "
        f"{len(hist)} iterations in {time.perf_counter() - t0:.2f} s (build included), losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f" (the last step's load-balancing term "
        f"{aux:.6f}, in the objective); launches {_nonzero(counts)}")
    _step_ms(hist, batch, "records", card)
    _check_no_launch_run(label, probe, counts, losses, iters)
    if not aux > 0:
        raise AssertionError(f"{label}: no load-balancing term in the state")
    dev_ms, wall_ms, share = _busy_share(opt, 2)
    log(f"    host/device split (2 more iterations under torch.profiler): device {dev_ms:.2f} ms "
        f"of {wall_ms:.2f} ms a step ({100 * share:.1f}% busy); card {card}")
    del opt
    return counts


def phase_remat(card):
    """[19c] [9]'s norm-LM (LN, switch on, Adam) with its stage wrapped as
    PipelinedBlocks(nn.Remat(stage), 6) under each policy, against the
    unwrapped model run twice; returns the paths' counts."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    dev = _s20_device()
    c = NORM_LM
    vocab, seq, batch, iters = c["vocab"], c["seq"], c["batch"], c["iters"]
    ids = planted_bigram_ids(c["n_seq"] * seq + 1, vocab, seed=SEED)
    x, y = ids[:-1].reshape(c["n_seq"], seq), ids[1:].reshape(c["n_seq"], seq)
    prev = (Engine.compute_dtype(), Engine.activation_dtype(), Engine._fused_kernels)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(True)
    variants = [("unwrapped", None), ("unwrapped again", None)] + [
        (f"Remat(policy={p!r})", p) for p in REMAT_POLICIES]
    runs, by_path, w_init = {}, {}, None
    try:
        for label, policy in variants:
            wrap = None if label.startswith("unwrapped") else (
                lambda s, p=policy: nn.Remat(s, policy=p, device=dev))
            RandomGenerator.set_seed(SEED)
            model = norm_lm("ln", vocab, c["hidden"], c["stages"], device=dev, wrap=wrap)
            model.init(sample_input=x[:batch])
            w0 = [p.detach().float().cpu().clone() for p in model.parameters()]
            if w_init is None:
                w_init = w0
            elif not all(torch.equal(a, b) for a, b in zip(w_init, w0)):
                raise AssertionError(f"[19c] {label}: other initial weights")
            opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch),
                                 nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(),
                                                             size_average=True))
            opt.set_optim_method(Adam(learningrate=3e-3)).set_end_when(Trigger.max_iteration(iters))
            _free()
            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()
            base = _mem()
            with _StepProbe() as probe:
                reset_counts()  # the main path starts here
                opt.optimize()
                _sync()
                counts = read_counts()  # the main path ends here
            peak = (torch.cuda.max_memory_allocated() - base) if dev == "cuda" else 0
            hist = opt.history
            step_ms = statistics.median(h["wall_s"] for h in hist[2:]) * 1e3
            per_step = probe.steps[-1]["launches"]
            runs[label] = ([h["loss"] for h in hist],
                           [p.detach().float().cpu().clone() for p in model.parameters()])
            log(f"[19c] norm-LM/LN, {label}: {len(hist)} iterations, step {step_ms:.2f} ms (median "
                f"of iterations 3-{iters}), peak device memory {peak / 2**30:.3f} GiB above the "
                f"{base / 2**30:.3f} GiB before the run, launches a step {_nonzero(per_step)}, "
                f"the run {_nonzero(counts)}; card {card}")
            n_norm = c["stages"] + 1
            recompute = 0 if label.startswith("unwrapped") else c["stages"]
            want = {n: {"layer_norm_fwd": n_norm + recompute, "layer_norm_bwd": n_norm}.get(n, 0)
                    for n in counts}
            _check_launch_steps(f"[19c] {label}", probe, iters, want, mem_from=3)
            dev_ms, wall_ms, share = _busy_share(opt, 2)
            log(f"    host/device split (2 more iterations under torch.profiler): device "
                f"{dev_ms:.2f} ms of {wall_ms:.2f} ms a step ({100 * share:.1f}% busy)")
            key = label.replace(" ", "_") if label.startswith("unwrapped") else str(policy).lower()
            by_path["remat_" + key] = counts
            del opt, model
            _free()
    finally:
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        Engine.set_fused_kernels(prev[2])
    (l0, p0), (l1, p1) = runs["unwrapped"], runs["unwrapped again"]

    def dist(a, b):
        return (max(abs(u - v) for u, v in zip(a[0], b[0])),
                max(float((u - v).abs().max()) for u, v in zip(a[1], b[1])))

    run_to_run = dist(runs["unwrapped"], runs["unwrapped again"])
    log(f"    unwrapped run to run: losses {run_to_run[0]:.3g}, weights {run_to_run[1]:.3g} "
        f"(max abs over {iters} steps)")
    for label, _ in variants[2:]:
        d = dist(runs[label], runs["unwrapped"])
        log(f"    {label} vs unwrapped: losses {d[0]:.3g}, weights {d[1]:.3g} (limit: the "
            "unwrapped run-to-run difference; 0 where the path is deterministic)")
        if d[0] > run_to_run[0] or d[1] > run_to_run[1]:
            raise AssertionError(f"[19c] {label} departs from the unwrapped run by more than "
                                 "its own run-to-run difference")
    if not np.isfinite(l0).all():
        raise AssertionError("[19c] non-finite losses")
    return by_path


def phase_tree_lstm(card):
    """[19d] examples/treelstm_train.py at its defaults on the card, then
    step 1 card vs CPU; returns the path's counts."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.examples import treelstm_train

    dev = _s20_device()
    argv = list(TREE_ARGS) + (["--platform", "cpu"] if dev == "cpu" else [])
    Engine.set_compute_dtype(None)  # the example's policy, as in a fresh process
    Engine.set_activation_dtype(None)
    Engine.set_fused_kernels(None)
    t0 = time.perf_counter()
    reset_counts()  # the main path starts here
    run = treelstm_train.main(argv)
    _sync()
    counts = read_counts()  # the main path ends here
    step_ms = statistics.median(run.step_ms[2:])
    log(f"[19d] examples/treelstm_train.py at its defaults ({len(run.x)} trees of 7 slots, batch "
        f"{run.args.batch_size}, {run.args.max_epoch} epochs): {len(run.losses)} steps in "
        f"{time.perf_counter() - t0:.2f} s, step {step_ms:.2f} ms (median from step 3, the "
        f"loss pulled each step), root accuracy {run.results['root_accuracy']:.4f}, last loss "
        f"{run.losses[-1]:.4f}; launches {_nonzero(counts)}; card {card}")
    if any(counts.values()) or not np.isfinite(run.losses).all():
        raise AssertionError(f"[19d] launched {_nonzero(counts)} or gave non-finite losses")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        one = ["--synthetic-size", str(run.args.batch_size), "--max-epoch", "1"]
        a = treelstm_train.main(one + (["--platform", "cpu"] if dev == "cpu" else []))
        b = treelstm_train.main(one + ["--platform", "cpu"])
    finally:
        Engine.set_compute_dtype(None)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    pa = [p.detach().cpu() for m in (a.tree, a.head) for p in m.parameters()]
    pb = [p.detach().cpu() for m in (b.tree, b.head) for p in m.parameters()]
    d_params = float(sum(((u - v) ** 2).sum() for u, v in zip(pa, pb)) ** 0.5
                     / sum((v ** 2).sum() for v in pb) ** 0.5)
    d_loss = abs(a.losses[0] - b.losses[0]) / max(1.0, abs(b.losses[0]))
    log(f"    step 1 card (f32, TF32 off) vs CPU: loss {a.losses[0]:.6f} vs {b.losses[0]:.6f} "
        f"(rel {d_loss:.2e}, limit {TREE_ROUTE_TOL['loss']}), weights after it rel L2 "
        f"{d_params:.2e} (limit {TREE_ROUTE_TOL['params']})")
    if d_loss > TREE_ROUTE_TOL["loss"] or d_params > TREE_ROUTE_TOL["params"]:
        raise AssertionError("[19d] step 1 card vs CPU off")
    del run, a, b
    _free()
    return counts


def phase_slice20(card):
    """[19] the quantized tiers, MoE, Remat and the tree LSTM; returns the
    main paths' launches."""
    t0 = time.perf_counter()
    by_path = phase_quantized(card)
    by_path.update(phase_moe(card))
    by_path.update(phase_remat(card))
    by_path["treelstm_example"] = phase_tree_lstm(card)
    log(f"[19] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# ------------------------------------------------------------------ [20]
SLICE21_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes below
KERAS_ARGS = []  # the example's defaults: 2048 synthetic digits, batch 64, 2 epochs: 64 steps
KERAS_POOLS_PER_STEP = 2  # K.MaxPooling2D twice: SpatialMaxPooling 2x2/s2, #10 in the backward
KERAS_ROUTE_ROWS = 64  # [20a] card vs CPU: one batch of the example, dropout 0
# [20b] C3D (Tran et al. 2015, arXiv:1412.0767, Sec. 3.2 / Fig. 3) at its widths, a
# 3x16x112x112 clip, batch 30, UCF101's 101 classes; the clips are drawn from the seed
C3D = {"batch": 30, "clip": (16, 112, 112), "widths": (64, 128, 256, 512, 512), "fc": 4096,
       "classes": 101, "iters": 10, "lr": 0.003, "records": 60}
C3D_ROUTE = {"batch": 2, "clip": (16, 32, 32), "widths": (8, 16, 16, 32, 32), "fc": 64}
# [20c] U-Net (Ronneberger et al. 2015, arXiv:1505.04597, Fig. 1): 572x572 tiles, base
# width 64, 2 classes, served by Model.predict in batches of 4
UNET = {"tiles": 8, "batch": 4, "tile": 572, "base": 64, "classes": 2, "timed": 10}
UNET_ROUTE = {"tiles": 2, "tile": 188, "base": 8}
# [20c] card (f32, TF32 off) vs CPU: max |diff| over max |cpu| of the output (fixed before the
# first run: 23 layers of f32 products summed in other orders)
UNET_ROUTE_REL = 1e-5
SLICE21_MODULE_SHAPE = (256, 256)  # [20d] a 2-D input's shape; the other ranks hold as many values


def _s21_device():
    return "cpu" if SLICE21_DEVICE == "cpu" else "cuda"


def c3d(device, widths, fc, classes, dropout=0.5):
    """C3D through the core API: 3x3x3/s1/p1 ``VolumetricConvolution`` s at
    ``widths`` (conv1a, conv2a, conv3a-b, conv4a-b, conv5a-b), each with a
    ReLU; ``VolumetricMaxPooling`` pool1 1x2x2, pools 2-5 2x2x2, pool5
    padded (0, 1, 1); ``View`` to one vector a clip; fc6 and fc7 ``fc``
    wide with ReLU and ``Dropout(dropout)``; fc8 to ``classes``."""
    from bigdl_tpu_torch import nn

    d = {"device": device}
    w1, w2, w3, w4, w5 = widths
    layers = []

    def conv(cin, cout):
        layers.extend([nn.VolumetricConvolution(cin, cout, 3, 3, 3, 1, 1, 1, 1, 1, 1, **d),
                       nn.ReLU(**d)])

    conv(3, w1)
    layers.append(nn.VolumetricMaxPooling(1, 2, 2, 1, 2, 2, **d))
    conv(w1, w2)
    layers.append(nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, **d))
    for cin, cout in ((w2, w3), (w3, w4), (w4, w5)):
        conv(cin, cout)
        conv(cout, cout)
        pad = (0, 1, 1) if cout == w5 and cin == w4 else (0, 0, 0)
        layers.append(nn.VolumetricMaxPooling(2, 2, 2, 2, 2, 2, *pad, **d))
    layers.extend([nn.View(-1, **d), nn.Linear(None, fc, **d), nn.ReLU(**d), nn.Dropout(dropout, **d),
                   nn.Linear(fc, fc, **d), nn.ReLU(**d), nn.Dropout(dropout, **d),
                   nn.Linear(fc, classes, **d)])
    return nn.Sequential(*layers, **d)


def unet(device, base, classes, tile):
    """The U-Net through the keras functional API: valid 3x3 ReLU
    ``Convolution2D`` pairs at base x (1, 2, 4, 8, 16), ``MaxPooling2D``,
    ``Deconvolution2D(n, 2, 2, subsample=(2, 2))`` up, each skip
    ``Cropping2D``-ed to the up-convolution's size and joined by
    ``Merge(mode="concat", concat_axis=1)``, a 1x1 ``Convolution2D`` to
    ``classes``."""
    from bigdl_tpu_torch.nn import keras as K

    d = {"device": device}

    def pair(x, n):
        x = K.Convolution2D(n, 3, 3, activation="relu", **d)(x)
        return K.Convolution2D(n, 3, 3, activation="relu", **d)(x)

    inp = K.Input(shape=(1, tile, tile))
    skips, sizes, x, s = [], [], inp, tile
    for level in range(4):
        x = pair(x, base * 2 ** level)
        s -= 4
        skips.append(x)
        sizes.append(s)
        x = K.MaxPooling2D(**d)(x)
        s //= 2
    x = pair(x, base * 16)
    s -= 4
    for level in reversed(range(4)):
        x = K.Deconvolution2D(base * 2 ** level, 2, 2, subsample=(2, 2), **d)(x)
        s *= 2
        c = (sizes[level] - s) // 2
        skip = K.Cropping2D(((c, c), (c, c)), **d)(skips[level])
        x = pair(K.Merge(mode="concat", concat_axis=1, **d)([skip, x]), base * 2 ** level)
        s -= 4
    return K.Model(inp, K.Convolution2D(classes, 1, 1, **d)(x), **d), s


def phase_keras_example(card):
    """[20a] ``examples/keras_train.py`` at its defaults through ``fit``: a
    forward hook on the first convolution stashes its output's mean into the
    state at every step; #10 twice a step and nowhere else; then the hook's
    stash against a recomputed mean, its removal, and 3 SGD steps card vs
    CPU of the example's model from the same weights. Returns the counts."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, nn
    from bigdl_tpu_torch.dataset import load_mnist
    from bigdl_tpu_torch.examples import keras_train
    from bigdl_tpu_torch.nn import keras as K

    dev = _s21_device()
    argv = list(KERAS_ARGS) + (["--platform", "cpu"] if dev == "cpu" else [])
    Engine.set_compute_dtype(None)  # the example's policy, as in a fresh process
    Engine.set_activation_dtype(None)
    Engine.set_fused_kernels(None)
    stash, hooked = [], []

    def hook(module, x, y):
        return {"act_mean": y.float().mean()}

    def before_step(opt):
        conv = opt.model[0][0]  # Convolution2D_0's SpatialConvolution, made at the build
        if not hooked:
            hooked.append(conv.register_forward_hook(hook))
        else:
            stash.append(conv.get_state()["act_mean"])

    t0 = time.perf_counter()
    with _StepProbe(before_step) as probe:
        reset_counts()  # the main path starts here
        run = keras_train.main(argv)
        _sync()
        counts = read_counts()  # the main path ends here
    wall = time.perf_counter() - t0
    hist = run.optimizer.history
    losses = [h["loss"] for h in hist]
    n_steps = run.args.max_epoch * ((run.args.synthetic_size or 2048) // run.args.batch_size)
    loss, acc = run.results["validation"]
    log(f"[20a] examples/keras_train.py ({len(hist)} steps of batch {run.args.batch_size}, "
        f"{run.args.max_epoch} epochs, validation every epoch on {keras_train.VALIDATION}) in "
        f"{wall:.2f} s: losses {losses[0]:.4f} -> {losses[-1]:.4f}, final validation loss "
        f"{loss:.4f}, accuracy {acc:.4f}; launches {_nonzero(counts)}")
    _step_ms(hist, run.args.batch_size, "images", card)
    per_step = {n: (KERAS_POOLS_PER_STEP if n == "maxpool2d_bwd" else 0) for n in counts}
    _check_launch_steps("[20a] keras example", probe, n_steps, per_step, mem_from=3)
    want = {n: n_steps * k for n, k in per_step.items()}
    if (counts != want or len(losses) != n_steps or not np.isfinite(losses).all()
            or any(v["launches"] for v in probe.validations) or len(probe.validations) != 2):
        raise AssertionError(f"[20a] {len(losses)} steps, launches {_nonzero(counts)}, expected "
                             f"{_nonzero(want)}; validations {probe.validations}")
    model = run.model
    x = load_mnist(None, synthetic_size=KERAS_ROUTE_ROWS)[0]
    preds, classes = model.predict(x), model.predict_classes(x)
    if preds.shape != (len(x), 10) or classes.shape != (len(x),) or not np.isfinite(preds).all():
        raise AssertionError(f"[20a] predict {preds.shape}, predict_classes {classes.shape}")
    if len(stash) != n_steps - 1 or not all(torch.isfinite(v) for v in stash):
        raise AssertionError(f"[20a] the hook stashed {len(stash)} means in {n_steps} steps")
    conv = model[0][0]
    xt = torch.from_numpy(x).to(conv.device)
    model.train()
    with torch.no_grad():
        model.forward(xt)  # one hooked forward on a known batch
        got = float(conv.get_state()["act_mean"])
        y = type(conv)._apply_params(conv, conv.get_parameters(), {}, xt, False, None)[0]
        want_mean, scale = float(y.float().mean()), float(y.float().abs().mean())
        model.evaluate()
        y_hooked = model.forward(xt).clone()
        hooked[0].remove()
        y_plain = model.forward(xt)
    rel = abs(got - want_mean) / scale
    log(f"    forward hook on the first convolution: {len(stash)} stashes during fit (last "
        f"{float(stash[-1]):.6f}); on a known batch {got:.6f} vs recomputed without the hook "
        f"{want_mean:.6f} (|diff| {rel:.2e} of mean |y|, limit 1e-6); removed, the eval output "
        f"{'equal' if torch.equal(y_hooked, y_plain) else 'CHANGED'} to the bit; predict "
        f"{tuple(preds.shape)}, predict_classes {tuple(classes.shape)}")
    if rel > 1e-6 or not torch.equal(y_hooked, y_plain) or "_apply_params" in conv.__dict__:
        raise AssertionError("[20a] the hook's stash or its removal is off")
    dev_ms, wall_ms, share = _busy_share(run.optimizer, 2)
    log(f"    host/device split (2 more iterations under torch.profiler): device {dev_ms:.2f} ms "
        f"of {wall_ms:.2f} ms a step ({100 * share:.1f}% busy); card {card}")
    del run, model
    _free()
    rng = np.random.default_rng(SEED + 70)
    xr = rng.standard_normal((KERAS_ROUTE_ROWS, 1, 28, 28)).astype(np.float32)
    yr = rng.integers(0, 10, KERAS_ROUTE_ROWS)
    r = _sgd_routes(lambda device: keras_train.cnn(K, dropout=0.0, device=device), xr, yr,
                    SEED + 70, criterion=nn.CrossEntropyCriterion)
    _check_routes("the keras example's CNN (dropout 0)", xr, r, VGG_ROUTE_TOL,
                  {k: (3 * KERAS_POOLS_PER_STEP if k == "maxpool2d_bwd" else 0)
                   for k in r["launches"][0]})
    return counts


def phase_c3d(card):
    """[20b] C3D trained through ``LocalOptimizer`` at its widths (bf16
    compute and activations, SGD 0.003/0.9, ``CrossEntropyCriterion``),
    then 3 f32 SGD steps card vs CPU at a cut width and clip. Returns the
    counts."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.optim import SGD

    dev = _s21_device()
    c = C3D
    t, h, w = c["clip"]
    rng = np.random.default_rng(SEED + 71)
    x = rng.standard_normal((c["records"], 3, t, h, w)).astype(np.float32)
    y = rng.integers(0, c["classes"], c["records"])
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(None)
    try:
        RandomGenerator.set_seed(SEED + 71)
        model = c3d(dev, c["widths"], c["fc"], c["classes"])
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        counts = _train_cells_path(
            f"[20b] C3D ({c['widths']}, fc {c['fc']}, {c['classes']} classes; bf16 compute and "
            "activations)", model, x, y, c["batch"], nn.CrossEntropyCriterion(),
            SGD(learningrate=c["lr"], momentum=0.9), c["iters"], card, "clips")
        peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
        _host_batch_ms(x, y, c["batch"], dev)
        gmac = _c3d_gmac(c["widths"], c["clip"], c["fc"], c["classes"])
        log(f"    peak device memory {peak / 2**30:.2f} GiB; forward {gmac:.2f} GMAC a clip "
            f"(counted from the layer shapes), {3 * gmac * 2 * c['batch'] / 1e3:.2f} TFLOP a step "
            "at 3x the forward")
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
    del model
    _free()
    rc = C3D_ROUTE
    rt, rh, rw = rc["clip"]
    xr = rng.standard_normal((rc["batch"], 3, rt, rh, rw)).astype(np.float32)
    yr = rng.integers(0, c["classes"], rc["batch"])
    r = _sgd_routes(lambda device: c3d(device, rc["widths"], rc["fc"], c["classes"], 0.0), xr, yr,
                    SEED + 72, criterion=nn.CrossEntropyCriterion,
                    method=lambda: SGD(learningrate=c["lr"], momentum=0.9))
    _check_routes(f"C3D cut to widths {rc['widths']}, fc {rc['fc']}, dropout 0", xr, r,
                  VGG_ROUTE_TOL, {k: 0 for k in r["launches"][0]},
                  recipe=f"SGD lr {c['lr']} momentum 0.9")
    return counts


def _host_batch_ms(x, y, batch, dev):
    """The host's share of a step's data path, as ``LocalOptimizer`` 's
    prefetch thread runs it: a batch's gather from the dataset's arrays (the
    host library's threaded ``gather_rows``; numpy fancy indexing beside it)
    and its copy to the card from pinned memory (median of 5 each)."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import DataSet, to_device

    ds = DataSet.array(x, y, batch_size=batch)
    gather, plain, copy = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        b = next(iter(ds.data(train=True)))
        t1 = time.perf_counter()
        to_device(b.get_input(), torch.device(dev))  # pinned, then the card, as a step's
        _sync()
        t2 = time.perf_counter()
        np.ascontiguousarray(x[np.arange(batch)])
        plain.append((time.perf_counter() - t2) * 1e3)
        gather.append((t1 - t0) * 1e3)
        copy.append((t2 - t1) * 1e3)
    log(f"    the host's data path a step: the batch's gather {statistics.median(gather):.2f} ms "
        f"(native gather_rows; numpy fancy indexing {statistics.median(plain):.2f}), its copy "
        f"to the card {statistics.median(copy):.2f} ms ({b.get_input().nbytes / 2**20:.1f} MiB; "
        "medians of 5); both now run on the prefetch thread, behind the step")


def _c3d_gmac(widths, clip, fc, classes):
    """C3D's forward multiply-adds a clip, from its layer shapes."""
    t, h, w = clip
    total, cin = 0, 3
    plan = [(widths[0], (1, 2, 2), (0, 0, 0)), (widths[1], (2, 2, 2), (0, 0, 0)),
            (widths[2], (2, 2, 2), (0, 0, 0)), (widths[3], (2, 2, 2), (0, 0, 0)),
            (widths[4], (2, 2, 2), (0, 1, 1))]
    for i, (cout, k, p) in enumerate(plan):
        for _ in range(1 if i < 2 else 2):
            total += t * h * w * cout * cin * 27
            cin = cout
        t, h, w = ((s + 2 * pp - kk) // kk + 1 for s, kk, pp in zip((t, h, w), k, p))
    flat = cin * t * h * w
    total += flat * fc + fc * fc + fc * classes
    return total / 1e9


def phase_unet(card):
    """[20c] the U-Net served by the keras ``Model.predict`` (bf16 compute
    and activations): CUDA-event ms a call, tiles/s, peak memory, 0
    launches; then card (f32, TF32 off) vs CPU at a 188x188 tile and base
    width 8. Returns the counts."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.utils.convert import load_jax_params

    dev = _s21_device()
    u = UNET
    rng = np.random.default_rng(SEED + 73)
    x = rng.standard_normal((u["tiles"], 1, u["tile"], u["tile"])).astype(np.float32)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    try:
        RandomGenerator.set_seed(SEED + 73)
        model, out_hw = unet(dev, u["base"], u["classes"], u["tile"])
        model.init(sample_input=x[:u["batch"]])
        model.evaluate()
        model.predict(x, batch_size=u["batch"])  # warm: cuDNN's algorithm choice
        _sync()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        timed = []
        reset_counts()  # the main path starts here
        for _ in range(u["timed"]):
            if torch.cuda.is_available():
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = model.predict(x, batch_size=u["batch"])
                end.record()
                _sync()
                timed.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                out = model.predict(x, batch_size=u["batch"])
                timed.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()  # the main path ends here
        peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
        n_events, dev_ms = _device_events(lambda: model.predict(x, batch_size=u["batch"]))
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
    ms = statistics.median(timed)
    n_batches = -(-u["tiles"] // u["batch"])
    log(f"[20c] U-Net (base {u['base']}, {model.n_parameters() / 1e6:.2f} M params) served by "
        f"Model.predict: {u['tiles']} tiles of 1x{u['tile']}x{u['tile']} in batches of "
        f"{u['batch']}, output {tuple(out.shape)}: {ms:.2f} ms a call (median of {u['timed']}, "
        f"CUDA events; {', '.join(f'{v:.2f}' for v in timed)}; min {min(timed):.2f}), "
        f"{ms / n_batches:.2f} ms a batch, "
        f"{u['tiles'] / ms * 1e3:.1f} tiles/s; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {_nonzero(counts)}; card {card}")
    log(f"    one more call under torch.profiler: {n_events} device events, {dev_ms:.2f} ms of "
        f"device work ({100 * dev_ms / ms:.1f}% of the median call)")
    if (tuple(out.shape) != (u["tiles"], u["classes"], out_hw, out_hw)
            or not np.isfinite(out).all() or any(counts.values())):
        raise AssertionError(f"[20c] output {out.shape}, launches {_nonzero(counts)}")
    del model
    _free()
    ru = UNET_ROUTE
    xr = rng.standard_normal((ru["tiles"], 1, ru["tile"], ru["tile"])).astype(np.float32)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        outs, w0 = {}, None
        for d in ("cpu", dev):
            RandomGenerator.set_seed(SEED + 74)
            m, _ = unet(d, ru["base"], u["classes"], ru["tile"])
            m.init(sample_input=xr[:1])
            if w0 is None:
                w0 = _tree_to_numpy(m.get_parameters())
            else:
                load_jax_params(m, _nest(w0))
            outs[d] = m.predict(xr, batch_size=1)
            del m
    finally:
        Engine.set_compute_dtype(None)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    rel = float(np.abs(outs[dev] - outs["cpu"]).max() / np.abs(outs["cpu"]).max())
    log(f"    card (f32, TF32 off) vs CPU, base {ru['base']}, {ru['tiles']} tiles of "
        f"{ru['tile']}x{ru['tile']} -> {tuple(outs['cpu'].shape)} from the same weights: max "
        f"|diff| / max |cpu| {rel:.2e} (limit {UNET_ROUTE_REL})")
    if rel > UNET_ROUTE_REL:
        raise AssertionError("[20c] the U-Net's card route disagrees with the CPU's")
    return counts


def _slice21_cases():
    """(label, maker (device -> module), input maker (rng -> numpy; a list
    is a Table), dtypes) of every other class this slice ported, and the
    keras wrappers of test_keras_breadth.py's table, at sizes of ~1e5
    values an input."""
    import numpy as np
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn import keras as K

    R, W = SLICE21_MODULE_SHAPE
    both, f32 = ("float32", "bfloat16"), ("float32",)

    def x(*shape):
        return lambda rng: rng.standard_normal(shape).astype(np.float32)

    def masked(rng):
        v = rng.standard_normal((R, 32, 8)).astype(np.float32)
        v[:, ::3] = 0.0
        return v

    def index(rng):
        return [rng.standard_normal((R, W)).astype(np.float32),
                rng.integers(1, R + 1, (16, 8)).astype(np.int64)]

    def mask_select(rng):
        v = rng.standard_normal((R, W)).astype(np.float32)
        return [v, (v > 0.3).astype(np.uint8)]

    def m(cls, *a, **k):
        return lambda device: cls(*a, **k, device=device)

    cases = [
        ("View", m(nn.View, W // 4, 4), x(R, W), both),
        ("Squeeze", m(nn.Squeeze, 2), x(R, 1, W), both),
        ("Unsqueeze", m(nn.Unsqueeze, 1), x(R, W), both),
        ("Transpose", m(nn.Transpose, [(2, 3), (1, 2)]), x(R, 16, 16), both),
        ("Contiguous", m(nn.Contiguous), x(R, W), both),
        ("Narrow", m(nn.Narrow, 2, 3, -5), x(R, W), both),
        ("Index", m(nn.Index, 1), index, both),
        ("Padding", m(nn.Padding, 2, -3, 2, 0.5), x(R, 32, 8), both),
        ("SpatialZeroPadding", m(nn.SpatialZeroPadding, 1, 2, 3, 0), x(R // 8, 8, 16, 16), both),
        ("ZeroPadding2D", m(nn.ZeroPadding2D, (2, 1)), x(R // 8, 8, 16, 16), both),
        ("Masking", m(nn.Masking, 0.0), masked, both),
        ("InferReshape", m(nn.InferReshape, (0, -1, 4), True), x(R, 16, 16), both),
        ("Flatten", m(nn.Flatten), x(R, 16, 16), both),
        ("MaskedSelect", m(nn.MaskedSelect), mask_select, both),
        ("UpSampling1D", m(nn.UpSampling1D, 2), x(R, 64, 8), both),
        ("UpSampling2D", m(nn.UpSampling2D, (2, 3)), x(R // 8, 8, 16, 16), both),
        ("UpSampling3D", m(nn.UpSampling3D, (2, 2, 1)), x(R // 8, 4, 8, 8, 8), both),
        ("Cropping1D", m(nn.Cropping1D, (3, 5)), x(R, 64, 8), both),
        ("Cropping2D", m(nn.Cropping2D, ((1, 2), (3, 0))), x(R // 8, 8, 16, 16), both),
        ("Cropping3D", m(nn.Cropping3D, ((1, 0), (0, 2), (2, 1))), x(R // 8, 4, 8, 8, 8), both),
        ("Replicate", m(nn.Replicate, 3, 1), x(R, W), both),
        ("LocallyConnected1D", m(nn.LocallyConnected1D, 32, 16, 24, 3, 2), x(R, 32, 16), f32),
        ("LocallyConnected2D", m(nn.LocallyConnected2D, 8, 16, 12, 16, 3, 2, 1, 1),
         x(R // 8, 8, 12, 16), f32),
        ("SpatialSeparableConvolution", m(nn.SpatialSeparableConvolution, 8, 16, 2, 3, 3, 1, 1,
                                          -1, -1), x(R // 8, 8, 16, 16), f32),
        ("VolumetricConvolution", m(nn.VolumetricConvolution, 4, 8, 3, 3, 3, 1, 2, 2, 1, 1, 1),
         x(R // 8, 4, 8, 16, 16), f32),
        ("VolumetricMaxPooling", m(nn.VolumetricMaxPooling, 2, 2, 2, 2, 2, 2, 0, 1, 1),
         x(R // 8, 4, 8, 16, 16), both),
        ("VolumetricAveragePooling", m(nn.VolumetricAveragePooling, 2, 3, 2, 1, 2, 1),
         x(R // 8, 4, 8, 16, 16), both),
        ("SpatialAdaptiveMaxPooling", m(nn.SpatialAdaptiveMaxPooling, 5, 3),
         x(R // 8, 8, 16, 16), both),
        ("TemporalAveragePooling", m(nn.TemporalAveragePooling, 3, 2), x(R, 64, 8), both),
        ("Normalize", m(nn.Normalize, 2.0), x(R, W), both),
        ("Normalize_inf", m(nn.Normalize, float("inf")), x(R, W), both),
        ("SpatialWithinChannelLRN", m(nn.SpatialWithinChannelLRN, 5, 1e-2, 0.75),
         x(R // 8, 8, 16, 16), both),
        ("Highway", m(nn.Highway), x(R, W), f32),
        ("Maxout", m(nn.Maxout, W, 32, 4), x(R, W), f32),
        ("Echo", m(nn.Echo), x(R, W), f32),
    ]
    breadth = [
        ("K.Convolution1D", m(K.Convolution1D, 16, 3), x(R, 32, 8)),
        ("K.Convolution3D", m(K.Convolution3D, 8, 2, 2, 2), x(R // 8, 4, 8, 8, 8)),
        ("K.AtrousConvolution2D", m(K.AtrousConvolution2D, 8, 3, 3, atrous_rate=(2, 2)),
         x(R // 8, 8, 16, 16)),
        ("K.AtrousConvolution1D", m(K.AtrousConvolution1D, 16, 3, atrous_rate=2), x(R, 32, 8)),
        ("K.Deconvolution2D", m(K.Deconvolution2D, 8, 3, 3, subsample=(2, 2)),
         x(R // 8, 8, 16, 16)),
        ("K.SeparableConvolution2D", m(K.SeparableConvolution2D, 12, 3, 3, border_mode="same",
                                       depth_multiplier=2), x(R // 8, 8, 16, 16)),
        ("K.LocallyConnected1D", m(K.LocallyConnected1D, 16, 3), x(R, 32, 8)),
        ("K.LocallyConnected2D", m(K.LocallyConnected2D, 8, 3, 3), x(R // 8, 8, 16, 16)),
        ("K.MaxPooling1D", m(K.MaxPooling1D, 2), x(R, 64, 8)),
        ("K.AveragePooling1D", m(K.AveragePooling1D, 2), x(R, 64, 8)),
        ("K.MaxPooling3D", m(K.MaxPooling3D, (2, 2, 2)), x(R // 8, 4, 8, 8, 8)),
        ("K.AveragePooling3D", m(K.AveragePooling3D, (2, 2, 2)), x(R // 8, 4, 8, 8, 8)),
        ("K.GlobalMaxPooling1D", m(K.GlobalMaxPooling1D), x(R, 64, 8)),
        ("K.GlobalAveragePooling1D", m(K.GlobalAveragePooling1D), x(R, 64, 8)),
        ("K.GlobalMaxPooling3D", m(K.GlobalMaxPooling3D), x(R // 8, 4, 8, 8, 8)),
        ("K.GlobalAveragePooling3D", m(K.GlobalAveragePooling3D), x(R // 8, 4, 8, 8, 8)),
        ("K.UpSampling1D", m(K.UpSampling1D, 2), x(R, 64, 8)),
        ("K.UpSampling2D", m(K.UpSampling2D, (2, 3)), x(R // 8, 8, 16, 16)),
        ("K.UpSampling3D", m(K.UpSampling3D, (2, 2, 2)), x(R // 8, 4, 8, 8, 8)),
        ("K.ZeroPadding1D", m(K.ZeroPadding1D, 2), x(R, 64, 8)),
        ("K.ZeroPadding2D", m(K.ZeroPadding2D, (1, 2)), x(R // 8, 8, 16, 16)),
        ("K.Cropping1D", m(K.Cropping1D, (1, 2)), x(R, 64, 8)),
        ("K.Cropping2D", m(K.Cropping2D, ((1, 1), (2, 1))), x(R // 8, 8, 16, 16)),
        ("K.Cropping3D", m(K.Cropping3D, ((1, 1), (1, 1), (1, 1))), x(R // 8, 4, 8, 8, 8)),
        ("K.Permute", m(K.Permute, (2, 1)), x(R, 64, 8)),
        ("K.Permute_3", m(K.Permute, (3, 1, 2)), x(R // 8, 8, 16, 16)),
        ("K.RepeatVector", m(K.RepeatVector, 6), x(R, W)),
        ("K.Masking", m(K.Masking, 0.0), masked),
        ("K.GaussianNoise", m(K.GaussianNoise, 0.1), x(R, W)),
        ("K.GaussianDropout", m(K.GaussianDropout, 0.1), x(R, W)),
        ("K.SpatialDropout1D", m(K.SpatialDropout1D, 0.3), x(R, 64, 8)),
        ("K.SpatialDropout2D", m(K.SpatialDropout2D, 0.3), x(R // 8, 8, 16, 16)),
        ("K.SpatialDropout3D", m(K.SpatialDropout3D, 0.3), x(R // 8, 4, 8, 8, 8)),
        ("K.ELU", m(K.ELU, 0.5), x(R, W)),
        ("K.LeakyReLU", m(K.LeakyReLU, 0.1), x(R, W)),
        ("K.PReLU", m(K.PReLU), x(R, W)),
        ("K.SReLU", m(K.SReLU), x(R, W)),
        ("K.ThresholdedReLU", m(K.ThresholdedReLU, 0.5), x(R, W)),
        ("K.SoftMax", m(K.SoftMax), x(R, W)),
        ("K.Highway", m(K.Highway), x(R, W)),
        ("K.MaxoutDense", m(K.MaxoutDense, 32, nb_feature=3), x(R, W)),
        ("K.TimeDistributed", lambda device: K.TimeDistributed(K.Dense(16, device=device),
                                                               device=device), x(R, 32, 8)),
        ("K.Bidirectional_concat", lambda device: K.Bidirectional(
            K.LSTM(16, return_sequences=True, device=device), merge_mode="concat",
            device=device), x(R, 16, 8)),
        ("K.Bidirectional_sum", lambda device: K.Bidirectional(K.LSTM(16, device=device),
                                                               merge_mode="sum", device=device),
         x(R, 16, 8)),
        ("K.ConvLSTM2D_sequences", m(K.ConvLSTM2D, 8, 3, return_sequences=True),
         x(R // 16, 4, 4, 16, 16)),
        ("K.ConvLSTM2D", m(K.ConvLSTM2D, 8, 3), x(R // 16, 4, 4, 16, 16)),
    ]
    return cases + [(label, make, data, f32) for label, make, data in breadth]


def _host_division_sites(device):
    """The three divisions by a host scalar that ROADMAP Queue 3 suspected,
    on ``device`` and on the CPU, on inputs whose other operations are exact
    on both: how many quotients the plain ``x / c`` and the site (through
    ``precision.true_div``) get differently; then a beam search at alpha 0.6
    (sequences, scores' largest relative difference)."""
    import math

    import torch
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn import attention as att

    def pair(fn):
        return [fn(d) for d in (device, "cpu")]

    def differ(a, b):
        return int((a.cpu() != b).sum())

    out = {}
    length = torch.arange(1, 4097, dtype=torch.float32)
    raw = pair(lambda d: (5.0 + length.to(d)) / 6.0)
    site = pair(lambda d: att._length_penalty(length.to(d), 1.0))
    out["length penalty (5 + l) / 6"] = (differ(*raw), differ(*site), length.numel())
    g = torch.Generator().manual_seed(SEED + 75)
    for dh in (48, 80):
        q = torch.randn(2, 3, 64, dh, generator=g)
        k = torch.nn.functional.one_hot(torch.randint(0, dh, (2, 3, 64), generator=g),
                                        dh).float()
        raw = pair(lambda d: torch.einsum("...qd,...kd->...qk", q.to(d), k.to(d))
                   / math.sqrt(dh))
        site = pair(lambda d: att._scaled_logits(q.to(d), k.to(d)))
        out[f"logits / sqrt({dh})"] = (differ(*raw), differ(*site), raw[1].numel())
    xs = torch.linspace(10.0, 1000.0, 1 << 16)
    raw = pair(lambda d: torch.logaddexp(3.0 * xs.to(d), torch.zeros(1, device=d)) / 3.0)
    site = pair(lambda d: nn.SoftPlus(3.0, device=d).forward(xs.to(d)))
    out["SoftPlus(3) / beta"] = (differ(*raw), differ(*site), xs.numel())
    table = torch.randn(37, 37, generator=g)
    table[:, 1] -= 1.5  # EOS now and then: finished beams and near ties
    beams = {}
    for d in (device, "cpu"):
        t = table.to(d)
        seqs, scores = att.sequence_beam_search(
            lambda ids, i, cache: (t[ids[:, -1]], cache), torch.tensor([2, 5, 9, 11], device=d),
            {}, 37, beam_size=4, alpha=0.6, max_decode_length=12, eos_id=1)
        beams[d] = (seqs.cpu(), scores.cpu())
    same = torch.equal(beams[device][0], beams["cpu"][0])
    rel = float(((beams[device][1] - beams["cpu"][1]).abs()
                 / beams["cpu"][1].abs().clamp(min=1e-30)).max())
    return out, same, rel


def phase_slice21_modules(card):
    """[20d] every other class of the slice and the keras breadth table's
    wrappers forward and backward on the card against the CPU (same weights
    and inputs; ``MODULE_TOL``), the counts 0 just before and read just
    after; then the three host-scalar division sites, card vs CPU."""
    import copy

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator

    device = _s21_device()
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    t0 = time.perf_counter()
    worst, n_runs, cases = {}, 0, _slice21_cases()
    try:
        reset_counts()  # the main path starts here
        for i, (label, make, data, dtypes) in enumerate(cases):
            RandomGenerator.set_seed(SEED + 80 + i)
            x = data(np.random.default_rng(SEED + 80 + i))
            host = make("cpu")
            host.init(sample_input=_to_device(x, "cpu", torch.float32))
            card_obj = copy.deepcopy(host).to(device)
            for dtype in dtypes:
                dt = getattr(torch, dtype)
                y_cpu, g_cpu, dts_cpu = _run_module(host, False, x, None, SEED + 130 + i, "cpu",
                                                    dt)
                y_dev, g_dev, dts_dev = _run_module(card_obj, False, x, None, SEED + 130 + i,
                                                    device, dt)
                if dts_cpu != dts_dev:
                    raise AssertionError(f"[20d] {label} {dtype}: output dtypes {dts_dev} on the "
                                         f"card, {dts_cpu} on the CPU")
                w = max([_module_diff(label, a, b, dtype, "output") for a, b in zip(y_dev, y_cpu)]
                        + [_module_diff(label, a, b, dtype, "gradient")
                           for a, b in zip(g_dev, g_cpu)])
                if w > 1.0:
                    raise AssertionError(f"[20d] {label} {dtype}: card vs CPU at {w:.2f} of the "
                                         "allowance")
                worst[(label, dtype)] = w
                n_runs += 1
            del host, card_obj
        _sync()
        counts = read_counts()  # the main path ends here
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        Engine.set_compute_dtype(None)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log(f"[20d] {len(cases)} modules and keras wrappers, {n_runs} (module, dtype) runs forward "
        f"and backward on the card against the CPU: all within their allowances (f32 1e-5 + "
        f"1e-4|cpu| + 1e-5 max|cpu|, bf16 1e-5 + 2^-6|cpu| + 2^-6 max|cpu|); the largest shares: "
        + ", ".join(f"{k[0]} {k[1]} {v:.3f}" for k, v in top)
        + f"; {time.perf_counter() - t0:.1f} s; launches {_nonzero(counts)}")
    if any(counts.values()):
        raise AssertionError(f"[20d] launched {_nonzero(counts)}")
    sites, same, rel = _host_division_sites(device)
    for name, (raw, routed, n) in sites.items():
        log(f"    host-scalar division, card vs CPU: {name}: the plain x / c differs at {raw} of "
            f"{n}, the site (precision.true_div) at {routed}")
    log(f"    beam search at alpha 0.6 (4 beams, 12 steps, vocab 37): sequences "
        f"{'equal' if same else 'DIFFERENT'}, scores' largest relative difference {rel:.2e} "
        "(limit 1e-6)")
    if any(routed for _, routed, _ in sites.values()) or not same or rel > 1e-6:
        raise AssertionError("[20d] a host-scalar division site differs card vs CPU")
    _free()
    return counts


def phase_slice21(card):
    """[20] the keras API and the rest of nn/: the keras example trained,
    C3D trained, the keras U-Net served, the module sweep; returns the main
    paths' launches."""
    t0 = time.perf_counter()
    by_path = {"keras_example": phase_keras_example(card)}
    by_path["c3d"] = phase_c3d(card)
    by_path["unet_predict"] = phase_unet(card)
    by_path["modules_slice21"] = phase_slice21_modules(card)
    log(f"[20] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# [21a] the ImageNet recipe from record shards: 1,280 records of 224x224x3
# uint8 in 8 BDLSHRD1 shards (one epoch of 10 steps at batch 128)
SHARDS = {"records": 1280, "shards": 8, "size": 224, "batch": 128, "classes": 1000}
# [21b] DataPipeline over 256x256 uint8 records with an ImageNet augmentation chain
AUGMENT = {"records": 512, "size": 256, "crop": 224, "batch": 128, "workers": (0, 4, 8)}


def _write_shards(directory, c, seed):
    """``c["records"]`` seeded uint8 images and labels written into
    ``c["shards"]`` record shards; returns (seconds, bytes, labels)."""
    import numpy as np
    from bigdl_tpu_torch.dataset import write_record_shards

    rng = np.random.default_rng(seed)
    n, hw = c["records"], c["size"]
    imgs = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    labels = rng.integers(0, c["classes"], n)
    t0 = time.perf_counter()
    paths = write_record_shards(((imgs[i].tobytes(), int(labels[i])) for i in range(n)),
                                str(directory), records_per_shard=n // c["shards"])
    if len(paths) != c["shards"]:
        raise AssertionError(f"[21a] wrote {len(paths)} shards, expected {c['shards']}")
    return time.perf_counter() - t0, imgs.nbytes, labels


class _InputSums:
    """Wraps ``_train_step`` of ``LocalOptimizer`` and ``DistriOptimizer``
    (class attributes, inside a ``_StepProbe``): a device-side integer sum
    of each step's input bits, taken on the driver's stream after the
    prefetch copy's event (no sync, no launch of this repo's kernels)."""

    def __enter__(self):
        import torch

        self.sums = []
        self._patch = _ClassPatch()
        sums = self.sums

        def wrap(orig):
            def step(opt, x, *a, **k):
                sums.append(x.contiguous().view(torch.int32).sum(dtype=torch.int64))
                return orig(opt, x, *a, **k)

            return step

        self._patch.patch("_train_step", wrap)
        return self

    def __exit__(self, *exc):
        self._patch.restore()
        return False


def _bits_sum(a) -> int:
    import numpy as np

    return int(np.ascontiguousarray(a, np.float32).view(np.int32).sum(dtype=np.int64))


def phase_imagenet_shards(card):
    """[21a] ``resnet_train.py --dataset imagenet --depth 50 --data-dir``
    over record shards for one epoch of 10 steps (conv7, batch 128, bf16
    activations): the shards read by a ``ShardedRecordDataSet`` 's threads,
    batched by a ``DataPipeline`` and copied by the optimizer's prefetch
    thread; every step's input on the card equal to the CPU's reading of the
    same epoch, #10 once a step, finite losses, memory flat. Returns the
    counts."""
    import statistics
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.examples import resnet_train

    c = SHARDS
    with tempfile.TemporaryDirectory(prefix="bigdl_shards_") as d:
        write_s, nbytes, _ = _write_shards(d, c, SEED + 90)
        log(f"[21a] wrote {c['records']} records of {c['size']}x{c['size']}x3 uint8 "
            f"({nbytes / 1e6:.1f} MB) into {c['shards']} record shards in {write_s:.2f} s")
        argv = ["--dataset", "imagenet", "--depth", "50", "--data-dir", d, "--max-epoch", "1",
                "-b", str(c["batch"]), "--class-num", str(c["classes"])]
        Engine.set_compute_dtype(None)  # the recipe's policy, as in a fresh process
        Engine.set_activation_dtype(None)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _StepProbe() as probe, _InputSums() as sums:
            reset_counts()  # the main path starts here
            recipe = resnet_train.main(argv)
            _sync()
            counts = read_counts()  # the main path ends here
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        opt = recipe.optimizer
        hist = opt.history
        n_steps = c["records"] // c["batch"]
        losses = [h["loss"] for h in hist]
        walls = [h["wall_s"] * 1e3 for h in hist[2:-1]]  # the last pull holds the epoch end
        step_ms = statistics.median(walls)
        log(f"    ResNet-50 conv7, {recipe.model.n_parameters() / 1e6:.3f} M params, batch "
            f"{c['batch']}, activations {Engine.activation_dtype()}, the pipeline's "
            f"{resnet_train.PIPELINE_WORKERS} workers over {opt.dataset.base.source.n_workers} decode "
            f"threads: {len(hist)} steps in {wall:.2f} s (build and first batch included); step "
            f"{step_ms:.2f} ms (median of steps 3-{n_steps - 1}; range {min(walls):.2f}-"
            f"{max(walls):.2f}), {c['batch'] / step_ms * 1e3:.1f} images/s; peak device memory "
            f"{peak / 2**30:.2f} GiB; card {card}")
        log("    losses: " + ", ".join(f"{v:.4f}" for v in losses))
        _log_input_wait("[21a]", hist)
        if len(hist) != n_steps or not all(np.isfinite(losses)):
            raise AssertionError(f"[21a] {len(hist)} steps, losses {losses}")
        _check_steps("[21a]", probe, n_steps, 1, want_validations=0)
        log(f"    maxpool2d_bwd launches {counts['maxpool2d_bwd']} (1 a step); others "
            f"{sum(counts.values()) - counts['maxpool2d_bwd']}")
        if counts["maxpool2d_bwd"] != n_steps or sum(counts.values()) != n_steps:
            raise AssertionError(f"[21a] launches {counts}")
        # every step's input as the card saw it against the CPU's reading of the epoch
        got = [int(v) for v in torch.stack(sums.sums).cpu()]
        ds = opt.dataset
        ds.shuffle(hist[0]["epoch"])
        want = [_bits_sum(b.get_input()) for b in ds.data(train=True)]
        log(f"    the {len(got)} steps' inputs on the card against the CPU's reading of the "
            f"same epoch (integer sums of their bits): {'equal' if got == want else 'DIFFER'}")
        if got != want:
            raise AssertionError(f"[21a] the card's inputs {got} are not the epoch's {want}")
        dev_ms, wall_ms, share = _busy_share(opt, 2)
        log(f"    device work a step {dev_ms:.2f} ms (2 more steps of the next epoch under "
            f"torch.profiler, whose wall, {wall_ms:.2f} ms a step, holds the epoch's start: the "
            f"shards' first decode and the first batch), {100 * dev_ms / step_ms:.1f}% of the "
            f"unprofiled step; card {card}")
    del recipe, opt
    _free()
    return counts


def _augment_lambda():
    """The [21b] chain as a ``Lambda`` over (HWC uint8 record, label) samples:
    RandomCrop(224), a random HFlip, ChannelNormalize, MatToTensor,
    ImageFrameToSample."""
    from bigdl_tpu_torch.dataset import Lambda, Sample
    from bigdl_tpu_torch.transform.vision.image import (ChannelNormalize, HFlip, ImageFeature,
                                                        ImageFrameToSample, MatToTensor,
                                                        RandomCrop, RandomTransformer)

    crop = AUGMENT["crop"]
    chain = (RandomCrop(crop, crop) >> RandomTransformer(HFlip(), 0.5)
             >> ChannelNormalize(104.0, 117.0, 123.0, 58.4, 57.1, 57.4) >> MatToTensor()
             >> ImageFrameToSample())

    def fn(s):
        x, t = chain(ImageFeature(mat=s.feature, label=s.label)).sample()
        return Sample(x, t)

    return Lambda(fn)


def phase_augment_pipeline(card):
    """[21b] ``DataPipeline`` with the ImageNet augmentation chain over 256x256
    uint8 records at 0, 4 and 8 workers: the host's images/s, and the batch
    streams at 0 and 8 workers equal by a hash. Returns the counts (no
    launch)."""
    import hashlib

    import numpy as np
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.dataset import DataPipeline, LocalArrayDataSet

    c = AUGMENT
    rng = np.random.default_rng(SEED + 91)
    x = rng.integers(0, 256, (c["records"], c["size"], c["size"], 3), dtype=np.uint8)
    y = rng.integers(0, 1000, c["records"])
    RandomGenerator.set_seed(SEED + 91)
    digests, rates = {}, {}
    reset_counts()
    for workers in c["workers"]:
        pipe = DataPipeline(LocalArrayDataSet(x, y, batch_size=c["batch"]), _augment_lambda(),
                            num_workers=workers)
        pipe.shuffle(1)
        h = hashlib.sha256()
        t0 = time.perf_counter()
        n = 0
        for b in pipe.data(train=True):
            h.update(b.get_input().tobytes())
            h.update(b.get_target().tobytes())
            n += b.size()
        secs = time.perf_counter() - t0
        digests[workers], rates[workers] = h.hexdigest(), n / secs
        log(f"[21b] DataPipeline, {workers} workers: {n} images of {c['size']}x{c['size']}x3 "
            f"uint8 through RandomCrop({c['crop']}), HFlip (p 0.5), ChannelNormalize, "
            f"MatToTensor and ImageFrameToSample in {secs:.2f} s: {n / secs:.1f} images/s "
            f"(hashing included); stream sha256 {digests[workers][:16]}; host of card {card}")
        if n != c["records"]:
            raise AssertionError(f"[21b] {workers} workers gave {n} images")
    counts = read_counts()
    if digests[0] != digests[max(c["workers"])]:
        raise AssertionError(f"[21b] the batch streams differ by worker count: {digests}")
    log(f"    the streams at 0 and {max(c['workers'])} workers are byte-identical; "
        f"{rates[max(c['workers'])] / rates[0]:.2f}x the serial rate at "
        f"{max(c['workers'])} workers")
    return counts


def _median_ms(fn, n=5):
    import statistics

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_native_host(card):
    """[21c] The host library on the card's host: its build time, and each
    entry point against its plain version at the main paths' sizes (timed,
    median of 5), and the gather's threshold measured."""
    import numpy as np
    from bigdl_tpu_torch import native

    log(f"[21c] host library {Path(native.BUILD_DIR, native.LIB_NAME).relative_to(ROOT)}: "
        f"built by g++ in {native.build_s:.2f} s in [2] (beside nvcc); host of card {card}; "
        f"{__import__('os').cpu_count()} CPUs")
    rng = np.random.default_rng(SEED + 92)
    t, hw = C3D["clip"][0], C3D["clip"][1:]
    src = rng.standard_normal((3 * C3D["batch"], 3, t, *hw)).astype(np.float32)
    idx = rng.permutation(len(src))[:C3D["batch"]]
    got, want = native.gather_rows(src, idx), native.gather_rows_plain(src, idx)
    equal = got.tobytes() == want.tobytes()
    log(f"    gather_rows at C3D's batch ({C3D['batch']} of {src.shape[1:]} f32, "
        f"{got.nbytes / 2**20:.1f} MiB): native {_median_ms(lambda: native.gather_rows(src, idx)):.2f}"
        f" ms, numpy {_median_ms(lambda: native.gather_rows_plain(src, idx)):.2f} ms; "
        f"bit-equal: {equal}")
    if not equal:
        raise AssertionError("[21c] gather_rows differs from numpy fancy indexing")
    lib = native._load()
    small = rng.standard_normal((16384, 1024)).astype(np.float32)  # 4 KiB rows
    sidx = rng.permutation(len(small))
    parts = []
    for kib in (64, 256, 1024, 4096, 16384, 65536):
        rows = kib // 4
        s_idx = sidx[:rows]
        nat = _median_ms(lambda: _forced_gather(lib, small, s_idx), 9)
        plain = _median_ms(lambda: np.ascontiguousarray(small[s_idx]), 9)
        parts.append(f"{kib} KiB native {nat:.3f} / numpy {plain:.3f} ms")
    log("    the gather's route threshold (native.py routes below 1 MiB to numpy, the JAX "
        "package's number from a host it does not name), measured here on 4 KiB rows: "
        + "; ".join(parts))
    batch = rng.integers(0, 256, (128, 224, 224, 3), dtype=np.uint8)
    mean, std = (104.0, 117.0, 123.0), (58.4, 57.1, 57.4)
    a = native.u8hwc_to_f32chw(batch, mean, std)
    b = native.u8hwc_to_f32chw_plain(batch, mean, std)
    err = float(np.abs(a - b).max())
    log(f"    u8hwc_to_f32chw at 128x224x224x3: native "
        f"{_median_ms(lambda: native.u8hwc_to_f32chw(batch, mean, std)):.2f} ms, numpy "
        f"{_median_ms(lambda: native.u8hwc_to_f32chw_plain(batch, mean, std)):.2f} ms; max "
        f"|native - numpy| {err:.2e} (limit 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"[21c] u8hwc_to_f32chw differs by {err}")
    data = rng.bytes(1 << 20)
    crc, plain_crc = native.crc32c(data), native._py_crc32c(data)
    log(f"    crc32c over 1 MiB: native {_median_ms(lambda: native.crc32c(data)):.3f} ms, "
        f"the plain loop {_median_ms(lambda: native._py_crc32c(data), 1):.1f} ms; equal: "
        f"{crc == plain_crc}")
    if crc != plain_crc:
        raise AssertionError("[21c] crc32c differs from the plain version")


def _forced_gather(lib, src, idx):
    """The library's threaded gather whatever the size (the route bypassed)."""
    import numpy as np

    dst = np.empty((len(idx),) + src.shape[1:], np.float32)
    lib.bigdl_gather_f32(src.ctypes.data, np.ascontiguousarray(idx, np.int64).ctypes.data,
                         dst.ctypes.data, len(idx), int(np.prod(src.shape[1:])))
    return dst


def phase_slice22(card):
    """[21] the host data path: the ImageNet recipe from record shards, the
    augmentation pipeline and the host library; returns the main paths'
    launches."""
    t0 = time.perf_counter()
    by_path = {"imagenet_shards": phase_imagenet_shards(card)}
    by_path["augment_pipeline"] = phase_augment_pipeline(card)
    phase_native_host(card)
    log(f"[21] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------------------- [22]
# data-parallel training across processes (bigdl_tpu_torch/parallel/distri_optimizer.py)
DISTRI_DEVICE = None  # the card; "cpu" rehearses [22] on the CPU
DISTRI_STEPS = 10  # [22a]'s main path
DISTRI_RECIPE = ["--dataset", "imagenet", "--depth", "50", "-b", "128", "--warmup-epochs", "0",
                 "--max-epoch", "1", "--synthetic-size", "1280"]
DISTRI_VGG = ["-b", "128", "--max-epoch", "1", "--synthetic-size", "512"]
DISTRI_RANK_STEPS = 3  # [22b]
POLICY_STEPS = 4  # [22c], [22d]
# tolerances, stated before the first run on the card:
# [22a] DistriOptimizer at one rank and LocalOptimizer (tree and flat) from the
#   same weights, 3 SGD steps under deterministic cuDNN: the same elementwise
#   arithmetic, so bit-equal is expected; the check holds them within 1e-6 of
#   the update's norm (relative L2) and logs whether they are bit-equal
DISTRI_LOCAL_REL = 1e-6
# [22b] the 2-rank run against the plain simulation of the 2-rank step on the
#   card (simulate_step), 3 steps under deterministic cuDNN: the same sums in
#   the same order (a + b, then / 2), bit-equal expected; held within 1e-5 of
#   the update's norm, BN state within 1e-5 absolute
DISTRI_SIM_REL = 1e-5
DISTRI_SIM_STATE_ATOL = 1e-5
# [22c] each policy run against the f32 run over its 4 steps. The f32 run's
#   loss moves by only ~0.045 over them, so the parameters decide: with the
#   f32 run's update d = p_f32 - p0, beta = <p - p0, d> / <d, d> (1 for a
#   run that follows the update, 0 for one whose weights never move) within
#   POLICY_BETA of 1, and rel = ||p - p_f32|| / ||d|| under POLICY_REL
#   (None: the bf16 master's stochastic rounding, 2**-8 of each weight a
#   step, is larger than the update, so only beta can tell). The same two
#   numbers read on a run that never moves (its own initial weights) must
#   fail the limits. Readings on the H100 (deterministic cuDNN; the run
#   that never moves in brackets): bf16 wire beta 0.931, rel 0.370; int8
#   wire 0.924, 0.389 (0, 1); bf16 state 0.890, 1.557 (0.00004, 1.308).
#   rel is large for every policy because VGG-for-CIFAR-10 from random
#   weights amplifies any difference ~6x a step (1.7e-3 of the update
#   after one step, 0.085 after four, on the CPU in float32). The limits
#   are a few times the distance of beta from 1, and rel under 0.6. The
#   losses within POLICY_LOSS_ATOL of the f32 run's (a few times the
#   readings 0.0068 / 0.0072 / 0.0122); the replicated flat run within
#   1e-4 of the sharded one
POLICY_BETA = {"p_bf16": 0.25, "p_int8": 0.25, "p_state": 0.35}
POLICY_REL = {"p_bf16": 0.6, "p_int8": 0.6, "p_state": None}
POLICY_LOSS_ATOL = {"p_bf16": 0.025, "p_int8": 0.025, "p_state": 0.04}
REPLICATED_LOSS_ATOL = 1e-4
DISTRI_CLIP = 0.05  # [22c] one step clipped by the global norm
# the clipped step against the simulation: the global norm is summed shard
#   by shard and then over the ranks, the simulation's leaf by leaf, so the
#   scale may differ by an ulp and a weight's p - lr·v round the other way
#   (2**-24 of the weight, against an update ~1e-3 of it): 1e-3 of the
#   update's norm
DISTRI_CLIP_REL = 1e-3
RANK_DEADLINE_S = 420.0


def _deterministic(on: bool) -> None:
    import torch

    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def _distri_argv(argv, device):
    return list(argv) + (["--platform", "cpu"] if device == "cpu" else [])


def _vec_of(tree):
    """A tree's floating leaves as one float32 vector, in its path order."""
    import torch
    from bigdl_tpu_torch.utils.serialization import tree_items

    leaves = [v.detach().reshape(-1).float() for v in tree_items(tree).values()
              if isinstance(v, torch.Tensor) and v.is_floating_point()]
    return torch.cat(leaves) if leaves else torch.zeros(0)


def _hash(t) -> tuple:
    """Two integer sums of a float32 vector's bits (equal vectors, equal
    pairs; a difference of one bit changes both)."""
    import torch

    b = t.detach().contiguous().view(torch.int32).to(torch.int64)
    w = torch.arange(1, b.numel() + 1, device=b.device, dtype=torch.int64) % 65521
    return int(b.sum()), int((b * w).sum())


def _update_rel(a, b, a0) -> float:
    """||a - b|| over ||b - a0|| (float64 on the host)."""
    import torch

    a, b, a0 = (v.detach().double().cpu() for v in (a, b, a0))
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b - a0)),
                                                       1e-30))


def _against_update(p, ref, p0) -> tuple:
    """``(beta, rel)`` of ``p`` against the reference run's update ``d = ref -
    p0``: ``<p - p0, d> / <d, d>`` and ``||p - ref|| / ||d||`` (float64 on
    the host)."""
    import torch

    p, ref, p0 = (v.detach().double().cpu() for v in (p, ref, p0))
    d = ref - p0
    return float(torch.dot(p - p0, d) / torch.dot(d, d)), _update_rel(p, ref, p0)


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _kernels_in(fn):
    """``(launch calls, device kernels)`` of ``fn`` under torch.profiler: the
    CUDA runtime's launch calls on the host, and the kernels the device
    recorded (CUPTI can drop device records, seen in a long process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    evs = list(prof.profiler.kineto_results.events())
    return (sum(1 for ev in evs if ev.name() in _LAUNCH_CALLS),
            sum(1 for ev in evs if ev.device_type() == torch.autograd.DeviceType.CUDA
                and not ev.name().startswith(("Memcpy", "Memset"))))


def _update_launches(opt):
    """:func:`_kernels_in` of one flat update and of one tree update of
    ``opt`` 's method over its model, on copies."""
    import torch

    fs, method = opt._flat, opt.optim_method
    fp = fs.fp
    step = method.state["neval"]
    p = fs.work.clone()
    slots = {k: v.clone() for k, v in fs.slots.items()}
    g = torch.zeros_like(p)
    flat_n = _kernels_in(lambda: method.update_flat(g, p, slots, 0.1, step, wd_coeff=fs.wd))
    tp = fp.unflatten(fs.work.clone())
    ts = {k: fp.unflatten(v.clone()) for k, v in fs.slots.items()}
    tg = fp.unflatten(torch.zeros_like(p))
    tree_n = _kernels_in(lambda: method.update(tg, tp, ts, 0.1, step))
    return flat_n, tree_n


def _recipe_optimizer(kind, argv):
    """``(optimizer, model)``: the ResNet recipe's pieces through
    ``Optimizer.apply`` (``kind="apply"``), or through ``LocalOptimizer``
    on the tree (``"local"``) or the flat layout (``"local_flat"``)."""
    from bigdl_tpu_torch.examples import resnet_train
    from bigdl_tpu_torch.optim import LocalOptimizer, Optimizer

    recipe = resnet_train.build(resnet_train.parser().parse_args(argv))
    base = recipe.optimizer
    if kind == "apply":
        opt = Optimizer.apply(recipe.model, base.dataset, base.criterion)
    else:
        opt = LocalOptimizer(recipe.model, base.dataset, base.criterion,
                             flat_update=kind == "local_flat")
    return opt.set_optim_method(base.optim_method), recipe.model


def phase_distri_one_rank(card):
    """[22a] the ResNet recipe through ``Optimizer.apply(...,
    DataSet.distributed(base, 1), ...)`` -> ``DistriOptimizer`` (sharded)
    after ``Engine.init_distributed`` over NCCL at world size 1, 10 steps;
    then 3 steps of it against the tree and the flat ``LocalOptimizer`` from
    the same weights. Returns the main path's counts."""
    import socket
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer

    device = DISTRI_DEVICE
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    Engine.init_distributed(f"localhost:{port}", 1, 0, device=device)
    try:
        log(f"[22a] rank 0 of 1 joined tcp://localhost:{port} over {Engine.backend()} on "
            f"{Engine.rank_device()}")
        if device is None and Engine.backend() != "nccl":
            raise AssertionError(f"[22a] one rank on its own card took {Engine.backend()}")
        argv = _distri_argv(DISTRI_RECIPE, device)
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
        opt, model = _recipe_optimizer("apply", argv)
        if type(opt) is not DistriOptimizer:
            raise AssertionError(f"[22a] Optimizer.apply gave {type(opt).__name__}")
        opt.set_end_when(Trigger.max_iteration(DISTRI_STEPS))
        if device is None:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _StepProbe() as probe:
            reset_counts()  # the main path starts here
            opt.optimize()
            _sync()
            counts = read_counts()  # the main path ends here
        wall = time.perf_counter() - t0
        hist = opt.history
        losses = [h["loss"] for h in hist]
        if opt._sync != "sharded" or len(hist) != DISTRI_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"[22a] sync {opt._sync}, losses {losses}")
        walls = [h["wall_s"] * 1e3 for h in hist[2:]]
        step_ms = statistics.median(walls)
        batch = hist[0]["records"]
        fs = opt._flat
        master_b = fs.master.numel() * fs.master.element_size()
        slot_b = sum(v.numel() * v.element_size() for v in fs.slots.values())
        peak = torch.cuda.max_memory_allocated() / 2**30 if device is None else float("nan")
        log(f"    ResNet-{DISTRI_RECIPE[DISTRI_RECIPE.index('--depth') + 1]} conv7, "
            f"{model.n_parameters() / 1e6:.3f} M params, batch {batch}, "
            f"activations {Engine.activation_dtype()}: {len(hist)} steps in {wall:.2f} s (build "
            f"included); step {step_ms:.2f} ms (median of steps 3-{DISTRI_STEPS}; range "
            f"{min(walls):.2f}-{max(walls):.2f}), {batch / step_ms * 1e3:.1f} images/s; peak "
            f"device memory {peak:.2f} GiB; flat master {master_b / 2**20:.1f} MiB "
            f"({fs.fp.total} parameters, padded {fs.fp.padded_total}), slots "
            f"{slot_b / 2**20:.1f} MiB; card {card}")
        log("    losses: " + ", ".join(f"{v:.4f}" for v in losses))
        if device is None:
            _check_steps("[22a]", probe, DISTRI_STEPS, 1, want_validations=0)
            if counts["maxpool2d_bwd"] != DISTRI_STEPS or sum(counts.values()) != DISTRI_STEPS:
                raise AssertionError(f"[22a] launches {counts}")
        log(f"    maxpool2d_bwd launches {counts['maxpool2d_bwd']} (1 a step); others "
            f"{sum(counts.values()) - counts['maxpool2d_bwd']}")
        if device is None:
            flat_k, tree_k = _update_launches(opt)
            log(f"    one update's kernel launches (launch calls / kernels the device "
                f"recorded): flat {flat_k[0]} / {flat_k[1]}, tree {tree_k[0]} / {tree_k[1]} "
                f"({len(fs.fp.paths)} leaves)")
            dev_ms, wall_ms, _ = _busy_share(opt, 2)
            log(f"    device work a step {dev_ms:.2f} ms (2 more steps under torch.profiler, "
                f"{wall_ms:.2f} ms a step there), {100 * dev_ms / step_ms:.1f}% of the "
                f"unprofiled step; card {card}")
        del opt, model, fs
        _free()
        _distri_vs_local(card, argv)
    finally:
        Engine.shutdown_distributed()
    return counts


def _distri_vs_local(card, argv):
    """[22a] 3 steps of DistriOptimizer (one rank), LocalOptimizer on the
    tree and on the flat layout, from the same weights, deterministic cuDNN."""
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.parallel import FlatParameter

    _deterministic(True)
    try:
        out = {}
        for kind in ("apply", "local", "local_flat"):
            opt, model = _recipe_optimizer(kind, argv)
            opt.set_end_when(Trigger.max_iteration(3))
            first = opt._first_batch()
            model.build(RandomGenerator.generator(), model._as_input(first.get_input()))
            p0 = _vec_of(model.get_parameters()).clone()
            opt.optimize()
            fp = FlatParameter(model.get_parameters(), 1)
            out[kind] = (fp.flatten(model.get_parameters()).cpu(), p0.cpu(),
                         [h["loss"] for h in opt.history])
            del opt, model
            _free()
    finally:
        _deterministic(False)
    ref, ref0, ref_l = out["apply"]
    for kind in ("local", "local_flat"):
        got, got0, got_l = out[kind]
        if not bool((got0 == ref0).all()):
            raise AssertionError(f"[22a] {kind} started from other weights")
        rel = _update_rel(got, ref, ref0)
        exact = bool((got == ref).all())
        log(f"[22a] 3 SGD steps of the recipe, DistriOptimizer at one rank against "
            f"LocalOptimizer ({kind}): {rel:.3g} of the update's norm (limit "
            f"{DISTRI_LOCAL_REL}), bit-equal {exact}; losses {got_l} / {ref_l}; card {card}")
        if not rel <= DISTRI_LOCAL_REL:
            raise AssertionError(f"[22a] DistriOptimizer and {kind} differ by {rel}")


# --- [22b]-[22d]: two ranks sharing the card, spawned from here ----------------------------
def _rank_job_optimizer(job, rank):
    """The job's optimizer and model on this rank."""
    from bigdl_tpu_torch.examples import resnet_train, vgg_train
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer

    if job["model"] == "resnet":
        run = resnet_train.build(resnet_train.parser().parse_args(job["argv"]))
    else:
        run = vgg_train.build(vgg_train.parser().parse_args(job["argv"]))
    base = run.optimizer
    opt = DistriOptimizer(run.model, base.dataset, base.criterion, **job.get("kw", {}))
    opt.set_optim_method(base.optim_method)
    if job.get("clip") is not None:
        opt.set_gradient_clipping_by_l2_norm(job["clip"])
    opt.set_end_when(Trigger.max_iteration(job["steps"]))
    return opt, run.model


def _rank_run(job, rank, folder):
    """One job on this rank: train, recording every step's parameter and
    state hashes, the BN state before and after the average, the step's
    generator seed; returns what the parent checks."""
    import torch
    from bigdl_tpu_torch.parallel import _comm
    from bigdl_tpu_torch.parallel import distri_optimizer as dmod
    from bigdl_tpu_torch.utils.random import RandomGenerator

    opt, model = _rank_job_optimizer(job, rank)
    if job.get("resume"):
        opt.resume(os.path.join(folder, job["resume"]))
    if job.get("checkpoint"):
        from bigdl_tpu_torch.optim import Trigger

        opt.set_checkpoint(os.path.join(folder, job["checkpoint"]),
                           Trigger.several_iteration(2))
    rec = {"hashes": [], "pre": [], "post": [], "seeds": [], "init": None}
    orig_avg = dmod.average_state

    def average_state(state, loss):
        rec["pre"].append(_vec_of(state).cpu())
        out = orig_avg(state, loss)
        rec["post"].append(_vec_of(out[0]).cpu())
        return out

    orig_step = opt._train_step

    def step(*a, **k):
        if rec["init"] is None:
            rec["init"] = (opt._flat.work.detach().cpu().clone() if opt._flat is not None
                           else _vec_of(model.get_parameters()).cpu(),
                           _vec_of(model.get_state()).cpu())
        rec["seeds"].append(RandomGenerator._seed * 1_000_003 + RandomGenerator._counter + 1)
        out = orig_step(*a, **k)
        params = opt._flat.work if opt._flat is not None else _vec_of(model.get_parameters())
        rec["hashes"].append((_hash(params), _hash(_vec_of(model.get_state()))))
        return out

    opt._train_step = step
    dmod.average_state = average_state
    on_card = torch.cuda.is_available() and model.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        _comm.reset_counts()
        reset_counts()  # the main path starts here
        opt.optimize()
        _sync()
        counts = read_counts()  # the main path ends here
    finally:
        dmod.average_state = orig_avg
    comm = _comm.counts()
    fs = opt._flat
    params = fs.work if fs is not None else _vec_of(model.get_parameters())
    out = {
        "counts": counts, "comm": comm,
        "losses": [h["loss"] for h in opt.history],
        "walls": [h["wall_s"] * 1e3 for h in opt.history],
        "records": [h["records"] for h in opt.history],
        "peak": torch.cuda.max_memory_allocated() if on_card else 0,
        "hashes": rec["hashes"], "seeds": rec["seeds"],
        "master_bytes": fs.master.numel() * fs.master.element_size() if fs else 0,
        "slot_bytes": sum(v.numel() * v.element_size() for v in fs.slots.values()) if fs else 0,
        "sync": opt._sync,
    }
    torch.save({"pre": rec["pre"], "post": rec["post"], "init": rec["init"],
                "final": (params.detach().cpu().clone(), _vec_of(model.get_state()).cpu())},
               os.path.join(folder, f"{job['name']}.{rank}.pt"))
    del opt, model, fs, params, step, orig_step
    _free()
    return out


def _distri_rank(rank, world, folder):
    """A spawned rank: join the group through a file, run the jobs of
    ``jobs.json`` in order, write ``rank<r>.json``."""
    sys.path.insert(0, str(ROOT))
    from bigdl_tpu_torch import Engine

    with open(os.path.join(folder, "jobs.json")) as f:
        spec = json.load(f)
    Engine.init_distributed(f"file://{folder}/group", world, rank, device=spec["device"])
    if spec["device"] is None:  # the library's load launches the probe once: before any path
        from bigdl_tpu_torch.ops import _build

        _build.load()
    _deterministic(True)
    results = {"backend": Engine.backend(), "device": str(Engine.rank_device())}
    try:
        for job in spec["jobs"]:
            results[job["name"]] = _rank_run(job, rank, folder)
            if job.get("keep_oldest_checkpoint") and rank == 0:
                _keep_oldest(os.path.join(folder, job["checkpoint"]))
            from bigdl_tpu_torch.parallel import _comm

            _comm.barrier()
    finally:
        Engine.shutdown_distributed()
    with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def _keep_oldest(directory):
    """Remove every checkpoint of ``directory`` but the oldest."""
    from bigdl_tpu_torch.utils.serialization import _checkpoint_steps, _remove_checkpoint

    for step in _checkpoint_steps(directory)[:-1]:
        _remove_checkpoint(directory, step)


def _spawn_ranks(jobs, folder, world=2):
    """Run ``jobs`` on ``world`` spawned ranks (gloo, sharing the card);
    a rank that fails or outlives ``RANK_DEADLINE_S`` fails the run (its
    exit code and the end of its stderr are printed)."""
    from bigdl_tpu_torch.examples._common import spawn

    with open(os.path.join(folder, "jobs.json"), "w") as f:
        json.dump({"device": DISTRI_DEVICE, "jobs": jobs}, f)
    spawn(_distri_rank, (folder,), world, RANK_DEADLINE_S, stderr_dir=folder)
    out = []
    for r in range(world):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _simulate(job, folder, rank0, clip=None):
    """The plain simulation of the job's 2-rank steps in this process, from
    rank 0's initial weights and state, each step with the ranks' generator
    seed; returns (parameters, state, initial parameters, losses) on the
    host."""
    import torch
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.parallel import FlatParameter, simulate_step
    from bigdl_tpu_torch.parallel.parameter import tree_leaves_with_path
    from bigdl_tpu_torch.utils.serialization import tree_items

    saved = torch.load(os.path.join(folder, f"{job['name']}.0.pt"))
    opt, model = _rank_job_optimizer(job, 0)  # no group in this process: whole batches
    first = opt._first_batch()
    model.build(RandomGenerator.generator(),
                model._as_input(first.slice(0, first.size() // 2).get_input()))
    params = model.get_parameters()
    fp = FlatParameter(params, 1)
    init_p, init_s = saved["init"]
    vec = torch.zeros(fp.padded_total, device=model.device)
    vec[:fp.total] = init_p[:fp.total].to(model.device)
    with torch.no_grad():
        for (_, p), (_, v) in zip(tree_leaves_with_path(params),
                                  tree_leaves_with_path(fp.unflatten(vec))):
            p.copy_(v)
        off = 0
        for v in tree_items(model.get_state()).values():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                v.copy_(init_s[off:off + v.numel()].view(v.shape).to(v))
                off += v.numel()
    method = opt.optim_method
    slots = method.init_slots(params)
    ds = opt.dataset
    ds.shuffle(1)
    losses, norms = [], []
    for i, batch in enumerate(ds.data(train=True)):
        if i == job["steps"]:
            break
        x = torch.as_tensor(batch.get_input()).to(model.device)
        t = torch.as_tensor(batch.get_target()).to(model.device)
        gen = torch.Generator().manual_seed(rank0["seeds"][i])
        stats = {}
        losses.append(float(simulate_step(
            model, opt.criterion, method, slots, x, t, 2, method.get_learning_rate(),
            method.state["neval"], rng=gen, clip_norm=clip, stats=stats)))
        norms.append(stats["grad_norm"])
        method.state["neval"] += 1
    final = fp.flatten(model.get_parameters()).cpu()
    out = (final[:fp.total], _vec_of(model.get_state()).cpu(), vec[:fp.total].cpu(), losses,
           norms)
    del opt, model, params, slots
    _free()
    return out


def _check_against_sim(label, job, folder, ranks, card, clip=None):
    """A 2-rank job's final parameters and state against the simulation
    (``DISTRI_SIM_REL``; ``DISTRI_CLIP_REL`` with clipping)."""
    import torch

    _deterministic(True)
    try:
        p, st, p0, sim_losses, norms = _simulate(job, folder, ranks[0][job["name"]], clip=clip)
    finally:
        _deterministic(False)
    got_p, got_s = torch.load(os.path.join(folder, f"{job['name']}.0.pt"))["final"]
    got_p = got_p[:p.numel()]
    rel = _update_rel(got_p, p, p0)
    sd = float((got_s - st).abs().max()) if st.numel() else 0.0
    exact = bool((got_p == p).all()) and bool((got_s == st).all())
    limit = DISTRI_SIM_REL if clip is None else DISTRI_CLIP_REL
    log(f"{label} against the plain simulation of the 2-rank step on this device "
        f"(simulate_step, {job['steps']} steps, deterministic cuDNN): parameters "
        f"{rel:.3g} of the update's norm (limit {limit}), BN state max |diff| "
        f"{sd:.3g} (limit {DISTRI_SIM_STATE_ATOL}), bit-equal {exact}; losses "
        f"{ranks[0][job['name']]['losses']} / simulation {sim_losses}; the averaged "
        f"gradient's norm " + ", ".join(f"{v:.4g}" for v in norms) + f"; card {card}")
    if clip is not None and not min(norms) > clip:
        raise AssertionError(f"{label} the gradient norm {norms} never reached the clip {clip}")
    if not (rel <= limit and sd <= DISTRI_SIM_STATE_ATOL):
        raise AssertionError(f"{label} differs from the simulation: {rel}, {sd}")


def _check_rank_equal_and_bn_mean(label, name, folder, ranks):
    """Bit-equal parameters and state across the ranks after every step;
    the averaged BN state the mean of the ranks' own."""
    import torch

    h0, h1 = ranks[0][name]["hashes"], ranks[1][name]["hashes"]
    if h0 != h1:
        raise AssertionError(f"{label} the ranks' parameters or state differ: {h0} / {h1}")
    a = torch.load(os.path.join(folder, f"{name}.0.pt"))
    b = torch.load(os.path.join(folder, f"{name}.1.pt"))
    for i, (pre0, pre1, post) in enumerate(zip(a["pre"], b["pre"], a["post"])):
        if not bool((post == (pre0 + pre1) / 2).all()):
            raise AssertionError(f"{label} step {i + 1}: the averaged BN state is not the "
                                 "mean of the ranks' states")
    log(f"{label} the ranks' parameters and BN state bit-equal after each of the "
        f"{len(h0)} steps; the averaged BN state ({a['pre'][0].numel()} values) equal to the "
        f"mean of the two ranks' own after every step, to the bit")


def _rank_times(label, name, ranks, card, per_step_pools):
    import statistics

    for r, res in enumerate(ranks):
        x = res[name]
        walls = x["walls"][1:] or x["walls"]
        comm = {k: v["bytes"] for k, v in x["comm"].items() if v["calls"]}
        log(f"{label} rank {r}: {len(x['losses'])} steps of {x['records'][0]} records "
            f"({x['records'][0] // 2} a rank), step {statistics.median(walls):.2f} ms "
            f"(median after the first; two processes time-sharing one card), peak "
            f"{x['peak'] / 2**30:.2f} GiB, losses "
            + ", ".join(f"{v:.4f}" for v in x["losses"])
            + f"; collective operand bytes {comm} (the comm layer stages none: gloo takes "
            f"CUDA tensors); "
            f"maxpool2d_bwd {x['counts']['maxpool2d_bwd']}; card {card}")
        if DISTRI_DEVICE is None and (
                x["counts"]["maxpool2d_bwd"] != per_step_pools * len(x["losses"])
                or sum(x["counts"].values()) != x["counts"]["maxpool2d_bwd"]):
            raise AssertionError(f"{label} rank {r} launches {x['counts']}")


def _sum_counts(ranks, names):
    total = {}
    for res in ranks:
        for name in names:
            for k, v in res[name]["counts"].items():
                total[k] = total.get(k, 0) + v
    return total


def phase_distri_two_ranks(card):
    """[22b]-[22d] on two ranks sharing the card over gloo; returns the
    main paths' counts (both ranks')."""
    import tempfile

    import numpy as np
    import torch

    dev = DISTRI_DEVICE
    rn, vg = _distri_argv(DISTRI_RECIPE, dev), _distri_argv(DISTRI_VGG, dev)

    def vgg(name, steps=POLICY_STEPS, **extra):
        return dict(name=name, model="vgg", argv=vg, steps=steps, **extra)

    jobs = [dict(name="resnet", model="resnet", argv=rn, steps=DISTRI_RANK_STEPS),
            vgg("vgg", DISTRI_RANK_STEPS),
            vgg("p_f32"), vgg("p_bf16", kw={"comms_dtype": "bfloat16"}),
            vgg("p_int8", kw={"comms_dtype": "int8"}),
            vgg("p_state", kw={"master_dtype": "bfloat16", "slot_dtype": "bfloat16"}),
            vgg("p_replicated_flat", kw={"parameter_sync": "replicated", "flat_update": True}),
            vgg("p_clip", 1, clip=DISTRI_CLIP),
            vgg("ckpt_a", checkpoint="ckpt", keep_oldest_checkpoint=True),
            vgg("ckpt_b", resume="ckpt")]
    by_name = {j["name"]: j for j in jobs}
    folder = tempfile.mkdtemp(prefix="bigdl_ranks_")
    t0 = time.perf_counter()
    ranks = _spawn_ranks(jobs, folder)
    log(f"[22b] two ranks on {ranks[0]['device']} over {ranks[0]['backend']}: {len(jobs)} "
        f"runs in {time.perf_counter() - t0:.1f} s (the processes' start included)")
    if ranks[0]["backend"] != "gloo":
        raise AssertionError(f"[22b] two ranks on one card took {ranks[0]['backend']}")
    # [22b] the recipe and VGG-for-CIFAR-10
    for name, pools in (("resnet", 1), ("vgg", 5)):
        label = f"[22b] {'ResNet-50 recipe' if name == 'resnet' else 'VGG-for-CIFAR-10'}:"
        _rank_times(label, name, ranks, card, pools)
        _check_rank_equal_and_bn_mean(label, name, folder, ranks)
        _check_against_sim(label, by_name[name], folder, ranks, card)
    # [22c] the policies
    res = {n: ranks[0][n] for n in by_name if n.startswith("p_")}
    # the sharded runs' gradient exchange: the reduce-scatter or the codes'
    # all-to-all (the replicated run averages it with pmean)
    ex = {n: (r["comm"]["psum_scatter"]["bytes"] + r["comm"]["all_to_all"]["bytes"]
              + (r["comm"]["pmean"]["bytes"] if r["sync"] == "replicated" else 0))
          / len(r["losses"]) for n, r in res.items()}
    ref = np.asarray(res["p_f32"]["losses"])
    for n, r in res.items():
        dl = float(np.max(np.abs(np.asarray(r["losses"]) - ref[:len(r["losses"])])))
        log(f"[22c] {n}: gradient exchange {ex[n] / 2**20:.2f} MiB a step (f32 "
            f"{ex['p_f32'] / ex[n]:.2f}x of it), stored master "
            f"{r['master_bytes'] / 2**20:.1f} MiB, slots {r['slot_bytes'] / 2**20:.1f} MiB, "
            f"losses " + ", ".join(f"{v:.4f}" for v in r["losses"])
            + f" (max |diff| to f32 {dl:.3g}); ranks equal "
            f"{ranks[0][n]['hashes'] == ranks[1][n]['hashes']}; card {card}")
        if ranks[0][n]["hashes"] != ranks[1][n]["hashes"] or not np.isfinite(r["losses"]).all():
            raise AssertionError(f"[22c] {n}: ranks differ or a loss is not finite")
        limit = REPLICATED_LOSS_ATOL if n == "p_replicated_flat" else POLICY_LOSS_ATOL.get(n)
        if limit is not None and dl > limit:
            raise AssertionError(f"[22c] {n}: losses {dl} from the f32 run's (limit {limit})")
    _check_policy_params(folder, card)
    if not (ex["p_f32"] / ex["p_bf16"] >= 2.0 and ex["p_f32"] / ex["p_int8"] >= 3.5):
        raise AssertionError(f"[22c] exchange bytes {ex}")
    st, f32 = res["p_state"], res["p_f32"]
    if not (st["master_bytes"] * 2 == f32["master_bytes"]
            and st["slot_bytes"] * 2 == f32["slot_bytes"]):
        raise AssertionError(f"[22c] bf16 state bytes {st['master_bytes']}, {st['slot_bytes']}")
    if res["p_replicated_flat"]["sync"] != "replicated":
        raise AssertionError("[22c] the replicated run did not run replicated")
    _check_against_sim(f"[22c] clipping by the global norm ({DISTRI_CLIP}):",
                       by_name["p_clip"], folder, ranks, card, clip=DISTRI_CLIP)
    # [22d] checkpoint at step 2, resume at world size 2, equal at step 4
    a = torch.load(os.path.join(folder, "ckpt_a.0.pt"))["final"]
    b = torch.load(os.path.join(folder, "ckpt_b.0.pt"))["final"]
    same = bool((a[0] == b[0]).all()) and bool((a[1] == b[1]).all())
    log(f"[22d] VGG-for-CIFAR-10 at 2 ranks checkpointed at step 2 and resumed at 2 ranks: "
        f"step 4 bit-equal to the uninterrupted run {same} (losses "
        f"{ranks[0]['ckpt_a']['losses']} / resumed {ranks[0]['ckpt_b']['losses']})")
    if not same or ranks[0]["ckpt_b"]["hashes"] != ranks[1]["ckpt_b"]["hashes"]:
        raise AssertionError("[22d] the resumed run is not the uninterrupted one")
    _local_reads_checkpoint(os.path.join(folder, "ckpt"), vg, card)
    import shutil

    shutil.rmtree(folder, ignore_errors=True)
    return {"distri_resnet_2rank": _sum_counts(ranks, ["resnet"]),
            "distri_vgg_2rank": _sum_counts(ranks, ["vgg"]),
            "distri_policies": _sum_counts(ranks, [n for n in by_name if n.startswith("p_")]),
            "distri_resume": _sum_counts(ranks, ["ckpt_a", "ckpt_b"])}


def _check_policy_params(folder, card):
    """[22c] each policy run's final parameters against the f32 run's
    update (``POLICY_BETA``, ``POLICY_REL``); a run that never moves (the
    run's own initial weights) must fail the same limits."""
    import torch

    f32 = torch.load(os.path.join(folder, "p_f32.0.pt"))
    p0, ref = f32["init"][0], f32["final"][0]
    for n in ("p_bf16", "p_int8", "p_state"):
        saved = torch.load(os.path.join(folder, f"{n}.0.pt"))
        own0, got = saved["init"][0], saved["final"][0]
        beta_lim, rel_lim = POLICY_BETA[n], POLICY_REL[n]

        def ok(beta, rel):
            return abs(beta - 1) <= beta_lim and (rel_lim is None or rel <= rel_lim)

        beta, rel = _against_update(got, ref, p0)
        beta_c, rel_c = _against_update(own0, ref, p0)
        log(f"[22c] {n}: parameters against the f32 run's update (||d|| "
            f"{float(torch.linalg.vector_norm((ref - p0).double())):.4g}): beta {beta:.6g} "
            f"(limit |beta - 1| <= {beta_lim}), rel {rel:.6g} (limit {rel_lim}); a run that "
            f"never moves reads beta {beta_c:.6g}, rel {rel_c:.6g}; its initial weights "
            f"max |diff| to f32's {float((own0 - p0).abs().max()):.3g}; card {card}")
        if not ok(beta, rel):
            raise AssertionError(f"[22c] {n}: the parameters do not follow the f32 update: "
                                 f"beta {beta}, rel {rel}")
        if ok(beta_c, rel_c):
            raise AssertionError(f"[22c] {n}: the limits pass a run that never moves")


def _local_reads_checkpoint(directory, argv, card):
    """[22d] the 2-rank checkpoint resumed by a 1-rank LocalOptimizer."""
    import numpy as np
    from bigdl_tpu_torch.examples import vgg_train
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.serialization import load_checkpoint, tree_items

    run = vgg_train.build(vgg_train.parser().parse_args(argv))
    base = run.optimizer
    opt = LocalOptimizer(run.model, base.dataset, base.criterion)
    opt.set_optim_method(base.optim_method).resume(directory)
    params, _, host, _ = load_checkpoint(directory)
    mine = {k: v.detach().cpu().numpy() for k, v in tree_items(run.model.get_parameters()).items()}
    equal = all(np.array_equal(mine[k], v) for k, v in params.items())
    opt.set_end_when(Trigger.max_iteration(host["neval"] + 1))
    opt.optimize()
    losses = [h["loss"] for h in opt.history]
    log(f"[22d] the checkpoint (step {host['neval'] - 1}) read by a 1-rank LocalOptimizer: "
        f"parameters equal to the file's {equal}, 2 more steps at the whole batch, losses "
        f"{losses}; card {card}")
    if not equal or len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError("[22d] LocalOptimizer did not resume the 2-rank checkpoint")
    del opt, run
    _free()


def phase_slice23(card):
    """[22] data-parallel training across processes; returns the main
    paths' launches."""
    t0 = time.perf_counter()
    by_path = {"distri_recipe": phase_distri_one_rank(card)}
    by_path.update(phase_distri_two_ranks(card))
    log(f"[22] done in {time.perf_counter() - t0:.1f} s (tools/torch_multiprocess_smoke.py "
        "runs beside [23e])")
    return by_path


def _multiprocess_tool_args():
    """[22]'s ``tools/torch_multiprocess_smoke.py`` on this device (started
    beside [23e]'s examples: both are pass/fail runs of spawned processes)."""
    return [sys.executable, str(ROOT / "tools" / "torch_multiprocess_smoke.py"), "--json",
            "--device", "cpu" if DISTRI_DEVICE == "cpu" else "cuda"]


# ----------------------------------------------------------------------------- [23]
# the mesh parallelisms (bigdl_tpu_torch/parallel/{sharding,hybrid,sequence,moe,
# pipeline,pipeline_optimizer}.py), each phase on ranks spawned here that
# share the card over gloo (NCCL refuses two ranks on one device)
MESH_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes below
MESH_PIPE = {"vocab": 8192, "hidden": 512, "stages": 6, "seq": 2048, "batch": 8, "n_seq": 24,
             "n_micro": 8, "iters": 6, "check_batch": 8}  # [23a]: [9]'s widths
MESH_LM = dict(LM_WIDTH, records=8, steps=3, sp=4)  # [23b], [23d]: [5]/[6]'s widths
MESH_MOE = dict(MOE_BENCH, iters=6, check_steps=3)  # [23c]: bench.py's MoE model
MESH_EXAMPLES = ("pipeline_train", "longctx_train", "moe_train")  # [23e], their defaults
MESH_EXAMPLE_TOKENS = 20000  # [23e]: half the mains' 40,000, to keep the smoke inside its limit
MESH_EXAMPLE_TIMEOUT_S = 300
# Limits of the f32 checks (TF32 off). Each check runs twice on the mesh:
# sound, and with a planted fault, the gradient of one split leaf doubled
# before the update (``_doubled``: what a boundary whose backward sums
# where JAX takes a block gives over an axis of 2).
# Each limit sits between the two runs' readings on an H100 (80GB HBM3,
# 700 W; "sound / planted" below), both logged beside it on every run; a
# sound run over a limit fails, and so does a planted run under every
# limit. The checks step with SGD: Adam's first steps are blind to a
# gradient's scale.
# [23a] 3 SGD steps of the 6-stage GPipe run against the sequential stack
#   through LocalOptimizer on one rank from the same weights (the batch
#   gradient a sum of 8 microbatch gradients against one sum); planted on
#   a stage's FFN filter weight. Loss 0 / 5.1e-3, update 1.2e-3 / 0.55
#   (spread over every stage leaf and the embedding alike, with the fused
#   norms on or off).
# [23b] 3 SGD steps of the ring (4 ranks of 512 positions, bf16 policy off)
#   against the dense route on one rank (the softmax accumulated online
#   over 4 blocks against one exp-normalise); planted on block 0's query
#   weight, whose gradient comes through the ring's backward. Loss
#   1.0e-7 / 1.0e-6, update 5.4e-5 / 1.0e-2.
# [23c] 3 SGD steps of ExpertParallelOptimizer against the dense MoE on one
#   rank (the same per-expert products over the same rows); planted on the
#   expert-stacked w1. Top-1 / top-2: loss 0, 7.0e-8 / 6.5e-4, 2.7e-3;
#   update 8.0e-6, 5.8e-6 / 0.47, 0.47; params 4.9e-9, 7.1e-9 / 2.9e-4,
#   5.8e-4.
# [23d] 3 SGD steps of data 2 x model 2 under the Megatron plan against
#   LocalOptimizer on one rank (tighter than the JAX test's loss 1e-4 and
#   parameters 2e-4 absolute, which the planted fault passes); planted on
#   block 0's query weight, cut over the model axis. Loss 0 / 7.0e-7,
#   update 1.3e-5 / 1.1e-2, parameters 3.7e-7 / 1.2e-4 absolute.
MESH_TOL = {"pipe": {"loss": 1e-5, "update": 1e-2},
            "ring": {"loss": 3e-7, "update": 5e-4},
            "moe": {"loss": 1e-6, "update": 1e-4, "params": 1e-7},
            "hybrid": {"loss": 1e-7, "update": 2e-4, "params_abs": 5e-6}}
MESH_PLANT = {"pipe": "/stages/FeedForwardNetwork_1/filter_w", "ring": "block0/self_q_w",
              "moe": "/w1", "hybrid": "block0/self_q_w"}  # the leaf each check's fault doubles
# [26b] the health records' global gradient norm of [23a]'s and [23d]'s f32
#   checks against the one-rank run's at each step (largest relative
#   difference; the planted run's too). On an H100 (80GB HBM3, 700 W):
#   [23a] 6.98e-6 / 0.380, [23d] 7.25e-7 / 1.83e-4 (sound / planted);
#   each limit sits between them
MESH_HEALTH_TOL = {"pipe": 1e-3, "hybrid": 1e-5}


def _f32_card():
    """f32 compute, no bf16 activations, TF32 off; returns a restore function."""
    import torch
    from bigdl_tpu_torch import Engine

    prev = (Engine.compute_dtype(), Engine.activation_dtype(), Engine._fused_kernels,
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def restore():
        Engine.set_compute_dtype(prev[0])
        Engine.set_activation_dtype(prev[1])
        Engine.set_fused_kernels(prev[2])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[3:]

    return restore


def _bf16_card(fused: bool):
    from bigdl_tpu_torch import Engine

    restore = _f32_card()
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    Engine.set_fused_kernels(fused)
    return restore


def _flat_params(model):
    import torch

    return torch.cat([p.detach().float().reshape(-1).cpu() for p in model.parameters()])


def _doubled(cls, leaf: str):
    """``cls`` with the gradient of the first parameter whose path ends in
    ``leaf`` doubled before the update (the planted fault of the f32
    checks)."""
    from bigdl_tpu_torch.utils.serialization import tree_items, unflatten_to_like

    class Doubled(cls):
        def _clip_grads(self, grads):
            items = tree_items(grads)
            path = next(p for p in items if p.endswith(leaf))
            items[path] = items[path] * 2
            return super()._clip_grads(unflatten_to_like(items, grads))

    return Doubled


def _observed(opt):
    """[26b] ``Telemetry`` (no heartbeats, no meta-device cost count: a
    mesh step's collectives do not run on meta tensors) and ``set_health``
    on ``opt``, and each step's collective bytes read around its
    ``_train_step``; returns the function that gives ``{"steps", "health",
    "wire"}`` (the step and health records, the per-step byte deltas of
    ``parallel._comm`` by collective)."""
    from bigdl_tpu_torch.obs import HealthConfig, PerfConfig, Telemetry
    from bigdl_tpu_torch.parallel import _comm

    tel = Telemetry(heartbeat_interval_s=None)
    opt.set_telemetry(tel).set_perf(PerfConfig(cost=False))
    opt.set_health(HealthConfig(every_n_steps=1))
    step, wire = opt._train_step, []

    def counted(*a, **k):
        before = _comm.counts()
        out = step(*a, **k)
        after = _comm.counts()
        wire.append({n: after[n]["bytes"] - before[n]["bytes"] for n in after})
        return out

    opt._train_step = counted

    def read():
        recs = list(tel.ring.records)
        return {"steps": [r for r in recs if r["type"] == "step"],
                "health": [r for r in recs if r["type"] == "health"], "wire": wire}

    return read


def _grad_norms(observed):
    """The global gradient norms of an observed run's health records."""
    return [h["global"]["grad_norm"] for h in observed["health"]]


def _check_observed(label, ranks, job, iters, bubble=None):
    """[26b] every rank's records of an observed run: ``iters`` step and
    health records, every health reading finite, each step record's
    ``collective_bytes`` (and its all-to-all and ppermute parts) equal to
    that step's delta of ``parallel._comm`` 's counters, and the pipeline's
    ``pipe_bubble_frac``. Returns rank 0's global gradient norms."""
    import math

    for r, res in enumerate(ranks):
        obs = res[job]["observed"]
        steps, health, wire = obs["steps"], obs["health"], obs["wire"]
        if len(steps) != iters or len(health) != iters:
            raise AssertionError(f"{label} rank {r}: {len(steps)} step and {len(health)} health "
                                 f"records, expected {iters}")
        for h in health:
            g = h["global"]
            if (not all(math.isfinite(g[k]) for k in ("grad_norm", "weight_norm",
                                                      "update_ratio"))
                    or g["nonfinite_grads"] or g["nonfinite_params"]):
                raise AssertionError(f"{label} rank {r}: health {g}")
        for rec, w in zip(steps, wire):
            want = (sum(w.values()), w["all_to_all"], w["ppermute"])
            got = (rec["collective_bytes"], rec["all_to_all_bytes"], rec["ppermute_bytes"])
            if got != want:
                raise AssertionError(f"{label} rank {r}: step record wire {got}, the counters' "
                                     f"delta {want}")
            if bubble is not None and abs(rec.get("pipe_bubble_frac", -1) - bubble) > 1e-6:
                raise AssertionError(f"{label} rank {r}: pipe_bubble_frac "
                                     f"{rec.get('pipe_bubble_frac')}, expected {bubble}")
    obs = ranks[0][job]["observed"]
    mib = [s["collective_bytes"] / 2**20 for s in obs["steps"]]
    log(f"    {label} health on every rank: {iters} records each, finite; global grad norm "
        + ", ".join(f"{v:.4f}" for v in _grad_norms(obs)) + "; collective MiB a step (rank 0) "
        + ", ".join(f"{v:.2f}" for v in mib) + " = the counters' delta a step"
        + (f"; pipe_bubble_frac {obs['steps'][0]['pipe_bubble_frac']}" if bubble else ""))
    return _grad_norms(obs)


def _norms_against(label, check, ref, planted, tol):
    """[26b] the mesh run's global gradient norms against the one-rank
    run's within ``tol`` (largest relative difference), the planted run's
    over it."""
    def dist(a):
        return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, ref))

    got, bad = dist(check), dist(planted)
    log(f"    {label}: health grad norms {[round(v, 5) for v in check]} vs "
        f"{[round(v, 5) for v in ref]}: {got:.2e} (limit {tol}; planted {bad:.2e})")
    if len(check) != len(ref) or got > tol:
        raise AssertionError(f"{label}: the mesh run's health disagrees with the one-rank run")
    if not bad > tol:
        raise AssertionError(f"{label}: the planted fault's health passes the limit {tol}")


def _distance(run, ref, p0):
    """The largest loss difference relative to max(1, |loss|), and the
    parameters' update-relative (``update``), norm-relative (``params``) and
    absolute (``params_abs``) distance."""
    (l1, p1), (l2, p2) = run, ref
    return {"loss": max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(l1, l2)),
            "update": float((p1 - p2).norm() / (p2 - p0).norm()),
            "params": float((p1 - p2).norm() / p2.norm()),
            "params_abs": float((p1 - p2).abs().max())}


def _against(label, run, ref, p0, tol, planted):
    """``run`` (losses, parameters) against ``ref`` from the same ``p0``
    within every limit of ``tol``, and ``planted`` (the same run with the
    planted fault) over at least one of them."""
    got, bad = _distance(run, ref, p0), _distance(planted, ref, p0)
    log(f"    {label}: losses {[round(v, 5) for v in run[0]]} vs "
        f"{[round(v, 5) for v in ref[0]]}; "
        + ", ".join(f"{k} {v:.2e}" + (f" (limit {tol[k]}; planted {bad[k]:.2e})" if k in tol
                                      else f" (planted {bad[k]:.2e})")
                    for k, v in got.items()))
    if len(run[0]) != len(ref[0]) or any(got[k] > v for k, v in tol.items()):
        raise AssertionError(f"{label}: the mesh run disagrees with the one-rank run")
    if not any(bad[k] > v for k, v in tol.items()):
        raise AssertionError(f"{label}: the planted fault (a doubled gradient) passes the "
                             f"limits {tol}: {bad}")


def _pipe_data(c, seed):
    from bigdl_tpu_torch.examples.transformer_train import planted_bigram_ids

    ids = planted_bigram_ids(c["n_seq"] * c["seq"] + 1, c["vocab"], seed=seed)
    return ids[:-1].reshape(c["n_seq"], c["seq"]), ids[1:].reshape(c["n_seq"], c["seq"])


def _mesh_job_pipe(rank, world, out):
    """[23a] the norm-LM/LN through PipelineOptimizer on a 6-stage mesh."""
    import statistics

    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.parallel import PipelineOptimizer, _comm, make_mesh

    c, dev = MESH_PIPE, MESH_DEVICE
    mesh = make_mesh({"pipe": c["stages"]})
    x, y = _pipe_data(c, SEED)
    restore = _bf16_card(fused=True)
    try:
        RandomGenerator.set_seed(SEED)
        model = norm_lm("ln", c["vocab"], c["hidden"], c["stages"], device=dev)
        model.init(sample_input=x[:c["batch"]])
        whole = sum(p.numel() * 4 for p in model.parameters())
        stacked = sum(p.numel() * 4 for n, p in model.named_parameters() if ".stages." in n)
        opt = PipelineOptimizer(model, DataSet.array(x, y, batch_size=c["batch"]),
                                _lm_criterion(), mesh=mesh, n_micro=c["n_micro"])
        opt.set_optim_method(Adam(learningrate=3e-3))
        opt.set_end_when(Trigger.max_iteration(c["iters"]))
        observed = _observed(opt)  # [26b]
        _comm.reset_counts()
        reset_counts()  # the main path starts here
        opt.optimize()
        _sync()
        out["counts"] = read_counts()  # the main path ends here
        out["comm"] = _comm.counts()
        out["observed"] = observed()
        hist = opt.history
        out.update(losses=[h["loss"] for h in hist],
                   step_ms=statistics.median(h["wall_s"] for h in hist[2:]) * 1e3,
                   held=opt.held_bytes, whole=whole, stacked=stacked)
        del opt, model
        _free()
    finally:
        restore()
    _pipe_f32_check(rank, mesh, x, y, out, fused=True, planted=True)


def _pipe_f32_check(rank, mesh, x, y, out, fused: bool, planted: bool) -> None:
    """[23a]'s check: 3 f32 SGD steps on the mesh (sound, and with the
    planted fault when ``planted``), then on rank 0 the sequential stack,
    under the fused-kernel switch ``fused``; into ``out``: ``check``,
    ``planted``, ``ref``, ``p0`` (rank 0), each (losses, parameters)."""
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.parallel import PipelineOptimizer, _comm

    c, dev = MESH_PIPE, MESH_DEVICE
    restore = _f32_card()
    try:
        Engine.set_fused_kernels(fused)
        n = c["check_batch"]

        def build():
            RandomGenerator.set_seed(SEED + 1)
            m = norm_lm("ln", c["vocab"], c["hidden"], c["stages"], device=dev)
            m.init(sample_input=x[:n])
            return m

        def fit(model, cls, key, **kw):
            o = cls(model, DataSet.array(x[:n], y[:n], batch_size=n), _lm_criterion(), **kw)
            o.set_optim_method(SGD(learningrate=0.1)).set_end_when(Trigger.max_iteration(3))
            observed = _observed(o)  # [26b] health against the sequential stack's
            o.optimize()
            out[f"{key}_norms"] = _grad_norms(observed())
            out[key] = ([h["loss"] for h in o.history], _flat_params(model))

        model = build()
        p0 = _flat_params(model)
        fit(model, PipelineOptimizer, "check", mesh=mesh, n_micro=c["n_micro"])
        del model
        if planted:
            model = build()
            fit(model, _doubled(PipelineOptimizer, MESH_PLANT["pipe"]), "planted", mesh=mesh,
                n_micro=c["n_micro"])
            del model
        _free()
        _comm.barrier()
        if rank == 0:
            model = build()
            fit(model, LocalOptimizer, "ref")
            out["p0"] = p0
            out["names"] = [n_ for n_, _ in model.named_parameters()]
            out["sizes"] = [p.numel() for _, p in model.named_parameters()]
            del model
            _free()
        _comm.barrier()
    finally:
        restore()


def _mesh_lm(dev, seed):
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.nn import Transformer

    w = MESH_LM
    RandomGenerator.set_seed(seed)
    return Transformer(w["vocab"], w["hidden"], w["heads"], w["filt"], w["layers"], 0.0, 0.0,
                       0.0, mode="lm", device=dev)


def _lm_data(seed):
    import numpy as np

    w = MESH_LM
    gen = np.random.default_rng(seed)
    return (gen.integers(0, w["vocab"], (w["records"], w["seq"])),
            gen.integers(0, w["vocab"], (w["records"], w["seq"])))


def _lm_fit(model, cls, x, y, steps, observe=None, micro=1, **kw):
    """``steps`` SGD steps of ``cls`` (with ``micro`` micro-batches); with
    ``observe`` (a dict) the run is ``_observed`` and its readings go there
    under ``"observed"``."""
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, Trigger

    o = cls(model, DataSet.array(x, y, batch_size=MESH_LM["batch"]), CrossEntropyCriterion(),
            **kw)
    o.set_micro_batches(micro)
    o.set_optim_method(SGD(learningrate=0.1)).set_end_when(Trigger.max_iteration(steps))
    read = _observed(o) if observe is not None else None
    o.optimize()
    if read is not None:
        observe["observed"] = read()
    return o


def _mesh_job_ring(rank, world, out):
    """[23b] the LM through LocalOptimizer on every rank with the ring
    registered over ``sp``."""
    import os

    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.parallel import _comm, make_mesh

    w, dev = MESH_LM, MESH_DEVICE
    mesh = make_mesh({"sp": w["sp"]})
    x, y = _lm_data(SEED)
    restore = _bf16_card(fused=False)
    try:
        model = _mesh_lm(dev, SEED)
        model.init(sample_input=x[:w["batch"]])
        Engine.set_sequence_parallel(mesh, "sp")
        _comm.reset_counts()
        reset_counts()  # the main path starts here
        opt = _lm_fit(model, LocalOptimizer, x, y, w["steps"])
        _sync()
        out["counts"] = read_counts()  # the main path ends here
        Engine.set_sequence_parallel(None)
        out["comm"] = _comm.counts()
        out["losses"] = [h["loss"] for h in opt.history]
        out["step_ms"] = [h["wall_s"] * 1e3 for h in opt.history]
        del opt
        if rank == 0:  # registration cleared: the flash route again, one step
            reset_counts()
            _lm_fit(model, LocalOptimizer, x, y, 1)
            _sync()
            out["cleared_counts"] = read_counts()
        del model
        _free()
        _comm.barrier()
    finally:
        Engine.set_sequence_parallel(None)
        restore()
    restore = _f32_card()
    prev = os.environ.get("BIGDL_ATTN_IMPL")
    try:
        model = _mesh_lm(dev, SEED + 1)
        model.init(sample_input=x[:w["batch"]])
        p0 = _flat_params(model)
        Engine.set_sequence_parallel(mesh, "sp")
        o = _lm_fit(model, LocalOptimizer, x, y, 3)
        out["check"] = ([h["loss"] for h in o.history], _flat_params(model))
        del o, model
        model = _mesh_lm(dev, SEED + 1)
        model.init(sample_input=x[:w["batch"]])
        o = _lm_fit(model, _doubled(LocalOptimizer, MESH_PLANT["ring"]), x, y, 3)
        Engine.set_sequence_parallel(None)
        out["planted"] = ([h["loss"] for h in o.history], _flat_params(model))
        del o, model
        _free()
        _comm.barrier()
        if rank == 0:
            os.environ["BIGDL_ATTN_IMPL"] = "dense"
            model = _mesh_lm(dev, SEED + 1)
            model.init(sample_input=x[:w["batch"]])
            o = _lm_fit(model, LocalOptimizer, x, y, 3)
            out["ref"], out["p0"] = ([h["loss"] for h in o.history], _flat_params(model)), p0
            del o, model
            _free()
        _comm.barrier()
    finally:
        Engine.set_sequence_parallel(None)
        if prev is None:
            os.environ.pop("BIGDL_ATTN_IMPL", None)
        else:
            os.environ["BIGDL_ATTN_IMPL"] = prev
        restore()


def _mesh_job_moe(rank, world, out):
    """[23c] the bench's MoE model through ExpertParallelOptimizer, top-1
    and top-2."""
    import numpy as np
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.parallel import ExpertParallelOptimizer, _comm, make_mesh

    c, dev = MESH_MOE, MESH_DEVICE
    mesh = make_mesh({"expert": c["experts"]})
    gen = np.random.default_rng(SEED + 70)
    x = gen.standard_normal((c["batch"] * 2, c["hidden"])).astype(np.float32)
    y = gen.integers(0, c["classes"], c["batch"] * 2)
    restore = _f32_card()
    try:
        for k in (1, 2):
            def build():
                RandomGenerator.set_seed(SEED + 71)
                m = _bench_moe(k, dev, c)
                m.init(sample_input=x[:c["batch"]])
                return m

            def fit(model, cls, steps, **kw):
                o = cls(model, DataSet.array(x, y, batch_size=c["batch"]), ClassNLLCriterion(),
                        **kw)
                o.set_optim_method(SGD(learningrate=c["lr"]))
                o.set_end_when(Trigger.max_iteration(steps)).optimize()
                return o

            model = build()
            whole = sum(p.numel() * 4 for p in model.parameters())
            experts = sum(p.numel() * 4 for n, p in model.named_parameters()
                          if n.split(".")[-1] in ("w1", "b1", "w2", "b2"))
            p0 = _flat_params(model)
            _comm.reset_counts()
            reset_counts()  # the main path starts here
            opt = fit(model, ExpertParallelOptimizer, c["iters"], mesh=mesh)
            _sync()
            res = {"counts": read_counts(), "comm": _comm.counts(),  # the main path ends here
                   "losses": [h["loss"] for h in opt.history], "held": opt.held_bytes,
                   "whole": whole, "experts": experts,
                   "step_ms": [h["wall_s"] * 1e3 for h in opt.history]}
            del opt, model
            model = build()
            o = fit(model, ExpertParallelOptimizer, c["check_steps"], mesh=mesh)
            res["check"] = ([h["loss"] for h in o.history], _flat_params(model))
            del o, model
            model = build()
            o = fit(model, _doubled(ExpertParallelOptimizer, MESH_PLANT["moe"]),
                    c["check_steps"], mesh=mesh)
            res["planted"] = ([h["loss"] for h in o.history], _flat_params(model))
            del o, model
            _free()
            _comm.barrier()
            if rank == 0:
                model = build()
                o = fit(model, LocalOptimizer, c["check_steps"])
                res["ref"], res["p0"] = ([h["loss"] for h in o.history],
                                         _flat_params(model)), p0
                del o, model
                _free()
            _comm.barrier()
            out[f"top{k}"] = res
    finally:
        restore()


def _mesh_job_hybrid(rank, world, out):
    """[23d] the LM through HybridParallelOptimizer on data 2 x model 2
    under the Megatron plan."""
    from bigdl_tpu_torch.analysis import ParamAuditError
    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.parallel import (HybridParallelOptimizer, _comm, hybrid, make_mesh,
                                          megatron_transformer_plan)

    w, dev = MESH_LM, MESH_DEVICE
    mesh = make_mesh({"data": 2, "model": 2})
    x, y = _lm_data(SEED + 2)
    restore = _bf16_card(fused=False)
    try:
        model = _mesh_lm(dev, SEED)
        model.init(sample_input=x[:w["batch"]])
        from bigdl_tpu_torch.utils.serialization import tree_items

        plan = megatron_transformer_plan()
        items = tree_items(model.get_parameters())
        out["whole"] = sum(p.numel() * 4 for p in items.values())
        out["sharded"] = sum(p.numel() * 4 for k, p in items.items() if plan.spec_for(k) != ())
        _comm.reset_counts()
        reset_counts()  # the main path starts here
        opt = _lm_fit(model, HybridParallelOptimizer, x, y, w["steps"], observe=out,
                      plan=megatron_transformer_plan(), mesh=mesh)
        _sync()
        out["counts"] = read_counts()  # the main path ends here
        out["comm"] = _comm.counts()
        out.update(losses=[h["loss"] for h in opt.history], held=opt.held_bytes,
                   step_ms=[h["wall_s"] * 1e3 for h in opt.history])
        del opt
        # a NaN planted in one block of rank 1: its audit names the leaf,
        # the block and the rank; every other rank stops naming rank 1
        real = hybrid.shard_leaf
        planted = []

        def shard_and_plant(leaf, spec, m):
            blk = real(leaf, spec, m)
            if m.rank == 1 and not planted and blk.dim() == 2:
                blk[0, 0] = float("nan")
                planted.append(True)
            return blk

        hybrid.shard_leaf = shard_and_plant
        try:
            _lm_fit(model, HybridParallelOptimizer, x, y, 1, plan=megatron_transformer_plan(),
                    mesh=mesh)
            out["audit"] = "passed"
        except ParamAuditError as e:
            out["audit"] = str(e)
        finally:
            hybrid.shard_leaf = real
        del model
        _free()
    finally:
        restore()
    restore = _f32_card()
    try:
        model = _mesh_lm(dev, SEED + 3)
        model.init(sample_input=x[:w["batch"]])
        p0 = _flat_params(model)
        seen = {}
        o = _lm_fit(model, HybridParallelOptimizer, x, y, 3, observe=seen,
                    plan=megatron_transformer_plan(), mesh=mesh)
        out["check"] = ([h["loss"] for h in o.history], _flat_params(model))
        out["check_norms"] = _grad_norms(seen["observed"])
        del o, model
        # [26b] donate=False: the same update into fresh blocks, to the bit
        model = _mesh_lm(dev, SEED + 3)
        model.init(sample_input=x[:w["batch"]])
        o = _lm_fit(model, HybridParallelOptimizer, x, y, 3, plan=megatron_transformer_plan(),
                    mesh=mesh, donate=False)
        out["undonated"] = _flat_params(model)
        del o, model
        model = _mesh_lm(dev, SEED + 3)
        model.init(sample_input=x[:w["batch"]])
        o = _lm_fit(model, _doubled(HybridParallelOptimizer, MESH_PLANT["hybrid"]), x, y, 3,
                    observe=seen, plan=megatron_transformer_plan(), mesh=mesh)
        out["planted"] = ([h["loss"] for h in o.history], _flat_params(model))
        out["planted_norms"] = _grad_norms(seen["observed"])
        del o, model
        _free()
        _slice28_hybrid_runs(mesh, x, y, out)  # [27b]
        _comm.barrier()
        if rank == 0:
            model = _mesh_lm(dev, SEED + 3)
            model.init(sample_input=x[:w["batch"]])
            o = _lm_fit(model, LocalOptimizer, x, y, 3, observe=seen)
            out["ref"], out["p0"] = ([h["loss"] for h in o.history], _flat_params(model)), p0
            out["ref_norms"] = _grad_norms(seen["observed"])
            del o, model
            model = _mesh_lm(dev, SEED + 3)  # [27b]'s reference: one rank, the same micro-batches
            model.init(sample_input=x[:w["batch"]])
            o = _lm_fit(model, LocalOptimizer, x, y, 3, micro=SLICE28_MICRO)
            out["micro_ref"] = ([h["loss"] for h in o.history], _flat_params(model))
            del o, model
            _free()
        _comm.barrier()
    finally:
        restore()


_MESH_JOBS = {"pipe": _mesh_job_pipe, "ring": _mesh_job_ring, "moe": _mesh_job_moe,
              "hybrid": _mesh_job_hybrid}


def _mesh_rank(rank, world, folder, jobs, settings):
    """A spawned rank of [23]: take the parent's ``settings`` (device and
    sizes), join the group through a file, run ``jobs`` in order, save what
    the parent checks as ``rank<r>.pt``."""
    import torch

    global MESH_DEVICE
    MESH_DEVICE = settings["device"]
    for table, values in ((MESH_PIPE, settings["pipe"]), (MESH_LM, settings["lm"]),
                          (MESH_MOE, settings["moe"])):
        table.update(values)
    sys.path.insert(0, str(ROOT))
    from bigdl_tpu_torch import Engine

    Engine.init_distributed(f"file://{folder}/group", world, rank,
                            device=None if MESH_DEVICE == "cuda" else "cpu")
    if MESH_DEVICE == "cuda":  # the library's load launches the probe once: before any path
        from bigdl_tpu_torch.ops import _build

        _build.load()
    results = {"backend": Engine.backend(), "device": str(Engine.rank_device())}
    try:
        for job in jobs:
            t0 = time.perf_counter()
            results[job] = {}
            _MESH_JOBS[job](rank, world, results[job])
            results[job]["wall_s"] = time.perf_counter() - t0
    finally:
        Engine.shutdown_distributed()
    torch.save(results, os.path.join(folder, f"rank{rank}.pt"))


def _spawn_mesh(jobs, world):
    """``jobs`` on ``world`` spawned ranks sharing the card; each rank's
    results. A rank that fails or outlives ``RANK_DEADLINE_S`` fails the
    run (the end of its stderr is printed)."""
    import tempfile

    import torch
    from bigdl_tpu_torch.examples._common import spawn

    with tempfile.TemporaryDirectory(prefix="smoke_mesh_") as folder:
        settings = {"device": MESH_DEVICE, "pipe": MESH_PIPE, "lm": MESH_LM, "moe": MESH_MOE}
        spawn(_mesh_rank, (folder, list(jobs), settings), world, RANK_DEADLINE_S,
              stderr_dir=folder)
        return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _sum_rank_counts(ranks, job, key="counts"):
    total = {}
    for res in ranks:
        for k, v in res[job][key].items():
            total[k] = total.get(k, 0) + v
    return total


def _check_backend(label, ranks):
    log(f"{label} {len(ranks)} ranks on {ranks[0]['device']} over {ranks[0]['backend']}")
    if MESH_DEVICE == "cuda" and ranks[0]["backend"] != "gloo":
        raise AssertionError(f"{label} ranks sharing one card took {ranks[0]['backend']}")


def phase_mesh_pipe(card):
    """[23a]; returns the path's launches (summed over the ranks)."""
    import numpy as np

    c = MESH_PIPE
    ranks = _spawn_mesh(["pipe"], c["stages"])
    _check_backend("[23a] GPipe norm-LM/LN:", ranks)
    r0 = ranks[0]["pipe"]
    losses = r0["losses"]
    log(f"[23a] PipelineOptimizer on make_mesh({{'pipe': {c['stages']}}}), n_micro "
        f"{c['n_micro']}, batch {c['batch']} x {c['seq']}, bf16, the fused-kernel switch on, "
        f"Adam(3e-3): {len(losses)} iterations in {r0['wall_s']:.1f} s (the phase), step "
        f"{r0['step_ms']:.1f} ms (median of iterations 3-{c['iters']}); losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; card {card}")
    for r, res in enumerate(ranks):
        if res["pipe"]["losses"] != losses:
            raise AssertionError(f"[23a] rank {r}'s losses differ from rank 0's")
    if len(losses) != c["iters"] or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[23a] losses {losses}")
    whole, stacked = r0["whole"], r0["stacked"]
    want = whole - stacked + stacked // c["stages"]
    held = [res["pipe"]["held"] for res in ranks]
    log(f"    held a rank: parameters {held[0]['params'] / 2**20:.2f} MiB, Adam slots "
        f"{held[0]['slots'] / 2**20:.2f} MiB (the whole model {whole / 2**20:.2f} MiB, its "
        f"stack {stacked / 2**20:.2f} MiB: expected {want / 2**20:.2f} and twice that)")
    if any(h["params"] != want or h["slots"] != 2 * want for h in held):
        raise AssertionError(f"[23a] held bytes {held}, expected {want} and {2 * want}")
    per_rank = (c["n_micro"] + 1) * c["iters"]  # each microbatch's stage norm and the final one
    for r, res in enumerate(ranks):
        got = _nonzero(res["pipe"]["counts"])
        exp = {"layer_norm_fwd": per_rank, "layer_norm_bwd": per_rank}
        if MESH_DEVICE == "cuda" and got != exp:
            raise AssertionError(f"[23a] rank {r} launched {got}, expected {exp}")
    comm = r0["comm"]
    log(f"    launches a rank: layer_norm_fwd / _bwd {per_rank} each ({c['n_micro']} "
        f"microbatches + the final norm, x {c['iters']} iterations), nothing else; hops a "
        f"rank: ppermute {comm['ppermute']['calls']} ({comm['ppermute']['bytes'] / 2**20:.1f} "
        f"MiB), broadcast {comm['broadcast']['calls']} "
        f"({comm['broadcast']['bytes'] / 2**20:.1f} MiB)")
    _against("[23a] 3 f32 SGD steps, GPipe vs the sequential stack on one rank", r0["check"],
             r0["ref"], r0["p0"], MESH_TOL["pipe"], r0["planted"])
    s = c["stages"]
    _check_observed("[26b] [23a]'s bf16 run:", ranks, "pipe", c["iters"],
                    bubble=(s - 1) / (c["n_micro"] + s - 1))
    _norms_against("[26b] [23a]'s 3 f32 steps", r0["check_norms"], r0["ref_norms"],
                   r0["planted_norms"], MESH_HEALTH_TOL["pipe"])
    return _sum_rank_counts(ranks, "pipe")


def phase_mesh_four(card):
    """[23b]-[23d] on 4 ranks; returns their paths' launches."""
    import numpy as np

    ranks = _spawn_mesh(["ring", "moe", "hybrid"], 4)
    _check_backend("[23b]-[23d]:", ranks)
    w = MESH_LM
    by_path = {}
    # [23b]
    r0 = ranks[0]["ring"]
    chunk = w["batch"] * w["heads"] * (w["seq"] // w["sp"]) * (w["hidden"] // w["heads"]) * 2
    want_bytes = 2 * (w["sp"] - 1) * 2 * w["layers"] * chunk * w["steps"]
    log(f"[23b] ring attention: the LM (V {w['vocab']}, H {w['hidden']}, {w['heads']} heads, "
        f"{w['layers']} layers, T {w['seq']}, batch {w['batch']}, bf16) through LocalOptimizer "
        f"on {w['sp']} ranks of {w['seq'] // w['sp']} positions: losses "
        + ", ".join(f"{v:.4f}" for v in r0["losses"]) + ", step ms "
        + ", ".join(f"{v:.0f}" for v in r0["step_ms"]) + f"; ppermute "
        f"{r0['comm']['ppermute']['bytes'] / 2**20:.1f} MiB a rank over {w['steps']} steps "
        f"(3 hops x K, V x {w['layers']} layers, forward and backward: "
        f"{want_bytes / 2**20:.1f} MiB); card {card}")
    for r, res in enumerate(ranks):
        if res["ring"]["comm"]["ppermute"]["bytes"] != want_bytes:
            raise AssertionError(f"[23b] rank {r} moved {res['ring']['comm']['ppermute']}")
        if any(res["ring"]["counts"].values()):
            raise AssertionError(f"[23b] rank {r} launched {_nonzero(res['ring']['counts'])} "
                                 "under the ring registration")
        if res["ring"]["losses"] != r0["losses"] or not all(np.isfinite(r0["losses"])):
            raise AssertionError(f"[23b] rank {r}'s losses {res['ring']['losses']}")
    cleared = _nonzero(r0["cleared_counts"])
    exp = {k: w["layers"] for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")}
    log(f"    after set_sequence_parallel(None), one step on rank 0: launches {cleared} "
        f"(expected {exp}, [6]'s count for one iteration)")
    if MESH_DEVICE == "cuda" and cleared != exp:
        raise AssertionError(f"[23b] the cleared step launched {cleared}")
    _against("[23b] 3 f32 SGD steps, the ring vs the dense route on one rank", r0["check"],
             r0["ref"], r0["p0"], MESH_TOL["ring"], r0["planted"])
    by_path["mesh_ring"] = _sum_rank_counts(ranks, "ring")
    by_path["mesh_ring_cleared"] = dict(r0["cleared_counts"])
    # [23c]
    c = MESH_MOE
    for k in (1, 2):
        res0 = ranks[0]["moe"][f"top{k}"]
        cap = int(np.ceil(c["batch"] / c["experts"] / c["experts"] * c["capacity_factor"] * k))
        a2a = 2 * 2 * c["experts"] * cap * c["hidden"] * 4 * c["iters"]
        whole, experts = res0["whole"], res0["experts"]
        want = whole - experts + experts // c["experts"]
        log(f"[23c] expert parallelism, top-{k}: the bench's MoE (H {c['hidden']}, "
            f"{c['experts']} experts, batch {c['batch']}, capacity {c['capacity_factor']}) "
            f"through ExpertParallelOptimizer, f32: losses "
            + ", ".join(f"{v:.4f}" for v in res0["losses"]) + ", step ms "
            + ", ".join(f"{v:.1f}" for v in res0["step_ms"]) + f"; all-to-all "
            f"{res0['comm']['all_to_all']['bytes'] / 2**20:.2f} MiB a rank over {c['iters']} "
            f"steps (2 hops x E {c['experts']} x C {cap} x D {c['hidden']} x 4 B, forward and "
            f"backward: {a2a / 2**20:.2f} MiB); held parameters {res0['held']['params'] / 2**20:.2f}"
            f" MiB (expected {want / 2**20:.2f}: one expert of {experts / 2**20:.2f}); card {card}")
        for r, res in enumerate(ranks):
            rr = res["moe"][f"top{k}"]
            if rr["comm"]["all_to_all"]["bytes"] != a2a or rr["held"]["params"] != want:
                raise AssertionError(f"[23c] top-{k} rank {r}: {rr['comm']['all_to_all']}, "
                                     f"held {rr['held']}")
            if rr["losses"] != res0["losses"] or not all(np.isfinite(rr["losses"])):
                raise AssertionError(f"[23c] top-{k} rank {r}'s losses {rr['losses']}")
        _against(f"[23c] top-{k}, 3 f32 SGD steps vs the dense MoE on one rank", res0["check"],
                 res0["ref"], res0["p0"], MESH_TOL["moe"], res0["planted"])
        by_path[f"mesh_moe_top{k}"] = _sum_rank_counts([r["moe"] for r in ranks], f"top{k}")
    # [23d]
    r0 = ranks[0]["hybrid"]
    held = [res["hybrid"]["held"]["params"] for res in ranks]
    log(f"[23d] data 2 x model 2, the LM under megatron_transformer_plan(), bf16, SGD 0.1: "
        f"losses " + ", ".join(f"{v:.4f}" for v in r0["losses"]) + ", step ms "
        + ", ".join(f"{v:.0f}" for v in r0["step_ms"]) + f"; held parameters a rank "
        f"{held[0] / 2**20:.2f} MiB against {r0['whole'] / 2**20:.2f} MiB replicated (its "
        f"Megatron-sharded leaves {r0['sharded'] / 2**20:.2f} MiB, halved); card {card}")
    want = r0["whole"] - r0["sharded"] + r0["sharded"] // 2  # the model axis halves them
    if any(h != want for h in held) or any(res["hybrid"]["held"]["slots"] for res in ranks):
        raise AssertionError(f"[23d] held bytes {held}, expected {want} and no slots")
    exp = {k: w["layers"] * w["steps"] for k in ("flash_attention_fwd",
                                                 "flash_attention_bwd_dq",
                                                 "flash_attention_bwd_dkv")}
    for r, res in enumerate(ranks):
        if MESH_DEVICE == "cuda" and _nonzero(res["hybrid"]["counts"]) != exp:
            raise AssertionError(f"[23d] rank {r} launched {_nonzero(res['hybrid']['counts'])}")
    audits = [res["hybrid"]["audit"] for res in ranks]
    log(f"    flash launches a rank {exp} (its data rows); ShardedParamAudit passed on the "
        f"run; with a NaN planted in rank 1's block: rank 1 says {audits[1][:160]!r}; rank 0 "
        f"says {audits[0][:100]!r}")
    # rank 1 is (data 0, model 1): the second half of the rows of the first
    # leaf cut, block0's q
    h = w["hidden"]
    if not (f"['block0']['self_q_w'] (shard [{h // 2}:{h}, 0:{h}] on rank 1)" in audits[1]
            and all("rank(s) [1]" in a for i, a in enumerate(audits) if i != 1)):
        raise AssertionError(f"[23d] the audits said {audits}")
    _against("[23d] 3 f32 SGD steps, hybrid vs LocalOptimizer on one rank", r0["check"],
             r0["ref"], r0["p0"], MESH_TOL["hybrid"], r0["planted"])
    _check_observed("[26b] [23d]'s bf16 run:", ranks, "hybrid", w["steps"])
    _norms_against("[26b] [23d]'s 3 f32 steps", r0["check_norms"], r0["ref_norms"],
                   r0["planted_norms"], MESH_HEALTH_TOL["hybrid"])
    for r, res in enumerate(ranks):
        if not bool((res["hybrid"]["undonated"] == res["hybrid"]["check"][1]).all()):
            raise AssertionError(f"[26b] rank {r}: donate=False moved the parameters otherwise")
    log("    [26b] [23d]'s 3 f32 steps with donate=False: every rank's parameters equal the "
        "donated run's to the bit")
    by_path["mesh_hybrid"] = _sum_rank_counts(ranks, "hybrid")
    by_path.update(_check_slice28_mesh(ranks, card))  # [27b]
    return by_path


def phase_mesh_examples(card):
    """[23e] the three mesh mains at their JAX mains' defaults but one epoch
    (``--max-epoch 1``, of 2) over ``MESH_EXAMPLE_TOKENS`` planted-bigram
    tokens (half their default), started together (20 ranks sharing the card;
    their output to files, so no pipe fills while another is read) with
    [22]'s two-process tool beside them, each joined under its deadline."""
    import re
    import tempfile

    with tempfile.TemporaryDirectory(prefix="smoke_examples_") as folder:
        procs = {}
        for name in MESH_EXAMPLES + ("multiprocess_tool",):
            if name == "multiprocess_tool":
                args = _multiprocess_tool_args()
            else:
                args = [sys.executable, "-m", f"bigdl_tpu_torch.examples.{name}",
                        "--max-epoch", "1", "--synthetic-size", str(MESH_EXAMPLE_TOKENS)]
            if MESH_DEVICE == "cpu" and name != "multiprocess_tool":
                args += ["--platform", "cpu"]
            out = open(os.path.join(folder, f"{name}.out"), "w")
            err = open(os.path.join(folder, f"{name}.err"), "w")
            procs[name] = (subprocess.Popen(args, stdout=out, stderr=err, cwd=str(ROOT)),
                           time.perf_counter(), out, err)
        failed = []
        for name, (proc, t0, out, err) in procs.items():
            try:
                proc.wait(timeout=max(1.0, MESH_EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            wall = time.perf_counter() - t0
            out.close()
            err.close()
            with open(out.name) as f:
                text = f.read()
            with open(err.name) as f:
                tail = f.read()[-3000:]
            if name == "multiprocess_tool":
                lines = [ln for ln in text.splitlines() if ln.startswith("{")]
                log(f"[22] tools/torch_multiprocess_smoke.py (beside [23e]): exit "
                    f"{proc.returncode} in {wall:.1f} s, {lines[-1] if lines else text[-500:]}; "
                    f"card {card}")
                if proc.returncode != 0:
                    failed.append(f"the two-process smoke:\n{text[-2000:]}\n{tail}")
                continue
            found = re.findall(r"bigram-map recovery: ([0-9.]+) \(rank 0 of (\d+)\)", text)
            log(f"[23e] examples/{name}.py: exit {proc.returncode} in {wall:.1f} s, "
                f"bigram-map recovery {found[-1][0] if found else None} over "
                f"{found[-1][1] if found else '?'} ranks; card {card}")
            if proc.returncode != 0 or not found:
                failed.append(f"{name}:\n{text[-2000:]}\n{tail}")
    if failed:
        raise AssertionError("[23e] " + "\n".join(failed))


def phase_slice24(card):
    """[23] the mesh parallelisms; returns the main paths' launches and
    [26a]'s ranks, started beside [23e] (a ``_Background``)."""
    t0 = time.perf_counter()
    by_path = {"mesh_pipe": phase_mesh_pipe(card)}
    by_path.update(phase_mesh_four(card))
    elastic = _Background(_spawn_elastic)  # [26a]'s ranks beside [23e]'s: pass/fail runs
    phase_mesh_examples(card)
    log(f"[23] done in {time.perf_counter() - t0:.1f} s")
    return by_path, elastic


# [24] the training drive loop's observability and resilience (slice 25),
# driven by the full-width LM of [6] through LocalOptimizer (SGD 0.1
# momentum 0.9, bf16 compute): [24a] every extra attached at once and two
# faults, [24b] a planted NaN, [24c] SIGTERM and a resume in a fresh process,
# [24d] the sync contract, [24e] a set_profile window, [24f] a terminal
# failure's postmortem. Rehearse it on the CPU by importing chip_smoke,
# setting OBS_DEVICE = "cpu", cutting OBS_LM (V 64, H 32, 4 heads, filter 64,
# 2 layers, T 16) and calling phase_slice25("cpu") (the launch checks are
# the card's).
OBS_DEVICE = "cuda"
OBS_LM = {"vocab": 8192, "hidden": 512, "heads": 8, "filt": 2048, "layers": 6, "seq": 2048,
          "batch": 8}
OBS_RECORDS = 48  # 6 batches an epoch
OBS_STEPS = 8
# [24b]: the NaN is planted at (epoch 1, batch 5): the target id 0 at column
# 0 (the data's targets never hold it there) turns the criterion's loss NaN
OBS_NAN_AT = (1, 5)
# [24d]: the counted window, steps [start, start + len)
OBS_SYNC_WINDOW = (3, 5)


def _obs_data(n: int, seed: int = SEED):
    import numpy as np

    gen = np.random.default_rng(seed)
    w = OBS_LM
    ids = gen.integers(0, w["vocab"], (n, w["seq"]))
    targets = gen.integers(1, w["vocab"], (n, w["seq"]))  # column 0 never 0
    return ids, targets


def _obs_classes():
    """The optimizer and criterion of [24]: LocalOptimizer counting its
    steps and validations, optionally running a profiler over a window of
    steps; CrossEntropy with the planted NaN's sentinel."""
    import torch
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import LocalOptimizer

    class Counting(LocalOptimizer):
        window = None  # (start, len): a torch.profiler over those steps

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.n_steps = self.n_validations = 0
            self.prof = None

        def _train_step(self, *a, **k):
            self.n_steps += 1
            return super()._train_step(*a, **k)

        def _validate_now(self):
            self.n_validations += 1
            return super()._validate_now()

        def _profile_window(self, neval):
            super()._profile_window(neval)
            if self.window is None:
                return
            start, n = self.window
            if neval == start:
                from torch.profiler import ProfilerActivity, profile

                try:  # every thread's events, and the synchronisations
                    from torch._C._profiler import _ExperimentalConfig

                    cfg = _ExperimentalConfig(profile_all_threads=True,
                                              enable_cuda_sync_events=True)
                except (ImportError, TypeError):
                    cfg = None
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
                self.prof = profile(activities=acts, experimental_config=cfg)
                self.prof.start()
            elif neval == start + n and self.prof is not None:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.prof.stop()

    class PlantedNaN(CrossEntropyCriterion):
        """A NaN factor on the loss where the sentinel is planted: the
        gradients and the updated weights go NaN too, as a diverging run's."""

        def _apply(self, input, target):
            loss = super()._apply(input, target)
            return loss * torch.where(target[0, 0] == 0, float("nan"), 1.0)

    return Counting, PlantedNaN


def _obs_opt(ids, targets, steps, criterion=None, dataset=None, **kw):
    """The LM's optimizer from the seed (the model built at its first
    batch, so every run starts from the same weights)."""
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.optim import SGD, Trigger

    Counting, _ = _obs_classes()
    w = OBS_LM
    Engine.set_compute_dtype("bfloat16")
    RandomGenerator.set_seed(SEED)
    model = Transformer(w["vocab"], w["hidden"], w["heads"], w["filt"], w["layers"], 0.0, 0.0,
                        0.0, mode="lm", device=OBS_DEVICE)
    ds = dataset if dataset is not None else DataSet.array(ids, targets, batch_size=w["batch"])
    opt = Counting(model, ds, criterion or CrossEntropyCriterion(), **kw)
    return opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9)).set_end_when(
        Trigger.max_iteration(steps))


def _obs_params(model):
    import torch

    return torch.cat([p.detach().float().flatten() for p in model.parameters()])


def _hooked(ds, hook):
    """``ds`` with ``hook(epoch, index, batch) -> batch or None`` on every
    training batch."""
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet

    class Hooked(AbstractDataSet):
        def __init__(self):
            self._epoch = 1

        def size(self):
            return ds.size()

        def shuffle(self, epoch=None):
            if epoch is not None:
                self._epoch = int(epoch)
            ds.shuffle(epoch)

        def data(self, train):
            for i, b in enumerate(ds.data(train)):
                out = hook(self._epoch, i, b) if train else None
                yield b if out is None else out

    return Hooked()


def _resilience_records(tel):
    return [r for r in tel.ring.records if r["type"] in ("retry", "rollback", "fault_injected",
                                                         "preempt_checkpoint")]


def phase_obs_extras(card, root):
    """[24a] every extra at once, a fault at `dispatch` and one at
    `checkpoint`; bit-equal to a clean run. Returns the launches."""
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.obs import HealthConfig, PerfConfig, Telemetry
    from bigdl_tpu_torch.optim import Loss, Trigger
    from bigdl_tpu_torch.resilience import FailurePolicy, FaultPlan
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary, read_events

    ids, targets = _obs_data(OBS_RECORDS)
    vx, vy = _obs_data(OBS_LM["batch"], seed=SEED + 1)
    clean = _obs_opt(ids, targets, OBS_STEPS)
    t0 = time.perf_counter()
    clean.optimize()
    p_clean = _obs_params(clean.model)
    clean_s = time.perf_counter() - t0
    del clean
    run_dir = os.path.join(root, "a")
    Engine.set_run_dir(run_dir)
    try:
        tel = Telemetry()  # the JSONL under the run dir, the ring, the flight recorder
        opt = _obs_opt(ids, targets, OBS_STEPS)
        opt.set_telemetry(tel).set_health(HealthConfig()).set_perf(PerfConfig(every_n_steps=4))
        summaries = (TrainSummary(run_dir, "lm"), ValidationSummary(run_dir, "lm"))
        opt.set_train_summary(summaries[0]).set_val_summary(summaries[1])
        opt.set_validation(Trigger.several_iteration(4),
                           DataSet.array(vx, vy, batch_size=OBS_LM["batch"]),
                           [Loss(CrossEntropyCriterion())])
        opt.set_failure_policy(FailurePolicy(backoff_base_s=0.0))
        opt.set_checkpoint(trigger=Trigger.several_iteration(2), keep_last=1)
        plan = FaultPlan(telemetry=tel).arm("dispatch", at_hit=3).arm("checkpoint", at_hit=2)
        reset_counts()  # the main path starts here
        t0 = time.perf_counter()
        with plan:
            opt.optimize()
        if OBS_DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()  # the main path ends here
        tel.close()
        for summary in summaries:
            summary.close()
    finally:
        Engine.set_run_dir(None)
    p_run = _obs_params(opt.model)
    equal = torch.equal(p_run, p_clean)
    recs = tel.ring.records
    steps = [r for r in recs if r["type"] == "step"]
    health = [r for r in recs if r["type"] == "health"]
    perf = [r for r in recs if r["type"] == "perf"]
    last_block = f"block{OBS_LM['layers'] - 1}/out_w"
    h = health[-1]["layers"]
    train_events = read_events(os.path.join(run_dir, "lm", "train"))
    val_events = read_events(os.path.join(run_dir, "lm", "validation"))
    n_fwd = OBS_LM["layers"] * (opt.n_steps + opt.n_validations)
    n_bwd = OBS_LM["layers"] * opt.n_steps
    want = {"flash_attention_fwd": n_fwd, "flash_attention_bwd_dq": n_bwd,
            "flash_attention_bwd_dkv": n_bwd}
    got = {k: counts[k] for k in want}
    log(f"[24a] the LM with telemetry, health, perf, summaries, validation, checkpoints "
        f"under the run dir and a FailurePolicy; faults {plan.events}: {opt.n_steps} steps "
        f"dispatched for {OBS_STEPS} ({len(_resilience_records(tel))} resilience records), "
        f"{opt.n_validations} validations, {wall:.2f} s (the clean run {clean_s:.2f} s); "
        f"final parameters bit-equal to the clean run: {equal}; card {card}")
    log("    step records: " + ", ".join(
        f"it {r['iteration']} mfu {r.get('mfu')} achieved {r.get('achieved_flops_s')} FLOP/s "
        f"wall {r['wall_s']:.4f} s" for r in steps[-3:]))
    log(f"    model_flops a step {steps[-1].get('model_flops')}; perf records "
        f"{[(r['iteration'], r['mfu'], r['breakdown']) for r in perf]}")
    log(f"    health (iteration {health[-1]['iteration']}): embedding grad_norm "
        f"{h['embedding']['grad_norm']:.6g} weight_norm {h['embedding']['weight_norm']:.6g} "
        f"update_ratio {h['embedding']['update_ratio']:.3g}; {last_block} grad_norm "
        f"{h[last_block]['grad_norm']:.6g} weight_norm {h[last_block]['weight_norm']:.6g} "
        f"update_ratio {h[last_block]['update_ratio']:.3g}; global {health[-1]['global']}")
    log(f"    launches including the replays: {got} (expected {want}); event files: "
        f"{sum(1 for e in train_events if 'Loss' in e['scalars'])} train Loss scalars, "
        f"{len([e for e in val_events if e['scalars']])} validation scalars")
    if not equal:
        d = (p_run - p_clean).abs().max().item()
        raise AssertionError(f"[24a] the recovered run's parameters differ from the clean "
                             f"run's (max |diff| {d:.3e})")
    if [e["seam"] for e in plan.events] != ["dispatch", "checkpoint"]:
        raise AssertionError(f"[24a] the faults fired as {plan.events}")
    if OBS_DEVICE == "cuda":
        if got != want or sum(counts.values()) != sum(got.values()):
            raise AssertionError(f"[24a] launches {counts}, expected {want}")
        if not steps[-1].get("mfu") or not steps[-1].get("achieved_flops_s"):
            raise AssertionError(f"[24a] no mfu on the step record: {steps[-1]}")
    if not (h["embedding"]["grad_norm"] > 0 and h[last_block]["weight_norm"] > 0):
        raise AssertionError(f"[24a] health norms {h['embedding']} {h[last_block]}")
    del opt
    return counts


def phase_obs_nan(card, root):
    """[24b] a NaN planted in the loss at (epoch 1, batch 5)."""
    import numpy as np
    import torch
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.obs import Telemetry
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.resilience import FailurePolicy

    _, PlantedNaN = _obs_classes()
    ids, targets = _obs_data(OBS_RECORDS)

    def plant(epoch, i, batch):
        if (epoch, i) == OBS_NAN_AT:
            t = np.array(batch.get_target(), copy=True)
            t[:, 0] = 0
            return MiniBatch(batch.get_input(), t)
        return None

    ds = _hooked(DataSet.array(ids, targets, batch_size=OBS_LM["batch"]), plant)
    tel = Telemetry(exporters=[])
    opt = _obs_opt(ids, targets, OBS_STEPS + 2, criterion=PlantedNaN(), dataset=ds)
    opt.set_telemetry(tel).set_failure_policy(FailurePolicy(backoff_base_s=0.0))
    opt.set_checkpoint(os.path.join(root, "b"), Trigger.several_iteration(2), keep_last=2)
    t0 = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t0
    pol = opt.failure_policy
    seq = [(r["type"], r.get("fault_class") or r.get("reason")) for r in _resilience_records(tel)]
    rb = [r for r in tel.ring.records if r["type"] == "rollback"]
    finite = bool(torch.isfinite(_obs_params(opt.model)).all())
    log(f"[24b] NaN planted at {OBS_NAN_AT}: records {seq}; rollback to step "
        f"{rb[0]['restored_step'] if rb else None} with lr_scale "
        f"{rb[0]['lr_scale'] if rb else None}; skip positions {sorted(pol.skip_positions)}; "
        f"lr scale in force {opt.optim_method.state.get('_lr_scale')}; {opt.n_steps} steps "
        f"dispatched, neval {opt.optim_method.state['neval']}, parameters finite: {finite}; "
        f"{wall:.2f} s")
    # the sequence tests/test_torch_resilience_training.py holds equal to the
    # JAX package's: each divergence rolls back, the second one at the same
    # position is poison and skipped
    want = [("retry", "divergence"), ("rollback", "non_finite_loss"), ("retry", "poison_batch"),
            ("rollback", "non_finite_loss")]
    if (seq != want or sorted(pol.skip_positions) != [OBS_NAN_AT] or not finite
            or opt.optim_method.state.get("_lr_scale") != 0.5 or rb[0]["lr_scale"] != 0.5
            or opt.optim_method.state["neval"] < OBS_STEPS + 2):
        raise AssertionError(f"[24b] the rollback sequence {seq} (expected {want})")
    del opt


def _resume_child(ckpt: str, out: str, device: str, lm: dict) -> None:
    """[24c]'s fresh process: the same optimizer (on ``device``, at the
    parent's ``OBS_LM``), ``resume(ckpt)``, the rest of the run; the
    parameters saved to ``out``."""
    import torch

    global OBS_DEVICE, OBS_LM
    OBS_DEVICE, OBS_LM = device, lm
    sys.path.insert(0, str(ROOT))
    ids, targets = _obs_data(OBS_RECORDS)
    opt = _obs_opt(ids, targets, OBS_STEPS)
    opt.resume(ckpt)
    opt.optimize()
    torch.save(_obs_params(opt.model).cpu(), out)


def phase_obs_preempt(card, root):
    """[24c] SIGTERM at the 5th batch, the guard installed: the emergency
    checkpoint, ``TrainingPreempted`` (exit code 0), then ``resume()`` in a
    fresh process, bit-equal to an uninterrupted run."""
    import signal

    import torch
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.obs import Telemetry
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.resilience import TrainingPreempted

    ids, targets = _obs_data(OBS_RECORDS)
    ref = _obs_opt(ids, targets, OBS_STEPS)
    ref.optimize()
    p_ref = _obs_params(ref.model).cpu()
    del ref
    sent = []

    def kill(epoch, i, batch):
        if not sent and i == 4:
            sent.append(i)
            os.kill(os.getpid(), signal.SIGTERM)
        return None

    ckpt = os.path.join(root, "c")
    tel = Telemetry(exporters=[])
    opt = _obs_opt(ids, targets, OBS_STEPS,
                   dataset=_hooked(DataSet.array(ids, targets, batch_size=OBS_LM["batch"]), kill))
    opt.set_telemetry(tel).set_preemption()
    opt.set_checkpoint(ckpt, Trigger.several_iteration(3), keep_last=1)
    try:
        opt.optimize()
        raise AssertionError("[24c] the run was not preempted")
    except TrainingPreempted as e:
        exc = e
    handler_back = signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    del opt
    out = os.path.join(root, "c_params.pt")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke._resume_child("
                        f"{ckpt!r}, {out!r}, {OBS_DEVICE!r}, {OBS_LM!r})"], cwd=str(ROOT), capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    child_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"[24c] the resuming process failed:\n{r.stderr[-3000:]}")
    p_resumed = torch.load(out)
    equal = torch.equal(p_resumed, p_ref)
    pre = [r for r in tel.ring.records if r["type"] == "preempt_checkpoint"]
    log(f"[24c] SIGTERM at batch 4: TrainingPreempted(exit_code={exc.exit_code}) at step "
        f"{exc.step}, emergency checkpoint under {os.path.basename(ckpt)}/, record {pre}; the "
        f"SIGTERM handler restored: {handler_back}; resumed in a fresh process "
        f"({child_s:.1f} s): bit-equal to the uninterrupted run: {equal}")
    if exc.exit_code != 0 or not pre or not handler_back or not equal:
        raise AssertionError("[24c] the preempted and resumed run is not the uninterrupted one")


def _sync_counts(prof, steps: int):
    """Device-to-host copies and stream/device/event synchronisations a
    step in a profiler's trace (its Chrome trace, every thread)."""
    import json
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        path = f.name
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    d2h = sum(1 for e in events if "DtoH" in str(e.get("name", ""))
              and e.get("cat") in ("gpu_memcpy", "Memcpy"))
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name") in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                      "cudaEventSynchronize"))
    return d2h / steps, syncs / steps


def phase_obs_sync(card, root):
    """[24d] the sync contract: device-to-host copies and synchronisations a
    step, bare loop against every extra attached; equal."""
    import statistics

    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.obs import HealthConfig, PerfConfig, Telemetry
    from bigdl_tpu_torch.optim import Loss, Trigger
    from bigdl_tpu_torch.resilience import FailurePolicy, FaultPlan
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

    ids, targets = _obs_data(OBS_RECORDS)
    start, n = OBS_SYNC_WINDOW
    out = {}
    for label in ("bare", "extras"):
        opt = _obs_opt(ids, targets, start + n)
        opt.window = OBS_SYNC_WINDOW
        run_dir = os.path.join(root, "d")
        if label == "extras":
            Engine.set_run_dir(run_dir)
            opt.set_telemetry(Telemetry()).set_health(HealthConfig()).set_perf(
                PerfConfig(every_n_steps=2))
            opt.set_train_summary(TrainSummary(run_dir, "lm"))
            opt.set_val_summary(ValidationSummary(run_dir, "lm"))
            # attached, firing outside the window (they copy to the host by design)
            opt.set_validation(Trigger.several_iteration(100),
                               DataSet.array(ids[:8], targets[:8], batch_size=8),
                               [Loss(CrossEntropyCriterion())])
            opt.set_checkpoint(trigger=Trigger.several_iteration(100))
            opt.set_failure_policy(FailurePolicy()).set_preemption()
        try:
            with FaultPlan():  # the chaos hook installed, nothing armed
                opt.optimize()
        finally:
            Engine.set_run_dir(None)
        d2h, syncs = _sync_counts(opt.prof, n)
        walls = [h["wall_s"] for h in opt.history if start <= h["neval"] < start + n]
        out[label] = (d2h, syncs, statistics.median(walls) * 1e3)
        del opt
    log(f"[24d] a step over steps {start}-{start + n - 1}: bare loop {out['bare'][0]:g} "
        f"device-to-host copies, {out['bare'][1]:g} synchronisations, step "
        f"{out['bare'][2]:.2f} ms; every extra attached {out['extras'][0]:g} copies, "
        f"{out['extras'][1]:g} synchronisations, step {out['extras'][2]:.2f} ms; card {card}")
    if out["bare"][:2] != out["extras"][:2]:
        raise AssertionError(f"[24d] the extras change the syncs a step: {out}")
    return out


def phase_obs_profile(card, root):
    """[24e] one set_profile window: the seams and the flash kernels in its
    trace."""
    import json

    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.dataset import SampleToMiniBatch
    from bigdl_tpu_torch.obs import Telemetry
    from bigdl_tpu_torch.optim import Trigger

    ids, targets = _obs_data(44)  # 5 full batches and a ragged 4-row tail an epoch
    run_dir = os.path.join(root, "e")
    Engine.set_run_dir(run_dir)
    try:
        opt = _obs_opt(ids, targets, 7, dataset=DataSet.array(
            ids, targets, transformer=SampleToMiniBatch(OBS_LM["batch"])))
        # steps 2-5: the prefetch thread (depth 2) pads the tail (the 6th
        # batch) after the driver takes the 3rd, inside the window
        opt.set_profile(start_iteration=2, num_iterations=4)
        opt.set_telemetry(Telemetry(exporters=[]))
        opt.set_checkpoint(trigger=Trigger.several_iteration(2), keep_last=1)
        opt.optimize()
    finally:
        Engine.set_run_dir(None)
    with open(os.path.join(run_dir, "profile", "trace.json")) as f:
        names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
    seams = {s: s in names for s in ("dispatch", "prefetch", "pad_mask", "checkpoint")}
    kernels = {k: any(k in nm for nm in names)
               for k in ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")}
    log(f"[24e] set_profile window (steps 2-5) under the run dir: {len(names)} distinct "
        f"names; seams {seams}; kernels {kernels}")
    if not all(seams.values()) or (OBS_DEVICE == "cuda" and not all(kernels.values())):
        raise AssertionError(f"[24e] the trace lacks {seams} {kernels}")


def phase_obs_postmortem(card, root):
    """[24f] a terminal failure (the budget 0) leaves a verified bundle."""
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.obs import Telemetry, load_bundle, verify_bundle
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.resilience import FailurePolicy, FaultInjected, FaultPlan

    ids, targets = _obs_data(OBS_RECORDS)
    run_dir = os.path.join(root, "f")
    Engine.set_run_dir(run_dir)
    try:
        tel = Telemetry()
        opt = _obs_opt(ids, targets, 4)
        opt.set_telemetry(tel).set_failure_policy(FailurePolicy(backoff_base_s=0.0, max_total=0))
        opt.set_checkpoint(trigger=Trigger.several_iteration(1), keep_last=1)
        try:
            with FaultPlan(telemetry=tel).arm("dispatch", at_hit=2):
                opt.optimize()
            raise AssertionError("[24f] the fault did not leave optimize()")
        except FaultInjected:
            pass
    finally:
        Engine.set_run_dir(None)
    pm = os.path.join(run_dir, "postmortem")
    bundles = sorted(d for d in os.listdir(pm) if d != "hard_crash")
    path = os.path.join(pm, bundles[-1])
    manifest = verify_bundle(path)
    b = load_bundle(path)
    log(f"[24f] terminal FaultInjected: bundle {bundles[-1]} verifies ({len(manifest['files'])} "
        f"files), reason {b['reason']['reason']}, last step {b['rings']['step'][-1]['iteration']}, "
        f"checkpoint pointer step {(b['checkpoint'] or {}).get('step')}")
    if b["reason"]["error"]["class"] != "FaultInjected":
        raise AssertionError(f"[24f] bundle reason {b['reason']}")


def phase_slice25(card):
    """[24] the training drive loop's observability and resilience; returns
    the main path's launches ([24a])."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_obs_", dir=str(ROOT / "build")) as root:
        by_path = {"obs_lm": phase_obs_extras(card, root)}
        _free()
        phase_obs_nan(card, root)
        _free()
        phase_obs_preempt(card, root)
        _free()
        phase_obs_sync(card, root)
        _free()
        phase_obs_profile(card, root)
        _free()
        phase_obs_postmortem(card, root)
        _free()
    log(f"[24] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# [25] serving's remaining surface (slice 26), driven by the full-width LM of
# [5]. The boots run as fresh processes, each with its own empty cache
# directory under build/, so [25a] builds the kernel library once and [25b]
# loads the one its bundle carries. Rehearse it on the CPU by importing
# chip_smoke, setting SURF_DEVICE = "cpu", cutting SURF_LM (V 64, H 32, 4
# heads, filter 64, 2 layers, T 16) and calling phase_slice26("cpu") (the
# build and launch checks are the card's).
SURF_DEVICE = "cuda"
SURF_LM = {"vocab": 8192, "hidden": 512, "heads": 8, "filt": 2048, "layers": 6, "seq": 2048}
SURF_REQUESTS, SURF_THREADS, SURF_BATCH = 16, 4, 8
SURF_DRIFT_EVERY = 2  # [25d]
SURF_TOL = 0.1  # [25a]'s row against a direct forward: [5]'s bf16 limit


def _surface_lm(filt=None, seed=SEED):
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.nn import Transformer

    w = SURF_LM
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(None)
    RandomGenerator.set_seed(seed)
    return Transformer(w["vocab"], w["hidden"], w["heads"], filt or w["filt"], w["layers"],
                       0.0, 0.0, 0.0, mode="lm", device=SURF_DEVICE).eval()


def _surface_records(n=SURF_REQUESTS, seed=SEED):
    import numpy as np

    w = SURF_LM
    return np.random.RandomState(seed).randint(1, w["vocab"], size=(n, w["seq"])).astype(
        np.int64)


def _row_hash(t) -> str:
    """sha256 of a host tensor's bytes: rows compared bit for bit."""
    import hashlib

    import torch

    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).numpy()).hexdigest()


def _serve_threads(server, name, records, threads=SURF_THREADS):
    """Every record from ``threads`` client threads; the rows in order."""
    rows = [None] * len(records)

    def client(idx):
        futs = [(i, server.infer(name, records[i])) for i in idx]
        for i, f in futs:
            rows[i] = f.result(timeout=300)

    ts = [threading.Thread(target=client, args=(range(c, len(records), threads),))
          for c in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    if any(t.is_alive() for t in ts) or any(r is None for r in rows):
        raise RuntimeError("not every request was served")
    return rows


def _scrape(url):
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, (time.perf_counter() - t0) * 1e3, body


def _surface_child(mode: str, bundle: str, out: str, lm: dict, device: str) -> None:
    """[25a] (``mode="cold"``) or [25b] (``"warm"``) in a fresh process whose
    ``BIGDL_COMPILE_CACHE_DIR`` is empty: serve the 16 records, write the
    readings to ``out`` (JSON)."""
    import torch
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.serving import ModelServer

    global SURF_LM, SURF_DEVICE
    SURF_LM, SURF_DEVICE = lm, device
    t_boot = time.perf_counter()
    model = _surface_lm()
    records = _surface_records()
    res = {"mode": mode}
    scrapes = []
    reset_counts()  # the main path starts here
    server = ModelServer(metrics_port=0 if mode == "cold" else None)
    try:
        if mode == "warm":
            t0 = time.perf_counter()
            server.warm_start(bundle)
            res["warm_start_s"] = time.perf_counter() - t0
        server.register("lm", model, sample_input=records[0], batch_size=SURF_BATCH,
                        max_delay_ms=5, drift=True, drift_every=1,
                        artifacts=bundle if mode == "warm" else None)
        res["ready_s"] = time.perf_counter() - t_boot
        stop = threading.Event()

        def scraper():
            base = f"http://127.0.0.1:{server.metrics_port}"
            while not stop.is_set():
                for path in ("/healthz", "/metrics"):
                    code, ms, body = _scrape(base + path)
                    scrapes.append((path, code, ms, len(body)))
                stop.wait(0.02)

        scr = threading.Thread(target=scraper) if mode == "cold" else None
        if scr is not None:
            scr.start()
        t0 = time.perf_counter()
        rows = _serve_threads(server, "lm", records)
        res["serve_s"] = time.perf_counter() - t0
        if scr is not None:
            stop.set()
            scr.join(30)
        res["flushes"] = server.models()["lm"]["flushes"]
        res["aot_modules"] = server.models()["lm"]["aot_modules"]
        if mode == "cold":
            t0 = time.perf_counter()
            manifest = server.export_artifacts(bundle)
            res["export_s"] = time.perf_counter() - t0
            res["files"] = {k: v["bytes"] for k, v in manifest["files"].items()}
            res["cache_entries"] = manifest["cache_entries"]
    finally:
        server.close()
    res["counts"] = read_counts()  # the main path ends here
    res["builds"], res["loads"] = _build.builds, _build.loads
    recs = server.telemetry.ring.records
    res["warmup"] = [r for r in recs if r["type"] == "warmup"]
    res["warns"] = [r for r in recs if r["type"] == "warn"]
    serves = [r for r in recs if r["type"] == "serve"]
    res["serve_drift"] = [sorted(r["drift"]) for r in serves if r.get("drift")]
    res["serve_drift_first"] = next((r["drift"] for r in serves if r.get("drift")), None)
    res["serve_cost"] = [{k: r.get(k) for k in ("records", "model_flops", "flops_per_record",
                                                "achieved_flops_s", "mfu", "trace_id")}
                         for r in serves]
    res["scrapes"] = scrapes
    res["row_hashes"] = [_row_hash(r) for r in rows]
    res["row_shape"] = list(rows[0].shape)
    res["rows_finite"] = all(bool(torch.isfinite(r).all()) for r in rows)
    if mode == "cold":  # the warm boot's rows are held to the cold boot's bits
        with torch.inference_mode():
            ref = model.forward(records[0][None])[0].float().cpu()
        res["row0_vs_direct"] = float((rows[0].float() - ref).abs().max())
    with open(out, "w") as f:
        json.dump(res, f, default=str)


def _child_start(call: str, cache_dir: str):
    """Start ``chip_smoke.<call>`` in a fresh process whose compile cache is
    ``cache_dir`` (its stderr to a file beside the cache)."""
    os.makedirs(cache_dir, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "BIGDL_COMPILE_CACHE_DIR": cache_dir}
    err = open(cache_dir + ".err", "w")
    proc = subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
                            cwd=str(ROOT), stdout=subprocess.DEVNULL, stderr=err, env=env)
    return proc, time.perf_counter(), err, call


def _child_join(child, timeout: int = 600) -> float:
    """Wait for a started child; its wall seconds, or raises with the end
    of its stderr when it fails or outlives ``timeout``."""
    proc, t0, err, call = child
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    err.close()
    if proc.returncode != 0:
        with open(err.name) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"[25] the child {call.split('(')[0]} failed "
                             f"({proc.returncode}):\n{tail}")
    return time.perf_counter() - t0


def _child(call: str, cache_dir: str, timeout: int = 600) -> float:
    return _child_join(_child_start(call, cache_dir), timeout)


def phase_surface_boots(card, root):
    """[25a] the cold boot and its export, [25b] the warm boot: returns the
    two processes' launches and the bundle's path."""
    import statistics

    bundle = os.path.join(root, "bundle")
    res = {}
    for mode in ("cold", "warm"):
        out = os.path.join(root, f"{mode}.json")
        wall = _child(f"_surface_child({mode!r}, {bundle!r}, {out!r}, {SURF_LM!r}, "
                      f"{SURF_DEVICE!r})", os.path.join(root, f"cache_{mode}"))
        with open(out) as f:
            res[mode] = json.load(f)
        res[mode]["wall_s"] = wall
    cold, warm = res["cold"], res["warm"]
    layers = SURF_LM["layers"]
    for tag, r in (("[25a]", cold), ("[25b]", warm)):
        w = r["warmup"][0]
        log(f"{tag} {r['mode']} boot in a fresh process ({r['wall_s']:.1f} s): ready in "
            f"{r['ready_s']:.2f} s, warmup_s {w['seconds']:.3f}, fresh_compiles "
            f"{w['fresh_compiles']}, compiles {w['compiles']}, warm_start {w['warm_start']}, "
            f"bundle {w.get('bundle')}; nvcc builds {r['builds']}, library loads {r['loads']}; "
            f"{SURF_REQUESTS} requests in {r['serve_s']:.3f} s over {r['flushes']} flushes; "
            f"launches {r['counts']}; card {card}")
        expect = layers * (len(r["warmup"]) + r["flushes"])
        if SURF_DEVICE != "cuda":  # the launch and build checks are the card's
            continue
        if r["counts"]["flash_attention_fwd"] != expect:
            raise AssertionError(f"{tag} flash forward launched "
                                 f"{r['counts']['flash_attention_fwd']} times, expected {expect}")
        if r["counts"]["probe_add_one"] != 1:
            raise AssertionError(f"{tag} the library's probe ran {r['counts']['probe_add_one']} "
                                 "times, expected 1 (its load)")
        if not r["rows_finite"] or r["row_shape"] != [SURF_LM["seq"], SURF_LM["vocab"]]:
            raise AssertionError(f"{tag} rows of shape {r['row_shape']} or not finite")
        if r.get("row0_vs_direct", 0.0) > SURF_TOL:
            raise AssertionError(f"{tag} served row 0 is {r['row0_vs_direct']} from a direct "
                                 f"forward (limit {SURF_TOL})")
    if SURF_DEVICE == "cuda" and (cold["warmup"][0]["fresh_compiles"] != 1
                                  or cold["builds"] != 1):
        raise AssertionError(f"[25a] expected 1 build, got {cold['builds']} "
                             f"(fresh_compiles {cold['warmup'][0]['fresh_compiles']})")
    codes = {}
    for path, code, ms, nbytes in cold["scrapes"]:
        codes.setdefault(path, []).append((code, ms))
    for path in ("/healthz", "/metrics"):
        got = codes.get(path, [])
        if not got or any(c != 200 for c, _ in got):
            raise AssertionError(f"[25a] {path} scraped {got}")
        log(f"    {path}: {len(got)} scrapes while serving, all 200, median "
            f"{statistics.median(ms for _, ms in got):.2f} ms, max {max(ms for _, ms in got):.2f} ms")
    total = sum(cold["files"].values())
    log(f"    bundle: {len(cold['files'])} files, {total} bytes ({cold['cache_entries']} cache "
        f"files), exported in {cold['export_s']:.3f} s: {cold['files']}")
    first = cold["serve_drift_first"]
    layer0 = sorted(first)[0]
    log(f"    serve records: {len(cold['serve_cost'])}, drift on {len(cold['serve_drift'])} "
        f"(every flush), {len(first)} layers; {layer0}: {first[layer0]}; costs of the last: "
        f"{cold['serve_cost'][-1]}")
    if len(cold["serve_drift"]) != cold["flushes"] or cold["serve_cost"][-1]["model_flops"] is None:
        raise AssertionError("[25a] a serve record lacks its drift or cost fields")
    w = warm["warmup"][0]
    if warm["builds"] != 0 or w["fresh_compiles"] != 0 or w.get("bundle") != bundle \
            or warm["aot_modules"] != 1 or warm["warns"]:
        raise AssertionError(f"[25b] not a warm boot: builds {warm['builds']}, warmup {w}, "
                             f"aot_modules {warm['aot_modules']}, warns {warm['warns']}")
    equal = warm["row_hashes"] == cold["row_hashes"]
    log(f"[25b] rows bit-equal to [25a]'s: {equal} ({sum(a == b for a, b in zip(warm['row_hashes'], cold['row_hashes']))}"
        f"/{SURF_REQUESTS}); warmup_s cold {cold['warmup'][0]['seconds']:.3f} / warm "
        f"{w['seconds']:.3f}, ready cold {cold['ready_s']:.2f} s / warm {warm['ready_s']:.2f} s "
        f"(warm_start {warm['warm_start_s']:.3f} s); card {card}")
    if not equal:
        raise AssertionError("[25b] the warm boot's rows are not [25a]'s")
    return {"surface_cold": cold["counts"], "surface_warm": warm["counts"]}, bundle


def phase_surface_rejections(card, root, bundle, model):
    """[25c] five bundles that fail a check: each registration boots cold,
    serves and leaves one ``artifact_incompatible`` warn."""
    import shutil

    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.serving import ModelServer

    records = _surface_records(2, seed=SEED + 1)

    def edit_manifest(b, fn):
        path = os.path.join(b, "manifest.json")
        with open(path) as f:
            man = json.load(f)
        fn(man)
        with open(path, "w") as f:
            json.dump(man, f)

    def truncate_lib(b):
        lib = os.path.join(b, "cache", _build.LIB_NAME)
        if not os.path.exists(lib):  # a CPU rehearsal's bundle holds no library
            lib = os.path.join(b, "modules", sorted(os.listdir(os.path.join(b, "modules")))[0])
        with open(lib, "r+b") as f:
            f.truncate(os.path.getsize(lib) // 2)

    cases = [
        ("tampered hash", lambda b: edit_manifest(b, lambda m: m["files"][
            next(iter(sorted(m["files"])))].update(sha256="0" * 64)), {}, "checksum"),
        ("truncated library", truncate_lib, {}, "truncated"),
        ("another torch", lambda b: edit_manifest(b, lambda m: m["fingerprint"].update(
            torch="0.0.0-other")), {}, "'torch'"),
        ("batch-size drift", lambda b: None, {"batch_size": SURF_BATCH // 2}, "geometry drift"),
        ("architecture drift", lambda b: None, {"model": "filt"}, "signature mismatch"),
    ]
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    try:
        for i, (label, corrupt, kw, detail) in enumerate(cases):
            b = os.path.join(root, f"reject{i}")
            shutil.copytree(bundle, b)
            corrupt(b)
            cache = os.path.join(root, f"cache_reject{i}")
            Engine.set_compilation_cache_dir(cache)
            m = _surface_lm(filt=SURF_LM["filt"] // 2) if kw.pop("model", None) else model
            with ModelServer() as server:
                server.register("lm", m, sample_input=records[0], max_delay_ms=5, drift=True,
                                drift_every=1, artifacts=b,
                                batch_size=kw.get("batch_size", SURF_BATCH))
                rows = server.predict("lm", records, timeout=300)
                info = server.models()["lm"]
                warns = [r for r in server.telemetry.ring.records if r["type"] == "warn"]
            seeded = sorted(os.listdir(cache))
            ok = (len(warns) == 1 and warns[0]["reason"] == "artifact_incompatible"
                  and detail in warns[0]["detail"] and info["aot_modules"] == 0
                  and rows.shape[0] == 2 and bool(torch_isfinite(rows))
                  and seeded in ([], sorted([_build.LIB_NAME, _build.STAMP_NAME])))
            log(f"[25c] {label}: served {rows.shape[0]} rows cold, warn {warns[0]['detail'] if warns else None!r}, "
                f"cache directory {seeded}")
            if not ok:
                raise AssertionError(f"[25c] {label}: warns {warns}, info {info}, seeded {seeded}")
            if m is not model:
                del m
    finally:
        Engine.set_compilation_cache_dir(None)
    counts = read_counts()  # the main path ends here
    log(f"    five rejections in {time.perf_counter() - t0:.1f} s, launches {counts}; no nvcc "
        f"build ({_build.builds} in this process, all in [2]); card {card}")
    return counts


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def _profiled(fn):
    """``fn()`` under a torch.profiler of every thread, CUDA sync events
    on; returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        from torch._C._profiler import _ExperimentalConfig

        cfg = _ExperimentalConfig(profile_all_threads=True, enable_cuda_sync_events=True)
    except (ImportError, TypeError):
        cfg = None
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts, experimental_config=cfg)
    prof.start()
    try:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.stop()
    return prof


def phase_surface_drift(card, root, model):
    """[25d] a stable stream then a shifted one: the drift warn, and the
    copies and synchronisations a flush with drift off and on."""
    import numpy as np
    from bigdl_tpu_torch.serving import ModelServer

    stable = _surface_records(12 * SURF_BATCH, seed=SEED + 2)
    shifted = np.full((2 * SURF_BATCH, SURF_LM["seq"]), 7, np.int64)  # one token, repeated
    window = 4  # flushes profiled
    n_stable = len(stable) // SURF_BATCH
    out = {}
    reset_counts()  # the main path starts here
    for drift in (False, True):
        with ModelServer() as server:
            # max_delay_ms past any submit: each predict of 8 records is one flush
            server.register("lm", model, sample_input=stable[0], max_delay_ms=60_000,
                            batch_size=SURF_BATCH, drift=drift, drift_every=SURF_DRIFT_EVERY)
            batches = [stable[i:i + SURF_BATCH] for i in range(0, len(stable), SURF_BATCH)]

            def flush(b):
                # one flush, waited for to its serve record: the drift sample
                # comes after the results, before the record
                n = len([r for r in server.telemetry.ring.records if r["type"] == "serve"])
                server.predict("lm", b, timeout=300)
                end = time.perf_counter() + 60
                while len([r for r in server.telemetry.ring.records
                           if r["type"] == "serve"]) <= n and time.perf_counter() < end:
                    time.sleep(0.001)

            for b in batches[:2]:
                flush(b)
            f0 = server.models()["lm"]["flushes"]
            prof = _profiled(lambda: [flush(b) for b in batches[2:2 + window]])
            flushed = server.models()["lm"]["flushes"] - f0
            if drift:  # the rest of the baseline, then the shift
                for b in batches[2 + window:]:
                    flush(b)
                for i in range(0, len(shifted), SURF_BATCH):
                    flush(shifted[i:i + SURF_BATCH])
        recs = server.telemetry.ring.records  # after close(): the last sample is in
        d2h, syncs = _sync_counts(prof, flushed)
        out[drift] = (d2h, syncs, flushed)
        del prof
        if drift:
            warns, sampled, n_serves = [], [], 0
            for r in recs:  # each warn with the number of flushes before it
                n_serves += r["type"] == "serve"
                if r["type"] == "serve" and r.get("drift"):
                    sampled.append(r)
                if r["type"] == "warn" and r["reason"] == "activation_drift":
                    warns.append((n_serves, r))
    counts = read_counts()  # the main path ends here
    off, on = out[False], out[True]
    added = (on[0] - off[0]) * SURF_DRIFT_EVERY
    log(f"[25d] a flush of {SURF_BATCH} (over {off[2]} / {on[2]} profiled flushes): drift off "
        f"{off[0]:g} device-to-host copies, {off[1]:g} synchronisations; drift on "
        f"(drift_every {SURF_DRIFT_EVERY}) {on[0]:g} copies, {on[1]:g} synchronisations: "
        f"{added:g} added copy every {SURF_DRIFT_EVERY} flushes; {len(sampled)} sampled flushes; "
        f"warns (flush, layer, z) {[(n, w['layer'], w['z']) for n, w in warns]} with the shift "
        f"at flush {n_stable + 1}; launches {counts}; card {card}")
    shifted_warns = [w for n, w in warns if n >= n_stable]
    if not shifted_warns or not shifted_warns[0].get("layer"):
        raise AssertionError("[25d] no activation_drift warn naming a layer on the shifted "
                             "stream")
    if SURF_DEVICE == "cuda" and (abs(added - 1.0) > 1e-9 or off[2] != window
                                  or on[2] != window):
        raise AssertionError(f"[25d] drift sampling added {added} copies every "
                             f"{SURF_DRIFT_EVERY} flushes, expected 1: {out}")
    return counts


def phase_prediction_service(card, model):
    """[25e] PredictionService from 4 threads against Predictor."""
    import torch
    from bigdl_tpu_torch.optim import PredictionService, Predictor

    records = _surface_records(8, seed=SEED + 3)
    svc = PredictionService(model)
    got = [None] * 4
    reset_counts()  # the main path starts here

    def client(i):
        got[i] = svc.predict(records[2 * i:2 * i + 2])

    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(600)
    wall = time.perf_counter() - t0
    counts = read_counts()  # the main path ends here
    ref = Predictor(model)
    equal = all(torch.equal(got[i], ref.predict(records[2 * i:2 * i + 2])) for i in range(4))
    log(f"[25e] PredictionService: 4 threads x 2 records in {wall:.3f} s (batch "
        f"{ref.batch_size} each), rows bit-equal to Predictor's: {equal}; launches {counts}; "
        f"card {card}")
    if not equal or (SURF_DEVICE == "cuda"
                     and counts["flash_attention_fwd"] != 4 * SURF_LM["layers"]):
        raise AssertionError(f"[25e] rows differ or launches {counts}")
    return counts


def _step_resume_child(bundle: str, ckpt: str, out: str, lm: dict, device: str) -> None:
    """[25f]'s fresh process: ``warm_start``, ``resume``, the rest of the
    run; the parameters to ``out`` and the readings beside them."""
    import torch
    from bigdl_tpu_torch.ops import _build

    global OBS_DEVICE, OBS_LM
    OBS_DEVICE, OBS_LM = device, lm
    ids, targets = _obs_data(OBS_RECORDS)
    reset_counts()  # the main path starts here
    opt = _obs_opt(ids, targets, 4)
    manifest = opt.warm_start(bundle)
    opt.resume(ckpt)
    opt.optimize()
    torch.save(_obs_params(opt.model).cpu(), out)
    with open(out + ".json", "w") as f:
        json.dump({"counts": read_counts(), "builds": _build.builds, "loads": _build.loads,
                   "step": manifest["step"], "steps": opt.n_steps}, f, default=str)


def phase_step_bundle_start(card, root, bundle):
    """[25f] 2 LM steps, their checkpoint and step bundle, and the fresh
    process that resumes from them (started here, joined by
    :func:`phase_step_bundle_finish` while [25c]-[25g] run)."""
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.utils import aot

    ids, targets = _obs_data(OBS_RECORDS)
    ref = _obs_opt(ids, targets, 4)
    ref.optimize()
    p_ref = _obs_params(ref.model).cpu()
    del ref
    _free()
    ckpt = os.path.join(root, "step_ckpt")
    step_bundle = os.path.join(root, "step_bundle")
    # this process's cache directory holds the library [25a] built: the
    # bundle's export harvests it from there
    Engine.set_compilation_cache_dir(os.path.join(root, "cache_step_export"))
    try:
        aot.seed_from_bundle(bundle)
        reset_counts()  # the main path starts here
        opt = _obs_opt(ids, targets, 2)
        opt.set_checkpoint(ckpt, Trigger.several_iteration(2), keep_last=1)
        opt.optimize()
        manifest = opt.export_step_artifact(step_bundle)
        counts = read_counts()  # the main path ends here
    finally:
        Engine.set_compilation_cache_dir(None)
    del opt
    _free()
    out = os.path.join(root, "step_params.pt")
    child = _child_start(f"_step_resume_child({step_bundle!r}, {ckpt!r}, {out!r}, {OBS_LM!r}, "
                         f"{OBS_DEVICE!r})", os.path.join(root, "cache_step_resume"))
    return child, out, p_ref, manifest, counts


def phase_step_bundle_finish(card, started):
    """[25f] the resumed process: 0 builds, bit-equal to 4 uninterrupted
    steps."""
    import torch

    child, out, p_ref, manifest, counts = started
    wall = _child_join(child)
    with open(out + ".json") as f:
        child = json.load(f)
    equal = torch.equal(torch.load(out), p_ref)
    step = manifest["step"]
    log(f"[25f] step bundle: {manifest['cache_entries']} cache files, module {step['module']}, "
        f"{len(step['arg_specs'])} argument specs, export_error {step['export_error']!r}; the "
        f"fresh process warm-started, resumed and ran {child['steps']} steps ({wall:.1f} s, "
        f"beside [25c]-[25g]) "
        f"with {child['builds']} nvcc builds and {child['loads']} library load: bit-equal to the "
        f"uninterrupted run: {equal}; launches {child['counts']}; card {card}")
    card_checks = OBS_DEVICE == "cuda"  # no library is built or loaded on the CPU
    if child["builds"] != 0 or not equal or (card_checks and (
            child["loads"] != 1 or manifest["cache_entries"] != 2)):
        raise AssertionError(f"[25f] resume not warm or not equal: {child}, equal {equal}")
    return counts, child["counts"]


def phase_server_postmortem(card, root, model):
    """[25g] an exception escaping ``with ModelServer()``: a verified
    postmortem bundle naming the class."""
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.obs import blackbox
    from bigdl_tpu_torch.serving import ModelServer

    class ServingFault(RuntimeError):
        pass

    run_dir = os.path.join(root, "run_g")
    Engine.set_run_dir(run_dir)
    reset_counts()  # the main path starts here
    try:
        with ModelServer() as server:
            server.register("lm", model, sample_input=_surface_records(1)[0],
                            batch_size=SURF_BATCH, max_delay_ms=5)
            raise ServingFault("planted")
    except ServingFault:
        pass
    finally:
        Engine.set_run_dir(None)
    counts = read_counts()  # the main path ends here
    pm = os.path.join(run_dir, "postmortem")
    bundles = sorted(d for d in os.listdir(pm) if d != "hard_crash")
    manifest = blackbox.verify_bundle(os.path.join(pm, bundles[0]))
    with open(os.path.join(pm, bundles[0], "reason.json")) as f:
        reason = json.load(f)
    log(f"[25g] postmortem {bundles}: verified ({len(manifest['files'])} files), reason "
        f"{reason['reason']!r}, error {reason['error']['class']}; launches {counts}")
    if len(bundles) != 1 or reason["error"]["class"] != "ServingFault" \
            or "ServingFault" not in reason["reason"]:
        raise AssertionError(f"[25g] postmortem {bundles}: {reason.get('reason')}")
    return counts


def phase_slice26(card):
    """[25] serving's remaining surface; returns the main paths' launches."""
    import tempfile

    import torch

    from bigdl_tpu_torch import Engine

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    # the settings a fresh process starts with: the bundles' fingerprints
    # of the children and of this process must agree
    Engine.set_fused_kernels(None)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(None)
    os.makedirs(ROOT / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_surface_", dir=str(ROOT / "build")) as root:
        by_path, bundle = phase_surface_boots(card, root)
        _free()
        # [25f]'s fresh process resumes beside [25c]-[25g] (its readings are
        # counts and bits; those phases' are counts, bits and records)
        step = phase_step_bundle_start(card, root, bundle)
        _free()
        model = _surface_lm()
        by_path["surface_rejections"] = phase_surface_rejections(card, root, bundle, model)
        _free()
        by_path["surface_drift"] = phase_surface_drift(card, root, model)
        _free()
        by_path["prediction_service"] = phase_prediction_service(card, model)
        _free()
        by_path["server_postmortem"] = phase_server_postmortem(card, root, model)
        del model
        _free()
        by_path["step_export"], by_path["step_resume"] = phase_step_bundle_finish(card, step)
        _free()
    log(f"[25] done in {time.perf_counter() - t0:.1f} s")
    return by_path


# ----------------------------------------------------------------------------- [26]
# the elastic fleet (resilience/elastic.py, obs/fleet.py's FleetMonitor) on
# ZeRO-1: [26a] the LM of [5]/[6] through DistriOptimizer(parameter_sync=
# "sharded") with set_elastic and set_health on 4 spawned ranks sharing the
# card over gloo, the JAX package's chaos schedule (a fake clock a second an
# end_when call; rank 0 holds a thread-free SimulatedFleet whose peers beat
# for the other ranks' hosts): host 3's heartbeats stop after step 2 and
# come back after step 5, the ranks shrink to 3 at a step boundary behind a
# generation-1 fleet checkpoint, rejoin at the next epoch boundary behind a
# generation-2 one, and end whole after epoch 3; then a clean 4-rank run of
# the same 3 epochs (a checkpoint at the shrink's step). [26b] rides
# [23a]'s and [23d]'s spawns (``_observed``, ``MESH_HEALTH_TOL``).
# Rehearse [26a] on the CPU by importing chip_smoke from a guarded script,
# setting ELASTIC_DEVICE = "cpu", cutting ELASTIC_LM (V 64, H 32, 4 heads,
# filter 64, 2 layers, T 16) and calling phase_elastic("cpu") (the launch
# checks are the card's).
ELASTIC_DEVICE = "cuda"
ELASTIC_LM = dict(LM_WIDTH, records=48, batch=12, epochs=3, world=4, kill=(3,), kill_at=3,
                  revive_at=6, stale_after_s=1.5)
# [26a] the elastic run's health (global gradient norm) against the clean
#   run's at each step both recorded, largest relative difference. Before
#   the shrink the two runs are one computation (expected 0); after it the
#   3-rank group sums the same 12 rows in another order (bf16 operands:
#   another row count per rank may take other cuBLAS kernels). The planted
#   reading is what doubling one leaf's gradient does to the clean run's
#   norm, from its own per-layer rows, taken at the record's largest leaf
#   (of ~75 leaves the largest holds at least 1/sqrt(75) of the norm, so
#   the planted reading is at least 0.02). An H100 (80GB HBM3, 700 W) read
#   6.74e-4 sound and 0.186 planted (the embedding's leaf alone: 2.59e-3,
#   too small a share at this width); the limit sits between
ELASTIC_NORM_REL = 5e-3


def _elastic_lm(dev):
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.nn import Transformer

    c = ELASTIC_LM
    RandomGenerator.set_seed(SEED)
    return Transformer(c["vocab"], c["hidden"], c["heads"], c["filt"], c["layers"], 0.0, 0.0,
                       0.0, mode="lm", device=dev)


def _elastic_fit(rank, world, folder, elastic: bool, ckpt_at=None):
    """One run of [26a] on this rank (elastic, or clean with a checkpoint at
    step ``ckpt_at``); its readings."""
    import numpy as np

    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.obs import HealthConfig, Telemetry
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer, _comm
    from bigdl_tpu_torch.resilience import ElasticConfig, ElasticCoordinator, SimulatedFleet

    c, dev = ELASTIC_LM, ELASTIC_DEVICE
    name = "elastic" if elastic else "clean"
    gen = np.random.default_rng(SEED + 5)
    x = gen.integers(0, c["vocab"], (c["records"], c["seq"]))
    y = gen.integers(0, c["vocab"], (c["records"], c["seq"]))
    model = _elastic_lm(dev)
    model.init(sample_input=x[:c["batch"] // world])
    opt = DistriOptimizer(model, DataSet.distributed(DataSet.array(x, y, batch_size=c["batch"]),
                                                     world),
                          CrossEntropyCriterion(), parameter_sync="sharded")
    opt.set_optim_method(SGD(learningrate=0.1))
    ckpt = os.path.join(folder, name, "ckpt")
    opt.set_checkpoint(ckpt, (lambda st: st["neval"] == ckpt_at) if ckpt_at
                       else Trigger.several_iteration(10 ** 6))
    run_dir = os.path.join(folder, name, "run")
    Engine.set_run_dir(run_dir)
    # rank 0 beats for itself (wall clock: fresh on the fake clock); the
    # SimulatedFleet's peers beat for the other ranks' hosts
    tel = Telemetry(heartbeat_interval_s=0.0 if elastic and rank == 0 else None)
    opt.set_telemetry(tel).set_health(HealthConfig(every_n_steps=1))
    clk = {"t": 1000.0}
    fleet = coord = None
    if elastic:
        coord = ElasticCoordinator(ElasticConfig(
            stale_after_s=c["stale_after_s"], poll_interval_s=0.0, min_fleet_steps=0,
            wall_clock=lambda: clk["t"]))
        opt.set_elastic(coord)
        if rank == 0:
            fleet = SimulatedFleet(run_dir, world, threads=False, clock=lambda: clk["t"])

    def end_when(state):
        step = int(state.get("neval", 0))
        clk["t"] += 1.0
        if fleet is not None:
            fleet.beat_all(step)
            for k in c["kill"]:
                if step == c["kill_at"]:
                    fleet.kill(k)
                if step == c["revive_at"]:
                    fleet.revive(k)
        return int(state.get("epoch", 1)) > c["epochs"]

    opt.set_end_when(end_when)
    step, dispatched = opt._train_step, [0]

    def counted(*a, **k):
        dispatched[0] += 1
        return step(*a, **k)

    opt._train_step = counted
    _comm.reset_counts()
    reset_counts()  # the main path starts here
    t0 = time.perf_counter()
    if fleet is not None:
        with fleet:
            opt.optimize()
    else:
        opt.optimize()
    _sync()
    out = {"counts": read_counts(), "wall_s": time.perf_counter() - t0}  # the path ends here
    tel.close()
    Engine.set_run_dir(None)
    recs = list(tel.ring.records)
    out.update(dispatched=dispatched[0], losses=[h["loss"] for h in opt.history],
               nevals=[h["neval"] for h in opt.history],
               warns=[r for r in recs if r["type"] == "warn"],
               health=[r for r in recs if r["type"] == "health"],
               step_ms=[h["wall_s"] * 1e3 for h in opt.history],
               snapshot=coord.snapshot() if coord is not None else None,
               step_cache=[list(k) for k in opt._distri_step_cache],
               params=_flat_params(model))
    del opt, model
    _free()
    return out


def _elastic_rank(rank, world, folder, settings):
    """A spawned rank of [26a]: the elastic run, then the clean one; rank 0
    also reads the checkpoints. Saves ``rank<r>.pt``."""
    import torch

    global ELASTIC_DEVICE
    ELASTIC_DEVICE = settings["device"]
    ELASTIC_LM.update(settings["lm"])
    sys.path.insert(0, str(ROOT))
    from bigdl_tpu_torch import Engine

    Engine.init_distributed(f"file://{folder}/group", world, rank,
                            device=None if ELASTIC_DEVICE == "cuda" else "cpu")
    if ELASTIC_DEVICE == "cuda":  # the library's load launches the probe once: before any path
        from bigdl_tpu_torch.ops import _build

        _build.load()
    res = {"backend": Engine.backend(), "device": str(Engine.rank_device())}
    try:
        res["elastic"] = _elastic_fit(rank, world, folder, elastic=True)
        from bigdl_tpu_torch.utils import serialization as ser

        ckpt = os.path.join(folder, "elastic", "ckpt")
        manifests = {s: ser.checkpoint_manifest(ckpt, s) for s in ser._checkpoint_steps(ckpt)}
        res["manifests"] = {s: {"generation": m["generation"], "shards": sorted(m["shards"]),
                                "process_count": m["process_count"], "mesh": m["mesh"]}
                            for s, m in manifests.items()}
        shrink = min(s for s, m in manifests.items() if m["generation"] == 1)
        res["clean"] = _elastic_fit(rank, world, folder, elastic=False, ckpt_at=shrink)
        if rank == 0:  # the emergency checkpoint against the clean run's, leaf by leaf
            import numpy as np

            like_model = _elastic_lm(ELASTIC_DEVICE)
            like_model.init(sample_input=np.zeros((1, ELASTIC_LM["seq"]), np.int64))
            like = like_model.get_parameters()
            pe, _, he, _ = ser.load_checkpoint(ckpt, shrink, params_like=like)
            pc, _, hc, _ = ser.load_checkpoint(os.path.join(folder, "clean", "ckpt"), shrink)
            res["ckpt_step"] = (shrink, he["neval"], hc["neval"])
            res["ckpt_equal"] = sorted(pe) == sorted(pc) and all(
                pe[k].dtype == pc[k].dtype and (pe[k] == pc[k]).all() for k in pe)
            res["ckpt_leaves"] = len(pe)
    finally:
        Engine.shutdown_distributed()
    torch.save(res, os.path.join(folder, f"rank{rank}.pt"))


def _spawn_elastic():
    """[26a]'s ranks under ``RANK_DEADLINE_S`` (a rank that fails or hangs
    fails the run); each rank's results."""
    import tempfile

    import torch
    from bigdl_tpu_torch.examples._common import spawn

    os.makedirs(ROOT / "build", exist_ok=True)
    world = ELASTIC_LM["world"]
    with tempfile.TemporaryDirectory(prefix="smoke_elastic_", dir=str(ROOT / "build")) as folder:
        settings = {"device": ELASTIC_DEVICE, "lm": ELASTIC_LM}
        spawn(_elastic_rank, (folder, settings), world, RANK_DEADLINE_S, stderr_dir=folder)
        return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


class _Background:
    """``fn()`` on a daemon thread (its spawned ranks beside another phase);
    :meth:`result` joins it and raises what it raised; ``wall_s`` is its
    time."""

    def __init__(self, fn):
        self._out = {}
        self.wall_s = None
        t0 = time.perf_counter()

        def run():
            try:
                self._out["value"] = fn()
                self.wall_s = time.perf_counter() - t0
            except BaseException as e:  # raised again on the caller's thread
                self._out["error"] = e

        self._thread = threading.Thread(target=run, name="smoke-background", daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def _planted_norm(health_rec):
    """``(leaf, norm)``: the record's largest leaf and the global gradient
    norm with that leaf's gradient doubled, from the record's own
    per-layer rows: sqrt(g^2 + 3 g_leaf^2)."""
    g = health_rec["global"]["grad_norm"]
    leaf, row = max(health_rec["layers"].items(), key=lambda kv: kv[1]["grad_norm"])
    return leaf, (g * g + 3 * row["grad_norm"] ** 2) ** 0.5


def phase_elastic(card, ranks=None):
    """[26a]'s checks over the ranks' results (spawned here unless given);
    returns the path's launches (summed over the ranks)."""
    import math

    import torch

    c = ELASTIC_LM
    if ranks is None:
        ranks = _spawn_elastic()
    _check_backend("[26a] ZeRO-1 elastic:", ranks)
    world = c["world"]
    e0, c0 = ranks[0]["elastic"], ranks[0]["clean"]
    shrunk = [w for w in e0["warns"] if w["reason"] == "mesh_shrunk"]
    rejoin = [w for w in e0["warns"] if w["reason"] == "mesh_rejoin"]
    lost = [w for w in e0["warns"] if w["reason"] == "host_lost"]
    log(f"[26a] ZeRO-1 elastic: the LM (V {c['vocab']}, H {c['hidden']}, {c['layers']} layers, T "
        f"{c['seq']}, batch {c['batch']} of {c['records']} records, bf16, SGD 0.1, health) on "
        f"{world} ranks, host {list(c['kill'])} silent after step {c['kill_at'] - 1} and back "
        f"after step {c['revive_at'] - 1}: {e0['wall_s']:.1f} s elastic, {c0['wall_s']:.1f} s "
        f"clean; dispatches a rank {[r['elastic']['dispatched'] for r in ranks]}; step ms (rank "
        f"0) " + ", ".join(f"{v:.0f}" for v in e0["step_ms"]) + f"; card {card}")
    if len(shrunk) != 1 or len(rejoin) != 1 or len(lost) != 1:
        raise AssertionError(f"[26a] rank 0's warns {[w['reason'] for w in e0['warns']]}")
    s, j = shrunk[0], rejoin[0]
    fields = ("iteration", "members", "processes", "process_count", "generation",
              "restored_step", "reshard_s", "reader_slices")  # the JAX package's
    for w in (s, j):
        if w.get("path") != "elastic" or any(k not in w for k in fields):
            raise AssertionError(f"[26a] a remesh record without the JAX fields: {w}")
        log(f"    {w['reason']}: " + ", ".join(f"{k} {w[k]}" for k in fields))
    if not (s["members"] == list(c["kill"]) and s["processes"] == [0, 1, 2]
            and s["generation"] == 1 and s["restored_step"] == s["iteration"]
            and j["members"] == list(c["kill"]) and j["processes"] == [0, 1, 2, 3]
            and j["generation"] == 2 and j["restored_step"] == j["iteration"]
            and j["iteration"] > s["iteration"]):
        raise AssertionError(f"[26a] the remesh records {s} / {j}")
    for r, res in enumerate(ranks):
        e = res["elastic"]
        reasons = [w["reason"] for w in e["warns"] if w["reason"].startswith("mesh_")]
        if reasons != (["mesh_rejoin"] if r in c["kill"] else ["mesh_shrunk", "mesh_rejoin"]):
            raise AssertionError(f"[26a] rank {r}'s remesh records {reasons}")
        if e["snapshot"]["active"] != list(range(world)) or e["snapshot"]["generation"] != 2:
            raise AssertionError(f"[26a] rank {r} ended at {e['snapshot']}")
        want_cache = [[0, 1, 2, 3]] if r in c["kill"] else [[0, 1, 2, 3], [0, 1, 2]]
        if e["step_cache"] != want_cache:
            raise AssertionError(f"[26a] rank {r}'s layouts {e['step_cache']}")
    man = ranks[0]["manifests"]
    ms, mj = man[s["iteration"]], man[j["iteration"]]
    log(f"    manifests: step {s['iteration']} generation {ms['generation']}, shards "
        f"{ms['shards']}, mesh {ms['mesh']}; step {j['iteration']} generation "
        f"{mj['generation']}, shards {mj['shards']}, mesh {mj['mesh']}")
    if not (ms["generation"] == 1 and ms["shards"] == ["0", "1", "2", "3"]
            and mj["generation"] == 2 and mj["shards"] == ["0", "1", "2"]):
        raise AssertionError(f"[26a] manifests {man}")
    step, ne, nc = ranks[0]["ckpt_step"]
    log(f"    the emergency checkpoint at step {step} ({ranks[0]['ckpt_leaves']} leaves, fleet "
        f"shards) against the clean run's at step {nc}: bit-equal {ranks[0]['ckpt_equal']}")
    if not (ranks[0]["ckpt_equal"] and ne == nc == step):
        raise AssertionError("[26a] the emergency checkpoint differs from the clean run's")
    # every rank's health finite; rank 0's norms against the clean run's
    for r, res in enumerate(ranks):
        for h in res["elastic"]["health"]:
            g = h["global"]
            if not math.isfinite(g["grad_norm"]) or g["nonfinite_grads"] or g["nonfinite_params"]:
                raise AssertionError(f"[26a] rank {r}: health {g}")
    clean = {h["iteration"]: h for h in c0["health"]}
    common = [h for h in e0["health"] if h["iteration"] in clean]
    dist = max(abs(h["global"]["grad_norm"] - clean[h["iteration"]]["global"]["grad_norm"])
               / clean[h["iteration"]]["global"]["grad_norm"] for h in common)
    plants = [_planted_norm(clean[h["iteration"]]) for h in common]
    planted = min(abs(n - clean[h["iteration"]]["global"]["grad_norm"])
                  / clean[h["iteration"]]["global"]["grad_norm"]
                  for (_, n), h in zip(plants, common))
    log(f"    health at {len(common)} common steps: grad norm vs the clean run {dist:.2e} "
        f"(limit {ELASTIC_NORM_REL}; planted, the largest leaf's gradient doubled "
        f"({sorted({leaf for leaf, _ in plants})}), at least {planted:.2e}); losses "
        + ", ".join(f"{v:.4f}" for v in e0["losses"]))
    if dist > ELASTIC_NORM_REL or not planted > ELASTIC_NORM_REL:
        raise AssertionError("[26a] the elastic run's health disagrees with the clean run's")
    if not torch.equal(ranks[1]["elastic"]["params"], e0["params"]) or not all(
            torch.equal(r["elastic"]["params"], e0["params"]) for r in ranks):
        raise AssertionError("[26a] the ranks end with different parameters")
    # #1-#3: 6 each a dispatched step on every rank that stepped
    for r, res in enumerate(ranks):
        got = _nonzero(res["elastic"]["counts"])
        exp = {k: c["layers"] * res["elastic"]["dispatched"]
               for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")}
        if ELASTIC_DEVICE == "cuda" and got != exp:
            raise AssertionError(f"[26a] rank {r} launched {got}, expected {exp}")
    return _sum_rank_counts(ranks, "elastic")


def phase_slice27(card, elastic=None):
    """[26] the elastic fleet (``elastic``: a ``_Background`` of
    ``_spawn_elastic`` started beside an earlier phase, or None to spawn
    here); returns the main path's launches."""
    t0 = time.perf_counter()
    ranks = elastic.result() if elastic is not None else None
    by_path = {"elastic_zero1": phase_elastic(card, ranks)}
    spawned = (f"{elastic.wall_s:.1f} s for its ranks beside [23e], then "
               if elastic is not None else "")
    log(f"[26] done in {spawned}{time.perf_counter() - t0:.1f} s ([26b] inside [23a] and "
        "[23d])")
    return by_path


# ----------------------------------------------------------------------------- [27]
# [27] the configurations the port once refused: [27a] the
# Siamese ResNet-50 of [17a] with micro-batches on its Table of pairs; [27b]
# (inside [23d]'s spawn) the hybrid mesh with micro-batches and a plan over
# the data axis; [27c] the examples' --summary-dir and --model-save; [27d]
# the estimator API over LeNet-5.
SLICE28_MICRO = 2  # micro-batches of [27a] and [27b]
SLICE28_DEVICE = "cuda"  # [27c], [27d]; a CPU rehearsal sets "cpu" (and SIAMESE_DEVICE for [27a])
# [27a] one micro-batched step (set_micro_batches(2), 8 pairs, f32, TF32 off,
# deterministic cuDNN) against a hand-written accumulation on the card: two
# train-mode forward/backward passes of the shared model on the Table's two
# halves (BN state carried), the gradients summed and halved, the same SGD
# update. The step runs the same arithmetic on the same shapes in the same
# order (the shared tower's two sites summed by autograd within each half,
# as [17a]'s check reads equal to the bit), so the update and the BN state
# are expected equal to the bit; the limit is SIAMESE_PAIR_TOL (1e-6 of each
# leaf's update and state norm) and its reasoning. Planted: the halves'
# gradients summed and not halved (the update doubled, 1.0 relative).
SIAMESE_MICRO = {"iters": 6, "rounds": 2}  # 1 warm-up + 5 timed, micro and unsplit in turns
# [27b] 3 f32 SGD steps of data 2 x model 2 on the LM at [5]/[6]'s widths,
# each with set_micro_batches(2), against LocalOptimizer on one rank with
# the same micro-batches: (i) under megatron_transformer_plan(), planted on
# block 0's query weight (its gradient doubled, as [23d]); (ii) with the
# embedding's rows over "data" too, planted as the gradient's block of
# this rank's own rows without the sum over the data axis. Each limit sits
# between the sound and planted readings on an H100 (80GB HBM3, 700 W; 3
# spawns, the same to the last digit; sound / planted): (i) loss 1.005e-7
# (one float32 step of a loss near 9.5) / 6.03e-7, update 4.35e-5 /
# 1.11e-2, parameters 1.32e-6 / 1.21e-4 absolute; (ii) the sound readings
# equal to (i)'s, planted loss 6.03e-7, update 5.61e-2, parameters 4.75e-4.
SLICE28_TOL = {"micro": {"loss": 3e-7, "update": 2e-4, "params_abs": 5e-6},
               "data": {"loss": 3e-7, "update": 2e-4, "params_abs": 5e-6}}
SLICE28_LENET = {"records": 2048, "batch": 128}  # [27c] lenet_train, 1 epoch: 16 steps
SLICE28_ALEXNET = {"records": 256, "batch": 64, "check": 4}  # 3 steps, a 64-image validation
# [27d] 4 epochs of SGD 0.1 momentum 0.9: 64 steps; its score on held-out
# digits must pass 0.5 (chance 0.1; 0.94 in f32 on the CPU)
SLICE28_ESTIMATOR = {"records": 2048, "test": 512, "batch": 128, "epochs": 4, "lr": 0.1,
                     "min_score": 0.5}


def _no_data_sum(leaf: str):
    """[27b]'s planted fault: HybridParallelOptimizer with the data-sharded
    ``leaf`` 's gradient taken as this rank's block of its own rows'
    gradient, without the sum over the data axis."""
    from bigdl_tpu_torch.parallel import HybridParallelOptimizer
    from bigdl_tpu_torch.parallel.sharding import shard_leaf
    from bigdl_tpu_torch.utils.serialization import tree_items, unflatten_to_like

    class NoDataSum(HybridParallelOptimizer):
        def _average_grads(self, grads):
            own = shard_leaf(tree_items(grads)[leaf], self._specs[leaf], self._run_mesh)
            out = tree_items(super()._average_grads(grads))
            out[leaf] = own
            return unflatten_to_like(out, grads)

    return NoDataSum


def _slice28_plan(data_rows: bool):
    from bigdl_tpu_torch.parallel import P, ShardingPlan, megatron_transformer_rules

    extra = [(r"^embedding$", P("data", None))] if data_rows else []
    return ShardingPlan(extra + megatron_transformer_rules())


def _slice28_hybrid_runs(mesh, x, y, out) -> None:
    """[27b] on this rank (f32, inside [23d]'s spawn): (i) and (ii), sound
    and planted, 3 steps each with SLICE28_MICRO micro-batches from
    [23d]'s check weights; the sound runs' launches counted."""
    from bigdl_tpu_torch.parallel import HybridParallelOptimizer

    w, dev = MESH_LM, MESH_DEVICE
    runs = (("micro", False, _doubled(HybridParallelOptimizer, MESH_PLANT["hybrid"])),
            ("data", True, _no_data_sum("embedding")))
    for name, data_rows, planted_cls in runs:
        for cls, key in ((HybridParallelOptimizer, name), (planted_cls, f"{name}_planted")):
            model = _mesh_lm(dev, SEED + 3)
            model.init(sample_input=x[:w["batch"]])
            if cls is HybridParallelOptimizer:
                reset_counts()  # [27b]'s main paths start here
            t0 = time.perf_counter()
            o = _lm_fit(model, cls, x, y, 3, micro=SLICE28_MICRO, plan=_slice28_plan(data_rows),
                        mesh=mesh)
            _sync()
            if cls is HybridParallelOptimizer:
                out[f"{name}_counts"] = read_counts()  # ... and end here
                out[f"{name}_step_ms"] = [h["wall_s"] * 1e3 for h in o.history]
                out[f"{name}_held"] = o.held_bytes
                out[f"{name}_s"] = time.perf_counter() - t0
            out[key] = ([h["loss"] for h in o.history], _flat_params(model))
            del o, model
            _free()


def _check_slice28_mesh(ranks, card):
    """[27b]'s checks over [23d]'s ranks; returns its two paths' launches."""
    w = MESH_LM
    r0 = ranks[0]["hybrid"]
    by_path = {}
    exp = {k: w["layers"] * SLICE28_MICRO * 3 for k in ("flash_attention_fwd",
                                                        "flash_attention_bwd_dq",
                                                        "flash_attention_bwd_dkv")}
    labels = {"micro": "(i) megatron_transformer_plan()",
              "data": "(ii) the plan with the embedding's rows over 'data'"}
    for name, label in labels.items():
        held = [res["hybrid"][f"{name}_held"]["params"] for res in ranks]
        log(f"[27b] data 2 x model 2, {label}, set_micro_batches({SLICE28_MICRO}), f32 SGD 0.1: "
            f"step ms " + ", ".join(f"{v:.0f}" for v in r0[f"{name}_step_ms"])
            + f" (rank 0; {r0[f'{name}_s']:.1f} s the run); held parameters a rank "
            f"{held[0] / 2**20:.2f} MiB; launches a rank "
            f"{[_nonzero(res['hybrid'][f'{name}_counts']) for res in ranks][0]}; card {card}")
        for r, res in enumerate(ranks):
            got = _nonzero(res["hybrid"][f"{name}_counts"])
            if MESH_DEVICE == "cuda" and got != exp:
                raise AssertionError(f"[27b] {name} rank {r} launched {got}, expected {exp} "
                                     f"({w['layers']} layers x {SLICE28_MICRO} micro-batches x "
                                     "3 steps)")
            if res["hybrid"][name][0] != r0[name][0]:
                raise AssertionError(f"[27b] {name}: rank {r}'s losses {res['hybrid'][name][0]}")
        if name == "data" and not held[0] < ranks[0]["hybrid"]["micro_held"]["params"]:
            raise AssertionError(f"[27b] the data-sharded embedding is not held as a block: "
                                 f"{held[0]} bytes against {r0['micro_held']['params']}")
        _against(f"[27b] {label}: 3 f32 SGD steps vs LocalOptimizer with the same "
                 "micro-batches on one rank", r0[name], r0["micro_ref"], r0["p0"],
                 SLICE28_TOL[name], r0[f"{name}_planted"])
        by_path[f"mesh_hybrid_{name}"] = _sum_rank_counts(ranks, "hybrid", f"{name}_counts")
    return by_path


def _f32_deterministic():
    """f32 compute, TF32 off, deterministic cuDNN; returns a restore function."""
    import torch

    restore = _f32_card()
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def undo():
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
        restore()

    return undo


def _copied(flat):
    """A flat numpy tree that shares no memory with the tensors it came from
    (``numpy()`` of a CPU tensor does)."""
    return {k: v.copy() for k, v in flat.items()}


def _rel_worst(got, want, base=None):
    """The largest per-leaf ``|got - want| / |want - base|`` (``|want|``
    without ``base``) over the leaves of two flat numpy trees."""
    import numpy as np

    worst = 0.0
    for k, v in want.items():
        ref = v.astype(np.float64) - (0.0 if base is None else base[k].astype(np.float64))
        d = np.linalg.norm(got[k].astype(np.float64) - v.astype(np.float64))
        worst = max(worst, float(d / max(np.linalg.norm(ref), 1e-30)) if d else 0.0)
    return worst


def _siamese_micro_check(card):
    """[27a]'s f32 check: the micro-batched step against the hand-written
    accumulation, sound and planted."""
    import torch
    from bigdl_tpu_torch import RandomGenerator, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn.module import detach_tree
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state
    from bigdl_tpu_torch.utils.serialization import tree_items, unflatten_to_like
    from bigdl_tpu_torch.utils.table import T

    c, n, dev = SIAMESE, SIAMESE_CHECK_PAIRS, _siamese_device()
    xa, xb, y = siamese_pairs(n, c["hw"], SEED + 44)
    undo = _f32_deterministic()
    try:
        RandomGenerator.set_seed(SEED + 44)
        model = siamese_model(dev, c["embed"])
        model.init(sample_input=T(xa[:2], xb[:2]))
        w0, s0 = (_copied(_tree_to_numpy(t)) for t in (model.get_parameters(),
                                                        model.get_state()))
        o = LocalOptimizer(model, DataSet.array(T(xa, xb), y, batch_size=n),
                           nn.CosineEmbeddingCriterion(margin=c["margin"]))
        o.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
        seen, step = {}, o._train_step

        def recorded(xs, ts, *a, **k):  # the batch the step trains on (the epoch's order)
            seen["x"], seen["t"] = xs, ts
            return step(xs, ts, *a, **k)

        o._train_step = recorded
        o.set_micro_batches(SLICE28_MICRO).set_end_when(Trigger.max_iteration(1)).optimize()
        got = (_copied(_tree_to_numpy(model.get_parameters())),
               _copied(_tree_to_numpy(model.get_state())))
        del o, model
        hand = {}
        for label, halve in (("sound", True), ("planted", False)):
            m = siamese_model(dev, c["embed"])
            m.init(sample_input=T(xa[:2], xb[:2]))
            load_jax_params(m, _nest(w0))
            load_jax_state(m, _nest(s0))
            crit = nn.CosineEmbeddingCriterion(margin=c["margin"])
            params, state, acc = m.get_parameters(), m.get_state(), None
            leaves = list(tree_items(params).values())
            for h in range(SLICE28_MICRO):
                rows = slice(h * n // SLICE28_MICRO, (h + 1) * n // SLICE28_MICRO)
                x = T(seen["x"][1][rows], seen["x"][2][rows])
                out, state = m.apply(params, state, x, training=True)
                g = torch.autograd.grad(crit._apply(out, seen["t"][rows]), leaves)
                acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
            if halve:
                acc = [a / SLICE28_MICRO for a in acc]
            method = SGD(learningrate=0.01, momentum=0.9)
            grads = unflatten_to_like(dict(zip(tree_items(params), acc)), params)
            method.update(grads, params, method.init_slots(params), method.get_learning_rate(), 1)
            m.set_state(detach_tree(state))
            hand[label] = (_tree_to_numpy(m.get_parameters()), _tree_to_numpy(m.get_state()))
            del m, params, state, leaves, acc, grads
            _free()
    finally:
        undo()
    (ps, ss), (pp, sp) = hand["sound"], hand["planted"]
    upd, st = _rel_worst(got[0], ps, w0), _rel_worst(got[1], ss)
    upd_p, st_p = _rel_worst(got[0], pp, w0), _rel_worst(got[1], sp)
    equal = sum(bool((got[0][k] == v).all()) for k, v in ps.items())
    log(f"[27a] the Siamese ResNet-50 ([17a]) with set_micro_batches({SLICE28_MICRO}) on its "
        f"Table of {n} pairs, one f32 step (TF32 off, deterministic cuDNN) vs the hand-written "
        f"accumulation (the two halves' train-mode passes, BN state carried, gradients summed "
        f"and halved, the same SGD update): worst leaf update {upd:.2e} ({equal} of {len(ps)} "
        f"leaves equal to the bit), BN state {st:.2e} (limit {SIAMESE_PAIR_TOL}); planted "
        f"(summed, not halved): update {upd_p:.2e}, BN state {st_p:.2e}; card {card}")
    if upd > SIAMESE_PAIR_TOL or st > SIAMESE_PAIR_TOL:
        raise AssertionError("[27a] the micro-batched step disagrees with the accumulation")
    if not upd_p > SIAMESE_PAIR_TOL:
        raise AssertionError("[27a] the planted accumulation (not halved) passes the limit")


def phase_siamese_micro(card):
    """[27a] the f32 check, then the bf16 Siamese ResNet-50 at [17a]'s full
    width micro-batched (the main path: 4 #10 launches a step) and unsplit,
    in turns; returns the main path's launches."""
    import statistics

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.table import T

    _siamese_micro_check(card)
    _free()
    c, s = SIAMESE, SIAMESE_MICRO
    xa, xb, y = siamese_pairs(c["pairs"], c["hw"], SEED + 40)
    ds = DataSet.array(T(xa, xb), y, batch_size=c["pairs"])
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype("bfloat16")
    RandomGenerator.set_seed(45)
    model = siamese_model(_siamese_device(), c["embed"])
    reads, counts = {1: [], SLICE28_MICRO: []}, None
    on_card = _siamese_device() != "cpu"
    try:
        for rnd in range(s["rounds"]):
            for micro in (SLICE28_MICRO, 1):
                o = LocalOptimizer(model, ds, nn.CosineEmbeddingCriterion(margin=c["margin"]))
                o.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
                o.set_micro_batches(micro).set_end_when(Trigger.max_iteration(s["iters"]))
                _sync()
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                main_path = rnd == 0 and micro == SLICE28_MICRO
                with _StepProbe() as probe:
                    if main_path:
                        reset_counts()  # the main path starts here
                    o.optimize()
                    _sync()
                    if main_path:
                        counts = read_counts()  # the main path ends here
                peak = torch.cuda.max_memory_allocated() if on_card else 0
                losses = [h["loss"] for h in o.history]
                if len(losses) != s["iters"] or not all(np.isfinite(losses)):
                    raise AssertionError(f"[27a] micro {micro}: losses {losses}")
                want = {n: (2 * micro if n == "maxpool2d_bwd" and on_card else 0)
                        for n in read_counts()}
                _check_launch_steps(f"[27a] micro {micro}", probe, s["iters"], want, mem_from=2)
                ms = statistics.median(h["wall_s"] for h in o.history[1:]) * 1e3
                reads[micro].append((ms, peak))
                del o
    finally:
        Engine.set_compute_dtype(None)
        Engine.set_activation_dtype(None)
    del model
    _free()
    if counts != {n: (2 * SLICE28_MICRO * s["iters"] if n == "maxpool2d_bwd" and on_card else 0)
                  for n in counts}:
        raise AssertionError(f"[27a] the main path launched {_nonzero(counts)}")

    def fmt(micro):
        return ", ".join(f"{ms:.2f} ms / {peak / 2**30:.2f} GiB" for ms, peak in reads[micro])

    log(f"    bf16, {c['pairs']} pairs of {c['hw']}x{c['hw']}, SGD 0.01 momentum 0.9, "
        f"{s['iters'] - 1} steps after a warm-up, in turns ({s['rounds']} rounds): micro "
        f"{SLICE28_MICRO} {fmt(SLICE28_MICRO)}; unsplit {fmt(1)} (median step, "
        f"max_memory_allocated); #10 launches {2 * SLICE28_MICRO} a step ({counts['maxpool2d_bwd']}"
        f" on the main path); card {card}")
    if on_card and not max(p for _, p in reads[SLICE28_MICRO]) < min(p for _, p in reads[1]):
        raise AssertionError("[27a] micro-batches did not lower the peak memory")
    return counts


_ALEXNET_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from bigdl_tpu_torch import Engine, nn

torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
torch.backends.cuda.matmul.allow_tf32 = sys.argv[9] == "1"
torch.backends.cudnn.allow_tf32 = sys.argv[10] == "1"
Engine.set_compute_dtype(sys.argv[4])
Engine.set_activation_dtype(None if sys.argv[5] == "None" else sys.argv[5])
m = nn.load_module(sys.argv[2], device=None if sys.argv[8] == "cuda" else "cpu")
m.evaluate()
x = np.random.default_rng(int(sys.argv[6])).standard_normal((int(sys.argv[7]), 3, 227, 227))
with torch.no_grad():
    out = m.forward(x.astype(np.float32))
np.save(sys.argv[3], out.float().cpu().numpy())
print(next(m.parameters()).device)
"""


def phase_examples_flags(card):
    """[27c] lenet_train with --summary-dir and --model-save, lenet_test on
    its file, alexnet_train with --model-save and its file loaded in a fresh
    process; returns the two mains' launches (one path)."""
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.examples import alexnet_train, lenet_test, lenet_train
    from bigdl_tpu_torch.visualization import TrainSummary, ValidationSummary

    le, ax = SLICE28_LENET, SLICE28_ALEXNET
    with tempfile.TemporaryDirectory(prefix="smoke_flags_") as d:
        summaries, lenet_file, alex_file = (os.path.join(d, n) for n in
                                            ("summaries", "lenet.bin", "alexnet.bin"))
        platform = ["--platform", "cpu"] if SLICE28_DEVICE == "cpu" else []
        reset_counts()  # the main path (both mains) starts here
        run = lenet_train.main(platform + ["--max-epoch", "1", "--synthetic-size",
                                           str(le["records"]), "-b", str(le["batch"]),
                                           "--summary-dir", summaries, "--model-save", lenet_file])
        alex = alexnet_train.main(platform + ["--max-epoch", "1", "--synthetic-size",
                                              str(ax["records"]), "-b", str(ax["batch"]),
                                              "--model-save", alex_file])
        _sync()
        counts = read_counts()  # the main path ends here
        run.optimizer.summary.flush()
        run.optimizer.val_summary.flush()
        losses = [h["loss"] for h in run.optimizer.history]
        read = TrainSummary(summaries, "lenet").read_scalar("Loss")
        top1 = ValidationSummary(summaries, "lenet").read_scalar("Top1Accuracy")
        steps = le["records"] // le["batch"]
        log(f"[27c] lenet_train --summary-dir --model-save ({le['records']} synthetic digits, "
            f"batch {le['batch']}, 1 epoch): {len(losses)} steps, read_scalar('Loss') {len(read)}"
            f" events (steps {read[0][0] if read else None}..{read[-1][0] if read else None}), "
            f"Top1Accuracy {len(top1)} event(s) {[round(v, 4) for _, v in top1]}; the model "
            f"file {os.path.getsize(lenet_file) / 2**10:.1f} KiB; card {card}")
        if (len(losses) != steps or [s for s, _ in read] != list(range(1, steps + 1))
                or not np.allclose([v for _, v in read], np.float32(losses), rtol=1e-6)
                or len(top1) != 1):
            raise AssertionError(f"[27c] the summaries read {read} / {top1}, losses {losses}")
        test = lenet_test.main(platform + ["--synthetic-size", str(le["records"]), "-b",
                                           str(le["batch"]), "--model", lenet_file])
        t_acc, t_n = test.results["Top1Accuracy"].result()
        r_acc = run.results["Top1Accuracy"].result()[0]
        log(f"    lenet_test --model: Top1Accuracy {t_acc:.4f} of {t_n} (the trained model's "
            f"{r_acc:.4f}), Top5Accuracy {test.results['Top5Accuracy'].result()[0]:.4f}")
        if abs(t_acc - r_acc) > 1.0 / t_n:
            raise AssertionError("[27c] lenet_test reads another model than lenet_train saved")
        # alexnet: the file in a fresh process, its eval forward against this process's
        x = np.random.default_rng(SEED + 46).standard_normal(
            (ax["check"], 3, 227, 227)).astype(np.float32)
        alex.model.evaluate()
        prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            with torch.no_grad():
                ref = alex.model.forward(x).float().cpu().numpy()
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
        out_file = os.path.join(d, "alexnet_out.npy")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", _ALEXNET_CHILD, str(ROOT), alex_file, out_file,
             Engine.compute_dtype(), str(Engine.activation_dtype()), str(SEED + 46),
             str(ax["check"]), SLICE28_DEVICE, str(int(torch.backends.cuda.matmul.allow_tf32)),
             str(int(torch.backends.cudnn.allow_tf32))], capture_output=True, text=True,
            timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"[27c] the AlexNet child failed:\n{child.stderr[-3000:]}")
        got = np.load(out_file)
        diff = float(np.abs(got - ref).max())
        log(f"    alexnet_train --model-save ({ax['records']} synthetic images, batch "
            f"{ax['batch']}): {len(alex.optimizer.history)} steps; nn.load_module in a fresh "
            f"process on {child.stdout.strip()} ({time.perf_counter() - t0:.1f} s): forward "
            f"{got.shape}, finite {bool(np.isfinite(got).all())}, max |child - parent| {diff:.2e}"
            f" (the same weights, policy and deterministic cuDNN); launches {_nonzero(counts)}")
        if got.shape != (ax["check"], 1000) or not np.isfinite(got).all() or diff > 0:
            raise AssertionError("[27c] the AlexNet file's forward disagrees")
    want = (2 * steps + 3 * (ax["records"] * 3 // 4 // ax["batch"])
            if SLICE28_DEVICE == "cuda" else 0)
    if counts["maxpool2d_bwd"] != want or sum(counts.values()) != want:
        raise AssertionError(f"[27c] launched {_nonzero(counts)}, expected {want} #10")
    return counts


def phase_estimator(card):
    """[27d] DLClassifier over LeNet-5 on the card: fit, predict, score;
    returns the path's launches."""
    import numpy as np
    from bigdl_tpu_torch import RandomGenerator, nn
    from bigdl_tpu_torch.dataset.mnist import load_mnist
    from bigdl_tpu_torch.ml import DLClassifier
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.optim import SGD

    e = SLICE28_ESTIMATOR
    x, y = load_mnist(None, train=True, synthetic_size=e["records"])
    xt, yt = load_mnist(None, train=False, synthetic_size=e["test"])
    RandomGenerator.set_seed(SEED + 47)
    dev = None if SLICE28_DEVICE == "cuda" else "cpu"
    est = DLClassifier(LeNet5(10, device=dev), nn.ClassNLLCriterion(), batch_size=e["batch"],
                       max_epoch=e["epochs"],
                       optim_method=SGD(learningrate=e["lr"], momentum=0.9), device=dev)
    t0 = time.perf_counter()
    reset_counts()  # the main path starts here
    fitted = est.fit(x, y)
    pred = fitted.predict(xt)
    score = fitted.score(xt, yt)
    _sync()
    counts = read_counts()  # the main path ends here
    proba = fitted.predict_proba(xt[:8])
    steps = e["epochs"] * (e["records"] // e["batch"])
    log(f"[27d] DLClassifier(LeNet5(10)) on {e['records']} synthetic digits (28x28, batch "
        f"{e['batch']}, {e['epochs']} epochs, SGD {e['lr']} momentum 0.9) on "
        f"{next(fitted.model.parameters()).device}: {steps} steps in "
        f"{time.perf_counter() - t0:.2f} s with predict and score; score {score:.4f} on "
        f"{e['test']} held-out digits; launches {_nonzero(counts)}; card {card}")
    if (pred.shape != (e["test"],) or not e["min_score"] < score <= 1.0
            or not np.allclose(proba.sum(1), 1.0, atol=1e-3)
            or (proba.argmax(1) != pred[:8]).any()):
        raise AssertionError(f"[27d] predictions {pred[:8]}, score {score}, proba {proba}")
    if counts != {n: (2 * steps if n == "maxpool2d_bwd" and dev is None else 0)
                  for n in counts}:
        raise AssertionError(f"[27d] launched {_nonzero(counts)}, expected {2 * steps} #10")
    return counts


def phase_slice28(card):
    """[27] the configurations the port once refused ([27b] ran inside [23d]'s spawn);
    returns the main paths' launches."""
    t0 = time.perf_counter()
    by_path = {"siamese_micro": phase_siamese_micro(card)}
    _free()
    by_path["examples_flags"] = phase_examples_flags(card)
    _free()
    by_path["estimator"] = phase_estimator(card)
    _free()
    log(f"[27] done in {time.perf_counter() - t0:.1f} s ([27b] inside [23d])")
    return by_path


# ----------------------------------------------------------------------------- [28]
# [28] the concurrency auditor and lock tracer over the serving path, and
# the interop loaders: [28a] the LM of [5] served through ModelServer with
# its locks traced against the auditor's static graph; [28b] BVLC GoogLeNet
# imported from Caffe files and fine-tuned; [28c] VGG-16 exported to a
# frozen GraphDef, imported, fine-tuned through TFSession, its weights
# through a .t7 file.
SLICE29_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" and cuts the sizes below
SLICE29_LM = {"vocab": 8192, "hidden": 512, "heads": 8, "filt": 2048, "layers": 6, "seq": 2048}
# [28a] 16 single-record requests from 4 threads, the update after the 8th
# answer while the next requests are served (each thread's last request
# waits for the swap, so both versions answer); batch 1, so each flush is
# the direct forward's shape (the bits of a row depend on the batch's
# geometry: [25a], [19a'])
SLICE29_SERVE = {"requests": 16, "threads": 4, "batch": 1, "swap_after": 8}
GOOGLENET = {"batch": 128, "image": 224, "check_rows": 8, "steps": 5, "lr": 0.01}
# [28b] the eval forward's first rows on the card (f32, TF32 off) against the
# same graph on the CPU: float32 sums over up to 832x3x3 products taken in
# other orders (cuDNN's algorithms, oneDNN's) through 57 layers, read on the
# softmax: the limit is relative to the largest probability.
GOOGLENET_TOL = 1e-4
SLICE29_VGG = {"batch": 64, "image": 224, "train_batch": 64, "steps": 3, "lr": 0.01}
# [28c] the imported graph's eval forward against the source model's on the
# card (f32, TF32 off): the import runs each convolution on NHWC-strided
# tensors, the source on NCHW ones, so cuDNN sums in other orders through 16
# layers; read on the LogSoftMax output, relative to its largest magnitude.
TF_VGG_TOL = 1e-4

# BVLC GoogLeNet as BVLC Caffe's models/bvlc_googlenet/deploy.prototxt
# publishes it (Szegedy et al. 2014, Table 1): conv1 7x7/2, max 3x3/2 (Caffe
# sizes pools with ceil), LRN, conv2 1x1 + 3x3, LRN, max 3x3/2, inception
# 3a-3b, max 3x3/2, 4a-4e, max 3x3/2, 5a-5b, average 7x7/1, dropout 0.4, the
# 1000-way loss3/classifier and prob.
_GOOGLENET_INCEPTION = {  # 1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool proj
    "3a": (64, 96, 128, 16, 32, 32), "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64), "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64), "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128), "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128)}


def _pt_conv(name, bottom, top, n, k, stride=1, pad=0):
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" top: "{top}"\n'
            f'  convolution_param {{ num_output: {n} kernel_size: {k} stride: {stride} '
            f'pad: {pad} }} }}\n'
            f'layer {{ name: "{name.rsplit("/", 1)[0]}/relu_{name.rsplit("/", 1)[-1]}" '
            f'type: "ReLU" bottom: "{top}" top: "{top}" }}\n')


def _pt_pool(name, bottom, top, mode, k, stride, pad=0):
    return (f'layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}" top: "{top}"\n'
            f'  pooling_param {{ pool: {mode} kernel_size: {k} stride: {stride} '
            f'pad: {pad} }} }}\n')


def _pt_lrn(name, bottom):
    return (f'layer {{ name: "{name}" type: "LRN" bottom: "{bottom}" top: "{name}"\n'
            '  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }\n')


def googlenet_prototxt(image: int = 224) -> str:
    """The deploy prototxt of BVLC GoogLeNet (its layer names and widths)."""
    t = ('name: "GoogleNet"\n'
         'layer { name: "data" type: "Input" top: "data"\n'
         f'  input_param {{ shape: {{ dim: 10 dim: 3 dim: {image} dim: {image} }} }} }}\n')
    t += _pt_conv("conv1/7x7_s2", "data", "conv1/7x7_s2", 64, 7, 2, 3)
    t += _pt_pool("pool1/3x3_s2", "conv1/7x7_s2", "pool1/3x3_s2", "MAX", 3, 2)
    t += _pt_lrn("pool1/norm1", "pool1/3x3_s2")
    t += _pt_conv("conv2/3x3_reduce", "pool1/norm1", "conv2/3x3_reduce", 64, 1)
    t += _pt_conv("conv2/3x3", "conv2/3x3_reduce", "conv2/3x3", 192, 3, 1, 1)
    t += _pt_lrn("conv2/norm2", "conv2/3x3")
    t += _pt_pool("pool2/3x3_s2", "conv2/norm2", "pool2/3x3_s2", "MAX", 3, 2)
    bottom = "pool2/3x3_s2"
    for name, (n1, r3, n3, r5, n5, pp) in _GOOGLENET_INCEPTION.items():
        i = f"inception_{name}"
        t += _pt_conv(f"{i}/1x1", bottom, f"{i}/1x1", n1, 1)
        t += _pt_conv(f"{i}/3x3_reduce", bottom, f"{i}/3x3_reduce", r3, 1)
        t += _pt_conv(f"{i}/3x3", f"{i}/3x3_reduce", f"{i}/3x3", n3, 3, 1, 1)
        t += _pt_conv(f"{i}/5x5_reduce", bottom, f"{i}/5x5_reduce", r5, 1)
        t += _pt_conv(f"{i}/5x5", f"{i}/5x5_reduce", f"{i}/5x5", n5, 5, 1, 2)
        t += _pt_pool(f"{i}/pool", bottom, f"{i}/pool", "MAX", 3, 1, 1)
        t += _pt_conv(f"{i}/pool_proj", f"{i}/pool", f"{i}/pool_proj", pp, 1)
        t += (f'layer {{ name: "{i}/output" type: "Concat" bottom: "{i}/1x1" '
              f'bottom: "{i}/3x3" bottom: "{i}/5x5" bottom: "{i}/pool_proj" '
              f'top: "{i}/output" }}\n')
        bottom = f"{i}/output"
        if name in ("3b", "4e"):
            pool = "pool3/3x3_s2" if name == "3b" else "pool4/3x3_s2"
            t += _pt_pool(pool, bottom, pool, "MAX", 3, 2)
            bottom = pool
    t += _pt_pool("pool5/7x7_s1", bottom, "pool5/7x7_s1", "AVE", 7, 1)
    t += ('layer { name: "pool5/drop_7x7_s1" type: "Dropout" bottom: "pool5/7x7_s1" '
          'top: "pool5/7x7_s1" dropout_param { dropout_ratio: 0.4 } }\n'
          'layer { name: "loss3/classifier" type: "InnerProduct" bottom: "pool5/7x7_s1" '
          'top: "loss3/classifier" inner_product_param { num_output: 1000 } }\n'
          'layer { name: "prob" type: "Softmax" bottom: "loss3/classifier" top: "prob" }\n')
    return t


def _write_caffemodel(path: str, shapes, seed: int) -> int:
    """A binary .caffemodel (NetParameter.layer = 100 {name = 1, blobs = 7
    {shape = 7 {dim = 1}, packed data = 5}}) for ``shapes`` ({layer: (weight
    shape, bias shape)}), written with the port's WireWriter: seeded weights
    of variance 1/fan_in (the variance of Caffe's xavier filler) and small
    seeded biases; returns its size in bytes."""
    import numpy as np
    from bigdl_tpu_torch.utils.protowire import WireWriter

    rng = np.random.default_rng(seed)
    net = WireWriter()
    net.string(1, "GoogleNet")
    for name, (ws, bs) in shapes.items():
        layer = WireWriter()
        layer.string(1, name)
        fan_in = int(np.prod(ws[1:]))
        for arr in (rng.standard_normal(ws).astype(np.float32) * np.float32(
                np.sqrt(1.0 / fan_in)), (rng.standard_normal(bs) * 0.01).astype(np.float32)):
            blob, shape = WireWriter(), WireWriter()
            for d in arr.shape:
                shape.varint(1, int(d))
            blob.message(7, shape)
            blob.bytes_(5, arr.astype("<f4").tobytes())
            layer.message(7, blob)
        net.message(100, layer)
    data = net.blob()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def _no_tf32():
    """Full float32 in matmuls and convolutions; returns the restorer."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return restore


def phase_lock_serving(card):
    """[28a] the LM served with its locks traced; returns the path's launches."""
    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator
    from bigdl_tpu_torch.analysis import concurrency, lock_tracer
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import ModelServer

    c, s = SLICE29_LM, SLICE29_SERVE
    pkg = str(ROOT / "bigdl_tpu_torch")
    t0 = time.perf_counter()
    findings = concurrency.audit_paths([pkg])
    log(f"[28a] concurrency.audit_paths(['bigdl_tpu_torch']) on this checkout: {len(findings)} "
        f"finding(s) in {time.perf_counter() - t0:.2f} s" + "".join(f"\n    {f}" for f in findings))
    if findings:
        raise AssertionError("[28a] the port's concurrency audit is not clean")
    static = lock_tracer.load_static_edges([pkg])

    class MaxHold(lock_tracer.LockTracer):
        """The tracer, also keeping each lock's longest hold and every hold
        past 10 ms with the host time of its release."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.longest, self.long = {}, []

        def note_released(self, lock, held_s):
            with self._meta:
                self.longest[lock.name] = max(self.longest.get(lock.name, 0.0), held_s)
                if held_s > 0.01:
                    self.long.append((lock.name, held_s, time.perf_counter()))
            super().note_released(lock, held_s)

    Engine.set_compute_dtype("bfloat16")
    dev = SLICE29_DEVICE

    def lm(seed):
        RandomGenerator.set_seed(seed)
        return Transformer(c["vocab"], c["hidden"], c["heads"], c["filt"], c["layers"], 0.0, 0.0,
                           0.0, mode="lm", device=dev).eval()

    models = {1: lm(SEED + 50), 2: lm(SEED + 51)}
    records = np.random.RandomState(SEED + 50).randint(
        1, c["vocab"], size=(s["requests"], c["seq"])).astype(np.int64)
    prev_env = os.environ.get("BIGDL_LOCK_DEBUG")
    os.environ["BIGDL_LOCK_DEBUG"] = "1"
    results, versions = [None] * s["requests"], [None] * s["requests"]
    done, swapped = threading.Semaphore(0), threading.Event()
    try:
        reset_counts()  # the main path starts here
        with ModelServer() as server:
            server.register("lm", models[1], sample_input=records[0], batch_size=s["batch"],
                            max_delay_ms=5)
            tr = MaxHold(telemetry=server.telemetry, static_edges=static)
            batcher = server._entries["lm"].batcher
            traced = (lock_tracer.instrument_locks(server, tracer=tr)
                      + lock_tracer.instrument_locks(batcher, tracer=tr)
                      + lock_tracer.instrument_locks(batcher.queue, tracer=tr))

            def client(idx):
                for j, i in enumerate(idx):
                    if j == len(idx) - 1 and not swapped.wait(600):
                        return  # each thread's last request follows the swap
                    f = server.infer("lm", records[i])
                    results[i] = f.result(timeout=300)
                    versions[i] = f.version
                    done.release()

            threads = [threading.Thread(target=client, args=(range(k, s["requests"], s["threads"]),))
                       for k in range(s["threads"])]
            t_start = time.perf_counter()
            for t in threads:
                t.start()
            for _ in range(s["swap_after"]):
                if not done.acquire(timeout=600):
                    raise AssertionError("[28a] requests stalled before the hot-swap")
            t_update = time.perf_counter()
            new_version = server.update("lm", models[2])
            t_updated = time.perf_counter()
            swapped.set()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t_start
            if any(t.is_alive() for t in threads) or any(r is None for r in results):
                raise AssertionError("[28a] not every request was served")
            flushes = server.models()["lm"]["flushes"]
        _sync()
        counts = read_counts()  # the main path ends here
    finally:
        if prev_env is None:
            os.environ.pop("BIGDL_LOCK_DEBUG", None)
        else:
            os.environ["BIGDL_LOCK_DEBUG"] = prev_env
    served = {v: versions.count(v) for v in sorted(set(versions))}
    observed = sorted(tr.edges)
    log(f"[28a] served {s['requests']} LM records (V {c['vocab']}, H {c['hidden']}, "
        f"{c['layers']} layers, T {c['seq']}, bf16, batch {s['batch']}) from {s['threads']} "
        f"threads in {wall:.2f} s over {flushes} flushes, update to version {new_version} after "
        f"the {s['swap_after']}th answer; answers by version {served}; traced {traced}; "
        f"observed orders {observed}; inversions {tr.inversions}; card {card}")
    hot = ("RequestQueue._lock", "ContinuousBatcher._swap_lock", "ModelServer._lock",
           "ModelServer._mgmt_lock")
    log("    longest holds (host clock): " + ", ".join(
        f"{n} {tr.longest.get(n, 0.0) * 1e3:.3f} ms{' (hot)' if n in hot else ''}"
        for n in traced) + f"; {len(tr.hold_breaches)} hold(s) past "
        f"{tr.hold_warn_s * 1e3:.0f} ms; card {card}")
    log(f"    holds past 10 ms (ms, released at ms from the first request; the update ran "
        f"{(t_update - t_start) * 1e3:.1f}-{(t_updated - t_start) * 1e3:.1f}): " + ", ".join(
            f"{n} {h * 1e3:.1f} at {(t - t_start) * 1e3:.1f}" for n, h, t in tr.long))
    want_edges = {("ContinuousBatcher._swap_lock", "ContinuousBatcher._acct_lock"),
                  ("ModelServer._mgmt_lock", "ModelServer._lock")}
    if tr.inversions or not want_edges <= set(tr.edges) or not want_edges <= static:
        raise AssertionError(f"[28a] inversions {tr.inversions}, observed {observed}, "
                             f"static {sorted(static)}")
    if set(served) != {1, 2} or new_version != 2:
        raise AssertionError(f"[28a] the hot-swap did not split the answers: {served}")
    # every answer against a direct forward of its version at the same geometry
    mismatched = []
    with torch.inference_mode():
        for i in range(s["requests"]):
            ref = models[versions[i]].forward(records[i][None])[0]
            got = results[i].to(ref.device)
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                mismatched.append((i, versions[i], (got.float() - ref.float()).abs().max().item()))
    log(f"    answers bit-equal to a direct forward of the version that served them: "
        f"{s['requests'] - len(mismatched)} of {s['requests']} {mismatched}")
    if mismatched or any(not bool(torch.isfinite(r).all()) for r in results):
        raise AssertionError("[28a] a served answer differs from its version's forward")
    forwards = 2 + flushes  # the two warmups (register, update) and one a flush
    want = c["layers"] * forwards if dev == "cuda" else 0
    log(f"    flash_attention_fwd launches {counts['flash_attention_fwd']} (expected "
        f"{c['layers']} x {forwards} forwards = {want}); others {_nonzero(counts)}")
    if counts["flash_attention_fwd"] != want or sum(counts.values()) != want:
        raise AssertionError(f"[28a] launched {_nonzero(counts)}, expected {want} #1")
    return counts


def _maxpool_spy():
    """Wraps the library's max-pool backward entry point to record each
    launch's (kernel, stride); returns (records, restore). On the CPU there
    is no library and nothing is recorded."""
    from bigdl_tpu_torch.ops import _build

    seen = []
    if SLICE29_DEVICE != "cuda":
        return seen, lambda: None
    lib = _build.load()
    orig = lib.bigdl_maxpool2d_bwd

    def spy(*args):
        seen.append(tuple(args[9:13]))  # kh, kw, sh, sw
        return orig(*args)

    lib.bigdl_maxpool2d_bwd = spy

    def restore():
        lib.bigdl_maxpool2d_bwd = orig
    return seen, restore


def phase_caffe_googlenet(card):
    """[28b] BVLC GoogLeNet from Caffe files, evaluated and fine-tuned;
    returns the path's launches."""
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    g = GOOGLENET
    dev = None if SLICE29_DEVICE == "cuda" else "cpu"
    rng = np.random.default_rng(SEED + 52)
    x = rng.standard_normal((g["batch"], 3, g["image"], g["image"])).astype(np.float32)
    y = rng.integers(0, 1000, g["batch"])
    with tempfile.TemporaryDirectory(prefix="smoke_caffe_") as d:
        proto = os.path.join(d, "deploy.prototxt")
        with open(proto, "w") as f:
            f.write(googlenet_prototxt(g["image"]))
        shapes_of = nn.load_caffe(proto, device="meta")
        shapes_of.init(sample_input=torch.empty(1, 3, g["image"], g["image"], device="meta"))
        shapes = {}
        for m in shapes_of._layers:
            p = m.get_parameters()
            p = next((t for t in p.values() if "weight" in t), p) if "weight" not in p else p
            if "weight" in p:
                shapes[m.name()] = (tuple(p["weight"].shape), tuple(p["bias"].shape))
        del shapes_of
        weights = os.path.join(d, "bvlc_googlenet.caffemodel")
        t0 = time.perf_counter()
        size = _write_caffemodel(weights, shapes, SEED + 52)
        t_write = time.perf_counter() - t0
        Engine.set_compute_dtype("float32")
        restore = _no_tf32()
        seen, unspy = _maxpool_spy()
        try:
            RandomGenerator.set_seed(SEED + 52)
            reset_counts()  # the main path starts here
            t0 = time.perf_counter()
            model = nn.load_caffe(proto, weights, device=dev)
            model.evaluate()
            with torch.no_grad():
                probs = model.forward(x)
            _sync()
            t_eval = time.perf_counter() - t0
            restore()
            Engine.set_compute_dtype("bfloat16")
            opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=g["batch"]),
                                 nn.ClassNLLCriterion(log_prob_as_input=False))
            opt.set_optim_method(SGD(learningrate=g["lr"], momentum=0.9))
            opt.set_end_when(Trigger.max_iteration(g["steps"]))
            t0 = time.perf_counter()
            opt.optimize()
            _sync()
            t_train = time.perf_counter() - t0
            counts = read_counts()  # the main path ends here
        finally:
            unspy()
            restore()
            Engine.set_compute_dtype(None)
        Engine.set_compute_dtype("float32")
        try:
            cpu = nn.load_caffe(proto, weights, device="cpu")
            cpu.evaluate()
            with torch.no_grad():
                ref = cpu.forward(x[:g["check_rows"]])
        finally:
            Engine.set_compute_dtype(None)
    got = probs[:g["check_rows"]].float().cpu()
    rel = float((got - ref).abs().max() / ref.abs().max())
    losses = [h["loss"] for h in opt.history]
    n_params = sum(int(np.prod(w)) + int(np.prod(b)) for w, b in shapes.values())
    log(f"[28b] BVLC GoogLeNet from its deploy prototxt ({len(shapes)} weighted layers, "
        f"{n_params / 1e6:.2f} M parameters) with a {size / 2**20:.1f} MiB seeded caffemodel "
        f"(written in {t_write:.2f} s) loaded onto {next(model.parameters()).device}; eval "
        f"forward at batch {g['batch']} of {g['image']}^2 (f32, TF32 off) with the load in "
        f"{t_eval:.2f} s: {tuple(probs.shape)}, rows sum to 1 within "
        f"{float((probs.sum(1) - 1).abs().max()):.1e}; first {g['check_rows']} rows against the "
        f"CPU: {rel:.2e} of the largest probability (limit {GOOGLENET_TOL}); card {card}")
    per_step = len(seen) // max(len(losses), 1)
    s1 = sum(1 for k in seen if k == (3, 3, 1, 1))
    log(f"    {len(losses)} LocalOptimizer steps (bf16, ClassNLLCriterion on prob, SGD "
        f"{g['lr']} momentum 0.9) in {t_train:.2f} s: losses {[round(v, 4) for v in losses]}; "
        f"maxpool2d_bwd launches {counts['maxpool2d_bwd']} ({per_step} a step, "
        f"{s1 // max(len(losses), 1)} a step at 3x3/s1); others {_nonzero(counts)}")
    if (tuple(probs.shape) != (g["batch"], 1000) or not bool(torch.isfinite(probs).all())
            or rel > GOOGLENET_TOL):
        raise AssertionError("[28b] the imported GoogLeNet's eval forward disagrees")
    if len(losses) != g["steps"] or not np.isfinite(losses).all():
        raise AssertionError(f"[28b] losses {losses}")
    want = 13 * g["steps"] if SLICE29_DEVICE == "cuda" else 0
    if (counts["maxpool2d_bwd"] != want or sum(counts.values()) != want
            or (want and (len(seen) != want or s1 != 9 * g["steps"]))):
        raise AssertionError(f"[28b] launched {_nonzero(counts)} ({s1} at 3x3/s1), expected "
                             f"{want} #10 with {9 * g['steps']} at 3x3/s1")
    return counts


def _tf_source_model(dev):
    """[28c]'s source model: VGG-16 at ImageNet widths (plain ReLU modules,
    no declared epilogues)."""
    from bigdl_tpu_torch.models import Vgg_16

    return Vgg_16(1000, device=dev)


def phase_tf_vgg(card):
    """[28c] VGG-16 to a frozen GraphDef and back, fine-tuned through
    TFSession, its weights through a .t7 file; returns the path's launches."""
    import tempfile

    import numpy as np
    import torch
    from bigdl_tpu_torch import Engine, RandomGenerator, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.utils.tf_saver import save_tf
    from bigdl_tpu_torch.utils.tf_session import TFSession
    from bigdl_tpu_torch.utils.torch_file import load_t7, save_t7

    v = SLICE29_VGG
    dev = None if SLICE29_DEVICE == "cuda" else "cpu"
    rng = np.random.default_rng(SEED + 53)
    x = rng.standard_normal((v["batch"], 3, v["image"], v["image"])).astype(np.float32)
    xt = rng.standard_normal((v["train_batch"] * v["steps"], 3, v["image"], v["image"])
                             ).astype(np.float32)
    yt = rng.integers(0, 1000, len(xt))
    Engine.set_compute_dtype("float32")
    restore = _no_tf32()
    try:
        RandomGenerator.set_seed(SEED + 53)
        src = _tf_source_model(dev)
        src.init(sample_input=x[:1])
        src.evaluate()
        with tempfile.TemporaryDirectory(prefix="smoke_tf_") as d:
            path = os.path.join(d, "vgg16.pb")
            reset_counts()  # the main path starts here
            t0 = time.perf_counter()
            final = save_tf(src, path)
            t_write = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            g = nn.load_tf(path, ["input"], [final], device=dev)
            t_read = time.perf_counter() - t0
            g.evaluate()
            with torch.no_grad():
                got = g.forward(x)
                want = src.forward(x)
            _sync()
            rel = float((got - want).abs().max() / want.abs().max())
            restore()
            Engine.set_compute_dtype("bfloat16")
            t0 = time.perf_counter()
            sess = TFSession(path, ["input"], [final], trainable=True, device=dev)
            t_sess = time.perf_counter() - t0
            t0 = time.perf_counter()
            sess.train(DataSet.array(xt, yt, batch_size=v["train_batch"]), nn.ClassNLLCriterion(),
                       optim_method=SGD(learningrate=v["lr"], momentum=0.9),
                       end_when=Trigger.max_iteration(v["steps"]))
            _sync()
            t_train = time.perf_counter() - t0
            losses = [h["loss"] for h in sess.optimizer.history]
            weights = sess.variables()
            t7 = os.path.join(d, "vgg16_weights.t7")
            t0 = time.perf_counter()
            save_t7(t7, weights)
            t_t7w = time.perf_counter() - t0
            t7_size = os.path.getsize(t7)
            t0 = time.perf_counter()
            back = load_t7(t7)
            t_t7r = time.perf_counter() - t0
            _sync()
            counts = read_counts()  # the main path ends here
    finally:
        restore()
        Engine.set_compute_dtype(None)
    same = (set(back) == set(weights) and all(
        back[k].dtype == weights[k].dtype and back[k].shape == weights[k].shape
        and back[k].tobytes() == weights[k].tobytes() for k in weights))
    n_params = sum(w.size for w in weights.values())
    log(f"[28c] VGG-16 ({n_params / 1e6:.1f} M parameters) written by "
        f"save_tf to a {size / 2**20:.1f} MiB frozen GraphDef in {t_write:.2f} s, read by "
        f"nn.load_tf onto {next(g.buffers()).device} in {t_read:.2f} s; eval forward at batch "
        f"{v['batch']} (f32, TF32 off) against the source model's: {rel:.2e} of the largest "
        f"magnitude (limit {TF_VGG_TOL}); card {card}")
    log(f"    TFSession(trainable=True) built in {t_sess:.2f} s ({len(weights)} variables); "
        f"{len(losses)} steps at batch {v['train_batch']} (bf16, SGD {v['lr']} momentum 0.9) in "
        f"{t_train:.2f} s: losses {[round(x_, 4) for x_ in losses]}; save_t7 of its weights "
        f"{t7_size / 2**20:.1f} MiB in {t_t7w:.2f} s, load_t7 in {t_t7r:.2f} s, bit-equal: "
        f"{same}; launches {_nonzero(counts)}")
    if not bool(torch.isfinite(got).all()) or rel > TF_VGG_TOL:
        raise AssertionError("[28c] the imported VGG-16 disagrees with its source")
    if len(losses) != v["steps"] or not np.isfinite(losses).all() or not same:
        raise AssertionError(f"[28c] losses {losses}, t7 round trip {same}")
    if sum(counts.values()):
        raise AssertionError(f"[28c] launched {_nonzero(counts)}; the path runs no kernel")
    return counts


def phase_slice29(card):
    """[28] the auditor and tracer on the serving path, and the interop
    loaders; returns the main paths' launches."""
    t0 = time.perf_counter()
    by_path = {"lock_serving": phase_lock_serving(card)}
    _free()
    by_path["caffe_googlenet"] = phase_caffe_googlenet(card)
    _free()
    by_path["tf_vgg16"] = phase_tf_vgg(card)
    _free()
    log(f"[28] done in {time.perf_counter() - t0:.1f} s")
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (ROOT / "bigdl_tpu_torch").is_dir():
        print("chip_smoke.py: bigdl_tpu_torch/ not found next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    rec = phase_parity()
    bwd_rec = phase_bwd_parity()
    mp_rec = phase_maxpool_parity()
    ep_rec = phase_epilogue_parity()
    norm_rec = phase_norm_parity()
    probe_k = phase_probe_times(card)
    fwd = phase_times(rec, card)
    dq, dkv = phase_bwd_times(bwd_rec, card)
    phase_mask_times(rec, bwd_rec, (fwd, dq, dkv), card)
    pool = phase_maxpool_times(mp_rec, card, probe_k["empty_kernel_ms"])
    epilogue = phase_epilogue_times(ep_rec, card)
    norms = phase_norm_times(norm_rec, card)
    del rec, bwd_rec, mp_rec, ep_rec, norm_rec
    torch.cuda.empty_cache()
    by_path = {"serving": phase_slice(card), "training": phase_training(card),
               "flagship": phase_flagship(card)}
    by_path["vgg16"], by_path["vgg16_eval"] = phase_vgg(card)
    by_path["normlm"] = phase_norm_lm(card)
    by_path["flagship_val"] = phase_flagship_val(card)
    by_path.update(phase_parity_configs(card))
    by_path["flagship_serving"] = phase_flagship_serving(card)
    optim_paths, pool["shift_ab"] = phase_optim(card)
    by_path.update(optim_paths)
    by_path.update(phase_attention_slice(card))
    by_path.update(phase_models(card))
    by_path.update(phase_cells(card))
    by_path.update(phase_graphs(card))
    by_path.update(phase_detection(card))
    by_path.update(phase_slice20(card))
    by_path.update(phase_slice21(card))
    by_path.update(phase_slice22(card))
    by_path.update(phase_slice23(card))
    mesh_paths, elastic = phase_slice24(card)
    by_path.update(mesh_paths)
    by_path.update(phase_slice25(card))
    by_path.update(phase_slice26(card))
    by_path.update(phase_slice27(card, elastic))
    by_path.update(phase_slice28(card))
    by_path.update(phase_slice29(card))
    kernels = [probe_k, fwd, dq, dkv, pool, *epilogue, *norms]
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    log(f"done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
