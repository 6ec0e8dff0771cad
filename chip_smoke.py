#!/usr/bin/env python3
"""Smoke run of deeplearning4j_tpu_torch on one NVIDIA GPU.

Run from the repository root on a host with a CUDA card:

    python3 chip_smoke.py

(``python3 chip_smoke.py _runtime_layer`` builds the kernels and runs
phase 38 alone, with a few extra readings of the runtime layer.)

Phases, one JSON line each; any failure raises and the script exits
non-zero (and without a result line when no CUDA device is present):

1. device  — card name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 is switched off for matmuls and cuDNN.
2. build   — nvcc builds csrc/flash_fwd.cu, flash_bwd.cu, flash_wide.cu,
   fused_lstm_fwd.cu and fused_lstm_bwd.cu (with the shared
   csrc/sm90_common.cuh and csrc/lstm_common.cuh) for sm_90a from the
   checkout, all at once, and g++ the C++ data parsers
   (native/fastload.cpp) into build/ beside them; registers, shared memory and spills per kernel
   instantiation (72), and the HGMMA (wgmma) count of each flash kernel
   from cuobjdump -sass. The 24 bf16 and f16 wgmma kernels (forward, dq,
   dk/dv at D = 32, 64, 128, 256) and the 6 of the wide-head route (bf16
   and f16 forward, dq and dk/dv past D = 256) must show HGMMA and no
   spills, the wide f32 forward, dq and dk/dv on register tiles no
   spills, ptxas must not serialize the wide-head wgmmas (C7514), and the shared
   memory and column groups the library reports for ops/flash_attention.py
   wide_plan's plans (D = 320, 512, 2880, 3072, 4096, every dtype), from
   the kernels' own layouts, must equal the plans'; the LSTM kernels no
   spills. The LSTM kernels' routes by width (cluster, wide, step) and the
   clusters that run at once at the char-RNN width.
3. kernel  — each kernel against its plain PyTorch version on the card:
   the forward kernel and the backward pair (dq; dk/dv) at the flagship
   shape (B=16, T=2048, H=16, D=128, bf16, causal, fused-qkv strided
   views) and edge shapes (T=1000, variable-length key masks, non-causal,
   D in 32/64/128/256 (f32 too), float16, head dims the kernels run zero-padded
   (D = 16, 96, 200; 20, 100 and f32 50, whose rows in the fused-qkv
   views are not 16-byte aligned), query rows with no valid key, T in 1/65/129
   (forward also 200), B*H = 1 and contiguous q/k/v). Every forward case
   runs twice and is held bit for bit, with every output and lse entry
   finite (rows without a valid key included); the forward's ragged cases
   give the same bits from fused-qkv views and from contiguous tensors;
   each backward case runs twice and is held bit for bit. Then timings
   with CUDA events: the forward at the flagship shape and at the 4 x 128
   HTTP bucket, each backward kernel and the whole backward (delta and
   kernels #2/#3) at the flagship shape, the plain versions, and torch's
   scaled_dot_product_attention forward and backward as a yardstick only.
   Then the wide-head route (D past 256, csrc/flash_wide.cu: the bf16/f16
   forward, dq and dk/dv on wgmma and TMA, the f32 forward, dq and dk/dv on
   register tiles) through the same wrappers: forward and backward at D =
   320 and 512 in bf16 and f32 (causal; key masks), f16 at D = 300 and
   512, bf16 at D = 576 and 1024, f32 at D = 576, at B16 T2048 H4 D512
   (the flagship's products at 4 heads), f32 at B=2, T=512, H=4 (D = 320,
   512), and in column groups D = 3072 (bf16, f32) and 4096 (bf16) at
   B=1, T=256, H=2, each against the plain versions and repeated bit for
   bit, and each kernel timed at B16 T2048 H4 D512 (bf16 and f32), at B=2, T=512, H=4
   (D = 320, 512) and at B=1, T=256, H=2 (D = 3072, 4096) beside its bound,
   the plain versions and SDPA (with the SDPA backend that ran).
4. small   — a tiny TransformerLM through the port on the CPU (plain
   versions) and on the GPU (the kernels) with the same weights: the
   output, then 3 SGD steps (loss per step, final params, 2 launches of
   each backward kernel per step).
5. serve   — the serving path at full width: TransformerLM(vocab 2048,
   max_len 2048, d_model 2048, 16 heads, 8 blocks, bf16, random weights
   from the seed) registered in ModelRegistry behind InferenceServer;
   concurrent HTTP :predict requests of 1x128 token ids, then 8 concurrent
   2x2048-token requests through ModelWorker.submit that coalesce to the
   16-row batch. Checks HTTP 200, finite rows that sum to 1, 8 kernel
   launches per dispatch, and a row served alone against the same row
   served in the batch. The dispatch's breakdown times the copy of the
   [16, 2048, 2048] bf16 output to the host both ways: widened to f32 on the
   card and copied pageable, and as bf16 bits through a pinned buffer,
   widened on the host (serve/scheduler.py _to_host), bit for bit the
   same.
6. train   — the training path at the same full width through the trainer
   CLI (``deeplearning4j_tpu_torch.train``, in-process): 16 rows of random
   ids from a seed with y = roll(ids, -1), Adam at lr 1e-4 (bench.py's),
   4 epochs of one batch, then the output zip. Checks a finite, falling
   loss, 8 launches of each kernel per step, and that the zip restores to
   a model with the same output. Then step time (CUDA events), its
   forward / backward / update split, tokens/s, share of the bf16 peak and
   peak memory; and the parameter gradients of one 4-row batch with
   kernels #2/#3 against the same with the plain backward in their place.
7. lstm_kernel — the fused-LSTM kernels #4 (forward) and #5 (backward)
   against their plain versions on the card, each case with the route
   (cluster or wide) each kernel took: the char-RNN shape (B=128, T=50,
   H=256) in f32, bf16 and f16, with and without peepholes; B=1 and B=32
   at T=1 (rnn_time_step); T=37; H=128, 384, 512, 640 and 1024 in f32 and
   bf16; H=1152 and 2048 (the step route, one launch a step) at B=32,
   T=20 in f32 and bf16, f16 at H=1152; variable-length masks with a row
   masked throughout; B=300 (38
   clusters, more than run at once); nonzero h0, c0, dh_T and dc_T; the
   backward repeated bit for bit; each f16 case also runs its control (the
   plain versions with h and dz rounded to bf16), which must fail the f16
   limits. Then timings: each kernel at the char-RNN shape (f32; bf16
   too), kernel #4 at the sampling shape (B=32, T=1), each with its bound;
   the host time of one wrapper call (host clock over back-to-back calls);
   the plain versions, and cuDNN's torch.nn.LSTM forward and backward as the
   nearest yardstick only; the step route timed the same way at H=1152 and
   2048.
8. lstm_small — a tiny TextGenerationLSTM (H=128) on the CPU (plain
   versions) and on the GPU (the kernels) from the same weights: the
   output, then 9 tBPTT updates of RMSProp (loss per batch, final params,
   2 + 2 launches per chunk).
9. lstm_train — TextGenerationLSTM(vocab 77, T 50, hidden 256, f32,
   RMSProp 1e-3, tBPTT 50) at full width through the trainer CLI: 256 rows
   x 200 steps of one-hot ids from a seed, batch 128, 2 epochs (4 chunks a
   batch, 16 updates). Checks a finite, falling loss, 2 launches of each
   kernel per chunk and the zip's restored output; then one step at
   128 x 50 (CUDA events), its forward / backward / update split, tokens/s
   and peak memory.
10. lstm_sample — the zip restored; 32 rows primed with 50 steps, then 100
   rnn_time_step calls of one step each (next character by argmax): 2
   launches of kernel #4 per call, the stepped outputs equal to output()
   over the whole sequence, the time per step.
11. cnn_train — LeNet-5 at bench.py's bench_lenet5 shape (28x28x1, batch
   256, f32, Adam 1e-3, random weights from seed 12345) through the
   trainer CLI, in-process, on 2,048 synthetic images (numpy seed, pixels
   in [0, 1)) with random one-hot labels: 2 epochs, --evaluate, the output
   zip. Checks a finite loss that fell from epoch to epoch, no hand-written
   kernel launched (cuDNN convolutions and pooling, cuBLAS dense layers),
   the zip's restored output; samples/s over the last epoch (host clock
   between the synchronised score reads), the evaluation's accuracy line,
   one 256-row step by CUDA events and its forward / backward / update
   split.
12. cnn_serve — the zip restored into ModelRegistry behind InferenceServer:
   HTTP :predict with 1x28x28x1 integer pixels 0-255, 8x28x28x1 floats,
   and 4 concurrent 2-row requests that must coalesce; every response row
   against output() on the same rows; each request's latency.
13. simplecnn — SimpleCNN (48x48x3, BatchNorm, dropout) fitted 4 steps at
   batch 64: BatchNorm's running statistics moved and finite, eval-mode
   output repeated bit for bit and held to the same params and state on
   the CPU (f32, TF32 off); the forward at batch 256.
14. resnet50_train — ResNet50 (ComputationGraph, conv7 stem) at bench.py's
   bench_resnet50 shape, unreduced: 224 x 224 x 3, 1000 classes, batch 128,
   bf16, Adam 1e-3, seed 12345, on bench.py's synthetic images (numpy seed
   0): 4 fit_batch steps (finite loss, 53 finite BatchNorm states), one
   step by CUDA events split into forward / backward / update, images/s,
   MFU from the analytic forward count (3 x forward per image, dense bf16
   peak), peak memory, and one profiled step (kernel time by name, the
   convolutions' layout, copies); no hand-written kernel runs here.
15. resnet50_serve — that model through save_network / restore_network
   into ModelRegistry (max_batch 16, max_wait 0.1 s) behind
   InferenceServer: HTTP :predict of 1 x 224 x 224 x 3 integer pixels and
   4 concurrent 2-image requests through ModelWorker.submit that coalesce,
   each against output(); then the same params and state as an f32 graph
   in eval mode at batch 4 on the card against the CPU (TF32 off).
16. graph_lstm — a seq2seq ComputationGraph at the char-RNN's widths
   (one-hot vocab 77 on both inputs, GravesLSTM(256) encoder ->
   last_time_step -> duplicate_to_time_series -> merge -> GravesLSTM(256)
   decoder -> RnnOutputLayer(77), f32, RMSProp 1e-3, T = 50, tBPTT 50):
   2 epochs of 256 rows at batch 128 through the trainer CLI, evaluate(),
   2 standard-BPTT fit_batch steps, 100 one-step rnn_time_step calls on 32
   rows held to the CPU; kernels #4/#5 counted per path (2 launches of each
   per chunk or step, 2 of #4 per evaluate batch or rnn_time_step call),
   with the plain LSTM scan made to fail if it runs.
17. resilience_train — the TransformerLM of phase 5 (full width, bf16,
   Adam 1e-4) through ``fit`` on 6 batches of 16 rows: (a) uninterrupted;
   (b) with CheckpointListener(every 2 iterations, keep_last=1) and a chaos
   preemption before iteration 4 (two full-state zips written); (c) a fresh
   model resumed from that directory with the same budget, whose params must
   equal (a)'s bit for bit; (d) a skip_batch guard with spike limit 0 over
   2 steps, leaving params and updater state bit-equal. Each save's and the
   restore's seconds and bytes (and, over the same bytes, the host copy of
   every leaf, one CRC32 pass, a write with fsync and a read), the guard's
   extra peak memory, 8 launches of each flash kernel a step in every run.
18. remat_train — the same model with DL4J_TPU_REMAT_BLOCKS=1 beside the
   plain step in one call: one batch's loss both ways (bf16 tolerance) and
   its parameter gradients (bit for bit, else per tensor within
   GRAD_CHECK_REL, the largest difference reported), a warm step and 3 timed steps each (CUDA events, tokens/s, peak memory,
   which remat must lower), 16 launches of kernel #1 a remat step and 8 of
   #2/#3; a ProfilerListener window over one remat step whose Chrome trace
   must name the three flash kernels.
19. lstm_resilience — the char-RNN of phase 9 (128 x 50, tBPTT 50, f32,
   RMSProp) through ``fit`` on 6 batches: a NaN batch (chaos nan_grad)
   under skip_batch leaves that update's params bit-equal and later ones
   train; rollback (spike limit twice the first loss) on the same NaN batch
   restores the last valid checkpoint, halves the rate and carries on; a
   mid-epoch resume equals the uninterrupted run bit for bit; 2 + 2
   launches of kernels #4/#5 a batch on every path.
20. lenet_runtime — LeNet-5 at bench_lenet5's shape with no listener:
   DL4J_TPU_CHAIN_STEPS=auto chains 8 steps (32 steps, 4 chains; unset,
   the variable chains nothing) against
   DL4J_TPU_CHAIN_STEPS=0 and against that with DL4J_TPU_DEVICE_PREFETCH=1
   (ms a step each way, the three interleaved three times, and the params'
   difference; then chained and per step again with cuDNN's deterministic
   algorithms, which must agree bit for bit);
   one step under DL4J_TPU_PHASE_SPANS=1 (the three phase spans);
   LBFGS with 5 iterations on one batch on the card and the CPU (LBFGS_TOL);
   an EarlyStoppingTrainer with MaxEpochs(3) and ScoreImprovement(patience=1);
   evaluate_roc of a 2-class LeNet-5 on the card.

21. chunk_kernel — the chunk entries flash_attention_block(_grad)
   (kernels #1-#3 with Tq != Tk, absolute offsets and an lse cotangent)
   against their plain versions: the ring's diagonal block (B16 H16 D128,
   512 x 512, causal) in bf16, f32 and f16, its off-diagonal block, a
   shifted diagonal (512 queries at 1536 over 1536 keys at 512, bf16 and
   f32), a chunk wholly in the future (lse <= -1e29, gradients exactly 0),
   a kmask of zeros, varlen kmasks, D = 64, the wide-head route (D = 320;
   D = 3072 in column groups); every case repeated bit for bit; then the
   diagonal and off-diagonal blocks timed, forward and forward + backward,
   beside their bounds, the plain versions and
   aten._scaled_dot_product_flash_attention.
22. ring_attention — the flash ring (parallel/ring.py _ring_flash_shard)
   at B16 T2048 H16 D128 bf16 causal in 4 shards of 512, run once per
   shard in one process: 16 launches of each chunk kernel (the slice's
   main path on one card), output and dq/dk/dv against flash_attention
   over the whole sequence, the plain reference (per tensor and per 64-row
   tile) and the einsum ring, with and without a varlen kmask; the ring's
   time beside the whole-sequence kernels'.
23. ring_train — ShardedTrainer on a world-size-1 NCCL group over the card
   (init_distributed, make_mesh): the phase 5 TransformerLM with
   sequence_parallel=True, 3 Adam steps on 16 x 2048 tokens against
   MultiLayerNetwork._fit_batch from the same params (bit for bit, else
   within GRAD_CHECK_REL), 8 launches of each of kernels #1-#3 a step, the
   step time beside the plain step's.

24. generate — the decode path at the serve phase's full width (bf16,
   random weights from the seed) through ModelRegistry.register_generate
   with GenerateConfig's defaults (paged, 8 streams, 64-token pages and
   prefill chunks, capacity 2048; every point of the signature grid warmed):
   prompts of 7, 64, 130 and 500 tokens and 4 more (33, 250, 1000, 1),
   each streamed alone, then all 8 at once through GenerateWorker, 32 new
   tokens each: every stream's tokens equal its solo tokens, the contiguous
   layout's tokens equal the paged ones, one stream over HTTP :generate, no
   request-path dispatch shape outside the warmed grid, no flash kernel
   launched (decode_attention is plain torch). Then open-loop arrivals
   through HTTP :generate (prompts of 16, 128, 512 and 1024 tokens, seed
   11, 64 new tokens) at three rates, 5 s each: TTFT and ITL p50/p99 from
   dl4j_ttft_seconds / dl4j_itl_seconds, tokens/s from
   dl4j_tokens_generated_total, the largest occupancy; an overload arm
   (2 streams, queue of 2, 1 ms deadline) that must shed. Outside the
   counted path: the same 8 streams driven through a DecodeProgram by hand,
   alone and batched (whether the logits are bit-equal, the largest
   difference), one stream's logits per step against the full forward with
   use_flash=False and with the flash kernels (GEN_VS_FULL_ATOL), the KV
   pool's bytes and the peak memory, and one decode dispatch at B=8, NP=32
   timed (CUDA events) beside its page gathers, attention and GEMMs timed
   alone, and profiled once (device time by kernel class).
25. moe_train / moe_serve — TransformerLM(moe_experts=8) at the same width
   (a MixtureOfExperts after every second block: 4 layers, 1.49e9
   params), Adam 1e-4: a warm step and 3 timed steps on 16 x 2048 tokens
   (8 x 2048 if the peak passes 70 GB), finite losses, 8 launches of each
   of kernels #1-#3 a step; the tokens dropped by capacity per MoE layer;
   one step (4 rows) against use_flash=False: its loss in bf16 (the
   gradients and the tokens routed to another expert reported), and its
   loss and gradients in an f32 replica of the same weights (MOE_LOSS_REL,
   MOE_GRAD_REL); step time, tokens/s, peak memory; then
   its zip (params only) restored into ModelRegistry behind
   InferenceServer and 2 HTTP :predict requests, one after the other,
   held to output().

26. word2vec — Word2Vec skip-gram at bench.py:416 bench_word2vec's full
   width, unreduced (vocab 100,000, dim 100, 65,536 pairs a batch, 5
   negatives, numpy seed 0): (a) _sg_ns_step on the card against the same
   step on the CPU from the same tables and batch (per table the update's
   difference in norm, W2V_UPDATE_REL; the loss, W2V_LOSS_REL), then 50
   steps after 5 warm ones by CUDA events (pairs/s, beside the least time
   the rows it touches allow); (b) _cbow_ns_step, _dm_ns_step,
   _cbow_hs_step, _sg_hs_step (Huffman tables of a 100,000-word Zipf
   vocabulary) and GloVe's _glove_step once each at B = 65,536, card
   against CPU; (c) one scan chunk (64 x 65,536 pairs, negatives drawn on
   the card) against the loop of steps fed the negatives the same
   generator seed draws (W2V_CHUNK_REL), and those 21M negatives' counts
   against the f32 cumulative unigram table (largest |z| below W2V_NEG_Z);
   (d) the end-to-end run as bench.py:473-497 computes it: 2,000,000
   tokens from zipf(1.3) below 50,000 in sentences of 1,000,
   Word2Vec(layer_size=100, window=5, negative=5, min_word_frequency=1,
   epochs=1, seed=1, batch_size=65536, pair_backend="numpy") (scan chunks
   and the tail): vocabulary build, cold fit, a warm epoch, host pair
   generation alone, tokens/s, and the device's idle share over a profiled
   warm epoch (torch.profiler's device time).
27. embeddings — on the card: Word2Vec skip-gram NS and HS, CBOW NS and HS
   and ParagraphVectors DBOW and DM on a planted-topic corpus (4 topics of
   25 words, 2,000 sentences of 20): mean within-topic similarity above
   across-topic (words; document labels), infer_vector of a topic-0 text
   nearest topic 0's labels; GloVe on the first 200,000 tokens of
   the word2vec corpus (its weighted cost over every co-occurrence must
   fall); DeepWalk and Node2Vec on a chain of 20 cliques of 10 vertices
   (within-clique similarity above across, fit seconds); the serializer's
   text, binary and zip files of the card-trained model read back;
   DistributedWord2Vec on a world-size-1 NCCL group (its all_gather_object
   and all_reduce run) against plain Word2Vec.fit (W2V_FIT_REL).
   Neither phase launches a hand-written kernel (no Pallas kernel lies on
   the JAX package's embedding path): every kernel count is set to 0
   before each and must read 0 after.

28. search — vector search (search/, serve/ SearchWorker and routes).
   (A) bench.py:1591 bench_vector_search's configuration uncut: 100,000 x
   64 f32 around 256 centres (RandomState(42)), IndexConfig(nlist 256,
   nprobe 8, max_k 16, batch_max 1, k_choices (16,), train_sample 20000,
   kmeans_iters 8, pending_cap 0): build and warm seconds, 200 single
   queries per tier at k = 10 (p50/p99, host clock), recall@10 of IVF
   against exact (>= SEARCH_RECALL_MIN, the benchmark's gate), whether IVF
   p99 < exact p99 (reported, not checked); the exact tier's ids against
   the CPU port's (rows that differ must be ties under f32 rounding,
   counted); one search with TF32 on process-wide, bit-equal to the run
   without. (B) 1,000,000 x 128 f32 (SIFT1M's shape; clustered synthetic
   data from a seed, 1024 centres), IndexConfig(nlist 1024, nprobe 16, pq_m
   16, batch_max 32, pending_cap 1024) through register_index and
   InferenceServer: build seconds, recall@10 of IVF and IVF-PQ against
   exact, the device ms of one coalesced 32-query dispatch per tier (CUDA
   events) beside the exact scan's bytes bound, coalesced answers bit-equal
   to each query alone at the same bucket (and the largest difference
   alone at bucket 1), single queries over HTTP /v1/search from 8
   concurrent clients per tier (p50/p99), /status, /knn and /knnnew, add
   of 1,000 rows found by every tier before and after merge_pending, a
   save/load round trip answering bit for bit (bytes, seconds), peak
   memory.
29. clustering — KMeansClustering(256, 20) on (A)'s corpus (seconds), that
   result held on the host (each centre the float64 mean of its points; the
   whole corpus assigned to those centres by the card and by the CPU port,
   equal but for near-ties), and card against the CPU port on its first
   KMEANS_CPU_ROWS rows (largest centre difference, share of equal
   assignments); knn_search on (B)'s corpus chunked (262,144 rows) against
   unchunked (ids equal but for ties); RandomProjectionLSH(16, 8, 64) on
   (A) (recall@10 against exact cosine); exact Tsne on 2,500 x 50 points
   in 10 planted clusters, 1000 steps (seconds, KL, 10-NN accuracy >=
   TSNE_KNN_MIN, peak memory; its first 10 steps card against CPU, within
   TSNE_PARITY_REL at learning rate 10, reported at 200); BarnesHutTsne(method="barnes_hut") on 500 of them
   (host trees, 40 steps); NearestNeighborsServer over (A)'s points
   (/status, /knn, /knnnew; the manhattan fallback too); the CLI
   (python -m deeplearning4j_tpu_torch.clustering) as a subprocess, asked
   once and stopped. Neither phase launches a hand-written kernel (no
   Pallas kernel lies on the JAX package's search path): every count is 0
   before each and must read 0 after.

30. model_import — a model trained elsewhere onto the card: (a) the
   char-RNN at full width (TextGenerationLSTM: 2 x GravesLSTM(256) with
   peepholes, vocab 77, T 50, f32, Adam 1e-3) fitted 2 tBPTT steps from the
   seed, written by export_dl4j_zip (bytes, seconds); loaded in process by
   ModelRegistry.load and served (launches of kernel #4 counted, > 0);
   served by ``python -m deeplearning4j_tpu_torch.serve charrnn=<zip> --port
   0`` as a subprocess to 4 concurrent :predict clients of 2 rows each,
   every reply held to the exporting model's output (IMPORT_SERVE_TOL; the
   CLI's seconds from start to the first reply); imported by
   import_dl4j_zip (params and Adam moments held to the original), sampled
   10 one-step calls (2 launches of #4 each) and fine-tuned 2 tBPTT steps
   beside the original (params and moments within IMPORT_TUNE_REL, bit for
   bit expected; kernels #4/#5 counted); (b) ResNet50 at 224 x 224 x 3,
   1000 classes, f32, Adam, after one fit_batch of 32 images: export and
   import with input_type (zip bytes, seconds), params, BatchNorm state and
   moments held, the outputs on 32 images, then 2 fit_batch steps on both
   (cuDNN's deterministic algorithms); (c) a Keras Sequential config of the
   char-RNN's shape (LSTM(256, return_sequences, sigmoid gates) x 2, a
   per-step softmax Dense(77)) with weights from the seed in Keras layouts,
   through the config + weight-dict route (model_from_config, no HDF5): the
   card's output (kernel #4) against the same import on the CPU; the route
   each imported LSTM layer took; (d) where the host has h5py, every
   committed tests/fixtures/keras_*.h5 through import_model on the card
   against its golden; where it has none, the line says that the HDF5
   container is covered by the CPU tests alone. No flash kernel runs.
31. data_path — (a) 60,000 x 28 x 28 uint8 MNIST-sized IDX files with
   labels written from the seed into a temporary DL4J_TPU_DATA; ``python -m
   deeplearning4j_tpu_torch.train lenet.json --dataset mnist --epochs 1`` as
   a subprocess: the fetcher read the local files (synthetic=False) through
   the C++ parser built from native/fastload.cpp into build/, and the
   trained zip's loss on 2,048 of the images is below the initial model's;
   then in process the fetch (parse and dataset build) and one epoch timed
   (images/s); (b) a 1,000,000-row numeric CSV (10 features and an integer
   label, from the seed) through CSVRecordReader inside
   RecordReaderDataSetIterator (rows/s of the parse, by the C++ parser), a
   TransformProcess, NormalizerStandardize as the iterator's pre-processor,
   an MLP fitted 20 steps (loss falls), saved with the normalizer in the
   checkpoint zip and both restored. No hand-written kernel runs: every
   count is 0 before and must read 0 after.

32. tp_train — ShardedTrainer over MeshSpec(model=2): two rank processes on
   the card in one gloo group (NCCL refuses two ranks on one device; the
   collectives carry CUDA tensors, staged through host memory where gloo
   takes none), the full-width TransformerLM of phase 5 (bf16, Adam 1e-4),
   3 steps on 8 x 2048 tokens against MultiLayerNetwork._fit_batch from the
   same params in this process (run first and freed): the first step's
   gathered gradients per tensor within GRAD_CHECK_REL (the key bias,
   whose exact gradient is 0, reported apart), the losses and the gathered
   params as one vector bit for bit, else within GRAD_CHECK_REL; the output()
   gathered from the ranks against the single-process output
   (TP_OUTPUT_REL); 8 launches of each of kernels #1-#3 per rank a step at
   H = 8 local heads; step times beside the single-process step's, peak
   memory per rank. Then the same model with clip_l2_per_layer on its 8
   TransformerBlocks and its output layer (threshold: half the smallest
   first-step norm among them, so each clips; the norm of a sharded layer
   spans both ranks' shards), 3 steps on the same ranks against
   _fit_batch with the same normalization: losses and gathered params
   within GRAD_CHECK_REL, the ranks bit-equal, kernels #1-#3 launched 8
   times a step on each rank.
33. dp_train — ParallelWrapper on two gloo ranks, the char-RNN at full width
   (B 128, T 50, H 256, f32): (a) 64/64 and (b) 70/58 rows, 3 steps each
   against the single-process fit on the 128 rows (DP_PARAM_REL); (c) the
   sharded update against (a); (d) the compressed exchange: every step's
   decoded sum plus the new residuals against the dense gradient sum plus
   the old residuals (DP_CONSERVE_REL), comm_stats' bytes against dense;
   launches of kernels #4/#5 per rank; the exchange's share of a step.
34. gpipe_train — GPipeTrainer over pipe=2 on the same char-RNN, n_micro=4,
   3 steps against the port's single-device run that micro-batches the same
   way; launches of #4/#5 per stage (4 a step) and the step time.
35. parallel_inference — ParallelInference(mode="batched") over the
   char-RNN in this process: 8 threads of 10 requests of 1-20 rows, each
   answer against model.output on its rows (bit for bit, else TOL[f32]), a
   1 ms deadline shed, p50/p99 latency on the host clock.
36. dp_cli — the trainer CLI with --data-parallel (a world of one over
   NCCL) on LeNet-5 from phase 31's IDX files, batch 64, against the same
   command without the flag: every iteration's loss and the zip's params
   bit for bit.
37. elastic_train — ElasticTrainer (train/elastic.py) through its launcher,
   each worker a process on the card (``python3 chip_smoke.py _elastic``
   around the port's worker entry, run_worker): the char-RNN of phase 33
   on 1,024 rows, global batch 128 in 4 vshards, 8 steps, a FileStore with
   a 2 s lease TTL. (a) 1 worker, the reference; (b) 2 workers,
   checkpointing every 4 steps; then side by side (c) host_kill of rank 1
   at iteration 3, relaunched, the survivor stalled 20 s after the shrink
   so that the view grows back, (d) (b) over an in-process NetStoreServer
   (tcp://), (e) a full restart from (b)'s checkpoints with the newest
   params file and rank 1's older shard corrupted (the manifest falls
   back, the shard is dropped, its segments come from the mirror), (f1) 1
   member that is a slice of 2 gloo ranks sharing the card (16 rows of a
   32-row vshard a rank), (f2) 2 such slices with slice 1 killed at
   iteration 3 (its process group). Every worker's params and losses
   against (a): bit for bit, else within DP_PARAM_REL; (f2)'s survivor
   against (f1) bit for bit. Each worker (each slice rank) reports its
   launches of kernels #4/#5 (2 of each per vshard, or vshard part, it
   computes), its step walls and store bytes; the seconds from the kill
   to the shrink view, to the relaunched worker's start and to the grow
   view; the shares of (f1)'s step that its leader spends waiting for the
   follower at a barrier before each gather (this worker's own), in the
   gather, in the host sum, packing the part and sending the plan; how
   (f2)'s killed slice's ranks ended (both by the kill, none left to the
   launcher); #4/#5 against their plain versions at a slice rank's shape
   (B 16).

38. runtime_layer — the runtime layer (slice 17), one line per step:
   (a) serve: the phase 5 TransformerLM (full width, bf16) registered with
   ``bundle=`` in a fresh directory: restored 0, buckets 1-16 warmed, each
   priced by a counting pass, the bundle saved (bytes, entries); then a
   fresh process (``python3 chip_smoke.py _bundle_child``) with
   DL4J_TPU_COMPILE_CACHE set to this run's build directory registers the
   same configuration from the bundle: restored = the saved entries, no
   nvcc run (``_build.NVCC_RUNS``), the ledger's keys from the bundle; a
   second fresh process registers it without a bundle (the control); every
   process's seconds from ``register`` to the first 1 x 128 :predict
   reply, each child's start split (context, library load, init, the
   self-test, every warm dispatch), and kernels #1-#3's launches in each
   (#2/#3 must stay 0); (b) the cost ledger: ``mln.output`` at every warmed bucket, its
   b16 flops within RT_FLOPS_REL of 2 x tokens x the product weights plus
   kernel #1's causal count, the MFU and bandwidth share from CUDA-event
   device time of 4 sampled b16 dispatches (none above 1.0); (c)
   ``memory_report(model, 16)``: params 2 bytes and Adam's f32 moments 8
   bytes a parameter, inference and training footprints, the model
   (params, updater state, generator, iteration) unchanged; (d) the
   char-RNN (LSTM_CONF, 256 rows x 100 steps, batch 128, 2 epochs)
   uninterrupted, then with a CheckpointListener (an ``.aotbundle``
   sidecar beside each checkpoint) preempted before its third batch, then
   resumed in a fresh model: the sidecar restored, losses and params bit
   for bit, 2 + 2 launches a chunk; ``tune.tune_model`` on LeNet-5 (batch
   256) over grad_accum {1, 2} x chain_steps {0}, eta 2, 128 timed
   steps a trial in the first round, every trial a subprocess on the card
   and ``ok``; one SGD step under DL4J_TPU_GRAD_ACCUM=2 against the full
   batch's (relative difference of the updates), then ``fit`` under
   DL4J_TPU_TUNE=auto applying the winner (``tune_applied``); (e) a
   StatsListener on 4 char-RNN updates into a FileStatsStorage, UIServer's
   /train/overview, /train/system (naming the card) and /debug/trace
   answering 200, the live trace and the trace CLI's rendering of a span
   dump both valid, ConvolutionalIterationListener's PNGs for one LeNet-5
   epoch.
39. analysis: the runtime guards of ``analysis/`` on the card, set through
   ``os.environ`` inside the phase and restored after it, with the process's
   compile and bucket counters reset at its start. (a) Serving under
   DL4J_TPU_STRICT_RETRACE=1 and DL4J_TPU_DONATION_GUARD=1: the full-width
   TransformerLM registered with its warm (``warm_serving`` registers the
   buckets 1-16 at T 2048), then requests of 1, 3, 4, 9 and 16 rows x 2048
   through the scheduler: the new signatures at ``mln.output`` equal
   ``predicted_compiles`` and nothing raises, kernel #1 launches 8 a
   dispatch and #2/#3 never; then, under the warning guard, one 1 x 128
   request (the serving path pads rows, not sequence length): one signature
   beyond the bound, caught. (b) A ``RetraceGuard`` around kernel #1 fed
   three sequence lengths in one row bucket raises ``RetraceError``. (c) The
   full-width char-RNN fits 4 tBPTT chunks under both guards: no trip, the
   step's leaves all kept, 2 + 2 launches of #4/#5 a chunk; a step that
   rebinds a param leaf trips once and its old tensor reads NaN on the card.
   (d) The guards' cost: b1 and b16 ``mln.output`` dispatches of the serve
   model with the guards off, on, on, off, by CUDA events and the host
   clock. (e) The port's lint as a subprocess (standard library only): its
   exit code (must be 0), seconds, and the baselined host-sync findings per
   module.

40. wide_lm — the TransformerLM of phase 5 with 4 heads (D = 512, the
   wide-head route; the same 415,455,232 params), random weights from the
   seed: registered with ServeConfig(max_batch=16), one 1 x 128 request
   and one 16 x 2048 dispatch (8 launches of the wide forward each, no
   other route, no backward), the dispatch's forward by CUDA events; then a
   warm Adam step (1e-4) and 3 timed ones on 16 x 2048 tokens (CUDA
   events; 8 launches of the wide forward, dq and dk/dv a step, the dq on
   wgmma; the loss falls), one step split into forward / backward /
   update, peak memory. Then the same model in float32 served the same way
   (the wide f32 forward on register tiles: 8 launches a dispatch, no
   backward), its 16 x 2048 forward by CUDA events and its peak memory,
   and trained the same way (Adam 1e-4, a warm step and 3 timed ones on 16
   x 2048 tokens, 8 launches a step of the f32 forward, dq and dk/dv on
   register tiles and of no other route, a falling loss, one step split,
   peak memory), its parameter gradients on one 2 x 2048 batch within
   GRAD_CHECK_REL_F32 of the plain backward's.

It ends with the command time, the kernels line (launches of each kernel
by path, the new phases' included; the wide-head kernels as rows of their
own: the wgmma forward, dq and dk/dv and the f32 forward, dq and dk/dv on
register tiles, launched on phase 40's paths), the card's name and power
limit, and ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import io
import json
import logging
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
import zipfile
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.obs import profile
from deeplearning4j_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from deeplearning4j_tpu_torch.models import ResNet50, zoo
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    LastTimeStepVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    Conv2D,
    DepthwiseConv2D,
    GravesLSTM,
    RnnOutputLayer,
    SeparableConv2D,
)
from deeplearning4j_tpu_torch.nn import step_program
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import fused_lstm as fl
from deeplearning4j_tpu_torch.serve import InferenceServer, ModelRegistry, ServeConfig
from deeplearning4j_tpu_torch.serve.scheduler import _HostBuffer, _to_host
from deeplearning4j_tpu_torch.train import __main__ as train_cli
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.utils.serialization import restore_network, save_network
from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_unflatten_like

# H100 SXM published dense peaks (NVIDIA data sheet) at a 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12     # f32 FMA outside the tensor cores
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(B=16, T=2048, H=16, D=128)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),   # summation order
       torch.bfloat16: dict(rtol=0.0, atol=2e-2),   # ~2 bf16 ulps at O(1)
       torch.float16: dict(rtol=0.0, atol=4e-3)}    # ~2 f16 ulps at O(2)
LSE_ATOL = 1e-4
# backward, bf16: the kernels round p and ds to bf16 before their products
# (as the TPU kernels do) and sum in another order than the plain version.
# Two bounds: max |err| per tensor within ~2 bf16 ulps of the tensor's
# largest entry, and per (batch, head, 64-row tile) ||err|| within 1e-2 of
# ||ref|| (bf16 rounding of both sides gives ~1e-3), so a tile of small late
# causal gradients that is wrong cannot hide under the first bound
BWD_BF16_REL = 2e-2
BWD_BF16_TILE_REL = 1e-2
BWD_TILE_ATOL = 1e-3   # RMS floor per element: tiles of pure rounding noise
# T = 1: dq and dk are exactly 0 (one key, so ds = p * (do.v - delta) = 0);
# the kernels' f32 rounding noise (~1e-6 at D=128) is held to this, 3
# orders below a bf16 ulp of the O(1) gradients
SINGLE_KEY_ATOL = 1e-5
TRAIN_LR = 1e-4        # bench.py's Adam rate
# full-width parameter gradients with kernels #2/#3 against the plain
# backward in their place, per tensor ||diff|| / ||ref||: both are bf16, the
# kernels sum in another order, and the difference then runs through the
# rest of the bf16 backward (~2-4 bf16 ulps in norm). 4 rows keep the plain
# backward's [B, H, T, T] f32 tensors to ~1 GB each
GRAD_CHECK_REL = 1e-2
# the same in float32 (phase 40's f32 flagship: the wide f32 dq and dk/dv
# against the plain backward, both f32 all through; 1.5e-6 read on an H100)
GRAD_CHECK_REL_F32 = 1e-4
GRAD_CHECK_ROWS = 4
FLAGSHIP_CONF = dict(vocab_size=2048, max_len=2048, d_model=2048, n_heads=16,
                     n_blocks=8, dtype="bfloat16", seed=12345)
# the char-RNN (bench.py's BASELINE #3): B=128, T=50, hidden 256, f32
LSTM_SHAPE = dict(B=128, T=50, H=256)
LSTM_CONF = dict(vocab_size=77, timesteps=50, hidden=256, dtype="float32", seed=12345)
# LSTM kernels, bf16: h and dz are rounded to bf16 before the products as
# the TPU kernels do, and the f32 sums run in another order; per tensor
# max |err| within 2e-2 of max |ref|, and per time step ||err|| within 1e-2
# of ||ref||, so that one wrong step cannot hide under the first bound
LSTM_BF16_REL = 2e-2
LSTM_BF16_STEP_REL = 1e-2
# float16 (11 significant bits): the kernels and the plain versions round h
# and dz alike, so they differ where the f32 sums' order flips a rounding:
# per tensor within ~1.5 f16 ulps of max |ref|, per step ||err|| within 2e-4
# of ||ref||. The control, the plain versions with h and dz rounded to bf16
# instead, reads 4e-4 to 1.1e-3 per step and up to 3e-3 per tensor, and
# must fail these limits
LSTM_F16_REL = 1.5e-3
LSTM_F16_STEP_REL = 2e-4
LSTM_LIMITS = {torch.bfloat16: (LSTM_BF16_REL, LSTM_BF16_STEP_REL),
               torch.float16: (LSTM_F16_REL, LSTM_F16_STEP_REL)}
LSTM_ROUTE_WIDTHS = (128, 256, 384, 512, 640, 1024, 1152, 2048)
# the part of the flash kernels past D = 256 (csrc/flash_wide.cu) and of the
# LSTM kernels past H = 1024 (their step route), timed at these shapes
WIDE_FLASH_SHAPE = dict(B=2, T=512, H=4)
# head dims past what one block of the wide-head route holds (dq's layout:
# 2880) run in column groups; held and timed at B=1, T=256, H=2
WIDEST_HEADS = (2880, 3072, 4096)
WIDEST_FLASH_SHAPE = dict(B=1, T=256, H=2)
# the wide-head wgmma kernels where they have work: the products of the
# flagship shape (B16 T2048 H16 D128) at 4 heads of 512
WIDE_FLAGSHIP = dict(B=16, T=2048, H=4, D=512)
# phase 40: the flagship TransformerLM with 4 heads (D = 512, the wide route)
WIDE_LM_CONF = dict(FLAGSHIP_CONF, n_heads=4)
STEP_LSTM_SHAPE = dict(B=32, T=20)
# LeNet-5 at bench.py's bench_lenet5 shape: batch 256 of 28 x 28 x 1, f32,
# Adam 1e-3, random weights from seed 12345; synthetic images and labels
CNN_ROWS, CNN_BATCH, CNN_EPOCHS = 2048, 256, 2
# SimpleCNN on the card against the same params and state on the CPU (f32,
# TF32 off): cuDNN and the CPU sum the 3 x 3 convolutions in other orders
SIMPLECNN_TOL = dict(rtol=1e-4, atol_of_max=1e-5)
# ResNet50 at bench.py's bench_resnet50 shape (224 x 224 x 3, 1000 classes,
# batch 128, bf16, Adam 1e-3, seed 12345): RESNET_STEPS steps, then
# RESNET_TIMED timed by CUDA events
RESNET = dict(size=224, classes=1000, batch=128)
RESNET_STEPS, RESNET_TIMED = 4, 5
# ResNet50 in f32 (TF32 off), eval mode, on the card against the CPU at
# batch 4: 53 convolutions summed in other orders by cuDNN and the CPU, on
# softmax outputs of order 1e-3
RESNET_CPU_TOL = dict(rtol=1e-3, atol=1e-6)
# the seq2seq graph at the char-RNN's widths (BASELINE config #3): vocab 77
# on both inputs, GravesLSTM(256) encoder and decoder, T = 50, tBPTT 50,
# batch 128, f32, RMSProp 1e-3
GRAPH_LSTM = dict(vocab=77, T=50, hidden=256, batch=128, rows=256, epochs=2, std_steps=2,
                  sample_rows=32, sample_steps=100)
# the training runtime (phases 17-20): the full-width TransformerLM resumed
# after a preemption before iteration RES_PREEMPT_AT of RES_BATCHES; remat
# timed over REMAT_TIMED steps; the char-RNN over LSTM_RES_BATCHES batches
RES_BATCHES, RES_PREEMPT_AT, REMAT_TIMED, LSTM_RES_BATCHES = 6, 4, 3, 6
# LeNet-5 chained (K = 8) against per step, LENET_STEPS Adam steps, f32, TF32 off:
# the same kernels in the same order. cuDNN's default backward algorithms
# may sum with atomics, and Adam turns the last bits of a near-zero
# gradient into a whole step of +-lr (on an H100 two runs read 6.2e-3 and
# 3.2e-6 apart), so that difference is reported; with cuDNN's
# deterministic algorithms the two must agree bit for bit
LENET_CHAIN_TOL = 0.0
# lenet_runtime: steps a fit (chains of 8) and interleaved repeats per loop
LENET_STEPS, LENET_REPEATS = 32, 3
# LBFGS, 5 iterations on one 256-image batch, card against CPU (f32, TF32
# off): cuDNN and the CPU sum the convolutions in other orders, and the
# line search's accept/reject can turn on the last bits of a loss
LBFGS_TOL = dict(loss_rtol=1e-3, params_atol=1e-3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 2 ----------------------------------------------------------------

_DTYPE_CODE = {"float32": 0, "bfloat16": 1, "float16": 2}


def _mangled_dtype(name: str) -> str:
    """The operand type of a template instantiation from its mangled name."""
    return "bfloat16" if "bfloat16" in name else "float16" if "half" in name else "float32"


def _ptxas_report(log: str, kernel: str, smem_bytes) -> list:
    """Registers, spills and shared memory of each instantiation of
    ``kernel`` in an ``nvcc -Xptxas -v`` report."""
    out = []
    for m in re.finditer(
            kernel + r"I(\w+?)Li(\d+)E.*?"
            r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
            r"Used (\d+) registers", log, re.S):
        dtype = _mangled_dtype(m.group(1))
        D = int(m.group(2))
        out.append({
            "kernel": kernel, "dtype": dtype, "D": D, "registers": int(m.group(5)),
            "spill_stores": int(m.group(3)), "spill_loads": int(m.group(4)),
            "smem_bytes": int(smem_bytes(_DTYPE_CODE[dtype], D))})
    return out


def _ptxas_report_typed(log: str, kernel: str, smem_bytes=None) -> list:
    """Registers, spills and shared memory (at the char-RNN's H, for the
    LSTM sweeps) of each dtype instantiation of a kernel templated on its
    operand type (the LSTM kernels, the wide-head flash kernels)."""
    out = []
    for m in re.finditer(
            kernel + r"I(\w+?)E.*?(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
            r"Used (\d+) registers", log, re.S):
        dtype = _mangled_dtype(m.group(1))
        row = {"kernel": kernel, "dtype": dtype, "registers": int(m.group(4)),
               "spill_stores": int(m.group(2)), "spill_loads": int(m.group(3))}
        rows = re.search(r"Li(\d+)$", m.group(1))   # the cluster kernels' rows
        if rows:
            row["rows"] = int(rows.group(1))
        if smem_bytes is not None:
            row["smem_bytes_H256"] = int(smem_bytes(_DTYPE_CODE[dtype]))
        out.append(row)
    return out


_FLASH_KERNELS = ("(flash_fwd_wgmma_kernel|flash_fwd_kernel|flash_bwd_dq_wgmma_kernel|"
                  "flash_bwd_dkv_wgmma_kernel|flash_bwd_dq_kernel|flash_bwd_dkv_kernel)")


def _cuobjdump() -> str:
    """The cuobjdump beside the nvcc that built the kernels, else the one
    Triton's package carries."""
    cand = Path(_build.nvcc_path()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    spec = importlib.util.find_spec("triton")   # its bundled binaries, not imported
    check(spec is not None and spec.origin is not None, "no cuobjdump found")
    return str(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")


def _hgmma_counts(lib: Path) -> dict:
    """HGMMA (wgmma) instructions per (kernel, dtype, D) in the SASS of ``lib``."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?" + _FLASH_KERNELS + r"I(\w*?)Li(\d+)E", line)
        if m:
            key = (m.group(1), _mangled_dtype(m.group(2)), int(m.group(3)))
            counts[key] = 0
        elif key is not None and "HGMMA" in line:
            counts[key] += 1
    return counts


def _sass_counts(lib: Path, pattern: str) -> dict:
    """HGMMA instructions per dtype of the functions whose name matches
    ``pattern`` (one group: the template arguments) in the SASS of ``lib``."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            m = re.search(pattern, line)
            key = _mangled_dtype(m.group(1)) if m else None
            if key is not None:
                counts[key] = 0
        elif key is not None and "HGMMA" in line:
            counts[key] += 1
    return counts


def build_report() -> dict:
    # one nvcc per source, started together
    t0 = time.perf_counter()
    errors = []

    def build(name):
        try:
            _build.build(name)
        except Exception as e:   # re-raised below, on the main thread
            errors.append(e)

    native_s = []

    def build_native():
        # the C++ CSV / IDX parsers (native/fastload.cpp -> build/), beside nvcc
        from deeplearning4j_tpu_torch import native

        n0 = time.perf_counter()
        native.get_lib()
        native_s.append(time.perf_counter() - n0)

    threads = [threading.Thread(target=build, args=(n,))
               for n in ("flash_fwd", "flash_bwd", "flash_wide", "fused_lstm_fwd",
                         "fused_lstm_bwd")] + [threading.Thread(target=build_native)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "an nvcc build hung")
    if errors:
        raise errors[0]
    from deeplearning4j_tpu_torch import native

    check(native.available(), f"g++ did not build native/fastload.cpp: {native.BUILD_ERROR}")
    fwd, bwd = fa._kernel_lib(), fa._bwd_kernel_lib()
    # each flash kernel: the wgmma kernel (bf16) and the FMA kernel (f32)
    fwd_log = _build.BUILD_LOG.get("flash_fwd", "")
    kernels = []
    for kernel in ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"):
        kernels += _ptxas_report(fwd_log, kernel, fwd.flash_fwd_smem_bytes)
    bwd_log = _build.BUILD_LOG.get("flash_bwd", "")
    for which, name in enumerate(("flash_bwd_dq", "flash_bwd_dkv")):
        for kernel in (name + "_wgmma_kernel", name + "_kernel"):
            kernels += _ptxas_report(bwd_log, kernel,
                                     lambda dt, D, w=which: bwd.flash_bwd_smem_bytes(w, dt, D))
    hgmma = {**_hgmma_counts(_build.build("flash_fwd")),
             **_hgmma_counts(_build.build("flash_bwd"))}
    for k in kernels:
        k["hgmma"] = hgmma.get((k["kernel"], k["dtype"], k["D"]), 0)
    wgmma = [k for k in kernels if "_wgmma_" in k["kernel"]]
    check(len(wgmma) == 24 and {k["dtype"] for k in wgmma} == {"bfloat16", "float16"}
          and {k["D"] for k in wgmma} == {32, 64, 128, 256},
          f"expected the 24 bf16/f16 wgmma instantiations (forward, dq, dk/dv at D = 32, "
          f"64, 128, 256), parsed {wgmma}")
    check(all(k["hgmma"] > 0 for k in wgmma), f"a 16-bit flash kernel has no HGMMA: {wgmma}")
    check(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in wgmma),
          f"a 16-bit flash kernel spills: {wgmma}")
    lf, lb = fl._fwd_kernel_lib(), fl._bwd_kernel_lib()
    H = LSTM_SHAPE["H"]
    flog = _build.BUILD_LOG.get("fused_lstm_fwd", "")
    blog = _build.BUILD_LOG.get("fused_lstm_bwd", "")
    routes = {}
    for name, lib, log, kind in (("fused_lstm_fwd", lf, flog, "fwd"),
                                 ("fused_lstm_bwd", lb, blog, "bwd")):
        smem = getattr(lib, f"{name}_smem_bytes")
        # the char-RNN width takes the cluster route in every dtype
        C = {code: fl.lstm_route(H, dt, kind)[1] for dt, code in
             ((torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2))}
        kernels += _ptxas_report_typed(log, name + "_cluster_kernel",
                                       lambda code, smem=smem, C=C: smem(code, H, C[code]))
        kernels += _ptxas_report_typed(log, name + "_kernel",
                                       lambda code, smem=smem: smem(code, H, 0))
        # the step route (H > 1024): static shared memory only
        kernels += _ptxas_report_typed(log, name + "_step_kernel")
        routes[name] = {str(dt).split(".")[-1]: [list(fl.lstm_route(h, dt, kind))
                                                  for h in LSTM_ROUTE_WIDTHS]
                        for dt in (torch.float32, torch.bfloat16, torch.float16)}
    kernels += _ptxas_report_typed(blog, "dwh_gemm_kernel")      # f32
    dwh_wgmma = _ptxas_report_typed(blog, "dwh_wgmma_kernel")    # bf16, f16
    sass = _sass_counts(_build.build("fused_lstm_bwd"), r"dwh_wgmma_kernelI(\w+?)E")
    for k in dwh_wgmma:
        k["hgmma"] = sass.get(k["dtype"], 0)
    check(len(dwh_wgmma) == 2 and all(k["hgmma"] > 0 for k in dwh_wgmma),
          f"the 16-bit dWh product shows no HGMMA: {dwh_wgmma}")
    kernels += dwh_wgmma
    # the wide-head flash route (D > 256), D at run time: the f32 forward,
    # dq and dk/dv on register tiles and the bf16/f16 wgmma forward, dq and
    # dk/dv (3 kernels x 2 dtypes), each with wide_plan's plan at the timed
    # head dims, whose bytes and groups the library reports from the
    # kernels' own layouts
    wide = fa._wide_kernel_lib()
    # ptxas's notes (C75xx) name a kernel outside its own report: drop them
    wlog = "\n".join(line for line in _build.BUILD_LOG.get("flash_wide", "").splitlines()
                     if "(C75" not in line)
    wide_lib = _build.build("flash_wide")
    wide_wgmma, wide_tiles = [], []
    for which, kern in enumerate(fa.WIDE_KERNELS):
        for name in (f"flash_wide_{kern}_tiles_kernel", f"flash_wide_{kern}_wgmma_kernel"):
            rows = _ptxas_report_typed(wlog, name)
            for r in rows:
                code = _DTYPE_CODE[r["dtype"]]
                dt = getattr(torch, r["dtype"])
                r["plans"] = {}
                for D in (320, 512) + WIDEST_HEADS:
                    plan = fa.wide_plan(kern, D, dt)
                    lib_plan = [wide.flash_wide_smem_bytes(which, code, D, plan.c_plan()),
                                wide.flash_wide_groups(which, code, D, plan.c_plan())]
                    check(lib_plan == [plan.smem_bytes, len(plan.groups)],
                          f"{name} {r['dtype']} D={D}: the library's layout under "
                          f"{plan} is {lib_plan}")
                    r["plans"][D] = {"route": plan.route, "rows": plan.rows,
                                     "groups": list(plan.groups), "slots": plan.slots,
                                     "resident": plan.resident, "smem_bytes": plan.smem_bytes}
            if "_wgmma_" in name:
                counts = _sass_counts(wide_lib, name + r"I(\w+?)E")
                for r in rows:
                    r["hgmma"] = counts.get(r["dtype"], 0)
                wide_wgmma += rows
            if "_tiles_" in name:
                wide_tiles += rows
            kernels += rows
    check(len(wide_wgmma) == 6 and {k["dtype"] for k in wide_wgmma} == {"bfloat16", "float16"}
          and {k["kernel"] for k in wide_wgmma} == {f"flash_wide_{k}_wgmma_kernel"
                                                     for k in fa.WIDE_KERNELS},
          f"expected the 6 bf16/f16 wide-head wgmma instantiations (forward, dq, dk/dv), "
          f"parsed {wide_wgmma}")
    check(all(k["hgmma"] > 0 for k in wide_wgmma),
          f"a wide-head wgmma kernel has no HGMMA: {wide_wgmma}")
    check(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in wide_wgmma),
          f"a wide-head wgmma kernel spills: {wide_wgmma}")
    check(len(wide_tiles) == 3 and {k["dtype"] for k in wide_tiles} == {"float32"}
          and all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in wide_tiles),
          f"expected the f32 forward, dq and dk/dv on register tiles, none spilling: "
          f"{wide_tiles}")
    check("C7514" not in _build.BUILD_LOG.get("flash_wide", ""),
          "ptxas serializes a wide-head kernel's wgmmas (C7514)")
    seconds = time.perf_counter() - t0
    check(len(kernels) == 72, f"expected 72 kernel instantiations (flash: 3 kernels x (4 f32 "
                              f"+ 8 bf16/f16 head dims), the wide-head route's f32 forward, dq "
                              f"and dk/dv on register tiles and its wgmma "
                              f"forward, dq and dk/dv (bf16, f16); LSTM: 3 dtypes x (2 cluster kernels x 2 row counts "
                              f"+ 2 wide kernels + 2 step kernels + the dWh product)) in the "
                              f"ptxas reports, parsed {len(kernels)}")
    lstm_spills = [k for k in kernels if k["kernel"].startswith(("fused_lstm", "dwh_"))
                   and (k["spill_stores"] or k["spill_loads"])]
    check(not lstm_spills, f"an LSTM kernel spills: {lstm_spills}")
    # rows a cluster owns: 8, or more when ceil(B / 8) clusters would not all
    # run at once (the char-RNN's B = 128 on an H100: 15 clusters of 9 rows)
    rows = {str(dt).split(".")[-1]: {f"B={B}": lf.fused_lstm_fwd_cluster_rows(
                code, B, H, fl.lstm_route(H, dt, "fwd")[1]) for B in (32, 128, 300)}
            for dt, code in ((torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2))}
    return {"phase": "build", "seconds": round(seconds, 3), "kernels": kernels,
            "lstm_routes_by_H": {"H": list(LSTM_ROUTE_WIDTHS), **routes},
            "lstm_fwd_cluster_rows_H256": rows,
            "native": {"library": str(native.lib_path()), "build_s": native_s[0]}}


# -- phase 3 ----------------------------------------------------------------

def make_qkv(B, T, H, D, dtype, seed):
    """q, k, v as the attention layer passes them: views of one fused
    [B, T, 3H, D] projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, T, 3 * H, D, generator=g, device="cuda").to(dtype)
    return qkv.split(H, dim=2)


def varlen_mask(B, T, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lens = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
    return (torch.arange(T, device="cuda")[None, :] < lens[:, None]).float()


def key_mask(kind, B, T, seed):
    """None, "varlen" (random lengths >= 1) or "leading" (the first 37 keys
    of batch 0 masked: under a causal mask its first 37 queries have no
    valid key at all)."""
    if kind is None:
        return None
    if kind == "varlen":
        return varlen_mask(B, T, seed)
    km = torch.ones(B, T, device="cuda")
    km[0, :37] = 0.0
    return km


def rows_with_a_key(km, B, T, causal):
    """[B, T] 1.0 where a query row sees at least one valid key."""
    if km is None:
        return torch.ones(B, T, device="cuda")
    valid = km > 0
    if causal:
        return valid.cummax(dim=1).values.float()
    return valid.any(dim=1, keepdim=True).expand(B, T).float()


def compare(case: dict) -> dict:
    """Kernel #1 against flash_attention_reference on the rows that see a
    valid key (the others are unspecified, as from the TPU kernel, but must
    be finite); a second run must equal the first bit for bit, and with
    ``same_as_contiguous`` so must a run on contiguous copies of the
    fused-qkv views."""
    B, T, H, D = case["B"], case["T"], case["H"], case["D"]
    dtype, causal = case["dtype"], case["causal"]
    q, k, v = make_qkv(B, T, H, D, dtype, case["seed"])
    km = key_mask(case["kmask"], B, T, case["seed"])
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=causal)
    out2, lse2 = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                                kmask=km, with_lse=True)
    w = rows_with_a_key(km, B, T, causal)
    diff = (out.float() - ref.float()).abs()
    err = (diff * w[:, :, None, None]).max().item()
    lse_err = ((lse - ref_lse).abs() * w[:, None, :]).max().item()
    tol = TOL[dtype]
    worst = (diff - tol["rtol"] * ref.float().abs()) * w[:, :, None, None]
    res = {"B": B, "T": T, "H": H, "D": D, "dtype": str(dtype).split(".")[-1],
           "causal": causal, "kmask": case["kmask"],
           "rows_without_a_key": int((w == 0).sum().item()),
           "max_abs_err": err, "lse_max_abs_err": lse_err, "tol": tol,
           "finite": bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()),
           "repeat_bit_identical": torch.equal(out, out2) and torch.equal(lse, lse2)}
    ok = (worst.max().item() <= tol["atol"] and lse_err <= LSE_ATOL and res["finite"]
          and res["repeat_bit_identical"])
    if case.get("same_as_contiguous"):
        out3, lse3 = fa.flash_fwd_cuda(*(x.contiguous() for x in (q, k, v)), kmask=km,
                                       causal=causal)
        res["contiguous_bit_identical"] = torch.equal(out, out3) and torch.equal(lse, lse3)
        ok &= res["contiguous_bit_identical"]
    res["ok"] = ok
    check(ok, f"kernel disagrees with its plain version: {res}")
    return res


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
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


def attention_bound(B, T, H, D, causal, elem_bytes, peak_flops, kmask=False):
    """(bound_ms, bound_by, flops, bytes): the least time for the work these
    inputs need — the two products over the (query, key) pairs the mask
    keeps, and q/k/v/out read or written once plus the f32 lse (the cost
    ledger's own count, obs/profile.py attention_fwd_cost)."""
    flops, nbytes = profile.attention_fwd_cost(B, T, T, H, D, causal, elem_bytes, kmask)
    return (*profile.bound(flops, nbytes, peak_flops, PEAK_BYTES), flops, nbytes)


def bwd_bound(B, T, H, D, causal, elem_bytes, kernel, kmask=False, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by, flops, bytes) of one backward kernel: its
    products over the kept (query, key) pairs — S, dP, dQ for dq; S, dP,
    dV, dK for dk/dv — and q, k, v, do, lse, delta read once and its
    gradients written once (obs/profile.py attention_bwd_cost)."""
    flops, nbytes = profile.attention_bwd_cost(B, T, T, H, D, causal, elem_bytes, kernel, kmask)
    return (*profile.bound(flops, nbytes, peak, PEAK_BYTES), flops, nbytes)


def tile_rel_err(got, want, rows: int = 64) -> float:
    """Worst ||got - want|| / (||want|| + BWD_TILE_ATOL * sqrt(n)) over the
    (batch, head, ``rows``-row tile) blocks of [B, T, H, D] tensors."""
    B, T, H, D = want.shape
    pad = (0, 0, 0, 0, 0, (-T) % rows)
    d = torch.nn.functional.pad(got.float() - want.float(), pad).view(B, -1, rows, H, D)
    w = torch.nn.functional.pad(want.float(), pad).view(B, -1, rows, H, D)
    num = d.square().sum((2, 4)).sqrt()
    den = w.square().sum((2, 4)).sqrt() + BWD_TILE_ATOL * (rows * D) ** 0.5
    return (num / den).max().item()


def compare_bwd(case: dict) -> dict:
    """The backward kernels against flash_attention_bwd_reference on the
    same q, k, v, forward out/lse, cotangent and key mask; then a second run
    of the kernels on the same inputs, which must equal the first bit for
    bit. q/k/v are the fused-qkv split views unless the case names
    ``layout="separate"`` (three contiguous tensors)."""
    B, T, H, D = case["B"], case["T"], case["H"], case["D"]
    dtype, causal = case["dtype"], case["causal"]
    q, k, v = make_qkv(B, T, H, D, dtype, case["seed"])
    if case.get("layout") == "separate":
        q, k, v = (x.contiguous() for x in (q, k, v))
    km = key_mask(case["kmask"], B, T, case["seed"])
    out, lse = fa.flash_fwd_cuda(q, k, v, kmask=km, causal=causal)
    g = torch.Generator(device="cuda").manual_seed(case["seed"] + 100)
    do = torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    got = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    again = fa.flash_bwd_cuda(q, k, v, out, lse, do, km, causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, causal)
    res = {"B": B, "T": T, "H": H, "D": D, "dtype": str(dtype).split(".")[-1],
           "causal": causal, "kmask": case["kmask"],
           "layout": case.get("layout", "fused"),
           "repeat_bit_identical": all(torch.equal(a, b) for a, b in zip(got, again))}
    ok = res["repeat_bit_identical"]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        res[f"{name}_max_abs_err"] = err
        if dtype == torch.float32:
            tol = TOL[torch.float32]
            ok &= bool(((a - b).abs() <= tol["atol"] + tol["rtol"] * b.abs()).all())
        elif T == 1 and name != "dv":
            # one key: p = 1 and dp - delta = 0 exactly, so dq and dk are 0 and
            # both versions return f32 rounding noise; held to the exact 0
            res[f"{name}_max_abs"] = a.abs().max().item()
            res[f"{name}_ref_max_abs"] = b.abs().max().item()
            ok &= res[f"{name}_max_abs"] <= SINGLE_KEY_ATOL
        else:
            ref_max = b.abs().max().item()
            tile = tile_rel_err(a, b)
            res[f"{name}_ref_max_abs"] = ref_max
            res[f"{name}_ref_median_abs"] = b.abs().median().item()
            res[f"{name}_tile_rel_err"] = tile
            ok &= err <= BWD_BF16_REL * ref_max and tile <= BWD_BF16_TILE_REL
    if case["kmask"] == "leading" and causal:
        ok &= int(torch.count_nonzero(got[0][0, :37])) == 0
    res["tol"] = (TOL[torch.float32] if dtype == torch.float32
                  else {"max_abs_err_over_max_abs_ref": BWD_BF16_REL,
                        "tile_rel_err": BWD_BF16_TILE_REL,
                        "tile_atol_rms": BWD_TILE_ATOL,
                        "single_key_dq_dk_max_abs": SINGLE_KEY_ATOL})
    res["ok"] = ok
    return res


def kernel_phase() -> dict:
    fl = FLAGSHIP
    bf16, f16 = torch.bfloat16, torch.float16
    cases = [dict(fl, dtype=bf16, causal=True, kmask=None, seed=0)]
    cases += [
        # the HTTP requests' bucket: 4 rows of 128 tokens
        dict(B=4, T=128, H=16, D=128, dtype=bf16, causal=True, kmask=None, seed=9),
        dict(B=2, T=1000, H=4, D=128, dtype=bf16, causal=True, kmask=None, seed=1),
        dict(B=3, T=700, H=4, D=64, dtype=bf16, causal=False, kmask="varlen", seed=2),
        dict(B=3, T=700, H=4, D=64, dtype=bf16, causal=True, kmask="varlen", seed=3),
        dict(B=2, T=2048, H=2, D=128, dtype=bf16, causal=False, kmask=None, seed=4),
        dict(B=2, T=333, H=3, D=32, dtype=bf16, causal=True, kmask="varlen", seed=5),
    ]
    cases += [dict(B=2, T=257, H=3, D=D, dtype=torch.float32, causal=c, kmask=m, seed=6 + D)
              for D in (32, 64, 128) for c, m in ((True, None), (False, "varlen"))]
    # the wgmma kernel's tiling: 128 query rows and 128-key tiles over ragged
    # T, one (batch, head), fused-qkv views against contiguous copies
    cases += [dict(B=1, T=T, H=1, D=D, dtype=bf16, causal=c, kmask=None,
                   seed=60 + T + D + int(c), same_as_contiguous=True)
              for T in (1, 65, 129, 200) for D in (32, 64, 128) for c in (False, True)]
    # rows without a valid key: finite, and the other rows still right
    cases += [dict(B=2, T=300, H=2, D=D, dtype=dt, causal=c, kmask="leading", seed=70 + D)
              for D, dt, c in ((64, bf16, True), (128, bf16, True), (32, bf16, True),
                               (128, bf16, False), (128, torch.float32, True),
                               (256, bf16, True), (256, f16, False))]
    # D = 256, float16, and head dims the wrapper zero-pads (16, 96, 200;
    # 20, 100 and f32 50, whose rows in the fused views are not 16-byte
    # aligned)
    cases += [dict(B=2, T=300, H=3, D=D, dtype=dt, causal=c, kmask=m, seed=80 + i)
              for i, (D, dt, c, m) in enumerate((
                  (16, bf16, True, "varlen"), (96, bf16, True, None), (200, bf16, True, None),
                  (256, bf16, True, None), (256, bf16, False, "varlen"), (256, f16, True, None),
                  (128, f16, True, "varlen"), (64, f16, False, None), (32, f16, True, None),
                  (16, f16, True, None), (96, f16, False, "varlen"),
                  (16, torch.float32, True, None), (96, torch.float32, False, "varlen"),
                  (256, torch.float32, True, "varlen"), (200, torch.float32, False, None),
                  (20, bf16, True, "varlen"), (100, bf16, False, None),
                  (50, torch.float32, True, None), (100, f16, True, None)))]
    cases += [dict(B=1, T=T, H=1, D=256, dtype=dt, causal=c, kmask=None,
                   seed=100 + T + int(c), same_as_contiguous=True)
              for T in (1, 65, 129) for dt in (bf16, f16) for c in (False, True)]
    results = [compare(c) for c in cases]

    B, T, H, D = fl["B"], fl["T"], fl["H"], fl["D"]
    q, k, v = make_qkv(B, T, H, D, torch.bfloat16, 0)
    kernel_ms = time_cuda(lambda: fa.flash_fwd_cuda(q, k, v, causal=True), iters=20)
    plain_ms = time_cuda(lambda: fa.flash_attention_reference(q, k, v, causal=True),
                         iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_cuda(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=20)
    bound_ms, bound_by, flops, nbytes = attention_bound(
        B, T, H, D, True, 2, PEAK_BF16_FLOPS)
    timing = {"shape": [B, T, H, D], "dtype": "bfloat16", "causal": True,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
              "bytes": nbytes, "achieved_tflops": flops / kernel_ms / 1e9,
              "roofline_share": bound_ms / kernel_ms}
    # the 4 x 128 bucket of the HTTP requests
    hq, hk, hv = make_qkv(4, 128, H, D, bf16, 9)
    http_ms = time_cuda(lambda: fa.flash_fwd_cuda(hq, hk, hv, causal=True), iters=50)
    hqt, hkt, hvt = (x.transpose(1, 2).contiguous() for x in (hq, hk, hv))
    http_lib_ms = time_cuda(lambda: torch.nn.functional.scaled_dot_product_attention(
        hqt, hkt, hvt, is_causal=True), iters=50)
    h_bound, h_by, h_flops, _ = attention_bound(4, 128, H, D, True, 2, PEAK_BF16_FLOPS)
    timing["http_bucket"] = {"shape": [4, 128, H, D], "kernel_ms": http_ms,
                             "library_ms": http_lib_ms, "bound_ms": h_bound, "bound_by": h_by,
                             "achieved_tflops": h_flops / http_ms / 1e9,
                             "roofline_share": h_bound / http_ms}

    bwd_cases = [dict(fl, dtype=bf16, causal=True, kmask=None, seed=20)]
    bwd_cases += [
        dict(B=2, T=1000, H=4, D=128, dtype=bf16, causal=True, kmask=None, seed=21),
        dict(B=3, T=700, H=4, D=64, dtype=bf16, causal=False, kmask="varlen", seed=22),
        dict(B=3, T=700, H=4, D=64, dtype=bf16, causal=True, kmask="varlen", seed=23),
        dict(B=2, T=333, H=3, D=32, dtype=bf16, causal=True, kmask="varlen", seed=24),
        dict(B=2, T=300, H=2, D=64, dtype=bf16, causal=True, kmask="leading", seed=25),
        dict(B=2, T=300, H=2, D=128, dtype=torch.float32, causal=True, kmask="leading",
             seed=26),
    ]
    bwd_cases += [dict(B=2, T=257, H=3, D=D, dtype=torch.float32, causal=c, kmask=m,
                       seed=30 + D) for D in (32, 64, 128)
                  for c, m in ((True, None), (False, "varlen"))]
    # the wgmma kernels' tiling: 128-row blocks over 64-row tiles, ragged T
    # (1, 65, 129), one (batch, head), and both operand layouts
    bwd_cases += [dict(B=2, T=T, H=3, D=D, dtype=bf16, causal=True, kmask=None,
                       seed=40 + T + D) for T in (1, 65, 129) for D in (32, 64, 128)]
    bwd_cases += [
        dict(B=1, T=300, H=1, D=128, dtype=bf16, causal=True, kmask="varlen", seed=50),
        dict(B=1, T=129, H=1, D=64, dtype=bf16, causal=False, kmask=None, seed=51),
        dict(B=2, T=384, H=4, D=128, dtype=bf16, causal=True, kmask=None, seed=52),
        dict(B=2, T=384, H=4, D=128, dtype=bf16, causal=True, kmask=None, seed=52,
             layout="separate"),
    ]
    # D = 256 (64 own rows a block, the two warpgroups on column halves),
    # float16, and zero-padded head dims
    bwd_cases += [dict(B=2, T=T, H=3, D=D, dtype=dt, causal=c, kmask=m, seed=110 + i)
                  for i, (T, D, dt, c, m) in enumerate((
                      (300, 16, bf16, True, "varlen"), (300, 96, bf16, True, None),
                      (300, 256, bf16, True, None), (257, 256, bf16, False, "varlen"),
                      (300, 256, f16, True, None), (257, 128, f16, True, "varlen"),
                      (129, 64, f16, False, None), (65, 32, f16, True, None),
                      (200, 96, f16, True, None), (200, 16, torch.float32, True, None),
                      (200, 96, torch.float32, False, "varlen"), (65, 256, bf16, True, None),
                      (200, 256, torch.float32, True, "varlen"),
                      (130, 200, torch.float32, False, None),
                      (1, 256, bf16, True, None), (1, 256, f16, True, None),
                      (384, 256, bf16, True, "leading"), (200, 200, bf16, True, None),
                      (300, 20, bf16, True, "varlen"), (200, 100, bf16, False, None),
                      (200, 50, torch.float32, True, None), (129, 100, f16, True, None)))]
    bwd_results = [compare_bwd(c) for c in bwd_cases]
    bad = [r for r in bwd_results if not r["ok"]]
    check(not bad, f"backward kernels disagree with their plain version: {bad}")
    torch.cuda.empty_cache()

    out, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
    do = torch.randn(B, T, H, D, generator=torch.Generator(device="cuda").manual_seed(7),
                     device="cuda").to(bf16)
    delta = fa._delta(out, do)
    dq_ms = time_cuda(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None, True),
                      iters=10)
    dkv_ms = time_cuda(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None, True),
                       iters=10)
    # the whole backward as autograd runs it: delta, then kernels #2 and #3
    whole_bwd_ms = time_cuda(lambda: fa.flash_bwd_cuda(q, k, v, out, lse, do, None, True),
                             iters=10)
    plain_bwd_ms = time_cuda(
        lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, None, True),
        iters=2, warmup=1)
    torch.cuda.empty_cache()
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    o = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    sdpa_bwd_ms = time_cuda(lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                                        retain_graph=True), iters=10)
    bwd_timing = {"shape": [B, T, H, D], "dtype": "bfloat16", "causal": True,
                  "whole_ms": whole_bwd_ms,
                  "whole": "flash_bwd_cuda: delta = rowsum(do * out), kernel #2, kernel #3",
                  "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms,
                  "library": "scaled_dot_product_attention backward (dq, dk, dv)",
                  "whole_over_library": whole_bwd_ms / sdpa_bwd_ms}
    for name, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
        b_ms, b_by, b_flops, b_bytes = bwd_bound(B, T, H, D, True, 2, name)
        bwd_timing[name] = {"kernel_ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                            "flops": b_flops, "bytes": b_bytes,
                            "achieved_tflops": b_flops / ms / 1e9,
                            "roofline_share": b_ms / ms}
    # D = 256 at the flagship's sequence and batch, 8 heads (model width 2048)
    q, k, v = make_qkv(16, 2048, 8, 256, bf16, 8)
    out, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
    do = torch.randn_like(out)
    delta = fa._delta(out, do)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    d256 = {"shape": [16, 2048, 8, 256], "dtype": "bfloat16", "causal": True,
            "fwd_ms": time_cuda(lambda: fa.flash_fwd_cuda(q, k, v, causal=True), iters=10),
            "dq_ms": time_cuda(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, None,
                                                            True), iters=5),
            "dkv_ms": time_cuda(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, None,
                                                              True), iters=5),
            "library_fwd_ms": time_cuda(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters=10),
            "fwd_bound_ms": attention_bound(16, 2048, 8, 256, True, 2, PEAK_BF16_FLOPS)[0]}
    del q, k, v, out, lse, do, delta, qt, kt, vt
    torch.cuda.empty_cache()
    return {"phase": "kernel", "cases": results, "timing": timing,
            "bwd_cases": bwd_results, "bwd_timing": bwd_timing, "head_dim_256": d256,
            "wide_head": wide_head_checks()}


def sdpa_backend(q, k, v, causal) -> str:
    """The backend scaled_dot_product_attention picks for these inputs (as
    its dispatcher does, requires_grad included)."""
    from torch.nn.attention import SDPBackend

    code = int(torch._fused_sdp_choice(q, k, v, is_causal=causal))
    return {m.value: n for n, m in SDPBackend.__members__.items()}.get(code, str(code))


def wide_head_checks() -> dict:
    """The wide-head route (head dims past 256, csrc/flash_wide.cu: the
    16-bit forward, dq and dk/dv on wgmma, the f32 forward, dq and dk/dv on
    register tiles) through the same wrappers: forward and backward cases
    against the plain versions (D = 320 and 512 in bf16 and f32, causal and
    with a key mask; f16 at D = 300, zero-padded to 320, and 512; f32 at D
    = 300 with rows that see no key; bf16 D = 576 (three column groups) and
    1024 with rows that see no key, f32 D = 576 (two groups) with a key
    mask; WIDE_FLAGSHIP in bf16 and f32; WIDE_FLASH_SHAPE at D = 320 and
    512 in f32; D = 3072 (bf16, f32) and 4096 (bf16) in groups), then each
    kernel timed at WIDE_FLAGSHIP (bf16 and f32), WIDE_FLASH_SHAPE and
    WIDEST_FLASH_SHAPE beside its bound, the plain versions and SDPA (naming
    the backend SDPA ran)."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    specs = ((320, bf16, True, None), (320, bf16, False, "varlen"), (320, f32, True, "varlen"),
             (320, f32, False, None), (512, bf16, True, "varlen"), (512, bf16, False, None),
             (512, f32, True, None), (512, f32, False, "varlen"), (300, f16, True, None),
             (1024, bf16, True, "leading"), (576, bf16, True, "varlen"),
             (512, f16, False, "leading"), (300, f32, True, "leading"),
             (576, f32, True, "varlen"))
    cases = [dict(B=2, T=300, H=3, D=D, dtype=dt, causal=c, kmask=m, seed=200 + i)
             for i, (D, dt, c, m) in enumerate(specs)]
    cases += [dict(WIDE_FLAGSHIP, dtype=dt, causal=True, kmask=None, seed=250)
              for dt in (bf16, f32)]
    cases += [dict(WIDE_FLASH_SHAPE, D=D, dtype=f32, causal=True, kmask=None, seed=260 + i)
              for i, D in enumerate((320, 512))]
    cases += [dict(B=1, T=65, H=1, D=320, dtype=bf16, causal=True, kmask=None, seed=220,
                   same_as_contiguous=True)]
    # past D = 2880: the outputs' columns in groups, the scores recomputed
    # in every group
    widest = ((3072, bf16, True, None), (3072, bf16, False, "varlen"),
              (3072, f32, True, "varlen"), (3072, f32, False, None),
              (4096, bf16, True, "varlen"), (4096, bf16, False, None))
    cases += [dict(WIDEST_FLASH_SHAPE, D=D, dtype=dt, causal=c, kmask=m, seed=240 + i)
              for i, (D, dt, c, m) in enumerate(widest)]
    fwd = [compare(c) for c in cases]
    bwd = [compare_bwd(c) for c in cases]
    bad = [r for r in bwd if not r["ok"]]
    check(not bad, f"the wide-head backward disagrees with its plain version: {bad}")
    timing = []
    shapes = [(dict(B=16, T=2048, H=4), 512, bf16), (dict(B=16, T=2048, H=4), 512, f32)]
    shapes += [(WIDE_FLASH_SHAPE, D, dt) for D in (320, 512) for dt in (bf16, f32)]
    shapes += [(WIDEST_FLASH_SHAPE, 3072, bf16), (WIDEST_FLASH_SHAPE, 3072, f32),
               (WIDEST_FLASH_SHAPE, 4096, bf16)]
    for shape, D, dt in shapes:
        B, T, H = shape["B"], shape["T"], shape["H"]
        q, k, v = make_qkv(B, T, H, D, dt, 230 + D)
        out, lse = fa.flash_fwd_cuda(q, k, v, causal=True)
        do = torch.randn(B, T, H, D, generator=torch.Generator(device="cuda").manual_seed(7),
                         device="cuda").to(dt)
        delta = fa._delta(out, do)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        o = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        dot = do.transpose(1, 2).contiguous()
        es = 2 if dt == bf16 else 4
        peak = PEAK_BF16_FLOPS if dt == bf16 else PEAK_F32_FLOPS
        row = {"shape": [B, T, H, D], "dtype": str(dt).split(".")[-1], "causal": True,
               "column_groups": [len(fa.wide_plan(kern, D, dt).groups)
                                 for kern in fa.WIDE_KERNELS],
               "routes": [fa.wide_plan(kern, D, dt).route for kern in fa.WIDE_KERNELS],
               "fwd_ms": time_cuda(lambda: fa.flash_fwd_cuda(q, k, v, causal=True), 10),
               "dq_ms": time_cuda(lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                               None, True), 5),
               "dkv_ms": time_cuda(lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                                 None, True), 5),
               "plain_fwd_ms": time_cuda(lambda: fa.flash_attention_reference(
                   q, k, v, causal=True), 3, warmup=1),
               "plain_bwd_ms": time_cuda(lambda: fa.flash_attention_bwd_reference(
                   q, k, v, out, lse, do, None, True), 3, warmup=1),
               "library_fwd_ms": time_cuda(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True), 10),
               "library_bwd_ms": time_cuda(lambda: torch.autograd.grad(
                   o, (qg, kg, vg), dot, retain_graph=True), 5),
               "library": "scaled_dot_product_attention forward / backward (dq, dk, dv)",
               "library_backend": {"fwd": sdpa_backend(qt, kt, vt, True),
                                   "fwd_bwd": sdpa_backend(qg, kg, vg, True)}}
        row["fwd_bound_ms"], row["fwd_bound_by"] = attention_bound(
            B, T, H, D, True, es, peak)[:2]
        for name in ("dq", "dkv"):
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bwd_bound(
                B, T, H, D, True, es, name, peak=peak)[:2]
        row["fwd_flops"] = attention_bound(B, T, H, D, True, es, peak)[2]
        row["achieved_fwd_tflops"] = row["fwd_flops"] / row["fwd_ms"] / 1e9
        timing.append(row)
        del q, k, v, out, lse, do, delta, qt, kt, vt, qg, kg, vg, o, dot
        torch.cuda.empty_cache()
    return {"cases": fwd, "bwd_cases": bwd, "timing": timing,
            "peak_flops": {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}}


# -- phase 4 ----------------------------------------------------------------

def small_phase() -> dict:
    out = {"phase": "small", "runs": []}
    # bf16: cuBLAS and the CPU GEMMs round the logits at other places; a
    # logit difference d moves a probability p by about p*d, and a few bf16
    # ulps of logits of order 1-4 are a few percent
    for dtype, tol in (("float32", dict(rtol=1e-4, atol=1e-5)),
                       ("bfloat16", dict(rtol=2 ** -5, atol=2 ** -10))):
        conf = zoo.TransformerLM(vocab_size=64, max_len=64, d_model=64, n_heads=2,
                                 n_blocks=2, dtype=dtype, seed=11)
        cpu = MultiLayerNetwork(conf, device="cpu").init()
        gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
        x = torch.randint(0, 64, (3, 64), generator=torch.Generator().manual_seed(1))
        before = fa.flash_fwd_cuda.launches
        got = gpu.output(x).cpu().float()
        launches = fa.flash_fwd_cuda.launches - before
        want = cpu.output(x).float()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, **tol)) and launches == 2
        run = {"dtype": dtype, "max_abs_err": err, "tol": tol,
               "kernel_launches": launches, "ok": ok}
        check(ok, f"GPU and CPU disagree on the tiny TransformerLM: {run}")
        out["runs"].append(run)
    out["train"] = small_train()
    return out


def _bwd_launches():
    return fa.flash_bwd_dq_cuda.launches, fa.flash_bwd_dkv_cuda.launches


def small_train() -> dict:
    """3 SGD steps of a tiny f32 TransformerLM on the CPU (plain versions)
    and on the GPU (the kernels) from the same weights and batch. f32:
    summation order differs (cuBLAS, the kernels' blockwise sums)."""
    tol = dict(rtol=1e-4, atol=1e-5)
    conf = zoo.TransformerLM(vocab_size=64, max_len=64, d_model=64, n_heads=2,
                             n_blocks=2, dtype="float32", seed=11,
                             updater={"type": "sgd", "lr": 0.1})
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
    x = torch.randint(0, 64, (4, 64), generator=torch.Generator().manual_seed(3))
    y = torch.roll(x, -1, dims=1)
    scores, launches = {}, {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        lis = CollectScoresListener()
        m.set_listeners(lis)
        before = _bwd_launches()
        m.fit((x, y), epochs=3)
        torch.cuda.synchronize()
        launches[name] = [a - b for a, b in zip(_bwd_launches(), before)]
        scores[name] = [s for _, s in lis.scores]
    got = [p.cpu() for p in tree_leaves(gpu.params)]
    want = tree_leaves(cpu.params)
    param_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    ok = (bool(np.allclose(scores["gpu"], scores["cpu"], **tol))
          and all(torch.allclose(a, b, **tol) for a, b in zip(got, want))
          and launches == {"cpu": [0, 0], "gpu": [6, 6]})
    res = {"dtype": "float32", "steps": 3, "loss_cpu": scores["cpu"],
           "loss_gpu": scores["gpu"], "param_max_abs_err": param_err, "tol": tol,
           "bwd_launches_dq_dkv": launches, "ok": ok}
    check(ok, f"GPU and CPU training disagree on the tiny TransformerLM: {res}")
    return res


# -- phase 5 ----------------------------------------------------------------

def post_predict(port: int, name: str, ids, deadline_ms: float):
    body = json.dumps({"inputs": ids, "deadline_ms": deadline_ms}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        status, payload = resp.status, json.loads(resp.read())
    return status, payload, time.perf_counter() - t0


def check_rows(out: torch.Tensor, shape, what: str) -> float:
    check(tuple(out.shape) == tuple(shape), f"{what}: shape {tuple(out.shape)} != {shape}")
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite outputs")
    dev = (out.sum(-1) - 1.0).abs().max().item()
    check(dev < 2e-2, f"{what}: softmax rows sum to 1 +- {dev}")
    return dev


def run_concurrently(fn, args_list):
    results = [None] * len(args_list)
    errors = []
    barrier = threading.Barrier(len(args_list))

    def call(i, a):
        try:
            barrier.wait(timeout=60)
            results[i] = fn(*a)
        except Exception as e:   # re-raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i, a)) for i, a in enumerate(args_list)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), "a request thread hung")
    if errors:
        raise errors[0]
    return results


def serve_phase() -> dict:
    vocab, T, name = 2048, 2048, "lm"
    conf = zoo.TransformerLM(**FLAGSHIP_CONF)
    g = torch.Generator().manual_seed(2)
    http_ids = [torch.randint(0, vocab, (1, 128), generator=g) for _ in range(4)]
    batch_ids = [torch.randint(0, vocab, (2, T), generator=g) for _ in range(8)]
    torch.cuda.reset_peak_memory_stats()

    # the main path: every launch below is counted
    fa.flash_fwd_cuda.launches = 0
    fa.flash_bwd_dq_cuda.launches = 0
    fa.flash_bwd_dkv_cuda.launches = 0
    t0 = time.perf_counter()
    model = MultiLayerNetwork(conf).init()
    registry = ModelRegistry(config=ServeConfig(
        max_batch=16, queue_limit=64, max_wait_s=0.1, default_deadline_s=600.0))
    registry.register(name, model)
    server = InferenceServer(registry).start(port=0)
    setup_s = time.perf_counter() - t0
    warm_launches = fa.flash_fwd_cuda.launches
    worker = registry.worker(name)
    try:
        # concurrent HTTP :predict, integer ids, a deadline a slow kernel meets
        before_b, before_l = worker.stats()["batches"], fa.flash_fwd_cuda.launches
        http = run_concurrently(
            lambda ids: post_predict(server.port, name, ids.tolist(), 600000.0),
            [(ids,) for ids in http_ids])
        http_batches = worker.stats()["batches"] - before_b
        http_launches = fa.flash_fwd_cuda.launches - before_l
        for status, payload, _ in http:
            check(status == 200, f"HTTP status {status}")
            check_rows(torch.tensor(payload["outputs"]), (1, 128, vocab), "HTTP :predict")
        check(http_launches == 8 * http_batches,
              f"{http_launches} launches for {http_batches} HTTP dispatches")

        # 8 x 2 rows of 2048 tokens coalesce into the 16-row batch
        before_b, before_l = worker.stats()["batches"], fa.flash_fwd_cuda.launches
        n_spans = len(obs.recent_spans())
        t1 = time.perf_counter()
        outs = run_concurrently(lambda ids: (worker.submit(ids.numpy(), deadline_s=600.0),
                                             time.perf_counter() - t1),
                                [(ids,) for ids in batch_ids])
        batches = worker.stats()["batches"] - before_b
        launches = fa.flash_fwd_cuda.launches - before_l
        check(launches == 8 * batches, f"{launches} launches for {batches} dispatches")
        sums = [check_rows(torch.from_numpy(o), (2, T, vocab), "batched request")
                for o, _ in outs]
        dispatches = [s for s in obs.recent_spans()[n_spans:] if s["span"] == "serve.dispatch"]

        # one row alone (bucket 1) against the same row inside the batch
        alone = worker.submit(batch_ids[0][:1].numpy(), deadline_s=600.0)
        in_batch = outs[0][0][:1]
        diff = float(abs(alone - in_batch).max())
        check(diff <= 1e-3, f"row alone vs in batch differ by {diff}")

        listing = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/v1/models", timeout=60).read())
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=60).read().decode()
        check('dl4j_requests_total{route="serve.lm:http",status="200"}' in metrics,
              "/metrics lacks the served requests")
    finally:
        server.stop()
    torch.cuda.synchronize()
    total_launches = fa.flash_fwd_cuda.launches
    check(total_launches > 0, "the main path never launched the kernel")
    check(_bwd_launches() == (0, 0), "serving launched a backward kernel")

    # where a 16-row dispatch goes, outside the counted run: the forward
    # pass on the card, then the copy of its bf16 output to the host, both
    # ways (host clock, 3 samples each, alternating): widened to f32 on the
    # card, and as bf16 bits into a pinned buffer widened on the host
    x16 = torch.cat(batch_ids).numpy()
    forward_ms = time_cuda(lambda: model.output(x16), iters=3, warmup=1)
    out16 = model.output(x16)
    torch.cuda.synchronize()
    copy_ms = {"f32_on_card": [], "bf16_bits_pinned": []}
    pinned = _HostBuffer()   # as a serving worker keeps one, allocated once
    _to_host(out16, pinned)
    for _ in range(3):
        for how, fn in (("f32_on_card", lambda: out16.float().cpu().numpy()),
                        ("bf16_bits_pinned", lambda: _to_host(out16, pinned))):
            t2 = time.perf_counter()
            host = fn()
            copy_ms[how].append((time.perf_counter() - t2) * 1e3)
    check(np.array_equal(_to_host(out16, pinned).view(np.uint32),
                         out16.float().cpu().numpy().view(np.uint32)),
          "the bf16-bits copy to the host differs from the f32 one")
    del host
    to_host_ms = min(copy_ms["bf16_bits_pinned"])
    return {
        "phase": "serve",
        "model": {"vocab": vocab, "T": T, "d_model": 2048, "heads": 16, "blocks": 8,
                  "dtype": "bfloat16", "params": model.num_params()},
        "setup_s": setup_s,
        "warm": {k: listing["models"][0][k] for k in ("warm_buckets", "warm_seconds")},
        "warm_launches": warm_launches,
        "http": {"requests": len(http), "rows_x_tokens": [1, 128],
                 "latency_s": sorted(lat for _, _, lat in http),
                 "dispatches": http_batches, "launches": http_launches},
        "batched": {"requests": len(outs), "rows_x_tokens": [2, T],
                    "latency_s": sorted(lat for _, lat in outs),
                    "dispatches": batches, "launches": launches,
                    "dispatch_rows": [s.get("attrs", {}).get("rows") for s in dispatches],
                    "dispatch_s": [s["wall_s"] for s in dispatches],
                    "max_row_sum_dev": max(sums)},
        "alone_vs_batched_max_abs_diff": diff,
        "breakdown_16x2048": {"forward_ms": forward_ms, "to_host_ms": to_host_ms,
                              "to_host_copies_ms": copy_ms},
        "launches": total_launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }


# -- phase 6 ----------------------------------------------------------------

class _ScoreLog(logging.Handler):
    """Collects the CLI's ScoreIterationListener lines and the host time of
    each (``time.perf_counter``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.scores = []
        self.stamps = []

    def emit(self, record):
        m = re.match(r"Score at iteration (\d+) is (\S+)", record.getMessage())
        if m:
            self.scores.append((int(m.group(1)), float(m.group(2))))
            self.stamps.append(time.perf_counter())


def _launch_counts():
    return {"flash_fwd": fa.flash_fwd_cuda.launches,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda.launches}


def train_phase(tmp: Path) -> dict:
    rows, steps = 16, 4
    conf = zoo.TransformerLM(updater={"type": "adam", "lr": TRAIN_LR}, **FLAGSHIP_CONF)
    V, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    L, C, H = FLAGSHIP_CONF["n_blocks"], FLAGSHIP_CONF["d_model"], FLAGSHIP_CONF["n_heads"]
    (tmp / "conf.json").write_text(conf.to_json())
    x = np.random.RandomState(4).randint(0, V, (rows, T)).astype(np.int64)
    y = np.roll(x, -1, axis=1)
    np.savez(tmp / "d.npz", x=x, y=y)
    out_zip = tmp / "trained.zip"
    log = logging.getLogger("deeplearning4j_tpu_torch")
    handler = _ScoreLog()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats()
    n_spans = len(obs.recent_spans())

    # the main path: every launch below is counted
    fa.flash_fwd_cuda.launches = 0
    fa.flash_bwd_dq_cuda.launches = 0
    fa.flash_bwd_dkv_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        model = train_cli.run([str(tmp / "conf.json"), "--data", str(tmp / "d.npz"),
                               "--epochs", str(steps), "--batch-size", str(rows),
                               "--output", str(out_zip), "--listener-frequency", "1"])
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    run_s = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_walls = [s["wall_s"] for s in obs.recent_spans()[n_spans:]
                  if s["span"] == "mln.fit_batch"]

    scores = [s for _, s in handler.scores]
    check([i for i, _ in handler.scores] == list(range(1, steps + 1)),
          f"scores logged for iterations {[i for i, _ in handler.scores]}")
    check(all(np.isfinite(scores)), f"non-finite loss: {scores}")
    # the loss sums over 2048 positions (~1.6e4, where a bf16 ulp is 128)
    check(scores[-1] < scores[0] - 128.0, f"the loss did not fall: {scores}")
    for name, n in launches.items():
        check(n == 8 * steps, f"{name}: {n} launches over {steps} steps, not 8 per step")

    # the zip restores to the same params and the same output
    restored = restore_network(str(out_zip))
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(model.params),
                                                tree_leaves(restored.params))),
          "restored params differ from the trained model's")
    x2 = x[:2]
    restore_diff = (model.output(x2).float() - restored.output(x2).float()).abs().max().item()
    check(restore_diff == 0.0, f"restored output differs by {restore_diff}")
    zip_bytes = out_zip.stat().st_size
    del restored
    gc.collect()
    torch.cuda.empty_cache()

    # step time after a warm step, then one step timed in phases (the
    # phases are what _value_and_grad and _update_params run)
    xt, yt = torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")
    model._fit_batch(xt, yt, None, None)
    torch.cuda.synchronize()
    timed = 3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(timed):
        model._fit_batch(xt, yt, None, None)
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / timed
    ph = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = tree_leaves(model.params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    ph[0].record()
    loss, _ = model._loss(tree_unflatten_like(model.params, live), model.state, xt, yt,
                          None, None, model._gen)
    ph[1].record()
    grads = torch.autograd.grad(loss, live)
    ph[2].record()
    model._update_params(tree_unflatten_like(model.params, list(grads)))
    ph[3].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ph[i].elapsed_time(ph[i + 1]) for i in range(3))

    grad_check = grads_vs_plain_backward(model, xt[:GRAD_CHECK_ROWS], yt[:GRAD_CHECK_ROWS])

    tokens = rows * T
    n_params = model.num_params()
    pairs = T * (T + 1) // 2
    # 6 N per token for the GEMMs (embedding and head included), and the
    # attention products of the model: 2 forward, 4 backward per block
    attn_flops = 6 * 2.0 * rows * H * pairs * (C // H) * L
    flops = 6.0 * n_params * tokens + attn_flops
    return {
        "phase": "train",
        "model": {"vocab": V, "T": T, "d_model": C, "heads": H, "blocks": L,
                  "dtype": "bfloat16", "params": n_params},
        "entry": "python -m deeplearning4j_tpu_torch.train (in-process)",
        "updater": {"type": "adam", "lr": TRAIN_LR}, "rows": rows, "steps": steps,
        "loss": scores, "launches": launches, "run_s": run_s,
        "step_wall_s": step_walls, "zip_bytes": zip_bytes,
        "restore_max_abs_diff": restore_diff,
        "step_ms": step_ms,
        "split_ms": {"forward": fwd_ms, "backward": bwd_ms, "update": upd_ms},
        "tokens_per_s": tokens / (step_ms / 1e3),
        "flops_per_step": flops, "attention_flops_per_step": attn_flops,
        "achieved_tflops": flops / step_ms / 1e9,
        "peak_share": flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
        "max_memory_allocated_bytes": peak,
        "grads_kernels_vs_plain_backward": grad_check,
    }


def _param_grads(model, x, y) -> list:
    """Gradients of the training loss with respect to every parameter, the
    model's generator restored afterwards so a second call sees the same
    randomness."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(model.params)]
    rng = model._gen.get_state()
    loss, _ = model._loss(tree_unflatten_like(model.params, live), model.state, x, y,
                          None, None, model._gen)
    model._gen.set_state(rng)
    return list(torch.autograd.grad(loss, live))


def grads_vs_plain_backward(model, x, y, tol: float = GRAD_CHECK_REL) -> dict:
    """The model's parameter gradients on one batch with kernels #2/#3 as the
    attention backward, and again with flash_attention_bwd_reference in
    their place (same weights, same batch): per tensor ||diff|| / ||ref||,
    held to ``tol``. Outside the counted main path."""
    got = _param_grads(model, x, y)
    kernels = fa.flash_bwd_cuda
    fa.flash_bwd_cuda = (lambda q, k, v, out, lse, do, kmask=None, causal=False:
                         fa.flash_attention_bwd_reference(q, k, v, out, lse, do, kmask, causal))
    try:
        want = _param_grads(model, x, y)
    finally:
        fa.flash_bwd_cuda = kernels
    rel = [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
           for a, b in zip(got, want)]
    res = {"rows": int(x.shape[0]), "tensors": len(rel), "max_rel_norm_diff": max(rel),
           "median_rel_norm_diff": float(np.median(rel)), "rel_norm_diff": rel,
           "tol": tol}
    check(max(rel) <= tol,
          f"parameter gradients with kernels #2/#3 differ from the plain backward's: {res}")
    torch.cuda.empty_cache()
    return res


# -- phase 7: the LSTM kernels -------------------------------------------------

def lstm_inputs(B, T, H, dtype, seed, peep=True, mask=None):
    """Kernel #4/#5 operands on the card from a seed: zx and carries of
    order 0.5, Wh scaled so h·Wh is of order 1, nonzero h0, c0, output
    cotangent, dh_T and dc_T. ``mask``: None, or "varlen" (random lengths,
    row 0 masked at every step)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    ins = {"zx": rnd(B, T, 4 * H, scale=0.5).to(dtype),
           "wh": rnd(H, 4 * H, scale=H ** -0.5).to(dtype),
           "h0": rnd(B, H, scale=0.5).to(dtype), "c0": rnd(B, H, scale=0.5).to(dtype),
           "peephole": rnd(3 * H, scale=0.3).to(dtype) if peep else None,
           "mask": None, "dout": rnd(B, T, H), "dhT": rnd(B, H), "dcT": rnd(B, H)}
    if mask == "varlen":
        lens = torch.randint(1, T + 1, (B,), generator=g, device="cuda")
        lens[0] = 0
        ins["mask"] = (torch.arange(T, device="cuda")[None, :] < lens[:, None]).float()
    return ins


def _step_rel_err(got, want) -> float:
    """Worst ||got_t - want_t|| / (||want_t|| + BWD_TILE_ATOL * sqrt(n)) over
    the time steps t of [B, T, ...] tensors."""
    d = (got.float() - want.float()).transpose(0, 1).reshape(want.shape[1], -1)
    w = want.float().transpose(0, 1).reshape(want.shape[1], -1)
    den = w.norm(dim=1) + BWD_TILE_ATOL * w.shape[1] ** 0.5
    return (d.norm(dim=1) / den).max().item()


def _lstm_close(name, got, want, dtype, res) -> bool:
    """One tensor against its plain version: f32 elementwise within
    TOL[f32]; bf16 and f16 within LSTM_LIMITS' share of max |ref| per tensor
    and, for tensors with a time axis, its share per step."""
    a, b = got.float(), want.float()
    err = (a - b).abs().max().item() if b.numel() else 0.0
    res[f"{name}_max_abs_err"] = err
    if dtype == torch.float32:
        tol = TOL[torch.float32]
        worst = ((a - b).abs() - tol["rtol"] * b.abs()).max().item()
        res[f"{name}_excess"] = worst - tol["atol"]
        return worst <= tol["atol"]
    rel, step_rel = LSTM_LIMITS[dtype]
    res[f"{name}_rel_err"] = err / max(b.abs().max().item(), 1e-30)
    ok = err <= rel * b.abs().max().item()
    if b.dim() == 3:
        step = _step_rel_err(a, b)
        res[f"{name}_step_rel_err"] = step
        ok = ok and step <= step_rel
    return ok


def _lstm_control(args, bargs, want, bwant, dtype) -> dict:
    """The control of a 16-bit case: the plain versions with h and dz
    rounded to bfloat16 in place of float16, held to the same limits. It
    must fail them, or they could not tell such a kernel from a right one."""
    got = fl.fused_lstm_reference(*args, round_to=torch.bfloat16)
    bgot = fl.fused_lstm_bwd_reference(*bargs, round_to=torch.bfloat16)
    res = {}
    ok = True
    for name, a, b in zip(("hs", "gates", "cs", "hT", "cT", "dzx", "dwh", "dh0", "dc0",
                           "dpeep"), got + bgot, want + bwant):
        if b is not None:
            ok &= _lstm_close(name, a, b, dtype, res)
    res = {k: v for k, v in res.items() if k.endswith("_rel_err")}
    res["passes_the_limits"] = bool(ok)
    return res


def compare_lstm(case: dict) -> dict:
    """Kernels #4 and #5 against their plain versions on the same inputs:
    the forward's outputs, then the backward's from the same residuals."""
    B, T, H, dtype = case["B"], case["T"], case["H"], case["dtype"]
    ins = lstm_inputs(B, T, H, dtype, case["seed"], case["peep"], case["mask"])
    args = (ins["zx"], ins["wh"], ins["h0"], ins["c0"], ins["mask"], ins["peephole"])
    got = fl.fused_lstm_fwd_cuda(*args)
    torch.cuda.synchronize()
    want = fl.fused_lstm_reference(*args)
    res = {"B": B, "T": T, "H": H, "dtype": str(dtype).split(".")[-1],
           "peephole": case["peep"], "mask": case["mask"],
           "route": {k: list(fl.lstm_route(H, dtype, k)) for k in ("fwd", "bwd")}}
    ok = True
    for name, a, b in zip(("hs", "gates", "cs", "hT", "cT"), got, want):
        ok &= _lstm_close(name, a, b, dtype, res)
    hs, gates, cs = got[:3]
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, ins["h0"], ins["c0"], ins["mask"],
                                           ins["dout"], ins["dhT"])
    bargs = (gates, cs, cprev, hprev, ins["wh"], m, dhs, ins["dcT"], ins["peephole"])
    bgot = fl.fused_lstm_bwd_cuda(*bargs)
    torch.cuda.synchronize()
    bwant = fl.fused_lstm_bwd_reference(*bargs)
    for name, a, b in zip(("dzx", "dwh", "dh0", "dc0", "dpeep"), bgot, bwant):
        if b is not None:
            ok &= _lstm_close(name, a, b, dtype, res)
    # a second run of the backward repeats bit for bit (no atomics)
    again = fl.fused_lstm_bwd_cuda(*bargs)
    res["bwd_repeats_bitwise"] = all(torch.equal(a, b) for a, b in zip(bgot, again)
                                     if a is not None)
    ok &= res["bwd_repeats_bitwise"]
    if dtype == torch.float16:
        res["control_h_dz_rounded_to_bf16"] = _lstm_control(args, bargs, want, bwant, dtype)
        ok &= not res["control_h_dz_rounded_to_bf16"]["passes_the_limits"]
    res["ok"] = bool(ok)
    return res


def lstm_bound(B, T, H, elem_bytes, kernel, peep=True):
    """(bound_ms, bound_by, flops, bytes) of one launch at these shapes: the
    recurrent products (one forward, two backward) at the f32 FMA or bf16
    tensor-core peak, and every input read once and output written once
    (obs/profile.py lstm_cost)."""
    peak = PEAK_F32_FLOPS if elem_bytes == 4 else PEAK_BF16_FLOPS
    flops, nbytes = profile.lstm_cost(B, T, H, elem_bytes, kernel, peep)
    return (*profile.bound(flops, nbytes, peak, PEAK_BYTES), flops, nbytes)


def time_device(fn, iters: int) -> float:
    """Device time of one call (ms) over back-to-back calls whose host side
    takes longer than their kernels: a sleep kernel keeps the card busy while
    the host queues the events and the calls, so the events time the
    kernels alone (CUDA events, not the host clock)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)   # ~25 ms of device time at H100 clocks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us_per_call(fn, iters: int = 200) -> float:
    """Host time of one wrapper call (us): back-to-back calls on the host
    clock, no synchronisation between them (the kernels are shorter)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def lstm_kernel_phase() -> dict:
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    sh = LSTM_SHAPE
    cases = [dict(sh, dtype=dt, peep=p, mask=None, seed=40 + i)
             for i, (dt, p) in enumerate(((f32, True), (f32, False), (bf16, True),
                                          (bf16, False), (f16, True)))]
    cases += [
        dict(B=1, T=1, H=256, dtype=f32, peep=True, mask=None, seed=50),   # rnn_time_step
        dict(B=1, T=1, H=256, dtype=bf16, peep=True, mask=None, seed=51),
        dict(B=32, T=1, H=256, dtype=f32, peep=True, mask=None, seed=52),  # sampling batch
        dict(B=5, T=37, H=256, dtype=f32, peep=True, mask="varlen", seed=53),
        dict(B=5, T=37, H=256, dtype=bf16, peep=False, mask="varlen", seed=54),
        dict(B=33, T=20, H=128, dtype=f32, peep=True, mask="varlen", seed=55),
        dict(B=33, T=20, H=128, dtype=bf16, peep=True, mask=None, seed=56),
        dict(B=9, T=4, H=128, dtype=f16, peep=True, mask="varlen", seed=57),
        dict(B=24, T=10, H=384, dtype=f32, peep=True, mask="varlen", seed=58),
        dict(B=24, T=10, H=384, dtype=bf16, peep=True, mask=None, seed=59),
        dict(B=40, T=12, H=512, dtype=f32, peep=True, mask="varlen", seed=60),
        dict(B=40, T=12, H=512, dtype=bf16, peep=False, mask=None, seed=61),
        dict(B=20, T=8, H=640, dtype=f32, peep=True, mask="varlen", seed=62),
        dict(B=20, T=8, H=640, dtype=bf16, peep=True, mask=None, seed=63),
        dict(B=20, T=6, H=1024, dtype=f32, peep=False, mask=None, seed=64),
        dict(B=20, T=6, H=1024, dtype=bf16, peep=True, mask="varlen", seed=65),
        # 38 clusters of 8 rows: more than run at once, so clusters queue
        dict(B=300, T=6, H=256, dtype=f32, peep=False, mask="varlen", seed=66),
        dict(B=300, T=6, H=256, dtype=bf16, peep=True, mask=None, seed=67),
        # past H = 1024: the step route, one launch a step
        dict(B=32, T=20, H=1152, dtype=f32, peep=True, mask="varlen", seed=68),
        dict(B=32, T=20, H=1152, dtype=bf16, peep=True, mask="varlen", seed=69),
        dict(B=32, T=20, H=2048, dtype=f32, peep=True, mask="varlen", seed=70),
        dict(B=32, T=20, H=2048, dtype=bf16, peep=True, mask="varlen", seed=71),
        dict(B=9, T=5, H=1152, dtype=f16, peep=True, mask="varlen", seed=72),
        dict(B=40, T=3, H=2048, dtype=f32, peep=False, mask=None, seed=73),
    ]
    results = [compare_lstm(c) for c in cases]
    bad = [r for r in results if not r["ok"]]
    check(not bad, f"LSTM kernels disagree with their plain versions: {bad}")

    # timings at the char-RNN shape, f32 with peepholes (one GravesLSTM layer)
    B, T, H = sh["B"], sh["T"], sh["H"]
    ins = lstm_inputs(B, T, H, f32, 60)
    args = (ins["zx"], ins["wh"], ins["h0"], ins["c0"], None, ins["peephole"])
    fwd_ms = time_cuda(lambda: fl.fused_lstm_fwd_cuda(*args), iters=20)
    plain_fwd_ms = time_cuda(lambda: fl.fused_lstm_reference(*args), iters=5, warmup=1)
    hs, gates, cs, _, _ = fl.fused_lstm_fwd_cuda(*args)
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, ins["h0"], ins["c0"], None,
                                           ins["dout"], ins["dhT"])
    bargs = (gates, cs, cprev, hprev, ins["wh"], m, dhs, ins["dcT"], ins["peephole"])
    bwd_ms = time_cuda(lambda: fl.fused_lstm_bwd_cuda(*bargs), iters=20)
    plain_bwd_ms = time_cuda(lambda: fl.fused_lstm_bwd_reference(*bargs), iters=5,
                             warmup=1)
    bf = lstm_inputs(B, T, H, bf16, 61)
    bf_args = (bf["zx"], bf["wh"], bf["h0"], bf["c0"], None, bf["peephole"])
    bf_fwd_ms = time_cuda(lambda: fl.fused_lstm_fwd_cuda(*bf_args), iters=20)
    bf_hs, bf_gates, bf_cs, _, _ = fl.fused_lstm_fwd_cuda(*bf_args)
    bf_ops = fl.bwd_operands(bf_hs, bf_cs, bf["h0"], bf["c0"], None, bf["dout"], bf["dhT"])
    bf_bargs = (bf_gates, bf_cs, bf_ops[0], bf_ops[1], bf["wh"], bf_ops[2], bf_ops[3],
                bf["dcT"], bf["peephole"])
    bf_bwd_ms = time_cuda(lambda: fl.fused_lstm_bwd_cuda(*bf_bargs), iters=20)
    # the sampling shape: 32 rows, one step (rnn_time_step), f32
    sm = lstm_inputs(32, 1, H, f32, 62)
    sm_args = (sm["zx"], sm["wh"], sm["h0"], sm["c0"], None, sm["peephole"])
    sm_hs, sm_gates, sm_cs, _, _ = fl.fused_lstm_fwd_cuda(*sm_args)
    sm_cprev, sm_hprev, sm_m, sm_dhs = fl.bwd_operands(sm_hs, sm_cs, sm["h0"], sm["c0"], None,
                                                       sm["dout"], sm["dhT"])
    sm_bargs = (sm_gates, sm_cs, sm_cprev, sm_hprev, sm["wh"], sm_m, sm_dhs, sm["dcT"],
                sm["peephole"])
    sample_ms = time_device(lambda: fl.fused_lstm_fwd_cuda(*sm_args), iters=50)
    s_bound, s_by, s_flops, s_bytes = lstm_bound(32, 1, H, 4, "fwd")
    host_us = {"fused_lstm_fwd": host_us_per_call(lambda: fl.fused_lstm_fwd_cuda(*sm_args)),
               "fused_lstm_bwd": host_us_per_call(lambda: fl.fused_lstm_bwd_cuda(*sm_bargs))}
    # the nearest library call, as a yardstick only: cuDNN's LSTM over
    # x [B, T, 256] (its own input projection, no peepholes, no mask)
    lib = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x = torch.randn(B, T, H, device="cuda", requires_grad=True)
    lib_fwd_ms = time_cuda(lambda: lib(x), iters=20)
    y, _ = lib(x)
    dy = torch.randn_like(y)
    lib_bwd_ms = time_cuda(lambda: torch.autograd.grad(
        y, [x] + list(lib.parameters()), dy, retain_graph=True), iters=20)
    lib_fwdbwd_ms = time_cuda(lambda: torch.autograd.grad(
        lib(x)[0], [x] + list(lib.parameters()), dy), iters=20)
    timing = {"shape": [B, T, H], "dtype": "float32", "peephole": True,
              "route": {k: list(fl.lstm_route(H, f32, k)) for k in ("fwd", "bwd")},
              "plain_ms": {"fwd": plain_fwd_ms, "bwd": plain_bwd_ms},
              "bf16_fwd_ms": bf_fwd_ms, "bf16_bwd_ms": bf_bwd_ms,
              "sampling_B32_T1": {"kernel_ms": sample_ms, "bound_ms": s_bound,
                                  "bound_by": s_by, "flops": s_flops, "bytes": s_bytes,
                                  "timed": "CUDA events over 50 back-to-back launches "
                                           "queued behind a sleep kernel"},
              "host_us_per_call_B32_T1": host_us,
              "library": "torch.nn.LSTM (cuDNN), input 256 -> hidden 256, no "
                         "peepholes or mask, its input projection included: the "
                         "nearest yardstick, not the same function",
              "library_ms": {"fwd": lib_fwd_ms, "bwd": lib_bwd_ms,
                             "fwd_bwd": lib_fwdbwd_ms}}
    for name, ms in (("fwd", fwd_ms), ("bwd", bwd_ms)):
        b_ms, b_by, b_flops, b_bytes = lstm_bound(B, T, H, 4, name)
        timing[name] = {"kernel_ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                        "flops": b_flops, "bytes": b_bytes,
                        "achieved_tflops": b_flops / ms / 1e9,
                        "roofline_share": b_ms / ms}
    timing["step_route"] = lstm_step_timing()
    return {"phase": "lstm_kernel", "cases": results, "timing": timing,
            "tol": {"float32": TOL[f32], "step_atol_rms": BWD_TILE_ATOL, **{
                str(dt).split(".")[-1]: {"max_abs_err_over_max_abs_ref": rel,
                                         "step_rel_err": step_rel}
                for dt, (rel, step_rel) in LSTM_LIMITS.items()}}}


def lstm_step_timing() -> list:
    """Kernels #4 and #5 on the step route (H = 1152 and 2048, B = 32,
    T = 20, peepholes, f32 and bf16), each beside its bound, its plain
    version and cuDNN's LSTM (the nearest yardstick, not the same
    function)."""
    rows = []
    B, T = STEP_LSTM_SHAPE["B"], STEP_LSTM_SHAPE["T"]
    for H in (1152, 2048):
        for dt in (torch.float32, torch.bfloat16):
            ins = lstm_inputs(B, T, H, dt, 80 + H)
            args = (ins["zx"], ins["wh"], ins["h0"], ins["c0"], None, ins["peephole"])
            hs, gates, cs, _, _ = fl.fused_lstm_fwd_cuda(*args)
            cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, ins["h0"], ins["c0"], None,
                                                   ins["dout"], ins["dhT"])
            bargs = (gates, cs, cprev, hprev, ins["wh"], m, dhs, ins["dcT"], ins["peephole"])
            es = 4 if dt == torch.float32 else 2
            # the yardstick in f32 (cuDNN's LSTM takes no bf16)
            lib = torch.nn.LSTM(H, H, batch_first=True).cuda()
            x = torch.randn(B, T, H, device="cuda", requires_grad=True)
            y, _ = lib(x)
            dy = torch.randn_like(y)
            row = {"shape": [B, T, H], "dtype": str(dt).split(".")[-1], "peephole": True,
                   "route": {k: list(fl.lstm_route(H, dt, k)) for k in ("fwd", "bwd")},
                   "fwd_ms": time_cuda(lambda: fl.fused_lstm_fwd_cuda(*args), 10),
                   "bwd_ms": time_cuda(lambda: fl.fused_lstm_bwd_cuda(*bargs), 10),
                   "plain_fwd_ms": time_cuda(lambda: fl.fused_lstm_reference(*args), 3,
                                             warmup=1),
                   "plain_bwd_ms": time_cuda(lambda: fl.fused_lstm_bwd_reference(*bargs), 3,
                                             warmup=1),
                   "library_fwd_ms": (time_cuda(lambda: lib(x), 10)
                                      if dt == torch.float32 else None),
                   "library_bwd_ms": (time_cuda(lambda: torch.autograd.grad(
                       y, [x] + list(lib.parameters()), dy, retain_graph=True), 10)
                                      if dt == torch.float32 else None),
                   "library": "torch.nn.LSTM (cuDNN) H -> H in f32, its input "
                              "projection included, no peepholes or mask"}
            for name in ("fwd", "bwd"):
                row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = lstm_bound(
                    B, T, H, es, name)[:2]
            rows.append(row)
            del ins, args, hs, gates, cs, cprev, hprev, m, dhs, bargs, lib, x, y, dy
    torch.cuda.empty_cache()
    return rows


def _lstm_launches():
    return {"fused_lstm_fwd": fl.fused_lstm_fwd_cuda.launches,
            "fused_lstm_bwd": fl.fused_lstm_bwd_cuda.launches}


def _zero_lstm_counts():
    fl.fused_lstm_fwd_cuda.launches = 0
    fl.fused_lstm_bwd_cuda.launches = 0


def lstm_small_phase() -> dict:
    """A tiny f32 TextGenerationLSTM (H=128) on the CPU (plain versions) and
    on the GPU (the kernels) from the same weights: the output, then 3 fit
    batches of tBPTT over T=12 in chunks of 4 with RMSProp (9 updates): the
    loss per batch, the final params and the exact launches."""
    tol = TOL[torch.float32]
    conf = zoo.TextGenerationLSTM(vocab_size=20, timesteps=12, hidden=128, seed=7)
    conf.tbptt_fwd_length = conf.tbptt_back_length = 4
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    gpu = params_from_numpy(MultiLayerNetwork(conf), params_to_numpy(cpu))
    ids = np.random.RandomState(5).randint(0, 20, (6, 12))
    eye = np.eye(20, dtype=np.float32)
    x, y = eye[ids], eye[np.roll(ids, -1, axis=1)]
    before = _lstm_launches()
    got = gpu.output(x).cpu()
    out_launches = {k: v - before[k] for k, v in _lstm_launches().items()}
    want = cpu.output(x)
    out_err = (got - want).abs().max().item()
    scores, launches = {}, {}
    for name, m in (("cpu", cpu), ("gpu", gpu)):
        lis = CollectScoresListener()
        m.set_listeners(lis)
        before = _lstm_launches()
        m.fit((x, y), epochs=3)
        torch.cuda.synchronize()
        launches[name] = {k: v - before[k] for k, v in _lstm_launches().items()}
        scores[name] = [s for _, s in lis.scores]
    gp = [p.cpu() for p in tree_leaves(gpu.params)]
    cp = tree_leaves(cpu.params)
    param_err = max((a - b).abs().max().item() for a, b in zip(gp, cp))
    ok = (bool(torch.allclose(got, want, **tol))
          and out_launches == {"fused_lstm_fwd": 2, "fused_lstm_bwd": 0}
          and bool(np.allclose(scores["gpu"], scores["cpu"], **tol))
          and all(torch.allclose(a, b, **tol) for a, b in zip(gp, cp))
          and launches["cpu"] == {"fused_lstm_fwd": 0, "fused_lstm_bwd": 0}
          and launches["gpu"] == {"fused_lstm_fwd": 18, "fused_lstm_bwd": 18}
          and gpu.iteration == cpu.iteration == 9)
    res = {"phase": "lstm_small", "dtype": "float32", "hidden": 128, "T": 12,
           "tbptt": 4, "output_max_abs_err": out_err, "output_launches": out_launches,
           "loss_cpu": scores["cpu"], "loss_gpu": scores["gpu"],
           "param_max_abs_err": param_err, "fit_launches": launches, "tol": tol, "ok": ok}
    check(ok, f"GPU and CPU disagree on the tiny TextGenerationLSTM: {res}")
    return res


def lstm_train_phase(tmp: Path) -> dict:
    """The char-RNN at full width through the trainer CLI, in-process."""
    V, T, H = LSTM_CONF["vocab_size"], LSTM_CONF["timesteps"], LSTM_CONF["hidden"]
    rows, steps, batch, epochs = 256, 200, 128, 2
    conf = zoo.TextGenerationLSTM(**LSTM_CONF)
    (tmp / "lstm.json").write_text(conf.to_json())
    ids = np.random.RandomState(8).randint(0, V, (rows, steps))
    eye = np.eye(V, dtype=np.float32)
    np.savez(tmp / "chars.npz", x=eye[ids], y=eye[np.roll(ids, -1, axis=1)])
    out_zip = tmp / "lstm.zip"
    log = logging.getLogger("deeplearning4j_tpu_torch")
    handler = _ScoreLog()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats()

    # the main path: every launch below is counted
    _zero_lstm_counts()
    t0 = time.perf_counter()
    try:
        model = train_cli.run([str(tmp / "lstm.json"), "--data", str(tmp / "chars.npz"),
                               "--epochs", str(epochs), "--batch-size", str(batch),
                               "--output", str(out_zip), "--listener-frequency", "1"])
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    run_s = time.perf_counter() - t0
    launches = _lstm_launches()
    peak = torch.cuda.max_memory_allocated()

    chunks = epochs * (rows // batch) * (steps // T)
    scores = [s for _, s in handler.scores]
    check(model.iteration == chunks, f"{model.iteration} updates, expected {chunks}")
    check(len(scores) == epochs * rows // batch and all(np.isfinite(scores)),
          f"scores {handler.scores}")
    check(scores[-1] < scores[0], f"the loss did not fall: {scores}")
    for name, n in launches.items():
        check(n == 2 * chunks, f"{name}: {n} launches over {chunks} tBPTT chunks, not 2 each")

    restored = restore_network(str(out_zip))
    x2 = torch.as_tensor(eye[ids[:2, :T]], device="cuda")
    restore_diff = (model.output(x2) - restored.output(x2)).abs().max().item()
    check(restore_diff == 0.0, f"restored output differs by {restore_diff}")

    # one step at bench.py's shape (128 x 50) after a warm step, then one
    # step timed in phases (what _value_and_grad and _update_params run)
    xt = torch.as_tensor(eye[ids[:batch, :T]], device="cuda")
    yt = torch.as_tensor(eye[np.roll(ids, -1, axis=1)[:batch, :T]], device="cuda")
    model._fit_tbptt(xt, yt, None, None)
    torch.cuda.synchronize()
    timed = 10
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(timed):
        model._fit_tbptt(xt, yt, None, None)
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / timed
    ph = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    live = [p.detach().requires_grad_(True) for p in tree_leaves(model.params)]
    ph[0].record()
    loss, _ = model._loss(tree_unflatten_like(model.params, live), model.state, xt, yt,
                          None, None, model._gen, carries=model._initial_carries(batch))
    ph[1].record()
    grads = torch.autograd.grad(loss, live)
    ph[2].record()
    model._update_params(tree_unflatten_like(model.params, list(grads)))
    ph[3].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ph[i].elapsed_time(ph[i + 1]) for i in range(3))
    return {
        "phase": "lstm_train",
        "model": {"vocab": V, "T": T, "hidden": H, "layers": "2 x GravesLSTM",
                  "dtype": "float32", "params": model.num_params()},
        "entry": "python -m deeplearning4j_tpu_torch.train (in-process)",
        "updater": conf.updater, "rows": rows, "steps_per_row": steps,
        "batch": batch, "epochs": epochs, "tbptt_chunks": chunks,
        "loss": scores, "launches": launches, "run_s": run_s,
        "restore_max_abs_diff": restore_diff,
        "max_memory_allocated_bytes": peak,
        "step_128x50": {"step_ms": step_ms,
                        "split_ms": {"forward": fwd_ms, "backward": bwd_ms,
                                     "update": upd_ms},
                        "tokens_per_s": batch * T / (step_ms / 1e3)},
        "zip": str(out_zip),
    }


def lstm_sample_phase(zip_path: str) -> dict:
    """Sampling from the trained zip: prime 32 rows with 50 steps, then 100
    rnn_time_step calls of one step each, the next character by argmax."""
    V, T = LSTM_CONF["vocab_size"], LSTM_CONF["timesteps"]
    rows, n_steps = 32, 100
    model = restore_network(zip_path)
    eye = torch.eye(V, device="cuda")
    prime = eye[torch.as_tensor(np.random.RandomState(9).randint(0, V, (rows, T)),
                                device="cuda")]

    # the main path: every launch below is counted
    _zero_lstm_counts()
    model.rnn_clear_previous_state()
    outs = [model.rnn_time_step(prime)]
    inputs = [prime]
    per_call = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        before = fl.fused_lstm_fwd_cuda.launches
        nxt = eye[outs[-1][:, -1].argmax(-1) if outs[-1].dim() == 3
                  else outs[-1].argmax(-1)]
        inputs.append(nxt[:, None])
        outs.append(model.rnn_time_step(nxt))
        per_call.append(fl.fused_lstm_fwd_cuda.launches - before)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    launches = _lstm_launches()
    check(launches == {"fused_lstm_fwd": 2 * (n_steps + 1), "fused_lstm_bwd": 0},
          f"sampling launches {launches}")
    check(set(per_call) == {2}, f"launches per rnn_time_step call: {sorted(set(per_call))}")

    stepped = torch.cat([outs[0]] + [o[:, None] for o in outs[1:]], dim=1)
    full = model.output(torch.cat(inputs, dim=1))
    tol = TOL[torch.float32]
    err = (stepped - full).abs().max().item()
    check(tuple(stepped.shape) == (rows, T + n_steps, V)
          and bool(torch.isfinite(stepped).all()), f"stepped outputs {tuple(stepped.shape)}")
    check(bool(torch.allclose(stepped, full, **tol)),
          f"stepped outputs differ from the full forward by {err}")
    # host-clock time of one sampling step, its device time by CUDA events
    x1 = inputs[-1][:, 0]
    step_ms = time_cuda(lambda: model.rnn_time_step(x1), iters=50, warmup=5)
    return {"phase": "lstm_sample", "rows": rows, "prime_steps": T, "steps": n_steps,
            "launches": launches, "launches_per_call": 2,
            "stepped_vs_full_max_abs_err": err, "tol": tol,
            "step_wall_ms": step_s * 1e3, "step_ms_cuda_events": step_ms}


# -- phases 11-13 -------------------------------------------------------------

def _all_launches():
    return {**_launch_counts(), **_lstm_launches()}


def _lenet_images(n, seed, hw=28, channels=1):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, hw, hw, channels).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, n)]
    return x, y


def cnn_train_phase(tmp: Path) -> dict:
    """LeNet-5 at bench_lenet5's shape through the trainer CLI, in-process:
    CNN_ROWS synthetic 28 x 28 x 1 images (pixels in [0, 1) from a numpy
    seed) with random one-hot labels, batch 256, CNN_EPOCHS epochs,
    ``--evaluate`` and the output zip. No hand-written kernel is on this
    path: the convolutions and pooling run in cuDNN, the dense layers in
    cuBLAS (TF32 off)."""
    conf = zoo.LeNet5()   # f32, Adam 1e-3, seed 12345
    (tmp / "lenet.json").write_text(conf.to_json())
    x, y = _lenet_images(CNN_ROWS, 21)
    np.savez(tmp / "images.npz", x=x, y=y)
    out_zip = tmp / "lenet.zip"
    log = logging.getLogger("deeplearning4j_tpu_torch")
    handler = _ScoreLog()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    torch.cuda.reset_peak_memory_stats()
    printed = io.StringIO()
    before = _all_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            model = train_cli.run([str(tmp / "lenet.json"), "--data", str(tmp / "images.npz"),
                                   "--epochs", str(CNN_EPOCHS), "--batch-size", str(CNN_BATCH),
                                   "--output", str(out_zip), "--listener-frequency", "1",
                                   "--evaluate"])
            torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    per_epoch = CNN_ROWS // CNN_BATCH
    scores = [sc for _, sc in handler.scores]
    check([i for i, _ in handler.scores] == list(range(1, CNN_EPOCHS * per_epoch + 1)),
          f"scores logged for iterations {[i for i, _ in handler.scores]}")
    check(all(np.isfinite(scores)), f"non-finite loss: {scores}")
    loss_per_epoch = [float(np.mean(scores[e * per_epoch:(e + 1) * per_epoch]))
                      for e in range(CNN_EPOCHS)]
    check(loss_per_epoch[-1] < loss_per_epoch[0], f"the loss did not fall: {loss_per_epoch}")
    # each iteration's score is logged after the host read it back (a
    # synchronisation), so the log times bound each epoch on the host clock
    stamps = handler.stamps
    last_epoch_s = stamps[-1] - stamps[-per_epoch - 1]
    accuracy_line = next(line.strip() for line in printed.getvalue().splitlines()
                         if "Accuracy:" in line)
    check(_all_launches() == before, "a hand-written kernel ran on the LeNet-5 path")

    restored = restore_network(str(out_zip))
    x2 = torch.as_tensor(x[:8], device="cuda")
    restore_diff = (model.output(x2) - restored.output(x2)).abs().max().item()
    check(restore_diff == 0.0, f"restored output differs by {restore_diff}")
    del restored

    # one step at 256 rows (CUDA events over 10 after a warm one), then one
    # step timed in phases (what _value_and_grad and _update_params run)
    xt = torch.as_tensor(x[:CNN_BATCH], device="cuda")
    yt = torch.as_tensor(y[:CNN_BATCH], device="cuda")
    model._fit_batch(xt, yt, None, None)
    torch.cuda.synchronize()
    step_ms = time_cuda(lambda: model._fit_batch(xt, yt, None, None), iters=10, warmup=0)
    ph = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    live = [p.detach().requires_grad_(True) for p in tree_leaves(model.params)]
    ph[0].record()
    loss, _ = model._loss(tree_unflatten_like(model.params, live), model.state, xt, yt,
                          None, None, model._gen)
    ph[1].record()
    grads = torch.autograd.grad(loss, live)
    ph[2].record()
    model._update_params(tree_unflatten_like(model.params, list(grads)))
    ph[3].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ph[i].elapsed_time(ph[i + 1]) for i in range(3))
    return {
        "phase": "cnn_train",
        "model": {"name": "LeNet5", "input": [28, 28, 1], "dtype": "float32",
                  "params": model.num_params()},
        "entry": "python -m deeplearning4j_tpu_torch.train lenet.json --data images.npz "
                 "--evaluate (in-process)",
        "updater": conf.updater, "rows": CNN_ROWS, "batch": CNN_BATCH, "epochs": CNN_EPOCHS,
        "loss": scores, "loss_per_epoch": loss_per_epoch, "run_s": run_s,
        "last_epoch_s": last_epoch_s,
        "samples_per_s_last_epoch": CNN_ROWS / last_epoch_s,
        "evaluation": accuracy_line,
        "restore_max_abs_diff": restore_diff,
        "step_256": {"step_ms": step_ms,
                     "split_ms": {"forward": fwd_ms, "backward": bwd_ms, "update": upd_ms},
                     "samples_per_s": CNN_BATCH / (step_ms / 1e3)},
        "max_memory_allocated_bytes": peak,
        "zip": str(out_zip),
    }


def cnn_serve_phase(zip_path: str) -> dict:
    """The trained LeNet-5 zip restored into ModelRegistry behind
    InferenceServer: one request of 1 x 28 x 28 x 1 integer pixels 0-255,
    one of 8 float images, then 4 concurrent requests of 2 images that
    coalesce; every response row against ``output`` on the same rows."""
    model = restore_network(zip_path)
    registry = ModelRegistry(config=ServeConfig(
        max_batch=16, queue_limit=64, max_wait_s=0.1, default_deadline_s=600.0))
    registry.register("lenet", model)
    server = InferenceServer(registry).start(port=0)
    worker = registry.worker("lenet")
    rs = np.random.RandomState(22)
    pix = rs.randint(0, 256, (1, 28, 28, 1))
    eight = rs.rand(8, 28, 28, 1).astype(np.float32)
    pairs = [rs.rand(2, 28, 28, 1).astype(np.float32) for _ in range(4)]
    errs = {}
    try:
        def served(x, what):
            status, body, lat = post_predict(server.port, "lenet", x.tolist(), 600000.0)
            check(status == 200, f"{what}: HTTP status {status}")
            got = np.asarray(body["outputs"], np.float32)
            want = model.output(np.asarray(x, np.float32)).float().cpu().numpy()
            check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
            err = float(np.abs(got - want).max())
            check(bool(np.all(np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want))),
                  f"{what}: served rows differ from output() by {err}")
            errs[what] = err
            return lat

        lat_int = served(pix, "1x28x28x1 integer pixels")
        lat_8 = served(eight, "8x28x28x1 floats")
        before = worker.stats()["batches"]
        lat_pairs = run_concurrently(lambda i: served(pairs[i], f"2 rows, request {i}"),
                                     [(i,) for i in range(len(pairs))])
        dispatches = worker.stats()["batches"] - before
        check(dispatches < len(pairs),
              f"{len(pairs)} concurrent requests took {dispatches} dispatches")
    finally:
        server.stop()
    return {"phase": "cnn_serve", "model": "LeNet5 (the cnn_train zip)",
            "latency_s": {"int_pixels_1x28x28x1": lat_int, "floats_8x28x28x1": lat_8,
                          "concurrent_2x28x28x1": sorted(lat_pairs)},
            "concurrent_dispatches": dispatches, "max_abs_err_vs_output": errs,
            "tol": {"rtol": 1e-4, "atol": 1e-5}}


def simplecnn_phase() -> dict:
    """SimpleCNN (48 x 48 x 3, BatchNorm, dropout) fitted 4 steps at batch 64
    on the card: BatchNorm's running statistics moved and are finite, eval
    mode repeats bit for bit, and the card's eval output matches the same
    params and state on the CPU (f32, TF32 off); then the forward at batch
    256 (CUDA events)."""
    conf = zoo.SimpleCNN()   # Adam 1e-3, seed 12345
    model = MultiLayerNetwork(conf).init()
    x, y = _lenet_images(256, 23, hw=48, channels=3)
    listener = CollectScoresListener()
    model.set_listeners(listener)
    model.fit((x, y), epochs=1, batch_size=64)
    torch.cuda.synchronize()
    scores = [sc for _, sc in listener.scores]
    check(model.iteration == 4 and len(scores) == 4 and all(np.isfinite(scores)),
          f"{model.iteration} steps, scores {scores}")
    bn = [s for s in model.state if s]
    check(len(bn) == 4, f"{len(bn)} BatchNorm states")
    moved = [{"mean_max_abs": s["mean"].abs().max().item(),
              "var_max_abs_dev_from_1": (s["var"] - 1).abs().max().item()} for s in bn]
    check(all(torch.isfinite(t).all() for s in bn for t in s.values()),
          "non-finite BatchNorm statistics")
    check(all(m["mean_max_abs"] > 0 and m["var_max_abs_dev_from_1"] > 0 for m in moved),
          f"BatchNorm statistics did not move: {moved}")
    xe = torch.as_tensor(x[:64], device="cuda")
    out1, out2 = model.output(xe), model.output(xe)
    check(torch.equal(out1, out2), "eval-mode output does not repeat bit for bit")
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    params_from_numpy(cpu, params_to_numpy(model))
    state_from_numpy(cpu, state_to_numpy(model))
    ref = cpu.output(x[:64])
    got = out1.cpu()
    err = (got - ref).abs()
    tol = SIMPLECNN_TOL["atol_of_max"] * ref.abs().max().item()
    check(bool((err <= tol + SIMPLECNN_TOL["rtol"] * ref.abs()).all()),
          f"SimpleCNN on the card differs from the CPU by {err.max().item()}")
    x256 = torch.as_tensor(x, device="cuda")
    fwd_ms = time_cuda(lambda: model.output(x256), iters=10)
    return {"phase": "simplecnn",
            "model": {"name": "SimpleCNN", "input": [48, 48, 3], "dtype": "float32",
                      "params": model.num_params()},
            "fit": {"batch": 64, "steps": model.iteration, "loss": scores},
            "batch_norm_moved": moved, "eval_repeats_bitwise": True,
            "card_vs_cpu_max_abs_err": err.max().item(), "tol": SIMPLECNN_TOL,
            "forward_ms_batch256": fwd_ms}


# -- phases 14-16: ComputationGraph -------------------------------------------

def _device_us(event) -> float:
    """An averaged profiler event's device time in microseconds (the
    attribute's name moved between torch releases)."""
    t = getattr(event, "device_time_total", None)
    return float(t if t is not None else getattr(event, "cuda_time_total", 0.0))


def graph_fwd_flops_per_example(cg) -> float:
    """2 * MACs of the convolutions and dense layers in one forward pass of
    one example, walked from the resolved graph's shapes (the analytic
    count bench.py's _graph_fwd_flops_per_example takes for ResNet50's
    MFU)."""
    total = 0.0
    for name in cg.topo_order:
        v = cg.rt[name]
        if not v.spec.is_layer():
            continue
        cfg, it, ot = v.config, v.input_types[0], cg.vertex_types[name]
        if isinstance(cfg, SeparableConv2D):
            kh, kw = cfg.kernel
            mid = it.channels * cfg.depth_multiplier
            total += 2.0 * ot.height * ot.width * mid * kh * kw
            total += 2.0 * ot.height * ot.width * ot.channels * mid
        elif isinstance(cfg, DepthwiseConv2D):
            kh, kw = cfg.kernel
            total += 2.0 * ot.height * ot.width * ot.channels * kh * kw
        elif type(cfg) is Conv2D:
            kh, kw = cfg.kernel
            total += 2.0 * ot.height * ot.width * ot.channels * kh * kw * it.channels
        elif type(cfg).__name__ in ("Dense", "OutputLayer"):
            total += 2.0 * it.flat_size() * cfg.n_out
    return total


def _resnet_images(n, seed):
    """bench.py's synthetic batch: numpy seed, pixels in [0, 1), one-hot
    labels over RESNET["classes"]."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, RESNET["size"], RESNET["size"], 3).astype(np.float32)
    y = np.eye(RESNET["classes"], dtype=np.float32)[rs.randint(0, RESNET["classes"], n)]
    return x, y


def resnet50_train_phase(tmp: Path) -> dict:
    """ResNet50 at bench.py's bench_resnet50 shape, unreduced: 224 x 224 x 3,
    1000 classes, batch 128, bf16, Adam 1e-3, seed 12345, the conv7 stem,
    on bench.py's synthetic images. RESNET_STEPS fit_batch steps through the
    public entry point (finite loss), then one step timed by CUDA events and
    split into forward / backward / update, images/s, MFU from the analytic
    forward count (3 x forward per trained image, at the dense bf16 peak),
    peak memory, and one profiled step: kernel time by name, the share in
    channels_last (NHWC) convolution kernels and the copies between vertices.
    Writes the trained zip for the serve phase."""
    conf = ResNet50(dtype="bfloat16")
    check(conf.seed == 12345 and conf.updater == {"type": "adam", "lr": 1e-3},
          f"ResNet50's defaults: seed {conf.seed}, updater {conf.updater}")
    torch.cuda.reset_peak_memory_stats()
    model = ComputationGraph(conf).init()
    x, y = _resnet_images(RESNET["batch"], 0)
    xt = torch.as_tensor(x, device="cuda").to(torch.bfloat16)
    yt = torch.as_tensor(y, device="cuda")
    losses = []
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        losses.append(model.fit_batch((xt, yt)))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), f"ResNet50 losses {losses}")
    check(model.iteration == RESNET_STEPS, f"{model.iteration} steps")
    bn = [s for s in model.state.values() if s]
    check(len(bn) == 53 and all(torch.isfinite(t).all() for s in bn for t in s.values()),
          f"{len(bn)} BatchNorm states, or one not finite")
    peak = torch.cuda.max_memory_allocated()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(RESNET_TIMED):
        model.fit_batch((xt, yt))
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / RESNET_TIMED
    inputs, labels, _, _ = model._to_device((xt,), (yt,), None, None)
    ph = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    live = {n: [t.detach().requires_grad_(True) for t in tree_leaves(p)]
            for n, p in model.params.items() if tree_leaves(p)}
    params = {n: tree_unflatten_like(p, live[n]) if n in live else p
              for n, p in model.params.items()}
    flat = [t for n in model.topo_order if n in live for t in live[n]]
    ph[0].record()
    loss, _ = model._loss(params, model.state, inputs, labels, None, None, model._gen)
    ph[1].record()
    grads_flat = torch.autograd.grad(loss, flat)
    ph[2].record()
    it = iter(grads_flat)
    grads = {n: (tree_unflatten_like(p, [next(it) for _ in live[n]]) if n in live else {})
             for n, p in model.params.items()}
    model._update_params(grads)
    ph[3].record()
    torch.cuda.synchronize()
    fwd_ms, bwd_ms, upd_ms = (ph[i].elapsed_time(ph[i + 1]) for i in range(3))
    del live, params, flat, grads_flat, grads, loss

    # one profiled step: where the device time goes, by kernel name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.fit_batch((xt, yt))
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the kernels themselves (operator and autograd rows repeat their time)
    rows = [(e.key, _device_us(e) / 1e3, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    check(rows, "the profiler saw no kernel in a ResNet50 step")
    total = sum(r[1] for r in rows)
    conv_rows = [r for r in rows if any(w in r[0].lower() for w in (
        "conv", "gemm", "xmma", "cudnn", "fprop", "dgrad", "wgrad", "cutlass"))]
    nhwc = [r for r in conv_rows if "nhwc" in r[0].lower()]
    nchw = [r for r in conv_rows if "nchw" in r[0].lower()]
    layout = [r for r in rows if "tonhwc" in r[0].lower() or "tonchw" in r[0].lower()]
    ops = {e.key: (e.count, _device_us(e) / 1e3) for e in events
           if e.key in ("aten::contiguous", "aten::copy_", "aten::clone",
                        "aten::convolution", "aten::convolution_backward")}
    top = sorted(rows, key=lambda r: -r[1])[:15]

    fwd_flops = graph_fwd_flops_per_example(model)
    ips = RESNET["batch"] / (step_ms / 1e3)
    zip_path = tmp / "resnet50.zip"
    save_network(model, str(zip_path))
    return {
        "phase": "resnet50_train",
        "model": {"name": "ResNet50", "stem": "conv7", "input": [224, 224, 3],
                  "classes": RESNET["classes"], "dtype": "bfloat16",
                  "params": model.num_params(), "vertices": len(model.topo_order),
                  "batch_norms": len(bn)},
        "entry": "ComputationGraph.fit_batch", "updater": conf.updater,
        "batch": RESNET["batch"], "steps": RESNET_STEPS, "loss": losses, "run_s": run_s,
        "step_ms": step_ms, "timed_steps": RESNET_TIMED,
        "split_ms": {"forward": fwd_ms, "backward": bwd_ms, "update": upd_ms},
        "images_per_s": ips,
        "analytic_fwd_gflops_per_image": fwd_flops / 1e9,
        "mfu_bf16_dense": 3.0 * fwd_flops * ips / PEAK_BF16_FLOPS,
        "max_memory_allocated_bytes": peak,
        "profile_one_step": {
            "kernel_ms_total": total,
            "conv_and_gemm_kernels_ms": sum(r[1] for r in conv_rows),
            "conv_kernels_nhwc_ms": sum(r[1] for r in nhwc),
            "conv_kernels_nchw_ms": sum(r[1] for r in nchw),
            "layout_conversion_kernels_ms": sum(r[1] for r in layout),
            "ops": {k: {"calls": c, "device_ms": t} for k, (c, t) in ops.items()},
            "top_kernels_ms": [{"name": n[:120], "ms": t, "calls": c} for n, t, c in top]},
        "zip": str(zip_path),
    }


def resnet50_serve_phase(zip_path: str) -> dict:
    """The trained ResNet50 zip through restore_network into ModelRegistry
    (max_batch 16, max_wait 0.1 s) behind InferenceServer: one HTTP :predict
    of 1 x 224 x 224 x 3 integer pixels, then 4 concurrent 2-image requests
    through ModelWorker.submit that must coalesce; each response against
    output() on the same rows. Then the same params and state as an f32
    graph, eval mode at batch 4, on the card and on the CPU (TF32 off)."""
    model = restore_network(zip_path)
    check(isinstance(model, ComputationGraph) and model.dtype == torch.bfloat16,
          f"restored {type(model).__name__} {model.dtype}")
    registry = ModelRegistry(config=ServeConfig(
        max_batch=16, queue_limit=64, max_wait_s=0.1, default_deadline_s=600.0))
    t0 = time.perf_counter()
    registry.register("resnet50", model)
    warm_s = time.perf_counter() - t0
    server = InferenceServer(registry).start(port=0)
    worker = registry.worker("resnet50")
    rs = np.random.RandomState(31)
    pix = rs.randint(0, 256, (1, 224, 224, 3))
    pairs = [rs.randint(0, 256, (2, 224, 224, 3)).astype(np.float32) for _ in range(4)]
    errs = {}
    tol = dict(rtol=0.0, atol=1e-6)   # the same rows, the same bucket: the same bits

    def same_as_output(got, x, what):
        want = model.output(np.asarray(x, np.float32)).float().cpu().numpy()
        check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
        check(bool(np.all(np.isfinite(got))) and np.allclose(got.sum(-1), 1.0, atol=1e-2),
              f"{what}: rows not finite probabilities")
        err = float(np.abs(got - want).max())
        errs[what] = err
        return err

    try:
        status, body, lat_int = post_predict(server.port, "resnet50", pix.tolist(), 600000.0)
        check(status == 200, f"integer pixels: HTTP status {status}")
        same_as_output(np.asarray(body["outputs"], np.float32), pix, "1x224x224x3 integers")
        before = worker.stats()["batches"]
        outs = run_concurrently(lambda i: worker.submit(pairs[i]), [(i,) for i in range(4)])
        dispatches = worker.stats()["batches"] - before
        check(dispatches < len(pairs),
              f"{len(pairs)} concurrent requests took {dispatches} dispatches")
        for i, o in enumerate(outs):
            same_as_output(np.asarray(o, np.float32), pairs[i], f"2 rows, request {i}")
    finally:
        server.stop()
        registry.shutdown()
    # the card against the CPU: the same params and state as an f32 graph
    x4 = _resnet_images(4, 32)[0]
    conf32 = ComputationGraphConfiguration.from_dict(dict(model.conf.to_dict(), dtype="float32"))
    card = ComputationGraph(conf32).init()
    cpu = ComputationGraph(conf32, device="cpu").init()
    for m in (card, cpu):
        params_from_numpy(m, params_to_numpy(model))
        state_from_numpy(m, state_to_numpy(model))
    got = card.output(x4).cpu()
    ref = cpu.output(x4)
    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()) and bool(
        (err <= RESNET_CPU_TOL["atol"] + RESNET_CPU_TOL["rtol"] * ref.abs()).all()),
        f"ResNet50 (f32) on the card differs from the CPU by {err.max().item()}")
    del card, cpu
    return {"phase": "resnet50_serve", "model": "ResNet50 (the resnet50_train zip, bf16)",
            "warm_s": warm_s, "latency_s": {"int_pixels_1x224x224x3": lat_int},
            "concurrent_dispatches": dispatches, "served_vs_output_max_abs_err": errs,
            "served_tol": tol,
            "card_vs_cpu_f32_batch4_max_abs_err": err.max().item(),
            "card_vs_cpu_tol": RESNET_CPU_TOL}


def seq2seq_conf(hidden, vocab, T, updater, seed=12345):
    """The seq2seq graph (tests/test_graph.py's wiring) at the char-RNN's
    widths: one-hot ``vocab`` on both inputs, encoder GravesLSTM(hidden) ->
    last_time_step -> duplicate_to_time_series over the decoder input ->
    merge -> decoder GravesLSTM(hidden) -> RnnOutputLayer(vocab), f32,
    tBPTT over T."""
    return (ComputationGraphConfiguration.builder()
            .add_inputs("enc_in", "dec_in")
            .set_input_types(InputType.recurrent(vocab, T), InputType.recurrent(vocab, T))
            .add_layer("enc", GravesLSTM(n_out=hidden, activation="tanh"), "enc_in")
            .add_vertex("last", LastTimeStepVertex(), "enc")
            .add_vertex("dup", DuplicateToTimeSeriesVertex(), "last", "dec_in")
            .add_vertex("merge", MergeVertex(), "dec_in", "dup")
            .add_layer("dec", GravesLSTM(n_out=hidden, activation="tanh"), "merge")
            .add_layer("out", RnnOutputLayer(n_out=vocab, activation="softmax", loss="mcxent"),
                       "dec")
            .set_outputs("out").updater(updater).seed(seed).tbptt(T).build())


@contextlib.contextmanager
def _no_plain_lstm_scan():
    """Any step of the plain LSTM scan (the cell the non-fused route runs)
    raises while this is active: on CUDA the graph must take kernels #4/#5."""
    saved = GravesLSTM._cell_from_proj

    def refuse(*a, **k):
        raise AssertionError("the plain LSTM scan ran on CUDA")

    GravesLSTM._cell_from_proj = refuse
    try:
        yield
    finally:
        GravesLSTM._cell_from_proj = saved


def graph_lstm_phase(tmp: Path) -> dict:
    """The seq2seq graph at the char-RNN's widths (GRAPH_LSTM): trained
    through the trainer CLI (tBPTT 50 over T = 50: one chunk a batch),
    then evaluate(), then standard-BPTT fit_batch steps, then 100 one-step
    rnn_time_step calls on 32 rows held to the same calls on the CPU. Each
    path is run with the launch counts set to 0 just before it and read
    just after, under a guard that fails on any plain LSTM scan."""
    V, T, H, B = GRAPH_LSTM["vocab"], GRAPH_LSTM["T"], GRAPH_LSTM["hidden"], GRAPH_LSTM["batch"]
    rows, epochs = GRAPH_LSTM["rows"], GRAPH_LSTM["epochs"]
    conf = seq2seq_conf(H, V, T, {"type": "rmsprop", "lr": 1e-3})
    (tmp / "seq2seq.json").write_text(conf.to_json())
    rs = np.random.RandomState(41)
    eye = np.eye(V, dtype=np.float32)
    enc, dec = rs.randint(0, V, (rows, T)), rs.randint(0, V, (rows, T))
    np.savez(tmp / "seq.npz", x0=eye[enc], x1=eye[dec], y=eye[np.roll(dec, -1, axis=1)])
    out_zip = tmp / "seq2seq.zip"
    launches = {}
    log = logging.getLogger("deeplearning4j_tpu_torch")
    handler = _ScoreLog()
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    with _no_plain_lstm_scan():
        _zero_lstm_counts()
        t0 = time.perf_counter()
        try:
            model = train_cli.run([str(tmp / "seq2seq.json"), "--data", str(tmp / "seq.npz"),
                                   "--epochs", str(epochs), "--batch-size", str(B),
                                   "--output", str(out_zip), "--listener-frequency", "1"])
            torch.cuda.synchronize()
        finally:
            log.removeHandler(handler)
        fit_s = time.perf_counter() - t0
        launches["fit_tbptt"] = _lstm_launches()
        chunks = epochs * (rows // B)
        scores = [sc for _, sc in handler.scores]
        check(isinstance(model, ComputationGraph) and model.iteration == chunks,
              f"{type(model).__name__}: {model.iteration} updates, expected {chunks}")
        check(len(scores) == chunks and all(np.isfinite(scores)) and scores[-1] < scores[0],
              f"seq2seq scores {scores}")
        check(launches["fit_tbptt"] == {"fused_lstm_fwd": 2 * chunks,
                                        "fused_lstm_bwd": 2 * chunks},
              f"tBPTT fit launches {launches['fit_tbptt']} over {chunks} chunks")

        _zero_lstm_counts()
        ev = model.evaluate(((eye[enc], eye[dec]), eye[np.roll(dec, -1, axis=1)]),
                            batch_size=B)
        launches["evaluate"] = _lstm_launches()
        check(launches["evaluate"] == {"fused_lstm_fwd": 2 * (rows // B), "fused_lstm_bwd": 0},
              f"evaluate launches {launches['evaluate']}")

        std = ComputationGraph(ComputationGraphConfiguration.from_dict(
            dict(conf.to_dict(), backprop_type="standard"))).init()
        xb = tuple(torch.as_tensor(a[:B], device="cuda") for a in (eye[enc], eye[dec]))
        yb = torch.as_tensor(eye[np.roll(dec, -1, axis=1)][:B], device="cuda")
        _zero_lstm_counts()
        std_losses = [float(std.fit_batch((xb, yb))) for _ in range(GRAPH_LSTM["std_steps"])]
        launches["fit_batch"] = _lstm_launches()
        n = GRAPH_LSTM["std_steps"]
        check(launches["fit_batch"] == {"fused_lstm_fwd": 2 * n, "fused_lstm_bwd": 2 * n}
              and all(np.isfinite(std_losses)), f"standard fit_batch launches "
              f"{launches['fit_batch']}, losses {std_losses}")
        # one step by CUDA events at the training shape
        step_ms = time_cuda(lambda: std.fit_batch((xb, yb)), iters=5, warmup=1)
        del std

        restored = restore_network(str(out_zip))
        cpu = restore_network(str(out_zip), device="cpu")
        srows, nsteps = GRAPH_LSTM["sample_rows"], GRAPH_LSTM["sample_steps"]
        se = eye[rs.randint(0, V, (srows, nsteps))]
        sd = eye[rs.randint(0, V, (srows, nsteps))]
        restored.rnn_clear_previous_state()
        _zero_lstm_counts()
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(nsteps):
            outs.append(restored.rnn_time_step(se[:, t], sd[:, t]))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / nsteps
        launches["rnn_time_step"] = _lstm_launches()
    check(launches["rnn_time_step"] == {"fused_lstm_fwd": 2 * nsteps, "fused_lstm_bwd": 0},
          f"rnn_time_step launches {launches['rnn_time_step']}")
    cpu_outs = [cpu.rnn_time_step(se[:, t], sd[:, t]) for t in range(nsteps)]
    got = torch.stack([o.cpu() for o in outs], 1)
    want = torch.stack(cpu_outs, 1)
    tol = TOL[torch.float32]
    err = (got - want).abs().max().item()
    check(tuple(got.shape) == (srows, nsteps, V) and bool(torch.isfinite(got).all())
          and bool(torch.allclose(got, want, **tol)),
          f"streamed seq2seq outputs differ from the CPU's by {err}")
    return {"phase": "graph_lstm",
            "model": {"graph": "seq2seq: GravesLSTM enc -> last_time_step -> "
                               "duplicate_to_time_series -> merge -> GravesLSTM dec -> "
                               "RnnOutputLayer", "vocab": V, "hidden": H, "T": T,
                      "dtype": "float32", "params": model.num_params()},
            "entry": "python -m deeplearning4j_tpu_torch.train (in-process), evaluate, "
                     "fit_batch, rnn_time_step",
            "updater": conf.updater, "rows": rows, "batch": B, "epochs": epochs,
            "tbptt_chunks": chunks, "loss": scores, "fit_s": fit_s,
            "evaluate_accuracy": ev.accuracy(), "std_fit_batch_losses": std_losses,
            "std_step_ms_128x50": step_ms, "launches_by_path": launches,
            "rnn_time_step": {"rows": srows, "steps": nsteps, "step_wall_ms": step_s * 1e3,
                              "card_vs_cpu_max_abs_err": err, "tol": tol},
            "plain_scan_calls_on_cuda": 0}


# -- phases 17-20: the training runtime around fit ------------------------------

def _host_leaves(tree) -> list:
    """A copy of every leaf on the host (params are updated in place)."""
    return [t.detach().to("cpu", copy=True) for t in tree_leaves(tree)]


def _max_diff(a: list, b: list) -> float:
    return max(((x.float() - y.float()).abs().max().item() for x, y in zip(a, b)),
               default=0.0)


def _bits_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _zero_flash_counts():
    fa.flash_fwd_cuda.launches = 0
    fa.flash_bwd_dq_cuda.launches = 0
    fa.flash_bwd_dkv_cuda.launches = 0


def _spans_since(t0: float, name: str) -> list:
    """Wall seconds of the ``name`` spans begun at or after ``t0`` (host
    ``time.perf_counter()``); the span ring is bounded, so a count of the
    spans before would miss new ones once it is full."""
    return [s["wall_s"] for s in obs.recent_spans() if s["span"] == name and s["t0_s"] >= t0]


def _checkpoint_breakdown(model, ckdir: Path) -> dict:
    """Host-clock seconds of the pieces a full-state save is made of, each
    over the same bytes: every leaf of params and updater state copied to
    the host through the writer's one pinned buffer, one CRC32 pass over
    the zip's bytes (a save makes three: the npz entries, the outer entry,
    the index), the zip's bytes written and fsynced, and read back."""
    import zlib

    from deeplearning4j_tpu_torch.utils.serialization import _HostStage

    zip_path = next(ckdir.glob("*.zip"))
    out = {}
    stage = _HostStage()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in tree_leaves((model.params, model.opt_state)):
        stage.bytes_of(t.detach().contiguous())
    out["host_copy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = zip_path.read_bytes()
    out["read"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zlib.crc32(data)
    out["crc32_one_pass"] = time.perf_counter() - t0
    probe = ckdir / "write_probe.bin"
    t0 = time.perf_counter()
    with open(probe, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    out["write_fsync"] = time.perf_counter() - t0
    probe.unlink()
    out["bytes"] = len(data)
    return out


def resilience_train_phase(tmp: Path) -> dict:
    """The TransformerLM at full width (FLAGSHIP_CONF, Adam 1e-4) through
    ``fit`` on RES_BATCHES batches of 16 rows, one epoch: (a) uninterrupted;
    (b) with CheckpointListener(every 2 iterations, keep_last=1) and a chaos
    preemption before iteration 4; (c) a fresh model resumed from (b)'s
    directory with the same budget, whose params must equal (a)'s bit for
    bit; (d) a skip_batch guard with spike limit 0 over 2 steps, which must
    leave params and updater state bit-equal. Each run's launches counted."""
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.resilience import (
        ChaosPreemption, DivergenceGuard, install_chaos)

    rows, n = 16, RES_BATCHES
    conf = zoo.TransformerLM(updater={"type": "adam", "lr": TRAIN_LR}, **FLAGSHIP_CONF)
    V, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    x = np.random.RandomState(31).randint(0, V, (rows * n, T)).astype(np.int64)
    data = (x, np.roll(x, -1, axis=1))
    launches = {}

    def run(name, fn):
        _zero_flash_counts()
        fn()
        torch.cuda.synchronize()
        launches[name] = _launch_counts()

    a = MultiLayerNetwork(conf).init()
    run("a_uninterrupted", lambda: a.fit(data, epochs=1, batch_size=rows))
    want = _host_leaves(a.params)
    check(a.iteration == n, f"run (a) took {a.iteration} steps")
    del a
    gc.collect()
    torch.cuda.empty_cache()

    ckdir = tmp / "ckpt"
    b = MultiLayerNetwork(conf).init()
    lis = CheckpointListener(ckdir, save_every_n_iterations=2, keep_last=1)
    b.set_listeners(lis)
    install_chaos(f"preempt@iter:{RES_PREEMPT_AT}")
    preempted = False
    try:
        run("b_preempted", lambda: b.fit(data, epochs=1, batch_size=rows))
    except ChaosPreemption:
        preempted = True
        torch.cuda.synchronize()
        launches["b_preempted"] = _launch_counts()
    finally:
        install_chaos(None)
    check(preempted and b.iteration == RES_PREEMPT_AT,
          f"run (b) was not preempted at iteration {RES_PREEMPT_AT} ({b.iteration})")
    saves = [{"seconds": s["seconds"], "bytes": s["size"]} for s in lis.saves]
    kept = f"checkpoint_{len(saves) - 1}_iter_{RES_PREEMPT_AT}_epoch_0.zip"
    check(len(saves) == RES_PREEMPT_AT // 2 and sorted(os.listdir(ckdir)) == sorted(
        [kept, kept + ".aotbundle", "checkpointInfo.json"]),   # the zip and its sidecar
          f"checkpoint directory {sorted(os.listdir(ckdir))}")
    del b
    gc.collect()
    torch.cuda.empty_cache()

    c = MultiLayerNetwork(conf).init()
    t_mark = time.perf_counter()
    run("c_resumed", lambda: c.fit(data, epochs=1, batch_size=rows, resume_from=str(ckdir)))
    restore_s = _spans_since(t_mark, "checkpoint.restore")
    breakdown = _checkpoint_breakdown(c, ckdir)
    got = _host_leaves(c.params)
    resume_equal = _bits_equal(got, want)
    resume_diff = _max_diff(got, want)
    check(c.iteration == n and resume_equal,
          f"the resumed run differs from the uninterrupted one: iteration {c.iteration}, "
          f"max |diff| {resume_diff}")

    # (d) skip_batch with spike limit 0: every update is rejected on the card
    xb = torch.as_tensor(x[:rows], device="cuda")
    yb = torch.as_tensor(data[1][:rows], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c._fit_batch(xb, yb, None, None)              # a plain step: the peak without the guard
    torch.cuda.synchronize()
    peak_plain = torch.cuda.max_memory_allocated()
    before = _host_leaves((c.params, c.opt_state))
    g = DivergenceGuard("skip_batch", spike_limit=0.0)
    c.set_divergence_guard(g)
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run("d_skip_batch", lambda: c.fit((x[:rows * 2], data[1][:rows * 2]), epochs=1,
                                          batch_size=rows))
    peak_guard = torch.cuda.max_memory_allocated()
    after = _host_leaves((c.params, c.opt_state))
    skip_equal = _bits_equal(before, after)
    check(skip_equal and g.trips == 1,
          f"skip_batch changed params or updater state (trips {g.trips})")
    c.set_divergence_guard(None)
    for name, k in (("a_uninterrupted", n), ("b_preempted", RES_PREEMPT_AT),
                    ("c_resumed", n - RES_PREEMPT_AT), ("d_skip_batch", 2)):
        for kern, cnt in launches[name].items():
            check(cnt == 8 * k, f"{name}: {kern} launched {cnt} times over {k} steps")
    return {"phase": "resilience_train",
            "model": {"vocab": V, "T": T, "d_model": FLAGSHIP_CONF["d_model"],
                      "heads": FLAGSHIP_CONF["n_heads"], "blocks": FLAGSHIP_CONF["n_blocks"],
                      "dtype": "bfloat16", "params": c.num_params()},
            "entry": "MultiLayerNetwork.fit with CheckpointListener, install_chaos, "
                     "resume_from, set_divergence_guard",
            "rows": rows, "batches": n, "preempt_at": RES_PREEMPT_AT,
            "checkpoint_saves": saves, "checkpoint_restore_s": restore_s,
            "checkpoint_breakdown_s": breakdown,
            "resume_bit_equal": resume_equal, "resume_max_abs_diff": resume_diff,
            "skip_batch_bit_equal": skip_equal, "guard_trips": g.trips,
            "peak_bytes_plain_step": peak_plain, "peak_bytes_skip_batch": peak_guard,
            "guard_extra_peak_bytes": peak_guard - peak_plain,
            "launches_by_run": launches, "model_obj": c}


def remat_train_phase(model, tmp: Path) -> dict:
    """The same full-width model with DL4J_TPU_REMAT_BLOCKS=1 beside the
    plain step, in one call: the loss and every parameter gradient of one
    batch both ways (bit for bit, or per tensor within GRAD_CHECK_REL and
    the largest difference reported), then per mode
    a warm step and REMAT_TIMED steps by CUDA events with the peak memory;
    kernel #1 must launch 16 times a remat step, #2/#3 8 times; then a
    ProfilerListener window over one remat step, whose trace must name the
    three flash kernels."""
    from deeplearning4j_tpu_torch.train.listeners import ProfilerListener

    rows = 16
    V, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    x = np.random.RandomState(32).randint(0, V, (rows, T)).astype(np.int64)
    xt = torch.as_tensor(x, device="cuda")
    yt = torch.as_tensor(np.roll(x, -1, axis=1), device="cuda")
    res = {"phase": "remat_train", "rows": rows, "timed_steps": REMAT_TIMED}
    losses, grads = {}, {}
    try:
        # the same batch, init and generator state both ways: remat reruns
        # each block's forward (kernel #1, the dropout draws) inside the
        # backward, so its gradients must be the plain step's
        gen_state = model._gen.get_state()
        for mode in ("plain", "remat"):
            os.environ["DL4J_TPU_REMAT_BLOCKS"] = "1" if mode == "remat" else "0"
            model._gen.set_state(gen_state)
            _zero_flash_counts()
            loss, _, g, _ = model._value_and_grad(model.state, xt, yt, None, None, None)
            torch.cuda.synchronize()
            losses[mode] = float(loss)
            grads[mode] = tree_leaves(g)
            res[f"launches_one_{mode}_value_and_grad"] = _launch_counts()
        tol = TOL[torch.bfloat16]
        check(abs(losses["remat"] - losses["plain"]) <= tol["atol"] * max(
            1.0, abs(losses["plain"])) and np.isfinite(losses["remat"]),
              f"remat loss {losses['remat']} vs plain {losses['plain']}")
        res["loss"] = losses
        gbits = _bits_equal(grads["remat"], grads["plain"])
        gdiff = _max_diff(grads["remat"], grads["plain"])
        # the same kernels in the same order give the same bits; a library
        # op that sums with atomics may not, and is then held to the bf16
        # backward's limit, per tensor ||diff|| / ||ref||
        grel = max(((r.float() - p.float()).norm() / p.float().norm().clamp_min(1e-30)).item()
                   for r, p in zip(grads["remat"], grads["plain"]))
        check(all(bool(torch.isfinite(r).all()) for r in grads["remat"])
              and (gbits or grel <= GRAD_CHECK_REL),
              f"remat gradients against plain: max |diff| {gdiff}, worst tensor "
              f"||diff|| / ||ref|| {grel} (limit {GRAD_CHECK_REL})")
        res["grads"] = {"tensors": len(grads["plain"]), "bit_equal": gbits,
                        "max_abs_diff": gdiff, "max_rel_norm_diff": grel,
                        "tol": GRAD_CHECK_REL}
        del grads, g
        for mode in ("plain", "remat"):
            os.environ["DL4J_TPU_REMAT_BLOCKS"] = "1" if mode == "remat" else "0"
            gc.collect()
            torch.cuda.empty_cache()
            model._fit_batch(xt, yt, None, None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_flash_counts()
            ms = time_cuda(lambda: model._fit_batch(xt, yt, None, None), iters=REMAT_TIMED,
                           warmup=0)
            res[mode] = {"step_ms": ms, "tokens_per_s": rows * T / (ms / 1e3),
                         "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                         "launches": _launch_counts()}
        for mode, per in (("plain", (8, 8, 8)), ("remat", (16, 8, 8))):
            want = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                            (REMAT_TIMED * k for k in per)))
            check(res[mode]["launches"] == want,
                  f"{mode}: launches {res[mode]['launches']} over {REMAT_TIMED} steps, "
                  f"expected {want}")
        check(res["remat"]["max_memory_allocated_bytes"]
              < res["plain"]["max_memory_allocated_bytes"],
              f"remat did not lower the peak memory: {res['remat']} vs {res['plain']}")
        # a profiler window over one remat step
        os.environ["DL4J_TPU_REMAT_BLOCKS"] = "1"
        it0 = model.iteration
        lis = ProfilerListener(str(tmp / "trace"), start=it0 + 1, stop=it0 + 2)
        model.set_listeners(lis)
        model.fit((np.concatenate([x, x]), np.roll(np.concatenate([x, x]), -1, axis=1)),
                  epochs=1, batch_size=rows)
        model.set_listeners()
        names = {e.get("name", "") for e in json.loads(Path(lis.trace_path).read_text())
                 .get("traceEvents", []) if e.get("cat") == "kernel"}
        found = {k: any(k in nm for nm in names)
                 for k in ("flash_fwd_wgmma_kernel", "flash_bwd_dq", "flash_bwd_dkv")}
        check(lis.captured and all(found.values()),
              f"the profiler trace misses flash kernels: {found}")
        res["profiler"] = {"trace_bytes": Path(lis.trace_path).stat().st_size,
                           "kernel_names_found": found, "kernel_names": len(names)}
    finally:
        os.environ.pop("DL4J_TPU_REMAT_BLOCKS", None)
    return res


class _ParamsEachIteration:
    """A listener keeping every iteration's params on the host."""

    def __init__(self):
        self.params = {}

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def iteration_done(self, model, iteration, score, batch_size=0):
        self.params[iteration] = _host_leaves(model.params)


def lstm_resilience_phase(tmp: Path) -> dict:
    """The char-RNN at the lstm_train configuration (LSTM_CONF: 128 x 50,
    tBPTT 50, f32, RMSProp 1e-3) through ``fit`` on LSTM_RES_BATCHES batches:
    a NaN batch (chaos nan_grad) under skip_batch leaves that update's
    params bit-equal and later updates train; rollback on the same NaN batch
    (spike limit twice the first loss) restores the last valid checkpoint,
    halves the rate and carries on; a resume from the middle of an epoch
    equals the uninterrupted run bit for bit. Kernels #4/#5 counted per
    path."""
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.resilience import (
        ChaosPreemption, DivergenceGuard, install_chaos)

    V, T, B = LSTM_CONF["vocab_size"], LSTM_CONF["timesteps"], LSTM_SHAPE["B"]
    n = LSTM_RES_BATCHES
    conf = zoo.TextGenerationLSTM(**LSTM_CONF)
    ids = np.random.RandomState(33).randint(0, V, (B * n, T))
    eye = np.eye(V, dtype=np.float32)
    data = (eye[ids], eye[np.roll(ids, -1, axis=1)])
    launches, res = {}, {"phase": "lstm_resilience", "batches": n, "batch": B, "T": T}
    k = 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # NaN batch under skip_batch
        m = MultiLayerNetwork(conf).init()
        keep = _ParamsEachIteration()
        g = DivergenceGuard("skip_batch")
        m.set_listeners(keep).set_divergence_guard(g)
        install_chaos(f"nan_grad@iter:{k}")
        _zero_lstm_counts()
        try:
            m.fit(data, epochs=1, batch_size=B)
        finally:
            install_chaos(None)
        torch.cuda.synchronize()
        launches["nan_skip"] = _lstm_launches()
        p = keep.params
        skipped = _bits_equal(p[k + 1], p[k])
        trained_after = not _bits_equal(p[k + 2], p[k + 1]) and all(
            bool(torch.isfinite(t).all()) for t in p[n])
        check(skipped and trained_after and g.trips == 1,
              f"nan_grad under skip_batch: skipped {skipped}, trained after "
              f"{trained_after}, trips {g.trips}")
        res["nan_skip"] = {"nan_at_iteration": k, "update_bit_equal": skipped,
                           "later_updates_train": trained_after, "trips": g.trips}
        first_loss = None

        # rollback
        ck = tmp / "lstm_rollback"
        m = MultiLayerNetwork(conf).init()
        first = CollectScoresListener()
        m.set_listeners(first).fit((data[0][:B], data[1][:B]), epochs=1)
        first_loss = first.scores[0][1]
        m = MultiLayerNetwork(conf).init()
        g = DivergenceGuard("rollback", checkpoint_dir=str(ck), spike_limit=2 * first_loss)
        m.set_listeners(CheckpointListener(ck, save_every_n_iterations=2, keep_last=2))
        m.set_divergence_guard(g)
        install_chaos(f"nan_grad@iter:{k + 1}")
        _zero_lstm_counts()
        try:
            m.fit(data, epochs=1, batch_size=B)
        finally:
            install_chaos(None)
        torch.cuda.synchronize()
        launches["rollback"] = _lstm_launches()
        lr = m._updaters[0].spec["lr"]
        ok = (g.trips == 1 and g.retries == 1 and m._lr_scale == 0.5
              and abs(lr - 0.5 * conf.updater["lr"]) < 1e-12
              and m.iteration == n - 2
              and all(bool(torch.isfinite(t).all()) for t in tree_leaves(m.params)))
        check(ok, f"rollback: trips {g.trips}, retries {g.retries}, lr_scale {m._lr_scale}, "
                  f"iteration {m.iteration}")
        res["rollback"] = {"spike_limit": 2 * first_loss, "nan_at_iteration": k + 1,
                           "trips": g.trips, "retries": g.retries, "lr_scale": m._lr_scale,
                           "lr": lr, "final_iteration": m.iteration}

    # mid-epoch resume against the uninterrupted run
    m = MultiLayerNetwork(conf).init()
    _zero_lstm_counts()
    m.fit(data, epochs=1, batch_size=B)
    torch.cuda.synchronize()
    launches["uninterrupted"] = _lstm_launches()
    want = _host_leaves(m.params)
    ck = tmp / "lstm_resume"
    m = MultiLayerNetwork(conf).init()
    m.set_listeners(CheckpointListener(ck, save_every_n_iterations=2, keep_last=1))
    install_chaos("preempt@iter:3")
    _zero_lstm_counts()
    try:
        m.fit(data, epochs=1, batch_size=B)
    except ChaosPreemption:
        pass
    finally:
        install_chaos(None)
    torch.cuda.synchronize()
    launches["preempted"] = _lstm_launches()
    r = MultiLayerNetwork(conf).init()
    _zero_lstm_counts()
    r.fit(data, epochs=1, batch_size=B, resume_from=str(ck))
    torch.cuda.synchronize()
    launches["resumed"] = _lstm_launches()
    got = _host_leaves(r.params)
    equal = _bits_equal(got, want)
    check(r.iteration == n and equal,
          f"the resumed char-RNN differs: iteration {r.iteration}, "
          f"max |diff| {_max_diff(got, want)}")
    res["resume"] = {"preempt_at": 3, "resumed_from_iteration": 2, "bit_equal": equal}
    for name, steps in (("nan_skip", n), ("rollback", n), ("uninterrupted", n),
                        ("preempted", 3), ("resumed", n - 2)):
        check(launches[name] == {"fused_lstm_fwd": 2 * steps, "fused_lstm_bwd": 2 * steps},
              f"{name}: launches {launches[name]} over {steps} tBPTT chunks")
    res["launches_by_path"] = launches
    return res


def lenet_runtime_phase() -> dict:
    """LeNet-5 at bench_lenet5's shape (28 x 28 x 1, batch 256, f32, Adam
    1e-3), no listeners: ``auto`` chains 8 steps (LENET_STEPS steps)
    against DL4J_TPU_CHAIN_STEPS=0, without and with the device prefetch
    (step ms each way by CUDA events, interleaved LENET_REPEATS times; the
    params' difference, with cuDNN's deterministic algorithms within
    LENET_CHAIN_TOL); one step under DL4J_TPU_PHASE_SPANS=1; LBFGS
    with 5 iterations on one batch on the card and on the CPU; an
    EarlyStoppingTrainer with MaxEpochs(3) and ScoreImprovement(patience=1);
    evaluate_roc of a 2-class LeNet-5 on the card."""
    from deeplearning4j_tpu_torch.train import earlystopping as es
    from deeplearning4j_tpu_torch.train.solvers import Solver

    B = CNN_BATCH
    x, y = _lenet_images(LENET_STEPS * B, 34)
    conf = zoo.LeNet5()
    res = {"phase": "lenet_runtime", "batch": B, "steps": LENET_STEPS}
    warm = MultiLayerNetwork(conf).init()
    warm.fit((x[:B], y[:B]), epochs=1)
    del warm
    chains = []
    copy_chain = step_program._copy_chain

    def fit_steps(chain, prefetch="0"):
        """A fresh LeNet-5 through ``fit`` over LENET_STEPS batches; ms a
        step by CUDA events around the call, and the chains it copied."""
        os.environ["DL4J_TPU_CHAIN_STEPS"] = chain
        os.environ["DL4J_TPU_DEVICE_PREFETCH"] = prefetch
        m = MultiLayerNetwork(conf).init()
        del chains[:]
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m.fit((x, y), epochs=1, batch_size=B)
        ev[1].record()
        torch.cuda.synchronize()
        return m, list(chains), ev[0].elapsed_time(ev[1]) / LENET_STEPS

    modes = {"chained": ("auto", "0"), "per_step": ("0", "0"),
             "per_step_prefetch": ("0", "1")}
    step_ms = {k: [] for k in modes}
    step_program._copy_chain = lambda group, device: (chains.append(len(group)),
                                                      copy_chain(group, device))[1]
    try:
        # the three loops interleaved, LENET_REPEATS times: the host clock
        # of a shared machine drifts more between runs than these differ
        for _ in range(LENET_REPEATS):
            for k, (chain, prefetch) in modes.items():
                m, got, ms = fit_steps(chain, prefetch)
                step_ms[k].append(ms)
                if k == "chained":
                    mc, mc_chains = m, got
                elif k == "per_step":
                    ms_, steps = m, got
        # the same comparison with cuDNN held to its deterministic algorithms:
        # chained and per-step must then agree bit for bit
        torch.backends.cudnn.deterministic = True
        (dc, dchains, dchain_ms), (ds, _, dstep_ms) = fit_steps("auto"), fit_steps("0")
    finally:
        step_program._copy_chain = copy_chain
        torch.backends.cudnn.deterministic = False
        os.environ.pop("DL4J_TPU_CHAIN_STEPS", None)
        os.environ.pop("DL4J_TPU_DEVICE_PREFETCH", None)
    diff = _max_diff(_host_leaves(mc.params), _host_leaves(ms_.params))
    det_diff = _max_diff(_host_leaves(dc.params), _host_leaves(ds.params))
    want_chains = [8] * (LENET_STEPS // 8)
    # "auto" chained every 8 steps; unset, the variable chains nothing
    check(mc._chain_k() == 0 and mc_chains == want_chains == dchains and not steps
          and mc.iteration == LENET_STEPS and det_diff <= LENET_CHAIN_TOL,
          f"chained LeNet-5: chains {mc_chains}, max |diff| {det_diff} with deterministic "
          f"cuDNN (limit {LENET_CHAIN_TOL}), {diff} without")
    res["chain"] = {"k": 8, "chains": mc_chains, "repeats": LENET_REPEATS,
                    "ms_per_step": step_ms,
                    "median_ms_per_step": {k: float(np.median(v)) for k, v in step_ms.items()},
                    "params_max_abs_diff": diff,
                    "deterministic_cudnn_ms_per_step": {"chained": dchain_ms,
                                                        "per_step": dstep_ms},
                    "params_max_abs_diff_deterministic_cudnn": det_diff,
                    "tol_deterministic_cudnn": LENET_CHAIN_TOL}

    os.environ["DL4J_TPU_PHASE_SPANS"] = "1"
    try:
        t_mark = time.perf_counter()
        ms_.fit((x[:B], y[:B]), epochs=1)
        spans = {k: [w * 1e3 for w in _spans_since(t_mark, k)]
                 for k in ("phase.fwd", "phase.bwd", "phase.update", "mln.fit_batch")}
    finally:
        os.environ.pop("DL4J_TPU_PHASE_SPANS", None)
    check(all(len(v) == 1 for v in spans.values()), f"phase spans {spans}")
    res["phase_spans_ms"] = {k: v[0] for k, v in spans.items()}

    lconf = MultiLayerConfiguration.from_dict(dict(conf.to_dict(), optimization_algo="lbfgs",
                                                   solver_iterations=5))
    gpu = MultiLayerNetwork(lconf).init()
    cpu = params_from_numpy(MultiLayerNetwork(lconf, device="cpu").init(),
                            params_to_numpy(gpu))
    batch = (x[:B], y[:B])
    before = gpu.score(batch)
    t0 = time.perf_counter()
    loss_gpu = Solver(gpu, "lbfgs").optimize(batch, iterations=5)
    torch.cuda.synchronize()
    lbfgs_s = time.perf_counter() - t0
    loss_cpu = Solver(cpu, "lbfgs").optimize(batch, iterations=5)
    pdiff = _max_diff(_host_leaves(gpu.params), tree_leaves(cpu.params))
    check(loss_gpu < before and abs(loss_gpu - loss_cpu) <= LBFGS_TOL["loss_rtol"] * abs(
        loss_cpu) and pdiff <= LBFGS_TOL["params_atol"],
          f"LBFGS: {before} -> {loss_gpu} on the card, {loss_cpu} on the CPU, "
          f"params max |diff| {pdiff}")
    res["lbfgs"] = {"iterations": 5, "loss_before": before, "loss_gpu": loss_gpu,
                    "loss_cpu": loss_cpu, "params_max_abs_diff": pdiff, "tol": LBFGS_TOL,
                    "gpu_s": lbfgs_s}

    xv, yv = _lenet_images(2 * B, 35)
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(3),
                                      es.ScoreImprovementEpochTerminationCondition(patience=1)],
        score_calculator=es.DataSetLossCalculator((xv, yv), batch_size=B))
    r = es.EarlyStoppingTrainer(cfg, MultiLayerNetwork(conf).init(), (x[:8 * B], y[:8 * B]),
                                batch_size=B).fit()
    check(r.best_model is not None and 1 <= r.total_epochs <= 3
          and all(np.isfinite(v) for v in r.score_vs_epoch.values()),
          f"early stopping: {r}")
    res["early_stopping"] = {"reason": r.termination_reason, "details": r.termination_details,
                             "best_epoch": r.best_model_epoch, "total_epochs": r.total_epochs,
                             "score_vs_epoch": r.score_vs_epoch}

    bconf = zoo.LeNet5(num_classes=2)
    yb2 = np.eye(2, dtype=np.float32)[(x[:4 * B].mean(axis=(1, 2, 3)) > 0.5).astype(int)]
    bm = MultiLayerNetwork(bconf).init()
    bm.fit((x[:4 * B], yb2), epochs=1, batch_size=B)
    roc = bm.evaluate_roc((x[:4 * B], yb2), batch_size=B)
    auc = roc.calculate_auc()
    check(np.isfinite(auc) and 0.0 <= auc <= 1.0, f"evaluate_roc AUC {auc}")
    res["evaluate_roc_auc"] = auc
    return res


# -- phases 21-23: the chunk entries, the ring, the sharded trainer -----------

# the ring's blocks at the TransformerLM's attention shape: B16 H16 D128,
# T 2048 cut into RING_SHARDS shards of 512
RING = dict(B=16, T=2048, H=16, D=128, shards=4)
# the einsum ring (use_flash=False) computes its scores in the operand
# dtype, as the JAX package's does: in bf16 its 64-row tiles sit ~1e-2 from
# the f32 plain version (the kernels: ~5e-3), so the flash ring is held to
# it, and it to the plain version, per tile within twice the kernels' limit
RING_EINSUM_TILE_REL = 2 * BWD_BF16_TILE_REL


def chunk_pairs(Tq, Tk, q_offset, k_offset, causal) -> int:
    """The (query, key) pairs a chunk's causal mask keeps (all Tq * Tk
    without one): query q sees keys k <= q + q_offset - k_offset."""
    return profile.attention_pairs(Tq, Tk, causal, q_offset, k_offset)


def chunk_bound(B, Tq, Tk, H, D, pairs, elem_bytes, peak, with_bwd):
    """(bound_ms, bound_by) of a chunk entry: its products over the kept
    pairs and its inputs read once and outputs written once
    (obs/profile.py chunk_cost)."""
    flops, nbytes = profile.chunk_cost(B, Tq, Tk, H, D, pairs, elem_bytes, with_bwd)
    return profile.bound(flops, nbytes, peak, PEAK_BYTES)


def _chunk_operands(case):
    B, Tq, Tk, H, D, dt = (case[k] for k in ("B", "Tq", "Tk", "H", "D", "dtype"))
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    q = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(B, Tk, H, D, generator=g, device="cuda").to(dt) for _ in range(2))
    do = torch.randn(B, Tq, H, D, generator=g, device="cuda").to(dt)
    dlse = torch.randn(B, H, Tq, generator=g, device="cuda")
    km = None
    if case.get("kmask") == "varlen":
        km = varlen_mask(B, Tk, case["seed"])
    elif case.get("kmask") == "zeros":
        km = torch.zeros(B, Tk, device="cuda")
    return q, k, v, km, do, dlse


def _chunk_rows(case, km):
    """[B, Tq] bool: the query rows of a chunk with at least one valid key."""
    B, Tq, Tk = case["B"], case["Tq"], case["Tk"]
    ok = torch.ones(Tq, Tk, dtype=torch.bool, device="cuda")
    if case["causal"]:
        ok = ((case["k_offset"] + torch.arange(Tk, device="cuda"))[None]
              <= (case["q_offset"] + torch.arange(Tq, device="cuda"))[:, None])
    ok = ok[None].expand(B, Tq, Tk)
    if km is not None:
        ok = ok & (km[:, None, :] > 0)
    return ok.any(-1)


def compare_chunk(case: dict) -> dict:
    """flash_attention_block and flash_attention_block_grad (kernels #1-#3
    with Tq, Tk and the offsets) against their plain versions on the card,
    with the tolerances of ``compare`` and ``compare_bwd``: the forward on
    the rows with a valid key (the others: lse <= -1e29, finite output),
    then the gradients of both outputs under random cotangents (do, dlse),
    dq of a row without a valid key exactly 0; forward and backward each
    run twice and held bit for bit."""
    dt, causal = case["dtype"], case["causal"]
    off = dict(q_offset=case["q_offset"], k_offset=case["k_offset"], causal=causal)
    q, k, v, km, do, dlse = _chunk_operands(case)
    out, lse = fa.flash_attention_block(q, k, v, kmask=km, **off)
    out2, lse2 = fa.flash_attention_block(q, k, v, kmask=km, **off)

    def grads():
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        o, l = fa.flash_attention_block_grad(qg, kg, vg, kmask=km, **off)
        torch.autograd.backward((o, l), (do, dlse))
        return [x.grad for x in (qg, kg, vg)]

    got, again = grads(), grads()
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_reference(q, k, v, kmask=km, with_lse=True, **off)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, km, dlse=dlse, **off)
    rows = _chunk_rows(case, km)
    w = rows[:, :, None, None].float()
    diff = (out.float() - ref.float()).abs() * w
    tol = TOL[dt]
    worst = (diff - tol["rtol"] * ref.float().abs() * w).max().item()
    lse_err = ((lse - ref_lse).abs() * rows[:, None, :].float()).max().item()
    dead = ~rows[:, None, :].expand_as(lse)
    res = {k: case[k] for k in ("B", "Tq", "Tk", "H", "D", "q_offset", "k_offset", "causal")}
    res.update({"dtype": str(dt).split(".")[-1], "kmask": case.get("kmask"),
                "route": "wide" if fa._wide(fa.kernel_head_dim(case["D"], dt)) else
                ("fma" if dt == torch.float32 else "wgmma"),
                "rows_without_a_key": int((~rows).sum().item()),
                "max_abs_err": diff.max().item(), "lse_max_abs_err": lse_err,
                "dead_rows_lse_max": lse[dead].max().item() if bool(dead.any()) else None,
                "finite": bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()),
                "repeat_bit_identical": (torch.equal(out, out2) and torch.equal(lse, lse2)
                                         and all(torch.equal(a, b) for a, b in zip(got, again))),
                "dq_dead_rows_nonzero": int(torch.count_nonzero(got[0][~rows]))})
    ok = (worst <= tol["atol"] and lse_err <= LSE_ATOL and res["finite"]
          and res["repeat_bit_identical"] and res["dq_dead_rows_nonzero"] == 0
          and (res["dead_rows_lse_max"] is None or res["dead_rows_lse_max"] <= -1e29))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        res[f"{name}_max_abs_err"] = (a - b).abs().max().item()
        if not bool(rows.any()):                   # every row dead: all exactly 0
            res[f"{name}_nonzero"] = int(torch.count_nonzero(a))
            ok &= res[f"{name}_nonzero"] == 0
        elif dt == torch.float32:
            t32 = TOL[torch.float32]
            ok &= bool(((a - b).abs() <= t32["atol"] + t32["rtol"] * b.abs()).all())
        else:
            res[f"{name}_tile_rel_err"] = tile_rel_err(a, b)
            ok &= (res[f"{name}_max_abs_err"] <= BWD_BF16_REL * b.abs().max().item()
                   and res[f"{name}_tile_rel_err"] <= BWD_BF16_TILE_REL)
    res["ok"] = bool(ok)
    check(res["ok"], f"a chunk entry disagrees with its plain version: {res}")
    return res


def _time_chunk(case: dict) -> dict:
    """The chunk entry at one block shape: forward, and forward + backward
    (both cotangents), beside the plain versions, the bound and
    aten._scaled_dot_product_flash_attention on the same block (forward:
    out and logsumexp; forward + backward: through autograd with the out
    cotangent alone, the library's backward taking no lse cotangent)."""
    dt, causal = case["dtype"], case["causal"]
    off = dict(q_offset=case["q_offset"], k_offset=case["k_offset"], causal=causal)
    q, k, v, km, do, dlse = _chunk_operands(case)
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))

    def fwd_bwd():
        o, l = fa.flash_attention_block_grad(qg, kg, vg, **off)
        return torch.autograd.grad((o, l), (qg, kg, vg), (do, dlse))

    def plain_fwd_bwd():
        o, l = fa.flash_attention_reference(q, k, v, with_lse=True, **off)
        return fa.flash_attention_bwd_reference(q, k, v, o, l, do, dlse=dlse, **off)

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qtg, ktg, vtg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    dot = do.transpose(1, 2).contiguous()
    sdpa_causal = causal and case["q_offset"] == case["k_offset"]

    def lib_fwd_bwd():
        o = torch.nn.functional.scaled_dot_product_attention(qtg, ktg, vtg, is_causal=sdpa_causal)
        return torch.autograd.grad(o, (qtg, ktg, vtg), dot)

    B, Tq, Tk, H, D = (case[k] for k in ("B", "Tq", "Tk", "H", "D"))
    pairs = chunk_pairs(Tq, Tk, case["q_offset"], case["k_offset"], causal)
    es = torch.finfo(dt).bits // 8
    peak = PEAK_F32_FLOPS if dt == torch.float32 else PEAK_BF16_FLOPS
    row = {"shape": [B, Tq, Tk, H, D], "dtype": str(dt).split(".")[-1], **off, "pairs": pairs,
           "fwd_ms": time_cuda(lambda: fa.flash_attention_block(q, k, v, **off), iters=20),
           "fwd_bwd_ms": time_cuda(fwd_bwd, iters=10),
           "plain_fwd_ms": time_cuda(lambda: fa.flash_attention_reference(
               q, k, v, with_lse=True, **off), iters=3, warmup=1),
           "plain_fwd_bwd_ms": time_cuda(plain_fwd_bwd, iters=2, warmup=1),
           "library_fwd_ms": time_cuda(
               lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                   qt, kt, vt, 0.0, sdpa_causal), iters=20),
           "library_fwd_bwd_ms": time_cuda(lib_fwd_bwd, iters=10),
           "library": "aten._scaled_dot_product_flash_attention (out, logsumexp); "
                      "fwd+bwd: SDPA autograd with the out cotangent only",
           "library_same_function": not causal or sdpa_causal}
    row["fwd_bound_ms"], row["fwd_bound_by"] = chunk_bound(B, Tq, Tk, H, D, pairs, es, peak,
                                                           False)
    row["fwd_bwd_bound_ms"], row["fwd_bwd_bound_by"] = chunk_bound(B, Tq, Tk, H, D, pairs,
                                                                   es, peak, True)
    return row


def chunk_kernel_phase() -> dict:
    """Phase 21: flash_attention_block(_grad) on the card against their
    plain versions: the ring's diagonal block (B16 H16 D128, 512 x 512,
    causal) in bf16, f32 and f16, its off-diagonal block (not causal), Tq
    != Tk with a shifted diagonal (512 queries at 1536 over 1536 keys at
    512), a chunk wholly in the future, a chunk whose kmask is all 0, D =
    64, and the wide-head route (D = 320; D = 3072 in column groups); then
    the diagonal and off-diagonal blocks timed."""
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    blk = dict(B=RING["B"], Tq=512, Tk=512, H=RING["H"], D=RING["D"])
    cases = [dict(blk, dtype=dt, causal=True, q_offset=0, k_offset=0, seed=300 + i)
             for i, dt in enumerate((bf16, f32, f16))]
    cases += [
        dict(blk, dtype=bf16, causal=False, q_offset=0, k_offset=512, seed=303),
        dict(blk, Tk=1536, dtype=bf16, causal=True, q_offset=1536, k_offset=512, seed=304),
        dict(blk, Tk=1536, dtype=f32, causal=True, q_offset=1536, k_offset=512, seed=305),
        dict(blk, dtype=bf16, causal=True, q_offset=0, k_offset=512, seed=306),
        dict(blk, dtype=bf16, causal=False, q_offset=0, k_offset=0, kmask="zeros", seed=307),
        dict(blk, dtype=bf16, causal=True, q_offset=512, k_offset=0, kmask="varlen", seed=308),
        dict(blk, D=64, Tk=700, dtype=bf16, causal=True, q_offset=900, k_offset=300, seed=309),
        dict(blk, D=64, Tq=300, dtype=f16, causal=True, q_offset=200, k_offset=100,
             kmask="varlen", seed=310),
        dict(B=2, Tq=300, Tk=500, H=4, D=320, dtype=bf16, causal=True, q_offset=400,
             k_offset=100, kmask="varlen", seed=311),
        dict(B=2, Tq=300, Tk=500, H=4, D=320, dtype=f32, causal=True, q_offset=0,
             k_offset=100, seed=312),
        dict(B=1, Tq=256, Tk=384, H=2, D=3072, dtype=bf16, causal=True, q_offset=384,
             k_offset=128, seed=313),
    ]
    results = [compare_chunk(c) for c in cases]
    torch.cuda.empty_cache()
    timing = {"diagonal": _time_chunk(dict(blk, dtype=bf16, causal=True, q_offset=0,
                                           k_offset=0, seed=320)),
              "off_diagonal": _time_chunk(dict(blk, dtype=bf16, causal=False, q_offset=0,
                                               k_offset=512, seed=321))}
    torch.cuda.empty_cache()
    return {"phase": "chunk_kernel", "cases": results, "timing": timing,
            "tol": {"forward": {str(k).split(".")[-1]: v for k, v in TOL.items()},
                    "lse_atol": LSE_ATOL, "bwd_16bit_rel": BWD_BF16_REL,
                    "bwd_16bit_tile_rel": BWD_BF16_TILE_REL}}


def _zero_chunk_counts():
    for name in fa.CHUNK_LAUNCHES:
        fa.CHUNK_LAUNCHES[name] = 0


def _rel_checks(got, want, what, tile_rel=BWD_BF16_TILE_REL) -> dict:
    """Per tensor max |err| / max |ref| and the worst 64-row tile's
    relative error, held to the 16-bit backward's limits (``tile_rel`` per
    tile)."""
    res = {}
    for name, a, b in zip(what, got, want):
        err = (a.float() - b.float()).abs().max().item()
        res[name] = {"max_abs_err": err, "ref_max_abs": b.float().abs().max().item(),
                     "tile_rel_err": tile_rel_err(a, b), "tile_rel_limit": tile_rel}
        check(err <= BWD_BF16_REL * res[name]["ref_max_abs"]
              and res[name]["tile_rel_err"] <= tile_rel,
              f"ring {name} disagrees: {res[name]}")
    return res


def ring_attention_phase() -> dict:
    """Phase 22: the flash ring (``parallel/ring.py`` ``_ring_flash_shard``)
    at the full-width TransformerLM's attention shape, B16 T2048 H16 D128,
    bf16, causal, cut into 4 shards of 512: the routine runs once per shard
    in one process (``ring_in_one_process``), each shard receiving the
    blocks in its ring order, forward and backward; its launches of the
    chunk entries are this slice's main path on one card. The joined output
    and dq/dk/dv are held to flash_attention over the whole sequence
    (kernels #1-#3), to the plain reference (per tensor and per 64-row
    tile) and to the einsum ring, with and without a varlen kmask; then the
    ring's time beside the whole-sequence kernels'."""
    from deeplearning4j_tpu_torch.parallel import ring

    B, T, H, D, s = (RING[k] for k in ("B", "T", "H", "D", "shards"))
    res = {"phase": "ring_attention", "shape": [B, T, H, D], "shards": s, "dtype": "bfloat16",
           "causal": True, "runs": {}}
    for masked in (False, True):
        q0, k0, v0 = make_qkv(B, T, H, D, torch.bfloat16, 400 + int(masked))
        q, k, v = (x.detach().requires_grad_(True) for x in (q0, k0, v0))
        km = varlen_mask(B, T, 400) if masked else None
        g = torch.Generator(device="cuda").manual_seed(401)
        do = torch.randn(B, T, H, D, generator=g, device="cuda").to(torch.bfloat16)
        if masked:
            do = do * km[:, :, None, None].to(do.dtype)   # rows past a length carry no loss

        def run(fn):
            parts = ring.ring_in_one_process(
                fn, q.chunk(s, 1), k.chunk(s, 1), v.chunk(s, 1),
                km.chunk(s, 1) if masked else None, causal=True)
            out = torch.cat(parts, 1)
            return [out.detach()] + list(torch.autograd.grad(out, (q, k, v), do))

        # the main path of this slice on one card: every launch below is counted
        _zero_flash_counts()
        _zero_chunk_counts()
        got = run(ring._ring_flash_shard)
        torch.cuda.synchronize()
        run_res = {"chunk_launches": dict(fa.CHUNK_LAUNCHES), "kernel_launches": _launch_counts()}
        for name in fa.CHUNK_LAUNCHES:
            check(run_res["chunk_launches"][name] == s * s,
                  f"{name}: {run_res['chunk_launches'][name]} chunk launches, not {s * s}")

        names = ("out", "dq", "dk", "dv")
        w = km[:, :, None, None] if masked else 1.0

        def weigh(xs):   # the output on the rows a key mask keeps
            return [xs[0] * w] + list(xs[1:])

        out = fa.flash_attention(q, k, v, kmask=km, causal=True)
        whole = [out.detach()] + list(torch.autograd.grad(out, (q, k, v), do))
        run_res["vs_flash_attention"] = _rel_checks(weigh(got), weigh(whole), names)
        del whole, out
        einsum = run(ring._ring_attention_shard)
        run_res["vs_einsum_ring"] = _rel_checks(weigh(got), weigh(einsum), names,
                                                RING_EINSUM_TILE_REL)
        torch.cuda.empty_cache()
        ref, ref_lse = fa.flash_attention_reference(q0, k0, v0, causal=True, kmask=km,
                                                    with_lse=True)
        ref = [ref] + list(fa.flash_attention_bwd_reference(q0, k0, v0, ref, ref_lse, do,
                                                            km, True))
        run_res["vs_plain_reference"] = _rel_checks(weigh(got), weigh(ref), names)
        run_res["einsum_ring_vs_plain_reference"] = _rel_checks(
            weigh(einsum), weigh(ref), names, RING_EINSUM_TILE_REL)
        del ref, ref_lse, einsum
        torch.cuda.empty_cache()
        res["runs"]["varlen_kmask" if masked else "no_kmask"] = run_res
        if not masked:
            def ring_fwd():
                with torch.no_grad():
                    return torch.cat(ring.ring_in_one_process(
                        ring._ring_flash_shard, q.chunk(s, 1), k.chunk(s, 1), v.chunk(s, 1),
                        causal=True), 1)

            res["timing"] = {
                "ring_fwd_ms": time_cuda(ring_fwd, iters=5),
                "ring_fwd_bwd_ms": time_cuda(lambda: run(ring._ring_flash_shard), iters=3),
                "whole_fwd_ms": time_cuda(lambda: fa.flash_fwd_cuda(q0, k0, v0, causal=True),
                                          iters=10),
                "whole_fwd_bwd_ms": time_cuda(lambda: torch.autograd.grad(
                    fa.flash_attention(q, k, v, causal=True), (q, k, v), do), iters=5),
                "ring": "4 shards x 4 blocks of 512 x 512 through the chunk entries, merged; "
                        "future blocks launched and weighted out",
                "whole": "flash_attention over T 2048 (kernels #1-#3)"}
        del q, k, v, q0, k0, v0, got, do
        torch.cuda.empty_cache()
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def ring_train_phase() -> dict:
    """Phase 23: ShardedTrainer (``parallel/tp.py``) on a world-size-1 NCCL
    group over the card (``init_distributed``, ``make_mesh``), driving the
    serve/train TransformerLM with sequence_parallel=True (full width,
    bf16, Adam 1e-4) for 3 steps on 16 x 2048 tokens; the losses and params
    against MultiLayerNetwork._fit_batch from the same params (bit for bit,
    else the largest difference against GRAD_CHECK_REL), the launches of
    kernels #1-#3 per step, and the step time beside the plain step's."""
    from deeplearning4j_tpu_torch.parallel import (
        ShardedTrainer, init_distributed, make_mesh, shutdown_distributed)

    steps, rows = 3, 16
    conf = zoo.TransformerLM(updater={"type": "adam", "lr": TRAIN_LR}, sequence_parallel=True,
                             **FLAGSHIP_CONF)
    V, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    x = np.random.RandomState(41).randint(0, V, (rows, T)).astype(np.int64)
    y = np.roll(x, -1, axis=1)
    init_distributed(f"tcp://localhost:{_free_port()}", 1, 0, timeout_s=120)
    try:
        mesh = make_mesh()
        model = MultiLayerNetwork(conf).init()
        trainer = ShardedTrainer(model, mesh)
        _zero_flash_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        ev[0].record()
        losses = []
        for i in range(steps):
            losses.append(trainer.fit_batch(x, y))
            ev[i + 1].record()
        torch.cuda.synchronize()
        launches = _launch_counts()
        sharded_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
        sharded_losses = [float(l) for l in losses]
        sharded_params = _host_leaves(model.params)
        backend = torch.distributed.get_backend()
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutdown_distributed()
    plain = MultiLayerNetwork(conf).init()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    ev[0].record()
    plain_losses = []
    for i in range(steps):
        plain_losses.append(plain._fit_batch(x, y, None, None))
        ev[i + 1].record()
    torch.cuda.synchronize()
    plain_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    plain_losses = [float(l) for l in plain_losses]
    plain_params = _host_leaves(plain.params)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    bit_equal = sharded_losses == plain_losses and _bits_equal(sharded_params, plain_params)
    rel = max(((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
              for a, b in zip(sharded_params, plain_params))
    res = {"phase": "ring_train", "backend": backend, "world_size": 1,
           "mesh": {"data": 1, "model": 1, "seq": 1, "pipe": 1},
           "model": {"vocab": V, "T": T, "d_model": FLAGSHIP_CONF["d_model"],
                     "blocks": FLAGSHIP_CONF["n_blocks"], "dtype": "bfloat16",
                     "sequence_parallel": True},
           "updater": {"type": "adam", "lr": TRAIN_LR}, "rows": rows, "steps": steps,
           "losses": sharded_losses, "plain_losses": plain_losses,
           "bit_equal": bit_equal,
           "params_max_abs_diff": _max_diff(sharded_params, plain_params),
           "params_max_rel_diff": rel, "tol_if_not_bit_equal": GRAD_CHECK_REL,
           "launches": launches, "step_ms": sharded_ms, "plain_step_ms": plain_ms}
    check(all(np.isfinite(sharded_losses)), f"non-finite loss: {sharded_losses}")
    check(bit_equal or (rel <= GRAD_CHECK_REL and np.allclose(
        sharded_losses, plain_losses, rtol=GRAD_CHECK_REL)),
          f"ShardedTrainer disagrees with _fit_batch: {res}")
    for name, n in launches.items():
        check(n == 8 * steps, f"{name}: {n} launches over {steps} sharded steps")
    return res


# -- phase 24: token-level generation ------------------------------------------

GEN_PROMPTS = (7, 64, 130, 500)      # the parity prompts' lengths
GEN_EXTRA = (33, 250, 1000, 1)       # the 4 more streams of the concurrent run
GEN_MAX_NEW = 32
LOAD_PROMPTS = (16, 128, 512, 1024)  # bench_generate-shaped load, seed 11
LOAD_MAX_NEW = 64
LOAD_WINDOW_S = 5.0
# open-loop arrival rates (streams/s): a sweep of 1, 3, 6, 12 and 24/s
# (tools/decode_invariance_probe.py --rates, PERF.md §6) filled the
# 8-stream decode batch from 6/s on; 8/s holds it full with a queue, 1.5
# and 3 leave it part-empty
LOAD_RATES = (1.5, 3.0, 8.0)
# a decode step's logits against the full forward's at the same position,
# bf16 end to end through 8 blocks: the two paths round the attention and
# the residual stream at different places. Logits stay below 4 in size,
# where a bf16 ulp is 2^-5: 4 ulps (the largest difference measured on the
# card: 0.035, PERF.md §6)
GEN_VS_FULL_ATOL = 0.125


def _gen_prompts(lengths, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, FLAGSHIP_CONF["vocab_size"], size=n).tolist() for n in lengths]


def _stream_all(worker, prompts, max_new, **kw):
    """Submit every prompt at once and read every stream (bounded waits)."""
    streams = [worker.submit(p, max_new=max_new, timeout_s=600.0, **kw) for p in prompts]
    return [list(s) for s in streams], [s.finish_reason for s in streams]


def _solo(worker, prompts, max_new):
    out = []
    for p in prompts:
        toks, reasons = _stream_all(worker, [p], max_new)
        check(reasons == ["length"], f"solo stream ended with {reasons}")
        out.append(toks[0])
    return out


def _drive_program(prog, prompts, n_gen, together: bool, force=None):
    """Hand-driven DecodeProgram: each prompt prefilled alone (batch 1, as
    the worker does), then ``n_gen - 1`` decode steps with all the streams
    in one batch (``together``) or each alone, each step fed the stream's
    last greedy id, or its id in ``force`` (the same inputs both ways).
    Returns per stream the logits [n_gen, V] (f32, on the host) and the
    greedy ids."""
    pg, ladder = prog.page_tokens, prog.ladder
    npb = ladder.bucket(prog.max_pages)
    tables = []
    for i in range(len(prompts)):
        t = np.zeros((1, npb), np.int64)
        t[0, :prog.max_pages] = 1 + i * prog.max_pages + np.arange(prog.max_pages)
        tables.append(t)
    logits = [[] for _ in prompts]
    ids = [[] for _ in prompts]
    cached = [0] * len(prompts)
    for i, p in enumerate(prompts):
        for s in range(0, len(p), prog.prefill_chunk):
            chunk = p[s:s + prog.prefill_chunk]
            tc = ladder.bucket(len(chunk)) if len(chunk) > 1 else 1
            toks = np.zeros((1, tc), np.int64)
            toks[0, :len(chunk)] = chunk
            lg, nxt = prog.dispatch(tables[i], [cached[i]], toks, [len(chunk)])
            cached[i] += len(chunk)
        logits[i].append(lg[0].cpu())
        ids[i].append(int(nxt[0]))
    groups = [list(range(len(prompts)))] if together else [[i] for i in range(len(prompts))]
    for step in range(1, n_gen):
        for g in groups:
            bb = ladder.bucket(len(g))
            table = np.zeros((bb, npb), np.int64)
            lengths = np.zeros(bb, np.int64)
            toks = np.zeros((bb, 1), np.int64)
            n_new = np.zeros(bb, np.int64)
            for r, i in enumerate(g):
                table[r] = tables[i][0]
                fed = ids[i][-1] if force is None else force[i][step - 1]
                lengths[r], toks[r, 0], n_new[r] = cached[i], fed, 1
            lg, nxt = prog.dispatch(table, lengths, toks, n_new)
            lg, nxt = lg.cpu(), nxt.cpu()
            for r, i in enumerate(g):
                cached[i] += 1
                logits[i].append(lg[r])
                ids[i].append(int(nxt[r]))
    return [torch.stack(l) for l in logits], ids


def _full_logits(model, toks):
    """The full forward's logits (the head's preactivation, f32) at every
    position of ``toks``."""
    with torch.inference_mode():
        a = model._forward(model.params, model.state, np.asarray(toks)[None], train=False,
                           upto=len(model.layers) - 1)[0]
        return model.layers[-1].preactivation(model.params[-1], a)[0].float().cpu()


def _post_generate(port, name, payload, timeout=600):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", f"/v1/models/{name}:generate", json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read().decode()
        lines = [json.loads(l) for l in body.strip().splitlines()] if resp.status == 200 else []
        return resp.status, lines, time.perf_counter() - t0
    finally:
        conn.close()


def _open_loop(port, name, prompts, rate, window_s, max_new, deadline_ms=None):
    """Open-loop arrivals through HTTP :generate: request i fires at
    t0 + i / rate whatever the earlier ones are doing; each runs on its own
    thread, which reads the chunked stream to its end."""
    results = []
    lock = threading.Lock()

    def one(i):
        payload = {"prompt": prompts[i % len(prompts)], "max_tokens": max_new}
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
        try:
            r = _post_generate(port, name, payload)
        except Exception as e:   # counted below, never silently
            r = ("error", repr(e), 0.0)
        with lock:
            results.append(r)

    threads = []
    t0 = time.perf_counter()
    for i in range(int(rate * window_s)):
        wait = t0 + i / rate - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        t = threading.Thread(target=one, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a :generate request hung")
    return results, time.perf_counter() - t0


def _gen_summary(results, dt, tracker, route, worker) -> dict:
    ttft = tracker._ttft.summary(route=route) or {}
    itl = tracker._itl.summary(route=route) or {}
    statuses = {}
    reasons = {}
    for status, lines, _ in results:
        statuses[str(status)] = statuses.get(str(status), 0) + 1
        if lines:
            reasons[lines[-1]["reason"]] = reasons.get(lines[-1]["reason"], 0) + 1
    return {"requests": len(results), "statuses": statuses, "finish_reasons": reasons,
            "seconds": dt,
            "tokens": int(tracker._tokens.value(route=route) or 0),
            "tokens_per_s": int(tracker._tokens.value(route=route) or 0) / dt,
            "ttft_ms": {q: ttft.get(q, 0.0) * 1e3 for q in ("p50", "p99")},
            "itl_ms": {q: itl.get(q, 0.0) * 1e3 for q in ("p50", "p99")},
            "max_occupancy": worker.stats_counters["max_occupancy"]}


def _decode_split(prog) -> dict:
    """One decode dispatch at B=8, NP=32 (every stream 2,000 tokens deep):
    its time by CUDA events, its host wall time, and its parts timed
    alone at the same shapes: the page gathers (k and v of every block),
    the attention (decode_attention at every block) and the GEMMs (qkv,
    out, the two MLP products per block and the head at 8 rows); then one
    profiled dispatch's device time by kernel class."""
    from deeplearning4j_tpu_torch.nn.decode import _PagedView

    B, NP, pg = 8, 32, prog.page_tokens
    table = (1 + np.arange(B * NP).reshape(B, NP)).astype(np.int64)
    lengths = np.full(B, NP * pg - 48, np.int64)
    toks = np.ones((B, 1), np.int64)
    n_new = np.ones(B, np.int64)
    for _ in range(3):
        prog.dispatch(table, lengths, toks, n_new)
    torch.cuda.synchronize()
    dispatch_ms = time_cuda(lambda: prog.dispatch(table, lengths, toks, n_new), iters=20)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        prog.dispatch(table, lengths, toks, n_new)[1].cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev = prog.device
    tab = torch.as_tensor(table, device=dev)
    pos = torch.as_tensor(lengths, device=dev)[:, None]
    valid = torch.ones(B, 1, dtype=torch.bool, device=dev)
    views = [_PagedView(p, tab, pos, valid, pg) for p in prog.pools]
    with torch.inference_mode():
        gather_ms = time_cuda(lambda: [v.gathered() for v in views], iters=20)
        k_all, v_all = views[0].gathered()
        H, D = k_all.shape[2], k_all.shape[3]
        q = torch.randn(B, 1, H, D, device=dev, dtype=k_all.dtype)
        attn_ms = len(views) * time_cuda(
            lambda: fa.decode_attention(q, k_all, v_all, pos), iters=20)
        m = prog.model
        C = H * D
        x = torch.randn(B, C, device=dev, dtype=m.dtype)
        blocks = [p for p in m.params if "attn" in p]

        def gemms():
            for p in blocks:
                x @ p["attn"]["Wqkv"]
                x @ p["attn"]["Wo"]
                (x @ p["Wi"]) @ p["Wo"]
            x @ m.params[-1]["W"]

        gemm_ms = time_cuda(gemms, iters=20)
    parts = gather_ms + attn_ms + gemm_ms
    split = {"dispatch_ms": dispatch_ms, "dispatch_host_wall_ms_median": float(np.median(walls)),
             "page_gather_ms": gather_ms, "attention_ms": attn_ms, "gemm_ms": gemm_ms,
             "rest_ms": dispatch_ms - parts,
             "gathered_bytes": 2 * len(views) * k_all.numel() * k_all.element_size()}
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prog.dispatch(table, lengths, toks, n_new)
            torch.cuda.synchronize()
        classes = {"gemm": 0.0, "gather_index": 0.0, "softmax": 0.0, "other": 0.0}
        kernels = []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            if not us or e.key.startswith("aten::") or e.key.startswith("cuda"):
                continue
            k = e.key.lower()
            cls = ("gemm" if any(s in k for s in ("gemm", "sm90", "cutlass", "xmma", "gemv",
                                                   "nvjet"))
                   else "gather_index" if any(s in k for s in ("index", "gather"))
                   else "softmax" if "softmax" in k else "other")
            classes[cls] += us / 1e3
            kernels.append((us / 1e3, e.key[:80], e.count))
        kernels.sort(reverse=True)
        busy = sum(classes.values())
        split["profile"] = {"device_ms_by_class": classes, "device_busy_ms": busy,
                            "kernel_launches": sum(c for _, _, c in kernels),
                            "top_kernels": kernels[:8]}
        if busy > 0:
            split["profile"]["host_gap_ms"] = split["dispatch_host_wall_ms_median"] - busy
    except Exception as e:   # the profiler is a report, not a check
        split["profile"] = {"error": repr(e)}
    return split


def generate_phase() -> dict:
    """The decode path at full width: parity, load through HTTP :generate,
    the overload arm, memory and the decode step's split."""
    from deeplearning4j_tpu_torch.nn.decode import DecodeProgram
    from deeplearning4j_tpu_torch.obs import slo
    from deeplearning4j_tpu_torch.serve import GenerateConfig

    conf = zoo.TransformerLM(**FLAGSHIP_CONF)
    prompts = _gen_prompts(GEN_PROMPTS, seed=21)
    extra = _gen_prompts(GEN_EXTRA, seed=22)
    cfg = GenerateConfig()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every launch below is counted (decode runs no
    # hand-written kernel: decode_attention is plain torch)
    _zero_flash_counts()
    model = MultiLayerNetwork(conf).init()
    registry = ModelRegistry(config=ServeConfig(default_deadline_s=600.0))
    t0 = time.perf_counter()
    worker = registry.register_generate("lm", model, config=cfg)
    warm_s = time.perf_counter() - t0
    contig = registry.register_generate("lm_contig", model,
                                        config=GenerateConfig(paged=False))
    server = InferenceServer(registry).start(port=0)
    prog = worker.program
    try:
        solo = _solo(worker, prompts + extra, GEN_MAX_NEW)
        together, reasons = _stream_all(worker, prompts + extra, GEN_MAX_NEW)
        check(all(r == "length" for r in reasons), f"concurrent streams ended {reasons}")
        check(worker.stats_counters["max_occupancy"] == 8,
              f"8 streams shared the batch {worker.stats_counters['max_occupancy']} wide")
        same = [a == b for a, b in zip(together, solo)]
        first_diff = [next((j for j, (u, w) in enumerate(zip(a, b)) if u != w), None)
                      for a, b in zip(together, solo)]
        check(all(same), f"concurrent tokens differ from solo ones at {first_diff}")
        contig_solo = _solo(contig, prompts + extra, GEN_MAX_NEW)
        contig_first_diff = [next((j for j, (u, w) in enumerate(zip(a, b)) if u != w), None)
                             for a, b in zip(contig_solo, solo)]
        check(contig_solo == solo,
              f"contiguous tokens differ from paged ones at {contig_first_diff}")
        # HTTP round trip of one stream
        status, lines, _ = _post_generate(server.port, "lm",
                                          {"prompt": prompts[0], "max_tokens": GEN_MAX_NEW})
        check(status == 200 and [l["token"] for l in lines[:-1]] == solo[0],
              f"HTTP :generate gave {status}, tokens unlike the solo stream's")

        # load: three open-loop arrival rates, metrics per rate
        load_prompts = _gen_prompts(LOAD_PROMPTS, seed=11)
        load = []
        for rate in LOAD_RATES:
            obs.reset()
            worker.stats_counters["max_occupancy"] = 0
            res, dt = _open_loop(server.port, "lm", load_prompts, rate, LOAD_WINDOW_S,
                                 LOAD_MAX_NEW)
            row = dict(_gen_summary(res, dt, slo.slo_tracker(), "generate.lm", worker),
                       arrival_rate=rate)
            check(row["statuses"].get("200", 0) > 0, f"no stream served at {rate}/s: {row}")
            load.append(row)
        launches = _launch_counts()
        off_grid = {"paged": prog.off_grid_dispatches,
                    "contiguous": contig.program.off_grid_dispatches}
        check(off_grid == {"paged": 0, "contiguous": 0},
              f"request-path dispatch shapes outside the warmed grid: {off_grid}")
        check(prog.shapes_seen <= prog.warmed, "a dispatch shape was not warmed")
        check(launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
              f"the decode path launched a flash kernel: {launches}")

        # overload: a starved engine, a 1 ms deadline and a blast of arrivals
        obs.reset()
        over = registry.register_generate(
            "lm_over", model, config=GenerateConfig(decode_batch_max=2, queue_limit=2))
        res, dt = _open_loop(server.port, "lm_over", load_prompts, 4 * LOAD_RATES[-1], 1.0,
                             LOAD_MAX_NEW, deadline_ms=1.0)
        tracker = slo.slo_tracker()
        shed = {reason: int(tracker._shed.value(route="generate.lm_over", reason=reason) or 0)
                for reason in ("deadline", "backpressure")}
        statuses = {}
        for status, _, _ in res:
            statuses[str(status)] = statuses.get(str(status), 0) + 1
        overload = {"requests": len(res), "statuses": statuses, "shed": shed,
                    "burn_rate": tracker.burn_rate("generate.lm_over")}
        check(sum(shed.values()) > 0, f"the overload arm shed nothing: {overload}")
    finally:
        server.stop()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # outside the counted path: logits of solo and batched decode, and of
    # the decode step against the full forward
    program = DecodeProgram(model, page_tokens=cfg.kv_page_tokens, max_batch=8,
                            prefill_chunk=cfg.prefill_chunk)
    alone, ids_alone = _drive_program(program, prompts + extra, GEN_MAX_NEW, together=False)
    program.reset()
    batched, ids_batched = _drive_program(program, prompts + extra, GEN_MAX_NEW,
                                          together=True, force=ids_alone)
    bits = all(torch.equal(a, b) for a, b in zip(alone, batched))
    logits_diff = max((a - b).abs().max().item() for a, b in zip(alone, batched))
    ids_agree = {"alone_vs_worker_solo": ids_alone == solo,
                 "batched_vs_alone": ids_batched == ids_alone}
    vs_full = {}
    p = prompts[2]
    seq = p + ids_alone[2][:-1]
    step_logits = alone[2]
    for key, flash in (("use_flash_false", False), ("flash", "auto")):
        m = model
        if not flash:
            m = MultiLayerNetwork(MultiLayerConfiguration.from_dict(dict(
                conf.to_dict(), layers=[dict(l, use_flash=False)
                                        if l["@type"] == "transformer_block" else l
                                        for l in conf.to_dict()["layers"]])))
            m.params, m.state = model.params, model.state
        full = _full_logits(m, seq)[len(p) - 1:]
        diff = (full - step_logits).abs().max().item()
        agree = float((full.argmax(-1) == step_logits.argmax(-1)).float().mean())
        vs_full[key] = {"max_abs_diff": diff, "argmax_agreement": agree,
                        "tol": GEN_VS_FULL_ATOL,
                        "logit_abs_max": full.abs().max().item()}
        check(diff <= GEN_VS_FULL_ATOL,
              f"decode logits vs the full forward ({key}): {vs_full[key]}")
    split = _decode_split(program)
    out = {
        "phase": "generate",
        "model": {"params": model.num_params(), **FLAGSHIP_CONF},
        "config": {k: getattr(cfg, k) for k in ("decode_batch_max", "kv_page_tokens",
                                                "prefill_chunk", "paged")},
        "capacity": prog.capacity,
        "warm": {"shapes": len(prog.warmed), "seconds": warm_s},
        "parity": {"prompts": list(GEN_PROMPTS), "extra": list(GEN_EXTRA),
                   "max_new": GEN_MAX_NEW, "concurrent_equals_solo": all(same),
                   "paged_equals_contiguous": contig_solo == solo,
                   "logits_bit_equal_batched_vs_alone": bits,
                   "logits_max_abs_diff_batched_vs_alone": logits_diff,
                   "hand_driven_ids_agree": ids_agree,
                   "decode_vs_full_forward": vs_full},
        "load": load,
        "load_prompts": list(LOAD_PROMPTS), "load_max_new": LOAD_MAX_NEW,
        "overload": overload,
        "off_grid_dispatches": off_grid,
        "dispatch_shapes_seen": len(prog.shapes_seen),
        "kv_pool_bytes": prog.pool_bytes(),
        "max_memory_allocated_bytes": peak,
        "decode_step_B8_NP32": split,
        "launches": launches,
    }
    registry.shutdown()
    return out


# -- phase 25: the mixture-of-experts TransformerLM ----------------------------

MOE_EXPERTS = 8
MOE_ROWS = 16            # 8 if the peak passes MOE_PEAK_LIMIT
MOE_PEAK_LIMIT = 70e9
# one step's loss and parameter gradients (4 rows) with kernels #1-#3
# against use_flash=False. In bf16 the two attention paths round apart and
# ~1% of tokens route to another expert (their experts' gradients move by
# 10-30%), so bf16 is held on its loss and reported per tensor; the
# gradients are held in an f32 replica of the same weights, where the two
# paths route alike (PERF.md §6)
MOE_LOSS_REL = 1e-2
MOE_GRAD_REL = 5e-2


def _moe_vs_use_flash_false(model, x, y) -> dict:
    """One step's loss and parameter gradients with kernels #1-#3 against
    the same weights with use_flash=False, and the tokens each MoE layer
    routes to another expert between the two."""
    from deeplearning4j_tpu_torch.nn.layers import MixtureOfExperts

    d = model.conf.to_dict()
    plain = MultiLayerNetwork(MultiLayerConfiguration.from_dict(dict(
        d, layers=[dict(l, use_flash=False) if l["@type"] == "transformer_block" else l
                   for l in d["layers"]])))
    plain.params, plain.state = model.params, model.state

    def experts(m):
        with torch.inference_mode():
            acts = m._forward(m.params, m.state, x, train=False, collect=True)[4]
            return {i: l.route(m.params[i], acts[i - 1].reshape(-1, acts[i - 1].shape[-1]))[0]
                    for i, l in enumerate(m.layers) if isinstance(l, MixtureOfExperts)}

    ea, eb = experts(model), experts(plain)
    flips = {i: int((ea[i] != eb[i]).sum()) for i in ea}
    losses = []
    grads = []
    for m in (model, plain):
        rng = m._gen.get_state()
        grads.append(_param_grads(m, x, y))
        losses.append(float(m._loss(m.params, m.state, x, y, None, None, m._gen)[0]))
        m._gen.set_state(rng)
    rel = [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
           for a, b in zip(*grads)]
    moe_leaf = [isinstance(l, MixtureOfExperts) for l, p in zip(model.layers, model.params)
                for _ in tree_leaves(p)]
    return {"rows": int(x.shape[0]), "dtype": str(model.dtype).replace("torch.", ""),
            "loss_kernels": losses[0], "loss_use_flash_false": losses[1],
            "loss_rel_diff": abs(losses[0] - losses[1]) / abs(losses[1]),
            "routing_flips_by_layer": flips, "tokens_routed": int(x.numel()),
            "max_rel_norm_diff": max(rel), "median_rel_norm_diff": float(np.median(rel)),
            "max_rel_norm_diff_outside_moe": max(r for r, f in zip(rel, moe_leaf) if not f),
            "tol": {"loss_rel": MOE_LOSS_REL, "grad_rel_norm": MOE_GRAD_REL}}


def moe_train_phase(tmp: Path) -> dict:
    from deeplearning4j_tpu_torch.nn.layers import MixtureOfExperts

    conf = zoo.TransformerLM(moe_experts=MOE_EXPERTS,
                             updater={"type": "adam", "lr": TRAIN_LR}, **FLAGSHIP_CONF)
    V, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    x = np.random.RandomState(51).randint(0, V, (MOE_ROWS, T)).astype(np.int64)
    torch.cuda.reset_peak_memory_stats()

    # the main path: every launch below is counted
    _zero_flash_counts()
    model = MultiLayerNetwork(conf).init()
    xt = torch.as_tensor(x, device=model.device)
    yt = torch.roll(xt, -1, dims=1)
    rows, cut = MOE_ROWS, None
    losses = [float(model._fit_batch(xt, yt, None, None))]
    torch.cuda.synchronize()
    if torch.cuda.max_memory_allocated() > MOE_PEAK_LIMIT:
        rows = MOE_ROWS // 2
        cut = f"{MOE_ROWS} x {T} peaked above {MOE_PEAK_LIMIT / 1e9:.0f} GB: {rows} x {T}"
        xt, yt = xt[:rows], yt[:rows]
    timed = 3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(timed):
        losses.append(model._fit_batch(xt, yt, None, None))
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / timed
    losses = [float(l) for l in losses]
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = 1 + timed
    check(all(np.isfinite(losses)), f"non-finite MoE loss: {losses}")
    for name, n in launches.items():
        check(n == 8 * steps, f"{name}: {n} launches over {steps} MoE steps, not 8 a step")

    # outside the counted path: tokens dropped per MoE layer on this batch,
    # and one step's loss and gradients against use_flash=False
    with torch.inference_mode():
        acts = model._forward(model.params, model.state, xt, train=False, collect=True)[4]
    dropped = {i: l.dropped_tokens(model.params[i], acts[i - 1])
               for i, l in enumerate(model.layers) if isinstance(l, MixtureOfExperts)}
    del acts
    xs, ys = xt[:GRAD_CHECK_ROWS], yt[:GRAD_CHECK_ROWS]
    grad_check = {"bfloat16": _moe_vs_use_flash_false(model, xs, ys)}
    check(grad_check["bfloat16"]["loss_rel_diff"] <= MOE_LOSS_REL,
          f"the MoE loss with kernels #1-#3 vs use_flash=False: {grad_check['bfloat16']}")
    f32 = MultiLayerNetwork(zoo.TransformerLM(moe_experts=MOE_EXPERTS,
                                              **dict(FLAGSHIP_CONF, dtype="float32")))
    f32.params = tree_unflatten_like(model.params, [t.float() for t in tree_leaves(model.params)])
    f32.state = model.state
    grad_check["float32"] = _moe_vs_use_flash_false(f32, xs, ys)
    del f32
    g32 = grad_check["float32"]
    check(g32["loss_rel_diff"] <= MOE_LOSS_REL and g32["max_rel_norm_diff"] <= MOE_GRAD_REL,
          f"the f32 MoE step with kernels #1-#3 vs use_flash=False: {g32}")
    gc.collect()
    torch.cuda.empty_cache()

    path = tmp / "moe.zip"
    save_network(model, str(path), save_updater=False)
    n_params = model.num_params()
    tokens = rows * T
    out = {
        "phase": "moe_train",
        "model": {"params": n_params, "moe_experts": MOE_EXPERTS,
                  "moe_layers": len(dropped), **FLAGSHIP_CONF},
        "rows": rows, "cut": cut, "updater": {"type": "adam", "lr": TRAIN_LR},
        "loss": losses, "launches": launches, "launches_per_step": {
            k: v / steps for k, v in launches.items()},
        "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
        "capacity_per_expert": MixtureOfExperts(n_experts=MOE_EXPERTS)._capacity(tokens),
        "dropped_tokens_by_layer": dropped,
        "max_memory_allocated_bytes": peak,
        "kernels_vs_use_flash_false": grad_check,
        "zip_bytes": path.stat().st_size, "zip": str(path),
    }
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_serve_phase(zip_path: str) -> dict:
    V = FLAGSHIP_CONF["vocab_size"]
    g = torch.Generator().manual_seed(52)
    ids = [torch.randint(0, V, (1, 128), generator=g) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    t0 = time.perf_counter()
    model = restore_network(zip_path)
    registry = ModelRegistry(config=ServeConfig(max_batch=16, max_wait_s=0.1,
                                                default_deadline_s=600.0))
    registry.register("moe", model)
    server = InferenceServer(registry).start(port=0)
    setup_s = time.perf_counter() - t0
    try:
        # one after the other: an MoE layer's capacity counts the dispatch's
        # tokens, so a row coalesced with another may drop other tokens
        # than the same row alone
        http = [post_predict(server.port, "moe", i.tolist(), 600000.0) for i in ids]
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = _launch_counts()
    for (status, payload, _), i in zip(http, ids):
        check(status == 200, f"MoE :predict status {status}")
        out = torch.tensor(payload["outputs"])
        check_rows(out, (1, 128, V), "MoE :predict")
        want = model.output(i.numpy()).float().cpu()
        d = (out - want).abs().max().item()
        check(d <= 1e-3, f"MoE :predict differs from output() by {d}")
    check(launches["flash_fwd"] > 0, "serving the MoE model never launched kernel #1")
    check(launches["flash_bwd_dq"] == 0 and launches["flash_bwd_dkv"] == 0,
          "serving launched a backward kernel")
    out = {"phase": "moe_serve", "setup_s": setup_s,
           "latency_s": sorted(lat for _, _, lat in http), "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phases 26-27: Word2Vec and the embedding libraries ------------------------

# bench.py:416 bench_word2vec, unreduced: the step at vocab 100,000, dim 100,
# 65,536 pairs a batch, 5 negatives (numpy seed 0), then 2,000,000 tokens
# drawn from zipf(1.3) below 50,000 in sentences of 1,000 (the same
# RandomState, after the step's arrays)
W2V = dict(vocab=100_000, dim=100, batch=65536, negative=5, seed=0, lr=0.025)
W2V_CORPUS = dict(tokens=2_000_000, v_eff=50_000, sent_len=1000)
W2V_WARM, W2V_TIMED, W2V_SCAN_BATCHES = 5, 50, 64
# one step on the card against the same step on the CPU from the same tables
# and batch: index_add_ on the card adds a repeated row's updates with
# atomics in no fixed order, and the reductions sum in other orders, so per
# table the update (after - before) on the card is held to the CPU's in norm
# (f32 rounding of sums of a few terms: ~1e-7 of the update), the loss too
W2V_UPDATE_REL = 1e-4
W2V_LOSS_REL = 1e-5
# the scan over 64 batches against the loop of steps with the same
# negatives, both on the card: the same operations, atomics in another
# order, and 64 steps to carry the differences; per table, relative to the
# chunk's whole update
W2V_CHUNK_REL = 1e-3
# the device negatives' counts against the probabilities of the f32
# cumulative table (what inverse CDF over it draws): the largest |z| over
# 100,000 words (about 4.5 expected of as many normals)
W2V_NEG_Z = 6.0
# two fits on the card that differ only in atomics order (the world-size-1
# group against plain fit): the tables' difference in norm
W2V_FIT_REL = 1e-4
# the planted-topic corpus of the embeddings phase, GloVe's slice of the
# word2vec corpus, and the clique graph of DeepWalk and Node2Vec
EMB_TOPICS = dict(topics=4, words=25, sentences=2000, length=20, seed=21)
# (512 pairs a batch: each of the 100 words comes ~5 times a batch, whose
# summed updates at a larger batch overshoot)
EMB_CONF = dict(layer_size=64, window=5, negative=5, min_word_frequency=1, epochs=3,
                seed=3, batch_size=512, learning_rate=0.025)
# ParagraphVectors: a document's 20 words give its label 20 pairs an epoch,
# so the labels take more epochs at a higher rate
PV_CONF = dict(EMB_CONF, epochs=10, learning_rate=0.05)
GLOVE_TOKENS, GLOVE_EPOCHS = 200_000, 5
CLIQUES = dict(size=10, count=20)
_CUDA = torch.device("cuda")


def _w2v_bench_inputs():
    """bench_word2vec's arrays in its draw order: the step's tables and
    batch, then the corpus."""
    V, D, B, K = W2V["vocab"], W2V["dim"], W2V["batch"], W2V["negative"]
    rs = np.random.RandomState(W2V["seed"])
    syn0 = (rs.rand(V, D).astype(np.float32) - 0.5) / D
    batch = [rs.randint(0, V, B, dtype=np.int32), rs.randint(0, V, B, dtype=np.int32),
             rs.randint(0, V, (B, K), dtype=np.int32)]
    n, v_eff, L = W2V_CORPUS["tokens"], W2V_CORPUS["v_eff"], W2V_CORPUS["sent_len"]
    zipf = rs.zipf(1.3, n * 2)
    toks = zipf[zipf <= v_eff][:n].astype(np.int64)
    corpus = [[f"w{t}" for t in toks[i:i + L]] for i in range(0, len(toks), L)]
    return syn0, batch, corpus


def _zipf_vocab(V: int):
    """A V-word vocabulary with counts 1e7 / rank (Zipf), for the Huffman
    tables and the unigram table at the step's width."""
    from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord

    counts = np.maximum((1e7 / np.arange(1, V + 1)).astype(np.int64), 1)
    cache = VocabCache()
    for i, c in enumerate(counts):
        cache.add(VocabWord(f"w{i}", int(c)))
    cache.total_word_count = int(counts.sum())
    return cache


def _sg_ns_bound_ms(centers, contexts, negs, D) -> dict:
    """The least time of one SG-NS step on this batch: every table row the
    step touches read once and written once (the rows this batch's ids
    name), every index read once; against ~6 D operations a (pair, row) in
    f32 FMA."""
    rows = (np.unique(centers).size + np.unique(np.concatenate(
        [contexts.ravel(), negs.ravel()])).size)
    nbytes = 2 * 4 * D * rows + 8 * (centers.size + contexts.size + negs.size)
    ops = 6 * D * (centers.size + contexts.size + negs.size)
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": nbytes, "bound_operations": ops, "rows_touched": int(rows)}


def _step_vs_cpu(name, fn, params, args, lr, **kw) -> dict:
    """One step on the card and on the CPU from the same tables (``params``,
    on the CPU) and batch: per table the update's difference in norm, the
    largest entry difference, and the loss."""
    gp, gl = fn({k: v.to(_CUDA, copy=True) for k, v in params.items()},
                *(a.to(_CUDA) for a in args), lr, **kw)
    torch.cuda.synchronize()
    cp, cl = fn({k: v.clone() for k, v in params.items()}, *args, lr, **kw)
    res = {"step": name, "batch": int(args[0].shape[0]), "loss": float(gl),
           "cpu_loss": float(cl), "tables": {}}
    for k, want in cp.items():
        got = gp[k].cpu()
        du = want - params[k]
        rel = float((got - want).norm() / du.norm().clamp_min(1e-30))
        res["tables"][k] = {"update_rel": rel, "max_abs_err": float((got - want).abs().max()),
                            "update_norm": float(du.norm())}
        check(rel <= W2V_UPDATE_REL, f"{name}: {k} update off by {rel} (card vs CPU)")
    check(abs(res["loss"] - res["cpu_loss"]) <= W2V_LOSS_REL * abs(res["cpu_loss"]),
          f"{name}: loss {res['loss']} on the card, {res['cpu_loss']} on the CPU")
    res["max_abs_err"] = max(t["max_abs_err"] for t in res["tables"].values())
    del gp, cp
    return res


def _kernel_launches() -> dict:
    return {**_all_launches(), **{f"chunk_{k}": v for k, v in fa.CHUNK_LAUNCHES.items()},
            **dict(fa.WIDE_LAUNCHES)}


def _zero_wide_counts():
    for name in fa.WIDE_LAUNCHES:
        fa.WIDE_LAUNCHES[name] = 0


def _zero_all_kernel_counts():
    _zero_flash_counts()
    _zero_lstm_counts()
    _zero_chunk_counts()
    _zero_wide_counts()


def _check_no_kernel(launches: dict, phase: str):
    check(not any(launches.values()),
          f"{phase}: a hand-written kernel launched on a path without one: {launches}")


def _device_busy_ms(prof) -> float:
    """Device time of every kernel and copy the profiler saw (one stream,
    so they do not overlap)."""
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def word2vec_phase() -> dict:
    """Phase 26: Word2Vec skip-gram at bench_word2vec's full width: (a) the
    step, card against CPU, then timed; (b) the other steps and GloVe's once
    each at B = 65,536, card against CPU; (c) one scan chunk (64 x 65,536
    pairs) against the loop of steps with the same negatives, and those
    negatives against the unigram table; (d) the end-to-end run and the
    device's idle share over a warm epoch."""
    from deeplearning4j_tpu_torch.nlp import embeddings as E
    from deeplearning4j_tpu_torch.nlp.embeddings import Word2Vec, _fast_pairs
    from deeplearning4j_tpu_torch.nlp.glove import _glove_step
    from deeplearning4j_tpu_torch.nlp.vocab import huffman_tables, subsample_probs, unigram_table

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the f32 steps")
    V, D, B, K = W2V["vocab"], W2V["dim"], W2V["batch"], W2V["negative"]
    lr = float(np.float32(W2V["lr"]))
    dev = _CUDA
    syn0, (c_np, t_np, n_np), corpus = _w2v_bench_inputs()
    c, t, n = (torch.from_numpy(a.astype(np.int64)).to(dev) for a in (c_np, t_np, n_np))

    stage = {"start": time.perf_counter()}
    # (a) the step: warm steps from bench's tables (syn1neg zero), then one
    # step from that state on the card against the CPU, then timed steps
    params = {"syn0": torch.from_numpy(syn0).to(dev), "syn1neg": torch.zeros(V, D, device=dev)}
    for _ in range(W2V_WARM):
        params, loss = E._sg_ns_step(params, c, t, n, lr)
    torch.cuda.synchronize()
    state = {k: v.cpu() for k, v in params.items()}
    fused = _step_vs_cpu("_sg_ns_step", E._sg_ns_step, state,
                         [torch.from_numpy(a.astype(np.int64)) for a in (c_np, t_np, n_np)], lr)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(W2V_TIMED):
        params, loss = E._sg_ns_step(params, c, t, n, lr)
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / W2V_TIMED
    check(np.isfinite(float(loss)), f"non-finite SG-NS loss {float(loss)}")
    fused.update(step_ms=step_ms, pairs_per_s=B / (step_ms / 1e3), warm_steps=W2V_WARM,
                 timed_steps=W2V_TIMED, final_loss=float(loss),
                 **_sg_ns_bound_ms(c_np, t_np, n_np, D))
    fused["roofline_share"] = fused["bound_ms"] / step_ms

    stage["step"] = time.perf_counter()
    # (b) the other steps, once each at B = 65,536 on the trained state
    rs = np.random.RandomState(1)
    cache = _zipf_vocab(V)
    codes, points, hmask = huffman_tables(cache)
    Wn = 2 * 5
    win = torch.from_numpy(rs.randint(0, V, (B, Wn)))
    wmask = torch.from_numpy((np.arange(Wn)[None, :] < rs.randint(1, Wn + 1, B)[:, None])
                             .astype(np.float32))
    tgt, docs = torch.from_numpy(rs.randint(0, V, B)), torch.from_numpy(rs.randint(0, V, B))
    hs_rows = rs.randint(0, V, B)
    hs = [torch.from_numpy(codes[hs_rows]), torch.from_numpy(points[hs_rows].astype(np.int64)),
          torch.from_numpy(hmask[hs_rows])]
    hs_state = {"syn0": state["syn0"],
                "syn1": torch.from_numpy(((rs.rand(V - 1, D) - 0.5) / D).astype(np.float32))}
    negs = torch.from_numpy(n_np.astype(np.int64))
    others = [
        _step_vs_cpu("_cbow_ns_step", E._cbow_ns_step, state, [win, wmask, tgt, negs], lr),
        _step_vs_cpu("_dm_ns_step", E._dm_ns_step, state, [docs, win, wmask, tgt, negs], lr),
        _step_vs_cpu("_cbow_hs_step", E._cbow_hs_step, hs_state, [win, wmask] + hs, lr),
        _step_vs_cpu("_sg_hs_step", E._sg_hs_step, hs_state, [tgt] + hs, lr)]
    grs = np.random.RandomState(12345)
    glove = {"W": (grs.rand(V, D).astype(np.float32) - 0.5) / D,
             "Wc": (grs.rand(V, D).astype(np.float32) - 0.5) / D,
             "b": np.zeros(V, np.float32), "bc": np.zeros(V, np.float32),
             "hW": np.full((V, D), 1e-8, np.float32), "hWc": np.full((V, D), 1e-8, np.float32),
             "hb": np.full(V, 1e-8, np.float32), "hbc": np.full(V, 1e-8, np.float32)}
    others.append(_step_vs_cpu(
        "_glove_step", _glove_step, {k: torch.from_numpy(v) for k, v in glove.items()},
        [tgt, docs, torch.from_numpy((rs.rand(B) * 100 + 1).astype(np.float32))], 0.05,
        x_max=100.0, alpha=0.75))
    others[-1]["huffman_code_length_max"] = int(codes.shape[1])

    stage["other_steps"] = time.perf_counter()
    # (c) one scan chunk against the loop with the same negatives
    table = unigram_table(cache)
    cum64 = np.cumsum(table)
    cum = torch.from_numpy(cum64.astype(np.float32)).to(dev)
    crs = np.random.RandomState(5)
    c2 = torch.from_numpy(crs.randint(0, V, (W2V_SCAN_BATCHES, B))).to(dev)
    t2 = torch.from_numpy(crs.randint(0, V, (W2V_SCAN_BATCHES, B))).to(dev)
    total = float(10 * W2V_SCAN_BATCHES * B)
    start = {k: v.clone() for k, v in params.items()}
    gen = torch.Generator(device=dev).manual_seed(2024)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    scan_p, scan_losses = E._sg_ns_epoch_scan({k: v.clone() for k, v in start.items()}, c2, t2,
                                              cum, gen, lr, 1e-4, 0.0, total, negative=K)
    ev[1].record()
    gen = torch.Generator(device=dev).manual_seed(2024)
    loop_p = {k: v.clone() for k, v in start.items()}
    seen = torch.zeros((), device=dev)
    counts = torch.zeros(V, dtype=torch.int64, device=dev)
    loop_losses = []
    ev[2].record()
    for i in range(W2V_SCAN_BATCHES):
        negs_d = E._device_negatives(cum, gen, B, K)
        counts += torch.bincount(negs_d.view(-1), minlength=V)
        rate = torch.clamp(lr * (1.0 - torch.clamp(seen / total, max=1.0)), min=1e-4)
        loop_p, l_i = E._sg_ns_step(loop_p, c2[i], t2[i], negs_d, rate)
        loop_losses.append(l_i)
        seen = seen + B
    ev[3].record()
    torch.cuda.synchronize()
    chunk = {"batches": W2V_SCAN_BATCHES, "batch": B, "scan_ms": ev[0].elapsed_time(ev[1]),
             "loop_with_bincount_ms": ev[2].elapsed_time(ev[3]), "tables": {}}
    chunk["scan_pairs_per_s"] = W2V_SCAN_BATCHES * B / (chunk["scan_ms"] / 1e3)
    for k in start:
        du = (loop_p[k] - start[k]).norm()
        rel = float((scan_p[k] - loop_p[k]).norm() / du.clamp_min(1e-30))
        chunk["tables"][k] = {"rel_to_update": rel,
                              "max_abs_err": float((scan_p[k] - loop_p[k]).abs().max())}
        check(rel <= W2V_CHUNK_REL, f"scan chunk {k} off the loop by {rel}")
    ll = torch.stack(loop_losses)
    chunk["loss_max_rel"] = float(((scan_losses - ll).abs() / ll.abs()).max())
    check(chunk["loss_max_rel"] <= W2V_CHUNK_REL, f"scan losses off the loop: {chunk}")
    cnt = counts.cpu().numpy().astype(np.float64)
    ndraw = cnt.sum()
    check(ndraw == W2V_SCAN_BATCHES * B * K, "negatives drawn != batches x B x K")
    p32 = np.diff(np.concatenate([[0.0], cum64.astype(np.float32).astype(np.float64)[:-1], [1.0]]))
    pos = p32 > 0
    z = np.abs(cnt[pos] - ndraw * p32[pos]) / np.sqrt(ndraw * p32[pos] * (1 - p32[pos]))
    dev64 = np.abs(cnt / ndraw - table)
    chunk["negatives"] = {"draws": int(ndraw), "max_z_vs_f32_table": float(z.max()),
                          "max_abs_dev_vs_unigram": float(dev64.max()),
                          "at_rank": int(dev64.argmax()), "z_limit": W2V_NEG_Z,
                          "draws_where_f32_table_is_zero": int(cnt[~pos].sum())}
    check(z.max() < W2V_NEG_Z and cnt[~pos].sum() == 0,
          f"device negatives off the unigram table: {chunk['negatives']}")
    del scan_p, loop_p, start, params, state, hs_state, c2, t2

    stage["scan_chunk"] = time.perf_counter()
    # (d) end to end, as bench.py:473-497 computes it
    m = Word2Vec(layer_size=D, window=5, negative=K, min_word_frequency=1, epochs=1, seed=1,
                 batch_size=B, pair_backend="numpy")
    t0 = time.perf_counter()
    m.build_vocab(corpus)
    t_vocab = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.fit(corpus)
    torch.cuda.synchronize()
    t_fit_cold = time.perf_counter() - t0
    idx_seqs = m._index_sequences(corpus)
    # every pair of the warm epoch must reach a step (scan chunks and the
    # tail): the steps count their batches' pairs, and the epoch's host
    # stream is replayed from its state for the pair generation alone
    rs_state = m._rs.get_state()
    stepped = [0]
    real_step = E._sg_ns_step

    def counted_step(prm, centers, *a):
        stepped[0] += centers.numel()
        return real_step(prm, centers, *a)

    E._sg_ns_step = counted_step
    try:
        t0 = time.perf_counter()
        m._run_epochs(idx_seqs, 1)
        torch.cuda.synchronize()
        t_epoch_warm = time.perf_counter() - t0
    finally:
        E._sg_ns_step = real_step
    keep = subsample_probs(m.vocab, m.sample)
    replay = np.random.RandomState()
    replay.set_state(rs_state)
    replay.randint(2 ** 31)   # the epoch's seed of the chunk generators
    t0 = time.perf_counter()
    n_pairs = sum(len(cc) for cc, _ in _fast_pairs(idx_seqs, m.window, keep, replay))
    t_host = time.perf_counter() - t0
    check(stepped[0] == n_pairs, f"warm epoch stepped {stepped[0]} pairs of {n_pairs}")
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        m._run_epochs(idx_seqs, 1)
        torch.cuda.synchronize()
    t_profiled = time.perf_counter() - t0
    busy_ms = _device_busy_ms(prof)
    check(busy_ms > 0, "the profiler saw no device time in a warm epoch")
    # where the host's part of a warm epoch goes: one more epoch under
    # cProfile (its overhead inflates Python-heavy functions; read the
    # shares, not the seconds)
    import cProfile
    import pstats

    cprof = cProfile.Profile()
    t0 = time.perf_counter()
    cprof.enable()
    m._run_epochs(idx_seqs, 1)
    torch.cuda.synchronize()
    cprof.disable()
    t_cprofiled = time.perf_counter() - t0
    stats = pstats.Stats(cprof).stats
    host_top = sorted(((v[2], f"{Path(k[0]).name}:{k[1]} {k[2]}", v[1])
                       for k, v in stats.items()), reverse=True)[:10]
    # bench_word2vec's rate and batch overshoot: a frequent word's hundreds
    # of summed updates a batch grow its rows without bound, in the JAX
    # package alike (tests/test_torch_word2vec.py holds the two packages
    # together there); reported, not checked
    finite = torch.isfinite(m.params["syn0"])
    table_state = {"syn0_finite_share": float(finite.float().mean()),
                   "syn0_max_abs_finite": (float(m.params["syn0"][finite].abs().max())
                                           if bool(finite.any()) else None)}
    n_tok = W2V_CORPUS["tokens"]
    e2e = {"corpus_tokens": n_tok, "vocab": len(m.vocab), "pairs_per_epoch": n_pairs,
           "batches_per_epoch": -(-n_pairs // B),
           "scan_chunks_per_epoch": n_pairs // (B * W2V_SCAN_BATCHES),
           "split_s": {"vocab_build": t_vocab, "first_epoch_cold": t_fit_cold,
                       "warm_epoch": t_epoch_warm, "host_pair_generation": t_host},
           "pairs_stepped_warm_epoch": stepped[0], "tables_after_3_epochs": table_state,
           "tokens_per_s": n_tok / (t_vocab / 2 + t_epoch_warm),
           "tokens_per_s_cold": n_tok / (t_vocab + t_fit_cold),
           "warm_epoch_profiled_s": t_profiled, "device_busy_ms": busy_ms,
           "idle_share_profiled": 1.0 - busy_ms / (t_profiled * 1e3),
           "idle_share_vs_unprofiled_epoch": 1.0 - busy_ms / (t_epoch_warm * 1e3),
           "host_cprofile": {"epoch_s": t_cprofiled,
                             "top_by_own_time": [{"s": t_, "fn": f, "calls": n_}
                                                 for t_, f, n_ in host_top]}}
    stage["end_to_end"] = time.perf_counter()
    del m
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "word2vec", "config": dict(W2V, **W2V_CORPUS), "step": fused,
            "other_steps": others, "scan_chunk": chunk, "end_to_end": e2e,
            "stage_s": {k: stage[k] - stage[p] for p, k in zip(list(stage)[:-1],
                                                                list(stage)[1:])},
            "tolerances": {"update_rel": W2V_UPDATE_REL, "loss_rel": W2V_LOSS_REL,
                           "chunk_rel": W2V_CHUNK_REL, "negatives_z": W2V_NEG_Z},
            "launches": _kernel_launches(),
            "glove_slice": corpus[:GLOVE_TOKENS // W2V_CORPUS["sent_len"]]}


def _topic_corpus():
    """Sentences drawn each from one of EMB_TOPICS' disjoint word sets."""
    T_ = EMB_TOPICS
    rs = np.random.RandomState(T_["seed"])
    words = [[f"t{k}w{i}" for i in range(T_["words"])] for k in range(T_["topics"])]
    sents = [" ".join(rs.choice(words[s % T_["topics"]], T_["length"]))
             for s in range(T_["sentences"])]
    return words, sents


def _within_across(vec, groups) -> dict:
    """Mean cosine similarity within the groups and across them."""
    unit = {}
    for g in groups:
        for w in g:
            v = np.asarray(vec(w), np.float64)
            unit[w] = v / max(np.linalg.norm(v), 1e-12)
    within, across = [], []
    for a, ga in enumerate(groups):
        for b, gb in enumerate(groups):
            for i, x in enumerate(ga):
                for y in gb[(i + 1 if a == b else 0):]:
                    (within if a == b else across).append(unit[x] @ unit[y])
    return {"within": float(np.mean(within)), "across": float(np.mean(across))}


def _clique_graph(Graph):
    k, m = CLIQUES["size"], CLIQUES["count"]
    g = Graph(k * m)
    for b in range(m):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(b * k + i, b * k + j)
    for b in range(m - 1):
        g.add_edge(b * k + k - 1, (b + 1) * k)
    return g, [list(range(b * k, (b + 1) * k)) for b in range(m)]


def embeddings_phase(corpus_slice) -> dict:
    """Phase 27: the embedding libraries on the card: Word2Vec (SG NS, SG HS,
    CBOW NS / HS) and ParagraphVectors (DBOW, DM; infer_vector) on a
    planted-topic corpus, GloVe on a 200,000-token slice of the word2vec
    corpus, DeepWalk and Node2Vec on a chain of cliques, the serializer's
    three formats round trip, and DistributedWord2Vec on a world-size-1 NCCL
    group against plain Word2Vec.fit."""
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph, Node2Vec
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec
    from deeplearning4j_tpu_torch.nlp.embeddings import ParagraphVectors, Word2Vec
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer as Ser
    from deeplearning4j_tpu_torch.parallel import init_distributed, shutdown_distributed

    words, sents = _topic_corpus()
    out = {"phase": "embeddings", "topic_corpus": EMB_TOPICS, "conf": EMB_CONF,
           "pv_conf": PV_CONF, "word2vec": {}}
    modes = {"sg_ns": {}, "sg_hs": {"use_hierarchic_softmax": True},
             "cbow_ns": {"elements_learning": "cbow"},
             "cbow_hs": {"elements_learning": "cbow", "use_hierarchic_softmax": True}}
    sg = None
    for name, kw in modes.items():
        t0 = time.perf_counter()
        m = Word2Vec(**EMB_CONF, **kw).fit(sents)
        torch.cuda.synchronize()
        r = _within_across(m.get_word_vector, words)
        r["fit_s"] = time.perf_counter() - t0
        check(m.params["syn0"].device.type == _CUDA.type, f"{name} did not train on the card")
        check(r["within"] > r["across"], f"{name}: topics not separated: {r}")
        out["word2vec"][name] = r
        if name == "sg_ns":
            sg = m
    labels = [[f"t{k}d{s}" for s in range(k, len(sents) // 4, EMB_TOPICS["topics"])]
              for k in range(EMB_TOPICS["topics"])]
    docs = [(sents[s], f"t{s % EMB_TOPICS['topics']}d{s}") for s in range(len(sents) // 4)]
    out["paragraph_vectors"] = {}
    for mode in ("dbow", "dm"):
        t0 = time.perf_counter()
        pv = ParagraphVectors(sequence_learning=mode, **PV_CONF)
        pv.fit_documents(docs)
        torch.cuda.synchronize()
        r = _within_across(pv.get_label_vector, labels)
        r["fit_s"] = time.perf_counter() - t0
        check(r["within"] > r["across"], f"PV-{mode}: documents not separated by topic: {r}")
        text = " ".join(np.random.RandomState(99).choice(words[0], EMB_TOPICS["length"]))
        inferred = pv.infer_vector(text)
        sims = [float(np.mean([pv.similarity_to_label(text, l) for l in labels[k][:5]]))
                for k in range(EMB_TOPICS["topics"])]
        r["infer_vector"] = {"finite": bool(np.isfinite(inferred).all()),
                             "similarity_to_topic_labels": sims}
        check(np.isfinite(inferred).all(), f"PV-{mode}: infer_vector not finite")
        check(int(np.argmax(sims)) == 0, f"PV-{mode}: inferred topic-0 text nearest {sims}")
        out["paragraph_vectors"][mode] = r

    # GloVe on a 200,000-token slice: the weighted cost over every
    # co-occurrence before and after
    t0 = time.perf_counter()
    g = Glove(layer_size=W2V["dim"], window=5, epochs=GLOVE_EPOCHS, batch_size=W2V["batch"],
              seed=12345).fit(corpus_slice)
    torch.cuda.synchronize()
    glove_s = time.perf_counter() - t0
    ii, jj, xx = g._cooccurrences(corpus_slice)
    ii, jj, xx = (torch.from_numpy(a.astype(np.int64) if a.dtype != np.float32 else a)
                  .to(_CUDA) for a in (ii, jj, xx))
    f = torch.clamp((xx / g.x_max) ** g.alpha, max=1.0)

    def cost(W, Wc, b, bc):
        diff = (W[ii] * Wc[jj]).sum(-1) + b[ii] + bc[jj] - torch.log(xx)
        return float(0.5 * torch.mean(f * diff * diff))

    rs = np.random.RandomState(12345)
    V, D = len(g.vocab), W2V["dim"]
    init = [torch.from_numpy((rs.rand(V, D).astype(np.float32) - 0.5) / D).to(_CUDA)
            for _ in range(2)] + [torch.zeros(V, device=_CUDA)] * 2
    out["glove"] = {"tokens": sum(len(s) for s in corpus_slice), "vocab": V,
                    "cooccurrences": int(ii.numel()), "epochs": GLOVE_EPOCHS,
                    "batch": W2V["batch"], "fit_s": glove_s, "cost_init": cost(*init),
                    "cost_trained": cost(*(g.params[k] for k in ("W", "Wc", "b", "bc")))}
    check(np.isfinite(g.syn0).all(), "GloVe tables not finite")
    check(out["glove"]["cost_trained"] < out["glove"]["cost_init"],
          f"GloVe did not lower its cost: {out['glove']}")
    del g, ii, jj, xx, f, init

    # DeepWalk and Node2Vec on a chain of cliques
    graph, cliques = _clique_graph(Graph)
    t0 = time.perf_counter()
    dw = DeepWalk(vector_size=64, window_size=4, batch_size=4096, seed=7).fit(
        graph, walk_length=20, epochs=3)
    torch.cuda.synchronize()
    r = _within_across(dw.get_vertex_vector, cliques)
    r["fit_s"] = time.perf_counter() - t0
    r["nearest_of_0"] = dw.vertices_nearest(0, CLIQUES["size"] - 1)
    check(r["within"] > r["across"], f"DeepWalk: vertices not clustered by clique: {r}")
    out["deepwalk"] = r
    t0 = time.perf_counter()
    n2v = Node2Vec(vector_size=64, window=4, walk_length=20, walks_per_vertex=10, p=1.0,
                   q=2.0, epochs=2, batch_size=4096, learning_rate=0.05, seed=7).fit(graph)
    torch.cuda.synchronize()
    r = _within_across(n2v.get_vertex_vector, cliques)
    r["fit_s"] = time.perf_counter() - t0
    check(r["within"] > r["across"], f"Node2Vec: vertices not clustered by clique: {r}")
    out["node2vec"] = r
    out["graph"] = {"vertices": graph.num_vertices(), **CLIQUES}

    # the serializer's three formats, written from the card-trained model
    want = sg.syn0
    ser = {}
    with tempfile.TemporaryDirectory() as tmp:
        for write, read, ext in (("write_word_vectors", "load_txt_vectors", "txt"),
                                 ("write_binary", "read_binary", "bin"),
                                 ("write_word2vec_model", "read_word2vec_model", "zip")):
            path = os.path.join(tmp, f"w2v.{ext}")
            getattr(Ser, write)(sg, path)
            back = getattr(Ser, read)(path)
            same_words = [w.word for w in back.vocab.words] == [w.word for w in sg.vocab.words]
            err = float(np.abs(back.syn0 - want).max())
            ser[ext] = {"bytes": os.path.getsize(path), "max_abs_err": err,
                        "vocab_equal": same_words}
            # the text format keeps 6 significant digits
            check(same_words and (err <= 1e-5 * np.abs(want).max() if ext == "txt"
                                  else err == 0.0), f"serializer {ext} round trip: {ser[ext]}")
    out["serializer"] = ser

    # DistributedWord2Vec on a world-size-1 NCCL group against plain fit
    conf = {k: v for k, v in EMB_CONF.items() if k != "epochs"}
    init_distributed(f"tcp://localhost:{_free_port()}", 1, 0, timeout_s=120)
    try:
        backend = torch.distributed.get_backend()
        d = DistributedWord2Vec(rounds=1, epochs_per_round=2, **conf).fit(sents)
        dist_syn0 = d.params["syn0"].clone()
        dist_vocab = [w.word for w in d.vocab.words]
    finally:
        shutdown_distributed()
    p = Word2Vec(epochs=2, **conf).fit(sents)
    rel = float((dist_syn0 - p.params["syn0"]).norm() / p.params["syn0"].norm())
    out["distributed"] = {"backend": backend, "world_size": 1, "rounds": 1,
                          "epochs_per_round": 2, "vocab_equal": dist_vocab == [
                              w.word for w in p.vocab.words],
                          "bit_equal": bool(torch.equal(dist_syn0, p.params["syn0"])),
                          "syn0_rel_diff": rel, "tol": W2V_FIT_REL}
    check(out["distributed"]["vocab_equal"] and rel <= W2V_FIT_REL,
          f"DistributedWord2Vec off plain fit: {out['distributed']}")
    out["launches"] = _kernel_launches()
    del sg, d, p, dw, n2v
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phases 28-29 ------------------------------------------------------------

# (A): bench.py:1591-1650 bench_vector_search, uncut
SEARCH_A = dict(n=100_000, dim=64, centers=256, seed=42, queries=200, k=10)
SEARCH_A_CONF = dict(dim=64, nlist=256, nprobe=8, max_k=16, batch_max=1, k_choices=(16,),
                     train_sample=20000, kmeans_iters=8, pending_cap=0)
# (B): SIFT1M's shape (1,000,000 x 128 f32), clustered synthetic data from a seed
SEARCH_B = dict(n=1_000_000, dim=128, centers=1024, seed=7, queries=256, k=10,
                clients=8, per_client=16, add=1000)
SEARCH_B_CONF = dict(dim=128, nlist=1024, nprobe=16, pq_m=16, batch_max=32, pending_cap=1024)
SEARCH_RECALL_MIN = 0.9     # bench_vector_search's own gate: IVF against exact at (A)
# two runs' distances this close are one tie under f32 rounding (the
# ||q||^2 - 2q.x + ||x||^2 expansion at ||x||^2 ~ 1e3 rounds ~1e-6 of d^2)
SEARCH_TIE_RTOL = 1e-5
TSNE = dict(n=2500, dim=50, clusters=10, seed=5, n_iter=1000, parity_iter=10, parity_lr=10.0)
TSNE_KNN_MIN = 0.9          # 10-NN accuracy of the embedding's planted labels
KMEANS_CPU_ROWS = 20000     # the k-means card-vs-CPU comparison's rows
# the card's centres against float64 means of their points on the host:
# f32 sums of up to the whole corpus on the card, relative to max |centre|
KMEANS_MEAN_RTOL = 1e-4
# a point the card and the CPU assign differently must be a near-tie: its
# distances to the two centres agree within this (relative to the distance)
KMEANS_TIE_RTOL = 1e-4
# 10 steps card vs CPU at learning rate 10, of the embedding's scale (the
# JAX package and the port on one CPU part by 2.2e-5 there; at the default
# rate 200 by 3.7e-3: t-SNE amplifies rounding, so that one is reported)
TSNE_PARITY_REL = 1e-3
BH_TSNE = dict(n=500, n_iter=40)
CLI_WAIT_S = 180            # the CLI subprocess: import, index build, bind


def _bench_vectors(n, dim, n_centers, n_q, seed):
    """bench_vector_search's data: centres 4 N(0, 1), points and queries a
    centre + N(0, 1), from RandomState(seed)."""
    rs = np.random.RandomState(seed)
    centers = (4.0 * rs.randn(n_centers, dim)).astype(np.float32)
    corpus = (centers[rs.randint(0, n_centers, n)] + rs.randn(n, dim)).astype(np.float32)
    queries = (centers[rs.randint(0, n_centers, n_q)] + rs.randn(n_q, dim)).astype(np.float32)
    return corpus, queries


def _sift_shaped(n, dim, n_centers, n_q, seed):
    """(B)'s data, as (A)'s but drawn in float32 from a Generator (bulk)."""
    g = np.random.default_rng(seed)
    centers = 4.0 * g.standard_normal((n_centers, dim), dtype=np.float32)
    corpus = centers[g.integers(0, n_centers, n)]
    corpus += g.standard_normal((n, dim), dtype=np.float32)
    queries = centers[g.integers(0, n_centers, n_q)]
    queries += g.standard_normal((n_q, dim), dtype=np.float32)
    return corpus, queries


def _recall(got, want) -> float:
    k = want.shape[1]
    return float(np.mean([np.intersect1d(a[a >= 0], b).size / k for a, b in zip(got, want)]))


def _ids_vs(ids_a, d_a, ids_b, d_b) -> dict:
    """Rows whose ids differ, and how many of them are ties under f32
    rounding (their distance lists agree within SEARCH_TIE_RTOL)."""
    rows = np.nonzero((ids_a != ids_b).any(axis=1))[0]
    tie = [int(r) for r in rows
           if np.allclose(d_a[r], d_b[r], rtol=SEARCH_TIE_RTOL, atol=0)]
    return {"rows": int(ids_a.shape[0]), "rows_differing": int(rows.size),
            "rows_tie": len(tie), "rows_not_tie": [int(r) for r in rows if r not in tie][:8]}


def _pctl(a) -> dict:
    a = np.asarray(a)
    return {"p50_ms": float(np.percentile(a, 50)), "p99_ms": float(np.percentile(a, 99)),
            "n": int(a.size)}


def _http_json(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def search_phase() -> dict:
    """Phase 28: vector search on the card. (A) bench_vector_search's
    configuration uncut: build, warm, 200 single queries per tier (host
    clock), recall@10 of IVF against exact (>= 0.9), the exact tier's ids
    against the CPU port's; then TF32 switched on process-wide, which the
    library's products must not take. (B) a 1,000,000 x 128 corpus served
    through register_index and InferenceServer: build, recall of IVF and
    IVF-PQ, one coalesced 32-query dispatch per tier by CUDA events beside
    the bytes bound of an exact scan, coalesced against solo at the same
    bucket (bit for bit) and at bucket 1 (the largest difference), single
    queries over HTTP from 8 concurrent clients, add of 1,000 rows visible
    before and after merge_pending, a save/load round trip, /knn, /knnnew
    and /status, peak memory."""
    from deeplearning4j_tpu_torch.search import IndexConfig, VectorIndex
    from deeplearning4j_tpu_torch.search import program as sp

    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "search", "a": {"conf": dict(SEARCH_A, index=SEARCH_A_CONF)},
           "b": {"conf": dict(SEARCH_B, index=SEARCH_B_CONF)}}

    # -- (A) --------------------------------------------------------------
    A, ra = SEARCH_A, out["a"]
    corpus, queries = _bench_vectors(A["n"], A["dim"], A["centers"], A["queries"], A["seed"])
    t0 = time.perf_counter()
    ix = VectorIndex.build(corpus, IndexConfig(**SEARCH_A_CONF))
    torch.cuda.synchronize()
    ra["build_s"] = time.perf_counter() - t0
    check(ix._corpus.device.type == "cuda", "(A): the index is not on the card")
    t0 = time.perf_counter()
    ra["warmed_signatures"] = ix.warm()
    ra["warm_s"] = time.perf_counter() - t0
    lat, ids, dist = {}, {}, {}
    for tier in ("exact", "ivf"):
        lat[tier], got = [], []
        for i in range(A["queries"]):
            t0 = time.perf_counter()
            got.append(ix.search(queries[i:i + 1], k=A["k"], tier=tier))
            lat[tier].append((time.perf_counter() - t0) * 1e3)
        ids[tier] = np.concatenate([g[0] for g in got])
        dist[tier] = np.concatenate([g[1] for g in got])
        ra[tier] = _pctl(lat[tier])
    ra["recall_at_10_ivf"] = _recall(ids["ivf"], ids["exact"])
    ra["ivf_p99_below_exact_p99"] = bool(ra["ivf"]["p99_ms"] < ra["exact"]["p99_ms"])
    ra["build_stats"] = dict(ix.stats)
    check(ra["recall_at_10_ivf"] >= SEARCH_RECALL_MIN,
          f"(A): IVF recall@10 {ra['recall_at_10_ivf']} < {SEARCH_RECALL_MIN}")
    cpu = VectorIndex.build(corpus, IndexConfig(**dict(SEARCH_A_CONF, ivf=False,
                                                       batch_max=32)), device="cpu")
    ci, cd = cpu.search(queries, k=A["k"], tier="exact")
    ra["exact_card_vs_cpu"] = _ids_vs(ids["exact"], dist["exact"], ci, cd)
    check(not ra["exact_card_vs_cpu"]["rows_not_tie"],
          f"(A): exact ids differ card vs CPU beyond ties: {ra['exact_card_vs_cpu']}")
    del cpu
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ti, td = ix.search(queries[:1], k=A["k"], tier="exact")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ra["tf32_on_bit_equal"] = bool(np.array_equal(ti, ids["exact"][:1])
                                   and np.array_equal(td, dist["exact"][:1]))
    check(ra["tf32_on_bit_equal"], "(A): a search under process-wide TF32 changed its answer")
    out["a_corpus"], out["a_queries"] = corpus, queries   # the clustering phase's input
    del ix

    # -- (B) --------------------------------------------------------------
    B, rb = SEARCH_B, out["b"]
    t0 = time.perf_counter()
    corpus, queries = _sift_shaped(B["n"], B["dim"], B["centers"], B["queries"], B["seed"])
    rb["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix = VectorIndex.build(corpus, IndexConfig(**SEARCH_B_CONF))
    torch.cuda.synchronize()
    rb["build_s"] = time.perf_counter() - t0
    rb["layout"] = {"capacity": int(ix._corpus.shape[0]), "list_width": int(ix._postings.shape[1]),
                    "nlist": int(ix._centroids.shape[0]), "corpus_bytes": int(corpus.nbytes)}
    reg = ModelRegistry()
    t0 = time.perf_counter()
    reg.register_index("sift", ix)
    rb["register_warm_s"] = time.perf_counter() - t0
    srv = InferenceServer(reg).start(port=0)
    try:
        res = {t: ix.search(queries, k=B["k"], tier=t) for t in ix.available_tiers()}
        rb["recall_at_10"] = {t: _recall(res[t][0], res["exact"][0]) for t in ("ivf", "ivf_pq")}
        rb["build_stats"] = dict(ix.stats)

        # one coalesced 32-query dispatch per tier, device time
        q32 = torch.as_tensor(queries[:32], device=ix.device)
        kb, p = 16, ix.nprobe_choices[0]
        calls = {
            "exact": lambda: sp.exact_topk(q32, ix._corpus, ix._cnorms, ix.n, 0, kb),
            "ivf": lambda: sp.ivf_topk(q32, ix._centroids, ix._postings, ix._sizes,
                                       ix._corpus, ix._cnorms, p, kb),
            "ivf_pq": lambda: sp.pq_topk(q32, ix._centroids, ix._postings, ix._sizes,
                                         ix._codes, ix._codebooks, ix._corpus, ix._cnorms,
                                         p, kb, ix.rerank_width(kb)),
        }
        with torch.inference_mode():
            rb["dispatch_32_ms"] = {t: time_device(fn, 10) for t, fn in calls.items()}
        rb["exact_scan_bound_ms"] = ix.n * B["dim"] * 4 / PEAK_BYTES * 1e3
        rb["dispatch_32_bound"] = "bytes: the corpus read once (exact)"

        # coalesced against solo: at the same bucket (32) bit for bit; alone at bucket 1
        rb["coalesced_vs_solo"] = {}
        pad = np.zeros((31, B["dim"]), np.float32)
        for t in ix.available_tiers():
            bi, bd = ix.search(queries[:32], k=B["k"], tier=t)
            same = [ix.search(np.concatenate([queries[i:i + 1], pad]), k=B["k"], tier=t)
                    for i in range(32)]
            alone = [ix.search(queries[i:i + 1], k=B["k"], tier=t) for i in range(32)]
            eq = all(np.array_equal(s[0][0], bi[i]) and np.array_equal(s[1][0], bd[i])
                     for i, s in enumerate(same))
            ai = np.concatenate([a[0] for a in alone])
            ad = np.concatenate([a[1] for a in alone])
            rb["coalesced_vs_solo"][t] = {
                "same_bucket_bit_equal": bool(eq),
                "bucket1_max_abs_diff": float(np.abs(ad - bd).max()),
                "bucket1_ids": _ids_vs(ai, ad, bi, bd)}
            check(eq, f"(B) {t}: a coalesced answer differs from the same query alone "
                      "at the same bucket")

        # single queries over HTTP, 8 concurrent clients, per tier
        rb["http"] = {}
        for t in ix.available_tiers():
            lats = []
            lock = threading.Lock()

            def client(c, t=t):
                for j in range(B["per_client"]):
                    q = queries[(c * B["per_client"] + j) % B["queries"]]
                    t0 = time.perf_counter()
                    body = _http_json(srv.port, "/v1/search",
                                      {"index": "sift", "queries": [q.tolist()],
                                       "k": B["k"], "tier": t})
                    ms = (time.perf_counter() - t0) * 1e3
                    check(body["tier"] == t and len(body["ids"][0]) == B["k"],
                          f"(B) HTTP {t}: {body}")
                    with lock:
                        lats.append(ms)

            threads = [threading.Thread(target=client, args=(c,)) for c in range(B["clients"])]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            wall = time.perf_counter() - t0
            check(len(lats) == B["clients"] * B["per_client"], f"(B) HTTP {t}: lost requests")
            rb["http"][t] = dict(_pctl(lats), qps=len(lats) / wall)
        rb["http"]["batches"] = reg.searcher("sift").stats()["batches"]

        # the legacy routes on the same server
        st = _http_json(srv.port, "/status")
        check(st == {"ok": True, "points": ix.n + ix._pending_n, "dim": B["dim"]},
              f"(B) /status: {st}")
        knn = _http_json(srv.port, "/knn", {"ndarray": 5, "k": 4})["results"]
        check(len(knn) == 4 and all(r["index"] != 5 for r in knn), f"(B) /knn: {knn}")
        new = _http_json(srv.port, "/knnnew", {"ndarray": corpus[11].tolist(), "k": 3})["results"]
        # a row's distance to itself is the square root of the expansion's
        # rounding: ~0.03 at ||x||^2 ~ 2e3
        check(new[0]["index"] == 11 and new[0]["distance"] < 0.1 and len(new) == 3,
              f"(B) /knnnew: {new}")
        rb["legacy_routes"] = {"status": st, "knn": knn, "knnnew": new}

        # add 1,000 rows: visible before and after merge_pending
        g = np.random.default_rng(B["seed"] + 1)
        added = (6.0 * g.standard_normal((B["add"], B["dim"]), dtype=np.float32))
        t0 = time.perf_counter()
        new_ids = ix.add(added)
        rb["add_s"] = time.perf_counter() - t0
        check(list(new_ids) == list(range(B["n"], B["n"] + B["add"])), "(B) add: ids")
        probe = added[::10] + np.float32(0.01)
        want = new_ids[::10]
        rb["add_visible"] = {}
        for stage in ("pending", "merged"):
            if stage == "merged":
                t0 = time.perf_counter()
                moved = ix.merge_pending()
                rb["merge_s"] = time.perf_counter() - t0
                check(moved == B["add"] and ix._pending_n == 0, "(B) merge_pending")
            for t in ix.available_tiers():
                top = ix.search(probe, k=1, tier=t)[0][:, 0]
                rb["add_visible"][f"{stage}_{t}"] = float(np.mean(top == want))
                check(np.array_equal(top, want), f"(B) added rows not found ({stage}, {t})")

        # save / load round trip
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sift.zip")
            t0 = time.perf_counter()
            ix.save(path)
            rb["save_s"] = time.perf_counter() - t0
            rb["save_bytes"] = os.path.getsize(path)
            t0 = time.perf_counter()
            ix2 = VectorIndex.load(path)
            torch.cuda.synchronize()
            rb["load_s"] = time.perf_counter() - t0
            for t in ix.available_tiers():
                a, b = ix.search(queries[:64], k=B["k"], tier=t), ix2.search(queries[:64], k=B["k"], tier=t)
                check(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]),
                      f"(B) {t}: the loaded index answers otherwise")
            del ix2
    finally:
        srv.stop()
    rb["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["b_corpus"] = corpus
    del ix
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tsne_kl(x, y, perplexity) -> float:
    """KL(P || Q) of an embedding, from the module's own P (on the card)."""
    from deeplearning4j_tpu_torch.clustering import knn, tsne

    n = x.shape[0]
    p = tsne._binary_search_perplexity(knn.pairwise_distance(x, x, "sqeuclidean"), perplexity)
    p = ((p + p.T) / (2.0 * n)).clamp_min(1e-12)
    yt = torch.as_tensor(y, device=p.device, dtype=torch.float64)
    num = 1.0 / (1.0 + torch.cdist(yt, yt) ** 2)
    num.fill_diagonal_(0.0)
    q = (num / num.sum()).clamp_min(1e-12)
    p = p.double()
    return float((p * torch.log(p / q)).sum())


def _knn_label_accuracy(y, labels, k=10) -> float:
    yt = torch.as_tensor(y, device=_CUDA)
    d = torch.cdist(yt, yt)
    d.fill_diagonal_(float("inf"))
    nn = d.topk(k, largest=False).indices.cpu().numpy()
    return float((labels[nn] == labels[:, None]).mean())


def _kmeans_on_host(km, corpus) -> dict:
    """The card's full-corpus k-means result held on the host: every
    centre with points is their mean (float64 sums of its assignments), and
    one more assignment of the whole corpus to those centres agrees between
    the card and the CPU port (``assign_points``)."""
    from deeplearning4j_tpu_torch.clustering.kmeans import assign_points

    k = km.centers.shape[0]
    counts = np.bincount(km.assignments, minlength=k)
    sums = np.zeros((k, corpus.shape[1]))
    np.add.at(sums, km.assignments, corpus.astype(np.float64))
    live = counts > 0
    means = sums[live] / counts[live][:, None]
    scale = max(1.0, float(np.abs(km.centers).max()))
    mean_diff = float(np.abs(km.centers[live] - means).max())
    t0 = time.perf_counter()
    card_a, card_d = assign_points(corpus, km.centers)
    cpu_a, cpu_d = assign_points(corpus, km.centers, device="cpu")
    seconds = time.perf_counter() - t0
    differ = card_a != cpu_a
    # a differing assignment must be a near-tie: both centres as close
    tie = np.abs(card_d[differ] - cpu_d[differ]) <= KMEANS_TIE_RTOL * np.maximum(
        1.0, np.abs(cpu_d[differ]))
    res = {"rows": int(len(corpus)), "live_centres": int(live.sum()),
           "centre_vs_mean_max_abs_diff": mean_diff, "tol": KMEANS_MEAN_RTOL * scale,
           "assign_seconds": seconds, "assignments_differ": int(differ.sum()),
           "differ_not_tie": int((~tie).sum())}
    check(mean_diff <= KMEANS_MEAN_RTOL * scale,
          f"k-means centres are not their points' means on the host: {res}")
    check(res["differ_not_tie"] == 0,
          f"card and CPU assign the corpus differently beyond ties: {res}")
    return res


def clustering_phase(a_corpus, a_queries, b_corpus) -> dict:
    """Phase 29: the clustering library on the card: KMeansClustering(256,
    20) on (A)'s corpus against the CPU port; knn_search on (B)'s corpus
    chunked against unchunked; RandomProjectionLSH(16, 8, 64) on (A),
    recall@10 against exact cosine; exact Tsne on 2,500 x 50 points in 10
    planted clusters, 1000 steps (seconds, KL, 10-NN accuracy, its first 10
    steps against the CPU port, peak memory); BarnesHutTsne(method=
    "barnes_hut") on 500 points; NearestNeighborsServer over (A)'s points
    (/knn, /knnnew, /status, the manhattan fallback); the CLI as a
    subprocess, asked once and stopped."""
    from deeplearning4j_tpu_torch.clustering import (
        BarnesHutTsne, KMeansClustering, NearestNeighborsServer, RandomProjectionLSH, Tsne,
        knn_search)

    out = {"phase": "clustering"}
    # k-means on the card, then card against the CPU port on the first
    # KMEANS_CPU_ROWS rows (the whole corpus took the card's host 31 s)
    t0 = time.perf_counter()
    km = KMeansClustering(256, 20).apply_to(a_corpus)
    out["kmeans_s"] = time.perf_counter() - t0
    out["kmeans_full_corpus_on_host"] = _kmeans_on_host(km, a_corpus)
    part = a_corpus[:KMEANS_CPU_ROWS]
    kg = KMeansClustering(256, 20).apply_to(part)
    t0 = time.perf_counter()
    kc = KMeansClustering(256, 20, device="cpu").apply_to(part)
    out["kmeans_cpu_s"] = time.perf_counter() - t0
    out["kmeans_card_vs_cpu"] = {
        "rows": int(len(part)),
        "max_center_diff": float(np.abs(kg.centers - kc.centers).max()),
        "equal_assignments": float(np.mean(kg.assignments == kc.assignments))}
    check(np.isfinite(km.centers).all() and km.centers.shape == (256, a_corpus.shape[1]),
          "k-means centres")

    # knn_search on (B): chunked against unchunked
    q = b_corpus[:256] + np.float32(0.5)
    t0 = time.perf_counter()
    ui, ud = knn_search(b_corpus, q, 10)
    out["knn_unchunked_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ci, cd = knn_search(b_corpus, q, 10, chunk_size=262144)
    out["knn_chunked_s"] = time.perf_counter() - t0
    out["knn_chunked_vs_unchunked"] = _ids_vs(ci, cd, ui, ud)
    check(not out["knn_chunked_vs_unchunked"]["rows_not_tie"],
          f"knn_search chunked != unchunked: {out['knn_chunked_vs_unchunked']}")

    # LSH on (A): recall@10 against exact cosine
    t0 = time.perf_counter()
    lsh = RandomProjectionLSH(16, 8, a_corpus.shape[1])
    lsh.make_index(a_corpus)
    want, _ = knn_search(a_corpus, a_queries, 10, metric="cosinedistance")
    hits = []
    for i, qv in enumerate(a_queries):
        rows = lsh.search(qv, k=10)
        got = {r.tobytes() for r in rows}
        hits.append(sum(a_corpus[j].tobytes() in got for j in want[i]) / 10.0)
    out["lsh"] = {"s": time.perf_counter() - t0, "recall_at_10_vs_exact_cosine": float(np.mean(hits))}

    # exact t-SNE on 2,500 x 50 in 10 planted clusters
    T = TSNE
    rs = np.random.RandomState(T["seed"])
    centers = (4.0 * rs.randn(T["clusters"], T["dim"])).astype(np.float32)
    labels = rs.randint(0, T["clusters"], T["n"])
    x = (centers[labels] + rs.randn(T["n"], T["dim"])).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    y = Tsne(n_iter=T["n_iter"]).fit_transform(x)
    torch.cuda.synchronize()
    out["tsne"] = {"s": time.perf_counter() - t0, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   "kl": _tsne_kl(x, y, 30.0), "knn10_accuracy": _knn_label_accuracy(y, labels)}
    out["tsne"]["peak_bytes_per_n2"] = out["tsne"]["peak_memory_bytes"] / T["n"] ** 2
    check(np.isfinite(y).all(), "t-SNE: non-finite embedding")
    check(out["tsne"]["knn10_accuracy"] >= TSNE_KNN_MIN, f"t-SNE: {out['tsne']}")
    rel = {}
    for lr in (T["parity_lr"], 200.0):
        yg = Tsne(n_iter=T["parity_iter"], learning_rate=lr).fit_transform(x)
        yc = Tsne(n_iter=T["parity_iter"], learning_rate=lr, device="cpu").fit_transform(x)
        rel[f"lr{lr:g}"] = float(np.abs(yg - yc).max() / np.abs(yc).max())
    out["tsne"]["first_steps_card_vs_cpu_rel"] = rel
    check(rel[f"lr{T['parity_lr']:g}"] <= TSNE_PARITY_REL,
          f"t-SNE: {T['parity_iter']} steps card vs CPU {rel}")

    # Barnes-Hut t-SNE on 500 points (host trees)
    xb, lb = x[:BH_TSNE["n"]], labels[:BH_TSNE["n"]]
    t0 = time.perf_counter()
    yb = BarnesHutTsne(method="barnes_hut", n_iter=BH_TSNE["n_iter"]).fit_transform(xb)
    out["bh_tsne"] = {"s": time.perf_counter() - t0, "n_iter": BH_TSNE["n_iter"],
                      "knn10_accuracy": _knn_label_accuracy(yb, lb)}
    check(np.isfinite(yb).all() and yb.shape == (BH_TSNE["n"], 2), "Barnes-Hut t-SNE")

    # NearestNeighborsServer over (A)'s points, index route and legacy fallback
    out["nn_server"] = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for sim in ("euclidean", "manhattan"):
            t0 = time.perf_counter()
            srv = NearestNeighborsServer(a_corpus, similarity_function=sim).start(0)
            try:
                st = _http_json(srv.port, "/status")
                knn = _http_json(srv.port, "/knn", {"ndarray": 3, "k": 5})["results"]
                new = _http_json(srv.port, "/knnnew", {"ndarray": a_corpus[9].tolist(),
                                                       "k": 2})["results"]
            finally:
                srv.stop()
            check(st == {"ok": True, "points": a_corpus.shape[0], "dim": a_corpus.shape[1]},
                  f"NN server {sim} /status: {st}")
            check(len(knn) == 5 and all(r["index"] != 3 for r in knn), f"NN {sim} /knn: {knn}")
            check(new[0]["index"] == 9 and new[0]["distance"] < 0.1, f"NN {sim} /knnnew: {new}")
            out["nn_server"][sim] = {"s": time.perf_counter() - t0, "knn": knn, "knnnew": new,
                                     "legacy": sim != "euclidean"}

    # the CLI, as a user starts it
    with tempfile.TemporaryDirectory() as tmp:
        pts = os.path.join(tmp, "points.npy")
        np.save(pts, a_corpus)
        port = _free_port()
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "deeplearning4j_tpu_torch.clustering",
                                 "--points", pts, "--port", str(port)],
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        st = None
        try:
            while st is None and proc.poll() is None and time.perf_counter() - t0 < CLI_WAIT_S:
                try:
                    st = _http_json(port, "/status")
                except OSError:
                    time.sleep(0.5)
            ready = time.perf_counter() - t0
            check(st is not None, f"CLI: no answer in {ready:.0f} s (exit {proc.poll()})")
            new = _http_json(port, "/knnnew", {"ndarray": a_corpus[7].tolist(), "k": 3})["results"]
            check(new[0]["index"] == 7, f"CLI /knnnew: {new}")
        finally:
            proc.terminate()
            try:
                text = proc.communicate(timeout=30)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                text = proc.communicate(timeout=30)[0]
        out["cli"] = {"ready_s": ready, "status": st, "knnnew": new,
                      "stdout": text.strip().splitlines()[:2]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phases 30-31 -------------------------------------------------------------

# model_import: the char-RNN at full width (Adam 1e-3 so that the zip carries
# moments), fitted IMPORT_FIT_STEPS tBPTT steps of IMPORT_ROWS rows, exported,
# served by the CLI to IMPORT_CLIENTS concurrent clients of IMPORT_CLIENT_ROWS
# rows each, sampled IMPORT_SAMPLE_STEPS one-step calls and fine-tuned
# IMPORT_TUNE_STEPS steps beside the original
IMPORT_ROWS, IMPORT_FIT_STEPS, IMPORT_TUNE_STEPS = 128, 2, 2
IMPORT_CLIENTS, IMPORT_CLIENT_ROWS, IMPORT_SAMPLE_STEPS = 4, 2, 10
IMPORT_CLI_WAIT_S = 300      # the serving CLI: import, warm over its buckets, bind
# the CLI's replies against the exporting model's output on the card: f32,
# the same kernels, rows coalesced into another batch than the reference's
IMPORT_SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
# the fine-tuned import against the original, and ResNet50's fit steps on
# both: the same kernels (cuDNN's deterministic algorithms for ResNet50) on
# bit-equal params and moments, so bit for bit is expected; each tensor is
# held within this share of its norm, and the largest difference reported
IMPORT_TUNE_REL = 1e-6
IMPORT_RESNET_BATCH, IMPORT_RESNET_STEPS = 32, 2
HAVE_H5PY = importlib.util.find_spec("h5py") is not None
# data_path: MNIST-sized IDX files (uncompressed) and a numeric CSV table
MNIST_ROWS, MNIST_BATCH, MNIST_SCORE_ROWS = 60_000, 128, 2048
CSV_ROWS, CSV_FEATURES, CSV_CLASSES, CSV_BATCH, CSV_STEPS = 1_000_000, 10, 5, 4096, 20


def _charrnn_data(rows, T, V, seed):
    ids = np.random.RandomState(seed).randint(0, V, (rows, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _tree_rel(a: list, b: list) -> float:
    """Largest per-tensor ||a - b|| / ||b|| over two leaf lists."""
    check(len(a) == len(b), f"{len(a)} leaves against {len(b)}")
    worst = 0.0
    for x, y in zip(a, b):
        den = y.float().norm().item()
        worst = max(worst, (x.float() - y.float()).norm().item() / (den if den > 0 else 1.0))
    return worst


def _held(a_tree, b_tree, what: str) -> dict:
    a, b = _host_leaves(a_tree), _host_leaves(b_tree)
    res = {"bits_equal": _bits_equal(a, b), "max_abs_diff": _max_diff(a, b),
           "max_rel_diff": _tree_rel(a, b)}
    check(res["bits_equal"] or res["max_rel_diff"] <= IMPORT_TUNE_REL,
          f"{what}: {res}")
    return res


def _lstm_routes(model) -> list:
    """The recurrence each LSTM layer of ``model`` takes on the card."""
    from deeplearning4j_tpu_torch.nn.layers import LSTM

    out = []
    for i, layer in enumerate(model.layers):
        if isinstance(layer, LSTM):
            if layer._fused_eligible():
                route = "kernels #4/#5, %s route" % fl.lstm_route(layer.n_out, model.dtype,
                                                                  "fwd")[0]
            else:
                route = "the plain step loop (not fused-eligible)"
            out.append({"layer": i, "type": type(layer).__name__, "hidden": layer.n_out,
                        "gate_activation": layer.gate_activation, "route": route})
    return out


def _serve_cli(zip_path: str, tmp: Path, probe: np.ndarray, want: torch.Tensor) -> dict:
    """``python -m deeplearning4j_tpu_torch.serve charrnn=<zip> --port 0`` as a
    subprocess; IMPORT_CLIENTS concurrent :predict clients, each reply held
    to the exporting model's rows; the time from start to the first reply."""
    log = tmp / "serve_cli.log"
    t0 = time.perf_counter()
    with open(log, "w") as sink:
        proc = subprocess.Popen([sys.executable, "-m", "deeplearning4j_tpu_torch.serve",
                                 f"charrnn={zip_path}", "--port", "0"],
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=sink, stderr=subprocess.STDOUT, text=True)
    try:
        port = None
        while port is None and proc.poll() is None and \
                time.perf_counter() - t0 < IMPORT_CLI_WAIT_S:
            for line in log.read_text().splitlines():
                if line.startswith("serving "):
                    port = int(line.rsplit(":", 1)[1])
            if port is None:
                time.sleep(0.2)
        bound_s = time.perf_counter() - t0
        check(port is not None, f"serving CLI: no port in {bound_s:.0f} s (exit "
                                f"{proc.poll()}): {log.read_text()[-2000:]}")
        done = [None] * IMPORT_CLIENTS

        def client(i):
            rows = probe[i * IMPORT_CLIENT_ROWS:(i + 1) * IMPORT_CLIENT_ROWS]
            status, payload, dt = post_predict(port, "charrnn", rows.tolist(), 600_000)
            done[i] = time.perf_counter()
            return status, payload, dt

        results = run_concurrently(client, [(i,) for i in range(IMPORT_CLIENTS)])
        errs = []
        for i, (status, payload, _) in enumerate(results):
            check(status == 200, f"serving CLI client {i}: HTTP {status}")
            got = torch.as_tensor(np.asarray(payload["outputs"], np.float32))
            ref = want[i * IMPORT_CLIENT_ROWS:(i + 1) * IMPORT_CLIENT_ROWS]
            errs.append((got - ref).abs().max().item())
            check(tuple(got.shape) == tuple(ref.shape)
                  and bool(torch.allclose(got, ref, **IMPORT_SERVE_TOL)),
                  f"serving CLI client {i}: reply differs from the exporting model by "
                  f"{errs[-1]}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return {"clients": IMPORT_CLIENTS, "rows_per_client": IMPORT_CLIENT_ROWS,
            "start_to_bound_s": bound_s, "start_to_first_reply_s": min(done) - t0,
            "latency_s": [r[2] for r in results], "max_abs_err": max(errs),
            "tol": IMPORT_SERVE_TOL, "log_head": log.read_text().splitlines()[:3]}


def _charrnn_import(tmp: Path, launches: dict) -> dict:
    from deeplearning4j_tpu_torch.modelimport import export_dl4j_zip, import_dl4j_zip

    V, T = LSTM_CONF["vocab_size"], LSTM_CONF["timesteps"]
    conf = zoo.TextGenerationLSTM(**LSTM_CONF, updater={"type": "adam", "lr": 1e-3})
    src = MultiLayerNetwork(conf).init()
    x, y = _charrnn_data(IMPORT_ROWS * IMPORT_FIT_STEPS, T, V, 21)
    src.fit((x, y), epochs=1, batch_size=IMPORT_ROWS)
    check(src.iteration == IMPORT_FIT_STEPS, f"char-RNN fit: iteration {src.iteration}")
    zpath = str(tmp / "charrnn_dl4j.zip")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_dl4j_zip(src, zpath)
    export_s = time.perf_counter() - t0
    with zipfile.ZipFile(zpath) as zf:
        entries = sorted(zf.namelist())
    check(entries == ["coefficients.bin", "configuration.json", "updaterState.bin"],
          f"char-RNN zip entries {entries}")
    probe = x[:IMPORT_CLIENTS * IMPORT_CLIENT_ROWS]
    want = src.output(probe).cpu()
    res = {"model": "TextGenerationLSTM", "vocab": V, "T": T, "hidden": LSTM_CONF["hidden"],
           "updater": conf.updater, "fit_steps": IMPORT_FIT_STEPS,
           "zip_bytes": os.path.getsize(zpath), "export_s": export_s}

    # serving in process through ModelRegistry.load: every launch is counted
    _zero_all_kernel_counts()
    reg = ModelRegistry()
    try:
        t0 = time.perf_counter()
        reg.load("charrnn", zpath)
        load_s = time.perf_counter() - t0
        got = torch.as_tensor(np.asarray(reg.worker("charrnn").submit(probe), np.float32))
        launches["serve_registry"] = _kernel_launches()
        err = (got - want).abs().max().item()
        check(bool(torch.allclose(got, want, **IMPORT_SERVE_TOL)),
              f"ModelRegistry.load: output differs from the exporting model by {err}")
    finally:
        reg.shutdown()
    check(launches["serve_registry"]["fused_lstm_fwd"] > 0,
          f"ModelRegistry.load served the imported char-RNN without kernel #4: "
          f"{launches['serve_registry']}")
    res["registry"] = {"load_and_warm_s": load_s, "max_abs_err": err,
                       "tol": IMPORT_SERVE_TOL}
    res["serve_cli"] = _serve_cli(zpath, tmp, probe, want)

    t0 = time.perf_counter()
    imp = import_dl4j_zip(zpath)
    torch.cuda.synchronize()
    res["import_s"] = time.perf_counter() - t0
    check(imp.iteration == src.iteration, f"imported iteration {imp.iteration}")
    res["imported_vs_original"] = {
        "params": _held(imp.params, src.params, "imported char-RNN params"),
        "opt_state": _held(imp.opt_state, src.opt_state, "imported char-RNN Adam moments")}
    res["routes"] = _lstm_routes(imp)

    # sampling from the import: one-step calls, 2 launches of kernel #4 each
    eye = torch.eye(V, device="cuda")
    _zero_all_kernel_counts()
    imp.rnn_clear_previous_state()
    out = imp.rnn_time_step(torch.as_tensor(probe, device="cuda"))
    for _ in range(IMPORT_SAMPLE_STEPS):
        out = imp.rnn_time_step(eye[(out[:, -1] if out.dim() == 3 else out).argmax(-1)])
    torch.cuda.synchronize()
    launches["sample"] = _kernel_launches()
    check(launches["sample"]["fused_lstm_fwd"] == 2 * (IMPORT_SAMPLE_STEPS + 1),
          f"sampling the import: {launches['sample']}")
    imp.rnn_clear_previous_state()

    # fine-tuning the import beside the original: kernel #5 on the import's path
    x2, y2 = _charrnn_data(IMPORT_ROWS * IMPORT_TUNE_STEPS, T, V, 22)
    _zero_all_kernel_counts()
    imp.fit((x2, y2), epochs=1, batch_size=IMPORT_ROWS)
    torch.cuda.synchronize()
    launches["finetune"] = _kernel_launches()
    src.fit((x2, y2), epochs=1, batch_size=IMPORT_ROWS)
    check(launches["finetune"]["fused_lstm_bwd"] > 0 and launches["finetune"]["fused_lstm_fwd"] > 0,
          f"fine-tuning the import without kernels #4/#5: {launches['finetune']}")
    res["finetune"] = {"steps": IMPORT_TUNE_STEPS, "iteration": imp.iteration,
                       "params": _held(imp.params, src.params, "fine-tuned params"),
                       "opt_state": _held(imp.opt_state, src.opt_state, "fine-tuned moments"),
                       "tol_rel": IMPORT_TUNE_REL}
    del src, imp
    return res


def _resnet_import(tmp: Path, launches: dict) -> dict:
    from deeplearning4j_tpu_torch.modelimport import export_dl4j_zip, import_dl4j_zip

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        src = ComputationGraph(ResNet50(height=RESNET["size"], width=RESNET["size"],
                                        num_classes=RESNET["classes"])).init()
        check(src.dtype == torch.float32 and src.conf.updater["type"] == "adam",
              f"ResNet50 import: {src.dtype}, {src.conf.updater}")
        x, y = _resnet_images(IMPORT_RESNET_BATCH, 5)
        xt, yt = torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")
        src.fit_batch((xt, yt))          # non-zero Adam moments in the zip
        zpath = str(tmp / "resnet50_dl4j.zip")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_dl4j_zip(src, zpath)
        export_s = time.perf_counter() - t0
        _zero_all_kernel_counts()
        t0 = time.perf_counter()
        imp = import_dl4j_zip(zpath, input_type=[InputType.convolutional(
            RESNET["size"], RESNET["size"], 3)])
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        res = {"model": "ResNet50", "input": [RESNET["size"], RESNET["size"], 3],
               "classes": RESNET["classes"], "dtype": "float32", "batch": IMPORT_RESNET_BATCH,
               "zip_bytes": os.path.getsize(zpath), "export_s": export_s,
               "import_s": import_s,
               "imported_vs_original": {
                   "params": _held(imp.params, src.params, "ResNet50 params"),
                   "state": _held(imp.state, src.state, "ResNet50 BatchNorm state"),
                   "opt_state": _held(imp.opt_state, src.opt_state, "ResNet50 moments")}}
        got, want = imp.output(xt), src.output(xt)
        res["output"] = _held([got], [want], "ResNet50 output")
        check(tuple(got.shape) == (IMPORT_RESNET_BATCH, RESNET["classes"])
              and bool(torch.isfinite(got).all()), f"ResNet50 output {tuple(got.shape)}")
        losses = {"import": [], "original": []}
        for _ in range(IMPORT_RESNET_STEPS):
            losses["import"].append(float(imp.fit_batch((xt, yt))))
            losses["original"].append(float(src.fit_batch((xt, yt))))
        torch.cuda.synchronize()
        launches["resnet50"] = _kernel_launches()
        res["fit"] = {"steps": IMPORT_RESNET_STEPS, "losses": losses,
                      "params": _held(imp.params, src.params, "ResNet50 params after fit"),
                      "opt_state": _held(imp.opt_state, src.opt_state,
                                         "ResNet50 moments after fit"),
                      "cudnn_deterministic": True}
        del src, imp, xt, yt
    finally:
        torch.backends.cudnn.deterministic = det
    return res


def _keras_charrnn(launches: dict) -> dict:
    """A Keras Sequential config of the char-RNN's shape (LSTM x2 with
    return_sequences, sigmoid gates, then a per-step softmax Dense: what
    TimeDistributed(Dense) computes, written as Keras 2 applies a Dense to
    3-D input; the importer has no TimeDistributed converter), weights from
    the seed in Keras layouts, through the config + weight-dict route."""
    from deeplearning4j_tpu_torch.modelimport import model_from_config

    V, T, H = LSTM_CONF["vocab_size"], LSTM_CONF["timesteps"], LSTM_CONF["hidden"]
    lstm = dict(units=H, return_sequences=True, activation="tanh",
                recurrent_activation="sigmoid")
    cfg = {"class_name": "Sequential", "config": {"name": "charrnn", "layers": [
        {"class_name": "InputLayer", "config": {"batch_input_shape": [None, T, V],
                                                "name": "chars"}},
        {"class_name": "LSTM", "config": dict(lstm, name="lstm_1")},
        {"class_name": "LSTM", "config": dict(lstm, name="lstm_2")},
        {"class_name": "Dense", "config": {"name": "probs", "units": V,
                                           "activation": "softmax"}}]}}
    rs = np.random.RandomState(31)

    def glorot(n_in, n_out):
        lim = np.sqrt(6.0 / (n_in + n_out))
        return rs.uniform(-lim, lim, (n_in, n_out)).astype(np.float32)

    weights = {"lstm_1": [glorot(V, 4 * H), glorot(H, 4 * H), np.zeros(4 * H, np.float32)],
               "lstm_2": [glorot(H, 4 * H), glorot(H, 4 * H), np.zeros(4 * H, np.float32)],
               "probs": [glorot(H, V), np.zeros(V, np.float32)]}
    for name in ("lstm_1", "lstm_2"):
        weights[name][2][H:2 * H] = 1.0           # Keras' unit_forget_bias
    x, _ = _charrnn_data(IMPORT_ROWS, T, V, 23)
    t0 = time.perf_counter()
    gpu = model_from_config(json.dumps(cfg), weights)
    import_s = time.perf_counter() - t0
    cpu = model_from_config(cfg, weights, device="cpu")
    _zero_all_kernel_counts()
    got = gpu.output(x)
    torch.cuda.synchronize()
    launches["keras"] = _kernel_launches()
    got = got.cpu()
    want = cpu.output(x)
    tol = TOL[torch.float32]
    err = (got - want).abs().max().item()
    check(launches["keras"]["fused_lstm_fwd"] == 2,
          f"the Keras char-RNN's output: {launches['keras']}")
    check(tuple(got.shape) == (IMPORT_ROWS, T, V) and bool(torch.allclose(got, want, **tol)),
          f"the Keras char-RNN on the card differs from the CPU by {err}")
    return {"layers": "LSTM(256, return_sequences) x2, Dense(77, softmax) per step",
            "import_s": import_s, "rows": IMPORT_ROWS, "max_abs_err": err, "tol": tol,
            "routes": _lstm_routes(gpu), "params": gpu.num_params()}


def _keras_h5_fixtures(launches: dict) -> dict:
    """Every committed tests/fixtures/keras_*.h5 through import_model on the
    card, held to its golden (tests/test_modelimport_r3.py's tolerance)."""
    from deeplearning4j_tpu_torch.modelimport import import_model

    fix = Path(__file__).resolve().parent / "tests" / "fixtures"
    tol = dict(rtol=1e-4, atol=1e-5)
    out = {}
    _zero_all_kernel_counts()
    for path in sorted(fix.glob("keras_*.h5")):
        io_ = np.load(str(path)[:-3] + "_io.npz")
        got = import_model(str(path)).output(io_["x"]).float().cpu().numpy()
        err = float(np.abs(got - io_["y"]).max())
        check(np.allclose(got, io_["y"], **tol), f"{path.name} on the card: max err {err}")
        out[path.stem] = err
    launches["keras_h5"] = _kernel_launches()
    check(len(out) == 17, f"{len(out)} Keras fixtures")
    return {"fixtures": len(out), "max_abs_err": out, "tol": tol}


def model_import_phase(tmp: Path) -> dict:
    """Phase 30: a DL4J zip and a Keras model onto the card, served and
    fine-tuned (module docstring, phase 30)."""
    launches = {}
    res = {"phase": "model_import", "charrnn": _charrnn_import(tmp, launches)}
    gc.collect()
    torch.cuda.empty_cache()
    res["resnet50"] = _resnet_import(tmp, launches)
    gc.collect()
    torch.cuda.empty_cache()
    res["keras_charrnn"] = _keras_charrnn(launches)
    if HAVE_H5PY:
        res["keras_h5"] = _keras_h5_fixtures(launches)
    else:
        res["keras_h5"] = ("h5py is not installed on this host: the HDF5 container "
                           "is covered by the CPU tests alone "
                           "(tests/test_torch_keras_import.py)")
    for path, n in launches.items():
        flash = {k: v for k, v in n.items() if "lstm" not in k}
        _check_no_kernel(flash, f"model_import {path}")
    res["launches_by_path"] = launches
    return res


def _write_idx(data_dir: Path, n: int, seed: int):
    """MNIST-sized uncompressed IDX files from the seed: a template per class
    plus pixel noise, so that the classes can be learnt."""
    rs = np.random.RandomState(seed)
    templates = rs.rand(10, 28, 28).astype(np.float32)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    imgs = np.empty((n, 28, 28), np.uint8)
    for i in range(0, n, 10_000):
        s = slice(i, min(i + 10_000, n))
        noise = rs.rand(s.stop - s.start, 28, 28).astype(np.float32)
        imgs[s] = ((0.6 * templates[labels[s]] + 0.4 * noise) * 255).astype(np.uint8)
    (data_dir / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    (data_dir / "train-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, n) + labels.tobytes())
    return imgs, labels


def _mnist_dataset_cli(tmp: Path) -> dict:
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator

    data_dir = tmp / "data"
    data_dir.mkdir()
    t0 = time.perf_counter()
    imgs, labels = _write_idx(data_dir, MNIST_ROWS, 51)
    write_s = time.perf_counter() - t0
    conf = zoo.LeNet5()
    (tmp / "lenet.json").write_text(conf.to_json())
    out_zip = tmp / "lenet_mnist.zip"
    log = tmp / "train_cli.log"
    env = dict(os.environ, DL4J_TPU_DATA=str(data_dir))
    t0 = time.perf_counter()
    with open(log, "w") as sink:
        rc = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.train",
                             str(tmp / "lenet.json"), "--dataset", "mnist", "--epochs", "1",
                             "--batch-size", str(MNIST_BATCH), "--output", str(out_zip)],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=sink, stderr=subprocess.STDOUT, timeout=600).returncode
    cli_s = time.perf_counter() - t0
    text = log.read_text()
    check(rc == 0, f"train CLI --dataset mnist: exit {rc}: {text[-2000:]}")
    line = next((l for l in text.splitlines() if l.startswith("dataset mnist:")), "")
    m = re.match(r"dataset mnist: (\d+) examples, synthetic=(\w+), native parses (\{.*\})",
                 line)
    check(m is not None, f"train CLI: no dataset line in {text[-2000:]}")
    parses = json.loads(m.group(3).replace("'", '"'))
    check(int(m.group(1)) == MNIST_ROWS and m.group(2) == "False"
          and parses["parse_idx_images"] >= 1,
          f"train CLI read {line!r}: not the local IDX files through the C++ parser")
    n = MNIST_SCORE_ROWS
    xs = (imgs[:n].astype(np.float32) / 255.0)[..., None]
    ys = np.eye(10, dtype=np.float32)[labels[:n]]
    before = MultiLayerNetwork(conf).init().score((xs, ys))
    after = restore_network(str(out_zip)).score((xs, ys))
    check(np.isfinite(after) and after < before,
          f"LeNet-5 trained on MNIST by the CLI: loss {before} -> {after}")

    # the fetch and one epoch in process, timed (the launches are counted)
    calls = dict(native.CALLS)
    old = os.environ.get("DL4J_TPU_DATA")
    os.environ["DL4J_TPU_DATA"] = str(data_dir)
    try:
        t0 = time.perf_counter()
        it = MnistDataSetIterator(MNIST_BATCH, train=True)
        fetch_s = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("DL4J_TPU_DATA")
        else:
            os.environ["DL4J_TPU_DATA"] = old
    check(not it.synthetic and native.CALLS["parse_idx_images"] == calls["parse_idx_images"] + 1,
          f"MnistDataSetIterator: synthetic={it.synthetic}, native calls {native.CALLS}")
    model = MultiLayerNetwork(conf).init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit(it, epochs=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    return {"images": MNIST_ROWS, "idx_bytes": imgs.nbytes + 16, "write_s": write_s,
            "cli": {"seconds": cli_s, "dataset_line": line, "loss_before": before,
                    "loss_after": after, "score_rows": n},
            "fetch_s": fetch_s, "fetch_images_per_s": MNIST_ROWS / fetch_s,
            "epoch_s": epoch_s, "epoch_images_per_s": MNIST_ROWS / epoch_s,
            "batch": MNIST_BATCH, "iterations": model.iteration}


def _csv_table(tmp: Path) -> dict:
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import (
        CSVRecordReader, EarlyTerminationDataSetIterator, Normalizer,
        NormalizerStandardize, RecordReaderDataSetIterator, Schema, TransformProcess)
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.utils.serialization import restore_normalizer

    N, F, K = CSV_ROWS, CSV_FEATURES, CSV_CLASSES
    rs = np.random.RandomState(61)
    feats = (rs.randn(N, F) * 3 + 5).astype(np.float32)
    labels = np.argmax(feats @ rs.randn(F, K) + rs.randn(N, K), axis=1)
    path = tmp / "table.csv"
    t0 = time.perf_counter()
    np.savetxt(path, np.column_stack([feats, labels]), delimiter=",",
               fmt=["%.6g"] * F + ["%d"])
    write_s = time.perf_counter() - t0
    calls = native.CALLS["parse_csv"]
    t0 = time.perf_counter()
    it = RecordReaderDataSetIterator(str(path), CSV_BATCH, label_index=F, num_classes=K,
                                     reader=CSVRecordReader())
    parse_s = time.perf_counter() - t0
    check(native.CALLS["parse_csv"] == calls + 1 and it.rows.shape == (N, F + 1),
          f"CSV parse: native calls {native.CALLS}, rows {it.rows.shape}")
    names = [f"f{i}" for i in range(F)]
    schema = Schema.builder().add_double(*names).add_integer("label").build()
    tp = (TransformProcess.builder(schema).replace_invalid("f0", 0.0)
          .double_math_op("f1", "multiply", 0.5).build())
    t0 = time.perf_counter()
    raw_f1 = it.rows[:, 1].copy()
    it.rows = tp.execute_to_matrix(
        {n: it.rows[:, i] for i, n in enumerate(schema.names())}).astype(np.float32)
    transform_s = time.perf_counter() - t0
    check(np.allclose(it.rows[:, 1], raw_f1 * 0.5) and it.rows.shape == (N, F + 1),
          "TransformProcess output")
    t0 = time.perf_counter()
    norm = NormalizerStandardize().fit(it)
    normalize_fit_s = time.perf_counter() - t0
    it.set_pre_processor(norm)
    conf = MultiLayerConfiguration(
        layers=(Dense(n_out=64, activation="relu"),
                OutputLayer(n_out=K, activation="softmax", loss="mcxent")),
        input_type=InputType.feed_forward(F), updater={"type": "adam", "lr": 1e-2})
    model = MultiLayerNetwork(conf).init()
    first = next(iter(it))
    before = model.score((first.features, first.labels))
    t0 = time.perf_counter()
    model.fit(EarlyTerminationDataSetIterator(it, CSV_STEPS), epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after = model.score((first.features, first.labels))
    check(model.iteration == CSV_STEPS and after < before,
          f"MLP on the CSV table: {model.iteration} steps, loss {before} -> {after}")
    zpath = str(tmp / "mlp_with_normalizer.zip")
    save_network(model, zpath, normalizer=norm.to_dict())
    back = restore_network(zpath)
    bnorm = Normalizer.from_dict(restore_normalizer(zpath))
    check(bnorm.to_dict() == norm.to_dict(), "the normalizer restored from the zip")
    xb = bnorm.transform_features(it.rows[:CSV_BATCH, :F])
    check(torch.equal(back.output(xb), model.output(xb)), "the model restored from the zip")
    return {"rows": N, "features": F, "classes": K, "csv_bytes": path.stat().st_size,
            "write_s": write_s, "parse_s": parse_s, "parse_rows_per_s": N / parse_s,
            "transform_s": transform_s, "normalizer_fit_s": normalize_fit_s,
            "fit_steps": CSV_STEPS, "fit_s": fit_s, "loss_before": before,
            "loss_after": after, "batch": CSV_BATCH}


def data_path_phase(tmp: Path) -> dict:
    """Phase 31: the data path on the card (module docstring, phase 31)."""
    from deeplearning4j_tpu_torch import native

    check(native.available(), f"the C++ parsers did not build: {native.BUILD_ERROR}")
    res = {"phase": "data_path", "native_lib": str(native.lib_path()),
           "mnist": _mnist_dataset_cli(tmp)}
    res["csv"] = _csv_table(tmp)
    res["native_calls"] = dict(native.CALLS)
    return res


# -- phases 32-36: the parallel slice ------------------------------------------
# Two rank processes share the one card over a gloo group (NCCL refuses two
# ranks on one device); the collectives carry CUDA tensors, staged through
# host memory where gloo takes none (parallel/comm.py). This measures that
# the parallel paths are right and run the kernels at their sharded shapes,
# not the speed of NCCL between cards.
PAR_RANKS = 2
PAR_TIMEOUT_S = 300        # the ranks of one phase together, start-up included
TP_ROWS, TP_STEPS, TP_OUT_ROWS = 8, 3, 2
# the output of the tensor-parallel model against the single-process model
# from the same params, bf16: each rank's row-parallel product is rounded to
# bf16 before the all-reduce, so a logit can land one bf16 ulp away (2^-5
# in [4, 8): a probability 3.2% off; 2^-4 in [8, 16): 6.5%); max |err|
# within 7e-2 of max |ref|
TP_OUTPUT_REL = 7e-2
# the gradient-normalized TP case (its threshold: half the smallest
# first-step norm of the normalized layers)
TP_GN_MODE = "clip_l2_per_layer"
DP_STEPS = 3
DP_SPLITS = {"even": (64, 64), "uneven": (70, 58)}
# ParallelWrapper against the single-process fit on the same 128 rows, f32:
# the mean of two 64-row gradients (or of two padded 128-row ones) against
# one 128-row gradient, the LSTM kernels' f32 sums in another order; per
# tensor ||diff|| / ||ref|| of the params after 3 RMSProp steps
DP_PARAM_REL = 1e-4
# the compressed exchange's conservation, per step: decoded sum + new
# residuals against the dense sum + old residuals, f32 rounding of sums of
# two ranks' values, relative to the largest |dense sum + old residual|
DP_CONSERVE_REL = 1e-6
DP_THRESHOLD = 1e-3
GP_MICRO = 4
# 60,000 = 937 x 64 + 32: the tail batch is a rung of the bucket ladder, so
# neither run pads a batch and the two must agree bit for bit
DP_CLI_BATCH = 64
PI_THREADS, PI_REQUESTS, PI_MAX_ROWS = 8, 10, 20


def _rank_main(argv) -> int:
    """A rank of one parallel phase: ``chip_smoke.py _rank <phase> <rank>
    <world> <root>`` (parallel/launch.py spawn_ranks). Joins a gloo group
    over the card, runs its part and writes ``<root>/rank<r>.json``."""
    from deeplearning4j_tpu_torch.parallel import init_distributed, shutdown_distributed

    phase, rank, world, root = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    init_distributed(f"file://{root}/store", world, rank, backend="gloo", timeout_s=240)
    try:
        res = {"tp": _tp_rank, "dp": _dp_rank, "gpipe": _gpipe_rank}[phase](rank, root)
    finally:
        shutdown_distributed()
    res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    (root / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def _spawn(phase: str, root: Path) -> list:
    from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks

    here = os.path.abspath(__file__)
    secs = spawn_ranks([sys.executable, here, "_rank", phase], PAR_RANKS, root, PAR_TIMEOUT_S,
                       cwd=os.path.dirname(here))
    out = [json.loads((root / f"rank{r}.json").read_text()) for r in range(PAR_RANKS)]
    for r in out:
        r["ranks_seconds"] = secs
    return out


def _events(n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _tp_inputs():
    conf = zoo.TransformerLM(updater={"type": "adam", "lr": TRAIN_LR}, **FLAGSHIP_CONF)
    V, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    x = np.random.RandomState(51).randint(0, V, (TP_ROWS, T)).astype(np.int64)
    return conf, x, np.roll(x, -1, axis=1)


def _tp_rank(rank: int, root: Path) -> dict:
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ShardedTrainer, make_mesh

    conf, x, y = _tp_inputs()
    model = MultiLayerNetwork(conf).init()          # the parent's params: one seed
    trainer = ShardedTrainer(model, make_mesh(MeshSpec(model=PAR_RANKS)))
    want_out = torch.load(root / "ref_out.pt")
    out = trainer.output(x[:TP_OUT_ROWS]).float().cpu()
    out_rel = ((out - want_out).abs().max() / want_out.abs().max()).item()
    attn = model.params[2]["attn"]["Wqkv"]
    C, H = FLAGSHIP_CONF["d_model"], FLAGSHIP_CONF["n_heads"]
    local_heads = attn.shape[1] // (3 * (C // H))
    # the first step's gradients, gathered, against the one-process ones
    from deeplearning4j_tpu_torch.nn.model import _cast_labels

    _, _, g = trainer.value_and_grad(model._features(x), _cast_labels(y, model.dtype, model.device),
                                     None, None, None, TP_ROWS)
    grads = _host_leaves(tuple(trainer._gather_tree(gi, lay)
                               for gi, lay in zip(g, trainer.layouts)))
    del g
    grad_cmp = _tp_compare(grads, torch.load(root / "ref_grads.pt"), C)
    del grads
    _zero_all_kernel_counts()
    ev = _events(TP_STEPS + 1)
    ev[0].record()
    losses = []
    for i in range(TP_STEPS):
        losses.append(trainer.fit_batch(x, y))
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = _kernel_launches()
    whole = _host_leaves(trainer.gathered_params())
    want = torch.load(root / "ref_params.pt")
    out = {"losses": [float(l) for l in losses], "launches": launches,
           "local_heads": local_heads, "step_ms": [ev[i].elapsed_time(ev[i + 1])
                                                   for i in range(TP_STEPS)],
           "bit_equal": _bits_equal(whole, want), "params": _tp_compare(whole, want, C),
           "grads": grad_cmp, "output_rel": out_rel,
           "param_sums": [float(t.double().sum()) for t in whole]}
    mesh = trainer.mesh
    del trainer, model, whole, want
    gc.collect()
    torch.cuda.empty_cache()
    out["gn"] = _tp_gn_rank(root, mesh, C)
    return out


def _tp_gn_conf(threshold: float):
    """The phase's TransformerLM with clip_l2_per_layer on every
    TransformerBlock (attention and FFN) and on the output layer."""
    import dataclasses

    conf, _, _ = _tp_inputs()
    layers = tuple(dataclasses.replace(l, gradient_normalization=TP_GN_MODE,
                                       gradient_normalization_threshold=threshold)
                   if type(l).__name__ in ("TransformerBlock", "RnnOutputLayer") else l
                   for l in conf.layers)
    return dataclasses.replace(conf, layers=layers)


def _tp_gn_rank(root: Path, mesh, C: int) -> dict:
    """The gradient-normalized case on this rank: a new model from the seed
    with ``_tp_gn_conf``, TP_STEPS steps, the kernels' launches, the
    gathered params against the one-process run's."""
    from deeplearning4j_tpu_torch.parallel import ShardedTrainer

    _, x, y = _tp_inputs()
    gn = json.loads((root / "gn.json").read_text())
    model = MultiLayerNetwork(_tp_gn_conf(gn["threshold"])).init()
    trainer = ShardedTrainer(model, mesh)
    _zero_all_kernel_counts()
    ev = _events(TP_STEPS + 1)
    ev[0].record()
    losses = []
    for i in range(TP_STEPS):
        losses.append(trainer.fit_batch(x, y))
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = _kernel_launches()
    whole = _host_leaves(trainer.gathered_params())
    want = torch.load(root / "ref_gn_params.pt")
    return {"losses": [float(l) for l in losses], "launches": launches,
            "step_ms": [ev[i].elapsed_time(ev[i + 1]) for i in range(TP_STEPS)],
            "bit_equal": _bits_equal(whole, want), "params": _tp_compare(whole, want, C),
            "param_sums": [float(t.double().sum()) for t in whole]}


def _tp_compare(got: list, want: list, C: int) -> dict:
    """Per-tensor ||got - want|| / ||want|| of two leaf lists, the worst five
    named by index and shape. The key bias (the middle third of every bqkv
    [3C]) has a zero gradient in exact arithmetic (softmax ignores a shift
    shared by all keys): its gradient is rounding noise and Adam moves it by
    that noise, so it is reported apart and left out of the rest."""
    key_bias, sq_diff, sq_ref = 0.0, 0.0, 0.0
    rels = []
    for i, (a, b) in enumerate(zip(got, want)):
        sq_diff += (a.float() - b.float()).norm().item() ** 2
        sq_ref += b.float().norm().item() ** 2
        a, b = a.float(), b.float()
        if a.shape == (3 * C,):
            key_bias = max(key_bias, (a[C:2 * C] - b[C:2 * C]).abs().max().item())
            a, b = torch.cat([a[:C], a[2 * C:]]), torch.cat([b[:C], b[2 * C:]])
        den = b.norm().item()
        rels.append(((a - b).norm().item() / (den if den > 0 else 1.0), i,
                     list(a.shape), den, (a - b).abs().max().item()))
    rels.sort(reverse=True)
    return {"max_rel": rels[0][0], "all_rel": (sq_diff / max(sq_ref, 1e-30)) ** 0.5,
            "key_bias_max_abs_diff": key_bias,
            "worst": [dict(zip(("rel", "leaf", "shape", "norm", "max_abs_diff"), r))
                      for r in rels[:5]]}


def tp_train_phase(tmp: Path) -> dict:
    """Phase 32: ShardedTrainer over model=2 (tensor parallelism), two gloo
    ranks on the card, the full-width TransformerLM (bf16, Adam 1e-4) for 3
    steps on 8 x 2048 tokens, against MultiLayerNetwork._fit_batch from the
    same params in this process (run first and freed)."""
    t0 = time.perf_counter()
    conf, x, y = _tp_inputs()
    torch.cuda.reset_peak_memory_stats()
    ref = MultiLayerNetwork(conf).init()
    torch.save(ref.output(x[:TP_OUT_ROWS]).float().cpu(), tmp / "ref_out.pt")
    _, _, g, _ = ref._value_and_grad(ref.state, ref._features(x),
                                     torch.from_numpy(y).to(ref.device), None, None, None)
    torch.save(_host_leaves(g), tmp / "ref_grads.pt")
    # the gradient-normalized case clips at half the smallest first-step
    # norm of the layers it normalizes, so every one of them clips
    gn_norms = [float(torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tree_leaves(g[i]))))
                for i, l in enumerate(ref.layers)
                if type(l).__name__ in ("TransformerBlock", "RnnOutputLayer")]
    gn_threshold = 0.5 * min(gn_norms)
    del g
    ev = _events(TP_STEPS + 1)
    ev[0].record()
    ref_losses = []
    for i in range(TP_STEPS):
        ref_losses.append(ref._fit_batch(x, y, None, None))
        ev[i + 1].record()
    torch.cuda.synchronize()
    ref_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TP_STEPS)]
    ref_losses = [float(l) for l in ref_losses]
    ref_peak = torch.cuda.max_memory_allocated()
    torch.save(_host_leaves(ref.params), tmp / "ref_params.pt")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    gref = MultiLayerNetwork(_tp_gn_conf(gn_threshold)).init()
    gn_ref_losses = [float(gref._fit_batch(x, y, None, None)) for _ in range(TP_STEPS)]
    torch.save(_host_leaves(gref.params), tmp / "ref_gn_params.pt")
    (tmp / "gn.json").write_text(json.dumps({"threshold": gn_threshold}))
    del gref
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _spawn("tp", tmp)
    res = {"phase": "tp_train", "backend": "gloo", "ranks": PAR_RANKS,
           "mesh": {"data": 1, "model": PAR_RANKS, "seq": 1, "pipe": 1},
           "model": {k: FLAGSHIP_CONF[k] for k in ("vocab_size", "max_len", "d_model",
                                                   "n_heads", "n_blocks", "dtype")},
           "rows": TP_ROWS, "steps": TP_STEPS, "ref_losses": ref_losses,
           "ref_step_ms": ref_ms, "ref_peak_memory_bytes": ref_peak,
           "ranks_detail": [{k: r[k] for k in r if k not in ("param_sums", "gn")}
                            for r in ranks],
           "gradient_normalization": {
               "mode": TP_GN_MODE, "layers": "TransformerBlock x 8, RnnOutputLayer",
               "threshold": gn_threshold, "first_step_norms": gn_norms,
               "ref_losses": gn_ref_losses,
               "ranks": [{k: v for k, v in r["gn"].items() if k != "param_sums"}
                         for r in ranks]},
           "seconds": time.perf_counter() - t0}
    H = FLAGSHIP_CONF["n_heads"] // PAR_RANKS
    for r, rk in enumerate(ranks):
        check(all(np.isfinite(rk["losses"])), f"tp rank {r}: non-finite loss {rk['losses']}")
        check(rk["grads"]["max_rel"] <= GRAD_CHECK_REL,
              f"tp rank {r}: first-step gradients against _fit_batch's: {rk['grads']}")
        # after 3 Adam steps a zero-initialized bias is its updates alone, and
        # Adam moves an element by about lr whatever its gradient's size, so
        # such biases differ by tens of percent where the gradients (held per
        # tensor above) differ by under 1%: the params are held as one vector
        check(rk["bit_equal"] or (rk["params"]["all_rel"] <= GRAD_CHECK_REL and np.allclose(
            rk["losses"], ref_losses, rtol=GRAD_CHECK_REL)), f"tp rank {r} against _fit_batch: "
            f"{rk['losses']} vs {ref_losses}, params {rk['params']}")
        check(rk["output_rel"] <= TP_OUTPUT_REL, f"tp rank {r} output rel {rk['output_rel']}")
        check(rk["local_heads"] == H, f"tp rank {r}: {rk['local_heads']} local heads, not {H}")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            n = rk["launches"][name]
            check(n == FLAGSHIP_CONF["n_blocks"] * TP_STEPS,
                  f"tp rank {r}: {n} launches of {name} over {TP_STEPS} steps")
    check(ranks[0]["param_sums"] == ranks[1]["param_sums"] and
          ranks[0]["losses"] == ranks[1]["losses"], "tp ranks disagree")
    for r, rk in enumerate(ranks):
        gn = rk["gn"]
        check(all(np.isfinite(gn["losses"])), f"tp gn rank {r}: non-finite loss")
        check(gn["bit_equal"] or (gn["params"]["all_rel"] <= GRAD_CHECK_REL and np.allclose(
            gn["losses"], gn_ref_losses, rtol=GRAD_CHECK_REL)), f"tp gn rank {r} against "
            f"_fit_batch: {gn['losses']} vs {gn_ref_losses}, params {gn['params']}")
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            n = gn["launches"][name]
            check(n == FLAGSHIP_CONF["n_blocks"] * TP_STEPS,
                  f"tp gn rank {r}: {n} launches of {name} over {TP_STEPS} steps")
    check(ranks[0]["gn"]["param_sums"] == ranks[1]["gn"]["param_sums"] and
          ranks[0]["gn"]["losses"] == ranks[1]["gn"]["losses"], "tp gn ranks disagree")
    return res


def _dp_inputs():
    conf = zoo.TextGenerationLSTM(**LSTM_CONF)
    x, y = _charrnn_data(LSTM_SHAPE["B"], LSTM_SHAPE["T"], LSTM_CONF["vocab_size"], 61)
    return conf, x, y


def _dp_rank(rank: int, root: Path) -> dict:
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, comm, grads

    conf, x, y = _dp_inputs()
    want = torch.load(root / "ref_params.pt")
    out = {}

    def rows(split):
        lo = sum(split[:rank])
        return slice(lo, lo + split[rank])

    def run(name, split, **kw):
        sl = rows(split)
        model = MultiLayerNetwork(conf).init()
        pw = ParallelWrapper(model, **kw)
        runner = pw._exchange_runner()
        ex_ms, step_ms = [], []
        real = runner.exchange.update

        def timed_update(*a):
            e = _events(2)
            e[0].record()
            r = real(*a)
            e[1].record()
            ex_ms.append(e)
            return r

        runner.exchange.update = timed_update
        _zero_all_kernel_counts()
        for _ in range(DP_STEPS):
            e = _events(2)
            e[0].record()
            pw.fit((x[sl], y[sl]), epochs=1)
            e[1].record()
            step_ms.append(e)
        torch.cuda.synchronize()
        leaves = _host_leaves(model.params)
        out[name] = {"rows": split[rank], "launches": _lstm_launches(),
                     "step_ms": [a.elapsed_time(b) for a, b in step_ms],
                     "exchange_ms": [a.elapsed_time(b) for a, b in ex_ms],
                     "params_max_rel_diff_vs_single": _tree_rel(leaves, want),
                     "bit_equal_vs_single": _bits_equal(leaves, want),
                     "comm_stats": runner.comm_stats(),
                     "param_sums": [float(t.double().sum()) for t in leaves]}
        return leaves

    even = run("even", DP_SPLITS["even"])
    run("uneven", DP_SPLITS["uneven"])
    sharded = run("sharded", DP_SPLITS["even"], sharded_update=True)
    out["sharded"]["params_max_rel_diff_vs_even"] = _tree_rel(sharded, even)

    # compressed: every step's decoded sum + new residuals against the
    # dense sum + old residuals
    sl = rows(DP_SPLITS["even"])
    model = MultiLayerNetwork(conf).init()
    pw = ParallelWrapper(model, grad_compress=True, compress_threshold=DP_THRESHOLD)
    run_c = pw._exchange_runner()
    run_c.begin()
    decoded = []
    real = grads.compression.decode_gathered
    grads.compression.decode_gathered = lambda *a: decoded.append(real(*a)) or decoded[-1]
    gaps = []
    _zero_all_kernel_counts()
    try:
        xs, ys = x[sl], y[sl]
        for _ in range(DP_STEPS):
            old = {k: v.clone() for k, v in run_c._residual.items()}
            _, _, g, _ = model._value_and_grad(model.state, model._features(xs),
                                               torch.from_numpy(ys).cuda(), None, None, None)
            decoded.clear()
            run_c.fit_batch(xs, ys, None, None)
            for i, key in enumerate(run_c._entries):
                e = run_c._entries[key]
                flat = grads._pad_flat(grads._flat(g[key]).float(), e.n_pad)
                lhs = decoded[i] + comm.all_reduce(run_c._residual[key].clone(), run_c.sub)
                rhs = comm.all_reduce(flat + old[key], run_c.sub)
                gaps.append(((lhs - rhs).abs().max() / rhs.abs().max().clamp_min(1e-30)).item())
        run_c.finish()
    finally:
        grads.compression.decode_gathered = real
    torch.cuda.synchronize()
    out["compressed"] = {"conservation_rel": gaps, "comm_stats": run_c.comm_stats(),
                         "launches": _lstm_launches()}
    return out


def dp_train_phase(tmp: Path) -> dict:
    """Phase 33: ParallelWrapper on two gloo ranks over the card, the
    char-RNN at full width (B 128, T 50, H 256, f32, RMSProp): (a) 64/64
    rows, (b) 70/58 rows, each 3 steps against the single-process fit on the
    128 rows (DP_PARAM_REL); (c) the sharded update against (a); (d) the
    compressed exchange's conservation per step and its bytes against
    dense; the launches of kernels #4/#5 per rank, the exchange's share of a
    step."""
    t0 = time.perf_counter()
    conf, x, y = _dp_inputs()
    ref = MultiLayerNetwork(conf).init()
    for _ in range(DP_STEPS):
        ref._fit_batch(x, y, None, None)
    torch.save(_host_leaves(ref.params), tmp / "ref_params.pt")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _spawn("dp", tmp)
    res = {"phase": "dp_train", "backend": "gloo", "ranks": PAR_RANKS, "splits": DP_SPLITS,
           "steps": DP_STEPS, "tol": DP_PARAM_REL, "compress_threshold": DP_THRESHOLD,
           "ranks_detail": [{c: {k: v for k, v in r[c].items() if k != "param_sums"}
                             for c in r if isinstance(r[c], dict)} for r in ranks],
           "seconds": time.perf_counter() - t0}
    for r, rk in enumerate(ranks):
        for case in ("even", "uneven"):
            c = rk[case]
            check(c["bit_equal_vs_single"] or c["params_max_rel_diff_vs_single"] <= DP_PARAM_REL,
                  f"dp rank {r} {case}: params rel {c['params_max_rel_diff_vs_single']}")
        check(rk["sharded"]["params_max_rel_diff_vs_even"] <= DP_PARAM_REL,
              f"dp rank {r}: sharded update against the replicated one: "
              f"{rk['sharded']['params_max_rel_diff_vs_even']}")
        check(max(rk["compressed"]["conservation_rel"]) <= DP_CONSERVE_REL,
              f"dp rank {r}: compressed conservation {rk['compressed']['conservation_rel']}")
        cs = rk["compressed"]["comm_stats"]
        check(cs["compressed_entries"] == cs["n_entries"] and
              cs["dense_bytes"] >= 4 * cs["wire_bytes"], f"dp rank {r} comm_stats {cs}")
        for case in ("even", "uneven", "sharded", "compressed"):
            # 2 LSTM layers a step; the compressed check runs each step's
            # forward and backward once more for its dense gradient
            per = 4 if case == "compressed" else 2
            for name, n in rk[case]["launches"].items():
                check(n == per * DP_STEPS, f"dp rank {r} {case}: {n} launches of {name}")
    for case in ("even", "uneven", "sharded"):
        check(ranks[0][case]["param_sums"] == ranks[1][case]["param_sums"],
              f"dp ranks disagree ({case})")
    ex = [e / s for rk in ranks for e, s in zip(rk["even"]["exchange_ms"][1:],
                                                  rk["even"]["step_ms"][1:])]
    res["exchange_share_even"] = {"mean": float(np.mean(ex)), "values": ex}
    return res


def _gpipe_rank(rank: int, root: Path) -> dict:
    from deeplearning4j_tpu_torch.parallel import GPipeTrainer, MeshSpec, make_mesh

    conf, x, y = _dp_inputs()
    tr = GPipeTrainer(conf, make_mesh(MeshSpec(pipe=PAR_RANKS)), n_micro=GP_MICRO)
    _zero_all_kernel_counts()
    ev = _events(DP_STEPS + 1)
    ev[0].record()
    losses = []
    for i in range(DP_STEPS):
        losses.append(tr.fit_batch(x, y))
        ev[i + 1].record()
    torch.cuda.synchronize()
    launches = _lstm_launches()
    whole = _host_leaves(tr.to_model().params)
    want = torch.load(root / "ref_params.pt")
    return {"stage": tr.stage, "stage_layers": tr.stage_ranges[tr.stage],
            "losses": [float(l) for l in losses], "launches": launches,
            "step_ms": [ev[i].elapsed_time(ev[i + 1]) for i in range(DP_STEPS)],
            "bit_equal": _bits_equal(whole, want), "params_max_rel_diff": _tree_rel(whole, want)}


def gpipe_train_phase(tmp: Path) -> dict:
    """Phase 34: GPipeTrainer over pipe=2 (two gloo ranks on the card) on
    the char-RNN, n_micro=4, 3 steps, against the port's single-device run
    that micro-batches the same way (microbatched_reference)."""
    from deeplearning4j_tpu_torch.parallel.gpipe import microbatched_reference

    t0 = time.perf_counter()
    conf, x, y = _dp_inputs()
    ref = microbatched_reference(conf, GP_MICRO)
    ev = _events(DP_STEPS + 1)
    ev[0].record()
    ref_losses = []
    for i in range(DP_STEPS):
        ref_losses.append(ref.fit_batch(x, y))
        ev[i + 1].record()
    torch.cuda.synchronize()
    torch.save(_host_leaves(ref.to_model().params), tmp / "ref_params.pt")
    ref_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(DP_STEPS)]
    ref_losses = [float(l) for l in ref_losses]
    del ref
    ranks = _spawn("gpipe", tmp)
    res = {"phase": "gpipe_train", "backend": "gloo", "stages": PAR_RANKS,
           "n_micro": GP_MICRO, "steps": DP_STEPS, "ref_losses": ref_losses,
           "ref_step_ms": ref_ms, "ranks_detail": ranks, "seconds": time.perf_counter() - t0}
    for r, rk in enumerate(ranks):
        check(rk["bit_equal"] or rk["params_max_rel_diff"] <= DP_PARAM_REL,
              f"gpipe stage {r}: params rel {rk['params_max_rel_diff']}")
        check(np.allclose(rk["losses"], ref_losses, rtol=DP_PARAM_REL),
              f"gpipe stage {r}: {rk['losses']} vs {ref_losses}")
        for name, n in rk["launches"].items():
            check(n == GP_MICRO * DP_STEPS,
                  f"gpipe stage {r}: {n} launches of {name} over {DP_STEPS} steps")
    return res


def parallel_inference_phase() -> dict:
    """Phase 35: ParallelInference(mode="batched") over the char-RNN in this
    process: 8 threads send requests of 1-20 rows; each answer against
    model.output on its rows (bit for bit, else within TOL[f32]); a 1 ms
    deadline shed; p50/p99 on the host clock; launches of kernel #4."""
    import concurrent.futures as cf

    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serve.scheduler import ShedError

    t0 = time.perf_counter()
    conf, x, _ = _dp_inputs()
    model = MultiLayerNetwork(conf).init()
    pi = ParallelInference(model, mode="batched", max_batch_size=32, warmup=True)
    rs = np.random.RandomState(71)
    jobs = [(rs.randint(0, len(x) - PI_MAX_ROWS), rs.randint(1, PI_MAX_ROWS + 1))
            for _ in range(PI_THREADS * PI_REQUESTS)]
    _zero_all_kernel_counts()

    def ask(job):
        lo, n = job
        s = time.perf_counter()
        out = pi.output(x[lo:lo + n])
        return out, time.perf_counter() - s

    try:
        with cf.ThreadPoolExecutor(PI_THREADS) as ex:
            answers = list(ex.map(ask, jobs))
    finally:
        pi.shutdown()
    launches = _lstm_launches()
    bits, worst = 0, 0.0
    for (lo, n), (out, _) in zip(jobs, answers):
        want = model.output(x[lo:lo + n]).cpu().numpy()
        bits += int(np.array_equal(out, want))
        worst = max(worst, float(np.abs(out - want).max()))
        check(np.allclose(out, want, **TOL[torch.float32]),
              f"ParallelInference rows {lo}:{lo + n}: max diff {np.abs(out - want).max()}")
    lat = np.array([s for _, s in answers]) * 1e3
    # the shed: a request queued with a 1 ms deadline, drained 5 ms later
    shed_pi = ParallelInference(model, mode="batched", worker=False)
    shed_pi._thread = threading.current_thread()   # requests queue; drained here
    with cf.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(shed_pi.output, x[:1], 1.0)
        while shed_pi._queue.empty():
            time.sleep(1e-4)
        time.sleep(5e-3)
        drained = shed_pi._drain()
        try:
            fut.result(timeout=30)
            shed = False
        except ShedError:
            shed = True
    shed_pi._thread = None
    check(shed and not drained, "a request past its 1 ms deadline was not shed")
    check(launches["fused_lstm_fwd"] > 0 and launches["fused_lstm_bwd"] == 0,
          f"ParallelInference launches {launches}")
    return {"phase": "parallel_inference", "threads": PI_THREADS, "requests": len(jobs),
            "rows": [1, PI_MAX_ROWS], "max_batch_size": 32, "warmed_buckets": pi.warmed,
            "bit_equal_answers": bits, "max_abs_diff": worst, "tol": TOL[torch.float32],
            "latency_ms": {"p50": float(np.percentile(lat, 50)),
                           "p99": float(np.percentile(lat, 99))},
            "shed_1ms_deadline": shed, "launches": launches,
            "seconds": time.perf_counter() - t0}


def dp_cli_phase(tmp: Path) -> dict:
    """Phase 36: the trainer CLI in process, ``lenet.json --dataset mnist
    --data-parallel`` (a world of one, NCCL) from the data path phase's IDX
    files, against the same command without the flag: every iteration's
    logged loss and the zips' params bit for bit."""
    t0 = time.perf_counter()
    lines: list = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("deeplearning4j_tpu_torch")   # train/listeners.py logs here
    grab, level = Grab(), log.level
    log.addHandler(grab)
    log.setLevel(logging.INFO)
    old = os.environ.get("DL4J_TPU_DATA")
    os.environ["DL4J_TPU_DATA"] = str(tmp / "data")
    # cuDNN's default convolution algorithms may sum in another order from
    # one run to the next: both runs take the deterministic ones
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, extra in (("plain", []), ("data_parallel", ["--data-parallel"])):
            out_zip = tmp / f"dp_cli_{name}.zip"
            lines.clear()
            s = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                train_cli.run([str(tmp / "lenet.json"), "--dataset", "mnist", "--epochs", "1",
                               "--batch-size", str(DP_CLI_BATCH), "--listener-frequency", "1",
                               "--output", str(out_zip), *extra])
            torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - s,
                          "scores": [l for l in lines if l.startswith("Score at iteration")],
                          "params": _host_leaves(restore_network(str(out_zip)).params)}
    finally:
        torch.backends.cudnn.deterministic = False
        log.removeHandler(grab)
        log.setLevel(level)
        if old is None:
            os.environ.pop("DL4J_TPU_DATA")
        else:
            os.environ["DL4J_TPU_DATA"] = old
    a, b = runs["plain"], runs["data_parallel"]
    check(torch.distributed.is_available() and not torch.distributed.is_initialized(),
          "the CLI left its process group behind")
    check(len(a["scores"]) == -(-MNIST_ROWS // DP_CLI_BATCH) and a["scores"] == b["scores"],
          f"--data-parallel losses differ: {a['scores'][:2]} vs {b['scores'][:2]}")
    check(_bits_equal(a["params"], b["params"]), "--data-parallel params differ")
    return {"phase": "dp_cli", "model": "LeNet5", "dataset": "mnist (local IDX files)",
            "batch": DP_CLI_BATCH, "backend": "nccl", "world_size": 1,
            "iterations": len(a["scores"]), "losses_bit_equal": True,
            "params_bit_equal": True, "last_score": a["scores"][-1],
            "cli_seconds": {k: v["seconds"] for k, v in runs.items()},
            "seconds": time.perf_counter() - t0}


# Phase 37: elastic training (train/elastic.py) on the char-RNN at dp_train's
# width: worker processes on the card exchanging through a store. 8 steps
# of 128 rows, 4 vshards; the relaunched worker of (c) starts (python, torch,
# the port, the card) inside the survivor's stall after the shrink. (f1) and
# (f2): members that are slices of ELASTIC_SLICE gloo ranks sharing the card
# (elastic-of-slices), 16 rows of a 32-row vshard a rank
ELASTIC = dict(rows=1024, batch=128, vshards=4, seed=71, ttl=2.0, poll=0.02, ckpt_every=4)
ELASTIC_SLICE = "2"
ELASTIC_STEPS = 8
ELASTIC_REJOIN_STALL_S = 20
ELASTIC_TIMEOUT_S = 240


def _elastic_main(argv) -> int:
    """A worker of the elastic phase: ``chip_smoke.py _elastic <worker
    flags>`` (the launcher's worker command). The port's worker entry
    (train/elastic.py run_worker) on the full-width char-RNN; the kernels'
    launches, the step walls and the time it was ready go to
    ``<outdir>/report_<id>.json`` (a slice's follower:
    ``report_<id>_r<rank>.json``)."""
    from deeplearning4j_tpu_torch.parallel import comm
    from deeplearning4j_tpu_torch.parallel.mesh_step import MeshSlice
    from deeplearning4j_tpu_torch.train import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from deeplearning4j_tpu_torch.parallel import elastic as membership

    args = elastic.parse_args(["worker", *argv])
    model = MultiLayerNetwork(zoo.TextGenerationLSTM(**LSTM_CONF)).init()
    data = _charrnn_data(args.n, LSTM_CONF["timesteps"], LSTM_CONF["vocab_size"], args.seed)
    # where a step's host time goes: the seconds inside each of these calls
    # on the training thread (the heartbeat and prefetch threads excluded;
    # _vshard_payload includes the vshard's forward and backward)
    split = {}
    main_thread = threading.main_thread()

    def timed(owner, name, label):
        fn = getattr(owner, name)

        def wrapper(*a, **kw):
            if threading.current_thread() is not main_thread:
                return fn(*a, **kw)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                split[label] = split.get(label, 0.0) + time.perf_counter() - t
        setattr(owner, name, wrapper)

    # _vshard_payload includes _slice_sum (the part's packing and, in a
    # slice, sum_to_leader: its gather to the leader and the host sum), and
    # _send_plan the plan and params broadcast
    for name in ("_vshard_payload", "_combine", "_segment_update", "_dense_update",
                 "_assemble_params", "_await_vshards", "_await_psegs", "_slice_sum",
                 "_send_plan"):
        timed(elastic.ElasticTrainer, name, name.lstrip("_"))
    timed(membership.FileStore, "set", "store_set")
    timed(membership.FileStore, "get", "store_get")
    timed(MeshSlice, "sum_to_leader", "sum_to_leader")
    timed(comm, "gather", "gather")
    # the gather apart from the ranks' skew: this worker (not the trainer)
    # puts a barrier of the slice before it, timed as slice_wait
    sum_to_leader = MeshSlice.sum_to_leader

    def after_barrier(self, part):
        if self.size > 1 and threading.current_thread() is main_thread:
            t = time.perf_counter()
            torch.distributed.barrier(group=self.group.group)
            split["slice_wait"] = split.get("slice_wait", 0.0) + time.perf_counter() - t
        return sum_to_leader(self, part)
    MeshSlice.sum_to_leader = after_barrier
    ready = time.time()
    _zero_all_kernel_counts()
    res = elastic.run_worker(args, model=model, data=data)
    torch.cuda.synchronize()
    report = {"ready_ts": ready, "pid": os.getpid(), "launches": _kernel_launches(),
              "step_wall_s": [sp["wall_s"] for sp in obs.recent_spans()   # finished steps
                              if sp["span"] == "elastic.step" and not sp.get("error")],
              "host_split_s": split, "slice_rank": args.slice_rank,
              "vshard_parts": res.get("vshard_parts"),
              "iterations": res.get("iteration"), "device": torch.cuda.get_device_name(0)}
    name = f"report_{args.id}.json" if args.slice_rank == 0 else \
        f"report_{args.id}_r{args.slice_rank}.json"
    path = Path(args.outdir) / name
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(report))
    os.replace(tmp, path)
    return 0


def _elastic_run(tmp: Path, name: str, workers: int, *, chaos=None, relaunch=0,
                 allow_failures=0, ckpt=None, ckpt_every=0, store=None, mesh=None) -> dict:
    """One launcher run (train/elastic.py _cmd_launch, in this process) of
    ``workers`` worker processes through ``_elastic_main`` (with ``mesh``
    each worker a slice of that many rank processes); returns every
    worker's result, params, report (its followers' under
    ``follower_reports``) and events."""
    from deeplearning4j_tpu_torch.train import elastic

    out = tmp / name
    E = ELASTIC
    argv = ["launch", "--store", store or str(out / "store"), "--outdir", str(out),
            "--workers", str(workers), "--world", str(workers), "--epochs", "1",
            "--batch", str(E["batch"]), "--n", str(E["rows"]), "--seed", str(E["seed"]),
            "--vshards", str(E["vshards"]), "--ttl", str(E["ttl"]), "--poll", str(E["poll"]),
            "--relaunch", str(relaunch), "--allow-failures", str(allow_failures),
            "--timeout", str(ELASTIC_TIMEOUT_S)]
    if ckpt:
        argv += ["--ckpt-dir", str(ckpt), "--ckpt-every", str(ckpt_every)]
    if mesh:
        argv += ["--mesh", mesh, "--slice-devices", str(elastic.MeshSlice.ranks_of(mesh))]
    env = {k: v for k, v in os.environ.items() if k != "DL4J_TPU_CHAOS"}
    if chaos:
        env["DL4J_TPU_CHAOS"] = chaos
    t0 = time.perf_counter()
    rc = elastic._cmd_launch(elastic.parse_args(argv),
                             worker_cmd=[sys.executable, os.path.abspath(__file__), "_elastic"],
                             env=env)
    secs = time.perf_counter() - t0
    check(rc == 0, f"elastic {name}: the launcher returned {rc}")
    got = {"seconds": secs, "workers": {}}
    for i in range(workers):
        wid = f"w{i}"
        res_path = out / f"result_{wid}.json"
        if not res_path.exists():      # an allowed failure
            continue
        with np.load(out / f"params_{wid}.npz") as z:
            params = [torch.from_numpy(z[k].copy()) for k in sorted(z.files)]
        events_path = out / f"events_{wid}.jsonl"
        got["workers"][wid] = {
            "result": json.loads(res_path.read_text()), "params": params,
            "report": json.loads((out / f"report_{wid}.json").read_text()),
            "follower_reports": [json.loads(f.read_text()) for f in
                                 sorted(out.glob(f"report_{wid}_r*.json"))],
            "events": ([json.loads(l) for l in events_path.read_text().splitlines()]
                       if events_path.exists() else [])}
    for i in range(workers):        # a killed slice's leader logged its kill
        events_path = out / f"events_w{i}.jsonl"
        if f"w{i}" not in got["workers"] and events_path.exists():
            got.setdefault("failed_events", {})[f"w{i}"] = [
                json.loads(l) for l in events_path.read_text().splitlines()]
    # how each slice incarnation's ranks ended (the launcher's record)
    got["slice_exits"] = {f.parent.name: json.loads(f.read_text())
                          for f in sorted(out.glob("slice_w*_*/exits.json"))}
    return got


def elastic_train_phase(tmp: Path) -> dict:
    """Phase 37: ElasticTrainer through its launcher, each worker a process
    on the card running the full-width char-RNN (TextGenerationLSTM, vocab
    77, T 50, H 256, f32, RMSProp) on 1,024 rows, a global batch of 128 in
    4 vshards, 8 steps, FileStore under the phase's tmp dir, TTL 2 s: (a) 1
    worker (the reference); (b) 2 workers, checkpointing every 4 steps;
    then together (c) host_kill of rank 1 at iteration 3 with one relaunch
    (the survivor stalls ELASTIC_REJOIN_STALL_S after the shrink, so the
    relaunched worker rejoins), (d) (b) over a NetStoreServer (tcp://) and
    (e) a full restart from (b)'s checkpoints with the newest params file
    and rank 1's shard of the one before corrupted, (f1) 1 member that is
    a slice of 2 gloo ranks sharing the card (spec ELASTIC_SLICE: each rank
    16 rows of a 32-row vshard) and (f2) 2 such slices with slice_kill of
    slice 1 at iteration 3 (its process group: leader and follower). Every
    run's params and losses against (a): bit for bit, else within
    DP_PARAM_REL (the finding is which); (f2)'s survivor against (f1) bit
    for bit (exact across member count at a fixed spec). Kernels #4/#5
    launched in every worker's vshard backward (2 of each per vshard: two
    LSTM layers), on a slice's every rank 2 per vshard part it computed;
    both held against their plain versions at a slice rank's shape (B 16,
    T 50, H 256, f32)."""
    from deeplearning4j_tpu_torch.parallel.netstore import NetStoreServer

    t0 = time.perf_counter()
    steps, v = ELASTIC_STEPS, ELASTIC["vshards"]
    a = _elastic_run(tmp, "a_world1", 1)
    ckpt = tmp / "b_ckpt"
    b = _elastic_run(tmp, "b_world2", 2, ckpt=ckpt, ckpt_every=ELASTIC["ckpt_every"])
    # (e) restarts from the checkpoint at step 4: the newest params file and
    # rank 1's shard at step 4 fail their CRCs
    tags = sorted(f.name[len("manifest_"):-len(".json")] for f in ckpt.glob("manifest_*.json"))
    check(len(tags) == steps // ELASTIC["ckpt_every"], f"elastic (b) checkpoints: {tags}")
    from deeplearning4j_tpu_torch.train.resilience import corrupt_file

    corrupt_file(ckpt / f"ckpt_{tags[-1]}_params.npz")
    corrupt_file(ckpt / f"shard_{tags[-2]}_r1.npz")
    server = NetStoreServer()
    host, port = server.start()
    runs = {"a_world1": a, "b_world2": b}
    errors = []

    def run(name, *args, **kw):
        try:
            runs[name] = _elastic_run(tmp, name, *args, **kw)
        except BaseException as e:        # noqa: BLE001 (re-raised below)
            errors.append(e)

    threads = [threading.Thread(target=run, args=(name, n), kwargs=kw) for name, n, kw in (
        ("c_kill_rejoin", 2, dict(relaunch=1, chaos=f"host_kill@iter:3:rank1,slow_iter@iter:"
                                                    f"4:rank0:{ELASTIC_REJOIN_STALL_S}")),
        ("d_tcp", 2, dict(store=f"tcp://{host}:{port}")),
        ("e_restart", 2, dict(ckpt=ckpt, ckpt_every=0)),
        ("f1_slice", 1, dict(mesh=ELASTIC_SLICE)),
        ("f2_slice_kill", 2, dict(mesh=ELASTIC_SLICE, chaos="slice_kill@iter:3:slice1",
                                  allow_failures=1)))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    server.stop()
    if errors:
        raise errors[0]

    ref = a["workers"]["w0"]
    want, want_losses = ref["params"], ref["result"]["losses"]
    check(ref["result"]["iteration"] == steps and ref["result"]["world"] == 1,
          f"elastic (a): {ref['result']}")
    check(all(np.isfinite(want_losses)), f"elastic (a) losses {want_losses}")
    res = {"phase": "elastic_train", "model": dict(LSTM_CONF), "rows": ELASTIC["rows"],
           "global_batch": ELASTIC["batch"], "vshards": v, "steps": steps,
           "ttl_s": ELASTIC["ttl"], "rejoin_stall_s": ELASTIC_REJOIN_STALL_S,
           "tol": DP_PARAM_REL, "losses": want_losses, "runs": {}}
    by_path = {}
    for name, r in runs.items():
        entry = {"seconds": r["seconds"], "workers": {}}
        for wid, w in r["workers"].items():
            rel = _tree_rel(w["params"], want)
            bits = _bits_equal(w["params"], want)
            walls = w["report"]["step_wall_s"]
            result = w["result"]
            entry["workers"][wid] = {
                "world": result["world"], "gen": result["gen"],
                "iteration": result["iteration"], "bit_equal_vs_world1": bits,
                "losses_equal_vs_world1": result["losses"] == want_losses,
                "params_max_rel_diff_vs_world1": rel,
                "launches": w["report"]["launches"], "step_wall_s": walls,
                "stall_s": result["stall_s"],
                "stall_share": result["stall_s"] / max(sum(walls), 1e-12),
                "store_bytes_per_step": result["payload_bytes"] / max(len(walls), 1),
                "store_backend": result["store_backend"],
                "host_split_s": w["report"]["host_split_s"],
                "membership": [e["reason"] for e in w["events"]
                               if e["kind"] == "membership_change"]}
            check(bits or rel <= DP_PARAM_REL,
                  f"elastic {name} {wid}: params rel {rel} against the world-1 run")
            check(bits or np.allclose(result["losses"], want_losses, rtol=DP_PARAM_REL),
                  f"elastic {name} {wid}: losses {result['losses']} vs {want_losses}")
            lau = w["report"]["launches"]
            check(lau["fused_lstm_fwd"] > 0 and lau["fused_lstm_fwd"] == lau["fused_lstm_bwd"],
                  f"elastic {name} {wid}: kernels #4/#5 launched {lau}")
            by_path[f"elastic_train_{name}_{wid}"] = lau
        res["runs"][name] = entry
    # (a) computes every vshard, (b) half of them each: 2 launches of #4
    # and of #5 per vshard (two LSTM layers)
    check(a["workers"]["w0"]["report"]["launches"]["fused_lstm_fwd"] == 2 * v * steps,
          "elastic (a): launches of kernel #4")
    for wid, w in b["workers"].items():
        check(w["report"]["launches"]["fused_lstm_bwd"] == v * steps,
              f"elastic (b) {wid}: launches of kernel #5 {w['report']['launches']}")
        check(w["result"]["world"] == 2, f"elastic (b) {wid} ended at world {w['result']}")
    c = runs["c_kill_rejoin"]["workers"]
    check(set(c) == {"w0", "w1"} and all(w["result"]["world"] == 2 for w in c.values()),
          "elastic (c): both workers must end at world 2 (the rejoin)")
    reasons = res["runs"]["c_kill_rejoin"]["workers"]["w0"]["membership"]
    check("shrink" in reasons and "grow" in reasons, f"elastic (c) membership {reasons}")
    ts = {e.get("reason"): e["ts"] for e in c["w0"]["events"] if e["kind"] == "membership_change"}
    kill_ts = [e["ts"] for e in c["w1"]["events"]
               if e["kind"] == "chaos" and e.get("fault") == "host_kill"]
    check(len(kill_ts) == 1, f"elastic (c): host_kill events {kill_ts}")
    res["rejoin"] = {"kill_to_shrink_view_s": ts["shrink"] - kill_ts[0],
                     "kill_to_relaunched_ready_s": c["w1"]["report"]["ready_ts"] - kill_ts[0],
                     "relaunched_ready_to_grow_view_s": ts["grow"] - c["w1"]["report"]["ready_ts"],
                     "kill_to_grow_view_s": ts["grow"] - kill_ts[0]}
    check(runs["d_tcp"]["workers"]["w0"]["result"]["store_backend"] == "tcp", "elastic (d)")
    ev = [e["kind"] for w in runs["e_restart"]["workers"].values() for e in w["events"]]
    check("checkpoint_shard_dropped" in ev and "checkpoint_corrupt_fallback" in ev
          and "elastic_restart_restore" in ev, "elastic (e): the fallbacks did not run")
    for wid, w in runs["e_restart"]["workers"].items():
        check(w["report"]["launches"]["fused_lstm_fwd"] == v * (steps - ELASTIC["ckpt_every"]),
              f"elastic (e) {wid}: the restart ran {w['report']['launches']}")
    walls = {W: [s for w in r["workers"].values() for s in w["report"]["step_wall_s"]]
             for W, r in ((1, a), (2, b))}
    res["step_wall_ms"] = {f"world{W}": {"median": 1e3 * float(np.median(x)),
                                         "min": 1e3 * min(x), "max": 1e3 * max(x)}
                           for W, x in walls.items()}
    res["store_bytes_per_step"] = {
        f"world{W}": sum(w["result"]["payload_bytes"] for w in r["workers"].values()) / steps
        for W, r in ((1, a), (2, b))}
    res["host_split_ms_per_step"] = {
        f"world{W}_w0": {k: 1e3 * v / steps for k, v in
                         r["workers"]["w0"]["report"]["host_split_s"].items()}
        for W, r in ((1, a), (2, b))}
    res["slices"] = _elastic_slices_check(runs, by_path, steps, v)
    res["launches_by_path"] = by_path
    res["seconds"] = time.perf_counter() - t0
    return res


def _elastic_slices_check(runs: dict, by_path: dict, steps: int, v: int) -> dict:
    """Phase 37 (f1), (f2): the slices' launches per rank (2 of #4 and of #5
    per vshard part a rank computed), (f2)'s survivor bit for bit against
    (f1), the in-slice gather's share of a step, the seconds from the kill
    to the shrink view; kernels #4/#5 against their plain versions at a
    slice rank's shape."""
    from deeplearning4j_tpu_torch.parallel.mesh_step import MeshSlice

    f1, f2 = runs["f1_slice"]["workers"], runs["f2_slice_kill"]["workers"]
    check(set(f1) == {"w0"} and set(f2) == {"w0"}, f"elastic (f): workers {set(f1)}, {set(f2)}")
    ref, got = f1["w0"], f2["w0"]
    check(ref["result"]["slice_ranks"] == 2 and ref["result"]["world"] == 1,
          f"elastic (f1): {ref['result']}")
    check(got["result"]["world"] == 1, f"elastic (f2) ended at world {got['result']['world']}")
    bits = _bits_equal(got["params"], ref["params"])
    check(bits and got["result"]["losses"] == ref["result"]["losses"],
          "elastic (f2): the survivor is not bit-equal to the one-slice run (f1)")
    ranks = {}
    for name, ws in (("f1_slice", f1), ("f2_slice_kill", f2)):
        w = ws["w0"]
        reports = [w["report"]] + w["follower_reports"]
        check(len(reports) == 2, f"elastic {name}: {len(reports)} rank reports")
        for rep in reports:
            lau, parts = rep["launches"], rep["vshard_parts"]
            key = f"elastic_train_{name}_w0_r{rep['slice_rank']}"
            ranks[key] = {"launches": lau, "vshard_parts": parts,
                          "fwd_per_part": lau["fused_lstm_fwd"] / max(parts, 1)}
            check(parts > 0 and lau["fused_lstm_fwd"] == 2 * parts == lau["fused_lstm_bwd"],
                  f"elastic {name} rank {rep['slice_rank']}: {lau} over {parts} parts")
            if rep["slice_rank"] > 0:      # the leader's are in by_path already
                by_path[key] = lau
    # (f1) computes every vshard on both ranks
    check(all(r["vshard_parts"] == v * steps for k, r in ranks.items() if "f1_" in k),
          f"elastic (f1): parts {ranks}")
    split = ref["report"]["host_split_s"]
    walls = ref["report"]["step_wall_s"]
    total = max(sum(walls), 1e-12)
    kill = [e["ts"] for e in runs["f2_slice_kill"].get("failed_events", {}).get("w1", [])
            if e["kind"] == "slice_kill"]
    shrink = [e["ts"] for e in got["events"] if e["kind"] == "membership_change"
              and e.get("reason") == "shrink"]
    check(len(kill) == 1 and shrink, f"elastic (f2): kill {kill}, shrink {shrink}")
    # slice_kill took both of slice 1's ranks: neither was left for the
    # launcher to kill
    exits = runs["f2_slice_kill"]["slice_exits"]
    check(exits.get("slice_w1_0") == {"rcs": [-9, -9], "killed": []}
          and exits.get("slice_w0_0", {}).get("rcs") == [0, 0],
          f"elastic (f2): slice exits {exits}")
    rows = ELASTIC["batch"] // v // MeshSlice.parse_spec(ELASTIC_SLICE)[0]
    cases = [compare_lstm(dict(B=rows, T=LSTM_CONF["timesteps"], H=LSTM_CONF["hidden"],
                               dtype=torch.float32, peep=peep, mask=None, seed=74 + i))
             for i, peep in enumerate((True, False))]
    check(all(c["ok"] for c in cases), f"elastic (f): #4/#5 at B 16 against plain: {cases}")
    return {"spec": ELASTIC_SLICE, "rows_per_rank": rows,
            "f2_bit_equal_vs_f1": bits, "ranks": ranks,
            # of (f1)'s leader's step walls: the wait at the barrier before
            # each gather (the ranks' skew), the gather, the host sum and
            # the part's packing
            "rank_wait_share_of_step": split.get("slice_wait", 0.0) / total,
            "gather_share_of_step": split.get("gather", 0.0) / total,
            "host_sum_share_of_step": (split.get("sum_to_leader", 0.0)
                                       - split.get("gather", 0.0)) / total,
            "pack_share_of_step": (split.get("slice_sum", 0.0) - split.get("sum_to_leader", 0.0)
                                   - split.get("slice_wait", 0.0)) / total,
            "plan_share_of_step": split.get("send_plan", 0.0) / total,
            "slice_exits_f2": exits,
            "step_wall_ms_f1": {"median": 1e3 * float(np.median(walls)),
                                "min": 1e3 * min(walls), "max": 1e3 * max(walls)},
            "kill_to_shrink_view_s": shrink[0] - kill[0],
            "kernel_vs_plain_B16": cases}


# -- phase 38 ----------------------------------------------------------------

# two configurations, one round of two subprocess trials (grad_accum {1, 2}
# x chain_steps {0, 8} ran six in two rounds, ~113 s, mostly process
# start-up): gradient accumulation still runs on the card in a trial, the
# chain in lenet_runtime; a knob left out of the grid searches its whole
# registered domain
RT_TUNE_GRID = {"grad_accum": [1, 2], "chain_steps": ["0"]}
# one SGD step of LeNet-5 under DL4J_TPU_GRAD_ACCUM=2 against the full
# batch's, f32 with TF32 off: the two 128-row gradients' mean against one
# 256-row gradient, sums in another order; ||delta diff|| / ||delta||
RT_ACCUM_REL = 1e-4
RT_TUNE = dict(batch=256, base_steps=128, warmup_steps=1, eta=2, timeout_s=300)
RT_CHARRNN = dict(rows=256, T=100, seed=38)   # 2 batches of 128 x 2 tBPTT chunks
RT_FLOPS_REL = 2e-2        # counted vs analytic forward flops at b16
RT_CHILD_TIMEOUT_S = 600


def _charrnn_rows(rows, T, seed):
    V = LSTM_CONF["vocab_size"]
    return _charrnn_data(rows, T, V, seed)


def _bundle_child_main(argv) -> int:
    """The fresh process of phase 38 (a): ``python3 chip_smoke.py
    _bundle_child <bundle or -> <report.json>``, with DL4J_TPU_COMPILE_CACHE
    set to the parent's build directory. Registers the full-width
    TransformerLM from the bundle (``-``: without one, the control), serves
    one :predict and reports where the time went: the CUDA context, the
    kernel library load and the model's init, each before ``register``;
    then every warm dispatch of the register (its ``compile`` spans) and
    the reply."""
    bundle, out = argv
    bundle = None if bundle == "-" else bundle
    split = {"main_wall": time.time()}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        split[name] = now - t
        t = now

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    lap("context_s")
    _build.load("flash_fwd")
    lap("library_load_s")
    model = MultiLayerNetwork(zoo.TransformerLM(**FLAGSHIP_CONF)).init()
    torch.cuda.synchronize()
    lap("model_init_s")
    _zero_flash_counts()
    registry = ModelRegistry(config=ServeConfig(
        max_batch=16, queue_limit=64, max_wait_s=0.01, default_deadline_s=600.0))
    t1 = time.perf_counter()
    registry.register("lm", model, bundle=bundle)
    torch.cuda.synchronize()
    lap("register_s")
    server = InferenceServer(registry).start(port=0)
    ids = torch.randint(0, FLAGSHIP_CONF["vocab_size"], (1, 128),
                        generator=torch.Generator().manual_seed(5))
    try:
        status, payload, _ = post_predict(server.port, "lm", ids.tolist(), 600000.0)
        first_reply_s = time.perf_counter() - t1
        lap("first_predict_s")
    finally:
        server.stop(shutdown_registry=False)
    warms = [{"mode": r["attrs"].get("mode"), "wall_s": r["wall_s"]}
             for r in obs.recent_spans() if r["span"] == "compile"
             and r.get("attrs", {}).get("site") == "mln.output"]
    meta = registry.describe()[0]
    rep = {"bundle": bundle is not None, "split": split, "warm_dispatches": warms,
           "register_to_first_reply_s": first_reply_s,
           "status": status, "restored": meta["restored"], "warmed": meta["warmed"],
           "warm_seconds": meta["warm_seconds"], "nvcc_runs": list(_build.NVCC_RUNS),
           "libraries_loaded": sorted(_build.BUILD_LOG), "build_dir": str(_build.BUILD_DIR),
           "launches": _launch_counts(),
           "cost_keys": sorted(obs.cost_report()["sites"].get("mln.output", {})),
           "rejected": obs.event_log().counts().get("aot_bundle_rejected", 0),
           "finite": bool(np.isfinite(np.asarray(payload["outputs"])).all())}
    Path(out).write_text(json.dumps(rep))
    registry.shutdown()
    return 0


def _lm_analytic_fwd_flops(model, rows, T) -> float:
    """2 x tokens x the weights of the products (embedding tables are
    lookups) plus kernel #1's causal count in every block."""
    weights, blocks = 0, 0
    for layer, p in zip(model.layers, model.params):
        kind = type(layer).__name__
        if kind in ("EmbeddingSequence", "PositionalEmbedding"):
            continue
        blocks += kind == "TransformerBlock"
        weights += sum(t.numel() for t in tree_leaves(p) if t.dim() == 2)
    H = FLAGSHIP_CONF["n_heads"]
    attn, _ = profile.attention_fwd_cost(rows, T, T, H, FLAGSHIP_CONF["d_model"] // H,
                                         True, 2)
    return 2.0 * rows * T * weights + blocks * attn


def _rt_serve(tmp: Path) -> dict:
    """(a) cold register with a bundle, then a fresh process from it; (b)
    the cost ledger; (c) the memory report of the same model."""
    from deeplearning4j_tpu_torch.nn.memory import memory_report

    vocab, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    bundle = tmp / "lm.aotbundle"
    obs.reset()
    ids = torch.randint(0, vocab, (1, 128), generator=torch.Generator().manual_seed(5))
    model = MultiLayerNetwork(zoo.TransformerLM(**FLAGSHIP_CONF)).init()
    torch.cuda.synchronize()
    registry = ModelRegistry(config=ServeConfig(
        max_batch=16, queue_limit=64, max_wait_s=0.01, default_deadline_s=600.0))
    _zero_flash_counts()
    t0 = time.perf_counter()
    registry.register("lm", model, bundle=str(bundle))
    server = InferenceServer(registry).start(port=0)
    try:
        status, payload, _ = post_predict(server.port, "lm", ids.tolist(), 600000.0)
        first_reply_s = time.perf_counter() - t0
    finally:
        server.stop(shutdown_registry=False)
    check(status == 200, f"cold :predict status {status}")
    check_rows(torch.tensor(payload["outputs"]), (1, 128, vocab), "cold :predict")
    meta = registry.describe()[0]
    buckets = [1, 2, 4, 8, 16]
    check(meta["restored"] == 0 and meta["warm_buckets"] == buckets
          and meta["warmed"] == len(buckets),
          f"cold register: restored {meta['restored']}, buckets {meta['warm_buckets']}")
    check(bundle.exists(), "the cold register wrote no bundle")
    with zipfile.ZipFile(bundle) as zf:
        manifest = json.loads(zf.read("manifest.json"))
    entries = len(manifest["entries"])
    cold_launches = _launch_counts()
    check(cold_launches["flash_fwd"] > 0 and cold_launches["flash_bwd_dq"] == 0
          and cold_launches["flash_bwd_dkv"] == 0, f"cold register launches {cold_launches}")
    cold = {"register_to_first_reply_s": first_reply_s, "warm_seconds": meta["warm_seconds"],
            "launches": cold_launches,
            "bundle_bytes": bundle.stat().st_size, "bundle_entries": entries,
            "fingerprint": {k: manifest[k] for k in ("torch_version", "cuda_version",
                                                     "device_name", "backend")}}
    check(entries >= len(buckets), f"the bundle holds {entries} entries")

    # fresh processes, from the bundle and without one, loading the kernel
    # libraries this process built (DL4J_TPU_COMPILE_CACHE)
    env = dict(os.environ, DL4J_TPU_COMPILE_CACHE=str(_build.BUILD_DIR))
    children = {}
    for name, arg in (("from_bundle", str(bundle)), ("no_bundle", "-")):
        report = tmp / f"{name}.json"
        t1, w1 = time.perf_counter(), time.time()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "_bundle_child",
                               arg, str(report)], env=env, capture_output=True,
                              text=True, timeout=RT_CHILD_TIMEOUT_S)
        check(proc.returncode == 0,
              f"{name} child exited {proc.returncode}: {proc.stderr[-2000:]}")
        child = json.loads(report.read_text())
        child["process_s"] = time.perf_counter() - t1
        child["split"]["start_to_main_s"] = child["split"].pop("main_wall") - w1
        check(child["status"] == 200 and child["finite"], f"{name} :predict {child['status']}")
        check(child["nvcc_runs"] == [], f"the {name} child ran nvcc for {child['nvcc_runs']}")
        check(child["cost_keys"] == sorted(f"b{b}" for b in buckets),
              f"{name} child ledger keys {child['cost_keys']}")
        cl = child["launches"]
        check(cl["flash_fwd"] > 0 and cl["flash_bwd_dq"] == 0 and cl["flash_bwd_dkv"] == 0,
              f"{name} child launches {cl}")
        children[name] = child
    child = children["from_bundle"]
    check(child["restored"] == entries and child["rejected"] == 0,
          f"child restored {child['restored']} of {entries} entries "
          f"({child['rejected']} rejections)")
    check(children["no_bundle"]["restored"] == 0
          and children["no_bundle"]["warmed"] == len(buckets),
          f"the control restored {children['no_bundle']['restored']}")

    # (b) the ledger: every warmed bucket, the b16 count against the analytic
    every, profile.SAMPLE_EVERY = profile.SAMPLE_EVERY, 1   # sample every dispatch
    try:
        x16 = torch.randint(0, vocab, (16, T), generator=torch.Generator().manual_seed(6))
        for _ in range(4):
            model.output(x16)
        torch.cuda.synchronize()
        rep = obs.cost_report()
    finally:
        profile.SAMPLE_EVERY = every
    sites = rep["sites"].get("mln.output", {})
    check(sorted(sites) == sorted(f"b{b}" for b in buckets), f"ledger keys {sorted(sites)}")
    e16 = sites["b16"]
    want = _lm_analytic_fwd_flops(model, 16, T)
    rel = abs(e16["flops"] - want) / want
    check(rel <= RT_FLOPS_REL, f"b16 counted flops {e16['flops']:.4e} vs analytic "
                               f"{want:.4e} ({rel:.2%})")
    check(e16["kernels"].get("flash_fwd", {}).get("launches") == 8,
          f"the counting pass saw {e16['kernels']} kernel launches")
    u = rep["utilization"].get("mln.output")
    check(u is not None and u["timebase"] == "device" and "error" not in u
          and u["mfu"] <= 1.0 and u["membw_util"] <= 1.0,
          f"mln.output's device-time utilization: {u}")
    ledger = {"b16": {k: e16[k] for k in ("flops", "bytes_accessed", "peak_hbm_bytes",
                                          "kernels")},
              "analytic_flops": want, "rel_err": rel, "utilization": u,
              "flops_by_bucket": {k: v["flops"] for k, v in sites.items()},
              "roofline": rep["roofline"]}

    # (c) the memory report of the same model, which must not train it
    before = [t.detach().clone() for t in tree_leaves(model.params)]
    had_opt = model.opt_state is not None
    gen_state = model._gen.get_state()
    _zero_flash_counts()
    t2 = time.perf_counter()
    mr = memory_report(model, 16)
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t2
    mem_launches = _launch_counts()
    same = (all(torch.equal(a, b) for a, b in zip(before, tree_leaves(model.params)))
            and (model.opt_state is not None) == had_opt
            and torch.equal(model._gen.get_state(), gen_state) and model.iteration == 0)
    check(same, "memory_report changed the model")
    n = model.num_params()
    check(mr.params_bytes == 2 * n, f"params {mr.params_bytes} bytes for {n} bf16 params")
    check(mr.opt_state_bytes == 2 * 4 * n, f"Adam state {mr.opt_state_bytes} bytes")
    memory = {"params_bytes": mr.params_bytes, "opt_state_bytes": mr.opt_state_bytes,
              "inference": mr.inference, "training": mr.training, "seconds": mem_s,
              "launches": mem_launches, "model_unchanged": same}
    del before
    registry.shutdown()
    del model
    return {"cold": cold, **children, "ledger": ledger, "memory": memory,
            "launches": {"cold_serve": cold_launches,
                         "bundle_child": children["from_bundle"]["launches"],
                         "no_bundle_child": children["no_bundle"]["launches"],
                         "memory_report": mem_launches}}


def _rt_charrnn(tmp: Path) -> dict:
    """(d, first half) the char-RNN with a checkpoint sidecar, resumed in a
    fresh model: bit-equal losses and params."""
    from deeplearning4j_tpu_torch.nn import aot
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.resilience import ChaosPreemption, install_chaos

    conf = zoo.TextGenerationLSTM(**LSTM_CONF)
    x, y = _charrnn_rows(**RT_CHARRNN)
    B = LSTM_SHAPE["B"]
    _zero_lstm_counts()
    a = MultiLayerNetwork(conf).init()
    sa = CollectScoresListener()
    a.set_listeners(sa).fit((x, y), epochs=2, batch_size=B)
    want = _host_leaves(a.params)
    launches = {"uninterrupted": _lstm_launches()}
    ck = tmp / "charrnn_ck"
    m = MultiLayerNetwork(conf).init()
    sm = CollectScoresListener()
    m.set_listeners(sm, CheckpointListener(ck, save_every_n_iterations=2, keep_last=1))
    install_chaos("preempt@iter:4")   # before the third batch (2 chunks a batch)
    _zero_lstm_counts()
    try:
        m.fit((x, y), epochs=2, batch_size=B)
    except ChaosPreemption:
        pass
    finally:
        install_chaos(None)
    launches["preempted"] = _lstm_launches()
    sidecars = sorted(p.name for p in ck.glob("*.aotbundle"))
    check(sidecars, "the checkpoint wrote no .aotbundle sidecar")
    r = MultiLayerNetwork(conf).init()
    sr = CollectScoresListener()
    restored0 = obs.event_log().counts().get("aot_bundle_restored", 0)
    _zero_lstm_counts()
    r.set_listeners(sr).fit((x, y), epochs=2, batch_size=B, resume_from=str(ck))
    torch.cuda.synchronize()
    launches["resumed"] = _lstm_launches()
    restored = obs.event_log().counts().get("aot_bundle_restored", 0) - restored0
    check(restored == 1, f"resume restored {restored} bundles")
    got = _host_leaves(r.params)
    equal_losses = bool(sr.scores) and sr.scores == sa.scores[-len(sr.scores):]
    check(_bits_equal(got, want) and equal_losses,
          f"the resumed char-RNN differs: params max |diff| {_max_diff(got, want)}, "
          f"losses {sr.scores} vs {sa.scores}")
    check(launches["uninterrupted"] == {"fused_lstm_fwd": 16, "fused_lstm_bwd": 16}
          and launches["resumed"] == {"fused_lstm_fwd": 8, "fused_lstm_bwd": 8},
          f"char-RNN launches {launches} (2 + 2 a tBPTT chunk)")
    return {"sidecars": sidecars, "bundle_restored": restored,
            "restored_signatures": len(r._get_tbptt_fn().signatures()),
            "losses_uninterrupted": sa.scores, "losses_resumed": sr.scores,
            "bit_equal": True, "launches": launches}


def _rt_tune(tmp: Path) -> dict:
    """(d, second half) tune_model on LeNet-5 in subprocess trials on the
    card, then fit under DL4J_TPU_TUNE=auto applies the winner."""
    from deeplearning4j_tpu_torch import tune

    db_path = tmp / "tunedb.zip"
    saved = {k: os.environ.get(k) for k in ("DL4J_TPU_TUNE", "DL4J_TPU_TUNE_DB",
                                            "DL4J_TPU_GRAD_ACCUM", "DL4J_TPU_CHAIN_STEPS")}
    for k in ("DL4J_TPU_TUNE", "DL4J_TPU_GRAD_ACCUM", "DL4J_TPU_CHAIN_STEPS"):
        os.environ.pop(k, None)
    os.environ["DL4J_TPU_TUNE_DB"] = str(db_path)
    try:
        model = MultiLayerNetwork(zoo.LeNet5()).init()
        x, y = _lenet_images(RT_TUNE["batch"], 38)
        t0 = time.perf_counter()
        entry = tune.tune_model(model, x, y, overrides=RT_TUNE_GRID, db=tune.TuningDB(db_path),
                                base_steps=RT_TUNE["base_steps"],
                                warmup_steps=RT_TUNE["warmup_steps"], eta=RT_TUNE["eta"],
                                timeout_s=RT_TUNE["timeout_s"])
        search_s = time.perf_counter() - t0
        hist = entry["history"]
        check(all(h["ok"] for h in hist),
              f"a tuning trial failed: {[h for h in hist if not h['ok']]}")
        check(len(hist) == 2 and {h["knobs"]["grad_accum"] for h in hist} == {1, 2},
              f"{len(hist)} trials for a 2-config grid at eta 2: {hist}")
        applied0 = obs.event_log().counts().get("tune_applied", 0)
        os.environ["DL4J_TPU_TUNE"] = "auto"
        fresh = MultiLayerNetwork(zoo.LeNet5()).init()
        fresh.fit((x, y), epochs=1, batch_size=RT_TUNE["batch"])
        applied = obs.event_log().counts().get("tune_applied", 0) - applied0
        env = {k: os.environ.get(k) for k in ("DL4J_TPU_GRAD_ACCUM", "DL4J_TPU_CHAIN_STEPS")}
        check(applied == 1 and env["DL4J_TPU_GRAD_ACCUM"] == str(entry["knobs"]["grad_accum"])
              and env["DL4J_TPU_CHAIN_STEPS"] == str(entry["knobs"]["chain_steps"]),
              f"fit under DL4J_TPU_TUNE=auto: {applied} tune_applied events, env {env}, "
              f"winner {entry['knobs']}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"grid": RT_TUNE_GRID, "batch": RT_TUNE["batch"], "eta": RT_TUNE["eta"],
            "trials": [{"knobs": h["knobs"], "steps_per_sec": h["steps_per_sec"], "ok": h["ok"]}
                       for h in hist],
            "winner": entry["knobs"], "objective": entry["objective"],
            "search_s": search_s, "applied_env": env, "accum": _rt_accum()}


def _rt_accum() -> dict:
    """One ``fit`` step of LeNet-5 (SGD) at batch 256 under
    DL4J_TPU_GRAD_ACCUM=2 against the same step without it, from one seed:
    the accumulated update equals the full batch's."""
    x, y = _lenet_images(RT_TUNE["batch"], 381)
    saved = (os.environ.get("DL4J_TPU_GRAD_ACCUM"), torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    deltas = []
    try:
        for accum in ("1", "2"):
            os.environ["DL4J_TPU_GRAD_ACCUM"] = accum
            m = MultiLayerNetwork(zoo.LeNet5(updater={"type": "sgd", "lr": 0.1})).init()
            before = [t.clone() for t in tree_leaves(m.params)]
            m.fit((x, y), epochs=1, batch_size=RT_TUNE["batch"])
            check(m.iteration == 1, f"grad_accum {accum}: {m.iteration} updates")
            deltas.append(torch.cat([(a - b).double().flatten()
                                     for a, b in zip(tree_leaves(m.params), before)]))
    finally:
        if saved[0] is None:
            os.environ.pop("DL4J_TPU_GRAD_ACCUM", None)
        else:
            os.environ["DL4J_TPU_GRAD_ACCUM"] = saved[0]
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[1:]
    rel = float((deltas[1] - deltas[0]).norm() / deltas[0].norm())
    check(rel <= RT_ACCUM_REL, f"grad_accum 2 against the full batch: rel {rel}")
    return {"batch": RT_TUNE["batch"], "micro_batches": 2, "updater": "sgd 0.1",
            "delta_rel_diff": rel, "tol": RT_ACCUM_REL}


def _rt_dashboard(tmp: Path) -> dict:
    """(e) StatsListener into a FileStatsStorage, UIServer routes, the live
    trace and the trace CLI, ConvolutionalIterationListener PNGs."""
    from deeplearning4j_tpu_torch.obs import trace_export
    from deeplearning4j_tpu_torch.ui import (ConvolutionalIterationListener, FileStatsStorage,
                                             StatsListener, UIServer)

    storage = FileStatsStorage(str(tmp / "stats.jsonl"))
    x, y = _charrnn_rows(**RT_CHARRNN)
    _zero_lstm_counts()
    m = MultiLayerNetwork(zoo.TextGenerationLSTM(**LSTM_CONF)).init()
    m.set_listeners(StatsListener(storage)).fit((x, y), epochs=1, batch_size=LSTM_SHAPE["B"])
    launches = _lstm_launches()
    check(m.iteration == 4, f"the char-RNN took {m.iteration} updates")
    sessions = storage.list_session_ids()
    check(len(sessions) == 1 and storage.get_all_updates(sessions[0]),
          f"stats storage holds {sessions}")
    ui = UIServer()
    ui.attach(storage)
    ui.serve(0)
    routes = {}
    try:
        for route in ("/train/overview", "/train/system", "/debug/trace"):
            with urllib.request.urlopen(f"http://127.0.0.1:{ui.port}{route}", timeout=60) as r:
                routes[route] = (r.status, r.read())
    finally:
        ui.stop()
    check(all(s == 200 for s, _ in routes.values()),
          f"UI routes: {({k: s for k, (s, _) in routes.items()})}")
    name = torch.cuda.get_device_name(0)
    check(name in routes["/train/system"][1].decode(), "/train/system does not name the card")
    live = json.loads(routes["/debug/trace"][1])
    live_problems = trace_export.validate(live)
    dump = tmp / "spans.json"
    n_spans = obs.save_spans(str(dump))
    out = tmp / "trace.json"
    proc = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.obs.trace_export",
                           "--spans", str(dump), "--out", str(out), "--validate"],
                          capture_output=True, text=True, timeout=120)
    cli_problems = trace_export.validate(json.loads(out.read_text())) if out.exists() else ["no output"]
    check(not live_problems and proc.returncode == 0 and not cli_problems,
          f"trace invalid: live {live_problems[:3]}, cli rc {proc.returncode} "
          f"{cli_problems[:3]} {proc.stderr[-500:]}")
    # one LeNet-5 epoch with the activation-grid listener
    lx, ly = _lenet_images(512, 39)
    net = MultiLayerNetwork(zoo.LeNet5()).init()
    cl = ConvolutionalIterationListener(lx[:1], str(tmp / "conv"), frequency=1)
    net.set_listeners(cl).fit((lx, ly), epochs=1, batch_size=256)
    pngs = sorted(Path(tmp / "conv").glob("*.png"))
    check(len(pngs) >= 2 and all(p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs),
          f"ConvolutionalIterationListener wrote {len(pngs)} PNGs")
    return {"stats_updates": len(storage.get_all_updates(sessions[0])),
            "routes": {k: {"status": s, "bytes": len(b)} for k, (s, b) in routes.items()},
            "spans": n_spans, "live_trace_events": len(live["traceEvents"]),
            "cli_trace_events": len(json.loads(out.read_text())["traceEvents"]),
            "pngs": len(pngs), "launches": launches}


def runtime_layer_phase(tmp: Path) -> dict:
    """Phase 38: the runtime layer (trace export, the cost ledger, bundles
    and the kernel-library cache, the memory report, the tuner, the
    dashboard) around the full-width TransformerLM and the char-RNN."""
    t0 = time.perf_counter()
    res = {"phase": "runtime_layer"}
    steps = (("serve", _rt_serve), ("charrnn", _rt_charrnn), ("tune", _rt_tune),
             ("dashboard", _rt_dashboard))
    for key, fn in steps:
        t1 = time.perf_counter()
        res[key] = fn(tmp)
        res[key]["step_s"] = time.perf_counter() - t1
        emit({"phase": f"runtime_layer.{key}", **res[key]})
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def _runtime_layer_main(argv) -> int:
    """``python3 chip_smoke.py _runtime_layer``: phase 38 alone, for work on
    the runtime layer. Builds the kernels and runs the phase (its step
    lines), then times the flagship's five warm dispatches priced and
    unpriced in this warm process (what a counting pass adds to each),
    twice each, and tunes LeNet-5 a second time (is the winner the same?).
    Prints one JSON line of those extras."""
    from deeplearning4j_tpu_torch.nn import aot

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(build_report())
    with tempfile.TemporaryDirectory() as tmp:
        rt = runtime_layer_phase(Path(tmp))
    walls = {"priced": [], "unpriced": []}
    for price in (True, False, True, False):
        model = MultiLayerNetwork(zoo.TransformerLM(**FLAGSHIP_CONF)).init()
        fn = model._get_output_fn()
        run = []
        for b in (1, 2, 4, 8, 16):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn.warm(aot._dummy_features(model, b), None, cost_key=f"b{b}", price=price)
            torch.cuda.synchronize()
            run.append(time.perf_counter() - t0)
        walls["priced" if price else "unpriced"].append(run)
        del model, fn
        gc.collect()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        again = _rt_tune(Path(tmp))
    emit({"phase": "runtime_layer.extras", "nvidia_smi": card, "seconds": rt["seconds"],
          "warm_dispatch_s": walls,
          "tune": [{"trials": [(h["knobs"], h["steps_per_sec"]) for h in r["trials"]],
                    "winner": r["winner"]} for r in (rt["tune"], again)]})
    return 0


# -- phase 39 ----------------------------------------------------------------

AN_ROWS = (1, 3, 4, 9, 16)          # (a)'s requests, rows x 2048 tokens
AN_OFF_GRID_T = 128                 # (a)'s last request, 1 row, off the warmed T
AN_UNPADDED = dict(rows=4, T=(128, 256, 384), H=16, D=128)   # (b): one row bucket
AN_CHARRNN = dict(rows=128, T=200, seed=39)   # (c): one batch of 4 tBPTT chunks
AN_TIMED = {1: 20, 16: 5}           # (d): dispatches a block, b1 and b16
AN_ROUNDS = 3                       # (d): rounds of off, on, on, off blocks
AN_CHECKS = 20000                   # (d): guard checks timed alone, off and on
AN_GUARDS = ("DL4J_TPU_RETRACE_GUARD", "DL4J_TPU_STRICT_RETRACE", "DL4J_TPU_DONATION_GUARD")
AN_LINT_TIMEOUT_S = 300


@contextlib.contextmanager
def _guards(**env):
    """The guard knobs set as given (None: unset) and restored afterwards."""
    saved = {k: os.environ.get(k) for k in AN_GUARDS}
    for k in AN_GUARDS:
        os.environ.pop(k, None)
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _reset_guard_state():
    from deeplearning4j_tpu_torch.analysis import donation_guard, retrace_guard
    from deeplearning4j_tpu_torch.utils import bucketing

    bucketing.telemetry().reset()
    retrace_guard.reset_aot_warmed()
    retrace_guard.reset_warnings()
    donation_guard.reset_warnings()


def _an_serve() -> tuple:
    """(a): strict serving of the full-width TransformerLM; returns the
    result and the model, which (d) times."""
    from deeplearning4j_tpu_torch.analysis import retrace_guard
    from deeplearning4j_tpu_torch.utils import bucketing

    vocab, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    tel = bucketing.telemetry()
    g = torch.Generator().manual_seed(39)
    out = {}
    with _guards(DL4J_TPU_STRICT_RETRACE="1", DL4J_TPU_DONATION_GUARD="1"):
        _zero_flash_counts()
        model = MultiLayerNetwork(zoo.TransformerLM(**FLAGSHIP_CONF)).init()
        registry = ModelRegistry(config=ServeConfig(
            max_batch=16, queue_limit=64, max_wait_s=0.01, default_deadline_s=600.0))
        registry.register("lm", model)
        worker = registry.worker("lm")
        warm = {"compiles": tel.compiles("mln.output"),
                "warmed_buckets": sorted(retrace_guard.aot_warmed_buckets("mln.output")),
                "launches": _launch_counts()}
        check(warm["warmed_buckets"] == [1, 2, 4, 8, 16] and warm["compiles"] == 5,
              f"the warm registered {warm}")
        requests = []
        for rows in AN_ROWS:
            before_b, before = worker.stats()["batches"], _launch_counts()
            ids = torch.randint(0, vocab, (rows, T), generator=g)
            res = worker.submit(ids.numpy(), deadline_s=600.0)
            check_rows(torch.from_numpy(res), (rows, T, vocab), f"strict {rows} x {T}")
            batches = worker.stats()["batches"] - before_b
            now = _launch_counts()
            fwd = now["flash_fwd"] - before["flash_fwd"]
            check(fwd == 8 * batches, f"{fwd} launches of #1 for {batches} dispatches")
            requests.append({"rows": rows, "T": T, "bucket": bucketing.bucket_size(rows),
                             "dispatches": batches, "flash_fwd": fwd})
            del res
        compiles = tel.compiles("mln.output")
        predicted = retrace_guard.predicted_compiles("mln.output")
        rep = retrace_guard.check("mln.output")
        launches = _launch_counts()
        check(rep.ok and compiles == predicted == 5,
              f"strict serving: {compiles} new signatures against {predicted} predicted")
        check(launches["flash_bwd_dq"] == 0 and launches["flash_bwd_dkv"] == 0,
              f"serving launched the backward kernels: {launches}")
        out.update(warm=warm, requests=requests, compiles=compiles, predicted=predicted,
                   buckets_used=list(tel.buckets_used("mln.output")), launches=launches)
    # the serving path pads rows up the ladder, not the sequence: a 1 x 128
    # request after the T 2048 warm is one signature beyond the bound
    with _guards(DL4J_TPU_RETRACE_GUARD="1"):
        events0 = obs.event_log().counts().get("retrace_guard", 0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", retrace_guard.RetraceWarning)
            ids = torch.randint(0, vocab, (1, AN_OFF_GRID_T), generator=g)
            res = worker.submit(ids.numpy(), deadline_s=600.0)
        check_rows(torch.from_numpy(res), (1, AN_OFF_GRID_T, vocab), "1 x 128 after the warm")
        rep = retrace_guard.check("mln.output")
        events = obs.event_log().counts().get("retrace_guard", 0) - events0
        check(not rep.ok and rep.compiles == 6 and rep.predicted == 5 and events >= 1,
              f"the 1 x 128 request: {rep}, {events} retrace_guard events")
        out["off_grid_1x128"] = {"compiles": rep.compiles, "predicted": rep.predicted,
                                 "events": events}
    out["launches"] = _launch_counts()
    registry.shutdown()
    return out, model


def _an_unpadded() -> dict:
    """(b): kernel #1 behind a RetraceGuard, three sequence lengths in one
    row bucket: the second raises."""
    from deeplearning4j_tpu_torch.analysis import retrace_guard

    B, H, D = AN_UNPADDED["rows"], AN_UNPADDED["H"], AN_UNPADDED["D"]
    guard = retrace_guard.RetraceGuard(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True), "analysis.unpadded")
    g = torch.Generator(device="cuda").manual_seed(39)
    seen, raised = [], None
    _zero_flash_counts()
    with _guards(DL4J_TPU_STRICT_RETRACE="1"):
        for T in AN_UNPADDED["T"]:
            q, k, v = (torch.randn(B, T, H, D, generator=g, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(3))
            try:
                o = guard(q, k, v)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(o).all()), f"kernel #1 at T {T}")
                seen.append(T)
            except retrace_guard.RetraceError as e:
                raised = {"T": T, "error": str(e)[:200]}
                break
    launches = _launch_counts()
    check(raised is not None and seen == [AN_UNPADDED["T"][0]],
          f"the unpadded site did not raise: ran {seen}")
    check(launches["flash_fwd"] == 2, f"kernel #1 launched {launches['flash_fwd']} times")
    return {"ran": seen, "raised": raised, "report": guard.report.__dict__,
            "launches": launches}


def _an_charrnn() -> dict:
    """(c): 4 tBPTT chunks of the full-width char-RNN under both guards,
    then a step that rebinds a param leaf."""
    from deeplearning4j_tpu_torch.analysis import donation_guard, retrace_guard
    from deeplearning4j_tpu_torch.utils import bucketing

    x, y = _charrnn_rows(**AN_CHARRNN)
    B = LSTM_SHAPE["B"]
    out = {}
    with _guards(DL4J_TPU_STRICT_RETRACE="1", DL4J_TPU_DONATION_GUARD="1"):
        m = MultiLayerNetwork(zoo.TextGenerationLSTM(**LSTM_CONF)).init()
        m.fit((x[:, :LSTM_CONF["timesteps"]], y[:, :LSTM_CONF["timesteps"]]),
              epochs=1, batch_size=B)       # one chunk: the updater state exists now
        trips0 = donation_guard._trips.value()
        _zero_lstm_counts()
        snap = donation_guard.snapshot(m, "analysis.charrnn")
        m.fit((x, y), epochs=1, batch_size=B)
        rep = donation_guard.check_after_step(snap, m)
        torch.cuda.synchronize()
        launches = _lstm_launches()
        n_leaves = sum(len(tree_leaves(getattr(m, k))) for k in donation_guard.KINDS)
        trips = donation_guard._trips.value() - trips0
        check(trips == 0 and rep.trips == () and rep.advanced == n_leaves,
              f"char-RNN under the guard: {trips} trips, {rep}")
        check(launches == {"fused_lstm_fwd": 8, "fused_lstm_bwd": 8},
              f"char-RNN launches {launches} (2 + 2 a tBPTT chunk, 4 chunks)")
        check(retrace_guard.check("mln.step.tbptt", hits_site="mln.fit").ok,
              "the tBPTT site broke its bound")
        out.update(chunks=m.iteration - 1, trips=trips, leaves=n_leaves,
                   advanced=rep.advanced, launches=launches,
                   compiles=bucketing.telemetry().compiles("mln.step.tbptt"))
        # a step that rebinds one param leaf: one trip, its old tensor NaN
        layer0 = m.params[0]
        name = sorted(layer0)[0]
        old = layer0[name]
        update = m._update_params

        def rebinding_update(grads, *a, **kw):
            update(grads, *a, **kw)
            layer0[name] = layer0[name].clone()

        m._update_params = rebinding_update
        events0 = obs.event_log().counts().get("donation_guard", 0)
        _zero_lstm_counts()
        m.fit((x[:, :LSTM_CONF["timesteps"]], y[:, :LSTM_CONF["timesteps"]]),
              epochs=1, batch_size=B)
        torch.cuda.synchronize()
        trips = donation_guard._trips.value() - trips0
        events = obs.event_log().counts().get("donation_guard", 0) - events0
        nan = bool(torch.isnan(old).all())
        check(trips == 1 and events == 1 and nan and old.device.type == "cuda"
              and bool(torch.isfinite(layer0[name]).all()),
              f"the rebinding step: {trips} trips, {events} events, old NaN {nan}")
        out["rebind"] = {"leaf": f"params[0][{name!r}]", "shape": list(old.shape),
                         "trips": trips, "events": events, "old_is_nan_on_card": nan,
                         "launches": _lstm_launches()}
    return out


def _an_cost(model) -> dict:
    """(d): b1 and b16 ``mln.output`` dispatches with the guards off, on,
    on, off (AN_ROUNDS times); per dispatch by CUDA events and by the host
    clock. Then the site's post-dispatch check alone, off and on, on the
    host clock: what the guards add to a dispatch without the dispatch's
    own spread."""
    vocab, T = FLAGSHIP_CONF["vocab_size"], FLAGSHIP_CONF["max_len"]
    g = torch.Generator(device="cuda").manual_seed(40)
    out = {"nvidia_smi": card_line()}
    _reset_guard_state()    # (a)'s off-grid signature is not this window's
    on = dict(DL4J_TPU_STRICT_RETRACE="1", DL4J_TPU_DONATION_GUARD="1")
    for rows, n in AN_TIMED.items():
        x = torch.randint(0, vocab, (rows, T), generator=g, device="cuda")
        runs = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off") * AN_ROUNDS:
            with _guards(**(on if mode == "on" else {})):
                model.output(x)
                torch.cuda.synchronize()
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                for _ in range(n):
                    model.output(x)
                stop.record()
                torch.cuda.synchronize()
                host = (time.perf_counter() - t0) * 1e3 / n
                runs[mode].append({"cuda_ms": start.elapsed_time(stop) / n, "host_ms": host})
        med = {m: {k: float(np.median([r[k] for r in rs])) for k in ("cuda_ms", "host_ms")}
               for m, rs in runs.items()}
        out[f"b{rows}"] = {"dispatches_per_block": n, "runs": runs, "median": med,
                           "overhead_host_ms": med["on"]["host_ms"] - med["off"]["host_ms"],
                           "overhead_cuda_ms": med["on"]["cuda_ms"] - med["off"]["cuda_ms"]}
    site = model._get_output_fn()
    check_us = {}
    for mode in ("off", "on"):
        with _guards(**(on if mode == "on" else {})):
            t0 = time.perf_counter()
            for _ in range(AN_CHECKS):
                site.guard()
            check_us[mode] = (time.perf_counter() - t0) * 1e6 / AN_CHECKS
    out["guard_check_us"] = check_us
    return out


def _an_lint() -> dict:
    """(e): ``python -m deeplearning4j_tpu_torch.analysis.lint
    deeplearning4j_tpu_torch`` on this host, as a subprocess."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deeplearning4j_tpu_torch.analysis.lint",
                           "deeplearning4j_tpu_torch", "--json"], cwd=str(root),
                          capture_output=True, text=True, timeout=AN_LINT_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"the lint exited {proc.returncode}: {proc.stderr[-1000:]}")
    findings, end = json.JSONDecoder().raw_decode(proc.stdout)
    check(not any(f["new"] for f in findings), "the lint found new findings")
    per_module = {}
    for f in findings:
        if f["rule"] == "host-sync":
            per_module[f["path"]] = per_module.get(f["path"], 0) + 1
    return {"rc": proc.returncode, "seconds": seconds, "findings": len(findings),
            "host_sync_per_module": dict(sorted(per_module.items())),
            "summary": proc.stdout[end:].strip()[-200:]}


def _analysis_main(argv) -> int:
    """``python3 chip_smoke.py _analysis``: phase 39 alone, for work on the
    guards. Builds the kernels, runs the phase and prints its line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": card_line()})
    emit(build_report())
    emit(analysis_phase())
    return 0


def analysis_phase() -> dict:
    """Phase 39: the guards of ``analysis/`` on the card, and the lint."""
    t0 = time.perf_counter()
    _reset_guard_state()
    res = {"phase": "analysis"}
    steps_s = {}
    t1 = time.perf_counter()
    res["serve"], model = _an_serve()
    steps_s["serve"] = time.perf_counter() - t1
    for key, fn in (("unpadded", _an_unpadded), ("charrnn", _an_charrnn),
                    ("cost", lambda: _an_cost(model)), ("lint", _an_lint)):
        t1 = time.perf_counter()
        res[key] = fn()
        steps_s[key] = time.perf_counter() - t1
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["steps_s"] = steps_s
    res["seconds"] = time.perf_counter() - t0
    return res


def _wide_lm_counts():
    return {**_launch_counts(), **dict(fa.WIDE_LAUNCHES)}


def _wide_lm_serve(model, name: str, ids1, ids16, V: int) -> dict:
    """Phase 40's serving path for one model: every count goes to 0, then
    the model registered with ServeConfig(max_batch=16) (its warm
    dispatches), one 1 x 128 request and one 16 x 2048 dispatch, each with
    8 launches of the wide forward and none of kernel #1 or of a backward
    kernel; then the 16-row dispatch's forward by CUDA events, outside the
    counted run."""
    def since(before):
        return {k: v - before[k] for k, v in _wide_lm_counts().items()}

    _zero_flash_counts()
    _zero_wide_counts()
    registry = ModelRegistry(config=ServeConfig(
        max_batch=16, queue_limit=64, max_wait_s=0.1, default_deadline_s=600.0))
    registry.register(name, model)
    warm = _wide_lm_counts()
    worker = registry.worker(name)
    try:
        runs = {}
        for label, ids in (("1x128", ids1), ("16x2048", ids16)):
            before, b0 = _wide_lm_counts(), worker.stats()["batches"]
            n_spans = len(obs.recent_spans())
            out = worker.submit(ids, deadline_s=600.0)
            dispatches = [sp for sp in obs.recent_spans()[n_spans:]
                          if sp["span"] == "serve.dispatch"]
            runs[label] = {"dispatches": worker.stats()["batches"] - b0,
                           "dispatch_s": [sp["wall_s"] for sp in dispatches],
                           "launches": since(before),
                           "max_row_sum_dev": check_rows(torch.from_numpy(out), ids.shape + (V,),
                                                         f"{name} {label}")}
            del out
    finally:
        registry.shutdown()
    torch.cuda.synchronize()
    serve_launches = _wide_lm_counts()
    for label, r in runs.items():
        n = r["dispatches"]
        check(r["launches"]["flash_wide_fwd"] == 8 * n == r["launches"]["flash_fwd"],
              f"{name} {label}: {r['launches']} over {n} dispatches, not 8 wide forward "
              f"launches each")
    check(serve_launches["flash_wide_fwd"] == serve_launches["flash_fwd"] > 0
          and serve_launches["flash_bwd_dq"] == serve_launches["flash_bwd_dkv"] == 0
          and serve_launches["flash_wide_bwd_dq"] == serve_launches["flash_wide_bwd_dkv"] == 0,
          f"{name} serving launched another route or a backward kernel: {serve_launches}")
    forward_ms = time_cuda(lambda: model.output(ids16), iters=3, warmup=1)
    return {"config": {"max_batch": 16}, "warm_launches": warm, "runs": runs,
            "launches": serve_launches, "forward_16x2048_ms": forward_ms}


def _wide_lm_train(model, xt, yt, name: str) -> dict:
    """Phase 40's training path for one model: every count goes to 0, then
    a warm Adam step and 3 timed ones (CUDA events) on xt, with 8 launches
    of the wide forward, dq and dk/dv a step and none of another route, and
    a falling loss; the peak memory of the timed steps; then one more step
    split into forward / backward / update by CUDA events."""
    _zero_flash_counts()
    _zero_wide_counts()
    losses = [model._fit_batch(xt, yt, None, None)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    for _ in range(3):
        losses.append(model._fit_batch(xt, yt, None, None))
    ev[1].record()
    torch.cuda.synchronize()
    launches = _wide_lm_counts()
    step_ms = ev[0].elapsed_time(ev[1]) / 3
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{name}: the loss did not fall over 3 steps: {losses}")
    for kern in ("flash_wide_fwd", "flash_wide_bwd_dq", "flash_wide_bwd_dkv"):
        check(launches[kern] == 8 * 4,
              f"{name}: {kern} launched {launches[kern]} times in 4 steps, not 8 a step")
    check(launches["flash_fwd"] == launches["flash_wide_fwd"]
          and launches["flash_bwd_dq"] == launches["flash_wide_bwd_dq"]
          and launches["flash_bwd_dkv"] == launches["flash_wide_bwd_dkv"],
          f"{name}: a training launch took another route: {launches}")
    peak = torch.cuda.max_memory_allocated()
    live = [t.detach().requires_grad_(True) for t in tree_leaves(model.params)]
    ev[2].record()
    loss, _ = model._loss(tree_unflatten_like(model.params, live), model.state, xt, yt,
                          None, None, model._gen)
    ev[3].record()
    grads = torch.autograd.grad(loss, live)
    ev[4].record()
    model._update_params(tree_unflatten_like(model.params, list(grads)))
    ev[5].record()
    torch.cuda.synchronize()
    del grads, live, loss
    rows, T = xt.shape
    return {"rows": int(rows), "steps_timed": 3, "loss": losses, "launches": launches,
            "step_ms": step_ms,
            "split_ms": {"forward": ev[2].elapsed_time(ev[3]),
                         "backward": ev[3].elapsed_time(ev[4]),
                         "update": ev[4].elapsed_time(ev[5])},
            "tokens_per_s": rows * T / (step_ms / 1e3), "max_memory_allocated_bytes": peak}


def wide_lm_phase() -> dict:
    """Phase 40: the flagship TransformerLM with 4 heads (WIDE_LM_CONF: D =
    512, so every attention runs the wide-head route) served and trained in
    bf16, then served and trained in float32 (the wide f32 forward, dq and
    dk/dv on register tiles). Counts go to 0 just before each path and are
    read just after: the bf16 model served (_wide_lm_serve); then trained
    (_wide_lm_train: a warm Adam step and 3 timed ones at 16 x 2048, 8
    launches of the wide forward, dq and dk/dv a step, a falling loss, one
    more step split into forward / backward / update, the peak memory);
    then the same configuration with dtype float32 served the same way,
    with its peak memory, and trained the same way, its parameter gradients
    on one 2 x 2048 batch within GRAD_CHECK_REL_F32 of the plain backward's
    (grads_vs_plain_backward, outside the counted run)."""
    t0 = time.perf_counter()
    conf = zoo.TransformerLM(updater={"type": "adam", "lr": TRAIN_LR}, **WIDE_LM_CONF)
    V, T = WIDE_LM_CONF["vocab_size"], WIDE_LM_CONF["max_len"]
    L, C, H = WIDE_LM_CONF["n_blocks"], WIDE_LM_CONF["d_model"], WIDE_LM_CONF["n_heads"]
    rng = np.random.RandomState(40)
    ids1 = rng.randint(0, V, (1, 128)).astype(np.int64)
    ids16 = rng.randint(0, V, (16, T)).astype(np.int64)
    torch.cuda.reset_peak_memory_stats()

    # the serving path: every launch below is counted
    model = MultiLayerNetwork(conf).init()
    serve = _wide_lm_serve(model, "wide_lm", ids1, ids16, V)

    # the training path: a warm step, then 3 timed, every launch counted
    xt = torch.as_tensor(ids16, device="cuda")
    yt = torch.as_tensor(np.roll(ids16, -1, axis=1), device="cuda")
    train = _wide_lm_train(model, xt, yt, "wide_lm")
    n_params = model.num_params()
    check(n_params == 415_455_232, f"wide_lm has {n_params} params, not the flagship's")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # the f32 paths: the same configuration in float32, served, then trained
    torch.cuda.reset_peak_memory_stats()
    model = MultiLayerNetwork(zoo.TransformerLM(
        updater={"type": "adam", "lr": TRAIN_LR}, **dict(WIDE_LM_CONF, dtype="float32"))).init()
    check(model.num_params() == n_params, "wide_lm_f32 has other params than wide_lm")
    serve32 = _wide_lm_serve(model, "wide_lm_f32", ids1, ids16, V)
    serve32["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    train32 = _wide_lm_train(model, xt, yt, "wide_lm_f32")
    train32["grad_check"] = grads_vs_plain_backward(model, xt[:2], yt[:2], GRAD_CHECK_REL_F32)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "wide_lm",
            "model": {"vocab": V, "T": T, "d_model": C, "heads": H, "head_dim": C // H,
                      "blocks": L, "dtype": "bfloat16", "params": n_params},
            "routes": {str(dt).split(".")[-1]: {kern: fa.wide_plan(kern, C // H, dt).route
                                                for kern in fa.WIDE_KERNELS}
                       for dt in (torch.bfloat16, torch.float32)},
            "serve": serve,
            "serve_f32": serve32,
            "train": train,
            "train_f32": train32,
            "seconds": time.perf_counter() - t0}


def _kernel_row(name, source, replaces, launches, by_path, max_abs_err, ms, plain_ms,
                bound_ms, bound_by, library_ms, **extra):
    return dict({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches, "launches_by_path": by_path,
                 "max_abs_err": max_abs_err, "ms": ms, "kernel_ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms}, **extra)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "allow_tf32": {"matmul": False, "cudnn": False}})
    emit(build_report())
    kern = kernel_phase()
    emit(kern)
    emit(small_phase())
    srv = serve_phase()
    t = kern["timing"]
    bd = srv["breakdown_16x2048"]
    bd["attention_ms"] = 8 * t["kernel_ms"]   # 8 blocks at the flagship shape
    bd["attention_share"] = bd["attention_ms"] / bd["forward_ms"]
    emit(srv)
    gc.collect()
    torch.cuda.empty_cache()   # the serve model is gone before training starts

    with tempfile.TemporaryDirectory() as tmp:
        trn = train_phase(Path(tmp))
    bt = kern["bwd_timing"]
    trn["attention_ms"] = {"forward": 8 * t["kernel_ms"],
                           "backward": 8 * (bt["dq"]["kernel_ms"] + bt["dkv"]["kernel_ms"]),
                           "backward_with_delta": 8 * bt["whole_ms"]}
    emit(trn)
    gc.collect()
    torch.cuda.empty_cache()

    lk = lstm_kernel_phase()
    emit(lk)
    emit(lstm_small_phase())
    lt = lk["timing"]
    with tempfile.TemporaryDirectory() as tmp:
        ltr = lstm_train_phase(Path(tmp))
        ltr["step_128x50"]["kernel_ms"] = {"forward": 2 * lt["fwd"]["kernel_ms"],
                                           "backward": 2 * lt["bwd"]["kernel_ms"]}
        lsm = lstm_sample_phase(ltr.pop("zip"))
    emit(ltr)
    emit(lsm)
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ctr = cnn_train_phase(Path(tmp))
        csv = cnn_serve_phase(ctr.pop("zip"))
    emit(ctr)
    emit(csv)
    emit(simplecnn_phase())
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        rtr = resnet50_train_phase(Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        rsv = resnet50_serve_phase(rtr.pop("zip"))
    emit(rtr)
    emit(rsv)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        glstm = graph_lstm_phase(Path(tmp))
    emit(glstm)
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        rtrain = resilience_train_phase(Path(tmp))
        model = rtrain.pop("model_obj")
        emit(rtrain)
        remat = remat_train_phase(model, Path(tmp))
        del model
    emit(remat)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        lres = lstm_resilience_phase(Path(tmp))
    emit(lres)
    emit(lenet_runtime_phase())
    gc.collect()
    torch.cuda.empty_cache()
    chunk = chunk_kernel_phase()
    emit(chunk)
    rattn = ring_attention_phase()
    emit(rattn)
    ring_tr = ring_train_phase()
    emit(ring_tr)
    gc.collect()
    torch.cuda.empty_cache()
    gen = generate_phase()
    emit(gen)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        moe = moe_train_phase(Path(tmp))
        moe_zip = moe.pop("zip")
        emit(moe)
        moe_sv = moe_serve_phase(moe_zip)
    emit(moe_sv)
    gc.collect()
    torch.cuda.empty_cache()
    # phases 26-27 run no hand-written kernel: every count must stay 0
    _zero_all_kernel_counts()
    w2v = word2vec_phase()
    glove_slice = w2v.pop("glove_slice")
    _check_no_kernel(w2v["launches"], "word2vec")
    emit(w2v)
    _zero_all_kernel_counts()
    emb = embeddings_phase(glove_slice)
    _check_no_kernel(emb["launches"], "embeddings")
    emit(emb)
    del glove_slice
    # phases 28-29 run no hand-written kernel either
    _zero_all_kernel_counts()
    srch = search_phase()
    a_corpus, a_queries, b_corpus = (srch.pop(k) for k in ("a_corpus", "a_queries", "b_corpus"))
    srch["launches"] = _kernel_launches()
    _check_no_kernel(srch["launches"], "search")
    emit(srch)
    _zero_all_kernel_counts()
    clus = clustering_phase(a_corpus, a_queries, b_corpus)
    clus["launches"] = _kernel_launches()
    _check_no_kernel(clus["launches"], "clustering")
    emit(clus)
    del a_corpus, a_queries, b_corpus
    gc.collect()
    torch.cuda.empty_cache()
    # phase 30 counts its launches path by path; phase 31 runs no hand-written kernel
    with tempfile.TemporaryDirectory() as tmp:
        imp = model_import_phase(Path(tmp))
    emit(imp)
    gc.collect()
    torch.cuda.empty_cache()
    _zero_all_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        dpath = data_path_phase(Path(tmp))
        dpath["launches"] = _kernel_launches()
        _check_no_kernel(dpath["launches"], "data_path")
        emit(dpath)
        dcli = dp_cli_phase(Path(tmp))
    emit(dcli)
    gc.collect()
    torch.cuda.empty_cache()
    # phases 32-34 run two gloo ranks on the card; each rank counts its launches
    par = {}
    for name, fn in (("tp_train", tp_train_phase), ("dp_train", dp_train_phase),
                     ("gpipe_train", gpipe_train_phase)):
        with tempfile.TemporaryDirectory() as tmp:
            par[name] = fn(Path(tmp))
        emit(par[name])
        gc.collect()
        torch.cuda.empty_cache()
    pinf = parallel_inference_phase()
    emit(pinf)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 37 runs worker processes on the card; each reports its launches
    with tempfile.TemporaryDirectory() as tmp:
        elas = elastic_train_phase(Path(tmp))
    emit(elas)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 38 counts its launches step by step
    with tempfile.TemporaryDirectory() as tmp:
        rt = runtime_layer_phase(Path(tmp))
    emit({"phase": "runtime_layer", "seconds": rt["seconds"],
          "steps_s": {k: rt[k]["step_s"] for k in ("serve", "charrnn", "tune", "dashboard")}})
    gc.collect()
    torch.cuda.empty_cache()
    # phase 39 counts its launches step by step
    an = analysis_phase()
    emit(an)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 40: the wide-head kernels on a model's path
    wlm = wide_lm_phase()
    emit(wlm)
    imp_by = imp["launches_by_path"]
    par_flash = {f"tp_train_rank{r}": rk["launches"]
                 for r, rk in enumerate(par["tp_train"]["ranks_detail"])}
    par_flash.update({f"tp_train_gn_rank{r}": rk["launches"] for r, rk in
                      enumerate(par["tp_train"]["gradient_normalization"]["ranks"])})
    par_lstm = {f"dp_train_{case}_rank{r}": rk[case]["launches"]
                for r, rk in enumerate(par["dp_train"]["ranks_detail"]) for case in rk}
    par_lstm.update({f"gpipe_train_stage{rk['stage']}": rk["launches"]
                     for rk in par["gpipe_train"]["ranks_detail"]})
    par_lstm["parallel_inference"] = pinf["launches"]
    par_lstm.update(elas["launches_by_path"])

    fwd_cases = kern["cases"]
    bwd_cases = kern["bwd_cases"]
    tl = trn["launches"]

    def flash_paths(name):
        by = {f"resilience_train_{run}": n[name]
              for run, n in rtrain["launches_by_run"].items()}
        by.update({"remat_train_plain": remat["plain"]["launches"][name],
                   "remat_train_remat": remat["remat"]["launches"][name],
                   "ring_train": ring_tr["launches"][name],
                   "generate": gen["launches"][name],
                   "moe_train": moe["launches"][name],
                   "moe_serve": moe_sv["launches"][name]})
        by.update({f"ring_attention_{run}": r["kernel_launches"][name]
                   for run, r in rattn["runs"].items()})
        by.update({"word2vec": w2v["launches"][name], "embeddings": emb["launches"][name],
                   "search": srch["launches"][name], "clustering": clus["launches"][name]})
        by.update({f"model_import_{path}": n[name] for path, n in imp_by.items()})
        by["data_path"] = dpath["launches"][name]
        by.update({path: n[name] for path, n in par_flash.items()})
        rl = rt["serve"]["launches"]
        by.update({f"runtime_layer_{path}": n[name] for path, n in rl.items()})
        by.update({"analysis_serve": an["serve"]["launches"][name],
                   "analysis_unpadded": an["unpadded"]["launches"][name]})
        return by

    fwd_by = dict({"serve": srv["launches"], "train": tl["flash_fwd"]},
                  **flash_paths("flash_fwd"))
    rows = [_kernel_row(
        "flash_fwd", "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
        "deeplearning4j_tpu/ops/flash_attention.py:57",
        sum(fwd_by.values()), fwd_by,
        fwd_cases[0]["max_abs_err"], t["kernel_ms"], t["plain_ms"], t["bound_ms"],
        t["bound_by"], t["library_ms"],
        max_err=max(c["max_abs_err"] for c in fwd_cases),
        roofline_share=t["roofline_share"], http_bucket_4x128=t["http_bucket"],
        wide_head=[{k: r[k] for k in ("shape", "dtype", "column_groups", "fwd_ms",
                                      "fwd_bound_ms", "library_fwd_ms")}
                   for r in kern["wide_head"]["timing"]])]
    for name, key, line, errs in (("flash_bwd_dq", "dq", 224, ("dq",)),
                                  ("flash_bwd_dkv", "dkv", 275, ("dk", "dv"))):
        bk = bt[key]
        bwd_by = dict({"serve": 0, "train": tl[name]}, **flash_paths(name))
        rows.append(_kernel_row(
            name, "deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
            f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
            sum(bwd_by.values()), bwd_by,
            max(bwd_cases[0][f"{e}_max_abs_err"] for e in errs), bk["kernel_ms"],
            bt["plain_ms"], bk["bound_ms"], bk["bound_by"], bt["library_ms"],
            max_err=max(c[f"{e}_max_abs_err"] for c in bwd_cases for e in errs),
            plain_and_library_compute="dq, dk and dv together",
            whole_backward_ms=bt["whole_ms"],
            wide_head=[{k: r[k] for k in ("shape", "dtype", "column_groups", f"{key}_ms",
                                          f"{key}_bound_ms", "library_bwd_ms")}
                       for r in kern["wide_head"]["timing"]]))
    # the wide-head kernels on phase 40's paths (the 16-bit forward, dq and
    # dk/dv on wgmma, the f32 forward, dq and dk/dv on register tiles):
    # launches from phase 40 (the f32 kernels: its f32 serving and training
    # paths), timed at WIDE_FLAGSHIP (the first two timing rows: bf16, f32)
    wh = kern["wide_head"]
    flagship = [WIDE_FLAGSHIP[k] for k in ("B", "T", "H", "D")]
    wt, wt32 = wh["timing"][:2]
    check(wt["shape"] == wt32["shape"] == flagship and wt["dtype"] == "bfloat16"
          and wt32["dtype"] == "float32", (wt["shape"], wt32["shape"]))

    def flagship_case(cases, dtype):
        return [c for c in cases if [c["B"], c["T"], c["H"], c["D"]] == flagship
                and c["dtype"] == dtype][0]

    for name, key, line, launch_key, errs, dtype, kernels in (
            ("flash_wide_fwd_wgmma", "fwd", 57, "flash_wide_fwd", None, "bfloat16",
             "flash_wide_fwd_wgmma_kernel (bf16, f16; head dims past 256)"),
            ("flash_wide_fwd_tiles", "fwd", 57, "flash_wide_fwd", None, "float32",
             "flash_wide_fwd_tiles_kernel (f32 register tiles; head dims past 256)"),
            ("flash_wide_dq_wgmma", "dq", 224, "flash_wide_bwd_dq", ("dq",), "bfloat16",
             "flash_wide_dq_wgmma_kernel (bf16, f16; head dims past 256)"),
            ("flash_wide_dkv_wgmma", "dkv", 275, "flash_wide_bwd_dkv", ("dk", "dv"), "bfloat16",
             "flash_wide_dkv_wgmma_kernel (bf16, f16; head dims past 256)"),
            ("flash_wide_dq_tiles", "dq", 224, "flash_wide_bwd_dq", ("dq",), "float32",
             "flash_wide_dq_tiles_kernel (f32 register tiles; head dims past 256)"),
            ("flash_wide_dkv_tiles", "dkv", 275, "flash_wide_bwd_dkv", ("dk", "dv"), "float32",
             "flash_wide_dkv_tiles_kernel (f32 register tiles; head dims past 256)")):
        f32 = dtype == "float32"
        tr = wt32 if f32 else wt
        paths = ("serve_f32", "train_f32") if f32 else ("serve", "train")
        by = {f"wide_lm_{path}": wlm[path]["launches"][launch_key] for path in paths}
        same = [c for c in (wh["cases"] if errs is None else wh["bwd_cases"])
                if (c["dtype"] == "float32") == f32]
        if errs is None:
            err = flagship_case(wh["cases"], dtype)["max_abs_err"]
            max_err = max(c["max_abs_err"] for c in same)
            plain, library = tr["plain_fwd_ms"], tr["library_fwd_ms"]
        else:
            wb = flagship_case(wh["bwd_cases"], dtype)
            err = max(wb[f"{e}_max_abs_err"] for e in errs)
            max_err = max(c[f"{e}_max_abs_err"] for c in same for e in errs)
            plain, library = tr["plain_bwd_ms"], tr["library_bwd_ms"]
        rows.append(_kernel_row(
            name, "deeplearning4j_tpu_torch/csrc/flash_wide.cu",
            f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
            sum(by.values()), by, err, tr[f"{key}_ms"], plain, tr[f"{key}_bound_ms"],
            tr[f"{key}_bound_by"], library, max_err=max_err,
            shape=f"B16 T2048 H4 D512 {'f32' if f32 else 'bf16'}, causal (the flagship's "
                  f"products at 4 heads)",
            kernels=kernels, library_backend=tr["library_backend"],
            plain_and_library_compute=("out" if errs is None else "dq, dk and dv together"),
            wide_head=[{k: r[k] for k in ("shape", "dtype", "routes", f"{key}_ms",
                                          f"{key}_bound_ms")} for r in wh["timing"]
                       if (r["dtype"] == "float32") == f32]))
    ct, ccases = chunk["timing"], chunk["cases"]
    chunk_by = {name: dict({f"ring_attention_{run}": r["chunk_launches"][name]
                            for run, r in rattn["runs"].items()},
                           word2vec=w2v["launches"][f"chunk_{name}"],
                           embeddings=emb["launches"][f"chunk_{name}"],
                           search=srch["launches"][f"chunk_{name}"],
                           clustering=clus["launches"][f"chunk_{name}"],
                           data_path=dpath["launches"][f"chunk_{name}"],
                           **{f"model_import_{path}": n[f"chunk_{name}"]
                              for path, n in imp_by.items()},
                           **{path: n[f"chunk_{name}"] for path, n in par_flash.items()})
                for name in fa.CHUNK_LAUNCHES}
    d = ct["diagonal"]
    rows.append(_kernel_row(
        "flash_attention_block", "deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
        "deeplearning4j_tpu/ops/flash_attention.py:563",
        sum(chunk_by["flash_fwd"].values()), chunk_by["flash_fwd"],
        ccases[0]["max_abs_err"], d["fwd_ms"], d["plain_fwd_ms"], d["fwd_bound_ms"],
        d["fwd_bound_by"], d["library_fwd_ms"],
        max_err=max(c["max_abs_err"] for c in ccases),
        shape="B16 Tq512 Tk512 H16 D128 bf16, causal, offsets 0 (the ring's diagonal block)",
        kernels="kernel #1 with Tq, Tk and the offsets (flash_fwd.cu; flash_wide.cu past D 256)",
        off_diagonal=ct["off_diagonal"], library=d["library"]))
    rows.append(_kernel_row(
        "flash_attention_block_grad", "deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
        "deeplearning4j_tpu/ops/flash_attention.py:648",
        sum(chunk_by["flash_bwd_dq"].values()) + sum(chunk_by["flash_bwd_dkv"].values()),
        {"dq": chunk_by["flash_bwd_dq"], "dkv": chunk_by["flash_bwd_dkv"]},
        max(ccases[0][f"{e}_max_abs_err"] for e in ("dq", "dk", "dv")), d["fwd_bwd_ms"],
        d["plain_fwd_bwd_ms"], d["fwd_bwd_bound_ms"], d["fwd_bwd_bound_by"],
        d["library_fwd_bwd_ms"],
        max_err=max(c[f"{e}_max_abs_err"] for c in ccases for e in ("dq", "dk", "dv")),
        timed="forward + backward with both cotangents (do, dlse) at the diagonal block",
        kernels="kernels #1-#3 with the offsets; delta_eff = rowsum(do * out) - dlse",
        ring_ms=rattn["timing"], library=d["library"]))
    lcases = lk["cases"]
    for name, key, line, errs in (("fused_lstm_fwd", "fwd", 60, ("hs", "gates", "cs")),
                                  ("fused_lstm_bwd", "bwd", 119, ("dzx", "dwh"))):
        by_path = {"lstm_train": ltr["launches"][name], "lstm_sample": lsm["launches"][name]}
        by_path.update({f"graph_lstm_{path}": n[name]
                        for path, n in glstm["launches_by_path"].items()})
        by_path.update({f"lstm_resilience_{path}": n[name]
                        for path, n in lres["launches_by_path"].items()})
        by_path.update({"word2vec": w2v["launches"][name], "embeddings": emb["launches"][name],
                        "search": srch["launches"][name], "clustering": clus["launches"][name]})
        by_path.update({f"model_import_{path}": n[name] for path, n in imp_by.items()})
        by_path["data_path"] = dpath["launches"][name]
        by_path.update({path: n[name] for path, n in par_lstm.items()})
        by_path.update({f"runtime_layer_charrnn_{run}": n[name]
                        for run, n in rt["charrnn"]["launches"].items()})
        by_path["runtime_layer_dashboard"] = rt["dashboard"]["launches"][name]
        by_path["analysis_charrnn"] = an["charrnn"]["launches"][name]
        by_path["analysis_rebind"] = an["charrnn"]["rebind"]["launches"][name]
        rows.append(_kernel_row(
            name, f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            f"deeplearning4j_tpu/ops/fused_lstm.py:{line}",
            sum(by_path.values()), by_path,
            max(lcases[0][f"{e}_max_abs_err"] for e in errs), lt[key]["kernel_ms"],
            lt["plain_ms"][key], lt[key]["bound_ms"], lt[key]["bound_by"],
            lt["library_ms"][key],
            max_err=max(c[f"{e}_max_abs_err"] for c in lcases for e in errs),
            route_char_rnn=lt["route"][key],
            host_us_per_call_B32_T1=lt["host_us_per_call_B32_T1"][name],
            **({"sampling_B32_T1": lt["sampling_B32_T1"]} if key == "fwd" else {}),
            library=f"torch.nn.LSTM (cuDNN) {key}: the nearest yardstick, not the same "
                    "function (its own input projection, no peepholes or mask)"))
    emit({"smoke_seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["_rank"]:     # a rank of a parallel phase (parallel/launch.py)
        sys.exit(_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["_elastic"]:  # a worker of the elastic phase (train/elastic.py)
        sys.exit(_elastic_main(sys.argv[2:]))
    if sys.argv[1:2] == ["_bundle_child"]:  # the fresh process of phase 38 (a)
        sys.exit(_bundle_child_main(sys.argv[2:]))
    if sys.argv[1:2] == ["_runtime_layer"]:  # phase 38 alone
        sys.exit(_runtime_layer_main(sys.argv[2:]))
    if sys.argv[1:2] == ["_analysis"]:  # phase 39 alone
        sys.exit(_analysis_main(sys.argv[2:]))
    sys.exit(main())
