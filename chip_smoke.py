"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, one JSON line each:

1. card      — the card's name and power limit (nvidia-smi);
2. build     — every CUDA kernel of the port, built with nvcc from csrc/,
               and the eight probe sources probes/packed_gat_ablate.cu,
               probes/packed_gat_designs.cu, probes/packed_rgcn_ablate.cu,
               probes/bsr_gat_designs.cu, probes/flash_gat_designs.cu,
               probes/packed_rgcn_designs.cu, probes/spmm_csr_designs.cu
               and probes/segment_sum_designs.cu (which include csrc/'s
               packed_gat.cu, packed_rgcn.cu, bsr_gat.cu, flash_gat.cu,
               spmm_csr.cu and sorted_spmm.cu): one nvcc per source, all
               started together; and the port's native host library
               (cluster/native/graphcore.cpp) with g++ beside them;
   cluster   — that library on this machine: on a synthetic ModelNet
               sample and a FAUST mesh at the published vertex count,
               knn_graph, radius, voxel_grid and coalesce_edges bitwise
               equal to their plain numpy versions, fps's k distinct
               points and graclus_cluster's matching of adjacent nodes;
3. kernel    — each kernel against its plain PyTorch version on the
               card, at the shapes the main paths give it, relative to
               the largest reference magnitude, with the kernel's, the
               plain version's and (where one exists) one library call's
               times (CUDA graphs of 50 calls timed with CUDA events)
               and the bound:
               - spmm_csr at Cora (3072 padded nodes, its real edges and
                 3072 self loops, F = 16 and 7), at a synthetic graph
                 of PubMed's shapes (F = 16 and 128) and at a graph with
                 a receiver of 500 senders and a sender of 400 receivers
                 (F = 16), both CSR directions, fp32 x (1e-5) and bf16 x
                 (1e-2); two launches bitwise equal;
               - the packed-GAT forward (raw num‖den and the shift's m,
                 each receiver's largest sender s) and backward
                 (dd, ds, dh) at Cora with conv1's (H, C) = (8, 8) and
                 conv2's (1, 7), at PubMed's shapes with (8, 8), and at a
                 graph with a receiver of 500 senders and a sender of 400
                 receivers with (8, 8), (1, 7) and (3, 5) (the backward's
                 three dispatch branches: float4 and one-float lane maps,
                 and the first design), and at examples/ppi.py's widths
                 (4, 256) and (6, 121), which run the wide-head map, on
                 one synthetic PPI train graph (3072 padded nodes, ~70k
                 edges of the sparse path's edge set, repeated edges
                 kept) and on the val batch of 2 graphs, attention
                 dropout 0 and 0.6, fp32 (1e-5); two launches bitwise
                 equal; and the shift's stress case, Cora (8, 8) and
                 (1, 7) at dropout 0.6 with 5% of the nodes' s lifted by
                 100-150, where the global shift of the JAX operator
                 underflows most rows (counted and required) and no row
                 with an edge may leave its den below 1;
               - the packed-RGCN forward (two launches: the messages,
                 then the receivers' segment sum) and backward (dxB,
                 datt) at the two operators of the MUTAG-RDF slice
                 (synthetic graph at the published size: 24576 padded
                 nodes, 141864 edges, 46 relations; conv1's (B, C) =
                 (30, 16) in embed mode, conv2's (30, 2)), and at an odd
                 shape (B, C) = (5, 33) on a graph with a hub receiver of
                 3,013 edges, a hub sender and a dominant relation, fp32
                 (1e-5); two launches bitwise equal;
               - the dense-mask flash-GAT forward (out, lse) and backward
                 (dd, ds, dh) at Cora's mask with conv1's (8, 8) and
                 conv2's (1, 7), at a half-full directed mask of 2048
                 nodes with empty rows and columns, attention dropout 0
                 and 0.6, and at the operator's cap, 8192 nodes at
                 PubMed's degree, dropout 0.6, fp32 (1e-5); two launches
                 bitwise equal;
               - the block-sparse GAT forward (out, lse), row pass
                 (dd, D) and column pass (ds, dh) at Cora's mask with
                 (8, 8) and (1, 7), also against the flash-GAT kernels'
                 outputs (1e-6); at PubMed's shapes after RCM reordering
                 (24576 padded nodes, ~113k entries) with (8, 8) and
                 (1, 3), with a sweep over tile shapes; at a block-dense
                 mask above the dense operator's cap (16384 nodes, 128
                 communities half full, ~1.07 M entries); at a mask whose
                 node count is no multiple of the tile, with a hub row
                 and a hub column of ~3000 entries; attention dropout 0
                 and 0.6, fp32 (1e-5); two launches bitwise equal;
               - the sorted segment sum at the GCN CSRs of Cora and of
                 PubMed after RCM reordering, both directions, F = 16 and
                 the class width, fp32 messages (1e-5) and bf16 (1e-2),
                 with torch.segment_reduce as the library call, and the
                 whole SortedSpmm call (gather and kernel) against
                 spmm_csr on the same CSR ("kernel_compare" lines);
               - the fused two-layer GCN forward (h1_pre, out) and
                 backward (gA2, dz1) at PubMed after RCM with (H, C) =
                 (16, 3) and Cora with (16, 7), dropout 0 and 0.5, fp32
                 (1e-5), against the unfused chain of spmm_csr launches
                 and torch ops; two launches bitwise equal;
               - the citation suite's shapes: spmm_csr at F = 1433, 300
                 and 33 on the Cora GCN CSR (SGC's propagation at 1433;
                 the other two widths of the chunk map), at 1433 on
                 Spline's two kernel-index CSRs (its conv1; and 16, both
                 directions), and at ARMA's F = 48 and 21 on L̂'s CSR,
                 both directions; the segment sum at AGNN's shapes (1
                 and 16 channels by receiver, 16 by sender) and at DNA's
                 shapes (its GCN edge set: the messages by receiver at
                 F = 128, its layers' key-value gradients by sender at
                 1 to 4 x 256); fp32 (1e-5); two launches bitwise
                 equal;
               - the graph-level examples' shapes: spmm_csr on a MUTAG
                 batch's operator (examples/mutag_gin.py: 32 graphs
                 padded to 1024 nodes and 4096 edges) at F = 7 and 32,
                 both directions, over the real edges (mutag_operators)
                 and, in the same call, over every edge slot (the
                 padding edges on the padding node's row), the two
                 bitwise equal; the readouts' segment sum over the batch
                 vector's real nodes (``pool_operator``: a row a graph)
                 at MUTAG's F = 32, ENZYMES' 129 (the mean pool's 128
                 channels and count) and QM9's Set2Set 64 and 1; QM9's
                 NNConv messages by receiver over the real edges at 64
                 and its gather by sender's sum; MUTAG's readout and
                 QM9's two sums at 64 also over every slot (the padding
                 rows) in the same call, the two bitwise equal; fp32
                 (1e-5);
   kernel_faust — spmm_csr on examples/faust.py's rectangular spline
               operator of a mesh at the published vertex count (8192
               padded nodes x K = 125 rows over 8192 columns) and its
               transpose, F = 1, 32 and 64, fp32 (1e-5, two launches
               bitwise equal), timed warm and L2-flushed, beside the
               K = 125 square operators and the cat for the same product,
               cuSPARSE and the bound; and on the full-scale synthetic
               Reddit graph (232,965 nodes, ~11.6 M edges) at F = 602 and
               128, checked on its first 20,000 rows;
   kernel_mnist — spmm_csr on an mnist_graclus batch's spline operators
               (64 graphs, N = 6144: conv1's at F = 1, conv2's at F = 32
               both directions) and the segment sum at its pools' means
               (F = 3), its readout (F = 65) and mnist_nn_conv's NNConv
               sums by receiver (F = 32 and 64) and gather by sender (32),
               over the batch's real entries, and the pools', the
               readout's and level 0's NNConv sum also over every slot
               (the padding rows) in the same call, the two bitwise
               equal; fp32 (1e-5), cuSPARSE or torch.segment_reduce
               beside them;
   kernel_scale — HybridSpmm on Cora (windows of 512) beside one fp32
               spmm_csr over the same edges (1e-2 of the fp32 plain
               version); BlockSpmm on bench_scale.py's community graph at
               Reddit's published size (114,615,892 edges, generated in
               the phase) at F = 602 and 128: forward and dx on its
               first 2000 rows against the fp32 plain sums (1e-2), two
               calls bitwise equal, beside one fp32 spmm_csr over all
               edges, cuSPARSE, both bounds, and the batched product with
               bf16 or fp32 output and with fp32 inputs;
   kernel_closure — the kernels at the closure and sampled paths'
               shapes against their plain versions (fp32 1e-5, two
               launches bitwise equal),
               with cuSPARSE and the bound: the closure GCN's rectangular
               operators on Cora (layer 0 at F = 16, layer 1 at 7, both
               directions), the closure GAT's two layers ((8, 8) and
               (1, 7), dropout 0.6), the closure RGCN's embedding-mode
               and transform layers on MUTAG-RDF, and spmm_csr on one
               sampled batch of the full-scale Reddit graph (512 seeds,
               fan-out [10, 10]) at F = 602 and 128, both directions;
   kernel_driver — spmm_csr at the research driver's GCN widths on Cora
               (F = 1084 and 819, both directions) and the packed GAT at
               its GAT's layers over the remove-then-add edge set ((8,
               135) and (8, 102) at dropout 0.6, (1, 7) at 0), fp32
               (1e-5), with cuSPARSE and the bound;
   probe     — the probes' libraries against the kernels that ship:
               every term-by-term ablation mode of the packed-GAT backward
               (RCM-PubMed, (8, 8), dropout 0.6) and of the packed-RGCN
               backward (MUTAG conv1 and conv2) launched once, finite, and
               counted; the forward's first design at prefetch depths 1,
               2 and 4 (MUTAG conv1, conv2 and the hub operator);
               ``full``, launched through the probe library's own kernel
               table, bitwise equal to the library's backward (also at
               Cora and the hub operator) and within 1e-5 of the plain
               version, depths 2 and 4 bitwise equal to depth 1, and
               depth 1 within 1e-5 of the library's forward (another
               design); the first design of the block-sparse GAT forward
               and column pass (probes/bsr_gat_designs.cu) against the
               library's at RCM-PubMed (8, 8), dropout 0.6, within 1e-6
               (the row pass's D bitwise), and both within 1e-5 of the
               plain versions; the same for
               the first design of the bsr row pass and of the packed-GAT
               forward and backward, with the wide-head map at every
               width (probes/packed_gat_designs.cu; Cora (8, 8) and the
               research driver's (8, 135), dropout 0.6; two launches of
               the library's forward bitwise equal; the wide-head map's
               num‖den, m and dh bitwise the first design's), and of
               spmm_csr
               (probes/spmm_csr_designs.cu; Cora's GCN CSR, F = 16, fp32
               x and bf16 x: 1e-6 between the designs, 1e-5 and 1e-2 to
               the plain version; F = 1433, 300 and 33, fp32, and 1433
               bf16: the chunk map and the library bitwise equal to the
               first design); the segment sum's first design and chunk
               map (probes/segment_sum_designs.cu) at DNA's by-sender
               F = 1024 and 256 (fp32 and bf16) and AGNN's F = 16, and
               the RGCN hub operator's C = 33: every design bitwise
               equal to the first, each within 1e-5 (fp32) or 1e-2
               (bf16) of the plain version; the first design of the
               dense-mask GAT forward and backward (probes/flash_gat_designs.cu) against
               the library's at Cora (8, 8), dropout 0.6, within 1e-6 (D
               bitwise) and both within 1e-5 of the plain version; the
               first design of the packed-RGCN forward
               (probes/packed_rgcn_designs.cu) within 1e-5 of the
               library's at MUTAG conv1 and its backward bitwise equal to
               the library's, each within 1e-5 of the plain version; the
               probe scripts print the timing tables;
4. slice     — the GCN path as a user runs it: Planetoid Cora ->
               from_data -> train_gcn(epochs=200, device="cuda"), the
               epochs captured in one CUDA graph (the default): the first
               epoch eager, the second captured, 199 replays, then the
               evaluation; the kernel's launches stated as captured per
               epoch x replays + warm-up + evaluation (4 x 199 + 4 + 2 =
               802), accuracy gates, and the trained model's logits on the
               card against the plain path on the CPU; then the same run
               eager (capture=False, its launches counted as before) and
               both runs' seconds;
5. slice_gat — the GAT path the same way: train_gat(epochs=200), the
               packed-GAT launches;
   slice_gat_dense — the same with backend="dense": every attention
               layer through the dense-mask flash-GAT kernels, and no
               packed-GAT launch;
   slice_gat_bsr — examples/gat.py --dataset PubMed --backend bsr:
               Planetoid PubMed -> NormalizeFeatures -> reorder_graph
               (RCM) -> from_data -> train_gat(epochs=200,
               backend="bsr"), every attention layer through the
               block-sparse kernels, no packed- or flash-GAT launch, the
               trained logits also against the packed operator's on the
               card, peak device memory (the CUDA graph's pool counted)
               under 1 GB;
6. slice_rgcn — the RGCN path the same way: Entities MUTAG at
               scale=1.0 -> from_data -> train_rgcn(epochs=50), the
               packed-RGCN launches, peak device memory;
   slice_gcn_sorted, slice_gcn_fused — the GCN of bench_common.py's
               full-graph rows on PubMed after RCM (N = 24576), 200
               epochs with train_gcn(backend="sorted") and
               backend="fused", every aggregation through the segment-sum
               kernel or the fused kernels;
   slice_gcn_dense — the GCN on Cora with backend="dense" (bf16 dense
               adjacency, one matrix product per aggregation, no kernel
               of the port);
   slice_gcn_hybrid — the GCN on Cora with backend="hybrid" (the JAX
               pallas=True: HybridSpmm, two spmm_csr launches an
               aggregation, 8 an epoch and 4 for the evaluation), logits
               against the CPU within 1e-2;
   slice_closure_gcn, slice_closure_gat, slice_closure_rgcn — the JAX
               bench's closure rows: the GCN and the GAT on Cora, the
               RGCN on MUTAG-RDF, trained on the training nodes'
               two-layer closure (closure=True; 200 epochs, RGCN 50),
               captured and then eager, evaluated on the full graph:
               launches as CLOSURE_LAUNCHES (the full graph's counts), the
               full slices' gates, card logits against the CPU's (1e-4,
               full graph and closure), the closure's logits at the seeds
               against the full graph's within the JAX bench's bounds
               (GCN 1e-3, GAT and RGCN 1e-2), each layer's rows and edges;
   adam_compact — the captured MUTAG epoch with utils/optim.py's
               adam_compact (bf16 moments) and with
               torch.optim.Adam(capturable=True): seconds, the optimiser's
               own step (device µs), the moments' bytes, both loss curves
               (each finite and halved);
   slice_sgc, slice_agnn, slice_arma, slice_spline, slice_dna — the
               five models of examples/citation_suite.py on Cora (Spline
               with TargetIndegree), 200 epochs each, captured and then
               eager, through train_suite: the launches of
               SUITE_LAUNCHES (spmm_csr: SGC 2 at set-up, AGNN 802, ARMA
               1604, Spline 1204; sorted_segment_sum: AGNN 1602, DNA
               2404), the
               accuracy gate, and the trained logits on the card against
               the model's plain path on the CPU (1e-4);
   slice_ppi — examples/ppi.py's run (PPI: 20 synthetic train graphs
               of ~2300 nodes, 50 features, 121 labels; GAT 4 x 256,
               4 x 256 + skip, 6 x 121 mean + skip; Adam 5e-3) for 10
               epochs, captured (the default: the training step and the
               prediction each a CUDA graph over static buffers of its
               loader's budget), then eager on the same batches, every
               attention layer through the PackedFlashGat of its batch,
               built once on the host and kept on the card (captured:
               copied into the static operator): packed-GAT launches
               asserted in both runs as 10 epochs x (20 train batches x
               3 forward + 1 val batch x 3) = 630 and 10 x 20 x 6 =
               1200 backward (captured: step x replays + warm-up, by
               stage); every step's loss, the final parameters and the
               F1, captured against eager, bitwise; losses finite, the
               last epoch's mean below the first's; val micro-F1 beside
               the all-positive predictor's (not gated); each run's
               seconds and ms a step, the captures' seconds, the host ms
               a batch, operator build seconds, peak device memory; the
               logits after three steps from the same parameters and
               batches, card against the plain path on the CPU (1e-4);
   slice_faust — examples/faust.py's run (six SplineConv layers, dim 3,
               kernel size 5, 1 -> 32 -> 64 x 5, Dense 256, a class per
               vertex; Adam 1e-2) for 3 epochs at FAUST's published
               template size (6,728 synthetic vertices, 80 train and 20
               test meshes, batches of 1), each layer's accumulator
               through one rectangular spline operator of its mesh,
               built once on the host and kept on the card: captured
               (the default: the training step, dropout from the run's
               generator, and the evaluation each a CUDA graph over the
               static spline operator of the loader's budget, each
               batch's operator copied in device to device), then eager
               on fresh loaders of the same seed, bitwise equal (every
               step's loss, the final parameters, the accuracy):
               spmm_csr launches asserted as 3 x (80 x 11 + 20 x 6) =
               3000 in both runs, and by stage; losses finite, the last
               epoch's mean below the first's; test accuracy beside
               chance (not gated); ms a step in both, the host ms a
               batch, operator build seconds, both peaks of device
               memory; the logits after three steps (dropout off), card
               against the plain path on the CPU at 684 vertices
               (1e-4);
   slice_mutag_gin — examples/mutag_gin.py's run (five GINConv over
               MLPs 7 -> 32 -> 32 with MaskedBatchNorm, a trained eps,
               global_add_pool, Dense 32 and 2; Adam 0.01, batches of 32,
               30 epochs over the synthetic MUTAG of 188 graphs),
               captured (the default, as slice_ppi), then eager on the
               same batches, one operator set a batch built on the host
               (the GIN sums' SpmmOperator over the batch's real edges,
               the readout's SortedSegmentSum; captured: copied into the
               static operators through pinned memory): launches
               asserted in both runs as 30 x (6 train batches x (9
               spmm_csr + 1 segment sum) + 1 test batch x (5 + 1));
               captured against eager bitwise (every step's loss, the
               final parameters and running statistics, the accuracy);
               the loss falling; test accuracy beside the majority
               class's (not gated); each run's seconds and ms a step, the
               host ms a batch; the logits after three steps (SGD),
               card against the plain path on the CPU (1e-4);
   slice_topk, slice_diff_pool, slice_qm9, slice_autoencoder,
   slice_infomax — examples/enzymes_topk_pool.py (20 epochs),
               enzymes_diff_pool.py (8), qm9_nn_conv.py (5, 1000
               molecules), autoencoder.py (100, GAE then --variational)
               and infomax.py (50, hidden 512, the port's logistic-
               regression probe) at their defaults, each captured, then
               eager, bitwise equal (every step's or epoch's loss, the
               final parameters, the accuracy, MAE, AUC and AP or the
               probe's accuracy): the graph-level steps and evaluations
               each a CUDA graph over static buffers (TopK and QM9 over
               the batch's real entries, the host ms a batch split;
               DiffPool one a batch size), the full-batch epochs one
               graph replayed over spans (models/capture.py:EpochSpans);
               launches asserted in both runs (GRAPH_EXAMPLES,
               AUTOENCODER_LAUNCHES, INFOMAX_LAUNCHES; DiffPool none),
               the loss falling, the output after three steps card
               against the CPU (1e-4; TopK, the autoencoders and infomax
               after SGD steps, with their first step's gradients,
               _step_gate);
   slice_mnist_graclus — examples/mnist_graclus.py's run (SplineConv
               1 -> 32 -> 64, K = 25, two graclus max pools, mean
               readout; Adam 0.01, batches of 64, 3 epochs over 1500
               synthetic superpixel graphs), captured (the training
               step, dropout from its registered generator, and the
               evaluation each a CUDA graph over static buffers of the
               loaders' budgets), then eager, one operator set a batch
               built on the host over its real entries (both levels'
               spline operators, the pools' cluster_operator, level 2's
               readout) and copied in: launches asserted as 3 x (24 x
               (3 spmm_csr + 3 segment sums) + 4 x (2 + 3)) in both runs,
               and by stage; captured and eager bitwise equal (every
               step's loss, the final parameters, the accuracy); ms a
               step in both, the host ms a batch split into collation,
               level geometry, operator builds and copies; the loss
               falling; the logits after three steps card against the
               CPU (1e-4);
   slice_mnist_voxel_grid, slice_mnist_nn_conv, slice_pointnet2 — the
               other point and superpixel examples at their defaults (3
               epochs each), captured and eager as slice_mnist_graclus
               (pointnet2 over the static graph of its loader's budget,
               the last batch's missing clouds padding): launches
               asserted (POINT_EXAMPLES; pointnet2 one segment sum a
               step, its level-2 gather's gradient), the loss
               falling, the logits after three steps card against the
               CPU (1e-4);
   slice_reddit_sage — examples/reddit_sage.py's run on
               Reddit(full_scale=True) (SAGE 602 -> 128 -> 41, fan-out
               [10, 10], batches of 512, index-shipping batches over the
               tables on the card, one epoch of 20 batches and 10
               validation batches), each batch's sums through one
               EmbedSpmm over its real edges (each layer's input and its
               degrees, a column of ones), built on the host by the
               sampler: captured (the default: the training and the
               evaluation step each a CUDA graph over the static packed
               batch and neighbour-sum operator of the sampler's
               budgets, each batch copied in through pinned memory),
               then eager, bitwise equal (every step's loss, the final
               parameters, the accuracy): launches asserted as 20 x 5 +
               10 x 4 in both runs, and by stage; ms a step in both
               beside the host ms a batch (the sampling, the operator's
               build, the copies); the loss falling, validation accuracy
               beside chance, the logits after three steps card against
               the CPU (1e-4), the sampler's nodes a second, and the
               epoch device-only, sampled inline and pipelined (prefetch
               4);
   slice_driver — research/driver.py's training_net on Cora at the
               driver's defaults (PrunableGCN, 2 layers at the seeded
               contraction widths, 100 + 100 epochs, AdamW with the
               global-norm clip at 5, SVD pruning at ConCoeff 0.6, the
               Fiedler weight correction at epochs 70 and 90 of phase 2,
               checkpoints and curves in a temporary directory), its
               epoch captured and replayed over each span, then eager,
               bitwise equal (both phases' losses, accuracies and
               parameters), every aggregation through one spmm_csr
               operator of the graph: launches asserted in both as 200
               epochs x 6 + 4 evaluations x 3; printed: the widths before
               and after
               pruning, each phase's seconds and best validation accuracy,
               the SVD pruning's seconds, each correction's seconds,
               applied count and Fiedler backends (the torch power
               iteration on the card from 192 nodes); both phases' losses
               falling; the logits after three SGD epochs (dropout 0)
               and the first epoch's gradients, card against the plain
               path on the CPU (1e-4, _step_gate);
   slice_driver_gat — the same with --modelName GAT, 20 + 60 epochs (one
               correction, at epoch 50), every attention layer through
               one PackedFlashGat (its wide-head map: 8 heads of up to
               135 channels): packed-GAT launches asserted as 80 epochs x
               (3 forward + 6 backward) + 3 evaluations x 3 forward; its
               logits after three SGD epochs and its first epoch's
               gradients card against CPU within 1e-3;
   slice_driver_inductive — training_net_ppi (PrunableGCN on PPI) and
               training_net_graphcls (PrunableTopK on ENZYMES), 2 + 2
               epochs each, one operator set a distinct batch, each as a
               user runs it (the steps of both phases captured over one
               static pair of buffers, a capture a phase), then eager,
               bitwise equal (both phases' every step's loss, test
               curves and final parameters): launches asserted in both
               runs as DRIVER_INDUCTIVE_LAUNCHES per step and evaluation
               batch, and by stage; ms a step in both, the host ms a
               batch;
   zoo_prunable — each model of models/prunable.py (widths 64, 32; TopK
               on an ENZYMES batch), one forward and one backward through
               its operators on the card against its plain path on the
               CPU (1e-4), each launching a kernel that sums feature rows;
   fiedler   — the Fiedler pair of slice_driver's composed weight graph
               (2,726 nodes, padded to 4096): the torch power iteration
               on the card against the same code on the CPU (1e-4) and
               against numpy eigh (λ2, and the vector inside eigh's
               eigenspace), with the card's milliseconds;
   mygcn     — examples/mygcn.py: 40 epochs with a checkpoint on the
               best validation accuracy, captured (the epoch replayed 20
               times a span) and eager, bitwise equal, launches 40 x 4 +
               3 x 2 in both, then --resume to 60 in a temporary
               directory: the restored epoch counter, the spans after
               it, the extended loss history;
   slice_dp  — data parallelism over a one-rank NCCL group (the calling
               process): examples/data_parallel.py at its defaults
               (MUTAG, GraphClassifier hidden 32, 4 graphs a rank, Adam
               1e-2, 5 epochs), each shard through its operators and
               DataParallelTrainer's rank-order average; its first three
               steps bitwise equal to the same steps without the
               trainer; launches asserted as 235 steps x (4 spmm_csr + 1
               segment sum), an evaluation batch's 2 + 1; the loss
               falling; examples/mnist_data_parallel.py at its defaults
               (16 steps); the driver's data-parallel graph
               classification (ENZYMES TopK, 2 + 2 epochs);
   slice_partition — the edge-partitioned trainers over a one-rank NCCL
               group: examples/distributed_gcn.py at its defaults (30
               epochs, window 256, dense threshold 128) and the driver's
               training_net_partitioned on Cora with GCN and GAT (100
               epochs each): launches asserted from each partition's
               structure (the dense tables at set-up, the dense window
               sums, the sparse remainder and the remote edges a call;
               GAT 2 + 4 a step), the loss falling, the logits against
               the single-device model on the same weights (1e-2: bf16
               halo rows and operands; GAT 1e-5), ms a step, peak memory;
   partition_shards — P = 4 shards of synthetic Cora (dense blocks
               asserted) and RCM-PubMed in one process: each shard's send
               buffer, the exchange as the stacked buffers' transpose,
               the partitioned SpMM's combine, halo_gat (8 x 8) and
               halo_rgcn (Cora, 3 relations) on the card against one
               whole-graph spmm_csr, packed GAT and relation-major
               spmm_csr (2e-2 relative L2; 1e-5), each shard and the
               whole graph timed in CUDA graphs of 50 calls;
   tool_gat_sweep, tool_rgcn_sweep, tool_profile_epoch, tool_reddit —
               the tool scripts of pytorch_geometric_tpu_torch/tools/
               (gat_sweep, rgcn_sweep --epoch, profile_epoch, probe_reddit)
               in-process at their defaults, one point each (PubMed after
               RCM, 8 x 8 heads; MUTAG-RDF, 30 bases; the captured RGCN
               epoch under torch.profiler; 20 M community edges at
               F = 128): their records (each checks its operator against
               its plain version before timing) and their launches;
   zoo       — every conv of the zoo (Part B's and the suite's) on Cora
               at 1433 -> 16, one forward and one backward through its
               operators on the card against its plain path on the CPU:
               output, input gradient and parameter gradients within
               1e-4, and a kernel launched by each conv that sums
               feature rows; for the max aggregations (EdgeConv,
               PointConv) the gradients against the CPU's backward
               routed through the card's maxima, and the messages
               within 1e-4;
7. capture_check — for each of the seventeen configurations, five epochs
               captured and five eager from the same seeds: the logits
               and every parameter within 1e-6 of the largest magnitude;
8. trace, trace_gat, trace_gat_dense, trace_gat_bsr, trace_rgcn,
   trace_gcn_sorted, trace_gcn_fused, trace_gcn_dense, trace_gcn_hybrid,
   trace_sgc,
   trace_agnn, trace_arma, trace_spline, trace_dna — torch.profiler
               over 20 eager epochs of each configuration's training
               step: device time per kernel name, device busy and idle
               share, the port's kernel launches per epoch from the device
               events;
   trace_ppi — the same over 20 eager training steps of the PPI example
               cycling over its train batches (9 port launches a step),
               then over 20 replays of the step captured over its static
               batch, each after a batch is copied in ("captured": true);
   trace_faust — the same over 20 eager training steps of the FAUST
               example (11 port launches a step), then over 20 replays of
               the step captured over its static batch, each after a
               batch is copied in ("captured": true);
   trace_pointnet2 — the same, eager and captured, for pointnet2 (1
               port launch a step);
   trace_mutag_gin — the same over 20 eager training steps of the MUTAG
               example (10 port launches a step), with the host's
               operator-set build time a batch, then over 20 captured
               replays, as trace_ppi;
   trace_qm9 — the same over 20 eager training steps of the QM9
               example (18 port launches a step), then over 20 captured
               replays, as trace_ppi;
   trace_enzymes — the same over 10 steps for enzymes_topk_pool (8
               port launches a step) and enzymes_diff_pool (its full
               batches, captured through SizedStep; none);
   trace_spans — the same over 10 epochs, eager and captured, of the
               GAE, the VGAE, infomax, mygcn and the research driver's
               GCN and GAT after a one-epoch run of each
               (EpochSpans.again; SPAN_TRACES launches an epoch);
   trace_driver_inductive — the same over 10 steps, eager and captured,
               of the research driver's ENZYMES TopK (8 port launches a
               step) and PPI GCN (6) inductive steps;
   trace_mnist_graclus — the same over 20 eager training steps of the
               mnist_graclus example (6 port launches a step), then over
               20 captured replays, as trace_ppi;
   trace_reddit_sage — the same over 20 eager reddit_sage steps, the
               batches sampled by the pipelined loader as a user runs it
               (5 port launches a step), then over 20 replays of the step
               captured over the sampler's static buffers, each batch
               and its operator from the producer thread copied in; the
               closure configurations' traces come with the others
               (trace_closure_*);
9. trace_captured_* — the same over 20 replays of the epoch captured as
               the trainers capture it, one phase per configuration; the
               port's launches per epoch must equal the eager count.

Then a "kernels" JSON line (each kernel's launches summed over the
slice and tool phases that ran it, and by phase), and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line; so does a machine without CUDA, or a directory without the port.
``--phases a,b`` runs card, build and the named phases only, with no
kernels line: a quick check of a few phases.
"""

import argparse
import functools
import itertools
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from pytorch_geometric_tpu_torch.bounds import (
    bsr_gat_bound, flash_gat_bound, fused_gcn_bound, gat_bound, rgcn_bound,
    segment_sum_bound, spmm_bound)
from pytorch_geometric_tpu_torch.datasets.graphs import (
    bsr_synthetic_masks, cora_graph, flash_synthetic_masks, gat_hub_edges,
    mutag_graph, pubmed_graph, rgcn_hub_operator, spmm_hub_operator)
from pytorch_geometric_tpu_torch.profiling import (
    device_ms, profile_steps, trace_summary)

DEVICE = "cuda"
SEED = 0
EPOCHS = 200
#: examples/rgcn.py's default.
RGCN_EPOCHS = 50
TOL = {"fp32": 1e-5, "bf16": 1e-2}
#: Attention-dropout seed of the packed-GAT kernel cases.
GAT_SEED = 123457
#: examples/ppi.py: its default epochs, and the (heads, channels) of
#: conv1 and conv2, then conv3.
PPI_EPOCHS = 10
PPI_WIDTHS = ((4, 256), (6, 121))
#: Packed-GAT launches of one PPI training step (a forward launch per
#: layer; the backward's two walks per layer) and of one evaluation batch.
PPI_STEP_LAUNCHES = {"packed_gat_fwd": 3, "packed_gat_bwd": 6}
PPI_EVAL_LAUNCHES = {"packed_gat_fwd": 3}
#: examples/faust.py: its default epochs, FAUST's published template size
#: (the synthetic sphere then has 58 x 116 = 6,728 vertices), the spline
#: operator's widths (conv1's input, conv1's output, the rest), and the
#: spmm_csr launches of one training step (one forward a layer, one dx a
#: layer but conv1, whose input takes no gradient) and of one evaluation
#: batch.
FAUST_EPOCHS = 3
FAUST_VERTICES = 6890
FAUST_WIDTHS = (1, 32, 64)
FAUST_STEP_LAUNCHES = {"spmm_csr": 11}
FAUST_EVAL_LAUNCHES = {"spmm_csr": 6}
#: Receiver rows of the full-scale Reddit graph that the plain version
#: sums (all of them would gather ~28 GB at F = 602).
REDDIT_SLICE_ROWS = 20_000
#: examples/mutag_gin.py: its default epochs, and the launches of one
#: training step (5 GIN sums forward and 4 ``dx``, conv1's input taking
#: none; the readout's segment sum, whose backward is a gather) and of one
#: evaluation batch.
MUTAG_EPOCHS = 30
MUTAG_STEP_LAUNCHES = {"spmm_csr": 9, "sorted_segment_sum": 1}
MUTAG_EVAL_LAUNCHES = {"spmm_csr": 5, "sorted_segment_sum": 1}
#: The other graph-level examples at their default epochs, and the
#: launches of a training step and of an evaluation batch (or, for the
#: full-graph autoencoder and infomax, of an epoch and of their
#: evaluations): enzymes_topk_pool 3 GraphConv sums and 2 ``dx``, a
#: mean readout a level; qm9_nn_conv NNConv's three message sums and
#: Set2Set's two sums a step forward (9), then the backward sums of
#: Set2Set's two gathers a step (6) and of NNConv's three gathers of its
#: input by sender (3);
#: the GAE's two GCN layers forward and back (the VGAE three) and the
#: backward sums of its decoder's four gathers (the train positives' and
#: the negatives' two ends), its test every 20 epochs (the GCN layers
#: forward); infomax's encoder twice forward and back an epoch,
#: then once more for the embeddings; DiffPool none.
GRAPH_EXAMPLES = {
    "topk": ("enzymes_topk_pool", 20,
             {"spmm_csr": 5, "sorted_segment_sum": 3},
             {"spmm_csr": 3, "sorted_segment_sum": 3}),
    "diff_pool": ("enzymes_diff_pool", 8, {}, {}),
    "qm9": ("qm9_nn_conv", 5, {"sorted_segment_sum": 18},
            {"sorted_segment_sum": 9}),
}
#: Card-against-CPU tolerance of a graph-level example's output after
#: three steps (``slice_topk``, ``slice_diff_pool``, ``slice_qm9``).
GRAPH_PARITY_TOL = 1e-4
AUTOENCODER_EPOCHS = 100
AUTOENCODER_LAUNCHES = {                               # epoch, test
    False: ({"spmm_csr": 4, "sorted_segment_sum": 4}, {"spmm_csr": 2}),
    True: ({"spmm_csr": 6, "sorted_segment_sum": 4}, {"spmm_csr": 3})}
#: Card-against-CPU tolerance of the autoencoders' embeddings after three
#: steps (``slice_autoencoder``).
AUTOENCODER_PARITY_TOL = 1e-4
INFOMAX_EPOCHS = 50
INFOMAX_LAUNCHES = (4, 2)                              # epoch, embeddings


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "torch_name": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from pytorch_geometric_tpu_torch.kernels import _build

    from probes import (bsr_gat_designs, flash_gat_designs,
                        fused_gcn_designs, gat_ablate, packed_gat_designs,
                        packed_rgcn_designs, rgcn_ablate, segment_sum_designs,
                        spmm_csr_designs)

    probes = (gat_ablate, packed_gat_designs, rgcn_ablate, bsr_gat_designs,
              flash_gat_designs, packed_rgcn_designs, spmm_csr_designs,
              segment_sum_designs, fused_gcn_designs)
    import threading

    from pytorch_geometric_tpu_torch.cluster import _native

    t0 = time.perf_counter()
    # g++ builds the native host library while nvcc builds the kernels
    graphcore = {}
    thread = threading.Thread(
        target=lambda: graphcore.update(seconds=_native.build()))
    thread.start()
    report = _build.build(sources=[probe.SOURCE for probe in probes])
    thread.join()
    if "seconds" not in graphcore:
        _native.build()       # raises with the compiler's output
    _native.get_lib()
    for name in _build.SIGNATURES:
        _build.load_library(name)
    for probe in probes:
        probe.load()
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()},
          "graphcore_seconds": graphcore["seconds"],
          "graphcore_library": _native.library_path().name,
          "ptxas": ptxas})


@functools.cache
def faust_datasets(num_vertices=FAUST_VERTICES):
    """examples/faust.py's FAUST (train, test), through its pre-transform,
    built once per run, and the seconds that took."""
    from pytorch_geometric_tpu_torch.examples import faust

    t0 = time.perf_counter()
    train, test = faust.load(SEED, num_vertices, device=DEVICE)
    return train.dataset, test.dataset, time.perf_counter() - t0


def faust_loaders(num_vertices=FAUST_VERTICES):
    """Fresh loaders over :func:`faust_datasets`, as ``faust.load`` makes
    them: batches of one mesh, the train loader shuffled from SEED."""
    from pytorch_geometric_tpu_torch.data import DataLoader

    train, test, _ = faust_datasets(num_vertices)
    return (DataLoader(train, batch_size=1, shuffle=True, seed=SEED,
                       device=DEVICE),
            DataLoader(test, batch_size=1, device=DEVICE))


def phase_cluster():
    """The native host library (``cluster/native/graphcore.cpp``, built
    with g++ by the build phase) on this machine: on a synthetic ModelNet
    sample and a FAUST mesh at the published vertex count, ``knn_graph``,
    ``radius``, ``voxel_grid`` and ``coalesce_edges`` (the mesh's edges
    twice each, with their Cartesian offsets) bitwise equal to their plain
    numpy versions; ``fps`` gives k distinct points and
    ``graclus_cluster`` (over normalised-cut weights) a matching of
    clusters of one or two adjacent nodes, the invariants of the JAX
    package's tests/test_cluster.py (both draw from C++'s mt19937_64,
    their plain versions from numpy's generator). Host ms beside each."""
    from pytorch_geometric_tpu_torch import cluster
    from pytorch_geometric_tpu_torch.cluster import _native
    from pytorch_geometric_tpu_torch.datasets import ModelNet
    from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
    from pytorch_geometric_tpu_torch.transforms import FaceToEdge
    from pytorch_geometric_tpu_torch.transforms.coarsen_levels import (
        _normalized_cut_np)

    lib = _native.get_lib()
    mesh = faust_datasets()[0][1]          # a jittered mesh
    sample = FaceToEdge()(ModelNet(str(PLANETOID_ROOT), "10",
                                   samples_per_class=1)[3].clone())
    rows, problems = [], []
    for cloud, data, r, size in (("modelnet10", sample, 0.3, 0.25),
                                 ("faust", mesh, 0.1, 0.1)):
        pos = data.pos.astype(np.float64)
        s, t = data.edge_index
        attr = pos[t] - pos[s]
        twice = (np.concatenate([s, s]), np.concatenate([t, t]),
                 np.concatenate([attr, attr]))
        calls = {"knn_graph": ("knn_graph", (pos, 6), {}),
                 "radius": ("radius", (pos, pos, r),
                            {"max_num_neighbors": 16}),
                 "voxel_grid": ("voxel_grid", (pos, size), {}),
                 "coalesce_edges": ("coalesce_edges", twice, {})}
        cases = {}
        for case, (name, args, kw) in calls.items():
            t0 = time.perf_counter()
            got = getattr(cluster, name)(*args, **kw)
            t1 = time.perf_counter()
            want = getattr(cluster, name + "_plain")(*args, **kw)
            t2 = time.perf_counter()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            equal = all(a.dtype == b.dtype and np.array_equal(a, b)
                        for a, b in zip(got, want))
            cases[case] = {"bitwise_equal": equal,
                           "size": int(got[0].shape[0]),
                           "host_ms": (t1 - t0) * 1e3,
                           "plain_host_ms": (t2 - t1) * 1e3}
            if not equal:
                problems.append(f"{cloud}: {case} differs from its plain "
                                "version")
        k = int(np.ceil(0.05 * pos.shape[0]))
        picked = cluster.fps(pos, ratio=0.05, seed=SEED)
        fps_ok = picked.size == k == np.unique(picked).size
        w = _normalized_cut_np(s, t, pos, data.num_nodes)
        cl = cluster.graclus_cluster(s, t, w, num_nodes=data.num_nodes,
                                     seed=SEED)
        ids, sizes = np.unique(cl, return_counts=True)
        pair = np.flatnonzero(cl != np.arange(cl.size))   # matched, not rep
        adjacent = set(zip(s.tolist(), t.tolist()))
        graclus_ok = bool(sizes.max() <= 2 and (cl[ids] == ids).all()
                          and (cl <= np.arange(cl.size)).all()
                          and all((int(i), int(cl[i])) in adjacent
                                  or (int(cl[i]), int(i)) in adjacent
                                  for i in pair))
        if not (fps_ok and graclus_ok):
            problems.append(f"{cloud}: fps ok {fps_ok}, graclus ok "
                            f"{graclus_ok}")
        row = {"phase": "cluster", "cloud": cloud,
               "points": int(pos.shape[0]), "edges": int(s.size),
               "cases": cases, "fps_points": int(picked.size),
               "fps_ok": fps_ok, "graclus_clusters": int(ids.size),
               "graclus_pairs": int(pair.size), "graclus_ok": graclus_ok,
               "library": _native.library_path().name}
        emit(row)
        rows.append(row)
    assert lib is not None
    if problems:
        raise AssertionError("; ".join(problems))
    return rows


def _csr_pairs(graph=None):
    """The (CSR, weights in CSR order) pairs that the GCN's bound SpMM
    hands the kernel: forward (receiver-major) and backward (transposed),
    over the self-looped ``gcn_norm`` edge set without padding edges; or,
    with no graph, over the hub graph (``spmm_hub_operator``: a receiver
    of 500 senders, a sender of 400 receivers, random weights)."""
    from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator

    op, w = (gcn_spmm_operator(graph) if graph is not None
             else spmm_hub_operator(DEVICE, SEED))
    val_f, val_b = op.route_weights(w)
    return {"fwd": (op.fwd, val_f), "bwd": (op.bwd, val_b)}


def check_case(graph_name, csr, val, direction, f, dtype_name, gen,
               extra=None):
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr, spmm_csr_plain

    dt = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    x = torch.randn(csr.num_cols, f, generator=gen,
                    device=val.device).to(dt)
    got, again = spmm_csr(csr, val, x), spmm_csr(csr, val, x)
    want = spmm_csr_plain(csr, val, x)
    torch.cuda.synchronize()
    repeats = torch.equal(got, again)
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    kernel_ms = device_ms(lambda: spmm_csr(csr, val, x))
    plain_ms = device_ms(lambda: spmm_csr_plain(csr, val, x))
    # the yardstick: one library call on the same values (the port never
    # calls it); cuSPARSE wants one dtype, so bf16 x goes up to fp32 first
    a = torch.sparse_csr_tensor(csr.row_ptr, csr.col, val,
                                (csr.num_rows, csr.num_cols))
    x32 = x.float()
    lib_out = torch.sparse.mm(a, x32)
    lib_err = float((lib_out - want).abs().max())
    library_ms = device_ms(lambda: torch.sparse.mm(a, x32))
    bound_ms, bound_by = spmm_bound(csr, f, x.element_size())
    case = {"phase": "kernel", "kernel": "spmm_csr", "graph": graph_name,
            "direction": direction, "F": f, "x": dtype_name,
            "rows": csr.num_rows, "edges": csr.num_edges,
            "longest_row": int((csr.row_ptr[1:] - csr.row_ptr[:-1]).max()),
            "max_abs_err": abs_err, "rel_err": rel_err,
            "tol": TOL[dtype_name], "bitwise_repeat": repeats,
            "ok": rel_err <= TOL[dtype_name] and repeats,
            "library_max_abs_err": lib_err,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, **(extra or {})}
    emit(case)
    return case


def _max_rel_err(got, want):
    """(largest absolute error, largest error relative to the largest
    reference magnitude) over matching tensors."""
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel_err = max(float((a - b).abs().max())
                  / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(got, want))
    return abs_err, rel_err


def gat_stress_s(n, H, gen, frac=0.05):
    """``s`` (n, H) for the packed GAT's shift stress case: N(0, 1), and a
    random ``frac`` of the nodes lifted by 100-150, so that every receiver
    without a lifted sender has all its incoming logits 100-150 below the
    global max of s, where the JAX operator's one shift a head underflows
    (an output of 0) and the per-receiver shift must not."""
    s = torch.randn(n, H, generator=gen, device=DEVICE)
    lifted = torch.rand(n, generator=gen, device=DEVICE) < frac
    lift = 100 + 50 * torch.rand(n, H, generator=gen, device=DEVICE)
    return torch.where(lifted[:, None], s + lift, s)


def check_gat_case(graph_name, op, H, C, rate, gen, s=None):
    """The packed-GAT forward (num‖den and the shift's m) and backward
    kernels against their plain versions on random node inputs (``s``
    given for the stress case) at one (H, C) and dropout rate, the plain
    versions at ``receiver_max``'s m: one line per kernel. A second launch
    must repeat the first bit for bit. The forward's line also counts the
    rows with edges whose den the kernel leaves below 1 (none may: each
    has its largest logit at exp(0)) and those whose den the JAX
    operator's global shift underflows (``rows_global_shift_underflow``,
    the plain forward at m = max(s) in every row)."""
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg

    n = op.n
    d = torch.randn(n, H, generator=gen, device=DEVICE)
    if s is None:
        s = torch.randn(n, H, generator=gen, device=DEVICE)
    h = torch.randn(n, H * C, generator=gen, device=DEVICE)
    g = torch.randn(n, H * C + H, generator=gen, device=DEVICE)
    m = pg.receiver_max(op.fwd, s)
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device=DEVICE)
    fwd_args = (op.fwd, d, s, h, seed, rate)
    fwd_plain_args = (op.fwd, d, s, h, m, seed, rate)
    # the kernel also walks the sender-major CSR; the plain version needs
    # only the receiver-major one
    bwd_args = (op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed, g, rate)
    bwd_plain_args = (op.fwd, d, s, h, m, seed, g, rate)
    rows = op.fwd.row_ptr[1:] - op.fwd.row_ptr[:-1]
    cases = []
    for name, kernel, plain, args, plain_args, backward in (
            ("packed_gat_fwd", pg.packed_gat_fwd, pg.packed_gat_fwd_plain,
             fwd_args, fwd_plain_args, False),
            ("packed_gat_bwd", pg.packed_gat_bwd, pg.packed_gat_bwd_plain,
             bwd_args, bwd_plain_args, True)):
        got, again = kernel(*args), kernel(*args)
        want = plain(*plain_args)
        torch.cuda.synchronize()
        if not backward:
            want = (want, m)
        abs_err, rel_err = _max_rel_err(got, want)
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        bound_ms, bound_by = gat_bound(op, H, C, backward)
        case = {"phase": "kernel", "kernel": name, "graph": graph_name,
                "H": H, "C": C, "rate": rate, "rows": n, "edges": op.E,
                "longest_row": int(rows.max()),
                "launches_per_call": 2 if backward else 1,
                "max_abs_err": abs_err, "rel_err": rel_err,
                "tol": TOL["fp32"], "bitwise_repeat": repeats,
                "ok": rel_err <= TOL["fp32"] and repeats,
                "kernel_ms": device_ms(lambda: kernel(*args)),
                "plain_ms": device_ms(lambda: plain(*plain_args)),
                # no single PyTorch call computes a GAT layer
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}
        if not backward:
            den = got[0][:, H * C:][rows > 0]
            old = pg.packed_gat_fwd_plain(
                op.fwd, d, s, h, s.amax(0).expand(n, H).contiguous(), seed,
                rate)[:, H * C:][rows > 0]
            case["rows_den_below_1"] = int(
                (den < 1).any(dim=1).sum())
            case["rows_global_shift_underflow"] = int(
                (old < 1e-16).any(dim=1).sum())
            case["ok"] = case["ok"] and case["rows_den_below_1"] == 0
        emit(case)
        cases.append(case)
    return cases


def check_flash_case(graph_name, adj, op, H, C, rate, gen, calls=50):
    """The flash-GAT forward and backward kernels against their plain
    versions on random node inputs at one (H, C) and dropout rate, over
    ``op``'s packed mask and the same mask dense (``adj``): one line per
    kernel. The backward takes the plain forward's out and lse. A second
    launch must repeat the first bit for bit."""
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    n = op.n
    valid = int(adj.sum())
    d, s = (torch.randn(n, H, generator=gen, device=DEVICE)
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device=DEVICE)
            for _ in range(2))
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device=DEVICE)
    out, lse = fg.flash_gat_fwd_plain(adj, d, s, h, seed, rate)
    cases = []
    for name, kernel, plain, args, backward in (
            ("flash_gat_fwd", fg.flash_gat_fwd, fg.flash_gat_fwd_plain,
             (d, s, h, seed, rate), False),
            ("flash_gat_bwd", fg.flash_gat_bwd, fg.flash_gat_bwd_plain,
             (d, s, h, lse, out, g, seed, rate), True)):
        got, again = kernel(op.mask, *args), kernel(op.mask, *args)
        want = plain(adj, *args)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_rel_err(got, want)
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        bound_ms, bound_by = flash_gat_bound(n, valid, H, C, backward)
        case = {"phase": "kernel", "kernel": name, "graph": graph_name,
                "H": H, "C": C, "rate": rate, "rows": n,
                "valid_entries": valid, "density": valid / (n * n),
                "launches_per_call": 2 if backward else 1,
                "max_abs_err": abs_err, "rel_err": rel_err,
                "tol": TOL["fp32"], "bitwise_repeat": repeats,
                "ok": rel_err <= TOL["fp32"] and repeats,
                "timed_calls": calls,
                "kernel_ms": device_ms(lambda: kernel(op.mask, *args),
                                       calls),
                "plain_ms": device_ms(lambda: plain(adj, *args), calls),
                # no single PyTorch call computes masked rank-1-logit
                # attention with this dropout
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit(case)
        cases.append(case)
    return cases


def _flash_masks(cora):
    """(name, dense mask, (H, C) pairs, rates, timed calls) of the
    flash-GAT cases: Cora's mask, and the two masks of
    ``datasets/graphs.py:flash_synthetic_masks`` (half full at 2048 nodes
    with empty rows and columns; the operator's cap, 8192 nodes at
    PubMed's degree)."""
    from pytorch_geometric_tpu_torch.nn.conv import gat_dense_adj

    (half_name, half), (cap_name, cap) = flash_synthetic_masks(SEED)
    return (("cora", gat_dense_adj(cora), ((8, 8), (1, 7)), (0.0, 0.6), 50),
            (half_name, torch.from_numpy(half).to(DEVICE), ((8, 8),),
             (0.0, 0.6), 50),
            (cap_name, torch.from_numpy(cap).to(DEVICE), ((8, 8),),
             (0.6,), 5))


def check_bsr_case(graph_name, op, H, C, rate, gen, calls=50,
                   flash_mask=None):
    """The three block-sparse GAT kernels against their plain versions on
    random node inputs at one (H, C) and dropout rate, over ``op``'s
    block mask: one line per kernel. The backward passes take the plain
    forward's out and lse, the column pass the plain row pass's D. A
    second launch must repeat the first bit for bit. With ``flash_mask``
    (the same mask as a ``BitMask``) each kernel's outputs are also held
    to the flash-GAT kernels' (1e-6)."""
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg
    from pytorch_geometric_tpu_torch.ops import flash_gat as fg

    mask, n = op.mask, op.n
    d, s = (torch.randn(n, H, generator=gen, device=DEVICE)
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device=DEVICE)
            for _ in range(2))
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device=DEVICE)
    out, lse = bg.bsr_gat_fwd_plain(mask, d, s, h, seed, rate)
    _, big_d = bg.bsr_gat_bwd_row_plain(mask, d, s, h, lse, out, g, seed,
                                        rate)
    dense = {}
    if flash_mask is not None:
        dd, ds, dh = fg.flash_gat_bwd(flash_mask, d, s, h, lse, out, g, seed,
                                      rate)
        # the dense-mask row pass keeps its D to itself: compare dd alone
        dense = {"bsr_gat_fwd": fg.flash_gat_fwd(flash_mask, d, s, h, seed,
                                                 rate),
                 "bsr_gat_bwd_row": (dd,), "bsr_gat_bwd_col": (ds, dh)}
    strips = mask.row.strip_ptr[1:] - mask.row.strip_ptr[:-1]
    cases = []
    for name, kernel, plain, args in (
            ("bsr_gat_fwd", bg.bsr_gat_fwd, bg.bsr_gat_fwd_plain,
             (d, s, h, seed, rate)),
            ("bsr_gat_bwd_row", bg.bsr_gat_bwd_row, bg.bsr_gat_bwd_row_plain,
             (d, s, h, lse, out, g, seed, rate)),
            ("bsr_gat_bwd_col", bg.bsr_gat_bwd_col, bg.bsr_gat_bwd_col_plain,
             (d, s, h, lse, big_d, g, seed, rate))):
        got, again = kernel(mask, *args), kernel(mask, *args)
        want = plain(mask, *args)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_rel_err(got, want)
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        dense_err = _max_rel_err(got, dense[name])[1] if dense else None
        bound_ms, bound_by = bsr_gat_bound(n, mask.num_entries, H, C,
                                           name[len("bsr_gat_"):])
        case = {"phase": "kernel", "kernel": name, "graph": graph_name,
                "H": H, "C": C, "rate": rate, "rows": n,
                "valid_entries": mask.num_entries,
                "tile": [mask.ti, mask.tj], "blocks": mask.num_blocks,
                "block_density": mask.density,
                "longest_strip_blocks": int(strips.max()),
                "launches_per_call": 1,
                "max_abs_err": abs_err, "rel_err": rel_err,
                "tol": TOL["fp32"], "bitwise_repeat": repeats,
                "rel_err_vs_flash_gat_kernel": dense_err,
                "ok": rel_err <= TOL["fp32"] and repeats and (
                    dense_err is None or dense_err <= 1e-6),
                "timed_calls": calls,
                "kernel_ms": device_ms(lambda: kernel(mask, *args), calls),
                "plain_ms": device_ms(lambda: plain(mask, *args), calls),
                # no single PyTorch call computes masked rank-1-logit
                # attention with this dropout
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit(case)
        cases.append(case)
    return cases


#: Tile shapes (tile_i, tile_j) of the sweep behind the operator's
#: default tile.
BSR_TILES = ((1, 32), (2, 32), (4, 32), (8, 32), (16, 32), (32, 32), (4, 64),
             (8, 64), (16, 64), (64, 64), (128, 128))


def bsr_tile_sweep(graph_name, senders, receivers, n, gen):
    """Device time of the three block-sparse kernels at (H, C) = (8, 8),
    dropout 0.6, for each tile of ``BSR_TILES`` on one edge set, and the
    host seconds to build the mask: what the operator's default tile was
    chosen from."""
    from pytorch_geometric_tpu_torch.ops import bsr_gat as bg

    H, C, rate = 8, 8, 0.6
    d, s = (torch.randn(n, H, generator=gen, device=DEVICE)
            for _ in range(2))
    h, g = (torch.randn(n, H * C, generator=gen, device=DEVICE)
            for _ in range(2))
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device=DEVICE)
    tiles = []
    for ti, tj in BSR_TILES:
        t0 = time.perf_counter()
        mask = bg.BsrFlashGat.from_edges(senders, receivers, n, tile_i=ti,
                                         tile_j=tj, device=DEVICE).mask
        build_s = time.perf_counter() - t0
        out, lse = bg.bsr_gat_fwd(mask, d, s, h, seed, rate)
        _, big_d = bg.bsr_gat_bwd_row(mask, d, s, h, lse, out, g, seed, rate)
        tiles.append({
            "tile": [ti, tj], "blocks": mask.num_blocks,
            "mask_bytes": sum(t.numel() * 4 for t in mask.tensors()),
            "host_build_seconds": build_s,
            "fwd_ms": device_ms(lambda: bg.bsr_gat_fwd(
                mask, d, s, h, seed, rate)),
            "bwd_row_ms": device_ms(lambda: bg.bsr_gat_bwd_row(
                mask, d, s, h, lse, out, g, seed, rate)),
            "bwd_col_ms": device_ms(lambda: bg.bsr_gat_bwd_col(
                mask, d, s, h, lse, big_d, g, seed, rate))})
    result = {"phase": "kernel_sweep", "kernel": "bsr_gat",
              "graph": graph_name, "H": H, "C": C, "rate": rate, "rows": n,
              "default_tile": list(bg.DEFAULT_TILE), "tiles": tiles}
    emit(result)
    return result


def phase_kernel_bsr(cora, gen):
    """The block-sparse GAT cases of the kernel phase, and the tile
    sweep at PubMed."""
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.nn.conv import (
        gat_dense_adj, gat_edge_set)
    from pytorch_geometric_tpu_torch.ops.bsr_gat import BsrFlashGat
    from pytorch_geometric_tpu_torch.ops.flash_gat import BitMask
    from pytorch_geometric_tpu_torch.utils.reorder import window_density

    cases = []
    op = gat_flash_op(cora, "bsr")
    flash_mask = BitMask(gat_dense_adj(cora))
    for H, C in ((8, 8), (1, 7)):
        for rate in (0.0, 0.6):
            cases += check_bsr_case("cora", op, H, C, rate, gen,
                                    flash_mask=flash_mask)
    # PubMed as the slice runs it, and what the reordering did to it
    edges = {}
    for name, reorder in (("pubmed", False), ("pubmed_rcm", True)):
        _, graph, rcm_seconds = pubmed_graph(DEVICE, reorder)
        edges[name] = (*gat_edge_set(graph), graph.num_nodes)
        op = gat_flash_op(graph, "bsr")
        emit({"phase": "kernel", "kernel": "bsr_gat", "graph": name,
              "rows": op.n, "valid_entries": op.mask.num_entries,
              "tile": [op.ti, op.tj], "num_blocks": op.num_blocks,
              "density": op.density, "rcm_seconds": rcm_seconds,
              "window_density_512": window_density(*edges[name], 512),
              "window_density_32": window_density(*edges[name], 32)})
    for H, C in ((8, 8), (1, 3)):
        for rate in (0.0, 0.6):
            cases += check_bsr_case("pubmed_rcm", op, H, C, rate, gen)
    bsr_tile_sweep("pubmed_rcm", *edges["pubmed_rcm"], gen)
    for name, senders, receivers, n, heads, calls in bsr_synthetic_masks(
            SEED):
        op = BsrFlashGat.from_edges(senders, receivers, n, device=DEVICE)
        for H, C in heads:
            for rate in (0.0, 0.6):
                cases += check_bsr_case(name, op, H, C, rate, gen, calls)
    return cases


def check_sorted_case(graph_name, csr, direction, f, dtype_name, gen):
    """The sorted segment-sum kernel against its plain version on random
    messages over one GCN CSR; ``torch.segment_reduce`` is the library
    call (bf16 messages go up to fp32 first, as for cuSPARSE). A second
    launch must repeat the first bit for bit."""
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import (
        sorted_segment_sum, sorted_segment_sum_plain)

    dt = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    msgs = torch.randn(csr.num_edges, f, generator=gen,
                       device=DEVICE).to(dt)
    rp = csr.row_ptr
    got, again = sorted_segment_sum(rp, msgs), sorted_segment_sum(rp, msgs)
    want = sorted_segment_sum_plain(rp, msgs)
    torch.cuda.synchronize()
    abs_err, rel_err = _max_rel_err((got,), (want,))
    repeats = torch.equal(got, again)
    offsets, lib_in = rp.long(), msgs.float()
    lib_err = float((torch.segment_reduce(lib_in, "sum", offsets=offsets)
                     - want).abs().max())
    bound_ms, bound_by = segment_sum_bound(csr.num_rows, csr.num_edges, f,
                                           msgs.element_size())
    case = {"phase": "kernel", "kernel": "sorted_segment_sum",
            "graph": graph_name, "direction": direction, "F": f,
            "msgs": dtype_name, "rows": csr.num_rows,
            "edges": csr.num_edges,
            "longest_row": int((rp[1:] - rp[:-1]).max()),
            "max_abs_err": abs_err, "rel_err": rel_err,
            "tol": TOL[dtype_name], "bitwise_repeat": repeats,
            "ok": rel_err <= TOL[dtype_name] and repeats,
            "library_max_abs_err": lib_err,
            "kernel_ms": device_ms(lambda: sorted_segment_sum(rp, msgs)),
            "plain_ms": device_ms(lambda: sorted_segment_sum_plain(rp, msgs)),
            "library_ms": device_ms(lambda: torch.segment_reduce(
                lib_in, "sum", offsets=offsets)),
            "bound_ms": bound_ms, "bound_by": bound_by}
    emit(case)
    return case


def check_real_vs_padded(graph_name, op, f, gen):
    """The segment sum of ``op``, a batch's operator over its real
    entries, and in the same call of the operator over every entry slot
    of its receivers (``<graph_name>_padded``, the padding row's entries
    included), each timed by :func:`check_sorted_case` at F = ``f``;
    then both on the same messages in entry order, those of the entries
    left out 0 (as the masked sums hand them): the two outputs must be
    bitwise equal on every row."""
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSegmentSum

    padded = SortedSegmentSum(op.receivers.cpu(), op.num_nodes,
                              device=DEVICE)
    cases = [check_sorted_case(graph_name, op.csr, "fwd", f, "fp32", gen),
             check_sorted_case(f"{graph_name}_padded", padded.csr, "fwd", f,
                               "fp32", gen)]
    entries = op.receivers.shape[0]
    kept = torch.zeros(entries, dtype=torch.bool, device=DEVICE)
    kept[op.csr.perm] = True
    msgs = torch.randn(entries, f, generator=gen, device=DEVICE)
    msgs = torch.where(kept[:, None], msgs, 0.0)
    same = bool(torch.equal(op._sum(msgs), padded._sum(msgs)))
    emit({"phase": "kernel", "kernel": "sorted_segment_sum",
          "graph": graph_name, "F": f, "entries": op.csr.num_edges,
          "slots": padded.csr.num_edges,
          "real_entries_bitwise_the_padded_operator": same})
    if not same:
        raise AssertionError(f"{graph_name}: the segment sum over the real "
                             "entries differs from the padded one")
    return cases


def compare_sorted_with_spmm(graph_name, sop, weights, csr, direction, f,
                             gen):
    """The whole ``SortedSpmm`` call (gather and weight the messages in
    CSR order, write them, sum them with the kernel) against
    ``spmm_csr``, which gathers inside its kernel, on the same CSR, fp32:
    which is faster, and do they agree (1e-5)."""
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr

    x = torch.randn(csr.num_cols, f, generator=gen, device=DEVICE)
    val = weights[csr.perm].contiguous()
    a, b = sop._run(csr, weights, x), spmm_csr(csr, val, x)
    torch.cuda.synchronize()
    rel_err = _max_rel_err((a,), (b,))[1]
    line = {"phase": "kernel_compare", "kernel": "sorted_spmm_call",
            "graph": graph_name, "direction": direction, "F": f,
            "edges": csr.num_edges,
            "messages_bytes": csr.num_edges * f * 4,
            "sorted_spmm_ms": device_ms(lambda: sop._run(csr, weights, x)),
            "spmm_csr_ms": device_ms(lambda: spmm_csr(csr, val, x)),
            "rel_err": rel_err, "ok": rel_err <= TOL["fp32"]}
    line["sorted_faster"] = line["sorted_spmm_ms"] < line["spmm_csr_ms"]
    emit(line)
    return line


def _unfused_gcn_fwd(fwd, val, z1, W2, b1, rate):
    """The forward of ``fused_gcn_fwd`` as the packed backend runs it:
    two ``spmm_csr`` launches around torch's bias, relu, dropout (random
    numbers from the default generator, so the chain captures in a CUDA
    graph) and ``@ W2``."""
    from pytorch_geometric_tpu_torch.models.citation import dropout
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr

    h1_pre = spmm_csr(fwd, val, z1)
    h = dropout(torch.relu(h1_pre + b1), rate, True)
    return h1_pre, spmm_csr(fwd, val, h @ W2)


def _unfused_gcn_bwd(bwd, val, g2, W2, b1, h1_pre, keep, rate):
    """The matching backward: ``spmm_csr`` over the transposed CSR, the
    products with W2, the saved dropout mask and relu's test, and
    ``spmm_csr`` again."""
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr

    gA2 = spmm_csr(bwd, val, g2)
    act = keep & (h1_pre + b1 > 0)
    dh1 = torch.where(act, (gA2 @ W2.t()) / (1.0 - rate), 0.0)
    return gA2, spmm_csr(bwd, val, dh1)


def check_fused_case(graph_name, fused, H, C, rate, gen):
    """The fused two-layer GCN forward and backward kernels against their
    plain versions on random inputs at one (H, C) and dropout rate, over
    ``fused``'s CSRs: one line per kernel, with the time of the unfused
    chain that computes the same (no single PyTorch call does). The
    backward takes the plain forward's h1_pre. A second launch must
    repeat the first bit for bit."""
    from pytorch_geometric_tpu_torch.ops import fused_gcn as fg

    n = fused.N
    z1 = torch.randn(n, H, generator=gen, device=DEVICE)
    g2 = torch.randn(n, C, generator=gen, device=DEVICE)
    W2 = torch.randn(H, C, generator=gen, device=DEVICE) * 0.5
    b1 = torch.randn(H, generator=gen, device=DEVICE) * 0.1
    seed = torch.tensor([GAT_SEED], dtype=torch.int32, device=DEVICE)
    fwd, bwd = fused.op.fwd, fused.op.bwd
    fwd_args = (fwd, fused.val_f, z1, W2, b1, seed, rate)
    h1_pre, _ = fg.fused_gcn_fwd_plain(*fwd_args)
    bwd_args = (bwd, fused.val_b, g2, W2, b1, h1_pre, seed, rate)
    keep = fg.keep_mask(seed, H, n, rate)
    chains = {
        "fused_gcn_fwd": lambda: _unfused_gcn_fwd(fwd, fused.val_f, z1, W2,
                                                  b1, rate),
        "fused_gcn_bwd": lambda: _unfused_gcn_bwd(bwd, fused.val_b, g2, W2,
                                                  b1, h1_pre, keep, rate)}
    cases = []
    for name, kernel, plain, args, backward in (
            ("fused_gcn_fwd", fg.fused_gcn_fwd, fg.fused_gcn_fwd_plain,
             fwd_args, False),
            ("fused_gcn_bwd", fg.fused_gcn_bwd, fg.fused_gcn_bwd_plain,
             bwd_args, True)):
        got, again = kernel(*args), kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_rel_err(got, want)
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        bound_ms, bound_by = fused_gcn_bound(n, fwd.num_edges, H, C,
                                             backward)
        case = {"phase": "kernel", "kernel": name, "graph": graph_name,
                "H": H, "C": C, "rate": rate, "rows": n,
                "edges": fwd.num_edges, "launches_per_call": 2,
                "max_abs_err": abs_err, "rel_err": rel_err,
                "tol": TOL["fp32"], "bitwise_repeat": repeats,
                "ok": rel_err <= TOL["fp32"] and repeats,
                "kernel_ms": device_ms(lambda: kernel(*args)),
                "plain_ms": device_ms(lambda: plain(*args)),
                "unfused_chain_ms": device_ms(chains[name]),
                # no single PyTorch call computes a two-layer GCN pass
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit(case)
        cases.append(case)
    return cases


def phase_kernel_gcn(cora, gen):
    """The sorted segment-sum and fused GCN cases of the kernel phase, at
    the GCN edge sets of Cora and of PubMed after RCM reordering (what
    the slices run)."""
    from pytorch_geometric_tpu_torch.models.citation import gcn_edge_set
    from pytorch_geometric_tpu_torch.ops.fused_gcn import FusedGcn2
    from pytorch_geometric_tpu_torch.ops.sorted_spmm import SortedSpmm

    _, pubmed, _ = pubmed_graph(DEVICE)
    cases = []
    for graph_name, graph, classes in (("cora", cora, 7),
                                       ("pubmed_rcm", pubmed, 3)):
        s, r, w = gcn_edge_set(graph)
        n = graph.num_nodes
        sop = SortedSpmm(s, r, n, device=DEVICE)
        for direction, csr in (("fwd", sop.fwd), ("bwd", sop.bwd)):
            for f in (16, classes):
                for dtype_name in ("fp32", "bf16"):
                    cases.append(check_sorted_case(graph_name, csr,
                                                   direction, f, dtype_name,
                                                   gen))
                cases.append(compare_sorted_with_spmm(
                    graph_name, sop, w, csr, direction, f, gen))
        fused = FusedGcn2(s, r, n, w, hidden=16, classes=classes,
                          device=DEVICE)
        for rate in (0.0, 0.5):
            cases += check_fused_case(graph_name, fused, 16, classes, rate,
                                      gen)
    return cases


def phase_kernel_suite(gen):
    """The citation suite's new shapes: ``spmm_csr`` at F = 1433 (SGC's
    propagation of Cora's features; Spline's conv1), 300 and 33 (the
    chunk map's other widths) on the Cora GCN CSR, at 1433 on Spline's
    two kernel-index CSRs (and at conv2's 16, both directions), and at
    ARMA's widths (3 stacks x 16 = 48, x 7 = 21) on L̂'s CSR, both
    directions; the segment sum at AGNN's shapes (its edge set by
    receiver at 1 and 16 channels, by sender at 16) and DNA's (its GCN
    edge set: F = 128 by receiver, its four layers' key-value gradients,
    1 to 4 x 256, by sender); fp32."""
    from pytorch_geometric_tpu_torch.nn.conv import (
        agnn_operators, arma_edge_set, dna_operators, spline_edge_sets)
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator

    _, cora, _ = load("cora")
    _, spline, _ = load("cora_spline")
    n = cora.num_node_features
    cases = []
    csr, val = _csr_pairs(cora)["fwd"]
    for f in (n, 300, 33):
        cases.append(check_case("cora", csr, val, "fwd", f, "fp32", gen))
    for k, (s, r, b) in enumerate(spline_edge_sets(spline, 1, 2)):
        op = SpmmOperator(s, r, spline.num_nodes, device=DEVICE)
        val_f, val_b = op.route_weights(b)
        for direction, csr, val, f in (("fwd", op.fwd, val_f, n),
                                       ("fwd", op.fwd, val_f, 16),
                                       ("bwd", op.bwd, val_b, 16)):
            cases.append(check_case(f"cora_spline_k{k}", csr, val,
                                    direction, f, "fp32", gen))
    s, r, w = arma_edge_set(cora)
    op = SpmmOperator(s, r, cora.num_nodes, device=DEVICE)
    for direction, csr, val in zip(("fwd", "bwd"), (op.fwd, op.bwd),
                                   op.route_weights(w)):
        for f in (48, 21):     # 3 stacks x 16, x 7
            cases.append(check_case("cora_arma", csr, val, direction, f,
                                    "fp32", gen))
    # AGNN's softmax sums (one channel) and its cosine gathers' gradients
    # (16), by receiver and by sender
    ops = agnn_operators(cora)
    for direction, op, f in (("fwd", ops["recv_op"], 1),
                             ("fwd", ops["recv_op"], 16),
                             ("bwd", ops["send_op"], 16)):
        cases.append(check_sorted_case("cora_agnn", op.csr, direction, f,
                                       "fp32", gen))
    ops = dna_operators(cora)
    cases.append(check_sorted_case("cora_dna", ops["segment_op"].csr, "fwd",
                                   128, "fp32", gen))
    # the layers' key-value gradients: a history of 1 to 4 x 256 channels
    for f in (256, 512, 768, 1024):
        cases.append(check_sorted_case("cora_dna", ops["sender_op"].csr,
                                       "bwd", f, "fp32", gen))
    return cases


def check_rgcn_case(graph_name, op, B, C, gen):
    """The packed-RGCN forward and backward kernels against their plain
    versions on random inputs at one (B, C): one line per kernel."""
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr

    xB = torch.randn(op.num_src_rows, B * C, generator=gen, device=DEVICE)
    att = torch.randn(op.R, B, generator=gen, device=DEVICE)
    g = torch.randn(op.num_nodes, C, generator=gen, device=DEVICE)
    # the forward kernels walk the sender-major CSR and sum over the
    # receiver-major one; its plain version needs only the latter
    fwd_args = (op.fwd, op.send, xB, att)
    fwd_plain_args = (op.fwd, op.fwd_et, op.fwd_w, xB, att)
    # the kernels also take the relation-major positions; the plain
    # version needs only the sender-major CSR
    bwd_args = (op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos, op.rel_ptr, xB,
                att, g)
    bwd_plain_args = (op.bwd, op.bwd_et, op.bwd_w, xB, att, g)
    cases = []
    for name, kernel, plain, args, plain_args, csr, backward in (
            ("packed_rgcn_fwd", pr.packed_rgcn_fwd,
             pr.packed_rgcn_fwd_plain, fwd_args, fwd_plain_args, op.fwd,
             False),
            ("packed_rgcn_bwd", pr.packed_rgcn_bwd,
             pr.packed_rgcn_bwd_plain, bwd_args, bwd_plain_args, op.bwd,
             True)):
        got, again, want = kernel(*args), kernel(*args), plain(*plain_args)
        torch.cuda.synchronize()
        if not backward:
            got, again, want = (got,), (again,), (want,)
        abs_err, rel_err = _max_rel_err(got, want)
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        bound_ms, bound_by = rgcn_bound(op, B, C, backward)
        case = {"phase": "kernel", "kernel": name, "graph": graph_name,
                "B": B, "C": C, "R": op.R, "rows": csr.num_rows,
                "src_rows": op.num_src_rows, "edges": op.E,
                "longest_row": int((csr.row_ptr[1:]
                                    - csr.row_ptr[:-1]).max()),
                "launches_per_call": 3 if backward else 2,
                # written and read back, beside the bound: dae (E, B)
                # backward, the messages (E, C) forward
                "scratch_bytes": 2 * op.E * (B if backward else C) * 4,
                "max_abs_err": abs_err, "rel_err": rel_err,
                "tol": TOL["fp32"], "bitwise_repeat": repeats,
                "ok": rel_err <= TOL["fp32"] and repeats,
                "kernel_ms": device_ms(lambda: kernel(*args)),
                "plain_ms": device_ms(lambda: plain(*plain_args)),
                # no single PyTorch call computes the basis-decomposed
                # relational aggregation or its backward
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit(case)
        cases.append(case)
    return cases


#: The driver's Cora shapes (slice_driver, slice_driver_gat): the GCN's
#: widths 1084 and 819 on its SpMM (after pruning 1083 and 818, the same
#: chunk map), and the GAT's three layers over its remove-then-add edge
#: set, 8 heads of 135 and of 102 channels (the wide-head map) with
#: attention dropout 0.6, and the output head (1, 7) without.
DRIVER_SPMM_WIDTHS = (1084, 819)
DRIVER_GAT_SHAPES = ((8, 135, 0.6), (8, 102, 0.6), (1, 7, 0.0))


def phase_kernel_driver(gen):
    """``spmm_csr`` and the packed-GAT kernels at the research driver's
    shapes on Cora (``DRIVER_SPMM_WIDTHS`` both directions, fp32;
    ``DRIVER_GAT_SHAPES`` over ``gat_sparse_edge_set``, the operator
    ``PrunableGAT.operators`` builds) against their plain versions (fp32
    1e-5, two launches bitwise equal), with cuSPARSE where it applies and
    the bound."""
    from pytorch_geometric_tpu_torch.nn.conv import gat_sparse_edge_set
    from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat

    _, cora = cora_graph(DEVICE)
    cases = []
    for direction, (csr, val) in _csr_pairs(cora).items():
        for f in DRIVER_SPMM_WIDTHS:
            cases.append(check_case("cora_driver", csr, val, direction, f,
                                    "fp32", gen))
    senders, receivers = gat_sparse_edge_set(cora)
    op = PackedFlashGat(senders=senders, receivers=receivers,
                        num_nodes=cora.num_nodes, device=DEVICE)
    for H, C, rate in DRIVER_GAT_SHAPES:
        cases += check_gat_case("cora_driver", op, H, C, rate, gen)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} driver-shape kernel cases failed: "
                             f"{bad}")
    return cases


def phase_kernel():
    from pytorch_geometric_tpu_torch.data import from_data
    from pytorch_geometric_tpu_torch.datasets import synthetic_citation_graph
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops
    from pytorch_geometric_tpu_torch.ops.flash_gat import FlashGatOperator
    from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat
    from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    _, cora = cora_graph(DEVICE)
    pubmed = from_data(NormalizeFeatures()(synthetic_citation_graph(
        "pubmed", seed=SEED)), device=DEVICE)
    cases = []
    for graph_name, pairs, widths in (
            ("cora", _csr_pairs(cora), (16, 7)),
            ("pubmed", _csr_pairs(pubmed), (16, 128)),
            ("hub", _csr_pairs(), (16,))):
        for direction, (csr, val) in pairs.items():
            for f in widths:
                for dtype_name in ("fp32", "bf16"):
                    cases.append(check_case(graph_name, csr, val, direction,
                                            f, dtype_name, gen))
    hub_s, hub_r = gat_hub_edges()
    hub = PackedFlashGat(senders=hub_s, receivers=hub_r, num_nodes=512,
                         device=DEVICE)
    for graph_name, op, heads in (
            ("cora", gat_flash_op(cora), ((8, 8), (1, 7))),
            ("pubmed", gat_flash_op(pubmed), ((8, 8),)),
            ("hub", hub, ((8, 8), (1, 7), (3, 5)))):
        for H, C in heads:
            for rate in (0.0, 0.6):
                cases += check_gat_case(graph_name, op, H, C, rate, gen)
    # the shift's stress case: most receivers 100-150 below the global max
    op = gat_flash_op(cora)
    for H, C in ((8, 8), (1, 7)):
        stress = check_gat_case("cora_stress", op, H, C, 0.6, gen,
                                s=gat_stress_s(op.n, H, gen))
        if stress[0]["rows_global_shift_underflow"] == 0:
            raise AssertionError("the stress case underflows no row at "
                                 "the global shift: it tests nothing")
        cases += stress
    for graph_name, adj, heads, rates, calls in _flash_masks(cora):
        op = FlashGatOperator(adj, device=DEVICE)
        for H, C in heads:
            for rate in rates:
                cases += check_flash_case(graph_name, adj, op, H, C, rate,
                                          gen, calls)
    ds, mutag = mutag_graph(DEVICE)
    embed_op, transform_op = rgcn_fused_ops(mutag, ds.num_relations)
    for graph_name, op, B, C in (("mutag", embed_op, 30, 16),
                                 ("mutag", transform_op, 30, 2),
                                 ("hub", rgcn_hub_operator(DEVICE, SEED), 5,
                                  33)):
        cases += check_rgcn_case(graph_name, op, B, C, gen)
    cases += phase_kernel_bsr(cora, gen)
    cases += phase_kernel_gcn(cora, gen)
    cases += phase_kernel_suite(gen)
    cases += phase_kernel_ppi(gen)
    cases += phase_kernel_graph(gen)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the "
                             f"plain version: {bad}")
    return cases


def ppi_kernel_graphs():
    """``(name, graph)`` of the PPI kernel cases: the first train graph
    and the val batch, collated at their loaders' budgets."""
    from pytorch_geometric_tpu_torch.data import DataLoader
    from pytorch_geometric_tpu_torch.examples import ppi

    train, val = ppi.load(SEED, device=DEVICE)
    first = DataLoader(train.dataset, batch_size=1, device=DEVICE,
                       num_nodes=train.num_nodes, num_edges=train.num_edges)
    return [("ppi_train", next(iter(first))), ("ppi_val", next(iter(val)))]


def phase_kernel_ppi(gen):
    """The packed-GAT kernels at examples/ppi.py's widths, which take the
    wide-head map: conv1 and conv2's (H, C) = (4, 256) and conv3's
    (6, 121), on the operator of the sparse path's edge set
    (``gat_sparse_edge_set``: repeated edges kept) of one train graph and
    of the val batch, attention dropout 0 and 0.6."""
    from pytorch_geometric_tpu_torch.examples.ppi import ppi_flash_op

    cases = []
    for graph_name, graph in ppi_kernel_graphs():
        op = ppi_flash_op(graph)
        for H, C in PPI_WIDTHS:
            for rate in (0.0, 0.6):
                cases += check_gat_case(graph_name, op, H, C, rate, gen)
    return cases


#: The kernel cases of the graph-level examples (the graphs of their
#: ``kernels`` line rows).
GRAPH_LEVEL_CASES = ("mutag_gin", "mutag_gin_padded", "mutag_gin_pool",
                     "mutag_gin_pool_padded", "enzymes_pool", "qm9_nnconv",
                     "qm9_nnconv_padded", "qm9_senders", "qm9_pool",
                     "qm9_pool_padded", "gae_gather")


def graph_example_batch(name):
    """``(indices, graph)``: the first train batch of the example's
    seeded loader, collated at its budget, on the card."""
    import importlib

    module = importlib.import_module(
        f"pytorch_geometric_tpu_torch.examples.{name}")
    loaders = module.load(SEED, device=DEVICE)
    return next(iter(loaders[0].indexed()))


def phase_kernel_graph(gen):
    """The kernels at the graph-level examples' shapes, fp32: ``spmm_csr``
    on a MUTAG batch's operator (examples/mutag_gin.py: 32 graphs of ~18
    nodes) at conv1's F = 7 and the hidden 32, both directions, over the
    real entries (``mutag_operators``, "mutag_gin") and in the same call
    over every edge slot ("mutag_gin_padded": the padding edges on the
    padding node's row), the two outputs bitwise equal; the segment sum of the
    readouts, ``pool_operator`` over the batch vector's real nodes (rows
    = graphs of ~18 nodes): MUTAG's add pool at F = 32 (and, in the same
    call, the padded operator with the padding graph's long row,
    :func:`check_real_vs_padded`), ENZYMES' mean pool (its 128 channels
    and the count, 64 graphs of ~33 nodes) and QM9's Set2Set at F = 64
    (against padded) and 1 (its softmax sums); and QM9's NNConv messages
    by receiver over the real edges (complete graphs) at F = 64, against
    padded, and its gather by sender's backward sum; the GAE decoder's
    gather at the train positives' senders (examples/autoencoder.py:
    ``gathers``), its backward sum at the embeddings' F = 16."""
    from pytorch_geometric_tpu_torch.examples import (
        autoencoder, mutag_gin, qm9_nn_conv)

    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm_csr

    cases = []
    _, mutag = graph_example_batch("mutag_gin")
    ops = mutag_gin.mutag_operators(mutag)
    padded = SpmmOperator(mutag.senders, mutag.receivers, mutag.num_nodes,
                          device=DEVICE)
    w = mutag.real_edge_mask().float()
    pairs = {}
    for name, op in (("mutag_gin", ops["spmm_op"]),
                     ("mutag_gin_padded", padded)):
        val_f, val_b = op.route_weights(w)
        pairs[name] = {"fwd": (op.fwd, val_f), "bwd": (op.bwd, val_b)}
        for direction, widths in (("fwd", (7, 32)), ("bwd", (32,))):
            csr, val = pairs[name][direction]
            for f in widths:
                cases.append(check_case(name, csr, val, direction, f,
                                        "fp32", gen))
    # the operator over the real entries is the padded one, bitwise
    for direction in ("fwd", "bwd"):
        x = torch.randn(mutag.num_nodes, 32, generator=gen, device=DEVICE)
        got, want = (spmm_csr(*pairs[name][direction], x)
                     for name in ("mutag_gin", "mutag_gin_padded"))
        same = bool(torch.equal(got, want))
        emit({"phase": "kernel", "kernel": "spmm_csr",
              "graph": "mutag_gin", "direction": direction, "F": 32,
              "real_entries_bitwise_the_padded_operator": same})
        if not same:
            raise AssertionError(f"mutag_gin {direction}: the operator over "
                                 "the real entries differs from the padded "
                                 "one")
    cases += check_real_vs_padded("mutag_gin_pool", ops["pool_op"], 32, gen)
    _, enzymes = graph_example_batch("enzymes_topk_pool")
    cases.append(check_sorted_case(
        "enzymes_pool", mutag_gin.mutag_operators(enzymes)["pool_op"].csr,
        "fwd", 129, "fp32", gen))
    _, qm9 = graph_example_batch("qm9_nn_conv")
    ops = qm9_nn_conv.qm9_operators(qm9)
    cases += check_real_vs_padded("qm9_nnconv", ops["segment_op"], 64, gen)
    cases.append(check_sorted_case("qm9_senders", ops["sender_op"].csr,
                                   "fwd", 64, "fp32", gen))
    cases += check_real_vs_padded("qm9_pool", ops["pool_op"], 64, gen)
    cases.append(check_sorted_case("qm9_pool", ops["pool_op"].csr, "fwd", 1,
                                   "fp32", gen))
    data, cora = autoencoder.load(SEED, device=DEVICE)
    gather, _ = autoencoder.gathers(*data.train_pos_edge_index,
                                    cora.num_nodes, DEVICE)
    cases.append(check_sorted_case("gae_gather", gather.csr, "fwd", 16,
                                   "fp32", gen))
    return cases


def phase_kernel_faust(gen):
    """``spmm_csr`` at examples/faust.py's shapes: the rectangular spline
    operator of a FAUST mesh at the published vertex count (8192 padded
    nodes x K = 125 rows over 8192 columns, ~262k (edge, corner) entries;
    most rows empty, the rest 1-4 entries) and its transpose (~39 a row),
    at F = 1, 32 and 64, fp32 (1e-5, two launches bitwise equal), with
    the K = 125 square operators of ``spline_operators`` timed beside it
    for the same product (forward: 125 launches and the ``cat``; ``dx``:
    125 launches summed), cuSPARSE and the bound."""
    import operator

    from pytorch_geometric_tpu_torch.examples import faust
    from pytorch_geometric_tpu_torch.nn.conv import spline_edge_sets
    from pytorch_geometric_tpu_torch.ops.spmm import SpmmOperator, spmm_csr

    train, _ = faust_loaders()
    graph = next(iter(train))
    n, K = graph.num_nodes, faust.KERNEL_SIZE ** faust.DIM
    geom, consts = faust.faust_spline_op(graph).args
    squares = []
    for s, r, b in spline_edge_sets(graph, faust.DIM, faust.KERNEL_SIZE):
        op = SpmmOperator(s, r, n, device=DEVICE)
        squares.append((op, *op.route_weights(b)))

    def k_forward(x):
        return torch.cat([spmm_csr(op.fwd, vf, x) for op, vf, _ in squares],
                         dim=1)

    def k_dx(g):      # g (N, K F): the cat's gradient, one slice a square
        f = g.shape[1] // K
        return functools.reduce(operator.add, (
            spmm_csr(op.bwd, vb, g[:, k * f:(k + 1) * f])
            for k, (op, _, vb) in enumerate(squares)))

    cases = []
    for f in FAUST_WIDTHS:
        x = torch.randn(n, f, generator=gen, device=DEVICE)
        g = torch.randn(n * K, f, generator=gen, device=DEVICE)
        rect_f = spmm_csr(geom.fwd, consts["fwd"], x).reshape(n, K * f)
        rect_b = spmm_csr(geom.bwd, consts["bwd"], g)
        g_cat = g.reshape(n, K * f)
        for direction, csr, val, rect, k_fn, arg in (
                ("fwd", geom.fwd, consts["fwd"], rect_f, k_forward, x),
                ("bwd", geom.bwd, consts["bwd"], rect_b, k_dx, g_cat)):
            k_out = k_fn(arg)
            # beside the warm timing (the named rows of g, ~28 MB at
            # F = 32, stay in the 50 MB L2 between calls), each call
            # from device memory
            extra = {"phase": "kernel_faust", "K": K,
                     "kernel_flushed_ms": device_ms(
                         lambda: spmm_csr(csr, val, arg if direction == "fwd"
                                          else g), flush_l2=True),
                     "k_operators_ms": device_ms(lambda: k_fn(arg)),
                     "k_operators_launches": K,
                     "k_operators_rel_err": _rel(k_out, rect)}
            case = check_case("faust", csr, val, direction, f, "fp32", gen,
                              extra)
            case["ok"] = case["ok"] and case["k_operators_rel_err"] <= 1e-5
            cases.append(case)
    cases += phase_kernel_reddit(gen)
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} FAUST / Reddit case(s) disagree "
                             f"with the plain version: {bad}")
    return cases


@functools.cache
def reddit_full():
    """``(Data, seconds)`` of ``Reddit(full_scale=True)`` (232,965 nodes,
    602 features, 41 classes, ~11.6 M planted-partition edges), built
    once per run: the Reddit kernel cases and reddit_sage's phases share
    it."""
    from pytorch_geometric_tpu_torch.datasets import Reddit
    from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT

    t0 = time.perf_counter()
    data = Reddit(str(PLANETOID_ROOT), full_scale=True)[0]
    return data, time.perf_counter() - t0


def phase_kernel_reddit(gen):
    """``spmm_csr`` on the full-scale synthetic Reddit graph
    (``Reddit(full_scale=True)``: 232,965 nodes, ~11.6 M directed edges,
    the receiver-major CSR with random weights) at F = 602 (its
    features) and 128 (reddit_sage's hidden width): the first
    ``REDDIT_SLICE_ROWS`` rows against the plain version over the same
    rows (1e-5), two launches bitwise equal, the whole call timed beside
    cuSPARSE and the bound, and the plain version and the kernel timed on
    the slice."""
    from pytorch_geometric_tpu_torch.ops.csr import Csr, build_csr
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr, spmm_csr_plain

    data, load_seconds = reddit_full()
    n = data.num_nodes
    t0 = time.perf_counter()
    csr = build_csr(data.edge_index[1], data.edge_index[0], n).to(DEVICE)
    csr_seconds = time.perf_counter() - t0
    val = torch.rand(csr.num_edges, generator=gen, device=DEVICE)
    rows = REDDIT_SLICE_ROWS
    e_rows = int(csr.row_ptr[rows])
    sub = Csr(row_ptr=csr.row_ptr[:rows + 1], col=csr.col[:e_rows],
              perm=csr.perm[:e_rows], num_rows=rows, num_cols=n)
    sub_val = val[:e_rows]
    a = torch.sparse_csr_tensor(csr.row_ptr, csr.col, val, (n, n))
    degree = csr.row_ptr[1:] - csr.row_ptr[:-1]
    cases = []
    for f, x in ((data.x.shape[1], torch.from_numpy(data.x).to(DEVICE)),
                 (128, torch.randn(n, 128, generator=gen, device=DEVICE))):
        got, again = spmm_csr(csr, val, x), spmm_csr(csr, val, x)
        want = spmm_csr_plain(sub, sub_val, x)
        torch.cuda.synchronize()
        abs_err = float((got[:rows] - want).abs().max())
        rel_err = abs_err / max(float(want.abs().max()), 1e-30)
        repeats = torch.equal(got, again)
        lib_err = float((torch.sparse.mm(a, x)[:rows] - want).abs().max())
        bound, bound_by = spmm_bound(csr, f, 4)
        case = {"phase": "kernel_faust", "kernel": "spmm_csr",
                "graph": "reddit_full", "direction": "fwd", "F": f,
                "x": "fp32", "rows": n, "edges": csr.num_edges,
                "longest_row": int(degree.max()),
                "checked_rows": rows, "checked_edges": e_rows,
                "max_abs_err": abs_err, "rel_err": rel_err,
                "tol": TOL["fp32"], "bitwise_repeat": repeats,
                "ok": rel_err <= TOL["fp32"] and repeats,
                "library_max_abs_err": lib_err,
                "kernel_ms": device_ms(lambda: spmm_csr(csr, val, x),
                                       calls=10),
                "plain_ms": None,      # would gather ~E x F x 4 bytes
                "library_ms": device_ms(lambda: torch.sparse.mm(a, x),
                                        calls=10),
                "bound_ms": bound, "bound_by": bound_by,
                "slice_kernel_ms": device_ms(
                    lambda: spmm_csr(sub, sub_val, x), calls=10),
                "slice_plain_ms": device_ms(
                    lambda: spmm_csr_plain(sub, sub_val, x), calls=5),
                "slice_bound_ms": spmm_bound(sub, f, 4)[0],
                "load_seconds": load_seconds, "csr_seconds": csr_seconds}
        emit(case)
        cases.append(case)
        del got, again, want
    return cases


def phase_probe():
    """The probes' libraries (``probes/packed_gat_ablate.cu``,
    ``probes/packed_rgcn_ablate.cu``) against the kernels that ship. Their
    path, counted: every ablation mode of the packed-GAT backward once at
    RCM-PubMed (8, 8) and ``full`` at Cora (8, 8), dropout 0.6; every mode
    of the packed-RGCN backward once at MUTAG's conv1 (30, 16) and conv2
    (30, 2) and ``full`` at the hub operator (5, 33); the forward at
    prefetch depths 1, 2 and 4 at those three (two launches a call: the
    message walk and the segment sum). Every mode, ``full`` included,
    goes through the probe library's own kernel table, and depths 2 and 4
    through its own message walk; depth 1 is the library's forward,
    ``packed_rgcn_fwd``, itself. Then, uncounted: ``full`` bitwise against
    the library's ``packed_gat_bwd`` / ``packed_rgcn_bwd`` and within 1e-5
    of their plain versions, depths 2 and 4 bitwise against depth 1, depth
    1 bitwise against the library's ``packed_rgcn_fwd``, depth 2 within
    1e-5 of its plain version, every output finite. The timing tables are
    the probe scripts'; here, on the main graph (RCM-PubMed, MUTAG conv1),
    one time of each backward's ``full`` and of the forward at each depth
    (the kernels row takes depth 2, the counterpart of the TPU probe's
    prefetching kernel). Then the design probes' checks, the fused GCN's
    (the earlier design beside the library's) among them."""
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops
    from pytorch_geometric_tpu_torch.ops import packed_gat as pg
    from pytorch_geometric_tpu_torch.ops import packed_rgcn as pr
    from probes import gat_ablate as ga
    from probes import rgcn_ablate as ra
    from probes import rgcn_pipe_probe as rp

    gat_lib, rgcn_lib = ga.load(), ra.load()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rate = 0.6
    gat_cases = []
    for name, graph in (("cora", cora_graph(DEVICE)[1]),
                        ("pubmed_rcm", pubmed_graph(DEVICE)[1])):
        op = gat_flash_op(graph)
        gat_cases.append((name, op, ga.inputs(op, gen)))
    ds, mutag = mutag_graph(DEVICE)
    embed_op, transform_op = rgcn_fused_ops(mutag, ds.num_relations)
    rgcn_cases = [(name, op, ra.inputs(op, B, C, gen))
                  for name, op, B, C in (("mutag", embed_op, 30, 16),
                                         ("mutag_conv2", transform_op, 30, 2),
                                         ("hub",
                                          rgcn_hub_operator(DEVICE, SEED), 5,
                                          33))]
    # the probes' path, counted
    ga.ablate_walk.launches = ra.ablate_bwd.launches = 0
    rp.pipe_fwd.launches = 0
    gat_out = {(name, mode): ga.ablate_bwd(gat_lib, op, *inp, rate, mode)
               for name, op, inp in gat_cases for mode in ga.MODES
               if mode == "full" or name == "pubmed_rcm"}
    rgcn_out = {(name, mode): ra.ablate_bwd(rgcn_lib, op, *inp, mode)
                for name, op, inp in rgcn_cases for mode in ra.MODES
                if mode == "full" or name != "hub"}
    pipe_out = {(name, depth): rp.pipe_fwd(rgcn_lib, op, *inp[:2], depth)
                for name, op, inp in rgcn_cases for depth in rp.DEPTHS}
    torch.cuda.synchronize()
    launches = {"packed_gat_ablate_bwd": ga.ablate_walk.launches,
                "packed_rgcn_ablate_bwd": ra.ablate_bwd.launches,
                "packed_rgcn_pipe_fwd": rp.pipe_fwd.launches}
    nodatt = sum(1 for name, mode in rgcn_out if mode == "nodatt")
    expected = {"packed_gat_ablate_bwd": 2 * len(gat_out),
                "packed_rgcn_ablate_bwd": 3 * len(rgcn_out) - 2 * nodatt,
                "packed_rgcn_pipe_fwd": 2 * len(pipe_out)}
    cases, failed = [], []
    rows = {}
    for name, op, (d, s, h, m, seed, g) in gat_cases:
        got = gat_out[name, "full"]
        lib = pg.packed_gat_bwd(op.fwd, op.bwd, op.bwd_eid, d, s, h, m, seed,
                                g, rate, op.slope)
        plain = pg.packed_gat_bwd_plain(op.fwd, d, s, h, m, seed, g, rate,
                                        op.slope)
        torch.cuda.synchronize()
        case = {"phase": "probe", "kernel": "packed_gat_ablate_bwd",
                "graph": name, "H": ga.H, "C": ga.C, "rate": rate,
                "modes": [md for nm, md in gat_out if nm == name],
                "bitwise_vs_library": all(torch.equal(a, b)
                                          for a, b in zip(got, lib)),
                "finite": all(bool(torch.isfinite(t).all())
                              for (nm, _), out in gat_out.items()
                              if nm == name for t in out)}
        case["max_abs_err"], case["rel_err"] = _max_rel_err(got, plain)
        if name == "pubmed_rcm":
            outs = [ga.ablate_walk(gat_lib, op, d, s, h, m, seed, g, rate,
                                   "full", walk) for walk in (0, 1)]
            case["kernel_ms"] = device_ms(lambda: [
                ga.ablate_walk(gat_lib, op, d, s, h, m, seed, g, rate, "full",
                               walk, outs[walk]) for walk in (0, 1)])
            case["plain_ms"] = device_ms(lambda: pg.packed_gat_bwd_plain(
                op.fwd, d, s, h, m, seed, g, rate, op.slope))
            case["bound_ms"], case["bound_by"] = gat_bound(op, ga.H, ga.C,
                                                           True)
            rows["packed_gat_ablate_bwd"] = case
        cases.append(case)
    for name, op, (xB, att, g) in rgcn_cases:
        got = rgcn_out[name, "full"]
        lib = pr.packed_rgcn_bwd(op.bwd, op.bwd_et, op.bwd_w, op.bwd_pos,
                                 op.rel_ptr, xB, att, g)
        plain = pr.packed_rgcn_bwd_plain(op.bwd, op.bwd_et, op.bwd_w, xB, att,
                                         g)
        fwd_lib = pr.packed_rgcn_fwd(op.fwd, op.send, xB, att)
        fwd_plain = pr.packed_rgcn_fwd_plain(op.fwd, op.fwd_et, op.fwd_w, xB,
                                             att)
        torch.cuda.synchronize()
        B = att.shape[1]
        C = xB.shape[1] // B
        case = {"phase": "probe", "kernel": "packed_rgcn_ablate_bwd",
                "graph": name, "B": B, "C": C,
                "modes": [md for nm, md in rgcn_out if nm == name],
                "bitwise_vs_library": all(torch.equal(a, b)
                                          for a, b in zip(got, lib)),
                "finite": all(bool(torch.isfinite(t).all())
                              for (nm, _), out in rgcn_out.items()
                              if nm == name for t in out)}
        case["max_abs_err"], case["rel_err"] = _max_rel_err(got, plain)
        ahead = [pipe_out[name, dp] for dp in rp.DEPTHS if dp != 1]
        # depth 1 is the library's forward: every depth gives its bits
        pipe = {"phase": "probe", "kernel": "packed_rgcn_pipe_fwd",
                "graph": name, "B": B, "C": C, "depths": list(rp.DEPTHS),
                "bitwise_vs_depth1": all(torch.equal(out, pipe_out[name, 1])
                                         for out in ahead),
                "bitwise_depth1_vs_library": torch.equal(pipe_out[name, 1],
                                                         fwd_lib),
                "finite": all(bool(torch.isfinite(out).all())
                              for out in ahead)}
        pipe["max_abs_err"], pipe["rel_err"] = _max_rel_err(
            (pipe_out[name, 2],), (fwd_plain,))
        if name == "mutag":
            scratch = ra.ablate_bwd(rgcn_lib, op, xB, att, g) + (
                torch.empty(op.E, B, device=DEVICE),
                torch.empty(op.R, pr.DATT_SPLITS, B, device=DEVICE))
            case["kernel_ms"] = device_ms(
                lambda: ra.ablate_bwd(rgcn_lib, op, xB, att, g, "full",
                                      scratch))
            case["plain_ms"] = device_ms(lambda: pr.packed_rgcn_bwd_plain(
                op.bwd, op.bwd_et, op.bwd_w, xB, att, g))
            case["bound_ms"], case["bound_by"] = rgcn_bound(op, B, C, True)
            out = torch.empty_like(fwd_lib)
            for depth in rp.DEPTHS:
                pipe[f"depth{depth}_ms"] = device_ms(
                    lambda: rp.pipe_fwd(rgcn_lib, op, xB, att, depth, out))
            pipe["kernel_ms"] = pipe["depth2_ms"]
            pipe["plain_ms"] = device_ms(lambda: pr.packed_rgcn_fwd_plain(
                op.fwd, op.fwd_et, op.fwd_w, xB, att))
            pipe["bound_ms"], pipe["bound_by"] = rgcn_bound(op, B, C, False)
            rows["packed_rgcn_ablate_bwd"] = case
            rows["packed_rgcn_pipe_fwd"] = pipe
        cases += [case, pipe]
    for case in cases:
        case["tol"] = TOL["fp32"]
        case["ok"] = (case["rel_err"] <= TOL["fp32"] and case["finite"]
                      and case.get("bitwise_vs_library", True)
                      and case.get("bitwise_vs_depth1", True)
                      and case.get("bitwise_depth1_vs_library", True))
        emit(case)
        if not case["ok"]:
            failed.append((case["kernel"], case["graph"]))
    emit({"phase": "probe", "launches": launches,
          "expected_launches": expected})
    for design in (probe_bsr_designs(gen), *probe_packed_designs(gen),
                   probe_flash_designs(gen), probe_rgcn_designs(gen),
                   *probe_spmm_designs(gen), *probe_segment_designs(gen),
                   probe_fused_designs(gen)):
        if not design["ok"]:
            failed.append((design["kernel"], design["graph"]))
    if failed:
        raise AssertionError(f"probe cases disagree with the library or "
                             f"the plain version: {failed}")
    if launches != expected or not all(launches.values()):
        raise AssertionError(f"probe launches {launches}, expected "
                             f"{expected}")
    return {"launches": launches, "rows": rows}


def probe_bsr_designs(gen, rate=0.6):
    """The first design of the block-sparse GAT forward, row pass and
    column pass (``probes/bsr_gat_designs.cu``) against the library's
    kernels at RCM-PubMed (8, 8): within 1e-6 of each other, the row
    pass's D (summed in one order by both) bitwise, and within 1e-5 of the
    plain versions (relative to the largest magnitude). The timing table
    is the probe script's."""
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from probes import bsr_gat_designs as bd

    mask = gat_flash_op(pubmed_graph(DEVICE)[1], "bsr").mask
    _, errors = bd.compare(bd.load(), mask, 8, 8, rate, gen)
    case = {"phase": "probe", "kernel": "bsr_gat_designs",
            "graph": "pubmed_rcm", "H": 8, "C": 8, "rate": rate,
            "errors": errors, "tol_designs": 1e-6, "tol": TOL["fp32"],
            "ok": errors["first_vs_shipped_D"] == 0 and all(
                err <= (1e-6 if "_vs_shipped_" in key else TOL["fp32"])
                for key, err in errors.items())}
    emit(case)
    return case


def probe_packed_designs(gen, rate=0.6):
    """The first design of the packed-GAT forward and backward and the
    wide-head map at every width (``probes/packed_gat_designs.cu``)
    against the library's at Cora (8, 8), the main path's call, and at
    the research driver's (8, 135), where the library runs the wide-head
    map: each within 1e-6 of the first design (the row map sums a row's
    edges in other orders), 1e-5 of the plain version, two launches of the
    library's forward bitwise equal; the wide-head map's num‖den, m and dh
    bitwise the first design's (and so the library's past 32 channels a
    head). The timing table is the probe script's."""
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op
    from pytorch_geometric_tpu_torch.nn.conv import gat_sparse_edge_set
    from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat
    from probes import packed_gat_designs as pd

    cora = cora_graph(DEVICE)[1]
    senders, receivers = gat_sparse_edge_set(cora)
    driver_op = PackedFlashGat(senders=senders, receivers=receivers,
                               num_nodes=cora.num_nodes, device=DEVICE)
    lib = pd.load()
    cases = []
    for graph, op, H, C in (("cora", gat_flash_op(cora), 8, 8),
                            ("cora_driver", driver_op, 8, 135)):
        inputs, errors = pd.compare(lib, op, H, C, rate, gen)
        fwd_errors, fwd_repeat = pd.compare_fwd(lib, op, inputs, rate)
        errors.update(fwd_errors)
        bitwise = ["fwd_first_vs_wide", "dh_first_vs_wide"]
        if C > 32:
            bitwise += ["fwd_first_vs_shipped", "dh_first_vs_shipped"]
        case = {"phase": "probe", "kernel": "packed_gat_designs",
                "graph": graph, "H": H, "C": C, "rate": rate,
                "errors": errors, "fwd_bitwise_repeat": fwd_repeat,
                "bitwise": bitwise, "tol_designs": 1e-6,
                "tol": TOL["fp32"],
                "ok": fwd_repeat and all(errors[k] == 0 for k in bitwise)
                and all(err <= (1e-6 if "_first_vs_" in key
                                or key.startswith("first_vs_")
                                else TOL["fp32"])
                        for key, err in errors.items())}
        emit(case)
        cases.append(case)
    return cases


def probe_spmm_designs(gen):
    """The first design of ``spmm_csr`` (``probes/spmm_csr_designs.cu``)
    against the library's on Cora's GCN CSR (the main path's forward): at
    F = 16, fp32 and bf16 x, within 1e-6 of each other (the row map sums
    a row's edges in another order); at the chunk map's widths, F = 1433
    (SGC's, Spline's), 300 and 33 in fp32 and 1433 in bf16, the chunk map
    at each K and the library bitwise equal to the first design (all sum
    in CSR order); each design within 1e-5 (fp32 x) or 1e-2 (bf16 x) of
    the plain version, and two launches of the library's bitwise equal.
    One case a width and dtype; the timing table is the probe
    script's."""
    from probes import spmm_csr_designs as sd

    lib = sd.load()
    csr, val = _csr_pairs(cora_graph(DEVICE)[1])["fwd"]
    cases = []
    for f, dtype_name in ((16, "fp32"), (16, "bf16"), (1433, "fp32"),
                          (300, "fp32"), (33, "fp32"), (1433, "bf16")):
        x = torch.randn(csr.num_cols, f, generator=gen,
                        device=DEVICE).to(sd.DTYPES[dtype_name])
        errors, same, repeat = sd.compare(lib, csr, val, x)
        # where the row map does not take F, every design keeps CSR order
        ordered = [d for d in same if d.startswith("chunks")
                   or (d == "shipped" and not sd.takes_row_map(f, x))]
        case = {"phase": "probe", "kernel": "spmm_csr_designs",
                "graph": "cora", "direction": "fwd", "F": f,
                "x": dtype_name, "errors": errors, "bitwise_vs_first": same,
                "bitwise_repeat": repeat, "tol_designs": 1e-6,
                "tol": TOL[dtype_name],
                "ok": repeat and all(same[d] for d in ordered) and all(
                    err <= (1e-6 if key == "first_vs_shipped"
                            else TOL[dtype_name])
                    for key, err in errors.items())}
        emit(case)
        cases.append(case)
    return cases


def probe_segment_designs(gen):
    """The segment sum's first design and chunk map
    (``probes/segment_sum_designs.cu``) against the library's at DNA's
    key-value gradients by sender on Cora (F = 1024 and 256, fp32 and
    bf16 messages), AGNN's F = 16 and the RGCN hub operator's C = 33
    (a receiver of 3,013 messages): every design, the library's too,
    bitwise equal to the first (all sum each element in CSR order in one
    accumulator), each within 1e-5 (fp32) or 1e-2 (bf16) of the plain
    version, and two launches of the library's bitwise equal. One case a
    shape and dtype; the timing table is the probe script's."""
    from probes import segment_sum_designs as gd

    lib = gd.load()
    ptrs = gd.row_ptrs(["dna", "agnn", "rgcn_hub"])
    cases = []
    for graph, direction, f, dtype_name in (
            ("dna", "bwd", 1024, "fp32"), ("dna", "bwd", 1024, "bf16"),
            ("dna", "bwd", 256, "fp32"), ("dna", "bwd", 256, "bf16"),
            ("agnn", "bwd", 16, "fp32"), ("rgcn_hub", "fwd", 33, "fp32")):
        rp = ptrs[graph, direction]
        msgs = torch.randn(int(rp[-1]), f, generator=gen,
                           device=DEVICE).to(gd.DTYPES[dtype_name])
        errors, same, repeat = gd.compare(lib, rp, msgs)
        case = {"phase": "probe", "kernel": "segment_sum_designs",
                "graph": graph, "direction": direction, "F": f,
                "msgs": dtype_name, "errors": errors,
                "bitwise_vs_first": same, "bitwise_repeat": repeat,
                "tol": TOL[dtype_name],
                "ok": repeat and all(same.values()) and all(
                    err <= TOL[dtype_name] for err in errors.values())}
        emit(case)
        cases.append(case)
    return cases


def probe_flash_designs(gen, rate=0.6):
    """The first design of the dense-mask GAT forward and backward
    (``probes/flash_gat_designs.cu``) against the library's at Cora
    (8, 8), the main path's call: within 1e-6 of each other (the forward
    and dd sum a row's entries in other orders), D (summed in one order
    by both) bitwise, each within 1e-5 of the plain version, and two
    launches of the library's forward bitwise equal. The timing table is
    the probe script's."""
    from pytorch_geometric_tpu_torch.nn.conv import gat_dense_adj
    from pytorch_geometric_tpu_torch.ops.flash_gat import BitMask
    from probes import flash_gat_designs as fd

    adj = gat_dense_adj(cora_graph(DEVICE)[1])
    lib, mask = fd.load(), BitMask(adj)
    inputs, errors = fd.compare(lib, adj, mask, 8, 8, rate, gen)
    fwd_errors, fwd_repeat = fd.compare_fwd(lib, adj, mask, inputs, rate)
    errors.update(fwd_errors)
    case = {"phase": "probe", "kernel": "flash_gat_designs",
            "graph": "cora", "H": 8, "C": 8, "rate": rate,
            "errors": errors, "fwd_bitwise_repeat": fwd_repeat,
            "tol_designs": 1e-6, "tol": TOL["fp32"],
            "ok": errors["first_vs_shipped_D"] == 0 and fwd_repeat and all(
                err <= (1e-6 if key.endswith("first_vs_shipped")
                        else TOL["fp32"])
                for key, err in errors.items())}
    emit(case)
    return case


def probe_rgcn_designs(gen):
    """The first designs of the packed-RGCN forward and backward
    (``probes/packed_rgcn_designs.cu``) against the library's at MUTAG
    conv1 (30, 16), the main path's largest call: the forwards within
    1e-5 of each other (they sum in other orders) and two launches of the
    library's bitwise equal; the backwards bitwise equal (both sum in one
    order); each within 1e-5 of the plain version. The timing table is
    the probe script's."""
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops
    from probes import packed_rgcn_designs as rd

    ds, mutag = mutag_graph(DEVICE)
    op = rgcn_fused_ops(mutag, ds.num_relations)[0]
    lib = rd.load()
    xB, att, g = rd.inputs(op, 30, 16, gen)
    fwd_errors, fwd_repeat = rd.compare_fwd(lib, op, xB, att)
    agree = rd.compare(lib, op, xB, att, g)
    case = {"phase": "probe", "kernel": "packed_rgcn_designs",
            "graph": "mutag", "B": 30, "C": 16,
            "fwd_errors": fwd_errors, "fwd_bitwise_repeat": fwd_repeat,
            "rel_err_vs_plain": {k: v[0] for k, v in agree.items()},
            "bitwise_vs_shipped": {k: v[1] for k, v in agree.items()},
            "tol": TOL["fp32"],
            "ok": fwd_repeat and all(err <= TOL["fp32"]
                                     for err in fwd_errors.values())
            and all(err <= TOL["fp32"] and same
                    for err, same in agree.values())}
    emit(case)
    return case


def probe_fused_designs(gen, rate=0.5):
    """The earlier design of the fused GCN kernels
    (``probes/fused_gcn_designs.cu``, namespace ``earlier_design``) beside
    the library's call and its walks in the other launch forms (one
    cooperative launch, two plain launches), at RCM-PubMed (16, 3),
    dropout 0.5, the main path's call: each within
    1e-5 of the plain versions and two launches of each bitwise equal (the
    probe raises otherwise), forward and backward timed. The full table
    (both graphs and rates, every lane count and grid) is the probe
    script's."""
    from probes import fused_gcn_designs as fd

    lib = fd.load()
    rows = fd.compare(lib, pubmed_graph(DEVICE)[1], 3, rate, gen)
    case = {"phase": "probe", "kernel": "fused_gcn_designs",
            "graph": "pubmed_rcm", "H": 16, "C": 3, "rate": rate,
            "library_options": fd.library_options(lib), "designs": rows,
            "tol": TOL["fp32"],
            "ok": all(r[d]["rel_err"] <= TOL["fp32"] for r in rows.values()
                      for d in ("fwd", "bwd"))}
    emit(case)
    return case


#: The thirteen configurations of the main path, by the suffix of their
#: phases: (trainer, backend or suite model, graph loader, epochs, device
#: kernel launches per epoch on the profiler's trace).
CONFIGS = {
    "gcn": ("gcn", "packed", "cora", EPOCHS, 4),
    "gat": ("gat", "packed", "cora", EPOCHS, 6),
    "gat_dense": ("gat", "dense", "cora", EPOCHS, 6),
    "gat_bsr": ("gat", "bsr", "pubmed", EPOCHS, 6),
    "rgcn": ("rgcn", None, "mutag", RGCN_EPOCHS, 10),
    "gcn_sorted": ("gcn", "sorted", "pubmed", EPOCHS, 4),
    "gcn_fused": ("gcn", "fused", "pubmed", EPOCHS, 4),
    "gcn_dense": ("gcn", "dense", "cora", EPOCHS, 0),
    "gcn_hybrid": ("gcn", "hybrid", "cora", EPOCHS, 8),
    "sgc": ("suite", "sgc", "cora", EPOCHS, 0),
    "agnn": ("suite", "agnn", "cora", EPOCHS, 12),
    "arma": ("suite", "arma", "cora", EPOCHS, 8),
    "spline": ("suite", "spline", "cora_spline", EPOCHS, 6),
    "dna": ("suite", "dna", "cora", EPOCHS, 12),
    "closure_gcn": ("gcn", "packed", "cora", EPOCHS, 4),
    "closure_gat": ("gat", "packed", "cora", EPOCHS, 6),
    "closure_rgcn": ("rgcn", None, "mutag", RGCN_EPOCHS, 10),
}
#: The configurations that train on the training nodes' closure
#: (``closure=True``) and evaluate on the full graph.
CLOSURE_CONFIGS = ("closure_gcn", "closure_gat", "closure_rgcn")
#: The JAX bench's bounds on the closure-against-full logit gap,
#: max |closure - full at the seeds| / (1 + max |full|)
#: (``bench_common.py:213, 306, 756``).
CLOSURE_GAP = {"gcn": 1e-3, "gat": 1e-2, "rgcn": 1e-2}

#: The citation suite's kernel launches, worked out from its code
#: (``examples/citation_suite.py:train_suite``): per epoch, for the
#: evaluation, at set-up. SGC propagates Cora's features twice at set-up
#: and then trains one matrix product. AGNN's two layers each run one
#: SpMM forward and one for dx (alpha's gradient is the operator's SDDMM,
#: no kernel), and one segment sum forward (the softmax's sums) and three
#: backward (the gradients of the two cosine gathers and of the sums'
#: gather). ARMA's two convs of two layers run one L̂ product each, forward
#: and backward. Spline's two convs run two kernel-index SpMMs each
#: forward, and the second conv two backward (the first one's input is
#: the features, which take no gradient). DNA's four layers run one
#: segment sum each forward (its backward is a gather) and two backward
#: (the gradients of the query gather by receiver and of the key-value
#: gather by sender).
SUITE_LAUNCHES = {
    "sgc": ({}, {}, {"spmm_csr": 2}),
    "agnn": ({"spmm_csr": 4, "sorted_segment_sum": 8},
             {"spmm_csr": 2, "sorted_segment_sum": 2}, {}),
    "arma": ({"spmm_csr": 8}, {"spmm_csr": 4}, {}),
    "spline": ({"spmm_csr": 6}, {"spmm_csr": 4}, {}),
    "dna": ({"sorted_segment_sum": 12}, {"sorted_segment_sum": 4}, {}),
}


@functools.cache
def load(name):
    """``(dataset, graph on the card, RCM seconds or None)`` of ``"cora"``,
    ``"cora_spline"`` (Cora with ``TargetIndegree``'s pseudo-coordinates,
    the suite's Spline graph), ``"pubmed"`` (RCM-reordered) or ``"mutag"``
    (the published size), built once per run."""
    from pytorch_geometric_tpu_torch.examples import citation_suite

    if name == "pubmed":
        return pubmed_graph(DEVICE)
    if name == "cora_spline":
        return (*citation_suite.load("spline", device=DEVICE), None)
    return (*(cora_graph if name == "cora" else mutag_graph)(DEVICE), None)


def train(config, epochs=None, capture=None, seed=SEED):
    """The trainer of ``config`` on its graph, as a user calls it:
    ``(model, metrics)``; captured by default."""
    from pytorch_geometric_tpu_torch.examples.citation_suite import (
        train_suite)
    from pytorch_geometric_tpu_torch.models.citation import (
        train_gat, train_gcn)
    from pytorch_geometric_tpu_torch.models.entities import train_rgcn

    kind, backend, graph_name, default_epochs, _ = CONFIGS[config]
    ds, graph, _ = load(graph_name)
    epochs = default_epochs if epochs is None else epochs
    if kind == "suite":
        return train_suite(backend, graph, ds.num_classes, epochs=epochs,
                           seed=seed, device=DEVICE, capture=capture)
    closure = config in CLOSURE_CONFIGS
    if kind == "rgcn":
        return train_rgcn(graph, ds.num_relations, ds.num_classes,
                          epochs=epochs, seed=seed, device=DEVICE,
                          capture=capture, closure=closure)
    fn = train_gcn if kind == "gcn" else train_gat
    return fn(graph, num_classes=ds.num_classes, epochs=epochs, seed=seed,
              device=DEVICE, backend=backend, capture=capture,
              closure=closure)


def logits_of(config, model, device=DEVICE, backend=None):
    """The trained model's logits on ``device`` through the operators of
    the config's backend (or of ``backend``, on the config's graph),
    dropout off (on the CPU their plain versions; a suite model on the
    CPU takes its plain path, without operators)."""
    from pytorch_geometric_tpu_torch.models.citation import (
        gat_flash_op, gcn_backend)
    from pytorch_geometric_tpu_torch.models.entities import rgcn_fused_ops

    kind, own, graph_name, _, _ = CONFIGS[config]
    backend = backend or own
    ds, graph, _ = load(graph_name)
    g = graph.to(device)
    m = model.to(device)
    with torch.no_grad():
        if kind == "suite":
            return m(g, g.x, **(m.operators(g) if g.device.type == "cuda"
                                else {}))
        if kind == "rgcn":
            return m(g, fused_ops=rgcn_fused_ops(g, ds.num_relations))
        if kind == "gat":
            return m(g, g.x, flash_op=gat_flash_op(g, backend))
        agg = gcn_backend(g, backend, 16, ds.num_classes, m.dropout_rate)[0]
        return m(g, g.x, **agg)


def epoch_step_of(config):
    """``(epoch_step, generator)`` of a fresh model of ``config``, built
    as its trainer builds it."""
    from pytorch_geometric_tpu_torch.models.citation import (
        GAT, GCN, create_gat_train_step, create_gcn_train_step)
    from pytorch_geometric_tpu_torch.models.entities import (
        RGCN, create_rgcn_train_step)

    from pytorch_geometric_tpu_torch.examples import citation_suite

    kind, backend, graph_name, _, _ = CONFIGS[config]
    ds, graph, _ = load(graph_name)
    init = torch.Generator().manual_seed(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    closure = config in CLOSURE_CONFIGS
    if kind == "suite":
        cls, hp = citation_suite.MODELS[backend]
        model = cls(graph.num_node_features, ds.num_classes,
                    generator=init).to(DEVICE)
        return citation_suite.create_train_step(
            model, graph, hp["lr"], hp["wd"], cls.operators(graph))[0], gen
    if kind == "rgcn":
        model = RGCN(graph.num_nodes, ds.num_relations, ds.num_classes,
                     generator=init).to(DEVICE)
        return create_rgcn_train_step(model, graph, ds.num_relations,
                                      closure=closure)[0], None
    if kind == "gat":
        model = GAT(graph.num_node_features, ds.num_classes,
                    generator=init).to(DEVICE)
        return create_gat_train_step(model, graph, backend=backend,
                                     closure=closure)[0], gen
    model = GCN(graph.num_node_features, 16, ds.num_classes,
                generator=init).to(DEVICE)
    return create_gcn_train_step(model, graph, backend=backend,
                                 closure=closure)[0], gen


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def run_main_path(config, per_epoch, evaluation, setup=None):
    """The config's training run as a user runs it (captured, the default)
    and then the same run eager (``capture=False``), launches read over
    each. Per counted wrapper, the captured run's device launches are
    captured epoch × replays + warm-up + evaluation (its Python calls are
    the warm-up's, the capture's and the evaluation's), plus ``setup``
    (a suite model's operators: SGC's propagation), and must equal
    ``epochs × per_epoch + evaluation + setup``, the eager run's count;
    every other wrapper launches no time. ``(model, report, problems)``."""
    from pytorch_geometric_tpu_torch.models.capture import (
        device_launches, launch_counts)

    setup = setup or {}
    epochs = CONFIGS[config][3]
    names = list(launch_counts())
    expected = {n: epochs * per_epoch.get(n, 0) + evaluation.get(n, 0)
                + setup.get(n, 0) for n in names}
    calls = {n: 2 * per_epoch.get(n, 0) + evaluation.get(n, 0)
             + setup.get(n, 0) for n in names}
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    before = launch_counts()
    model, metrics = train(config)
    peak = torch.cuda.max_memory_allocated()
    counted = {n: v - before[n] for n, v in launch_counts().items()}
    stages = metrics["launches"]
    set_up = metrics.get("setup_launches", {})
    ran = {n: device_launches(stages).get(n, 0) + set_up.get(n, 0)
           for n in names}
    # the captured run's model (parameters and gradients) stays allocated
    # through the eager run: each run's own peak is counted from its start
    torch.cuda.reset_peak_memory_stats()
    eager_start = torch.cuda.memory_allocated()
    before = launch_counts()
    _, eager = train(config, capture=False)
    eager_peak = torch.cuda.max_memory_allocated()
    eager_counted = {n: v - before[n] for n, v in launch_counts().items()}
    statement = {
        n: f"{stages['captured_epoch'].get(n, 0)} captured per epoch x "
           f"{stages['replays']} replays + {stages['warm_up'].get(n, 0)} "
           f"warm-up + {stages['evaluation'].get(n, 0)} evaluation"
           + (f" + {set_up[n]} set-up" if n in set_up else "") + f" = {v}"
        for n, v in ran.items() if v}
    loss = metrics["curve"]["loss"]
    report = {"epochs": epochs, "seconds": metrics["seconds"],
              "capture_seconds": metrics["capture_seconds"],
              "ms_per_epoch": metrics["seconds"] / (epochs - 1) * 1e3,
              "eager_seconds": eager["seconds"],
              "eager_ms_per_epoch": eager["seconds"] / epochs * 1e3,
              "first_loss": float(loss[0]), "final_loss": float(loss[-1]),
              "eager_final_loss": float(eager["curve"]["loss"][-1]),
              **{k: v for k, v in metrics.items() if k.endswith("_acc")},
              **{f"eager_{k}": v for k, v in eager.items()
                 if k.endswith("_acc")},
              "launches": ran, "launch_statement": statement,
              "launch_stages": stages, "setup_launches": set_up,
              "expected_launches": expected,
              "eager_launches": eager_counted,
              "max_memory_allocated": peak,
              "run_peak_bytes": peak - start,
              "eager_run_peak_bytes": eager_peak - eager_start}
    problems = []
    if not (np.isfinite(loss).all()
            and np.isfinite(eager["curve"]["loss"]).all()):
        problems.append("non-finite training loss")
    want_stages = {"warm_up": {n: v for n, v in per_epoch.items() if v},
                   "captured_epoch": {n: v for n, v in per_epoch.items()
                                      if v},
                   "replays": epochs - 1,
                   "evaluation": {n: v for n, v in evaluation.items() if v}}
    if stages != want_stages:
        problems.append(f"launches by stage {stages}, expected {want_stages}")
    if set_up != setup or eager.get("setup_launches", {}) != setup:
        problems.append(f"set-up launches {set_up} (eager run "
                        f"{eager.get('setup_launches')}), expected {setup}")
    if ran != expected or counted != calls:
        problems.append(f"captured run: device launches {ran} (wrapper calls "
                        f"{counted}), expected {expected} ({calls})")
    if eager_counted != expected:
        problems.append(f"eager run: launches {eager_counted}, expected "
                        f"{expected}")
    return model, metrics, report, problems


def _accuracy_gate(metrics, problems):
    if not (metrics["val_acc"] > 0.6 and metrics["test_acc"] > 0.6):
        problems.append(f"accuracy gate: val {metrics['val_acc']}, test "
                        f"{metrics['test_acc']} (need > 0.6)")


def _finish(result, problems):
    emit(result)
    if problems:
        raise AssertionError("; ".join(problems))
    return result


def phase_slice():
    """examples/gcn.py's run on the card: Planetoid Cora -> from_data ->
    train_gcn(epochs=200), captured, then eager; the trained model's
    logits on the card against the plain path on the CPU."""
    ds, graph, _ = load("cora")
    model, metrics, report, problems = run_main_path(
        "gcn", {"spmm_csr": 4}, {"spmm_csr": 2})
    card = logits_of("gcn", model)
    ref = logits_of("gcn", model, "cpu")
    parity = _rel(card.cpu(), ref)
    _accuracy_gate(metrics, problems)
    if not (torch.isfinite(card).all() and parity <= 1e-4):
        problems.append(f"trained logits: card vs CPU rel err {parity}")
    return _finish({"phase": "slice", "dataset": "cora",
                    "synthetic": ds.is_synthetic, "nodes": graph.num_nodes,
                    "edges": graph.num_edges, **report,
                    "logits_shape": list(ref.shape),
                    "logits_cuda_vs_cpu_rel_err": parity}, problems)


def phase_slice_gat(backend="packed", phase="slice_gat"):
    """examples/gat.py's run on the card: train_gat, every attention
    layer, forward and backward, through the kernels of ``backend``:
    packed-GAT (the edge list) or flash-GAT (``"dense"``, the (N, N)
    mask) on Cora, or the block-sparse kernels (``"bsr"``) on PubMed
    after RCM reordering. Per epoch 2 forward launches (conv1, conv2) and
    4 backward launches (2 per layer: the receiver- and the sender-major
    CSR, or the mask's row and column pass); the final evaluation adds 2
    forward launches. The other backends' kernels launch no time. The
    bsr run also holds its trained logits to the packed operator's on the
    card and its peak device memory, the CUDA graph's pool counted, under
    1 GB (nothing of size N^2)."""
    from pytorch_geometric_tpu_torch.models.citation import gat_flash_op

    config = "gat" if backend == "packed" else f"gat_{backend}"
    if backend == "bsr":
        per_epoch = {"bsr_gat_fwd": 2, "bsr_gat_bwd_row": 2,
                     "bsr_gat_bwd_col": 2}
        evaluation = {"bsr_gat_fwd": 2}
    else:
        mine = "flash_gat" if backend == "dense" else "packed_gat"
        per_epoch = {f"{mine}_fwd": 2, f"{mine}_bwd": 4}
        evaluation = {f"{mine}_fwd": 2}
    ds, graph, rcm_seconds = load(CONFIGS[config][2])
    model, metrics, report, problems = run_main_path(config, per_epoch,
                                                     evaluation)
    # the operator's host set-up, which train_gat keeps out of its seconds
    t0 = time.perf_counter()
    gat_flash_op(graph, backend)
    torch.cuda.synchronize()
    op_seconds = time.perf_counter() - t0
    card = logits_of(config, model)
    packed = (logits_of(config, model, backend="packed")
              if backend == "bsr" else None)
    ref = logits_of(config, model, "cpu")
    model.to(DEVICE)
    parity = _rel(card.cpu(), ref)
    packed_parity = None if packed is None else _rel(card, packed)
    _accuracy_gate(metrics, problems)
    if not (torch.isfinite(card).all() and parity <= 1e-4):
        problems.append(f"trained logits: card vs CPU rel err {parity}")
    peak = report["max_memory_allocated"]
    if backend == "bsr" and not (packed_parity <= 1e-4 and peak < 1e9):
        problems.append(f"bsr slice: logits vs the packed operator "
                        f"{packed_parity} (need <= 1e-4), peak device memory "
                        f"{peak} with the graph's pool (need < 1e9)")
    return _finish({"phase": phase, "backend": backend, "dataset": ds.name,
                    "synthetic": ds.is_synthetic, "nodes": graph.num_nodes,
                    "edges": graph.num_edges, "rcm_seconds": rcm_seconds,
                    "operator_setup_seconds": op_seconds, **report,
                    "logits_shape": list(ref.shape),
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "logits_vs_packed_rel_err": packed_parity}, problems)


def phase_slice_rgcn():
    """examples/rgcn.py's run on the card at MUTAG-RDF's published size,
    through the fused operators: train_rgcn, every aggregation, forward
    and backward, through the packed-RGCN kernels. Per epoch 4 forward
    launches (2 per layer: the sender-major message walk and the
    receivers' segment sum) and 6 backward launches (3 per layer: the
    sender-major walk and the two steps of the datt reduction); the final
    evaluation adds 4 forward launches. The peak device memory of the
    captured run counts the graph's pool (the per-forward transposed copy
    of conv1's basis lives there). Test accuracy is printed, not gated:
    the synthetic labels are the parity of a degree, near chance out of
    sample."""
    ds, graph, _ = load("mutag")
    model, metrics, report, problems = run_main_path(
        "rgcn", {"packed_rgcn_fwd": 4, "packed_rgcn_bwd": 6},
        {"packed_rgcn_fwd": 4})
    # the trained model on the card (kernels) against the plain
    # embedding-gather and transform-first paths on the CPU, same weights
    from pytorch_geometric_tpu_torch.nn.conv import rgcn_norm

    card = logits_of("rgcn", model)
    g = graph.to("cpu")
    with torch.no_grad():
        ref = model.to("cpu")(g, norm=rgcn_norm(g, g.edge_type,
                                                 ds.num_relations))
    model.to(DEVICE)
    parity = _rel(card.cpu(), ref)
    loss0, loss1 = report["first_loss"], report["final_loss"]
    if not loss1 < 0.5 * loss0:
        problems.append(f"loss did not halve: {loss0} -> {loss1}")
    if not metrics["train_acc"] >= 0.9:
        problems.append(f"training accuracy {metrics['train_acc']} "
                        "(need >= 0.9)")
    if not (torch.isfinite(card).all() and parity <= 1e-4):
        problems.append(f"trained logits: card vs CPU rel err {parity}")
    return _finish({"phase": "slice_rgcn", "dataset": "mutag",
                    "synthetic": ds.is_synthetic, "nodes": graph.num_nodes,
                    "edges": graph.num_edges,
                    "real_nodes": int(graph.node_mask.sum()),
                    "real_edges": int(graph.edge_mask.sum()),
                    "relations": ds.num_relations, "bases": 30,
                    "train_entities": int(graph.extras["train_idx"].shape[1]),
                    "test_entities": int(graph.extras["test_idx"].shape[1]),
                    **report, "logits_shape": list(ref.shape),
                    "logits_cuda_vs_cpu_rel_err": parity}, problems)


def phase_slice_gcn(backend, phase):
    """bench_common.py's full-graph GCN on the card through ``backend``:
    "sorted" and "fused" on PubMed after RCM (Planetoid -> NormalizeFeatures
    -> reorder_graph -> from_data, N = 24576), "dense" and "hybrid" (the
    JAX ``pallas=True`` path: ``HybridSpmm``, windows of 512) on Cora.
    Launches per epoch: the sorted backend's segment sum 4, and 2 for the
    evaluation; the fused kernels twice each (two launches a call), and
    ``spmm_csr`` 2 for the evaluation (``bind_external``); the dense
    backend none; the hybrid backend ``spmm_csr`` 8, and 4 for the
    evaluation. The trained logits
    on the card against the plain path on the CPU (1e-4; the dense and
    hybrid backends 1e-2, bf16 operands), and the sorted backend's
    against the packed operator's on the card (1e-5)."""
    from pytorch_geometric_tpu_torch.models.citation import gcn_backend

    config = f"gcn_{backend}"
    per_epoch, evaluation = {}, {}
    if backend == "sorted":
        per_epoch, evaluation = ({"sorted_segment_sum": 4},
                                 {"sorted_segment_sum": 2})
    elif backend == "fused":
        per_epoch, evaluation = ({"fused_gcn_fwd": 2, "fused_gcn_bwd": 2},
                                 {"spmm_csr": 2})
    elif backend == "hybrid":
        # the dense and the sparse part: twice the packed backend's
        per_epoch, evaluation = {"spmm_csr": 8}, {"spmm_csr": 4}
    ds, graph, rcm_seconds = load(CONFIGS[config][2])
    model, metrics, report, problems = run_main_path(config, per_epoch,
                                                     evaluation)
    # the backend's host set-up, which train_gcn keeps out of its seconds
    t0 = time.perf_counter()
    gcn_backend(graph, backend, 16, ds.num_classes, model.dropout_rate)
    torch.cuda.synchronize()
    setup_seconds = time.perf_counter() - t0
    card = logits_of(config, model)
    packed = (logits_of(config, model, backend="packed")
              if backend == "sorted" else None)
    ref = logits_of(config, model, "cpu")
    model.to(DEVICE)
    parity = _rel(card.cpu(), ref)
    # the dense backend rounds x @ W to bf16 before each product (the
    # hybrid one before its dense part's), and the card and the CPU sum
    # x @ W in other orders: where a value sits on a bf16 rounding boundary
    # the two round it apart, by 2^-8 of it, so its gate is the bf16
    # tolerance
    tol = TOL["bf16"] if backend in ("dense", "hybrid") else 1e-4
    packed_parity = None if packed is None else _rel(card, packed)
    _accuracy_gate(metrics, problems)
    if not (torch.isfinite(card).all() and parity <= tol):
        problems.append(f"trained logits: card vs CPU rel err {parity}")
    if backend == "sorted" and not packed_parity <= 1e-5:
        problems.append(f"sorted slice: logits vs the packed operator "
                        f"{packed_parity} (need <= 1e-5)")
    return _finish({"phase": phase, "backend": backend, "dataset": ds.name,
                    "synthetic": ds.is_synthetic, "nodes": graph.num_nodes,
                    "edges": graph.num_edges, "rcm_seconds": rcm_seconds,
                    "backend_setup_seconds": setup_seconds, **report,
                    "logits_shape": list(ref.shape),
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "logits_cuda_vs_cpu_tol": tol,
                    "logits_vs_packed_rel_err": packed_parity}, problems)


def phase_slice_suite(name):
    """examples/citation_suite.py's run of ``name`` on the card:
    Planetoid Cora (with ``TargetIndegree`` for Spline) -> from_data ->
    ``train_suite`` (200 epochs, captured, then eager), every feature-row
    sum through ``spmm_csr`` or ``sorted_segment_sum``, launches as
    ``SUITE_LAUNCHES`` states them; the accuracy gate, and the trained
    model's logits on the card (its operators) against its plain path on
    the CPU (1e-4)."""
    per_epoch, evaluation, setup = SUITE_LAUNCHES[name]
    ds, graph, _ = load(CONFIGS[name][2])
    model, metrics, report, problems = run_main_path(name, per_epoch,
                                                     evaluation, setup)
    card = logits_of(name, model)
    ref = logits_of(name, model, "cpu")
    model.to(DEVICE)
    parity = _rel(card.cpu(), ref)
    _accuracy_gate(metrics, problems)
    if not (torch.isfinite(card).all() and parity <= 1e-4):
        problems.append(f"trained logits: card vs CPU rel err {parity}")
    return _finish({"phase": f"slice_{name}", "model": name,
                    "dataset": ds.name, "synthetic": ds.is_synthetic,
                    "nodes": graph.num_nodes, "edges": graph.num_edges,
                    "setup_seconds": metrics["setup_seconds"], **report,
                    "logits_shape": list(ref.shape),
                    "logits_cuda_vs_cpu_rel_err": parity}, problems)


def ppi_steps_logits(device, steps=3):
    """``(logits, model)``: a fresh ``Net`` of examples/ppi.py (from
    ``SEED``) after ``steps`` Adam steps over the first ``steps`` batches
    of the seeded train loader, then its logits on the first of them, all
    on ``device`` (the CPU runs the kernels' plain versions)."""
    from pytorch_geometric_tpu_torch.examples import ppi

    train, _ = ppi.load(SEED, device=device)
    batches = list(itertools.islice(train.indexed(), steps))
    model = ppi.Net(generator=torch.Generator().manual_seed(SEED)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    ops = ppi.OperatorCache()
    for idx, graph in batches:
        ppi.train_step(model, opt, graph, ops(idx, graph))
    idx, graph = batches[0]
    with torch.no_grad():
        return model(graph, graph.x, flash_op=ops(idx, graph)).cpu(), model


def phase_slice_ppi():
    """examples/ppi.py's run on the card at its full widths: PPI (20
    synthetic train graphs of ~2300 nodes, 2 val graphs) -> DataLoader
    (batches of 1 shuffled from SEED; the val graphs in one batch) ->
    ``run`` for 10 epochs as a user runs it, captured (the default: the
    training step and the prediction each a CUDA graph over static
    buffers of its loader's budget, every attention layer through the
    static ``PackedFlashGat`` into which each batch's operator, built
    once on the host and kept on the card, is copied), then eager
    (``capture=False``) on fresh loaders of the same seed
    (:func:`_capture_pair`: device launches as epochs x (train batches x
    3 forward + 6 backward, val batches x 3 forward) in both runs, every
    step's loss, the final parameters and the F1 bitwise). Every loss
    finite and the last epoch's mean below the first's; val micro-F1
    beside the all-positive predictor's (the synthetic labels come from a
    fresh projection per graph, so F1 is printed, not gated); each run's
    seconds and ms a step, the capture's seconds, the host ms a batch,
    the operators' host build seconds and the peak of device memory; and
    the logits after three steps from the same parameters and batches on
    the card against the plain path on the CPU (1e-4)."""
    from pytorch_geometric_tpu_torch.examples import ppi

    t0 = time.perf_counter()
    train, val = ppi.load(SEED, device=DEVICE)
    load_seconds = time.perf_counter() - t0
    batches = {"train": len(train), "val": len(val)}
    statement = {
        n: f"{PPI_EPOCHS} epochs x ({batches['train']} train batches x "
           f"{PPI_STEP_LAUNCHES[n]} + {batches['val']} val batch x "
           f"{PPI_EVAL_LAUNCHES.get(n, 0)})" for n in PPI_STEP_LAUNCHES}
    out, _, report, problems = _capture_pair(
        lambda capture: ppi.run(PPI_EPOCHS, SEED, DEVICE,
                                loaders=ppi.load(SEED, device=DEVICE),
                                capture=capture),
        PPI_STEP_LAUNCHES, PPI_EVAL_LAUNCHES, PPI_EPOCHS * batches["train"],
        PPI_EPOCHS * batches["val"], statement, "f1")
    ys, masks = [], []
    for graph in val:
        ys.append(graph.y.cpu().numpy())
        masks.append(graph.node_mask.cpu().numpy())
    y, mask = np.concatenate(ys), np.concatenate(masks)
    all_positive_f1 = ppi.micro_f1(np.ones_like(y), y, mask)
    card, card_model = ppi_steps_logits(DEVICE)
    cpu, cpu_model = ppi_steps_logits("cpu")
    cpu_params = dict(cpu_model.named_parameters())
    params_err = max(_rel(p.detach().cpu(), cpu_params[n].detach())
                     for n, p in card_model.named_parameters())
    parity = _rel(card, cpu)
    losses = out["step_losses"]
    epochs = out["epoch_losses"]
    _falling(epochs, problems)
    if not (torch.isfinite(card).all() and parity <= 1e-4):
        problems.append(f"logits after 3 steps: card vs CPU rel err "
                        f"{parity}")
    return _finish({"phase": "slice_ppi", "dataset": "PPI",
                    "synthetic": train.dataset.is_synthetic,
                    "epochs": PPI_EPOCHS, "batches": batches,
                    "train_budget": [train.num_nodes, train.num_edges],
                    "val_budget": [val.num_nodes, val.num_edges],
                    **report,
                    "ms_per_epoch": out["seconds"] / PPI_EPOCHS * 1e3,
                    "load_seconds": load_seconds,
                    "operators": out["operators"],
                    "operator_setup_seconds": out["operator_seconds"],
                    "epoch_losses": epochs,
                    "first_loss": float(losses[0, 0]),
                    "final_loss": float(losses[-1, -1]),
                    "val_f1": out["f1"], "all_positive_f1": all_positive_f1,
                    "logits_shape": list(cpu.shape),
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "params_cuda_vs_cpu_rel_err": params_err}, problems)


def faust_steps_logits(device, steps=3, num_vertices=684):
    """``(logits, model)``: a fresh ``Net`` of examples/faust.py (from
    ``SEED``) after ``steps`` Adam steps, dropout off, over the first
    ``steps`` batches of the seeded train loader at ``num_vertices``, then
    its logits on the first of them, all on ``device`` (the CPU runs the
    kernel's plain version)."""
    from pytorch_geometric_tpu_torch.examples import faust
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    train, _ = faust.load(SEED, num_vertices, device=device)
    batches = list(itertools.islice(train.indexed(), steps))
    model = faust.Net(train.dataset[0].num_nodes,
                      generator=torch.Generator().manual_seed(SEED)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    ops = OperatorCache(faust.faust_spline_op)
    for idx, graph in batches:
        faust.train_step(model, opt, graph, ops(idx, graph), train=False)
    idx, graph = batches[0]
    with torch.no_grad():
        return model(graph, spline_op=ops(idx, graph)).cpu(), model


def phase_slice_faust():
    """examples/faust.py's run on the card at its full widths (six
    SplineConv layers, dim 3, kernel size 5, K = 125: 1 -> 32 -> 64 x 5,
    Dense 256, one class per vertex) at FAUST's published template size:
    the synthetic meshes of 6,728 vertices (80 train, 20 test) ->
    ``Compose([FaceToEdge(), Cartesian()])`` -> DataLoader (batches of 1,
    shuffled from SEED) -> ``run`` for 3 epochs as a user runs it,
    captured (the default: the training step, dropout from the run's
    generator, and the evaluation each a CUDA graph over the static
    spline operator of the loader's budget, 1,024,000 x 8,192, into which
    each mesh's operator, built once on the host and kept on the card, is
    copied), then eager (``capture=False``) on fresh loaders of the same
    seed (:func:`_capture_pair`: device launches as epochs x (train
    batches x 11 + test batches x 6), one ``spmm_csr`` a layer forward
    and one ``dx`` a layer but conv1, in both runs; every step's loss,
    the final parameters and the accuracy bitwise). Every loss finite and
    the last epoch's mean below the first's; test accuracy beside chance
    (1 / vertices), not gated; ms a step in both runs, the host ms a
    batch, the operators' host build seconds and both peaks of device
    memory; and the logits after three steps (dropout off) on the card
    against the plain path on the CPU at the example's default 684
    vertices (1e-4)."""
    from pytorch_geometric_tpu_torch.examples import faust

    train, test = faust_loaders()
    load_seconds = faust_datasets()[2]
    nv = train.dataset[0].num_nodes
    batches = {"train": len(train), "test": len(test)}
    statement = {
        n: f"{FAUST_EPOCHS} epochs x ({batches['train']} train batches x "
           f"{FAUST_STEP_LAUNCHES[n]} (6 layers forward + 5 dx; conv1's "
           f"input takes no gradient) + {batches['test']} test batches x "
           f"{FAUST_EVAL_LAUNCHES[n]}; one launch a layer and direction, "
           "against 125 for the K square operators)"
        for n in FAUST_STEP_LAUNCHES}
    out, _, report, problems = _capture_pair(
        lambda capture: faust.run(FAUST_EPOCHS, SEED, FAUST_VERTICES, DEVICE,
                                  loaders=faust_loaders(), capture=capture),
        FAUST_STEP_LAUNCHES, FAUST_EVAL_LAUNCHES,
        FAUST_EPOCHS * batches["train"], FAUST_EPOCHS * batches["test"],
        statement, "acc")
    parity, params_err, finite, shape = _parity(faust_steps_logits)
    losses = out["step_losses"]
    epochs = out["epoch_losses"]
    _falling(epochs, problems)
    if not (finite and parity <= 1e-4):
        problems.append(f"logits after 3 steps: card vs CPU rel err "
                        f"{parity}")
    return _finish({"phase": "slice_faust", "dataset": "FAUST",
                    "synthetic": train.dataset.is_synthetic,
                    "vertices": nv, "padded_nodes": train.num_nodes,
                    "padded_edges": train.num_edges,
                    "epochs": FAUST_EPOCHS, "batches": batches, **report,
                    "ms_per_epoch": out["seconds"] / FAUST_EPOCHS * 1e3,
                    "load_seconds": load_seconds,
                    "operators": out["operators"],
                    "operator_setup_seconds": out["operator_seconds"],
                    "epoch_losses": epochs,
                    "first_loss": float(losses[0, 0]),
                    "final_loss": float(losses[-1, -1]),
                    "test_acc": out["acc"], "chance_acc": 1.0 / nv,
                    # the loss of the uniform prediction over nv classes
                    "uniform_loss": float(np.log(nv)),
                    "logits_shape": shape,
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "params_cuda_vs_cpu_rel_err": params_err}, problems)


def _parity(steps_fn, runs=None):
    """``steps_fn(device) -> (output, model)`` on the card and on the CPU
    (the kernels' plain versions): the output's error relative to the
    CPU's largest magnitude, and the parameters' largest error relative
    to the CPU model's largest parameter (a parameter whose gradient is
    rounding only, such as a bias before a batch norm, holds nothing but
    that rounding, so its own magnitude is no scale for it). ``runs``, a
    dict, keeps both runs (``card``, ``cpu``: output and model)."""
    card, card_model = steps_fn(DEVICE)
    cpu, cpu_model = steps_fn("cpu")
    if runs is not None:
        runs.update(card=(card, card_model), cpu=(cpu, cpu_model))
    cpu_params = dict(cpu_model.named_parameters())
    scale = max(float(p.detach().abs().max()) for p in cpu_params.values())
    params_err = max(float((p.detach().cpu() - cpu_params[n].detach())
                           .abs().max()) for n, p in
                     card_model.named_parameters()) / scale
    return _rel(card.cpu(), cpu), params_err, bool(
        torch.isfinite(card).all()), list(cpu.shape)


#: The card-against-CPU gates that hold a path after a few optimizer
#: steps (``_step_gate``), and the learning rate of their SGD steps. The
#: card and the CPU part in two ways that no kernel causes
#: (``probes/parity_tail.py`` shows both):
#: - the paths train with Adam (AdamW in the driver), whose first step
#:   moves each weight by about ``lr * sign(g)``: a gradient element
#:   within rounding of 0, whose sign the two set apart, moves by ``2 lr``
#:   on one and not the other. So the gate takes SGD steps, whose moves
#:   follow the gradients, at a rate that moves the parameters at least
#:   as far as the Adam steps do (both largest moves printed and
#:   checked);
#: - a ReLU or PReLU whose input lies within rounding of 0 takes one
#:   branch on the card and the other on the CPU, and that one element
#:   moves the gradients by up to 7e-4 of the largest. So the CPU's run
#:   takes the card's branch there (:class:`KinkRoutes`, over the
#:   modules of ``GATE_KINKS``), as the zoo's gate routes the CPU's
#:   maxima through the card's (``ZOO_MAX_CONVS``).
#: The gate holds the SGD steps' output and the first step's gradients,
#: which the kernels produce. The Adam runs stay covered on the card:
#: captured against eager bitwise, the loss falling.
GATE_SGD_LR = {"infomax": 0.03, "gae": 10.0, "vgae": 0.05, "topk": 0.03,
               "driver_gcn": 4.0, "driver_gat": 8.0}
#: The modules whose outputs enter a ReLU or PReLU on each gate's path
#: (the GAT's ELU has a continuous slope; TopK's pools and maxima, and the
#: dense layers after them, were never seen to part).
GATE_KINKS = {"infomax": ("dgi.encoder.GCNConv_0",), "gae": ("conv1",),
              "vgae": ("conv1",), "driver_gcn": ("layers_0", "layers_1")}


class KinkRoutes:
    """The branches the card takes at a gate's ReLU and PReLU kinks: the
    first model it is attached to (the card's run) records the sign of
    each output of the gate's ``GATE_KINKS`` modules, call by call; the
    second (the CPU's) moves each output element that lies on the other
    side of 0 to the card's side (0, or the least positive float) with
    its gradient passed through unchanged, so that the CPU's forward and
    backward take the card's branch there. ``routed`` counts the moved
    elements."""

    def __init__(self):
        self.signs, self.calls, self.routed = None, 0, 0

    def attach(self, model, gate):
        names = GATE_KINKS.get(gate, ())
        if not names:
            return
        record = self.signs is None
        if record:
            self.signs = []
        modules = dict(model.named_modules())
        for name in names:
            modules[name].register_forward_hook(
                self._record if record else self._route)

    def _record(self, module, args, out):
        self.signs.append((out.detach() > 0).cpu())

    def _route(self, module, args, out):
        card = self.signs[self.calls].to(out.device)
        self.calls += 1
        flip = card != (out.detach() > 0)
        self.routed += int(flip.sum())
        side = torch.where(card, torch.finfo(out.dtype).tiny, 0.0)
        # the value exactly ``side`` (``out + (side - out)`` would round
        # the least positive float away), the gradient ``out``'s
        return torch.where(flip, side + (out - out.detach()), out)


def gate_optimizer(kind, model, lr, gate, adam=torch.optim.Adam,
                   routes=None):
    """The optimizer of a gate's steps over ``model``'s parameters:
    ``"adam"``, the path's own (``adam`` at ``lr``), or ``"sgd"`` at
    ``GATE_SGD_LR[gate]``. The model keeps its parameters before the steps
    (``gate_start``) and its gradients at the first step (``gate_grads``,
    recorded by a hook before the optimizer's first step); ``routes``, a
    :class:`KinkRoutes`, is attached to it."""
    if kind not in ("adam", "sgd"):
        raise ValueError(f"optimizer {kind!r}: adam or sgd")
    if routes is not None:
        routes.attach(model, gate)
    model.gate_start = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
    model.gate_grads = None
    opt = adam(model.parameters(), lr=lr) if kind == "adam" else \
        torch.optim.SGD(model.parameters(), lr=GATE_SGD_LR[gate])

    def first(optimizer, args, kwargs):
        if model.gate_grads is None:
            model.gate_grads = {
                n: (p.grad.detach().clone() if p.grad is not None
                    else torch.zeros_like(p))
                for n, p in model.named_parameters()}

    opt.register_step_pre_hook(first)
    return opt


def largest_move(model):
    """The largest change of a parameter over a gate's steps."""
    return max(float((p.detach() - model.gate_start[n]).abs().max())
               for n, p in model.named_parameters())


def grads_gap(card_model, cpu_model):
    """The first step's gradients, card against CPU: the largest error
    relative to the largest CPU gradient."""
    cpu = cpu_model.gate_grads
    scale = max(float(g.abs().max()) for g in cpu.values())
    return max(float((g.cpu() - cpu[n]).abs().max())
               for n, g in card_model.gate_grads.items()) / max(scale, 1e-30)


def step_gate(gate, widths=None):
    """``(steps_fn(device, optimizer) -> (output, model), tolerance,
    output name)`` of a gate over optimizer steps: ``infomax``
    (``slice_infomax``), ``gae`` and ``vgae`` (``slice_autoencoder``),
    ``topk`` (``slice_topk``), ``driver_gcn`` and ``driver_gat``
    (``slice_driver``, ``slice_driver_gat``; at ``widths``, default those
    ``training_net`` draws for Cora)."""
    if gate == "infomax":
        return infomax_steps_z, INFOMAX_PARITY_TOL, "z"
    if gate in ("gae", "vgae"):
        return (functools.partial(autoencoder_steps_z,
                                  variational=gate == "vgae"),
                AUTOENCODER_PARITY_TOL, "z")
    if gate == "topk":
        return (functools.partial(graph_steps_output, "topk"),
                GRAPH_PARITY_TOL, "output")
    if gate in ("driver_gcn", "driver_gat"):
        from pytorch_geometric_tpu_torch.research.pruning import (
            contraction_layer_coefficients)

        name = gate.split("_")[1].upper()
        if widths is None:
            widths = contraction_layer_coefficients(1433, 2, 0.5, seed=0)
        return (functools.partial(driver_steps_logits, name, widths=widths),
                DRIVER_PARITY_TOL[name], "logits")
    raise ValueError(f"unknown gate {gate!r}")


def _step_gate(steps_fn, tol, what, problems):
    """A card-against-CPU gate over optimizer steps
    (``steps_fn(device, optimizer) -> (output, model)``, the model from
    :func:`gate_optimizer`): the SGD steps' output (and parameters), card
    against CPU, within ``tol`` of the CPU's largest magnitude; the first
    step's gradients within ``tol`` of the largest CPU gradient; the CPU
    taking the card's branch at the path's kinks (:class:`KinkRoutes`);
    the SGD steps' largest move at least the Adam steps' on the card.
    Returns the report's keys."""
    runs, routes = {}, KinkRoutes()
    err, params_err, finite, shape = _parity(
        functools.partial(steps_fn, optimizer="sgd", routes=routes), runs)
    grads_err = grads_gap(runs["card"][1], runs["cpu"][1])
    sgd_move = largest_move(runs["card"][1])
    adam_move = largest_move(steps_fn(DEVICE, optimizer="adam")[1])
    if not (finite and err <= tol):
        problems.append(f"{what} after the SGD steps: card vs CPU rel err "
                        f"{err} (tolerance {tol})")
    if not grads_err <= tol:
        problems.append(f"first step's gradients: card vs CPU rel err "
                        f"{grads_err} (tolerance {tol})")
    if not sgd_move >= adam_move:
        problems.append(f"the SGD steps move the parameters by at most "
                        f"{sgd_move}, less than the Adam steps' {adam_move}")
    return {f"{what}_shape": shape,
            f"{what}_cuda_vs_cpu_rel_err": err,
            "params_cuda_vs_cpu_rel_err": params_err,
            "step1_grads_cuda_vs_cpu_rel_err": grads_err,
            "kinks_routed": routes.routed, "gate_tolerance": tol,
            "sgd_largest_move": sgd_move, "adam_largest_move": adam_move}


def _example_run(run, expected, statement):
    """``run()`` with its printed lines kept, the launches read over it
    against ``expected`` (or ``expected(out)``), the peak of device
    memory: ``(out, report, problems)``."""
    import contextlib
    import io

    from pytorch_geometric_tpu_torch.models.capture import launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    before = launch_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {n: v - before[n] for n, v in launch_counts().items()}
    if callable(expected):
        expected = expected(out)
    expected = {n: expected.get(n, 0) for n in launches}
    problems = []
    if launches != expected:
        problems.append(f"launches {launches}, expected {expected}")
    report = {"printed": printed.getvalue().splitlines(),
              "launches": {n: v for n, v in launches.items() if v},
              "expected_launches": {n: v for n, v in expected.items() if v},
              "launch_statement": statement,
              "max_memory_allocated": peak, "run_peak_bytes": peak - start,
              "seconds": out["seconds"]}
    return out, report, problems


def _capture_pair(run, step, evaluation, steps, evals, statement, metric):
    """An inductive example's run as a user runs it (``run(None)``:
    captured, the default on a card) and then eager (``run(False)``),
    each on fresh loaders from the same seed, so both see the same
    batches in the same order. ``step`` and ``evaluation`` are the
    launches of one training step and one evaluation batch; ``steps`` and
    ``evals`` their counts over the run. The captured run's device
    launches (captured step x replays + warm-up, for the training step
    and the evaluation, ``device_launches``) must equal the eager run's
    count, ``steps x step + evals x evaluation``, its wrapper calls the
    warm-ups' and the captures', and its launches by stage the step's
    and the evaluation's, its calls (warm-up and replays) of the training
    steps ``steps`` and of the evaluation steps ``evals`` (a run may hold
    one of each a batch size, ``train_<size>``); every step's loss, the
    final parameters
    and buffers, and the test metric (the run's key ``metric``) bitwise
    equal to the eager run's. The host's ms a batch are split into
    the collation, the operators' build (and, where the run reports it,
    its level geometry's share) and the copies. ``(captured out, eager
    out, report, problems)``."""
    names = set(step) | set(evaluation)
    expected = {n: steps * step.get(n, 0) + evals * evaluation.get(n, 0)
                for n in names}

    def calls(out):
        return {n: sum(2 * (step if k.startswith("train") else evaluation)
                       .get(n, 0) for k in out["launches"]) for n in names}

    statement = {n: f"{v} = {expected[n]}" for n, v in statement.items()}
    out, report, problems = _example_run(lambda: run(None), calls,
                                         statement)
    report["wrapper_calls"] = report.pop("launches")
    report["expected_wrapper_calls"] = report.pop("expected_launches")
    ran = out["device_launches"]
    report["launches"] = ran
    report["expected_launches"] = expected
    if ran != expected:
        problems.append(f"captured run: device launches {ran}, expected "
                        f"{expected}")
    step_calls = {"train": 0, "evaluation": 0}
    for name, stages in out["launches"].items():
        kind = "train" if name.startswith("train") else "evaluation"
        per = step if kind == "train" else evaluation
        step_calls[kind] += stages["replays"] + 1
        if stages["warm_up"] != per or stages["captured"] != per:
            problems.append(f"launches by stage of {name} {stages}, "
                            f"expected {per} in its warm-up and capture")
    if step_calls != {"train": steps, "evaluation": evals}:
        problems.append(f"calls of the captured steps {step_calls}, "
                        f"expected {steps} training and {evals} evaluation")
    eager, eager_report, eager_problems = _example_run(
        lambda: run(False), expected, statement)
    problems += [f"eager run: {p}" for p in eager_problems]
    losses, eager_losses = out["step_losses"], eager["step_losses"]
    loss_err = float(np.abs(losses - eager_losses).max()
                     / np.abs(eager_losses).max())
    ref = dict(eager["model"].state_dict())
    scale = max(float(v.abs().max()) for v in ref.values()
                if v.is_floating_point())
    state_err = max(float((v - ref[k]).abs().max())
                    for k, v in out["model"].state_dict().items()
                    if v.is_floating_point()) / scale
    report["captured_vs_eager_metric"] = [out[metric], eager[metric]]
    if not (loss_err == 0.0 and state_err == 0.0
            and out[metric] == eager[metric]):
        problems.append(f"captured vs eager not bitwise: step losses "
                        f"{loss_err}, parameters and buffers {state_err}, "
                        f"{metric} {out[metric]} against {eager[metric]}")
    batches = out["host_batches"]
    report.update({f"host_{k}_ms_per_batch": out[f"host_{k}_seconds"]
                   / batches * 1e3 for k in ("copy", "geometry")
                   if f"host_{k}_seconds" in out})
    if "host_geometry_seconds" in out:
        report["host_operator_build_ms_per_batch"] = (
            out["host_operator_seconds"] - out["host_geometry_seconds"]) \
            / batches * 1e3
    report.update({
        "ms_per_step": (out["seconds"] - out["capture_seconds"]) / steps
        * 1e3,
        "capture_seconds": out["capture_seconds"],
        "host_ms_per_batch": out["host_seconds"] / out["host_batches"]
        * 1e3,
        "host_collate_ms_per_batch": out["host_collate_seconds"]
        / out["host_batches"] * 1e3,
        "host_operator_ms_per_batch": out["host_operator_seconds"]
        / out["host_batches"] * 1e3,
        "launch_stages": out["launches"],
        "eager_seconds": eager["seconds"],
        "eager_ms_per_step": eager["seconds"] / steps * 1e3,
        "eager_launches": eager_report["launches"],
        "eager_run_peak_bytes": eager_report["run_peak_bytes"],
        "eager_printed": eager_report["printed"],
        "captured_vs_eager_step_loss_rel_err": loss_err,
        "captured_vs_eager_state_rel_err": state_err})
    return out, eager, report, problems


def _stage_calls(launches):
    """The wrapper calls a captured run of spans makes
    (``EpochSpans.launches``): its warm-up's, its capture's and its host
    work's."""
    total = {}
    for stage in ("warm_up", "captured_epoch", "evaluation"):
        for name, v in launches[stage].items():
            total[name] = total.get(name, 0) + v
    return total


def _bitwise(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (np.ndarray, list, tuple)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _span_pair(run, expected, statement, epochs, outputs):
    """A full-batch run as a user runs it (``run(None)``: its epochs
    captured, the default on a card; ``models/capture.py:EpochSpans``)
    and then eager (``run(False)``) from the same seed. ``expected`` is
    the eager run's count of launches; the captured run's device launches
    (captured epoch x replays + warm-up + the host work between the
    spans, its ``device_launches``) must equal it, and its wrapper calls
    its warm-up's, capture's and host work's (``launches`` by stage).
    ``outputs(out)`` names what must be bitwise equal in the two runs:
    every epoch's loss, the final parameters, the metrics. Each run's ms
    an epoch: the replays' (captured) and the epochs' (eager), the host
    work between spans left out. ``(captured out, eager out, report,
    problems)``."""
    statement = {n: f"{v} = {expected[n]}" for n, v in statement.items()}
    out, report, problems = _example_run(
        lambda: run(None), lambda o: _stage_calls(o["launches"]), statement)
    report["wrapper_calls"] = report.pop("launches")
    report["expected_wrapper_calls"] = report.pop("expected_launches")
    ran = out["device_launches"]
    report["launches"], report["expected_launches"] = ran, expected
    if ran != expected:
        problems.append(f"captured run: device launches {ran}, expected "
                        f"{expected}")
    eager, eager_report, eager_problems = _example_run(
        lambda: run(False), expected, statement)
    problems += [f"eager run: {p}" for p in eager_problems]
    got, want = outputs(out), outputs(eager)
    differ = [k for k in want if not _bitwise(got[k], want[k])]
    if differ:
        problems.append(f"captured vs eager not bitwise: {differ}")
    replays = out["launches"]["replays"]
    report.update({
        "captured_vs_eager_bitwise": sorted(want) if not differ else [],
        "ms_per_epoch": (out["seconds"] - out["capture_seconds"])
        / max(replays, 1) * 1e3,
        "capture_seconds": out["capture_seconds"],
        "between_seconds": out["between_seconds"],
        "launch_stages": out["launches"],
        "eager_seconds": eager["seconds"],
        "eager_ms_per_epoch": eager["seconds"] / epochs * 1e3,
        "eager_between_seconds": eager["between_seconds"],
        "eager_launches": eager_report["launches"],
        "eager_run_peak_bytes": eager_report["run_peak_bytes"],
        "eager_printed": eager_report["printed"]})
    return out, eager, report, problems


def _falling(losses, problems, what="epoch"):
    losses = np.asarray(losses)
    if not np.isfinite(losses).all():
        problems.append("non-finite training loss")
    elif not losses[-1] < losses[0]:
        problems.append(f"last {what}'s loss {losses[-1]} not below the "
                        f"first's {losses[0]}")


def mutag_steps_logits(device, steps=3):
    """``(logits, model)``: a fresh ``Net`` of examples/mutag_gin.py (from
    ``SEED``) after ``steps`` SGD steps (lr 0.01, the script's; Adam's
    first steps move the biases before each batch norm, whose gradient is
    0 up to rounding, by +-lr on the sign of that rounding) over the
    first batches of the seeded train loader, then its logits (running
    statistics) on the first of them."""
    from pytorch_geometric_tpu_torch.examples import mutag_gin
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    train, _ = mutag_gin.load(SEED, device=device)
    batches = list(itertools.islice(train.indexed(), steps))
    model = mutag_gin.Net(generator=torch.Generator().manual_seed(
        SEED)).to(device)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    ops = OperatorCache(mutag_gin.mutag_operators)
    for idx, graph in batches:
        mutag_gin.train_step(model, opt, graph, ops(idx, graph))
    idx, graph = batches[0]
    with torch.no_grad():
        return model(graph, **ops(idx, graph)), model


def phase_slice_mutag_gin():
    """examples/mutag_gin.py's run on the card at its full width and
    defaults: five GINConv over MLPs 7 -> 32 -> 32 with MaskedBatchNorm
    and a trained eps, global_add_pool, Dense 32 and Dense 2; Adam 0.01,
    batches of 32, 30 epochs over the synthetic MUTAG (188 graphs of ~18
    nodes, 7 labels, 2 classes; 169 train, 18 test), as a user runs it,
    captured (the default: the training step and the evaluation each a
    CUDA graph over static buffers of its loader's budget; each batch's
    operator set, ``mutag_operators`` over its real edges, built on the
    host and copied in through pinned memory), then eager
    (``capture=False``) on fresh loaders of the same seed
    (:func:`_capture_pair`: device launches as epochs x (train batches x
    10 + test batches x 6) in both runs, every step's loss, the final
    parameters and running statistics and the accuracy bitwise). Every
    loss finite and
    the last epoch's mean below the first's; test accuracy beside the
    majority class's (not gated); each run's seconds and ms a step, the
    capture's seconds, the host ms a batch (collation, the operators'
    build, the copies), the operator sets built and their host seconds;
    and the logits after three steps, card against the plain path on the
    CPU (1e-4)."""
    from pytorch_geometric_tpu_torch.examples import mutag_gin

    train, test = mutag_gin.load(SEED, device=DEVICE)
    batches = {"train": len(train), "test": len(test)}
    statement = {
        n: f"{MUTAG_EPOCHS} epochs x ({batches['train']} train batches x "
           f"{MUTAG_STEP_LAUNCHES[n]} + {batches['test']} test batch x "
           f"{MUTAG_EVAL_LAUNCHES[n]})" for n in MUTAG_STEP_LAUNCHES}
    out, _, report, problems = _capture_pair(
        lambda capture: mutag_gin.run(
            MUTAG_EPOCHS, 32, SEED, DEVICE,
            loaders=mutag_gin.load(SEED, device=DEVICE), capture=capture),
        MUTAG_STEP_LAUNCHES, MUTAG_EVAL_LAUNCHES,
        MUTAG_EPOCHS * batches["train"], MUTAG_EPOCHS * batches["test"],
        statement, "acc")
    _falling(out["epoch_losses"], problems)
    ys = np.concatenate([g.y[g.graph_mask].cpu().numpy() for g in test])
    majority = float(max(np.mean(ys == 0), np.mean(ys == 1)))
    parity, params_err, finite, shape = _parity(mutag_steps_logits)
    if not (finite and parity <= 1e-4):
        problems.append(f"logits after 3 steps: card vs CPU rel err "
                        f"{parity}")
    steps = MUTAG_EPOCHS * batches["train"]
    return _finish({"phase": "slice_mutag_gin", "dataset": "MUTAG",
                    "epochs": MUTAG_EPOCHS, "batches": batches,
                    "budget": [train.num_nodes, train.num_edges,
                               train.num_graphs],
                    "test_budget": [test.num_nodes, test.num_edges,
                                    test.num_graphs],
                    **report,
                    "ms_per_epoch": out["seconds"] / MUTAG_EPOCHS * 1e3,
                    "ms_per_step_with_its_share_of_evaluation":
                        out["seconds"] / steps * 1e3,
                    "operators": out["operators"],
                    "operator_setup_seconds": out["operator_seconds"],
                    "epoch_losses": out["epoch_losses"],
                    "first_loss": float(out["step_losses"][0, 0]),
                    "final_loss": float(out["step_losses"][-1, -1]),
                    "test_acc": out["acc"], "majority_acc": majority,
                    "logits_shape": shape,
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "params_cuda_vs_cpu_rel_err": params_err}, problems)


def graph_steps_output(name, device, steps=3, optimizer="sgd",
                       routes=None):
    """``(output, model)`` of a graph-level example after ``steps`` of its
    training step from ``SEED`` over the first batches of its seeded
    loader (dropout off; DiffPool by SGD 0.1, whose L2-normalised convs'
    biases, like mutag's, have gradients of rounding only; TopK by
    ``optimizer``, :func:`gate_optimizer`), then its output on the first
    batch."""
    import importlib

    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    m = importlib.import_module(f"pytorch_geometric_tpu_torch.examples."
                                f"{GRAPH_EXAMPLES[name][0]}")
    gen = torch.Generator().manual_seed(SEED)
    if name == "diff_pool":
        train, _ = m.load(SEED, device=device)
        batches = list(itertools.islice(iter(train), steps))
        model = m.DiffPoolNet(3, 6, generator=gen).to(device)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        for b in batches:
            m.train_step(model, opt, b)
        b = batches[0]
        with torch.no_grad():
            return model(b.x, b.adj, b.mask)[0], model
    if name == "topk":
        train, _ = m.load(SEED, device=device)
        model, ops = m.Net(3, 6, generator=gen), OperatorCache(
            m.mutag_operators)
        lr, extra = 5e-4, {"train": False}
    else:
        train, _, mean, std = m.load(SEED, device=device)
        model, ops = m.Net(generator=gen), OperatorCache(m.qm9_operators)
        lr, extra = 1e-3, {"mean": mean, "std": std}
    model = model.to(device)
    opt = gate_optimizer(optimizer, model, lr, "topk", routes=routes) \
        if name == "topk" \
        else torch.optim.Adam(model.parameters(), lr=lr)
    batches = list(itertools.islice(train.indexed(), steps))
    for idx, graph in batches:
        m.train_step(model, opt, graph, ops(idx, graph), **extra)
    idx, graph = batches[0]
    with torch.no_grad():
        return model(graph, **ops(idx, graph)), model


def phase_slice_graph(name):
    """A graph-level example's run on the card at its full width and
    default epochs (enzymes_topk_pool: GraphConv 128 and TopK 0.8 three
    times, max ‖ mean readouts, 20 epochs over the synthetic ENZYMES;
    enzymes_diff_pool: DenseSAGEConv blocks and two dense_diff_pool
    levels over ToDense(126) batches, 8 epochs; qm9_nn_conv: NNConv mean
    + GRU x 3 + Set2Set(3), dim 64, 5 epochs over 1000 synthetic
    molecules), one operator set a batch built on the host (QM9's over
    the batch's real edges and nodes; DiffPool has none): captured, then
    eager, bitwise equal (:func:`_capture_pair`: every step's loss, the
    final parameters and the accuracy or MAE; DiffPool one captured step
    a batch size). The launches asserted (``GRAPH_EXAMPLES``), the loss
    falling, and the output after three steps, card against the plain
    path on the CPU (``GRAPH_PARITY_TOL``; TopK's steps through
    :func:`_step_gate`, which also holds the first step's
    gradients)."""
    import importlib

    module_name, epochs, step, evaluation = GRAPH_EXAMPLES[name]
    m = importlib.import_module(
        f"pytorch_geometric_tpu_torch.examples.{module_name}")
    loaders = m.load(SEED, device=DEVICE)
    train, test = loaders[:2]
    batches = {"train": len(train), "test": len(test)}
    statement = {
        n: f"{epochs} epochs x ({batches['train']} train batches x "
           f"{step.get(n, 0)} + {batches['test']} test batches x "
           f"{evaluation.get(n, 0)})" for n in set(step) | set(evaluation)}
    out, _, report, problems = _capture_pair(
        lambda capture: m.run(epochs, seed=SEED, device=DEVICE,
                              loaders=m.load(SEED, device=DEVICE),
                              capture=capture),
        step, evaluation, epochs * batches["train"],
        epochs * batches["test"], statement, CAPTURED_EXAMPLES[name])
    if not statement:
        report["launch_statement"] = \
            "no kernel of the port: dense batched products only"
    _falling(out["epoch_losses"], problems)
    if name == "topk":
        gate = _step_gate(*step_gate("topk")[:2], "output", problems)
    else:
        parity, params_err, finite, shape = _parity(
            lambda dev: graph_steps_output(name, dev))
        if not (finite and parity <= GRAPH_PARITY_TOL):
            problems.append(f"output after 3 steps: card vs CPU rel err "
                            f"{parity}")
        gate = {"output_shape": shape, "output_cuda_vs_cpu_rel_err": parity,
                "params_cuda_vs_cpu_rel_err": params_err}
    metric = {k: out[k] for k in ("acc", "mae") if k in out}
    return _finish({"phase": f"slice_{name}", "example": module_name,
                    "epochs": epochs, "batches": batches, **report,
                    "ms_per_epoch": out["seconds"] / epochs * 1e3,
                    "operators": out.get("operators", 0),
                    "operator_setup_seconds": out.get("operator_seconds",
                                                      0.0),
                    "epoch_losses": out["epoch_losses"], **metric,
                    **gate}, problems)


def autoencoder_steps_z(device, variational, steps=3, optimizer="sgd",
                        routes=None):
    """``(z, encoder)``: examples/autoencoder.py's encoder (from ``SEED``)
    after ``steps`` steps of ``optimizer`` (:func:`gate_optimizer`: the
    script's Adam 0.01, or SGD), the VGAE's noise drawn on the CPU and
    handed in, then its embeddings (mu for the VGAE)."""
    from pytorch_geometric_tpu_torch.examples import autoencoder as ae_ex
    from pytorch_geometric_tpu_torch.models.citation import (
        gcn_spmm_operator)
    from pytorch_geometric_tpu_torch.nn.models import (
        GAE, VGAE, negative_sampling)

    data, graph = ae_ex.load(SEED, device=device)
    op, w = gcn_spmm_operator(graph)
    fn = op.bind(w)
    enc = ae_ex.Encoder(graph.num_node_features, variational=variational,
                        generator=torch.Generator().manual_seed(SEED))
    enc = enc.to(device)
    ae = VGAE(enc) if variational else GAE(enc)
    pos_s, pos_r = data.train_pos_edge_index
    pos = ae_ex.gathers(pos_s, pos_r, graph.num_nodes, device)
    neg = ae_ex.gathers(*negative_sampling(
        pos_s, pos_r, data.num_nodes, len(pos_s), seed=SEED + 1),
        graph.num_nodes, device)
    opt = gate_optimizer(optimizer, enc, 0.01,
                         "vgae" if variational else "gae", routes=routes)
    noise = torch.Generator().manual_seed(SEED)
    for _ in range(steps):
        eps = torch.randn((graph.num_nodes, 16), generator=noise)
        opt.zero_grad()
        ae_ex.loss_of(ae, enc, graph, pos, neg, fn,
                      noise=eps.to(device)).backward()
        opt.step()
    with torch.no_grad():
        z = enc(graph, graph.x, fn)
    return (z[0] if variational else z), enc


def phase_slice_autoencoder():
    """examples/autoencoder.py's run on the card, GAE and then
    ``--variational`` (GCN 1433 -> 32 -> 16 over Cora's train positives,
    Adam 0.01, 100 epochs, AUC and AP every 20), as a user runs it
    (captured: one epoch replayed up to each test) and then eager
    (:func:`_span_pair`: every epoch's loss, the encoder, AUC and AP
    bitwise): launches asserted as epochs x (2 layers forward + 2 back;
    the VGAE 3 + 3) + 5 tests x 2 (3) ``spmm_csr``, and epochs x 4
    segment sums (the backward of the decoder's gathers, which sum in a
    fixed order where torch's gather backward scatters with atomics);
    the loss falling; the embeddings
    after three SGD steps and the first step's gradients, card against
    the plain path on the CPU (:func:`_step_gate`,
    ``AUTOENCODER_PARITY_TOL``)."""
    from pytorch_geometric_tpu_torch.examples import autoencoder as ae_ex

    loaded = ae_ex.load(SEED, device=DEVICE)
    runs, problems = {}, []
    for variational in (False, True):
        key = "vgae" if variational else "gae"
        per_epoch, per_test = AUTOENCODER_LAUNCHES[variational]
        tests = AUTOENCODER_EPOCHS // 20
        want = {n: AUTOENCODER_EPOCHS * v + tests * per_test.get(n, 0)
                for n, v in per_epoch.items()}
        out, _, report, more = _span_pair(
            lambda capture: ae_ex.run(variational, AUTOENCODER_EPOCHS, SEED,
                                      DEVICE, loaded=loaded,
                                      capture=capture),
            want,
            {n: f"{AUTOENCODER_EPOCHS} epochs x {v} + {tests} tests x "
                f"{per_test.get(n, 0)}" for n, v in per_epoch.items()},
            AUTOENCODER_EPOCHS,
            lambda o: {"losses": o["losses"],
                       "encoder": o["model"].state_dict(),
                       "auc": o["auc"], "ap": o["ap"]})
        _falling(out["losses"], more)
        gate = _step_gate(*step_gate(key)[:2], "z", more)
        problems += [f"{key}: {p}" for p in more]
        runs[key] = {
            **report, "auc": out["auc"], "ap": out["ap"],
            "first_loss": float(out["losses"][0]),
            "final_loss": float(out["losses"][-1]),
            "operator_setup_seconds": out["operator_seconds"], **gate}
    launches = {n: sum(r["launches"].get(n, 0) for r in runs.values())
                for n in ("spmm_csr", "sorted_segment_sum")}
    return _finish({"phase": "slice_autoencoder", "epochs":
                    AUTOENCODER_EPOCHS, "launches": launches, **runs},
                   problems)


#: Card-against-CPU tolerance of the infomax embeddings after three
#: steps (``slice_infomax``).
INFOMAX_PARITY_TOL = 1e-4


def infomax_steps_z(device, steps=3, optimizer="sgd", routes=None):
    """``(z, model)``: examples/infomax.py's model (from ``SEED``, hidden
    512) after ``steps`` steps of ``optimizer`` (:func:`gate_optimizer`:
    the script's Adam 1e-3, or SGD), each corruption's permutation drawn
    on the CPU and handed in, then the embeddings."""
    from pytorch_geometric_tpu_torch.examples import infomax
    from pytorch_geometric_tpu_torch.models.citation import (
        gcn_spmm_operator)

    graph = infomax.load(device=device)
    op, w = gcn_spmm_operator(graph)
    fn = op.bind(w)
    perms = torch.Generator().manual_seed(SEED)

    def corruption(g, x, _):
        perm = torch.randperm(x.shape[0], generator=perms)
        return g, x[perm.to(x.device)]

    model = infomax.Model(graph.num_node_features, 512, corruption,
                          generator=torch.Generator().manual_seed(SEED))
    model = model.to(device)
    opt = gate_optimizer(optimizer, model, 1e-3, "infomax", routes=routes)
    for _ in range(steps):
        opt.zero_grad()
        model(graph, graph.x, None, fn)[0].backward()
        opt.step()
    with torch.no_grad():
        return model.dgi.encoder(graph, graph.x, fn), model


def phase_slice_infomax():
    """examples/infomax.py's run on the card at its full width (GCN 1433
    -> 512 with a PReLU, the bilinear discriminator, Adam 1e-3, 50
    epochs on Cora) and the port's logistic-regression probe, as a user
    runs it (captured: one epoch, the permutation drawn inside it,
    replayed in spans of 10) and then eager (:func:`_span_pair`: every
    epoch's loss, the model and the probe's accuracy bitwise): launches
    asserted as epochs x 4 (the encoder on the graph and on its
    corruption, forward and back) + 2 (the embeddings); the loss
    falling; the probe's accuracy printed; the embeddings after three
    SGD steps and the first step's gradients, card against the plain
    path on the CPU (:func:`_step_gate`, ``INFOMAX_PARITY_TOL``)."""
    from pytorch_geometric_tpu_torch.examples import infomax

    graph = infomax.load(device=DEVICE)
    per_epoch, final = INFOMAX_LAUNCHES
    want = INFOMAX_EPOCHS * per_epoch + final
    out, _, report, problems = _span_pair(
        lambda capture: infomax.run(INFOMAX_EPOCHS, SEED, 512, DEVICE,
                                    graph=graph, capture=capture),
        {"spmm_csr": want},
        {"spmm_csr": f"{INFOMAX_EPOCHS} epochs x {per_epoch} + {final}"},
        INFOMAX_EPOCHS,
        lambda o: {"losses": o["losses"], "model": o["model"].state_dict(),
                   "probe_acc": o["acc"]})
    _falling(out["losses"], problems)
    gate = _step_gate(*step_gate("infomax")[:2], "z", problems)
    return _finish({"phase": "slice_infomax", "epochs": INFOMAX_EPOCHS,
                    **report, "probe_acc": out["acc"],
                    "first_loss": float(out["losses"][0]),
                    "final_loss": float(out["losses"][-1]),
                    "operator_setup_seconds": out["operator_seconds"],
                    **gate}, problems)


def _zoo_cases(f, c, gen):
    """(name, graph, conv, its operators on a graph, input kind) of the
    zoo phase: Part B's convs and the suite's, at Cora's width f -> c."""
    from pytorch_geometric_tpu_torch.models.citation import gcn_spmm_operator
    from pytorch_geometric_tpu_torch.nn import conv as tc
    from pytorch_geometric_tpu_torch.nn.layers import Dense
    from pytorch_geometric_tpu_torch.nn.message_passing import (
        propagate_operators)

    def mlp(i, o):
        return torch.nn.Sequential(Dense(i, o, generator=gen),
                                   torch.nn.ReLU(),
                                   Dense(o, o, generator=gen))

    def gcn_bound(g):
        op, w = gcn_spmm_operator(g)
        return {"aggregate_fn": op.bind(w)}

    def segment_op(g):
        return {"segment_op": propagate_operators(g)["segment_op"]}

    none = lambda g: {}   # noqa: E731
    return [
        ("GraphConv", "cora", tc.GraphConv(f, c, generator=gen),
         propagate_operators, "x"),
        ("GINConv", "cora", tc.GINConv(mlp(f, c), eps=0.1, train_eps=True),
         propagate_operators, "x"),
        ("SAGEConv", "cora", tc.SAGEConv(f, c, generator=gen),
         propagate_operators, "x"),
        ("DenseSAGEConv", "cora", tc.DenseSAGEConv(f, c, generator=gen),
         none, "dense"),
        ("ChebConv", "cora", tc.ChebConv(f, c, K=3, generator=gen),
         lambda g: {"lap_fn": tc.cheb_operator(g)}, "x"),
        ("NNConv", "cora_spline",
         tc.NNConv(f, c, Dense(1, f * c, generator=gen), generator=gen),
         segment_op, "x"),
        ("EdgeConv", "cora", tc.EdgeConv(Dense(2 * f, c, generator=gen)),
         none, "x"),
        ("PointConv", "cora", tc.PointConv(Dense(f + 3, c, generator=gen),
                                           Dense(c, c, generator=gen)),
         none, "points"),
        ("SGConv", "cora", tc.SGConv(f, c, K=2, generator=gen), gcn_bound,
         "x"),
        ("AGNNConv", "cora", tc.AGNNConv(), tc.agnn_operators, "x"),
        ("ARMAConv", "cora", tc.ARMAConv(f, c, num_stacks=3, num_layers=2,
                                         shared_weights=True, generator=gen),
         lambda g: {"lap_fn": tc.arma_operator(g)}, "x"),
        ("SplineConv", "cora_spline",
         tc.SplineConv(f, c, dim=1, kernel_size=2, generator=gen),
         lambda g: {"spline_fns": tc.spline_operators(g, 1, 2)}, "x"),
        ("DNAConv", "cora", tc.DNAConv(128, heads=8, groups=16,
                                       generator=gen), tc.dna_operators,
         "history"),
    ]


def _zoo_call(conv, kind, g, x, ops):
    if kind == "dense":
        adj = torch.zeros(g.num_nodes, g.num_nodes, device=x.device)
        keep = g.real_edge_mask()
        adj[g.receivers[keep].long(), g.senders[keep].long()] = 1.0
        return conv(x, adj)
    if kind == "points":
        pos = torch.from_numpy(np.random.default_rng(SEED).normal(
            size=(g.num_nodes, 3)).astype(np.float32)).to(x.device)
        keep = g.real_edge_mask()
        return conv(x, pos, g.senders[keep], g.receivers[keep], g.num_nodes)
    return conv(g, x, **ops)


#: The zoo's convs that aggregate with a max (``ops/segment.py``'s
#: ``scatter_reduce``, no kernel of the port).
ZOO_MAX_CONVS = ("EdgeConv", "PointConv")


def phase_zoo():
    """Each conv of the zoo on Cora at 1433 -> 16 (AGNN keeps its width;
    DNA on a two-layer history of 128 channels; PointConv on positions
    drawn from the seed, over Cora's real edges; NNConv and SplineConv
    with ``TargetIndegree``'s pseudo-coordinates), through
    :func:`zoo_row`."""
    gen = torch.Generator().manual_seed(SEED)
    _, cora, _ = load("cora")
    rows, problems = [], []
    for case in _zoo_cases(cora.num_node_features, 16, gen):
        row = zoo_row(case, load(case[1])[1], gen)
        emit(row)
        rows.append(row)
        if not row["ok"]:
            problems.append(f"{case[0]}: {row}")
    if problems:
        raise AssertionError("; ".join(problems))
    return rows


def zoo_row(case, g, gen):
    """One case of :func:`_zoo_cases` on graph ``g`` (on the card): one
    forward and one backward on the card through its operators, against
    its plain path on the CPU from the same parameters and inputs (drawn
    from ``gen``; ``probes/zoo_max_routes.py:compare``): the output, the
    input's gradient and the parameters' within 1e-4 (relative to the
    largest magnitude; the parameters' to the largest of their
    gradients). The kernel launches are counted.

    A max aggregation's gradient jumps where a segment's two largest
    messages trade places: two messages a rounding apart (the synthetic
    Cora differs with ``PYTHONHASHSEED``, and some draws hold such a
    pair) can be ordered one way on the card and the other on the CPU,
    and the plain backward then sends that cotangent to another edge.
    So for ``ZOO_MAX_CONVS`` the CPU runs a second time with each max's
    backward routed through the card's maxima, and the gradients are
    held to that run at 1e-4, and the messages of the two devices to
    each other at 1e-4; the plain run's errors and the count of routes
    that differ are printed beside them."""
    from probes.zoo_max_routes import compare

    name, graph_name, conv, ops_of, kind = case
    graphs = {DEVICE: g, "cpu": g.to("cpu")}
    x = (torch.randn(g.num_nodes, 2, 128, generator=gen)
         if kind == "history" else graphs["cpu"].x.clone())
    res = compare(
        conv, lambda m, xi, dev, ops: _zoo_call(m, kind, graphs[dev], xi, ops),
        lambda dev: ops_of(graphs[dev]) if dev == DEVICE and ops_of else {},
        x, gen, DEVICE, max_aggr=name in ZOO_MAX_CONVS)
    row = {"phase": "zoo", "conv": name, "graph": graph_name,
           "out_shape": list(res["out"].shape),
           **{k: v for k, v in res.items() if k not in ("out", "gate")},
           "tol": 1e-4}
    # the convs that sum feature rows ran a kernel of the port
    sums = name not in ("DenseSAGEConv", "EdgeConv", "PointConv")
    row["ok"] = bool(torch.isfinite(res["out"]).all()) and \
        max(res["gate"]) <= 1e-4 and bool(res["launches"]) == sums
    return row


# ---------------------------------------------------------------------------
# The research layer (research/driver.py, models/prunable.py, mygcn)
# ---------------------------------------------------------------------------

#: research/driver.py's Cora pipeline at its defaults (epochs, fine-tune
#: epochs; corrections every 20 epochs from 0.5 x fine-tune + 20), and
#: the GAT's shorter run (one correction, at epoch 50).
DRIVER_EPOCHS = {"GCN": (100, 100), "GAT": (20, 60)}
#: Launches of one training epoch and of one evaluation: the GCN's three
#: convs, each one spmm_csr forward and one over the transposed CSR for
#: its ``dh`` (conv1's input takes no gradient, its ``h = x W`` does);
#: the GAT's three attention layers, one packed-GAT forward and two
#: backward walks each.
DRIVER_STEP_LAUNCHES = {"GCN": {"spmm_csr": 6},
                        "GAT": {"packed_gat_fwd": 3, "packed_gat_bwd": 6}}
DRIVER_EVAL_LAUNCHES = {"GCN": {"spmm_csr": 3}, "GAT": {"packed_gat_fwd": 3}}
#: The inductive pipelines' epochs a phase, and the launches of a step
#: and of an evaluation batch: PPI's PrunableGCN as the Cora GCN;
#: ENZYMES' PrunableTopK three GraphConv sums and two ``dx`` (the first
#: level's input takes none), a mean readout a level (its backward is a
#: gather), as examples/enzymes_topk_pool.py.
DRIVER_INDUCTIVE_EPOCHS = 2
DRIVER_INDUCTIVE_LAUNCHES = {
    "ppi": ({"spmm_csr": 6}, {"spmm_csr": 3}),
    "enzymes": ({"spmm_csr": 5, "sorted_segment_sum": 3},
                {"spmm_csr": 3, "sorted_segment_sum": 3})}
#: Card-against-CPU tolerance of the logits after three epochs: the
#: GAT's is wider, because AdamW's first steps turn rounding-level
#: gradient differences into lr-sized ones at its 1,080 channels (two
#: runs of the same plain CPU code: 3.4e-6 and 1.2e-4 apart). The gates
#: take SGD epochs (``GATE_SGD_LR``); the tolerances stand.
DRIVER_PARITY_TOL = {"GCN": 1e-4, "GAT": 1e-3}
#: The composed weight graph of slice_driver's last correction input
#: (the phase-2 model's first two weights), for the fiedler phase.
_DRIVER_GRAPH = {}


def _driver_expected(model_name, epochs, fine_tune):
    """``(expected launches, statement)`` of one ``training_net`` run:
    every epoch's step launches, and one evaluation a span (phase 1 one
    span; phase 2 cut at each correction epoch)."""
    from pytorch_geometric_tpu_torch.research import driver

    corrections = driver.correction_epochs_of(fine_tune, 0.5)
    evals = len(driver._spans(epochs, [])) + len(
        driver._spans(fine_tune, corrections))
    step, ev = DRIVER_STEP_LAUNCHES[model_name], \
        DRIVER_EVAL_LAUNCHES[model_name]
    expected = {n: (epochs + fine_tune) * step.get(n, 0)
                + evals * ev.get(n, 0) for n in set(step) | set(ev)}
    statement = {n: f"({epochs} + {fine_tune}) epochs x {step.get(n, 0)} + "
                    f"{evals} evaluations x {ev.get(n, 0)} = {expected[n]}"
                 for n in expected}
    return expected, statement, corrections


def driver_steps_logits(model_name, device, widths, epochs=3,
                        optimizer="sgd", routes=None):
    """``(logits, model)``: a fresh zoo model at ``widths`` (from
    ``SEED``, dropout 0: a generator on the card and one on the CPU draw
    different masks) after ``train_part`` for ``epochs`` epochs on Cora
    with ``optimizer`` (:func:`gate_optimizer`: the driver's AdamW 0.01,
    or SGD), then its logits; on the card through its operators, on the
    CPU through its plain path (no operators). The epochs run eagerly:
    the kinks' hooks (``routes``) run in Python, which a replay skips
    (``slice_driver`` holds the captured pipeline to the eager one,
    bitwise)."""
    from pytorch_geometric_tpu_torch.models.prunable import choose_model
    from pytorch_geometric_tpu_torch.research import driver

    ds, graph = driver.load_citation_dataset("Cora", device=device)
    model = choose_model(model_name, widths, ds.num_classes,
                         in_channels=graph.num_node_features, dropout=0.0,
                         generator=torch.Generator().manual_seed(SEED)
                         ).to(device)
    ops = model.operators(graph) if device != "cpu" else {}
    adamw = functools.partial(torch.optim.AdamW, weight_decay=5e-4,
                              capturable=device != "cpu")
    driver.train_part(model, graph, None, epochs, seed=SEED,
                      apply_kwargs=ops, capture=False,
                      optimizer=lambda _: gate_optimizer(
                          optimizer, model, 0.01,
                          f"driver_{model_name.lower()}", adamw, routes))
    model.eval()
    with torch.no_grad():
        return model(graph, graph.x, **ops).cpu(), model


def phase_slice_driver(model_name="GCN", phase="slice_driver"):
    """research/driver.py's ``training_net`` on Cora at the driver's
    defaults, as ``python -m pytorch_geometric_tpu_torch.research.driver``
    runs it (``--modelName GAT``: 20 + 60 epochs): widths from
    ``contraction_layer_coefficients`` (seed 0), phase 1, SVD pruning
    (``retain_network_size`` at ConCoeff 0.6), the smaller net, phase 2
    with the Fiedler weight correction every 20 epochs past half the
    fine-tune epochs, checkpoints and curves in a temporary directory.
    Printed: the widths before and after pruning, each phase's seconds
    and best validation accuracy, and each correction's epoch, seconds,
    ``applied`` count and Fiedler backends. Run as a user runs it
    (``train_part``'s epoch captured and replayed over each span, the
    correction editing the weights in place between spans), then eager
    (:func:`_span_pair`: both phases' losses, validation and test
    accuracies, best accuracy and final parameters bitwise). Launches
    asserted (``DRIVER_STEP_LAUNCHES`` x epochs + ``DRIVER_EVAL_LAUNCHES``
    x evaluations, in both runs); both phases' losses finite and falling
    (phase 1 from its checkpoint's history, phase 2 from its saved
    curve); the logits after three SGD epochs (dropout 0) and the first
    epoch's gradients, card against the plain path on the CPU
    (:func:`_step_gate`, ``DRIVER_PARITY_TOL``: GCN 1e-4, GAT 1e-3)."""
    import tempfile

    from pytorch_geometric_tpu_torch.research import driver
    from pytorch_geometric_tpu_torch.research.checkpoint import (
        CheckpointManager)
    from pytorch_geometric_tpu_torch.research.spectral import (
        compose, layer_weight_items, weights_to_adjacency)

    epochs, fine_tune = DRIVER_EPOCHS[model_name]
    expected, statement, corrections = _driver_expected(model_name, epochs,
                                                        fine_tune)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir, results_dir = f"{tmp}/checkpoint", f"{tmp}/Results"

        def run(capture):
            sub = tmp if capture is None else f"{tmp}/eager"
            t0 = time.perf_counter()
            (res,) = driver.training_net(
                "Cora", model_name, epochs=epochs,
                fine_tune_epochs=fine_tune, results_dir=f"{sub}/Results",
                ckpt_dir=f"{sub}/checkpoint", device=DEVICE,
                capture=capture)
            torch.cuda.synchronize()
            spans = [res["phases"][k].spans.metrics()
                     for k in ("phase1", "phase2")]
            out = {"result": res, "run_seconds": time.perf_counter() - t0}
            for key in ("seconds", "between_seconds", "capture_seconds"):
                if key in spans[0]:
                    out[key] = sum(sp[key] for sp in spans)
            if "launches" in spans[0]:
                out["device_launches"] = {
                    n: sum(sp["device_launches"].get(n, 0) for sp in spans)
                    for n in expected}
                out["launches"] = {
                    "replays": sum(sp["launches"]["replays"]
                                   for sp in spans),
                    **{stage: {n: sum(sp["launches"][stage].get(n, 0)
                                      for sp in spans) for n in expected}
                       for stage in ("warm_up", "captured_epoch",
                                     "evaluation")}}
            return out

        def outputs(o):
            ph = o["result"]["phases"]
            return {f"{k}_{what}": getattr(ph[k], attr)
                    for k in ph for what, attr in (
                        ("losses", "train_convergence"),
                        ("val_accs", "val_convergence"),
                        ("test_accs", "test_convergence"),
                        ("best_val_acc", "best_acc"), ("params", "params"))}

        out, _, report, problems = _span_pair(
            run, expected, statement, epochs + fine_tune, outputs)
        res = out["result"]
        run_key = (f"Cora-{model_name}2-{'_'.join(map(str, res['widths']))}"
                   f"-0.6-0")
        ckpt = CheckpointManager(ckpt_dir)
        phase1 = ckpt.load(run_key + "-phase1")
        phase2 = ckpt.load(run_key + "-phase2")
        tag = f"Cora-{model_name}2-param_" \
              f"{'_'.join(map(str, res['widths']))}_0.6-monte_0.npy"
        curve2 = np.load(f"{results_dir}/CoraConvergence/"
                         f"TrainConvergence-{tag}")
        # the composed graph of the phase-2 net's best weights, as the
        # correction builds it (the fiedler phase takes the GCN's)
        items = layer_weight_items(phase2["params"])
        graphs, start = [], 0
        for _, w in items:
            if sum(w.shape) > 2000 or len(graphs) >= 2:
                continue
            graphs.append(weights_to_adjacency(w, start, 50_000)[0])
            start += sum(w.shape)
        composed = compose(*graphs) if len(graphs) == 2 else graphs[0]
        if model_name == "GCN":
            _DRIVER_GRAPH["G"] = composed
    _falling(phase1["train_convergence"], problems, "phase-1 epoch")
    _falling(curve2, problems, "phase-2 epoch")
    if [c["epoch"] for c in res["corrections"]] != corrections:
        problems.append(f"corrections at {res['corrections']}, expected "
                        f"epochs {corrections}")
    gate = _step_gate(*step_gate(f"driver_{model_name.lower()}",
                                 res["widths"])[:2], "logits", problems)
    printed = {
        "widths": res["widths"], "pruned_widths": res["new_widths"],
        "phase1": {"seconds": res["seconds"]["phase1"],
                   "best_val_acc": res["pretrain_best"]},
        "svd_pruning_seconds": res["seconds"]["pruning"],
        "phase2": {"seconds": res["seconds"]["phase2"],
                   "best_val_acc": res["finetune_best"]},
        "corrections": res["corrections"]}
    print(json.dumps({"phase": phase, "pipeline": printed}), flush=True)
    return _finish({"phase": phase, "dataset": "Cora", "model": model_name,
                    "epochs": [epochs, fine_tune], **printed, **report,
                    "phase1_losses": [phase1["train_convergence"][0],
                                      phase1["train_convergence"][-1]],
                    "phase2_losses": [float(curve2[0]), float(curve2[-1])],
                    "phase2_max_loss": float(np.max(curve2)),
                    "composed_graph": {
                        "layers": [list(w.shape) for _, w in items],
                        "nodes": len(composed),
                        "edges": composed.number_of_edges()},
                    **gate}, problems)


def phase_slice_driver_inductive():
    """research/driver.py's inductive pipelines on the card for
    ``DRIVER_INDUCTIVE_EPOCHS`` epochs a phase: ``training_net_ppi``
    (PrunableGCN on PPI, batches of 2 graphs, one operator a distinct
    batch, built once) and ``training_net_graphcls`` (PrunableTopK on
    ENZYMES, batches of 64, one operator set a batch), each through the
    prune / rebuild / fine-tune loop, as a user runs it (``capture``
    None: each phase's training step and evaluation captured over one
    static pair of buffers, a capture a phase), then eager
    (``capture=False``). Launches asserted in both runs as 2 phases x
    epochs x (train batches x ``DRIVER_INDUCTIVE_LAUNCHES`` step + test
    batches x evaluation): the captured run's device launches (each
    step's captured launches x replays + warm-up) and its wrapper calls
    (the warm-ups' and the captures'), each step's launches by stage and
    its calls; both phases' every step's loss, test curves and final
    parameters bitwise equal in the two runs; each run's ms a step, the
    captured run's host ms a batch and capture seconds, both peaks of
    device memory; the widths, pruned widths and best metrics
    printed."""
    import tempfile

    from pytorch_geometric_tpu_torch.data import DataLoader
    from pytorch_geometric_tpu_torch.datasets import PPI, TUDataset
    from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
    from pytorch_geometric_tpu_torch.models.capture import launch_counts
    from pytorch_geometric_tpu_torch.research import driver

    e = DRIVER_INDUCTIVE_EPOCHS
    root = str(PLANETOID_ROOT)
    enz = TUDataset(root, "ENZYMES")
    n_test = len(enz) // 10
    batches = {
        "ppi": (len(DataLoader(PPI(root, split="train"), 2, device=DEVICE)),
                len(DataLoader(PPI(root, split="test"), 2, device=DEVICE))),
        "enzymes": (-(-(len(enz) - n_test) // 64), -(-n_test // 64))}
    runs = {"ppi": lambda tmp, capture: driver.training_net_ppi(
                epochs=e, fine_tune_epochs=e, results_dir=f"{tmp}/R",
                ckpt_dir=f"{tmp}/c", device=DEVICE, capture=capture),
            "enzymes": lambda tmp, capture: driver.training_net_graphcls(
                "ENZYMES", epochs=e, fine_tune_epochs=e,
                results_dir=f"{tmp}/R", ckpt_dir=f"{tmp}/c",
                device=DEVICE, capture=capture)}
    launches, expected, statement, results, problems = {}, {}, {}, {}, []
    for name, run in runs.items():
        step, ev = DRIVER_INDUCTIVE_LAUNCHES[name]
        n_train, n_eval = batches[name]
        mine = {k: 2 * e * (n_train * step.get(k, 0) + n_eval * ev.get(k, 0))
                for k in set(step) | set(ev)}
        for k, v in mine.items():
            expected[k] = expected.get(k, 0) + v
            statement[f"{name}:{k}"] = (
                f"2 phases x {e} epochs x ({n_train} train batches x "
                f"{step.get(k, 0)} + {n_eval} test batches x "
                f"{ev.get(k, 0)}) = {v}")
        out = {}
        for mode, capture in (("captured", None), ("eager", False)):
            with tempfile.TemporaryDirectory() as tmp:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
                before = launch_counts()
                t0 = time.perf_counter()
                (res,) = run(tmp, capture)
                torch.cuda.synchronize()
                out[mode] = (res, time.perf_counter() - t0, {
                    k: v - before[k] for k, v in launch_counts().items()
                    if v != before[k]},
                    torch.cuda.max_memory_allocated() - start)
        (cap, cap_s, cap_calls, cap_peak), (eag, eag_s, eag_calls,
                                            eag_peak) = out.values()
        ran, calls, stages = {}, {}, {}
        for p, phase in enumerate(cap["phases"]):
            for k, v in phase.steps["device_launches"].items():
                ran[k] = ran.get(k, 0) + v
            for kind, st in phase.steps["launches"].items():
                per, want = (step, n_train) if kind == "train" \
                    else (ev, n_eval)
                stages[f"phase{p + 1}_{kind}"] = st
                if st["warm_up"] != per or st["captured"] != per or \
                        st["replays"] + 1 != e * want:
                    problems.append(f"{name} phase {p + 1} {kind}: launches "
                                    f"by stage {st}, expected {per} in its "
                                    f"warm-up and capture and {e * want} "
                                    "calls")
                for stage in ("warm_up", "captured"):
                    for k, v in st[stage].items():
                        calls[k] = calls.get(k, 0) + v
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        for what, got, want in (("captured run: device launches", ran, mine),
                                ("captured run: wrapper calls", cap_calls,
                                 calls),
                                ("eager run: launches", eag_calls, mine)):
            if got != want:
                problems.append(f"{name} {what} {got}, expected {want}")
        differ = [f"phase {p + 1} {k}" for p, (a, b) in enumerate(zip(
            cap["phases"], eag["phases"])) for k, same in (
                ("step_losses", np.array_equal(a.steps["step_losses"],
                                               b.steps["step_losses"])),
                ("test_convergence",
                 a.test_convergence == b.test_convergence),
                ("params", _bitwise(a.params, b.params))) if not same]
        if differ or cap["new_widths"] != eag["new_widths"]:
            problems.append(f"{name}: captured vs eager not bitwise: "
                            f"{differ}, widths {cap['new_widths']} against "
                            f"{eag['new_widths']}")
        steps = 2 * e * n_train
        host = [ph.steps for ph in cap["phases"]]
        capture_s = sum(h["capture_seconds"] for h in host)
        results[name] = {
            **{k: v for k, v in cap.items() if k != "phases"},
            "seconds": cap_s, "eager_seconds": eag_s,
            "capture_seconds": capture_s,
            "ms_per_step": sum(h["seconds"] for h in host) / steps * 1e3
            - capture_s / steps * 1e3,
            "eager_ms_per_step": sum(ph.steps["seconds"] for ph in
                                     eag["phases"]) / steps * 1e3,
            "host_ms_per_batch": sum(h["host_seconds"] for h in host)
            / sum(h["host_batches"] for h in host) * 1e3,
            "run_peak_bytes": cap_peak, "eager_run_peak_bytes": eag_peak,
            "launches": ran, "wrapper_calls": cap_calls,
            "eager_launches": eag_calls, "launch_stages": stages,
            "captured_vs_eager_bitwise": not differ,
            "step_losses": [ph.steps["step_losses"].tolist()
                            for ph in cap["phases"]]}
    return _finish({"phase": "slice_driver_inductive", "epochs": e,
                    "batches": batches, "runs": results,
                    "launches": launches, "expected_launches": expected,
                    "launch_statement": statement}, problems)


def _prunable_cases():
    """``(name, widths, graph kind)`` of the zoo_prunable phase."""
    return [(name, (64, 32), "enzymes" if name == "TopK" else "cora")
            for name in ("GCN", "GAT", "Cheb", "AGNN", "Spline", "TopK")]


def phase_zoo_prunable():
    """Each model of ``models/prunable.py:MODEL_ZOO`` (widths 64, 32;
    the five node models on Cora, TopK on an ENZYMES batch of 64 graphs),
    dropout 0: one forward and one backward through its operators
    (``model.operators(graph)``) on the card against its plain path on
    the CPU from the same parameters: the output within 1e-4 of its
    largest magnitude, the parameters' gradients within 1e-4 of the
    largest gradient; each launches a kernel of the port that sums
    feature rows."""
    import copy

    from pytorch_geometric_tpu_torch.data import DataLoader
    from pytorch_geometric_tpu_torch.datasets import TUDataset
    from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
    from pytorch_geometric_tpu_torch.models.capture import launch_counts
    from pytorch_geometric_tpu_torch.models.prunable import choose_model
    from pytorch_geometric_tpu_torch.research import driver

    gen = torch.Generator().manual_seed(SEED)
    ds, cora = driver.load_citation_dataset("Cora", device=DEVICE)
    enz = next(iter(DataLoader(TUDataset(str(PLANETOID_ROOT), "ENZYMES"),
                               64, device=DEVICE)))
    rows, problems = [], []
    for name, widths, kind in _prunable_cases():
        g = enz if kind == "enzymes" else cora
        classes = 6 if kind == "enzymes" else ds.num_classes
        kw = {} if name == "TopK" else {"dropout": 0.0}
        model = choose_model(name, widths, classes,
                             in_channels=g.num_node_features,
                             generator=gen, **kw)
        results, ct = [], None
        for dev, m, with_ops in ((DEVICE, copy.deepcopy(model).to(DEVICE),
                                  True), ("cpu", model, False)):
            gg = g.to(dev)
            ops = m.operators(gg) if with_ops else {}
            before = launch_counts()
            out = m(gg, **ops) if name == "TopK" else m(gg, gg.x, **ops)
            if ct is None:
                ct = torch.randn(out.shape, generator=gen)
            (out * ct.to(dev)).sum().backward()
            launched = {k: v - before[k] for k, v in launch_counts().items()
                        if v != before[k]}
            results.append((out.detach().cpu(),
                            {n: p.grad.cpu() for n, p in
                             m.named_parameters()}, launched))
        (out, grads, launched), (ref, ref_grads, _) = results
        scale = max(float(v.abs().max()) for v in ref_grads.values())
        param_err = max(float((grads[n] - v).abs().max()) / max(scale, 1e-30)
                        for n, v in ref_grads.items())
        row = {"phase": "zoo_prunable", "model": name, "graph": kind,
               "widths": list(widths), "out_shape": list(out.shape),
               "launches": launched, "out_rel_err": _rel(out, ref),
               "param_grad_rel_err": param_err, "tol": 1e-4}
        row["ok"] = bool(torch.isfinite(out).all()) and max(
            row["out_rel_err"], param_err) <= 1e-4 and bool(launched)
        emit(row)
        rows.append(row)
        if not row["ok"]:
            problems.append(f"{name}: {row}")
    if problems:
        raise AssertionError("; ".join(problems))
    return rows


def phase_fiedler():
    """The Fiedler pair of slice_driver's composed weight graph (the
    phase-2 net's first two weights, 50,000 edges of the first kept)
    three ways: ``research/spectral.py``'s torch power iteration on the
    card (fp32, padded to the next power of two, 512 iterations), the
    same code on the CPU, and numpy ``eigh`` of the normalised Laplacian
    on the host. The card's λ2 and vector against the CPU's (sign
    aligned, 1e-4 of the largest entry) and λ2 against eigh's (1e-4
    absolute); since the composed graph's two layers are two components,
    λ2 = 0 has a two-dimensional eigenspace, so the vector is held to
    eigh's eigenspace of the eigenvalues up to λ2 + 1e-5 (the norm of its
    part outside it, 1e-4). The card's milliseconds (CUDA events, the
    host-to-card copy included) beside the CPU's and eigh's seconds."""
    from pytorch_geometric_tpu_torch.research import spectral

    if "G" not in _DRIVER_GRAPH:
        raise RuntimeError("fiedler needs slice_driver's composed graph: "
                           "run slice_driver first")
    G = _DRIVER_GRAPH["G"]
    A = np.abs(G.to_numpy_array())
    n = A.shape[0]
    n_pad = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 1)
    card_ms = _event_ms(lambda: spectral._fiedler_device(A, device=DEVICE),
                        reps=3)
    lam, vec = spectral._fiedler_device(A, device=DEVICE)
    t0 = time.perf_counter()
    lam_cpu, vec_cpu = spectral._fiedler_device(A, device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = A.sum(axis=1)
    dis = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-30)), 0.0)
    lap = np.eye(n) - (dis[:, None] * A) * dis[None, :]
    lap = (lap + lap.T) / 2.0
    w, V = np.linalg.eigh(lap)
    eigh_s = time.perf_counter() - t0
    sign = 1.0 if float(vec @ vec_cpu) >= 0 else -1.0
    vec_err = float(np.abs(vec - sign * vec_cpu).max()
                    / np.abs(vec_cpu).max())
    space = V[:, w <= w[1] + 1e-5]
    outside = float(np.linalg.norm(vec - space @ (space.T @ vec))
                    / np.linalg.norm(vec))
    problems = []
    if not (np.isfinite(vec).all() and vec_err <= 1e-4):
        problems.append(f"card vs CPU vector rel err {vec_err}")
    if abs(lam - lam_cpu) > 1e-4 or abs(lam - float(w[1])) > 1e-4:
        problems.append(f"lambda2 card {lam}, CPU {lam_cpu}, eigh {w[1]}")
    if outside > 1e-4:
        problems.append(f"vector outside eigh's eigenspace: {outside}")
    return _finish({"phase": "fiedler", "nodes": n, "padded": n_pad,
                    "edges": G.number_of_edges(), "iterations": 512,
                    "lambda2": {"card": lam, "cpu": lam_cpu,
                                "eigh": float(w[1])},
                    "eigh_low": [float(v) for v in w[:4]],
                    "eigenspace_dim": int(space.shape[1]),
                    "vector_cuda_vs_cpu_rel_err": vec_err,
                    "vector_outside_eigh_eigenspace": outside,
                    "card_ms": card_ms, "cpu_seconds": cpu_s,
                    "eigh_seconds": eigh_s}, problems)


MYGCN_EPOCHS = (40, 60)
#: Launches of a mygcn epoch (the packed GCN's two layers forward and
#: back) and of an evaluation.
MYGCN_LAUNCHES = (4, 2)


def phase_mygcn():
    """examples/mygcn.py on the card: 40 epochs (two spans of 20, a
    checkpoint on each better validation accuracy) in a temporary
    directory, as a user runs it (the epoch captured and replayed 20
    times a span) and then eager (:func:`_span_pair`: the loss history,
    the model and the final accuracies bitwise; launches 40 x 4 + 3
    evaluations x 2 in both), then ``--resume`` to 60: the restored epoch
    counter is the checkpoint's, the run trains on from it to 60 in spans
    of 20, the loss history is the checkpoint's up to there, and the
    final checkpoint is at least as good."""
    import contextlib
    import io
    import tempfile

    from pytorch_geometric_tpu_torch.examples import mygcn
    from pytorch_geometric_tpu_torch.research.checkpoint import (
        CheckpointManager)

    per_epoch, per_eval = MYGCN_LAUNCHES
    evals = MYGCN_EPOCHS[0] // 20 + 1
    want = MYGCN_EPOCHS[0] * per_epoch + evals * per_eval
    with tempfile.TemporaryDirectory() as tmp:
        out, _, report, problems = _span_pair(
            lambda capture: mygcn.run(
                epochs=MYGCN_EPOCHS[0], device=DEVICE, capture=capture,
                ckpt_dir=tmp if capture is None else f"{tmp}/eager"),
            {"spmm_csr": want},
            {"spmm_csr": f"{MYGCN_EPOCHS[0]} epochs x {per_epoch} + {evals} "
                         f"evaluations x {per_eval}"},
            MYGCN_EPOCHS[0],
            lambda o: {"history": o["history"],
                       "model": o["model"].state_dict(),
                       "val_acc": float(o["val_acc"]),
                       "test_acc": float(o["test_acc"])})
        first_s = out["seconds"] + out["between_seconds"]
        saved = CheckpointManager(tmp).load("mygcn-Cora")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            acc = mygcn.run(epochs=MYGCN_EPOCHS[1], resume=True,
                            ckpt_dir=tmp, device=DEVICE)
            resume_s = time.perf_counter() - t0
        final = CheckpointManager(tmp).load("mygcn-Cora")
    lines = report["printed"] + printed.getvalue().splitlines()
    resumed = [ln for ln in lines if ln.startswith("=> resumed")]
    want = f"=> resumed from epoch {saved['epoch']} "
    if len(resumed) != 1 or not resumed[0].startswith(want):
        problems.append(f"resume line {resumed}, expected {want!r}")
    spans = [ln[:9] for ln in lines[lines.index(resumed[0]) + 1:]] \
        if resumed else []
    expected_spans = [f"Epoch {e:03d}" for e in
                      range(saved["epoch"] + 20, MYGCN_EPOCHS[1] + 1, 20)]
    if spans != expected_spans:
        problems.append(f"after resuming {spans}, expected {expected_spans}")
    if final["train_convergence"][:saved["epoch"]] != \
            saved["train_convergence"]:
        problems.append("the resumed history does not extend the saved one")
    if final["metric"] < saved["metric"]:
        problems.append("the final checkpoint is worse than the resumed one")
    return _finish({"phase": "mygcn", "epochs": list(MYGCN_EPOCHS),
                    **report,
                    "printed": lines, "restored_epoch": saved["epoch"],
                    "restored_val_acc": saved["metric"],
                    "final_epoch": final["epoch"],
                    "final_val_acc": final["metric"],
                    "final_test_acc": float(acc["test_acc"]),
                    "first_run_seconds": first_s,
                    "resumed_run_seconds": resume_s}, problems)


#: Epochs of the captured-against-eager check.
# --- data parallelism and the edge partition ------------------------------

DP_EPOCHS = 5
DP_STEP_LAUNCHES = {"spmm_csr": 4, "sorted_segment_sum": 1}
DP_EVAL_LAUNCHES = {"spmm_csr": 2, "sorted_segment_sum": 1}
DP_BITWISE_STEPS = 3
DP_DRIVER_EPOCHS = 2
#: The partitioned trainers of slice_partition: the window and dense
#: threshold of each one's GraphPartition.
PARTITION_RUNS = {"example_gcn": (256, 128), "driver_gcn": (1024, 1024),
                  "driver_gat": (1024, 1024)}
PARTITION_EPOCHS = {"example_gcn": 30, "driver_gcn": 100, "driver_gat": 100}
#: Card-against-card tolerance of the partitioned logits against the
#: single-device model on the same weights: bf16 halo rows and bf16
#: operands of the partitioned SpMM (TOL["bf16"]); fp32 for the GAT.
PARTITION_TOL = {"example_gcn": TOL["bf16"], "driver_gcn": TOL["bf16"],
                 "driver_gat": TOL["fp32"]}
SHARDS = 4


def _launch_diff(before):
    from pytorch_geometric_tpu_torch.models.capture import launch_counts

    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def _add(total, counts, times=1):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + times * v
    return total


def dp_bitwise_steps(steps=DP_BITWISE_STEPS):
    """In a one-rank group on the card: ``steps`` steps of
    examples/data_parallel.py through ``DataParallelTrainer`` and the same
    steps as a plain Adam loop (the same model from ``SEED``, the same
    shards), the losses and parameters of both bitwise equal; and the
    launches of one trainer step and of one evaluation batch."""
    from pytorch_geometric_tpu_torch.data import DataListLoader
    from pytorch_geometric_tpu_torch.datasets import TUDataset
    from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
    from pytorch_geometric_tpu_torch.examples import data_parallel as dp
    from pytorch_geometric_tpu_torch.models.capture import launch_counts
    from pytorch_geometric_tpu_torch.models.graph_pred import GraphClassifier
    from pytorch_geometric_tpu_torch.parallel import (
        DataParallelTrainer, make_mesh, shard_data_list)
    from pytorch_geometric_tpu_torch.parallel.data_parallel import (
        unstack_graph)

    ds = TUDataset(str(PLANETOID_ROOT), "MUTAG")
    lists = list(itertools.islice(iter(DataListLoader(
        ds, batch_size=dp.GRAPHS_PER_RANK, shuffle=True, seed=SEED)), steps))
    max_n, max_e = dp.budgets(ds)

    def model():
        return GraphClassifier(
            ds.num_node_features, 32, 2,
            generator=torch.Generator().manual_seed(SEED)).to(DEVICE)

    a, b = model(), model()
    trainer = DataParallelTrainer(
        make_mesh(), dp.batch_loss, lambda ps: torch.optim.Adam(ps, lr=1e-2))
    opt_a = trainer.init(a)
    opt_b = torch.optim.Adam(b.parameters(), lr=1e-2)
    la, lb, step_launches = [], [], None
    for dl in lists:
        stacked = shard_data_list(dl, 1, max_n, max_e, dp.GRAPHS_PER_RANK,
                                  device=DEVICE)
        before = launch_counts()
        a, opt_a, loss = trainer.step(a, opt_a, stacked, None)
        torch.cuda.synchronize()
        step_launches = step_launches or _launch_diff(before)
        la.append(loss)
        graph = unstack_graph(stacked, 0)
        opt_b.zero_grad(set_to_none=True)
        loss_b = dp.batch_loss(b, graph)
        loss_b.backward()
        opt_b.step()
        lb.append(loss_b.detach())
    before = launch_counts()
    with torch.no_grad():
        b(graph, **dp.batch_operators(graph))
    torch.cuda.synchronize()
    eval_launches = _launch_diff(before)
    bitwise = all(torch.equal(x, y) for x, y in zip(la, lb)) and all(
        torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    return {"bitwise": bitwise, "losses": [float(x) for x in la],
            "step_launches": step_launches, "eval_launches": eval_launches}


def phase_slice_dp():
    """Data parallelism on the card over a one-rank NCCL group
    (``parallel/mesh.py:RankPool(1)``, the calling process):
    examples/data_parallel.py at its defaults (MUTAG, GraphClassifier
    hidden 32, 4 graphs a rank, Adam 1e-2, 5 epochs), each shard through
    its operators (spmm_csr, the segment-sum kernel) and
    DataParallelTrainer's fixed-order average over NCCL; its first three
    steps bitwise equal to the same steps without the trainer; the step's
    and an evaluation batch's launches against DP_STEP_LAUNCHES /
    DP_EVAL_LAUNCHES; the loss falling. Then examples/
    mnist_data_parallel.py at its defaults and the driver's
    training_net_graphcls(data_parallel=True, num_devices=1) on ENZYMES
    for 2 + 2 epochs, launches asserted (DRIVER_INDUCTIVE_LAUNCHES)."""
    import tempfile

    from pytorch_geometric_tpu_torch.datasets import (
        MNISTSuperpixels, TUDataset)
    from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
    from pytorch_geometric_tpu_torch.examples import (
        data_parallel, mnist_data_parallel)
    from pytorch_geometric_tpu_torch.parallel.mesh import RankPool
    from pytorch_geometric_tpu_torch.research import driver

    root = str(PLANETOID_ROOT)
    problems, launches, expected, statement, runs = [], {}, {}, {}, {}
    mutag_steps = -(-len(TUDataset(root, "MUTAG"))
                    // data_parallel.GRAPHS_PER_RANK)
    mnist_steps = len(MNISTSuperpixels(root, train=True,
                                       num_synthetic=512)) // 32
    with RankPool(1, device=DEVICE) as pool:
        check = pool.run(lambda rank: dp_bitwise_steps())[0]
        if not check["bitwise"]:
            problems.append("trainer steps differ from the plain steps")
        if check["step_launches"] != DP_STEP_LAUNCHES:
            problems.append(f"step launches {check['step_launches']}, "
                            f"expected {DP_STEP_LAUNCHES}")
        if check["eval_launches"] != DP_EVAL_LAUNCHES:
            problems.append(f"evaluation launches {check['eval_launches']}"
                            f", expected {DP_EVAL_LAUNCHES}")
        for name, fn, steps in (
                ("data_parallel", lambda: pool.run(
                    data_parallel.train_rank, DP_EPOCHS, SEED, DEVICE,
                    root)[0], DP_EPOCHS * mutag_steps),
                ("mnist_data_parallel", lambda: dict(pool.run(
                    mnist_data_parallel.train_rank, 1, 32, 512, SEED,
                    DEVICE, root)[0], seconds=0.0), mnist_steps)):
            mine = {k: steps * v for k, v in DP_STEP_LAUNCHES.items()}
            t0 = time.perf_counter()
            out, report, more = _example_run(fn, mine, {
                k: f"{steps} steps x {DP_STEP_LAUNCHES[k]}" for k in mine})
            report["seconds"] = time.perf_counter() - t0
            problems += [f"{name}: {p}" for p in more]
            _add(launches, report["launches"])
            _add(expected, mine)
            statement.update({f"{name}:{k}": v for k, v in
                              report["launch_statement"].items()})
            runs[name] = {**report, "steps": steps,
                          "ms_per_step": report["seconds"] / steps * 1e3}
            losses = out.get("epoch_losses") or out["step_losses"]
            if name == "data_parallel":
                _falling(losses, problems)
                runs[name]["epoch_losses"] = losses
            else:
                runs[name]["mean_loss"] = out["mean_loss"]
                if not np.isfinite(out["step_losses"]).all():
                    problems.append("mnist_data_parallel: non-finite loss")
    e = DP_DRIVER_EPOCHS
    enz = TUDataset(root, "ENZYMES")
    n_test = len(enz) // 10
    n_train, n_eval = -(-(len(enz) - n_test) // 64), -(-n_test // 64)
    step, ev = DRIVER_INDUCTIVE_LAUNCHES["enzymes"]
    mine = {k: 2 * e * (n_train * step.get(k, 0) + n_eval * ev.get(k, 0))
            for k in set(step) | set(ev)}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out, report, more = _example_run(
            lambda: {"res": driver.training_net_graphcls(
                "ENZYMES", epochs=e, fine_tune_epochs=e,
                results_dir=f"{tmp}/R", ckpt_dir=f"{tmp}/c", device=DEVICE,
                num_devices=1, data_parallel=True), "seconds": 0.0},
            mine, {k: f"2 phases x {e} epochs x ({n_train} train shards x "
                      f"{step.get(k, 0)} + {n_eval} test batches x "
                      f"{ev.get(k, 0)}) = {v}" for k, v in mine.items()})
    report["seconds"] = time.perf_counter() - t0
    problems += [f"driver: {p}" for p in more]
    _add(launches, report["launches"])
    _add(expected, mine)
    statement.update({f"driver:{k}": v for k, v in
                      report["launch_statement"].items()})
    runs["driver_graphcls_dp"] = {
        **report, **{k: v for k, v in out["res"][0].items()
                     if k != "phases"}}
    return _finish({"phase": "slice_dp", "group": "nccl, 1 rank",
                    "bitwise_check": check, "runs": runs,
                    "launches": launches, "expected_launches": expected,
                    "launch_statement": statement}, problems)


def _partition_counts(part):
    """(forward launches of one aggregation, set-up launches) of a
    GraphPartition's rank-0 'gcn' operator: a launch for the sparse
    remainder and one for the remote edges (spmm_csr), one window sum for
    the dense blocks (sorted_segment_sum); the dense tables' segment sums
    (one per weighting that has dense blocks) at construction."""
    local = part.ops["gcn"].device_consts()[0]["local"]
    fwd = {"spmm_csr": 1 + ("sparse" in local),
           "sorted_segment_sum": int("blocks" in local)}
    setup = sum("blocks" in op.device_consts()[0]["local"]
                for op in part.ops.values())
    return fwd, {"sorted_segment_sum": setup}


def _single_device_logits(what, graph, state_dict, num_classes):
    """The trained weights in the single-device model on the whole graph
    (its operators), eval mode."""
    from pytorch_geometric_tpu_torch.models.citation import (
        GAT, GCN, gat_flash_op, gcn_spmm_operator)

    F = graph.num_node_features
    if what == "driver_gat":
        model = GAT(F, num_classes).to(DEVICE)
        kwargs = {"flash_op": gat_flash_op(graph, "packed")}
    else:
        model = GCN(F, 16, num_classes).to(DEVICE)
        op, w = gcn_spmm_operator(graph)
        kwargs = {"aggregate_fn": op.bind(w)}
    model.load_state_dict(state_dict)
    model.eval()
    with torch.no_grad():
        return model(graph, graph.x, **kwargs)


def phase_slice_partition():
    """The edge-partitioned trainers on the card over a one-rank NCCL
    group: examples/distributed_gcn.py at its defaults (synthetic Cora,
    GraphPartition window 256 / dense threshold 128, DistGCN hidden 16,
    30 epochs), then research/driver.py's training_net_partitioned on
    Cora with GCN (hidden 16) and GAT (8 heads x 8), 100 epochs each.
    Launches asserted per step, evaluation and set-up from each
    partition's structure (_partition_counts: its dense tables at
    set-up, the GAT's too; GAT: 2 packed-GAT forward and 4 backward
    launches a step); the loss falling; the trained
    logits against the single-device model on the same weights (bf16
    tolerance for the partitioned SpMM, fp32 for the GAT); seconds, ms a
    step and peak memory."""
    from pytorch_geometric_tpu_torch.examples import distributed_gcn
    from pytorch_geometric_tpu_torch.parallel.api import GraphPartition
    from pytorch_geometric_tpu_torch.research import driver

    problems, launches, expected, statement, runs = [], {}, {}, {}, {}
    graphs = {"example_gcn": distributed_gcn.load(SEED)}
    ds, graphs["driver"] = driver.load_citation_dataset("Cora",
                                                        device="cpu")
    for what, (window, threshold) in PARTITION_RUNS.items():
        graph = graphs["example_gcn" if what == "example_gcn" else "driver"]
        e = PARTITION_EPOCHS[what]
        s, r = distributed_gcn.partition_edges(graph)
        part = GraphPartition(s, r, graph.num_nodes, 1, window=window,
                              dense_threshold=threshold, device=DEVICE)
        fwd, setup = _partition_counts(part)
        if what == "driver_gat":
            per_step = {"packed_gat_fwd": 2, "packed_gat_bwd": 4}
            per_eval = {"packed_gat_fwd": 2}
        else:
            per_step = {k: 4 * v for k, v in fwd.items()}
            per_eval = {k: 2 * v for k, v in fwd.items()}
        mine = {k: e * per_step.get(k, 0) + per_eval.get(k, 0)
                + setup.get(k, 0) for k in set(per_step) | set(setup)}
        mine = {k: v for k, v in mine.items() if v}
        if what == "example_gcn":
            run = functools.partial(distributed_gcn.run, epochs=e,
                                    world_size=1, device=DEVICE)
        else:
            run = functools.partial(
                driver.training_net_partitioned, "Cora",
                what.split("_")[1].upper(), 1, epochs=e, device=DEVICE)
        out, report, more = _example_run(run, mine, {
            k: f"{e} steps x {per_step.get(k, 0)} + evaluation "
               f"{per_eval.get(k, 0)} + set-up {setup.get(k, 0)} = {v}"
            for k, v in mine.items()})
        problems += [f"{what}: {p}" for p in more]
        losses = out["losses"] if what == "example_gcn" else \
            [out["loss_first"], out["loss_last"]]
        _falling(losses, problems, f"{what} step")
        want = _single_device_logits(
            what, graph.to(DEVICE), out["state_dict"],
            int(graph.y.max()) + 1 if what == "example_gcn"
            else ds.num_classes)
        err = _rel(torch.from_numpy(out["logits"]).to(DEVICE), want)
        if not err <= PARTITION_TOL[what]:
            problems.append(f"{what}: logits vs single device rel err {err}")
        _add(launches, report["launches"])
        _add(expected, mine)
        statement.update({f"{what}:{k}": v for k, v in
                          report["launch_statement"].items()})
        accs = {k: out[k] for k in ("train", "val", "test", "val_acc",
                                    "test_acc") if k in out}
        runs[what] = {**{k: v for k, v in report.items()
                         if k != "launch_statement"},
                      "epochs": e, "window": window,
                      "dense_threshold": threshold,
                      "ms_per_step": out["seconds"] / e * 1e3,
                      "losses_first_last": [float(losses[0]),
                                            float(losses[-1])],
                      "logits_vs_single_device_rel_err": err,
                      "tol": PARTITION_TOL[what], **accs}
    return _finish({"phase": "slice_partition", "group": "nccl, 1 rank",
                    "runs": runs, "launches": launches,
                    "expected_launches": expected,
                    "launch_statement": statement}, problems)


def _nograd(fn):
    def call():
        with torch.no_grad():
            return fn()
    return call


def _aug_edges(graph):
    """The remove-then-add self-loop edge set of a GraphPartition on the
    host, with its GCN weights and receiver order."""
    from pytorch_geometric_tpu_torch.examples.distributed_gcn import (
        partition_edges)

    s, r = partition_edges(graph)
    loop = np.arange(graph.num_nodes)
    s, r = np.concatenate([s, loop]), np.concatenate([r, loop])
    order = np.argsort(r, kind="stable")
    s, r = s[order], r[order]
    deg = np.bincount(r, minlength=graph.num_nodes).astype(np.float64)
    return s, r, (deg[s] ** -0.5 * deg[r] ** -0.5).astype(np.float32)


def _shard_exchange(sends):
    """What the all-to-all delivers to every shard: the (P, P, H, F) stack
    of the send buffers transposed on its first two axes."""
    return list(torch.stack(sends).transpose(0, 1))


def phase_partition_shards():
    """A real multi-shard halo on one card, in one process: P = 4
    GraphPartitions of synthetic Cora (window 256, dense threshold 128;
    dense blocks asserted) and of RCM-reordered synthetic PubMed (the
    defaults), every shard's operators on the card. Each shard's
    send_rows (or halo_send), the exchange as the stacked send buffers'
    transpose (what all_to_all delivers, tests/test_torch_port_partition.py
    holds the two equal), then combine (the partitioned GCN SpMM),
    halo_gat_combine (8 heads x 8) and, on Cora with 3 relations,
    halo_rgcn_combine; the unsharded results against one whole-graph
    spmm_csr, packed GAT and relation-major spmm_csr on the card
    (relative L2 2e-2 for the bf16 SpMM, 1e-5 for the fp32 ones); each
    shard's call and the whole-graph one timed in CUDA graphs of 50
    calls (a record of what the partition costs on one card)."""
    from pytorch_geometric_tpu_torch.datasets.synthetic import (
        synthetic_citation_graph)
    from pytorch_geometric_tpu_torch.data import from_data
    from pytorch_geometric_tpu_torch.ops.packed_gat import PackedFlashGat
    from pytorch_geometric_tpu_torch.ops.spmm import (
        SpmmOperator, pack_bipartite_tables, spmm_bi_static)
    from pytorch_geometric_tpu_torch.parallel.api import GraphPartition
    from pytorch_geometric_tpu_torch.parallel.partition import (
        halo_gat_combine, halo_rgcn_combine, halo_send)
    from pytorch_geometric_tpu_torch.transforms import NormalizeFeatures

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    P, H, C, F, R = SHARDS, 8, 8, 16, 3
    _, pubmed, _ = pubmed_graph(device="cpu")
    cora = from_data(NormalizeFeatures()(synthetic_citation_graph(
        "cora", seed=SEED)), device="cpu")
    problems, cases = [], []
    for name, graph, kw in (("cora", cora, dict(window=256,
                                                 dense_threshold=128)),
                            ("pubmed_rcm", pubmed, {})):
        from pytorch_geometric_tpu_torch.examples.distributed_gcn import (
            partition_edges)

        N = graph.num_nodes
        s, r = partition_edges(graph)
        et = np.random.default_rng(SEED).integers(0, R, len(s)) \
            if name == "cora" else None
        t0 = time.perf_counter()
        part = GraphPartition(s, r, N, P, device=DEVICE, edge_type=et,
                              num_relations=R if et is not None else 0,
                              **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        consts = part.stacked_consts()
        op = part.ops["gcn"]
        if name == "cora" and op.num_dense_blocks == 0:
            problems.append("cora: no dense block at window 256 / 128")
        sa, ra, wa = _aug_edges(graph)
        base = {"graph": name, "shards": P, "nodes": N,
                "nodes_per_shard": part.shards.nodes_per_shard,
                "halo_size": part.shards.halo_size,
                "dense_blocks": op.num_dense_blocks,
                "build_seconds": build_s,
                "comm": part.comm_stats(F)}

        def record(kernel, what, got, want, tol, metric, shard_fns,
                   whole_fn):
            err = float(torch.linalg.vector_norm(got - want)
                        / torch.linalg.vector_norm(want)) \
                if metric == "rel_l2" else _rel(got, want)
            shard_ms = [device_ms(_nograd(fn)) for fn in shard_fns]
            case = {"phase": "partition_shards", "kernel": kernel,
                    "operator": what, **base, "err": err, "metric": metric,
                    "tol": tol, "shard_ms": shard_ms,
                    "shards_ms_sum": float(sum(shard_ms)),
                    "whole_graph_ms": device_ms(_nograd(whole_fn))}
            emit(case)
            cases.append(case)
            if not err <= tol:
                problems.append(f"{name} {what}: err {err} > {tol}")

        # the partitioned GCN SpMM (bf16 halo rows)
        x = torch.randn(N, F, generator=gen, device=DEVICE)
        x_sh = part.shard_nodes(x)
        with torch.no_grad():
            sends = [op.send_rows(consts[p]["gcn"], x_sh[p])
                     for p in range(P)]
            recv = _shard_exchange(sends)
            got = part.unshard_nodes(torch.stack([
                op.combine(consts[p]["gcn"], x_sh[p], recv[p])
                for p in range(P)]).cpu())
        whole = SpmmOperator(sa, ra, N, device=DEVICE).bind(wa)
        with torch.no_grad():
            want = whole(x)
        record("spmm_csr", "partitioned_spmm", torch.from_numpy(got),
               want.cpu(), 2e-2, "rel_l2",
               [functools.partial(op.combine, consts[p]["gcn"], x_sh[p],
                                  recv[p]) for p in range(P)],
               lambda: whole(x))

        # halo_gat: [a_src | h] rows cross in fp32
        h = torch.randn(N, H * C, generator=gen, device=DEVICE)
        a_s = torch.randn(N, H, generator=gen, device=DEVICE)
        a_d = torch.randn(N, H, generator=gen, device=DEVICE)
        h_sh, as_sh, ad_sh = (part.shard_nodes(t) for t in (h, a_s, a_d))
        tables = [consts[p]["tables"] for p in range(P)]
        HS = part.shards.halo_size
        sends = [halo_send(torch.cat([as_sh[p], h_sh[p]], 1), tables[p], HS,
                           P) for p in range(P)]
        recv = _shard_exchange(sends)

        def gat_shard(p):
            return halo_gat_combine(h_sh[p], as_sh[p], ad_sh[p], recv[p],
                                    consts[p]["gat_op"], H)

        with torch.no_grad():
            got = part.unshard_nodes(torch.stack(
                [gat_shard(p) for p in range(P)]).cpu())
        whole_gat = PackedFlashGat(senders=sa, receivers=ra, num_nodes=N,
                                   device=DEVICE)
        with torch.no_grad():
            want = whole_gat(a_d, a_s, h, 0)
        record("packed_gat_fwd", "halo_gat", torch.from_numpy(got),
               want.cpu(), TOL["fp32"], "max_rel",
               [functools.partial(gat_shard, p) for p in range(P)],
               lambda: whole_gat(a_d, a_s, h, 0))

        if et is None:
            continue
        # halo_rgcn: one relation-major spmm_csr a shard
        basis = torch.randn(2, F, C, generator=gen, device=DEVICE)
        comb = torch.randn(R, 2, generator=gen, device=DEVICE)
        root = torch.randn(F, C, generator=gen, device=DEVICE)
        sends = [halo_send(x_sh[p], tables[p], HS, P) for p in range(P)]
        recv = _shard_exchange(sends)

        def rgcn_shard(p):
            return halo_rgcn_combine(x_sh[p], recv[p], basis, comb,
                                     consts[p]["rgcn_op"], root)

        with torch.no_grad():
            got = part.unshard_nodes(torch.stack(
                [rgcn_shard(p) for p in range(P)]).cpu())
        fused = r * R + et
        cnt = np.bincount(fused, minlength=N * R)
        w_rel = (1.0 / cnt[fused]).astype(np.float32)
        geom, wconsts = pack_bipartite_tables(
            s, et * N + r, N, R * N, w_rel, compute_dtype=torch.float32,
            directions=("fwd",), device=DEVICE)

        def rgcn_whole():
            aggs = spmm_bi_static(geom, wconsts, x).reshape(R, N, F)
            W = torch.einsum("rb,bfc->rfc", comb, basis)
            return torch.einsum("rnf,rfc->nc", aggs, W) + x @ root

        with torch.no_grad():
            want = rgcn_whole()
        record("spmm_csr", "halo_rgcn", torch.from_numpy(got), want.cpu(),
               TOL["fp32"], "max_rel",
               [functools.partial(rgcn_shard, p) for p in range(P)],
               rgcn_whole)
    return _finish({"phase": "partition_shards", "cases": cases}, problems)


CHECK_EPOCHS = 5


#: The port's tool scripts (pytorch_geometric_tpu_torch/tools/), each run
#: in-process at its defaults, one point: phase -> (module, argv, the
#: kernels it must launch).
TOOL_PHASES = {
    "tool_gat_sweep": ("gat_sweep", [], ("packed_gat_fwd",
                                         "packed_gat_bwd")),
    "tool_rgcn_sweep": ("rgcn_sweep", ["--epoch"], ("packed_rgcn_fwd",
                                                    "packed_rgcn_bwd")),
    "tool_profile_epoch": ("profile_epoch", [], ("packed_rgcn_fwd",
                                                 "packed_rgcn_bwd")),
    "tool_reddit": ("probe_reddit", [], ("spmm_csr",)),
}


def phase_tool(phase):
    """One tool script's ``main`` at its defaults (``TOOL_PHASES``): its
    records (each checks its operator against the plain version before
    it times anything, and raises on a mismatch), the wrappers' launches
    over the run (a captured epoch's replays make none: the warm-up and
    the capture count), which must include each kernel the tool runs."""
    import contextlib
    import importlib
    import io

    from pytorch_geometric_tpu_torch.models.capture import launch_counts

    name, argv, kernels = TOOL_PHASES[phase]
    tool = importlib.import_module(f"pytorch_geometric_tpu_torch.tools."
                                   f"{name}")
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        records = tool.main(argv)
    torch.cuda.synchronize()
    result = {"phase": phase, "tool": name, "argv": argv,
              "seconds": time.perf_counter() - t0, "records": records,
              "launches": _launch_diff(before)}
    emit(result)
    missing = [k for k in kernels if not result["launches"].get(k)]
    if missing:
        raise AssertionError(f"{phase}: no launch of {missing}")
    return result


def phase_capture_check():
    """For each configuration, five epochs captured and five eager from
    the same seeds: the trained logits and every parameter within 1e-6 of
    the largest magnitude. One line per configuration."""
    rows, problems = [], []
    for config in CONFIGS:
        model, captured = train(config, CHECK_EPOCHS)
        eager_model, eager = train(config, CHECK_EPOCHS, capture=False)
        ref = dict(eager_model.named_parameters())
        params = max(_rel(p.detach(), ref[n].detach())
                     for n, p in model.named_parameters())
        logits = _rel(logits_of(config, model),
                      logits_of(config, eager_model))
        curve = float(np.abs(captured["curve"]["loss"]
                             - eager["curve"]["loss"]).max())
        row = {"phase": "capture_check", "config": config,
               "epochs": CHECK_EPOCHS, "logits_rel_err": logits,
               "params_rel_err": params, "loss_curve_max_abs_err": curve,
               "tol": 1e-6, "ok": logits <= 1e-6 and params <= 1e-6}
        emit(row)
        rows.append(row)
        if not row["ok"]:
            problems.append(f"{config}: captured vs eager logits {logits}, "
                            f"parameters {params} (need <= 1e-6)")
    if problems:
        raise AssertionError("; ".join(problems))
    return rows


def phase_trace(config="gcn", capture=False, epochs=20):
    """Where an epoch's time goes: ``torch.profiler`` over ``epochs``
    epochs of the config's training step after warm-up, eager calls or
    (``capture``) replays of the epoch captured as the trainers capture
    it; device busy time per kernel name against the host's wall clock,
    and the port's kernel launches per epoch counted from the device
    events, which must equal the config's count (the eager trace's too).
    Launches here come after the slices' counts were read."""
    from pytorch_geometric_tpu_torch.models.capture import (
        capture_epoch, warm_up)

    step, gen = epoch_step_of(config)
    dev = torch.device(DEVICE)
    if capture:
        warm_up(lambda: step(gen), dev)
        graph = capture_epoch(lambda: step(gen), gen, dev)
        run = graph.replay
    else:
        run = lambda: step(gen)   # noqa: E731
    kernels, wall_us = profile_steps(run, epochs)
    summary, port_launches = trace_summary(kernels, wall_us, epochs)
    want = CONFIGS[config][4]
    eager_phase = "trace" if config == "gcn" else f"trace_{config}"
    result = {"phase": f"trace_captured_{config}" if capture
              else eager_phase, "config": config, "captured": capture,
              "epochs": epochs, **summary,
              "expected_port_launches_per_epoch": want}
    emit(result)
    if port_launches != want * epochs:
        raise AssertionError(f"{config}: {port_launches / epochs} port "
                             f"kernel launches per epoch on the trace, "
                             f"expected {want}")
    return result


def phase_trace_ppi(steps=20):
    """Where a PPI training step's time goes: ``torch.profiler`` over
    ``steps`` eager steps of examples/ppi.py's ``train_step`` (a fresh
    ``Net``, Adam) cycling over the 20 train batches, collated and their
    operators built before the window; then over ``steps`` replays of the
    step captured over its static batch (:func:`trace_captured_step`);
    9 port launches a step in both."""
    from pytorch_geometric_tpu_torch.examples import ppi

    train, _ = ppi.load(SEED, device=DEVICE)
    ops = ppi.OperatorCache()
    batches = [(graph, ops(idx, graph)) for idx, graph in train.indexed()]
    model = ppi.Net(generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    cycle = itertools.cycle(batches)

    def run():
        graph, op = next(cycle)
        ppi.train_step(model, opt, graph, op)

    kernels, wall_us = profile_steps(run, steps)
    summary, port_launches = trace_summary(kernels, wall_us, steps, "step")
    want = sum(PPI_STEP_LAUNCHES.values())
    result = {"phase": "trace_ppi", "captured": False, "steps": steps,
              **summary, "expected_port_launches_per_step": want}
    emit(result)
    if port_launches != want * steps:
        raise AssertionError(f"ppi: {port_launches / steps} port kernel "
                             f"launches per step on the trace, expected "
                             f"{want}")
    captured = trace_captured_step(
        ppi, train, [(graph, {"flash_op": op}) for graph, op in batches],
        ppi.Net(generator=torch.Generator().manual_seed(SEED)), 5e-3,
        steps, want, "ppi")
    return {"eager": result, "captured": captured}


def trace_captured_step(module, loader, batches, model, lr, steps, want,
                        name, **kw):
    """Where a captured training step's time goes: ``torch.profiler`` over
    ``steps`` calls of the example's captured training step
    (``module.captured_steps``, given ``kw``: a ``CapturedStep`` over its
    static batch of ``loader``'s budget), each after the next of
    ``batches`` (collated on the card, their operators built before the
    window) is copied into the static buffers, device to device;
    ``model`` on the card, Adam (capturable) at ``lr``. ``want`` port
    launches a step."""
    dev = torch.device(DEVICE)
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=True)
    # profile_steps calls the step 8 + steps times
    static, _, step, _, _ = module.captured_steps(model, opt, loader, loader,
                                                  8 + steps, dev, **kw)
    cycle = itertools.cycle(batches)

    def run():
        static.load(*next(cycle))
        step()

    kernels, wall_us = profile_steps(run, steps)
    summary, port_launches = trace_summary(kernels, wall_us, steps, "step")
    result = {"phase": f"trace_{name}", "captured": True, "steps": steps,
              **summary, "expected_port_launches_per_step": want}
    emit(result)
    if port_launches != want * steps:
        raise AssertionError(f"{name}: {port_launches / steps} port kernel "
                             f"launches per captured step on the trace, "
                             f"expected {want}")
    return result


def trace_pair(name, make_step, batches, static, steps, want, **extra):
    """Where a step's time goes, eager and captured: ``torch.profiler``
    over ``steps`` calls of a training step cycling over ``batches``
    (``(graph, ops)`` on the card, collated and built before the window),
    then over ``steps`` replays of the same step, from a fresh model of
    the same seed, captured over ``static`` (a ``StaticBatch`` of the
    loader's budget; ``models/capture.py:CapturedStep``), each after the
    next batch is copied in device to device. ``make_step()`` returns
    ``(step(graph, ops), generator)``, the generator the step's dropout
    draws from (registered with the graph) or None. ``want`` port
    launches a step in both; a ``trace_<name>`` line each, ``"captured"``
    false, then true."""
    from pytorch_geometric_tpu_torch.models.capture import CapturedStep

    out = {}
    for captured in (False, True):
        step, gen = make_step()
        cycle = itertools.cycle(batches)
        if captured:
            replay = CapturedStep(lambda: step(static.graph, static.ops),
                                  torch.device(DEVICE), generator=gen)

            def run():
                static.load(*next(cycle))
                replay()
        else:
            def run():
                step(*next(cycle))
        kernels, wall_us = profile_steps(run, steps)
        summary, port_launches = trace_summary(kernels, wall_us, steps,
                                               "step")
        result = {"phase": f"trace_{name}", "captured": captured,
                  "steps": steps, **extra, **summary,
                  "expected_port_launches_per_step": want}
        emit(result)
        if port_launches != want * steps:
            raise AssertionError(f"{name}: {port_launches / steps} port "
                                 f"kernel launches per step on the trace "
                                 f"(captured {captured}), expected {want}")
        out["captured" if captured else "eager"] = result
    return out


def _adam_step(model, loss_of, lr, generator=None):
    """A training step of ``model`` (Adam ``lr``, capturable, gradients
    zeroed in place): ``step(graph, ops)`` of ``loss_of(graph, ops)``."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=True)

    def step(graph, ops):
        opt.zero_grad(set_to_none=False)
        loss_of(graph, ops).backward()
        opt.step()

    return step, generator


def phase_trace_faust(steps=20):
    """Where a FAUST training step's time goes (:func:`trace_pair`):
    examples/faust.py's ``train_step`` (a fresh ``Net``, Adam 1e-2,
    dropout on) cycling over the first ``steps`` train batches, collated
    and their operators built before the window, eager and then captured
    over the static batch of the loader's budget; 11 port launches a
    step in both."""
    from pytorch_geometric_tpu_torch.examples import faust
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    train, _ = faust_loaders()
    ops = OperatorCache(faust.faust_spline_op)
    batches = [(graph, {"spline_op": ops(idx, graph)}) for idx, graph in
               itertools.islice(train.indexed(), steps)]

    def make_step():
        model = faust.Net(train.dataset[0].num_nodes, generator=torch
                          .Generator().manual_seed(SEED)).to(DEVICE)
        drop = torch.Generator(device=DEVICE).manual_seed(SEED)
        return _adam_step(model, lambda graph, o: faust.nll_loss(model(
            graph, train=True, spline_op=o["spline_op"], generator=drop),
            graph), 1e-2, drop)

    return trace_pair("faust", make_step, batches,
                      faust.static_batch(train, DEVICE), steps,
                      sum(FAUST_STEP_LAUNCHES.values()))


def phase_trace_pointnet2(steps=20):
    """Where a pointnet2 training step's time goes (:func:`trace_pair`):
    examples/pointnet2.py's step (a fresh ``Net``, Adam 1e-3) cycling
    over one epoch's train batches with their level-2 gather operators,
    eager and then captured over the static batch of the loader's
    budget; 1 port launch a step (the gather's gradient)."""
    from pytorch_geometric_tpu_torch.examples import pointnet2

    train = point_loaders("pointnet2")[0]
    batches = [(graph, pointnet2.pointnet2_operators(graph))
               for graph in train]

    def make_step():
        model = pointnet2.Net(generator=torch.Generator().manual_seed(
            SEED)).to(DEVICE)
        return _adam_step(model, lambda graph, o: pointnet2.loss_of(
            model(graph, **o), graph), 1e-3)

    return trace_pair("pointnet2", make_step, batches,
                      pointnet2.static_batch(train, DEVICE), steps,
                      sum(POINT_EXAMPLES["pointnet2"][1].values()))


def phase_trace_driver_inductive(steps=10):
    """Where the research driver's inductive steps' time goes
    (:func:`trace_pair`, 10 steps): PrunableTopK on ENZYMES (batches of
    64, the driver's three layers at their widths, Adam 5e-4, dropout
    on; 8 port launches a step) and PrunableGCN on PPI (batches of 2, two
    layers, Adam 5e-3, dropout on; 6 port launches a step), each cycling
    over one epoch's train batches
    with their operators, eager and then captured over the model's static
    operator forms (``research/driver.py:static_pair``)."""
    from pytorch_geometric_tpu_torch.data import DataLoader
    from pytorch_geometric_tpu_torch.datasets import PPI, TUDataset
    from pytorch_geometric_tpu_torch.datasets.graphs import PLANETOID_ROOT
    from pytorch_geometric_tpu_torch.examples.ppi import bce_loss
    from pytorch_geometric_tpu_torch.models.graph_pred import graph_xent_loss
    from pytorch_geometric_tpu_torch.models.prunable import choose_model
    from pytorch_geometric_tpu_torch.research import driver
    from pytorch_geometric_tpu_torch.research.pruning import (
        contraction_layer_coefficients)

    root = str(PLANETOID_ROOT)
    enz = TUDataset(root, "ENZYMES").shuffle(seed=SEED)
    cases = {
        "topk": (DataLoader(enz[len(enz) // 10:], batch_size=64,
                            shuffle=True, seed=SEED, device=DEVICE),
                 ("TopK", 128, 3, 6, 3), 5e-4,
                 lambda m, g, o, gen: graph_xent_loss(
                     m(g, train=True, generator=gen, **o), g.y,
                     g.graph_mask)),
        "ppi_gcn": (DataLoader(PPI(root, split="train"), batch_size=2,
                               shuffle=True, seed=SEED, device=DEVICE),
                    ("GCN", 50, 2, 121, 50), 5e-3,
                    lambda m, g, o, gen: bce_loss(
                        m(g, g.x, train=True, generator=gen, **o), g))}
    out = {}
    for case, (loader, (name, width, layers, classes, f_in), lr,
               loss_of) in cases.items():
        widths = contraction_layer_coefficients(width, layers, 0.5,
                                                seed=SEED)

        def make_step():
            model = choose_model(name, widths, classes, in_channels=f_in,
                                 generator=torch.Generator().manual_seed(
                                     SEED)).to(DEVICE)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            return _adam_step(model, lambda g, o: loss_of(model, g, o, gen),
                              lr, gen)

        # the operators are the graph's: any model of the class builds them
        model = choose_model(name, widths, classes, in_channels=f_in)
        batches = [(g, model.operators(g)) for g in loader]
        static = driver.static_pair(model, (loader, loader),
                                    torch.device(DEVICE))[0]
        want = sum(DRIVER_INDUCTIVE_LAUNCHES[
            "enzymes" if name == "TopK" else "ppi"][0].values())
        out[case] = trace_pair("driver_inductive", make_step, batches,
                               static, steps, want, path=case)
    return out


def phase_trace_mutag_gin(steps=20):
    """Where a MUTAG training step's time goes: ``torch.profiler`` over
    ``steps`` eager steps of examples/mutag_gin.py's ``train_step`` (a
    fresh ``Net``, Adam 0.01) cycling over one epoch's train batches,
    collated and their operator sets built before the window; then over
    ``steps`` replays of the step captured over its static batch
    (:func:`trace_captured_step`); 10 port launches a step in both."""
    from pytorch_geometric_tpu_torch.examples import mutag_gin
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    train, _ = mutag_gin.load(SEED, device=DEVICE)
    ops = OperatorCache(mutag_gin.mutag_operators)
    batches = [(graph, ops(idx, graph)) for idx, graph in train.indexed()]
    model = mutag_gin.Net(generator=torch.Generator().manual_seed(
        SEED)).to(DEVICE)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    cycle = itertools.cycle(batches)

    def run():
        graph, op = next(cycle)
        mutag_gin.train_step(model, opt, graph, op)

    kernels, wall_us = profile_steps(run, steps)
    summary, port_launches = trace_summary(kernels, wall_us, steps, "step")
    want = sum(MUTAG_STEP_LAUNCHES.values())
    result = {"phase": "trace_mutag_gin", "captured": False, "steps": steps,
              "operator_sets": len(ops.ops),
              "operator_setup_ms_per_batch": ops.seconds / len(ops.ops) * 1e3,
              **summary, "expected_port_launches_per_step": want}
    emit(result)
    if port_launches != want * steps:
        raise AssertionError(f"mutag_gin: {port_launches / steps} port "
                             f"kernel launches per step on the trace, "
                             f"expected {want}")
    captured = trace_captured_step(
        mutag_gin, train, batches,
        mutag_gin.Net(generator=torch.Generator().manual_seed(SEED)), 0.01,
        steps, want, "mutag_gin")
    return {"eager": result, "captured": captured}


def phase_trace_qm9(steps=20):
    """Where a QM9 training step's time goes: ``torch.profiler`` over
    ``steps`` eager steps of examples/qm9_nn_conv.py's ``train_step`` (a
    fresh ``Net``, dim 64, Adam 1e-3) cycling over one epoch's train
    batches, collated and their operator sets (over the real entries)
    built before the window; then over ``steps`` replays of the step
    captured over its static batch (:func:`trace_captured_step`); 18 port
    launches a step in both (``GRAPH_EXAMPLES``)."""
    from pytorch_geometric_tpu_torch.examples import qm9_nn_conv
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    train, _, mean, std = qm9_nn_conv.load(SEED, device=DEVICE)
    ops = OperatorCache(qm9_nn_conv.qm9_operators)
    batches = [(graph, ops(idx, graph)) for idx, graph in train.indexed()]
    model = qm9_nn_conv.Net(generator=torch.Generator().manual_seed(
        SEED)).to(DEVICE)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    cycle = itertools.cycle(batches)

    def run():
        graph, op = next(cycle)
        qm9_nn_conv.train_step(model, opt, graph, op, mean, std)

    kernels, wall_us = profile_steps(run, steps)
    summary, port_launches = trace_summary(kernels, wall_us, steps, "step")
    want = sum(GRAPH_EXAMPLES["qm9"][2].values())
    result = {"phase": "trace_qm9", "captured": False, "steps": steps,
              "operator_sets": len(ops.ops),
              "operator_setup_ms_per_batch": ops.seconds / len(ops.ops) * 1e3,
              **summary, "expected_port_launches_per_step": want}
    emit(result)
    if port_launches != want * steps:
        raise AssertionError(f"qm9: {port_launches / steps} port kernel "
                             f"launches per step on the trace, expected "
                             f"{want}")
    captured = trace_captured_step(
        qm9_nn_conv, train, batches,
        qm9_nn_conv.Net(generator=torch.Generator().manual_seed(SEED)),
        1e-3, steps, want, "qm9", mean=mean, std=std)
    return {"eager": result, "captured": captured}


def phase_trace_enzymes(steps=10):
    """Where an ENZYMES training step's time goes: ``torch.profiler`` over
    ``steps`` (10) eager steps of examples/enzymes_topk_pool.py's
    ``train_step`` (a fresh ``Net``, Adam 5e-4, dropout on) cycling over
    one epoch's train batches, collated and their operator sets built
    before the window, then over ``steps`` replays of the step captured
    over its static batch (:func:`trace_captured_step`; 8 port launches a
    step in both, ``GRAPH_EXAMPLES``); and the same for
    examples/enzymes_diff_pool.py's dense step (Adam 1e-3) over its full
    batches of 32, captured through ``SizedStep`` (no port kernel)."""
    from pytorch_geometric_tpu_torch.examples import (
        enzymes_diff_pool, enzymes_topk_pool)
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    dev = torch.device(DEVICE)
    out = {}
    train, _ = enzymes_topk_pool.load(SEED, device=DEVICE)
    ops = OperatorCache(enzymes_topk_pool.mutag_operators)
    batches = [(graph, ops(idx, graph)) for idx, graph in train.indexed()]
    want = sum(GRAPH_EXAMPLES["topk"][2].values())

    def net():
        return enzymes_topk_pool.Net(3, 6, generator=torch.Generator()
                                     .manual_seed(SEED)).to(DEVICE)

    model = net()
    opt = torch.optim.Adam(model.parameters(), lr=5e-4,
                           capturable=dev.type == "cuda")
    drop = torch.Generator(device=DEVICE).manual_seed(SEED)
    cycle = itertools.cycle(batches)

    def topk_step():
        enzymes_topk_pool.train_step(model, opt, *next(cycle), drop)

    kernels, wall_us = profile_steps(topk_step, steps)
    summary, port_launches = trace_summary(kernels, wall_us, steps, "step")
    out["topk"] = {"phase": "trace_enzymes", "example": "topk",
                   "captured": False, "steps": steps, **summary,
                   "expected_port_launches_per_step": want}
    emit(out["topk"])
    if port_launches != want * steps:
        raise AssertionError(f"topk: {port_launches / steps} port kernel "
                             f"launches per step on the trace, expected "
                             f"{want}")
    out["topk_captured"] = trace_captured_step(
        enzymes_topk_pool, train, batches, net(), 5e-4, steps, want, "topk",
        generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    train, _ = enzymes_diff_pool.load(SEED, device=DEVICE)
    full = [b for b in train if b.num_graphs == train.batch_size]
    for captured in (False, True):
        model = enzymes_diff_pool.DiffPoolNet(
            3, 6, generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                               capturable=dev.type == "cuda")
        cycle = itertools.cycle(full)
        if captured:
            step = enzymes_diff_pool.SizedStep(
                lambda b: enzymes_diff_pool.train_step(model, opt, b), dev,
                {})
        else:
            def step(b):
                enzymes_diff_pool.train_step(model, opt, b)
        kernels, wall_us = profile_steps(lambda: step(next(cycle)), steps)
        summary, port_launches = trace_summary(kernels, wall_us, steps,
                                               "step")
        key = "diff_pool_captured" if captured else "diff_pool"
        out[key] = {"phase": "trace_enzymes", "example": "diff_pool",
                    "captured": captured, "steps": steps, **summary,
                    "expected_port_launches_per_step": 0}
        emit(out[key])
        if port_launches:
            raise AssertionError(f"diff_pool: {port_launches} port kernel "
                                 f"launches on the trace, expected none")
    return out


#: The full-batch paths of ``trace_spans``: their port launches an epoch.
SPAN_TRACES = {
    "gae": AUTOENCODER_LAUNCHES[False][0],
    "vgae": AUTOENCODER_LAUNCHES[True][0],
    "infomax": {"spmm_csr": INFOMAX_LAUNCHES[0]},
    "mygcn": {"spmm_csr": MYGCN_LAUNCHES[0]},
    "driver_gcn": DRIVER_STEP_LAUNCHES["GCN"],
    "driver_gat": DRIVER_STEP_LAUNCHES["GAT"]}


def _spans_of(name, capture, tmp):
    """The ``EpochSpans`` of a one-epoch run of a full-batch path, as a
    user runs it at its full width (``capture`` None: captured)."""
    import contextlib
    import io

    from pytorch_geometric_tpu_torch.examples import (
        autoencoder, infomax, mygcn)
    from pytorch_geometric_tpu_torch.models.prunable import choose_model
    from pytorch_geometric_tpu_torch.research import driver
    from pytorch_geometric_tpu_torch.research.pruning import (
        contraction_layer_coefficients)

    with contextlib.redirect_stdout(io.StringIO()):
        if name in ("gae", "vgae"):
            return autoencoder.run(name == "vgae", 1, SEED, DEVICE,
                                   capture=capture)["spans"]
        if name == "infomax":
            return infomax.run(1, SEED, 512, DEVICE,
                               capture=capture)["spans"]
        if name == "mygcn":
            return mygcn.run(epochs=1, ckpt_dir=tmp, device=DEVICE,
                             capture=capture)["spans"]
    ds, graph = driver.load_citation_dataset("Cora", device=DEVICE)
    model = choose_model(
        name.split("_")[1].upper(),
        contraction_layer_coefficients(graph.num_node_features, 2, 0.5,
                                       seed=SEED), ds.num_classes,
        in_channels=graph.num_node_features,
        generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    return driver.train_part(model, graph, None, 1, seed=SEED,
                             apply_kwargs=model.operators(graph),
                             capture=capture).spans


def phase_trace_spans(steps=10):
    """Where a full-batch epoch's time goes: for the GAE, the VGAE,
    infomax (hidden 512), mygcn and the research driver's GCN and GAT at
    their widths on Cora, a one-epoch run as a user runs it, then
    ``torch.profiler`` over ``steps`` (10) more of its epochs
    (``EpochSpans.again``), eager and captured; the port launches an
    epoch asserted in both (``SPAN_TRACES``)."""
    import tempfile

    out = {}
    for name, launches in SPAN_TRACES.items():
        want = sum(launches.values())
        for capture in (False, None):
            with tempfile.TemporaryDirectory() as tmp:
                spans = _spans_of(name, capture, tmp).again(8 + steps)
                kernels, wall_us = profile_steps(spans.step, steps)
            summary, port_launches = trace_summary(kernels, wall_us, steps)
            key = name if capture is False else f"{name}_captured"
            out[key] = {"phase": "trace_spans", "path": name,
                        "captured": capture is None, "epochs": steps,
                        **summary, "expected_port_launches_per_epoch": want}
            emit(out[key])
            if port_launches != want * steps:
                raise AssertionError(
                    f"{key}: {port_launches / steps} port kernel launches "
                    f"an epoch on the trace, expected {want}")
    return out


# ---------------------------------------------------------------------------
# The point and superpixel examples and the scale SpMM operators
# ---------------------------------------------------------------------------

#: examples/mnist_graclus.py's default epochs, and the launches of one
#: training step (the two levels' spline operators forward and conv2's
#: ``dx``, conv1's input taking none; both pools' means of ``pos`` and the
#: readout, whose backward is a gather) and of one evaluation batch.
MNIST_EPOCHS = 3
MNIST_STEP_LAUNCHES = {"spmm_csr": 3, "sorted_segment_sum": 3}
MNIST_EVAL_LAUNCHES = {"spmm_csr": 2, "sorted_segment_sum": 3}
#: The other point and superpixel examples at their default epochs, and
#: the launches of a training step and of an evaluation batch:
#: mnist_voxel_grid trains mnist_graclus's Net over voxel levels;
#: mnist_nn_conv sums both levels' NNConv messages, both pools' means and
#: the readout (5 segment sums forward), and conv2's gather of its input
#: by sender sums its gradient (1 backward); pointnet2's reductions are
#: all maxima (torch's ``scatter_reduce``), and its level-2 gather by
#: sender sums its gradient (1 backward).
POINT_EXAMPLES = {
    "mnist_voxel_grid": (3, MNIST_STEP_LAUNCHES, MNIST_EVAL_LAUNCHES),
    "mnist_nn_conv": (3, {"sorted_segment_sum": 6},
                      {"sorted_segment_sum": 5}),
    "pointnet2": (3, {"sorted_segment_sum": 1}, {}),
}
#: The examples whose training step and evaluation a card captures
#: (``run(capture=None)``); each slice runs them captured, then eagerly,
#: and holds the two runs bitwise equal (the key of the run's test
#: metric).
CAPTURED_EXAMPLES = {"mnist_graclus": "acc", "mnist_voxel_grid": "acc",
                     "mnist_nn_conv": "acc", "qm9": "mae", "topk": "acc",
                     "diff_pool": "acc", "pointnet2": "acc"}
MNIST_CASES = ("mnist_conv1", "mnist_conv2", "mnist_pool1", "mnist_pool2",
               "mnist_readout", "mnist_nnconv1", "mnist_nnconv2")
#: The block SpMM's graph: bench_scale.py's community graph at Reddit's
#: published size (232,965 nodes, 114,615,892 edges, 200 communities,
#: 90% of the edges inside one), the JAX defaults' windows of 1024 and
#: dense threshold 1024, at Reddit's 602 features and reddit_sage's 128.
SCALE_COMMUNITIES = 200
SCALE_WINDOW = 1024
SCALE_THRESHOLD = 1024
SCALE_WIDTHS = (602, 128)
#: Rows of the scale graph the fp32 plain version sums (~1 M entries).
SCALE_CHECK_ROWS = 2000
#: examples/gcn.py's Cora through the JAX ``pallas=True`` windows.
HYBRID_WINDOW, HYBRID_TILE = 512, 512


def fresh_point_loaders(name, device=DEVICE):
    """New seeded default loaders of a point or superpixel example on
    ``device`` (mnist_nn_conv's are mnist_voxel_grid's at its 1000
    samples): a loader draws its batch order as it goes, so two runs that
    must see the same batches each take their own."""
    import importlib

    if name == "mnist_nn_conv":
        from pytorch_geometric_tpu_torch.examples import mnist_voxel_grid

        return mnist_voxel_grid.load(SEED, 64, 1000, device=device)
    m = importlib.import_module(
        f"pytorch_geometric_tpu_torch.examples.{name}")
    return m.load(SEED, device=device)


@functools.cache
def point_loaders(name, device=DEVICE):
    """:func:`fresh_point_loaders`, built once per run and device."""
    return fresh_point_loaders(name, device)


def _example_module(name):
    import importlib

    return importlib.import_module(
        f"pytorch_geometric_tpu_torch.examples.{name}")


def phase_kernel_mnist(gen):
    """The kernels at the superpixel examples' shapes, fp32, on the first
    train batch of mnist_graclus's loader (64 graphs of 75 nodes, N =
    6144, E = 49,152, 1,344 padding nodes): ``spmm_csr`` on conv1's
    spline operator (N·25 rows) at F = 1 and on conv2's (level 1) at
    F = 32 forward and ``dx``; the segment sum of pool 1's mean of pos
    (F = 3: pos and the count), pool 2's, and the readout (F = 65: 64
    channels and the count), each over the batch's real entries and, in
    the same call, over every slot (the padding nodes' row N - 1; level
    2's unoccupied rows on the padding graph's row), the two bitwise
    equal (:func:`check_real_vs_padded`); and on mnist_voxel_grid's
    first batch, mnist_nn_conv's NNConv sums by receiver over the real
    edges (F = 32 at level 0, against the padded operator's row of the
    padding edges; 64 at level 1) and conv2's gather by sender (its
    backward's sum, F = 32); and pointnet2's level-2 gather by sender
    over the first train batch's real entries (``pointnet2_operators``;
    its backward's sum at sa1's F = 128)."""
    from pytorch_geometric_tpu_torch.examples import mnist_graclus as mg

    cases = []
    graph = next(iter(point_loaders("mnist_graclus")[0]))
    ops = mg.mnist_operators(graph)
    for name, op, widths in (("mnist_conv1", ops["conv1"], (("fwd", 1),)),
                             ("mnist_conv2", ops["conv2"],
                              (("fwd", 32), ("bwd", 32)))):
        geom, consts = op.args
        for direction, f in widths:
            cases.append(check_case(name, getattr(geom, direction),
                                    consts[direction], direction, f, "fp32",
                                    gen))
    for name, key, f in (("mnist_pool1", "pool1", 3),
                         ("mnist_pool2", "pool2", 3),
                         ("mnist_readout", "readout", 65)):
        cases += check_real_vs_padded(name, ops[key], f, gen)
    graph = next(iter(point_loaders("mnist_nn_conv")[0]))
    ops = mg.mnist_operators(graph, segment_ops=True)
    cases += check_real_vs_padded("mnist_nnconv1", ops["segment1"], 32, gen)
    for name, key, f in (("mnist_nnconv2", "segment2", 64),
                         ("mnist_senders2", "senders2", 32)):
        cases.append(check_sorted_case(name, ops[key].csr, "fwd", f,
                                       "fp32", gen))
    from pytorch_geometric_tpu_torch.examples import pointnet2

    graph = next(iter(point_loaders("pointnet2")[0]))
    op = pointnet2.pointnet2_operators(graph)["sender_op"]
    cases.append(check_sorted_case("pointnet2_senders", op.csr, "fwd",
                                   pointnet2.SA1_MLP[-1][1], "fp32", gen))
    return cases


def _event_ms(fn, reps=5):
    """Median device ms of ``reps`` eager calls of ``fn`` between CUDA
    events (for calls that run autograd, which a CUDA graph of the
    timing helper cannot hold); long calls only, where launch gaps are
    noise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_csr(rows, cols, n):
    """``ops/csr.py:build_csr`` of ``(cols -> rows)`` on the card (a
    stable sort there: the same CSR, at 100M edges in a second)."""
    from pytorch_geometric_tpu_torch.ops.csr import Csr

    rows = torch.from_numpy(rows).to(DEVICE)
    perm = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=DEVICE)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    col = torch.from_numpy(cols).to(DEVICE)[perm].to(torch.int32)
    return Csr(row_ptr=row_ptr.to(torch.int32), col=col, perm=perm,
               num_rows=n, num_cols=n)


def phase_kernel_scale(gen):
    """The scale SpMM operators on the card.

    ``HybridSpmm`` on examples/gcn.py's Cora (``gcn_hybrid_operator``,
    windows of 512, the JAX ``pallas=True`` split; its two ``spmm_csr``
    launches) at the GCN's F = 16 and 7, against one fp32 ``spmm_csr``
    over the same edges (``gcn_spmm_operator``), the fp32 plain version
    (1e-2), cuSPARSE and the bound; two calls bitwise equal.

    ``BlockSpmm`` on bench_scale.py's community graph at Reddit's size
    (GCN weights; windows and threshold 1024, bf16): the split (dense
    blocks, their bytes, the dense edge share) and its host and device
    build times; at F = 602 and 128 the forward and ``dx`` (fp32 out;
    its first ``SCALE_CHECK_ROWS`` rows against the fp32 plain version
    over all their edges, 1e-2; two calls bitwise equal), one fp32
    ``spmm_csr`` over all edges, cuSPARSE, the bounds of both designs,
    and the batched product alone three ways: bf16 in with fp32 out (the
    operator's), bf16 out, and fp32 in."""
    from pytorch_geometric_tpu_torch.bounds import block_spmm_bound
    from pytorch_geometric_tpu_torch.datasets.graphs import (
        REDDIT_E, REDDIT_N, gen_clustered)
    from pytorch_geometric_tpu_torch.models.citation import (
        gcn_hybrid_operator, gcn_spmm_operator)
    from pytorch_geometric_tpu_torch.ops.block_spmm import (
        BlockSpmm, BlockStructure, _windows)
    from pytorch_geometric_tpu_torch.ops.csr import Csr
    from pytorch_geometric_tpu_torch.ops.spmm import spmm_csr, spmm_csr_plain

    lines = []
    _, cora = cora_graph(DEVICE)
    hop, hw = gcn_hybrid_operator(cora, HYBRID_WINDOW, HYBRID_TILE)
    hybrid = hop.bind(hw)
    sop, sw = gcn_spmm_operator(cora)
    val = sw[sop.fwd.perm].contiguous()
    a = torch.sparse_csr_tensor(sop.fwd.row_ptr, sop.fwd.col, val,
                                (sop.fwd.num_rows, sop.fwd.num_cols))
    for f in (16, 7):
        x = torch.randn(cora.num_nodes, f, generator=gen, device=DEVICE)
        got, again = hybrid(x), hybrid(x)
        want = spmm_csr_plain(sop.fwd, val, x)
        torch.cuda.synchronize()
        rel = _rel(got, want)
        bound, bound_by = spmm_bound(sop.fwd, f, 4)
        line = {"phase": "kernel_scale", "operator": "HybridSpmm",
                "graph": "cora", "F": f, "window": HYBRID_WINDOW,
                "tile": HYBRID_TILE, "dense_frac": hop.dense_frac,
                "part_edges": [len(p[1]) for p in hop.parts],
                "launches_per_call": len(hop.parts), "rel_err": rel,
                "tol": TOL["bf16"], "bitwise_repeat": torch.equal(got, again),
                "hybrid_ms": device_ms(lambda: hybrid(x)),
                "single_spmm_csr_ms": device_ms(
                    lambda: spmm_csr(sop.fwd, val, x)),
                "plain_ms": device_ms(lambda: spmm_csr_plain(sop.fwd, val,
                                                             x)),
                "library_ms": device_ms(lambda: torch.sparse.mm(a, x)),
                "bound_ms": bound, "bound_by": bound_by}
        line["ok"] = rel <= TOL["bf16"] and line["bitwise_repeat"]
        emit(line)
        lines.append(line)

    n, e = REDDIT_N, REDDIT_E
    t0 = time.perf_counter()
    s, r, _ = gen_clustered(n, e, SCALE_COMMUNITIES, seed=SEED)
    gen_seconds = time.perf_counter() - t0
    deg = np.bincount(r, minlength=n).astype(np.float64) + 1
    dis = deg ** -0.5
    w = (dis[s] * dis[r]).astype(np.float32)
    del deg, dis
    t0 = time.perf_counter()
    st = BlockStructure(s, r, n, window=SCALE_WINDOW,
                        dense_threshold=SCALE_THRESHOLD, device=DEVICE)
    torch.cuda.synchronize()
    structure_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = BlockSpmm(s, r, n, w, structure=st)
    torch.cuda.synchronize()
    bind_seconds = time.perf_counter() - t0
    fn, consts = op.bind()
    blocks = consts["blocks"]
    w_dev = torch.from_numpy(w).to(DEVICE)
    table_ms = device_ms(lambda: st.dense_blocks(w_dev), calls=3)
    t0 = time.perf_counter()
    csr = _device_csr(r, s, n)
    all_val = w_dev[csr.perm].contiguous()
    torch.cuda.synchronize()
    csr_seconds = time.perf_counter() - t0
    del s, r, w
    rows = SCALE_CHECK_ROWS
    e_rows = int(csr.row_ptr[rows])
    sub = Csr(row_ptr=csr.row_ptr[:rows + 1], col=csr.col[:e_rows],
              perm=csr.perm[:e_rows], num_rows=rows, num_cols=n)
    sub_val = all_val[:e_rows]
    lib = torch.sparse_csr_tensor(csr.row_ptr, csr.col, all_val, (n, n))
    split = {"dense_blocks": op.num_dense_blocks,
             "table_bytes": blocks.numel() * blocks.element_size(),
             "dense_edge_frac": op.dense_edge_frac,
             "sparse_edges": op.sparse_edges, "edges": e, "nodes": n,
             "windows": op.num_windows, "generate_seconds": gen_seconds,
             "structure_seconds": structure_seconds,
             "bind_seconds": bind_seconds, "table_build_ms": table_ms,
             "csr_seconds": csr_seconds}
    for f in SCALE_WIDTHS:
        x = torch.randn(n, f, generator=gen, device=DEVICE)
        with torch.no_grad():
            got, again = fn(consts, x), fn(consts, x)
        want = spmm_csr_plain(sub, sub_val, x)
        torch.cuda.synchronize()
        rel = _rel(got[:rows], want)
        repeats = torch.equal(got, again)
        del again
        xr = x.clone().requires_grad_()
        g = torch.randn(n, f, generator=gen, device=DEVICE)
        out = fn(consts, xr)
        dx = torch.autograd.grad(out, xr, g, retain_graph=True)[0]
        dx_again = torch.autograd.grad(out, xr, g, retain_graph=True)[0]
        # dx's first rows against the transposed plain sum: A^T g over
        # the edges whose sender is among them, from the full CSR
        col = csr.col.long()
        pick = col < rows
        rows_of = torch.repeat_interleave(
            torch.arange(n, device=DEVICE),
            (csr.row_ptr[1:] - csr.row_ptr[:-1]).long())
        dx_want = torch.zeros(rows, f, device=DEVICE).index_add_(
            0, col[pick], g[rows_of[pick]] * all_val[pick][:, None])
        dx_rel = _rel(dx[:rows], dx_want)
        del rows_of, pick, col, dx_want
        fwd_ms = device_ms(lambda: fn(consts, x), calls=5)
        dx_ms = _event_ms(lambda: torch.autograd.grad(
            out, xr, g, retain_graph=True))
        xs = _windows(x, st).index_select(0, consts["bsw"])
        products = {
            "bf16_in_fp32_out_ms": device_ms(lambda: torch.bmm(
                blocks, xs, out_dtype=torch.float32), calls=5),
            "bf16_in_bf16_out_ms": device_ms(lambda: torch.bmm(blocks, xs),
                                             calls=5)}
        b32, x32 = blocks.float(), xs.float()
        products["fp32_in_fp32_out_ms"] = device_ms(
            lambda: torch.bmm(b32, x32), calls=5)
        del b32, x32, xs
        bound, bound_by = block_spmm_bound(op, f)
        sp_bound, sp_bound_by = spmm_bound(csr, f, 4)
        line = {"phase": "kernel_scale", "operator": "BlockSpmm",
                "graph": "clustered_reddit", "F": f, **split,
                "checked_rows": rows, "checked_edges": e_rows,
                "rel_err": rel, "dx_rel_err": dx_rel, "tol": TOL["bf16"],
                "bitwise_repeat": repeats,
                "dx_bitwise_repeat": torch.equal(dx, dx_again),
                "block_fwd_ms": fwd_ms, "block_dx_ms": dx_ms,
                "spmm_csr_ms": device_ms(lambda: spmm_csr(csr, all_val, x),
                                         calls=3),
                "library_ms": device_ms(lambda: torch.sparse.mm(lib, x),
                                        calls=3),
                "plain_ms": None,     # would gather E x F x 4 bytes
                "slice_plain_ms": device_ms(
                    lambda: spmm_csr_plain(sub, sub_val, x), calls=3),
                "block_bound_ms": bound, "block_bound_by": bound_by,
                "bound_ms": sp_bound, "bound_by": sp_bound_by,
                "batched_product": products}
        line["ok"] = (rel <= TOL["bf16"] and dx_rel <= TOL["bf16"]
                      and repeats and line["dx_bitwise_repeat"])
        emit(line)
        lines.append(line)
        del x, xr, g, out, dx, dx_again, got, want
    problems = [f"{ln['operator']} F={ln['F']}: rel err {ln['rel_err']}"
                for ln in lines if not ln["ok"]]
    if problems:
        raise AssertionError("; ".join(problems))
    return lines


def point_steps_output(name, device, steps=3):
    """``(logits, model)`` of a point or superpixel example's ``Net``
    after ``steps`` Adam steps from ``SEED`` (dropout off) over the first
    batches of its seeded default loader, each with its operators as
    ``run`` trains (pointnet2's level-2 gather through the segment sum),
    then its logits on the first."""
    from pytorch_geometric_tpu_torch.examples import mnist_graclus as mg
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    gen = torch.Generator().manual_seed(SEED)
    train = point_loaders(name, device)[0]
    batches = list(itertools.islice(train.indexed(), steps))
    if name == "pointnet2":
        m = _example_module(name)
        model = m.Net(generator=gen).to(device)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        ops = [m.pointnet2_operators(graph) for _, graph in batches]
        for (_, graph), o in zip(batches, ops):
            m.train_step(model, opt, graph, o)
        with torch.no_grad():
            return model(batches[0][1], **ops[0]), model
    if name == "mnist_nn_conv":
        m = _example_module(name)
        model, build = m.Net(generator=gen), m.nn_conv_operators
    else:
        model, build = mg.Net(generator=gen), mg.mnist_operators
    model = model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    ops = OperatorCache(build)
    for idx, graph in batches:
        mg.train_step(model, opt, graph, ops(idx, graph), train=False)
    idx, graph = batches[0]
    with torch.no_grad():
        return model(graph, ops=ops(idx, graph)), model


def phase_slice_mnist_graclus():
    """examples/mnist_graclus.py's run on the card at its full width and
    defaults: SplineConv(1 -> 32, dim 2, K = 25), graclus max pool,
    Cartesian pseudo-coordinates of the pooled positions, SplineConv(32
    -> 64), a second pool, global mean pool, Dense 128 (ELU, dropout
    0.5), Dense 10; Adam 0.01, batches of 64, 3 epochs over 1500
    synthetic superpixel graphs (75 nodes, 8 neighbours; 250 test), as a
    user runs it, captured (the default: the training step, dropout
    drawn from the run's generator, and the evaluation each a CUDA graph
    over static buffers of its loader's budget; each batch's operator
    set, ``mnist_operators`` over its real entries: both levels' spline
    operators, both pools' ``cluster_operator`` and level 2's readout,
    built on the host and copied in through pinned memory), then eager
    (``capture=False``) on fresh loaders of the same seed
    (:func:`_capture_pair`: device launches as epochs x (train batches x
    step + test batches x evaluation) in both runs, every step's loss,
    the final parameters and the accuracy bitwise equal). Every loss
    finite and the last epoch's mean below the first's; test accuracy
    beside chance (not gated); each run's ms a step, the host ms a batch
    split into collation, level geometry, operator builds and copies;
    the operator sets built and their host seconds; the logits after
    three steps, card against the plain path on the CPU (1e-4)."""
    train, test = point_loaders("mnist_graclus")
    return _point_slice("mnist_graclus", MNIST_EPOCHS, MNIST_STEP_LAUNCHES,
                        MNIST_EVAL_LAUNCHES, (train, test))


def _point_slice(name, epochs, step, evaluation, loaders):
    m = _example_module(name)
    train, test = loaders
    batches = {"train": len(train), "test": len(test)}
    names = set(step) | set(evaluation)
    statement = {
        k: f"{epochs} epochs x ({batches['train']} train batches x "
           f"{step.get(k, 0)} + {batches['test']} test batches x "
           f"{evaluation.get(k, 0)})" for k in names}
    out, _, report, problems = _capture_pair(
        lambda capture: m.run(epochs, seed=SEED, device=DEVICE,
                              loaders=fresh_point_loaders(name),
                              capture=capture),
        step, evaluation, epochs * batches["train"],
        epochs * batches["test"], statement, CAPTURED_EXAMPLES[name])
    _falling(out["epoch_losses"], problems)
    parity, params_err, finite, shape = _parity(
        lambda dev: point_steps_output(name, dev))
    if not (finite and parity <= 1e-4):
        problems.append(f"logits after 3 steps: card vs CPU rel err "
                        f"{parity}")
    steps = epochs * batches["train"]
    return _finish({"phase": f"slice_{name}", "epochs": epochs,
                    "batches": batches,
                    "budget": [train.num_nodes, train.num_edges,
                               train.num_graphs], **report,
                    "ms_per_epoch": out["seconds"] / epochs * 1e3,
                    "ms_per_step_with_its_share_of_evaluation":
                        out["seconds"] / steps * 1e3,
                    "operators": out.get("operators", 0),
                    "operator_setup_seconds": out.get("operator_seconds",
                                                      0.0),
                    "epoch_losses": out["epoch_losses"],
                    "first_loss": float(out["step_losses"][0, 0]),
                    "final_loss": float(out["step_losses"][-1, -1]),
                    "test_acc": out["acc"], "chance_acc": 0.1,
                    "logits_shape": shape,
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "params_cuda_vs_cpu_rel_err": params_err}, problems)


def phase_slice_point(name):
    """A point or superpixel example's run on the card at its full width
    and default epochs (mnist_voxel_grid: mnist_graclus's Net over voxel
    levels of 5 and 10; mnist_nn_conv: NNConv mean over edge networks of
    the Cartesian pseudo-coordinates, 1000 samples; pointnet2: two
    PointConv set-abstraction levels over 128 sampled points of the
    synthetic ModelNet10, 12 samples a class): each captured, then
    eager, bitwise equal, as :func:`phase_slice_mnist_graclus` (pointnet2
    over the static graph of its loader's budget, its index fields
    included, the last batch padded to the budget). Launches asserted
    (``POINT_EXAMPLES``), the loss falling, and the logits after three
    steps, card against the plain path on the CPU (1e-4)."""
    epochs, step, evaluation = POINT_EXAMPLES[name]
    return _point_slice(name, epochs, step, evaluation, point_loaders(name))


def phase_trace_mnist_graclus(steps=20):
    """Where an mnist_graclus training step's time goes: ``torch.profiler``
    over ``steps`` eager steps of its ``train_step`` (a fresh ``Net``,
    Adam 0.01, dropout on) cycling over one epoch's train batches,
    collated and their operator sets (over the real entries) built before
    the window; then over ``steps`` replays of the step captured over its
    static batch, dropout from a registered generator
    (:func:`trace_captured_step`); 6 port launches a step in both."""
    from pytorch_geometric_tpu_torch.examples import mnist_graclus as mg
    from pytorch_geometric_tpu_torch.examples.ppi import OperatorCache

    train, _ = point_loaders("mnist_graclus")
    ops = OperatorCache(mg.mnist_operators)
    batches = [(graph, ops(idx, graph)) for idx, graph in train.indexed()]
    torch.cuda.synchronize()
    model = mg.Net(generator=torch.Generator().manual_seed(SEED)).to(DEVICE)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cycle = itertools.cycle(batches)

    def run():
        graph, op = next(cycle)
        mg.train_step(model, opt, graph, op, gen)

    kernels, wall_us = profile_steps(run, steps)
    summary, port_launches = trace_summary(kernels, wall_us, steps, "step")
    want = sum(MNIST_STEP_LAUNCHES.values())
    result = {"phase": "trace_mnist_graclus", "captured": False,
              "steps": steps, "operator_sets": len(ops.ops),
              "operator_setup_ms_per_batch": ops.seconds / len(ops.ops) * 1e3,
              **summary, "expected_port_launches_per_step": want}
    emit(result)
    if port_launches != want * steps:
        raise AssertionError(f"mnist_graclus: {port_launches / steps} port "
                             f"kernel launches per step on the trace, "
                             f"expected {want}")
    captured = trace_captured_step(
        mg, train, batches,
        mg.Net(generator=torch.Generator().manual_seed(SEED)), 0.01, steps,
        want, "mnist_graclus",
        generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    return {"eager": result, "captured": captured}


# ---------------------------------------------------------------------------
# Training closures, neighbour sampling and the compact optimiser
# ---------------------------------------------------------------------------

#: Launches of the closure configurations (the full graph's counts: each
#: closure layer runs the same operator kind over its own edges), per
#: epoch and for the full-graph evaluation.
CLOSURE_LAUNCHES = {
    "gcn": ({"spmm_csr": 4}, {"spmm_csr": 2}),
    "gat": ({"packed_gat_fwd": 2, "packed_gat_bwd": 4},
            {"packed_gat_fwd": 2}),
    "rgcn": ({"packed_rgcn_fwd": 4, "packed_rgcn_bwd": 6},
             {"packed_rgcn_fwd": 4}),
}
#: examples/reddit_sage.py: batch size, batches an epoch, and the
#: spmm_csr launches of a training step (conv1's and conv2's forward
#: sums, each of its input and of a column of ones, the degrees; conv2's
#: dx) and of an evaluation batch.
REDDIT_BATCH = 512
REDDIT_MAX_BATCHES = 20
REDDIT_STEP_LAUNCHES = {"spmm_csr": 5}
REDDIT_EVAL_LAUNCHES = {"spmm_csr": 4}
REDDIT_PREFETCH = 4


def closure_logits(config, model, device=DEVICE):
    """``(logits at the seeds, seeds, layers)``: the trained model's
    closure forward on ``device`` (dropout off) through the closure's
    operators, built as its trainer builds them (on the CPU their plain
    versions)."""
    from pytorch_geometric_tpu_torch.models.citation import training_closure
    from pytorch_geometric_tpu_torch.models.entities import (
        rgcn_closure, rgcn_closure_ops)
    from pytorch_geometric_tpu_torch.nn.conv import (
        gat_closure_op, gcn_closure_norm, gcn_closure_operator)

    kind, _, graph_name, _, _ = CONFIGS[config]
    ds, graph, _ = load(graph_name)
    g = graph.to(device)
    m = model.to(device)
    with torch.no_grad():
        if kind == "rgcn":
            seeds = g.extras["train_idx"][0].long()
            layers = rgcn_closure(g, seeds)
            out = m(None, closure=layers, fused_ops=rgcn_closure_ops(
                layers, g.num_nodes, ds.num_relations))
        else:
            layers, ei, seeds_np = training_closure(g)
            seeds = torch.from_numpy(seeds_np).to(device)
            x0 = g.x[layers[0].in_global.long()]
            if kind == "gcn":
                norms = gcn_closure_norm(ei, g.num_nodes, layers)
                ops = tuple(gcn_closure_operator(cl, w)
                            for cl, (w, _) in zip(layers, norms))
                out = m(None, x0, closure=layers, closure_norms=norms,
                        aggregate_fn=ops)
            else:
                out = m(None, x0, closure=layers,
                        flash_op=tuple(gat_closure_op(cl) for cl in layers))
    return out[:seeds.shape[0]], seeds, layers


def phase_slice_closure(config):
    """The JAX bench's closure rows on the card (``bench_common.py:144-217,
    221-310, 674-760``): the GCN and the GAT on Cora, the RGCN on MUTAG-RDF
    at its published size, trained on the two-layer receptive field of
    the training nodes (``closure=True``), captured and then eager, and
    evaluated on the full graph. Launches per epoch and for the
    evaluation as ``CLOSURE_LAUNCHES`` (the full-graph counts); the full
    slices' accuracy gates; the full-graph logits and the closure's, card
    against CPU (1e-4); and the closure's logits at the seeds against the
    full graph's at the same parameters, within the JAX bench's bounds
    (``CLOSURE_GAP``). Reports each layer's rows and edges."""
    kind = CONFIGS[config][0]
    per_epoch, evaluation = CLOSURE_LAUNCHES[kind]
    ds, graph, _ = load(CONFIGS[config][2])
    model, metrics, report, problems = run_main_path(config, per_epoch,
                                                     evaluation)
    card = logits_of(config, model)
    ref = logits_of(config, model, "cpu")
    card_cl, seeds, layers = closure_logits(config, model)
    cpu_cl, _, _ = closure_logits(config, model, "cpu")
    model.to(DEVICE)
    parity, cl_parity = _rel(card.cpu(), ref), _rel(card_cl.cpu(), cpu_cl)
    gap = float((card_cl - card[seeds]).abs().max()
                / (1.0 + card.abs().max()))
    if kind == "rgcn":
        loss0, loss1 = report["first_loss"], report["final_loss"]
        if not loss1 < 0.5 * loss0:
            problems.append(f"loss did not halve: {loss0} -> {loss1}")
        if not metrics["train_acc"] >= 0.9:
            problems.append(f"training accuracy {metrics['train_acc']} "
                            "(need >= 0.9)")
    else:
        _accuracy_gate(metrics, problems)
    if not (torch.isfinite(card).all() and torch.isfinite(card_cl).all()
            and parity <= 1e-4 and cl_parity <= 1e-4):
        problems.append(f"logits card vs CPU: full graph {parity}, closure "
                        f"{cl_parity} (need <= 1e-4)")
    if not gap <= CLOSURE_GAP[kind]:
        problems.append(f"closure vs full logit gap {gap} (need <= "
                        f"{CLOSURE_GAP[kind]})")
    layer_rows = [{"layer": i, "n_in": cl.n_in, "n_out": cl.n_out,
                   "real_in": cl.num_real_in, "real_out": cl.num_real_out,
                   "edges": cl.num_real_edges,
                   "padded_edges": cl.senders.shape[0]}
                  for i, cl in enumerate(layers)]
    return _finish({"phase": f"slice_{config}", "dataset": ds.name,
                    "synthetic": ds.is_synthetic, "nodes": graph.num_nodes,
                    "edges": graph.num_edges,
                    "real_edges": int(graph.real_edge_mask().sum()),
                    "seeds": int(seeds.shape[0]), "closure": layer_rows,
                    **report, "logits_shape": list(ref.shape),
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "closure_logits_cuda_vs_cpu_rel_err": cl_parity,
                    "closure_full_logit_gap": gap,
                    "closure_full_gap_bound": CLOSURE_GAP[kind]}, problems)


def phase_kernel_closure(gen):
    """The kernels at this slice's shapes, each against its plain version
    (fp32 1e-5, two launches bitwise equal), with cuSPARSE beside
    ``spmm_csr`` and the bound: the closure GCN's rectangular operators on
    Cora (layer 0 at F = 16, layer 1 at the class width, forward and
    transposed), the closure GAT's layers (conv1 (8, 8) at dropout 0.6,
    conv2 (1, 7)), the closure RGCN's embedding-mode layer (30, 16) and
    transform layer (30, 2) on MUTAG-RDF, and ``spmm_csr`` on one sampled
    Reddit batch (``Reddit(full_scale=True)``, 512 seeds, fan-out [10,
    10]: 56,833 rows, its real edges) at F = 602 and 128, forward and
    transposed."""
    from pytorch_geometric_tpu_torch.examples import reddit_sage
    from pytorch_geometric_tpu_torch.models.citation import training_closure
    from pytorch_geometric_tpu_torch.models.entities import (
        rgcn_closure, rgcn_closure_ops)
    from pytorch_geometric_tpu_torch.nn.conv import (
        gat_closure_op, gcn_closure_norm, gcn_closure_operator)

    cases = []

    def tagged(extra):
        return {"phase": "kernel_closure", **extra}
    ds, graph, _ = load("cora")
    layers, ei, _ = training_closure(graph)
    norms = gcn_closure_norm(ei, graph.num_nodes, layers)
    for i, (cl, (w, _), f) in enumerate(zip(layers, norms,
                                            (16, ds.num_classes))):
        geom, consts = gcn_closure_operator(cl, w).args
        for direction in ("fwd", "bwd"):
            cases.append(check_case(
                f"cora_closure{i}", getattr(geom, direction),
                consts[direction], direction, f, "fp32", gen,
                tagged({"n_in": cl.n_in, "n_out": cl.n_out})))
    for i, (cl, (H, C)) in enumerate(zip(layers, ((8, 8), (1, 7)))):
        for case in check_gat_case(f"cora_closure{i}", gat_closure_op(cl),
                                   H, C, 0.6, gen):
            case.update(tagged({"n_out": cl.n_out}))
            cases.append(case)
    mds, mgraph, _ = load("mutag")
    mlayers = rgcn_closure(mgraph, mgraph.extras["train_idx"][0])
    for name, op, (B, C) in zip(
            ("mutag_closure_embed", "mutag_closure_transform"),
            rgcn_closure_ops(mlayers, mgraph.num_nodes, mds.num_relations),
            ((30, 16), (30, 2))):
        for case in check_rgcn_case(name, op, B, C, gen):
            case.update(tagged({}))
            cases.append(case)
    data, _ = reddit_full()
    train, _, _, _ = reddit_sage.loaders(data, REDDIT_BATCH, SEED,
                                         device=DEVICE)
    batch = next(iter(train))
    agg = reddit_sage.sage_aggregate(batch)
    for f in (data.x.shape[1], 128):
        for direction in ("fwd", "bwd"):
            cases.append(check_case(
                "reddit_batch", getattr(agg.geom, direction),
                agg.consts[direction], direction, f, "fp32", gen,
                tagged({"seeds": REDDIT_BATCH,
                        "real_nodes": int(batch.node_mask.sum())})))
    bad = [(c["kernel"], c["graph"], c.get("direction"), c.get("F"))
           for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} closure / sampled case(s) "
                             f"disagree with the plain version: {bad}")
    return cases


def phase_adam_compact():
    """``utils/optim.py:adam_compact`` (both moments bf16) against
    ``torch.optim.Adam(capturable=True)`` on the captured full-graph MUTAG
    epoch (``bench_common.py:819-822``; 50 epochs, lr 0.01, the fused
    operators): each run's seconds and ms per captured epoch, the
    optimiser's own step captured alone (device µs, CUDA graphs of 50
    steps), the moments' bytes and both loss curves. Gate: each loss
    finite and halved."""
    from pytorch_geometric_tpu_torch.models.capture import run_epochs
    from pytorch_geometric_tpu_torch.models.citation import (
        softmax_xent_int_labels)
    from pytorch_geometric_tpu_torch.models.entities import (
        RGCN, rgcn_fused_ops)
    from pytorch_geometric_tpu_torch.utils.optim import adam_compact

    ds, graph, _ = load("mutag")
    ops = rgcn_fused_ops(graph, ds.num_relations)
    train_idx = graph.extras["train_idx"][0].long()
    y = graph.y[train_idx].long()
    dev = torch.device(DEVICE)
    rows, problems = {}, []
    for name in ("adam", "adam_compact"):
        model = RGCN(graph.num_nodes, ds.num_relations, ds.num_classes,
                     generator=torch.Generator().manual_seed(SEED)).to(dev)
        opt = (torch.optim.Adam(model.parameters(), lr=0.01,
                                capturable=True) if name == "adam"
               else adam_compact(model.parameters(), 0.01))

        def epoch_step(generator=None, model=model, opt=opt):
            opt.zero_grad(set_to_none=False)
            logits = model(graph, fused_ops=ops)[train_idx]
            loss = softmax_xent_int_labels(logits, y).mean()
            loss.backward()
            opt.step()
            return {"loss": loss.detach(), "train_acc": (
                logits.detach().argmax(-1) == y).float().mean()}

        @torch.no_grad()
        def eval_fn(model=model):
            logits = model(graph, fused_ops=ops)[train_idx]
            return {"train_acc": (logits.argmax(-1) == y).float().mean()}

        metrics = run_epochs(epoch_step, eval_fn, RGCN_EPOCHS, None, dev,
                             capture=True)
        step_us = device_ms(opt.step) * 1e3
        moments = sum(v.numel() * v.element_size()
                      for st in opt.state.values() for k, v in st.items()
                      if k in ("mu", "nu", "exp_avg", "exp_avg_sq"))
        loss = metrics["curve"]["loss"]
        params = sum(p.numel() for p in model.parameters())
        rows[name] = {"seconds": metrics["seconds"],
                      "ms_per_epoch": metrics["seconds"]
                      / (RGCN_EPOCHS - 1) * 1e3,
                      "optimizer_step_us": step_us,
                      "moment_bytes": moments,
                      "train_acc": metrics["train_acc"],
                      "loss_curve": [float(v) for v in loss]}
        if not (np.isfinite(loss).all() and loss[-1] < 0.5 * loss[0]):
            problems.append(f"{name}: loss {loss[0]} -> {loss[-1]} (need "
                            "finite and halved)")
    a, c = rows["adam"]["loss_curve"], rows["adam_compact"]["loss_curve"]
    return _finish({"phase": "adam_compact", "dataset": "mutag",
                    "epochs": RGCN_EPOCHS, "params": params, **rows,
                    "loss_curves_max_abs_diff": float(
                        np.abs(np.asarray(a) - np.asarray(c)).max())},
                   problems)


def reddit_steps_logits(device, steps=3):
    """``(logits, model)``: a fresh ``SAGE`` of examples/reddit_sage.py
    (from ``SEED``) after ``steps`` Adam steps over the first ``steps``
    batches of the seeded loader on the full-scale Reddit, then its
    logits on the first of them, on ``device`` (the CPU runs the kernel's
    plain version); each batch and its operator sampled and built on the
    host as ``run`` takes them (``Sampled``), then copied to ``device``."""
    from pytorch_geometric_tpu_torch.examples import reddit_sage

    data, _ = reddit_full()
    train, _, x_dev, y_dev = reddit_sage.loaders(data, REDDIT_BATCH, SEED,
                                                 device=device)
    batches = [(graph.to(device), ops["aggregate"].to(device))
               for graph, ops in reddit_sage.Sampled(train, steps, {})]
    model = reddit_sage.SAGE(data.x.shape[1], 128, 41,
                             generator=torch.Generator().manual_seed(
                                 SEED)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    for graph, agg in batches:
        reddit_sage.train_step(model, opt, graph, x_dev, y_dev, agg)
    graph, agg = batches[0]
    ids = graph.extras["local_to_global"].long()
    with torch.no_grad():
        out = model(graph, x_dev[ids], agg)
    return out[graph.node_mask].cpu(), model


def reddit_epochs(data):
    """The JAX bench's sampled-epoch measures (``bench_common.py:913-1041``)
    over ``REDDIT_MAX_BATCHES`` training batches: the host sampler alone
    (sampling and compaction, no copy: nodes a second, real and
    budgeted); the device-only epoch (batches sampled, their operators
    built and both copied first, the eager steps timed); and the eager
    epoch with sampling and the operators' build inline (``prefetch=0``)
    and pipelined (``prefetch=REDDIT_PREFETCH``, in the producer thread),
    each batch and its operator copied to the card, as ``run(capture=
    False)`` takes them (``Sampled``, capturable Adam), taken in turns
    twice, the best of each kept."""
    from pytorch_geometric_tpu_torch.data.neighbor_loader import (
        NeighborSampler)
    from pytorch_geometric_tpu_torch.examples import reddit_sage

    ei = np.asarray(data.edge_index)
    train_nodes = np.flatnonzero(data.train_mask)
    host = NeighborSampler(ei[0], ei[1], data.num_nodes, sizes=[10, 10],
                           batch_size=REDDIT_BATCH, seed_nodes=train_nodes,
                           seed=SEED, materialize_features=False,
                           device="cpu")
    t0 = time.perf_counter()
    real = budget = 0
    for graph in itertools.islice(host, REDDIT_MAX_BATCHES):
        real += int(graph.node_mask.sum())
        budget += graph.num_nodes
    sampler_s = time.perf_counter() - t0
    loaders = {p: reddit_sage.loaders(data, REDDIT_BATCH, SEED, p,
                                      DEVICE) for p in (0, REDDIT_PREFETCH)}
    _, _, x_dev, y_dev = loaders[0]
    model = reddit_sage.SAGE(data.x.shape[1], 128, 41,
                             generator=torch.Generator().manual_seed(
                                 SEED)).to(DEVICE)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3, capturable=True)

    def batches(prefetch):
        for graph, ops in reddit_sage.Sampled(loaders[prefetch][0],
                                              REDDIT_MAX_BATCHES, {}):
            yield graph.to(DEVICE), ops["aggregate"].to(DEVICE)

    pre = list(batches(0))
    graph, agg = pre[0]
    reddit_sage.train_step(model, opt, graph, x_dev, y_dev, agg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for graph, agg in pre:
        reddit_sage.train_step(model, opt, graph, x_dev, y_dev, agg)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    del pre

    def epoch(prefetch):
        t0 = time.perf_counter()
        for graph, agg in batches(prefetch):
            reddit_sage.train_step(model, opt, graph, x_dev, y_dev, agg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    serial, piped = [], []
    for _ in range(2):
        serial.append(epoch(0))
        piped.append(epoch(REDDIT_PREFETCH))
    return {"batches": REDDIT_MAX_BATCHES,
            "sampler_only_s": sampler_s,
            "sampler_real_nodes_per_s": real / sampler_s,
            "sampler_budget_nodes_per_s": budget / sampler_s,
            "device_only_s": device_s, "serial_epoch_s": min(serial),
            "pipelined_epoch_s": min(piped), "serial_epochs_s": serial,
            "pipelined_epochs_s": piped, "prefetch": REDDIT_PREFETCH}


def phase_slice_reddit_sage():
    """examples/reddit_sage.py's run on the card at its full widths on
    ``Reddit(full_scale=True)``: two SAGE layers (602 -> 128 -> 41),
    fan-out [10, 10], batches of 512 seeds (56,833-node, 56,320-edge
    budgets), index-shipping batches over the feature and label tables on
    the card, Adam 3e-3, one epoch of 20 batches and 10 validation
    batches, each batch's sums through one ``EmbedSpmm`` over its real
    edges (``spmm_csr``), built on the host by the sampler; as a user
    runs it, captured (the default: the training step and the evaluation
    each a CUDA graph over the static packed batch and neighbour-sum
    operator of the sampler's budgets), then eager (``capture=False``)
    (:func:`_capture_pair`: launches 20 x 5 + 10 x 4 in both runs and by
    stage; every step's loss, the final parameters and the accuracy
    bitwise; ms a step in both beside the host ms a batch: the sampling,
    the operator's build, the copies). The loss falling (the last step
    below the first); validation accuracy beside chance (1/41; not
    gated); the logits after three steps on the first batch, card
    against the plain path on the CPU (1e-4); the sampler's throughput
    and the epoch device-only, inline and pipelined
    (:func:`reddit_epochs`)."""
    from pytorch_geometric_tpu_torch.examples import reddit_sage

    data, load_seconds = reddit_full()
    statement = {n: f"{REDDIT_MAX_BATCHES} train batches x "
                    f"{REDDIT_STEP_LAUNCHES[n]} + {REDDIT_MAX_BATCHES // 2} "
                    f"val batches x {REDDIT_EVAL_LAUNCHES[n]}"
                 for n in REDDIT_STEP_LAUNCHES}
    out, _, report, problems = _capture_pair(
        lambda capture: reddit_sage.run(1, REDDIT_BATCH, SEED,
                                        REDDIT_MAX_BATCHES, DEVICE,
                                        data=data, capture=capture),
        REDDIT_STEP_LAUNCHES, REDDIT_EVAL_LAUNCHES, REDDIT_MAX_BATCHES,
        REDDIT_MAX_BATCHES // 2, statement, "acc")
    losses = out["step_losses"][0]
    _falling(losses, problems, "step")
    parity, params_err, finite, shape = _parity(reddit_steps_logits)
    if not (finite and parity <= 1e-4):
        problems.append(f"logits after 3 steps: card vs CPU rel err "
                        f"{parity}")
    epochs = reddit_epochs(data)
    ei = np.asarray(data.edge_index)
    return _finish({"phase": "slice_reddit_sage", "dataset": "Reddit",
                    "full_scale": True, "nodes": data.num_nodes,
                    "edges": int(ei.shape[1]),
                    "features": int(data.x.shape[1]),
                    "load_seconds": load_seconds,
                    "batch_size": REDDIT_BATCH,
                    "node_budget": REDDIT_BATCH * (1 + 10 + 100) + 1,
                    "edge_budget": REDDIT_BATCH * (10 + 100),
                    "step_losses": [float(v) for v in losses],
                    "first_loss": float(losses[0]),
                    "final_loss": float(losses[-1]),
                    "val_acc": out["acc"], "chance": out["chance"],
                    **report, **epochs, "logits_shape": shape,
                    "logits_cuda_vs_cpu_rel_err": parity,
                    "params_cuda_vs_cpu_rel_err": params_err}, problems)


def phase_trace_reddit_sage(steps=20):
    """Where a reddit_sage training step's time goes: ``torch.profiler``
    over ``steps`` training steps as ``run`` takes them, the batches
    sampled with ``prefetch=REDDIT_PREFETCH`` (the sampling and each
    batch's operator build in the producer thread), eager (each batch and
    its operator copied to the card, then the step) and then captured
    (each copied into the sampler's static buffers, then a replay); 5
    port launches a step in both."""
    from pytorch_geometric_tpu_torch.examples import reddit_sage
    from pytorch_geometric_tpu_torch.models.capture import CapturedStep

    data, _ = reddit_full()
    dev = torch.device(DEVICE)
    want = sum(REDDIT_STEP_LAUNCHES.values())
    out = {}
    for captured in (False, True):
        train, _, x_dev, y_dev = reddit_sage.loaders(
            data, REDDIT_BATCH, SEED, REDDIT_PREFETCH, DEVICE)
        model = reddit_sage.SAGE(data.x.shape[1], 128, 41,
                                 generator=torch.Generator().manual_seed(
                                     SEED)).to(DEVICE)
        opt = torch.optim.Adam(model.parameters(), lr=3e-3,
                               capturable=True)
        batches = train.iter_host(
            lambda g: reddit_sage.sage_aggregate(g, "cpu"))
        if captured:
            static = reddit_sage.StaticSampled(train, dev)
            step = CapturedStep(lambda: reddit_sage.train_step(
                model, opt, static.graph, x_dev, y_dev,
                static.ops["aggregate"]), dev)

            def run():
                graph, op = next(batches)
                static.load(graph, {"aggregate": op})
                step()
        else:
            def run():
                graph, op = next(batches)
                reddit_sage.train_step(model, opt, graph.to(dev), x_dev,
                                       y_dev, op.to(dev))

        kernels, wall_us = profile_steps(run, steps)
        batches.close()
        summary, port_launches = trace_summary(kernels, wall_us, steps,
                                               "step")
        result = {"phase": "trace_reddit_sage", "captured": captured,
                  "steps": steps, "prefetch": REDDIT_PREFETCH, **summary,
                  "port_us_per_step":
                      summary["us_per_step_by_group"]["port_kernels"],
                  "expected_port_launches_per_step": want}
        emit(result)
        if port_launches != want * steps:
            raise AssertionError(f"reddit_sage: {port_launches / steps} "
                                 f"port kernel launches per step on the "
                                 f"trace (captured {captured}), expected "
                                 f"{want}")
        out["captured" if captured else "eager"] = result
    return out


#: Each kernel's source, the Pallas kernel it replaces, its main path's
#: graph, and the case of the kernel phase that stands for that path: its
#: largest call (GCN's F = 16 forward SpMM; GAT's conv1, 8 heads x 8, with
#: attention dropout, for either backend; RGCN's conv1, 30 bases x 16
#: over the embedding table; the block-sparse kernels' conv1 on PubMed
#: after RCM; the segment sum's F = 16 forward on PubMed after RCM in
#: fp32; the fused GCN's (16, 3) with dropout 0.5 there).
KERNELS = {
    "spmm_csr": ("pytorch_geometric_tpu_torch/csrc/spmm_csr.cu",
                 "pytorch_geometric_tpu/ops/spmm.py:56", "cora",
                 dict(direction="fwd", F=16, x="fp32")),
    "packed_gat_fwd": ("pytorch_geometric_tpu_torch/csrc/packed_gat.cu",
                       "pytorch_geometric_tpu/ops/packed_gat.py:81", "cora",
                       dict(H=8, C=8, rate=0.6)),
    "packed_gat_bwd": ("pytorch_geometric_tpu_torch/csrc/packed_gat.cu",
                       "pytorch_geometric_tpu/ops/packed_gat.py:156", "cora",
                       dict(H=8, C=8, rate=0.6)),
    "flash_gat_fwd": ("pytorch_geometric_tpu_torch/csrc/flash_gat.cu",
                      "pytorch_geometric_tpu/ops/flash_gat.py:63", "cora",
                      dict(H=8, C=8, rate=0.6)),
    "flash_gat_bwd": ("pytorch_geometric_tpu_torch/csrc/flash_gat.cu",
                      "pytorch_geometric_tpu/ops/flash_gat.py:88", "cora",
                      dict(H=8, C=8, rate=0.6)),
    "packed_rgcn_fwd": ("pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu",
                        "pytorch_geometric_tpu/ops/packed_rgcn.py:68",
                        "mutag", dict(B=30, C=16)),
    "packed_rgcn_bwd": ("pytorch_geometric_tpu_torch/csrc/packed_rgcn.cu",
                        "pytorch_geometric_tpu/ops/packed_rgcn.py:131",
                        "mutag", dict(B=30, C=16)),
    "bsr_gat_fwd": ("pytorch_geometric_tpu_torch/csrc/bsr_gat.cu",
                    "pytorch_geometric_tpu/ops/bsr_gat.py:80", "pubmed_rcm",
                    dict(H=8, C=8, rate=0.6)),
    "bsr_gat_bwd_row": ("pytorch_geometric_tpu_torch/csrc/bsr_gat.cu",
                        "pytorch_geometric_tpu/ops/bsr_gat.py:125",
                        "pubmed_rcm", dict(H=8, C=8, rate=0.6)),
    "bsr_gat_bwd_col": ("pytorch_geometric_tpu_torch/csrc/bsr_gat.cu",
                        "pytorch_geometric_tpu/ops/bsr_gat.py:166",
                        "pubmed_rcm", dict(H=8, C=8, rate=0.6)),
    "sorted_segment_sum": ("pytorch_geometric_tpu_torch/csrc/sorted_spmm.cu",
                           "pytorch_geometric_tpu/ops/sorted_spmm.py:120",
                           "pubmed_rcm",
                           dict(direction="fwd", F=16, msgs="fp32")),
    "fused_gcn_fwd": ("pytorch_geometric_tpu_torch/csrc/fused_gcn.cu",
                      "pytorch_geometric_tpu/ops/fused_gcn.py:57",
                      "pubmed_rcm", dict(H=16, C=3, rate=0.5)),
    "fused_gcn_bwd": ("pytorch_geometric_tpu_torch/csrc/fused_gcn.cu",
                      "pytorch_geometric_tpu/ops/fused_gcn.py:57",
                      "pubmed_rcm", dict(H=16, C=3, rate=0.5)),
}


#: The probes' rows: each probe library's entry point, its source, the
#: Pallas probe it replaces; timed on the main graph (RCM-PubMed (8, 8)
#: with dropout 0.6; MUTAG conv1) at the backwards' ``full`` mode and the
#: forward's prefetch depth 2 (depths 1 and 4 beside it), launches counted
#: in the probe phase. No single PyTorch call computes any of them.
PROBE_KERNELS = {
    "packed_gat_ablate_bwd": ("probes/packed_gat_ablate.cu",
                              "tools/gat_ablate.py:194"),
    "packed_rgcn_ablate_bwd": ("probes/packed_rgcn_ablate.cu",
                               "tools/rgcn_ablate.py:116"),
    "packed_rgcn_pipe_fwd": ("probes/packed_rgcn_ablate.cu",
                             "tools/rgcn_pipe_probe.py:158"),
}


#: The keys of a ``kernel_closure`` case on the kernels line.
CLOSURE_CASE_KEYS = ("graph", "direction", "F", "H", "C", "B", "rate",
                     "rows", "src_rows", "edges", "longest_row", "kernel_ms",
                     "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "max_abs_err")


def kernels_line(results):
    """Per kernel: its launches on the main paths' runs (``launches``,
    the sum, and ``launches_by_path``: each slice phase's run, counts set
    to 0 before it), its largest error over the cases on its first path's
    graph, and the times and bound of that path's case (and, for the fused
    GCN kernels, the unfused chain's time, which stands where no library
    call exists)."""
    by_path = {}    # kernel -> {main path: its launches in that run}
    for phase, result in results.items():
        if phase.startswith(("slice", "tool_")):
            path = (phase[len("slice_"):] or "gcn"
                    if phase.startswith("slice") else phase)
            for k, v in result["launches"].items():
                if v:
                    by_path.setdefault(k, {})[path] = v
    line = []
    for name, (source, replaces, graph, keys) in KERNELS.items():
        mine = [c for c in results["kernel"]
                if c["kernel"] == name and c["graph"] == graph]
        case = next(c for c in mine
                    if all(c[k] == v for k, v in keys.items()))
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(by_path[name].values()),
                     "launches_by_path": by_path[name],
                     "max_abs_err": max(c["max_abs_err"] for c in mine),
                     "ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
                     "bound_ms": case["bound_ms"],
                     "bound_by": case["bound_by"],
                     "library_ms": case["library_ms"]})
        if "unfused_chain_ms" in case:
            line[-1]["unfused_chain_ms"] = case["unfused_chain_ms"]
        ppi = [c for c in results["kernel"]
               if c["kernel"] == name and c["graph"].startswith("ppi_")]
        if ppi:   # examples/ppi.py's widths, on the wide-head map
            line[-1]["ppi"] = [
                {k: c[k] for k in ("graph", "H", "C", "rate", "kernel_ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "max_abs_err")} for c in ppi]
        graph_level = [c for c in results["kernel"] if c["kernel"] == name
                       and c["graph"] in GRAPH_LEVEL_CASES]
        if graph_level:   # the graph-level examples' shapes
            line[-1]["graph_level"] = [
                {k: c[k] for k in ("graph", "direction", "F", "rows",
                                   "edges", "longest_row", "kernel_ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "max_abs_err")}
                for c in graph_level]
        mnist = [c for c in results["kernel_mnist"] if c["kernel"] == name]
        if mnist:   # the superpixel examples' operators
            line[-1]["mnist"] = [
                {k: c[k] for k in ("graph", "direction", "F", "rows",
                                   "edges", "longest_row", "kernel_ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "bound_by", "max_abs_err")}
                for c in mnist]
        if name == "spmm_csr":   # the scale operators it serves
            line[-1]["scale"] = [
                {k: ln.get(k) for k in (
                    "operator", "graph", "F", "dense_frac",
                    "dense_edge_frac", "dense_blocks", "table_bytes",
                    "hybrid_ms", "single_spmm_csr_ms", "block_fwd_ms",
                    "block_dx_ms", "spmm_csr_ms", "plain_ms", "library_ms",
                    "bound_ms", "block_bound_ms", "rel_err")}
                for ln in results["kernel_scale"]]
        for tag, graph_name, keys in (
                ("faust", "faust", ("k_operators_ms", "kernel_flushed_ms")),
                ("reddit", "reddit_full", ("slice_kernel_ms",
                                           "slice_plain_ms",
                                           "slice_bound_ms"))):
            rows = [c for c in results["kernel_faust"]
                    if c["kernel"] == name and c["graph"] == graph_name]
            if rows:  # examples/faust.py's operator; full-scale Reddit
                line[-1][tag] = [
                    {k: c[k] for k in ("direction", "F", "rows", "edges",
                                       "kernel_ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by", "max_abs_err")
                     + keys} for c in rows]
        driver = [c for c in results.get("kernel_driver", [])
                  if c["kernel"] == name]
        if driver:   # the research driver's widths on Cora
            line[-1]["driver"] = [
                {k: c.get(k) for k in ("direction", "F", "H", "C", "rate",
                                       "rows", "edges", "kernel_ms",
                                       "plain_ms", "library_ms",
                                       "bound_ms", "bound_by",
                                       "max_abs_err") if k in c}
                for c in driver]
        shards = [c for c in results.get("partition_shards", {}).get(
            "cases", []) if c["kernel"] == name]
        if shards:   # P = 4 shards of a partition on one card
            line[-1]["partition_shards"] = [
                {k: c[k] for k in ("operator", "graph", "shards",
                                   "nodes_per_shard", "halo_size",
                                   "dense_blocks", "shard_ms",
                                   "shards_ms_sum", "whole_graph_ms",
                                   "err", "metric")} for c in shards]
        closure = [c for c in results["kernel_closure"]
                   if c["kernel"] == name]
        if closure:   # the closure layers' and a sampled Reddit batch's
            line[-1]["closure_and_sampled"] = [
                {k: c[k] for k in CLOSURE_CASE_KEYS if k in c}
                for c in closure]
    probe = results["probe"]
    for name, (source, replaces) in PROBE_KERNELS.items():
        case = probe["rows"][name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": probe["launches"][name],
                     "max_abs_err": case["max_abs_err"],
                     "ms": case["kernel_ms"], "plain_ms": case["plain_ms"],
                     "bound_ms": case["bound_ms"],
                     "bound_by": case["bound_by"], "library_ms": None})
        for depth in (1, 4):
            if f"depth{depth}_ms" in case:
                line[-1][f"depth{depth}_ms"] = case[f"depth{depth}_ms"]
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description="Smoke run of the port on one "
                                "NVIDIA GPU; with no arguments, every phase")
    p.add_argument("--phases", default=None,
                   help="comma-separated phases to run after card and "
                        "build, for a quick check of some of them (no "
                        "kernels line)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    failed = []
    results = {}
    phase_seconds = {}
    phases = [("card", phase_card), ("build", phase_build),
              ("cluster", phase_cluster), ("kernel", phase_kernel),
              ("kernel_faust", lambda: phase_kernel_faust(
                  torch.Generator(device=DEVICE).manual_seed(SEED))),
              ("kernel_mnist", lambda: phase_kernel_mnist(
                  torch.Generator(device=DEVICE).manual_seed(SEED))),
              ("kernel_scale", lambda: phase_kernel_scale(
                  torch.Generator(device=DEVICE).manual_seed(SEED))),
              ("kernel_closure", lambda: phase_kernel_closure(
                  torch.Generator(device=DEVICE).manual_seed(SEED))),
              ("kernel_driver", lambda: phase_kernel_driver(
                  torch.Generator(device=DEVICE).manual_seed(SEED))),
              ("probe", phase_probe),
              ("slice", phase_slice), ("slice_gat", phase_slice_gat),
              ("slice_gat_dense",
               lambda: phase_slice_gat("dense", "slice_gat_dense")),
              ("slice_gat_bsr", lambda: phase_slice_gat("bsr", "slice_gat_bsr")),
              ("slice_rgcn", phase_slice_rgcn),
              ("slice_gcn_sorted",
               lambda: phase_slice_gcn("sorted", "slice_gcn_sorted")),
              ("slice_gcn_fused",
               lambda: phase_slice_gcn("fused", "slice_gcn_fused")),
              ("slice_gcn_dense",
               lambda: phase_slice_gcn("dense", "slice_gcn_dense")),
              ("slice_gcn_hybrid",
               lambda: phase_slice_gcn("hybrid", "slice_gcn_hybrid"))]
    for config in CLOSURE_CONFIGS:
        phases.append((f"slice_{config}",
                       functools.partial(phase_slice_closure, config)))
    phases.append(("adam_compact", phase_adam_compact))
    for name in SUITE_LAUNCHES:
        phases.append((f"slice_{name}",
                       functools.partial(phase_slice_suite, name)))
    phases.append(("slice_ppi", phase_slice_ppi))
    phases.append(("slice_faust", phase_slice_faust))
    phases.append(("slice_mutag_gin", phase_slice_mutag_gin))
    for name in GRAPH_EXAMPLES:
        phases.append((f"slice_{name}",
                       functools.partial(phase_slice_graph, name)))
    phases.append(("slice_autoencoder", phase_slice_autoencoder))
    phases.append(("slice_infomax", phase_slice_infomax))
    phases.append(("slice_mnist_graclus", phase_slice_mnist_graclus))
    for name in POINT_EXAMPLES:
        phases.append((f"slice_{name}",
                       functools.partial(phase_slice_point, name)))
    phases.append(("slice_reddit_sage", phase_slice_reddit_sage))
    phases += [("slice_driver", phase_slice_driver),
               ("slice_driver_gat",
                lambda: phase_slice_driver("GAT", "slice_driver_gat")),
               ("slice_driver_inductive", phase_slice_driver_inductive),
               ("zoo_prunable", phase_zoo_prunable),
               ("fiedler", phase_fiedler), ("mygcn", phase_mygcn),
               ("slice_dp", phase_slice_dp),
               ("slice_partition", phase_slice_partition),
               ("partition_shards", phase_partition_shards)]
    phases += [(name, functools.partial(phase_tool, name))
               for name in TOOL_PHASES]
    phases += [("zoo", phase_zoo), ("capture_check", phase_capture_check)]
    for config in CONFIGS:
        phases.append(("trace" if config == "gcn" else f"trace_{config}",
                       functools.partial(phase_trace, config)))
    phases.append(("trace_ppi", phase_trace_ppi))
    phases.append(("trace_faust", phase_trace_faust))
    phases.append(("trace_mutag_gin", phase_trace_mutag_gin))
    phases.append(("trace_qm9", phase_trace_qm9))
    phases.append(("trace_enzymes", phase_trace_enzymes))
    phases.append(("trace_spans", phase_trace_spans))
    phases.append(("trace_pointnet2", phase_trace_pointnet2))
    phases.append(("trace_driver_inductive", phase_trace_driver_inductive))
    phases.append(("trace_mnist_graclus", phase_trace_mnist_graclus))
    phases.append(("trace_reddit_sage", phase_trace_reddit_sage))
    for config in CONFIGS:
        phases.append((f"trace_captured_{config}",
                       functools.partial(phase_trace, config, True)))
    if args.phases:
        keep = {"card", "build", *args.phases.split(",")}
        unknown = keep - {name for name, _ in phases}
        if unknown:
            print(f"chip_smoke: unknown phases {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        phases = [(name, fn) for name, fn in phases if name in keep]
    for name, fn in phases:
        if failed and name != "card":
            emit({"phase": name, "skipped": f"after {failed[0]} failed"})
            continue
        t_phase = time.perf_counter()
        try:
            results[name] = fn()
            torch.cuda.synchronize()
        except Exception as exc:   # report every phase, then fail
            traceback.print_exc()
            emit({"phase": name, "error": f"{type(exc).__name__}: {exc}"})
            failed.append(name)
        phase_seconds[name] = time.perf_counter() - t_phase
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1

    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "phase_seconds": phase_seconds})
    print(results["card"], flush=True)
    if not args.phases:
        emit({"kernels": kernels_line(results)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
