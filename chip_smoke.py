"""Drive igneous_tpu_torch's downsample, transfer, connected-components,
meshing, skeleton, morphology, census, inference and contrast paths, solo,
batched, pipelined, through the queue worker, on gs:// and s3:// and into
sharded scales, its image surface (ROIs, spatial index, reorder, ingest),
its sharded and multires meshes and sharded skeletons, and its graphene
layers (served by a fake PyChunkGraph server) and cross-sectional areas,
and its fleet observability plane (the worker journal, /metrics, the
fleet commands, the health engine, profile capture), its campaign
survival, serving tier and chaos layer, and its multi-host pods over
torch.distributed, on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. build: compile the kernel sources (csrc/pooling.cu, csrc/ccl.cu,
     csrc/edt.cu, csrc/clahe.cu) with nvcc and the host libraries of the
     mesh and skeleton paths and the chunk codec (csrc/simplify.cpp,
     csrc/dijkstra.cpp, csrc/fggraph.cpp, csrc/cseg.cpp, csrc/xsection.cpp)
     with g++, one process per source, started together;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, bit for bit, at the main paths' shapes, with its time (device
     time: calls captured in a CUDA graph and replayed between CUDA
     events), its time for one call from the host, its bound and the plain
     time; pool2x2x1 at every element width on its vector and element-wise
     paths; tile_resolve on five cases at connectivity 6, 18 and 26, on
     every tile of the sweep and on an odd tile (the runtime-shape
     instance); edt_pass (three passes, one EDT) on seven cases, the first
     the default skeleton task's 515^3 uint64 field, also timed pass by
     pass and held against the JAX package's host EDT (native/csrc/edt.cpp,
     built with g++ and timed on the host's cores as context), with the
     float32 square root equal to numpy's, the last two with lines longer
     than the shared-memory threshold along z and along x (the long-line
     kernel); each case run twice with the same output both times; single
     passes on seeded random values along each axis, first and not, on
     the first and the long-line cases; the worst stack depth (one label,
     equal values) along each axis, timed; edt_pass's bound the larger of
     its bytes and its FP64 work counted on this run's data; clahe on seven
     cases (the first default CLAHE task's padded cutout of phase 14,
     2304x2304x64 uint8, grid 8, clip 40; the same cutout as uint16; a
     uint16 stack whose extents do not divide by the grid; rows that divide
     by the grid and columns that do not; clip 0; a constant uint16 stack
     at clip 0, one bin holding a whole tile; a constant uint8 stack), each
     bound the bytes of the planes in and out, each with the memory its
     launch took and the bytes of its LUTs;
  3. e2e downsample: four file:// layers through Volume.from_numpy ->
     create_downsampling_tasks -> LocalTaskQueue -> DownsampleTask, every
     produced mip read back and compared with the plain pyramid computed
     on the card; the kernels' launch counts are set to 0 just before and
     read just after, and each kernel must have launched;
  3a. codecs (host): 4 chunks of the segmentation layer's mip 0 (32
     before phase 20) and all 4 of its mip 3, chosen from seed 1, through the compressed_segmentation
     codec's native, numpy and per-block loop routes (one stream, each
     decoder gives the chunk back) and through compresso (round trip
     equal), with their rates on one host thread;
  3b. e2e xfer: the same raw segmentation layer through
     create_transfer_tasks into compressed_segmentation in 64^3 chunks with
     4 new mips (compress at its default, gzip), task by task on a
     LocalTaskQueue: each task's wall, stage split and launches (set to 0
     just before; pyramid2x2x1 must launch), the bytes written against the
     raw bytes, every mip 0-4 read back equal to the raw layer's same mip;
     then a compresso transfer of a 512x512x64 crop with no pyramid, read
     back equal, its info advertising compresso-cpsx;
  3c. batched: phase 3's image layer twice through batched_downsample,
     at 1024x1024x64 in batches of 8 (2 dispatches, 3 mips; a profiler
     trace for the card's busy share) and through `image downsample
     --batched` at its defaults (256x256x64, batch 8: 32 dispatches, 1
     mip), the segmentation at 512x512x64 (2 dispatches, 2 mips) and the
     ragged image at 256x256x64 (9 full cutouts, 7 through PagedPyramid
     in 28 page rounds), each into a new layer sharing phase 3's mip 0:
     per run its wall, dispatches, launches (pyramid2x2x1 once per
     full-cutout dispatch, pool2x2x1 once per level of every page round)
     and stage split, every produced chunk and the info's scales equal to
     phase 3's solo output; the page kernel (X5) on one round against its
     plain version, timed; entry() once, equal to the plain pyramid; then,
     after phase 4, batched_ccl_faces over its segmentation layer
     (paged_ccl, tile_resolve once per page round), every face file equal
     to the task path's pass 1, both walls; and after phase 6, edt_batch
     and paged_edt on the two default skeleton cutouts, bit for bit the
     solo edt, with their walls, launches and peak memory, and
     (after phase 15) batched_skeleton_forge over phase 15's tube crop
     (phase 6's tasks before phase 16) into a second skeleton directory,
     its .frags equal to phase 15's; the launch counts are set to 0 just
     before each part;
  3d. pipelined (after phase 3c, on phase 3's and 3b's layers): the
     image as 16 tasks of 1024x1024x64 with 3 mips (phase 3c's first
     batched grid) and the segmentation as 16 tasks of 512x512x64 with 2
     mips, each through create_downsampling_tasks -> LocalTaskQueue into
     new layers that share phase 3's mip 0, once with IGNEOUS_PIPELINE=off
     (the serial loop, on the first 2 tasks of each stream since phase 17)
     and once at the default (the staged pipeline): per
     run its wall, stage split (thread-seconds), the caller's waits, the
     prefetch buffer's stalls and high-water bytes and the chunk cache's
     counts; pyramid2x2x1 once a task (counts set to 0 just before each
     run), the runner's stats 16 staged, none solo or failed, every chunk
     written and the info's scales equal to phase 3's solo output; then phase 3b's
     cseg layer and phase 3's image (its mip 0 stored uncompressed, so
     compress none) through create_transfer_tasks with skip_downsamples
     into layers of the same chunking and encoding: the passthrough moves
     every chunk verbatim, each file byte for byte the source's, no kernel
     launched; the decode route (IGNEOUS_TRANSFER_PASSTHROUGH=off, and for
     the cseg layer once more with IGNEOUS_CHUNK_CACHE=off) writes the
     same bytes; every wall printed;
  4. e2e ccl: two file:// layers (a 448x448x224 thresholded smooth image
     at half the task's depth, one task, and an 896x448x56 uint64
     segmentation of 188 balls at an eighth of it, two tasks, whose
     faces and equivalences join across the task boundary) through
     ccl_auto (the four passes on a
     LocalTaskQueue, task shape 448^3, raw destination), with the wall time
     of every pass and the stage split of its tasks; the launch counts are
     set to 0 just before each layer and read just after, tile_resolve must
     have launched at least once per task in each recomputing pass, and
     the destination must be the same partition as scipy.ndimage.label's
     (6-connected, per label), with max_label its component count;
  5. e2e mesh: a 896x448x112 uint64 Voronoi segmentation (250 seeds, ids
     above 2^32 and 2^63, membrane gaps) through create_meshing_tasks ->
     LocalTaskQueue -> MeshTask (two tasks of the default 448^3 shape, at
     a quarter of its depth: 448x448x112; simplification 100 with
     error 40, spatial index, gzip; 8 simplification threads) and
     create_mesh_manifest_tasks; each task's wall, stage split and
     label and face counts, the merge's wall; every fragment listed in
     exactly one manifest and every listed fragment present; the first
     task's labels, boxes and dense ids, and 64 of its labels (from seed
     1) plus its largest meshed on the card and on the CPU, byte for byte
     equal, unsimplified and simplified, and equal to the written
     fragments; the launch counts are set to 0 before and none of the
     kernels may launch; the device programs of the path (the XLA
     programs X1-X3 the port runs as torch ops) timed at the first
     task's largest count pass against their bytes bound;
  6. e2e skeleton: a 1024x512x128 uint64 layer of 75 neurite-like tubes
     (radius 3-12 voxels along random polylines, ids above 2^32 and 2^63,
     many across x = 512; a quarter of the depth and tubes of the
     1024x512x512 layer it had before phases 8 and 9) through
     create_skeletonizing_tasks -> LocalTaskQueue -> SkeletonTask (two
     tasks of the default 512^3 shape with every default, 8 tracing
     threads) and
     create_unsharded_skeleton_merge_tasks; each task's wall, stage split,
     label and vertex counts, the card's busy time from a profiler trace
     and its peak memory; edt_pass must launch three times a task (the
     counts set to 0 before) and the other kernels not at all; every tube
     component across x = 512 one connected merged skeleton; the first
     task's EDT field equal to the plain version's (run on the card) bit
     for bit, and 8 of its labels (seed 1; 32 before phase 20) plus its
     largest skeletonized to the same bytes on the card and on the CPU
     route, and equal to the written fragments;
  8. morphology and the census (after phase 6): a 448x448x112 uint64
     "hollow cells" layer (75 Voronoi cells with cavities, every third
     opened by a one-voxel channel, and 200 specks, a quarter across
     x = 224): dilate and erode of the first mesh task's cutout on the
     card and on the CPU route, bit for bit, and X6 (the dilation step)
     timed against its bound; create_voxel_counting_tasks (224x224x112)
     -> LocalTaskQueue -> CountVoxelsTask and accumulate_voxel_counts, the
     totals equal to numpy's over the layer; two MeshTasks of 224x448x112
     with fill_holes=3, dust_threshold=100 and dust_global (8
     simplification threads): the meshed labels exactly those of 100 or
     more voxels in the census, the first task's labels (32 and its
     largest) card against CPU and against the written fragments, the
     level-3 fill count above the level-1 count above 0, each task's
     stage split (fill_holes on the host, dilate and erode on the card);
     no pooling, CCL or EDT kernel launched;
  9. inference (after phase 3d, on phase 3's image, bounds 1024x512x64,
     half its width before phase 11):
     the repo's inference model (convnet3d 1 -> 8 -> 2, patch 64x64x32,
     overlap 16x16x8, init_params(seed=0)) through create_inference_tasks
     -> LocalTaskQueue -> InferenceTask, 8 tasks of 108 patches at batch
     4, pipelined with postprocess none, again with IGNEOUS_PIPELINE=off
     and with batch 7 (each on the first 4 tasks since phase 13, byte for
     byte the first's same files), and with argmax
     (equal to the argmax of the first's floats); the identity model on
     the card and on the CPU route (4 tasks each since phase 13), byte for
     byte; the first task on the
     card and on the CPU route within rtol 1e-5 and atol 1e-5 of the
     largest output, argmax differences only at margins within it; per
     run its wall, stage split, the caller's waits, patches, padded slots
     and dispatches; X7 (one dispatch of the model, cuDNN with TF32 off)
     against its bound and cuDNN's batched call; the card's busy share
     over one task from a profiler trace; no hand kernel launched;
  10. the device plane (igneous_tpu_torch.observability.device,
     compile_cache, tune): the cost of one span on the card (1000 empty
     spans) before the e2e phases; the device ledger reset before each
     pipelined stream of phase 3d, each inference campaign of phase 9,
     each mesh and skeleton task of phases 5 and 6, and printed after it
     (the card's busy share, dispatches, h2d and d2h bytes, pad waste,
     peak memory, the spans' host cost as a share of the wall, each
     name's executes and span seconds; the hand kernels' executes equal
     their launches); on phase 9's traced task and on phase 4's first
     pass-1 task run again under a profiler trace, the ledger against the
     trace: each hand kernel's span seconds within 10% (or 20 us a
     launch) of its traced kernel time, its executes its launches, the
     busy seconds between the trace's kernel and copy time and the wall;
     then (after phase 8) the library store: every library of the run
     put into a file:// store, a worker process with an empty build
     directory and no compiler loads every one from it and holds each
     hand kernel bit for bit against its plain version, fetch seconds
     beside build seconds, and a bit-flipped entry quarantined, rebuilt
     and put back; and the tuner, tune.run(size=64, budget_sec=60): each
     candidate's time, all byte for byte the default's, the tuned file
     of the card's kind written and read back by resolve;
  11. the queue worker (after phase 3d, and after the batched parts of
     phases 4 and 6): (a) phase 3d's 16-task image stream (both streams
     before phase 18) inserted with
     `image downsample --queue fq://...` and drained by two workers at
     once, a worker process (`python -m igneous_tpu_torch execute
     --batch 4 -x`) and, once it holds leases, `execute --batch 8 -x
     --time` in this process (its launches and device ledger read):
     each task completed once (16 tallies, none leased or dead-lettered),
     every chunk of the new mips equal to phase 3's solo output, the walls
     beside phase 3d's; (b) phase 3's ragged image as 16 tasks of
     256x256x64 through a queue at batch 8 (full members through
     pyramid2x2x1, clamped ones through the pages and pool2x2x1), CCL pass
     1 of phase 4's segmentation through `ccl faces --queue` at batch 4
     (one paged_ccl group, every face file the task path's) and the
     sharded skeleton forge of phase 15's tube crop through a queue at
     batch 2 (one paged_edt group, both .frags phase 15's; phase 6's
     tasks before phase 16), no member solo, failed or fallen back;
     (c) eight downsample tasks and a FailTask at --max-deliveries 2 (the
     dead-letter queue holds the FailTask alone, with its reason twice),
     a worker process drained by its --drain-sentinel mid-run (exit 83,
     no lease held) and a second worker finishing its queue, and a 6 s
     task at --lease-sec 2 held by its heartbeat (a second worker finds
     nothing to lease; one completion, no zombie count);
  12. the storage plane (after phase 9, on phase 3's layers), with the
     repo's fake GCS and S3 servers (tests/fake_cloud_servers.py) in this
     process: (a) a 2048x2048x64 crop of the image uploaded to gs:// in
     128x128x64 gzip chunks, `image downsample --queue` (4 tasks of
     1024x1024x64, 4 mips in 64^3 chunks) and `execute --batch 4` here (one
     group, one pyramid2x2x1 launch, two injected 503s retried), every
     chunk byte for byte the same crop's on file:// by the solo route and
     every stored chunk in the integrity manifests with its digest;
     (b) a 1024x512x64 crop of the segmentation on s3:// (SigV4, mip 0 in
     multipart parts) through LocalTaskQueue, byte for byte the file://
     route's; (c) (a)'s layer damaged three ways (a flipped byte at mip 1,
     a truncated chunk at mip 2, a deleted one at mip 3): `audit --queue`
     names exactly those and exits 2, `audit --heal --queue` repairs them
     with three DownsampleTasks (pyramid2x2x1 three times), its second
     round clean, exit 0, every healed chunk its bytes before the damage;
     a flipped mip-0 chunk is UNHEALABLE, exit 2; (d) phase 3d's pipelined
     image stream (its first 4 tasks since phase 17, 8 before) with
     IGNEOUS_INTEGRITY=off, at the default and with
     IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE=1: walls, busy shares, every
     run's chunks phase 3's byte for byte. Each part prints its wall, requests per server, bytes up and
     down per protocol and the retries.* and integrity.* counters;
  13. sharded scales (after phase 12, on phase 3's layers): (a) the smooth
     image through `image xfer --sharded` (one task, one shard file) and
     `image downsample --sharded --num-mips 5` (one ImageShardDownsampleTask,
     one pyramid2x2x1 launch of L=5); (b) a 1024x1024x64 crop of the
     segmentation through `image xfer --sharded --memory 2^26` (8 shard
     files) and `image downsample --sharded --memory 2^26 --num-mips 2
     --queue fq://...` (4 tasks of 512x512x64) drained by `execute --batch
     4` in this process: each task
     completed once, every member solo, pyramid2x2x1 once a member; (c) a
     2048x2048x64 crop of the smooth image through `image downsample
     --isotropic` (2x2x1 twice, then 2x2x2), each mip equal to the plain
     pyramid of the same schedule on the card, pyramid2x2x1 launched for the
     leading 2x2x1 run. Every shard file decoded by a reader of the format
     kept in this script (not the port's ShardReader), every chunk id of the
     grid there once, the mip-0 chunks the source's bytes, every mip of (a)
     and (b) read back through Volume equal to phase 3's solo mips; each run
     prints its wall, stage split, the card's busy share (device ledger) and
     peak card memory;
  14. contrast and the image surface (after phase 13, on phase 3's smooth
     image; (e) after phase 5, on its layer), through the command line and
     LocalTaskQueue: on a 2560x2560x64 crop, (a) `image contrast histogram`
     at its defaults, each levels file equal to a numpy recomputation of
     the same sampled columns; (b) `image contrast equalize` in 4 tasks,
     every voxel the float32 stretch computed in numpy; (c) `image contrast
     clahe` at its defaults (4 tasks of 2048x2048x64, grid 8, clip 40), one
     clahe launch a task, every voxel clahe_plain on the card over the same
     padded cutouts; (d) `image roi --threshold 170` (max axial length 512:
     three 2x2x1 rounds, one pyramid2x2x1 launch; tile_resolve), the ROIs
     and the info's equal to scipy.ndimage's on the plain pyramid; (e) `mesh
     spatial-index create` of phase 5's layer into a second prefix, each
     .spatial file equal to a numpy oracle of the boxes, in its key order;
     (f) `image create` from an .npy and an .nrrd of a 512x512x64 crop and
     (g) `image reorder` of the first with z reversed, each read back. Each
     run prints its wall, the card's busy share (device ledger), launches
     and peak card memory;
  15. frags and multires (after phases 5 and 6, on crops of their layers):
     (a) `mesh forge --sharded` of a 448x224x112 crop of phase 5's layer
     (its far corner; ids above 2^32, some at or above 2^63) in 2 tasks of 224x224x112, one
     .frags container a task, the first byte for byte the same task on the
     CPU route; `mesh merge-sharded --nlod 1` into several shard files
     through fq:// and `execute`, every label read back through the port's
     ShardReader, each manifest 2 LODs whose fragment sizes sum to its
     data, every draco fragment decoding inside the stored lattice; (b) the
     legacy forge of the same crop (every .frags entry its gunzipped
     fragment), `mesh xfer --sharded --nlod 1` into a new layer and `mesh
     merge --nlod 1`, checked alike; (c) the sharded skeleton forge of a
     256x256x128 crop of phase 6's layer in 2 tasks (edt_pass 3 launches a
     task; the first task's .frags the CPU route's), `skeleton
     spatial-index db` and `skeleton merge-sharded --spatial-index-db`,
     every label of the index read from the shard files; (d) `mesh clean`
     and `mesh rm` (through the queue) of (b)'s layer and `skeleton xfer`
     of (c)'s through the queue, the files left and copied as counted.
     Each part prints its wall, stage split, the card's busy share (device
     ledger), peak card memory and launches;
  16. graphene and cross-sections (after phase 15, in phases 5 and 6's
     roots): a 384x128x64 crop of phase 5's layer cut into chunk-local
     supervoxels (the watershed layer; ids above 2^32, some at or above
     2^63) whose chunk graph (the port's LocalChunkGraph, chunks of
     128x128x64: each label's supervoxels chained by edges, so that
     touching supervoxels of one root share no edge, an autapse; a merge
     and a split at timestamps) the repo's fake PyChunkGraph server
     (tests/fake_pcg_server.py) serves in this process, as of a timestamp
     between the two edits: (a) the graphene mesh forge, 2 GrapheneMeshTasks
     at the default task shape (256x256x128), draco .frags of L2 ids
     (simplification off), task 0 again on the CPU route; (d) the
     agglomerated transfer with 2 new mips (pyramid2x2x1 once), every
     chunk the CPU route's; (b) the skeleton forge with fix_autapses of 6
     roots in 2 tasks (edt_pass 3 launches a task; the card's voxel graph
     of task 0's cutout bit for bit its plain version), again from (d)'s
     root layer (root_ids_cloudpath; the same files), task 0 on the CPU
     route; (e) the agglomerated census against numpy; then (c) on phase
     15's tube crop, `skeleton forge --cross-section 1` (contact repair
     unlimited) of its smallest label crossing the task boundary (2 tasks,
     edt_pass 6 launches), task 0 on the CPU route, `skeleton merge` and
     `skeleton convert` to SWC. Each part prints its wall, the card's busy
     share (device ledger), peak card memory, launches, the requests the
     PCG server answered and the host stages (cross-section and repair
     seconds);
  17. the journaled campaign (after phase 14, on phase 3's image; its
     skeleton group after phase 16, on phase 15's crop): (a) 8 of phase 3d's image-stream tasks (1024x1024x64, 3
     mips; the first two columns of phase 3's image) through `image
     downsample --queue fq://...` and `execute --batch 4 --metrics-port 0
     -x` (the fq:// default journal), spans on and off
     (IGNEOUS_TRACE_SAMPLE=0) in turns, twice each, into new layers: each
     wall, the card's busy share, the journal's segments, bytes and
     records a task, the seconds of journal flushes on the worker's
     thread; the host cost of one trace span (1000 spans); then phase
     15's tube crop, one skeleton group (edt_pass, three launches),
     journaled, its .frags phase 15's; (c) `profile capture --duration 2`
     before a solo run (`execute -x --pipeline`) of the same tasks, then `profile
     ls`: its Chrome trace holds pyramid2x2x1 kernels on the card; (d)
     `fleet status` (its task count the queue's tallies), `top`,
     `devices` (the card's name, the busy share of the worker's last
     ledger record), `trace <id>` (the pyramid2x2x1 execute span under
     its task span; the Perfetto export with a device track), `check
     --json` (its anomalies printed, not failed on), `compact`, `status`
     from the rollups equal to the raw segments' in every count, `gc`;
     (b) one /metrics scrape of a worker (`--batch 4 --metrics-port 0
     --drain-sentinel`) once the queue tallied every task: its delivery
     counters the tasks, the igneous_device_* gauges there; the sentinel
     drains it (exit 83, its last will's counters line); (e) the same
     tasks through LocalTaskQueue, no journal: every journaled run's
     layer byte for byte its layer;
  18. campaign survival (after phase 17, in phase 3's root): (a) 8 of
     phase 3d's image-stream tasks in two ranges; a worker process S
     stopped (SIGSTOP) once it holds a range; `campaign run --actuator
     local` twins S's silent ranges and its spawned worker finishes the
     campaign on the card; S resumed and drained (its acks fenced): the
     tally exactly 8, won + fenced == issued >= 1 (queue and journal), a
     scale-up and a scale-down, the spawned workers' exits 83 or 0 and
     pyramid2x2x1 in their device records, every chunk phase 17's; (b)
     phase 3's ragged image as 16 tasks behind a 6 s SleepTask in one
     range: a holder process whose pre-leased round sits unstarted, a
     thief in this process (IGNEOUS_STEAL=1) claiming it and running the
     tail the holder's renewal grants: claims, grants and stolen tasks,
     the tally exact, every chunk phase 3's; (c) the same 16 tasks to a
     worker named in health/flags.json, which runs its 9 full members in
     one pyramid2x2x1 launch and sheds the 7 clamped ones, none of whose
     pages ran, to a healthy worker (28 page rounds of pool2x2x1); (d)
     `fleet simulate` of (a)'s journal twice: equal forecasts and
     journal bytes, `fleet status` on them, the forecast printed beside
     (a)'s wall; each part's wall, workers, busy share and the survival
     counters printed;
  19. serving and chaos (after phase 18, in phase 3's root): (a) new
     layers holding phase 3's whole info and only its mip 0 (hard links),
     the image's and the segmentation's, served by a ServeApp on
     localhost; 16 clients request every mip-4 chunk of the image (a walk
     of 4 levels from mip 0), 16 of its mip-1 chunks and every mip-3
     chunk of the segmentation (mode), each synthesized on the card with
     one pyramid2x2x1 launch and served with phase 3's offline chunk's
     stored bytes; the same list again from the RAM tier with no launch;
     the requests' p50 and p99, the card's busy share; (b) a second
     replica peered with the first asks for 8 mip-2 chunks the first
     owns, each twice: one synthesis and one peer fill a chunk, launches
     the number of distinct chunks; (c) 8 of phase 3d's image-stream
     tasks on the first two columns of phase 3's image (re-ingested with
     gzip) drained by this process's lease batcher, clean and under
     chaos_storage and ChaosQueue (put_fail 0.2, get_corrupt 0.1, one
     crash between compute and upload, drop_delete 0.2): the faults
     fired, the failed deliveries, the launches, and the two layers byte
     for byte equal;
  20. pods (after phase 19, in phase 3's root): two rank processes on the
     card (IGNEOUS_COORDINATOR, IGNEOUS_NUM_PROCESSES, IGNEOUS_PROCESS_ID;
     they share the card, so their group is gloo): (a) a lease of 7
     cutouts of 1024x1024x64 of phase 3's image split by lease_partition
     (4 slots a rank, one zero-pad slot), ChunkExecutor.run_global with 3
     mips of (2,2,1); (b) a lease of 3 cutouts of 512x512x64 of phase 3's
     segmentation as (lo, hi) uint32 planes, by mode; (c) phase 3's
     ragged image cut into 32^3 pages (2048), split by page_partition,
     through PagedGlobalRunner (3 mips); every real row (page) a rank
     addresses equal to phase 3's stored mip 1-3 bytes, the all-reduced
     nonzero count of (a) and (b) the cutouts' count on both ranks, each
     rank's pyramid2x2x1 and pool2x2x1 launches (counted from 0 before
     each part) above 0; (d) a one-rank NCCL group in this process whose
     run_global all-reduces its count as a CUDA tensor, then destroyed;
     the ranks' and the parts' walls;
  7. the card's name and power limit, the programs line (X1-X3, X5-X7),
     the kernels line (each kernel's launches on the main paths, the
     transfer, the batched phase, the pipelined streams, the worker phase,
     where each of the four must have launched, the storage phase, the
     sharded phase, phase 14, phase 15 (edt_pass), phase 16
     (pyramid2x2x1, edt_pass), phase 17 (pyramid2x2x1, edt_pass), phase
     18 (pyramid2x2x1, pool2x2x1), phase 19 (serve, chaos) and phase 20
     (pod: the ranks' and (d)'s)), and the result.

Exits non-zero, printing no result, without a CUDA device or without the
package beside it.

    python3 chip_smoke.py --baseline NAME=DIR [--baseline NAME=DIR ...]

times the kernels of other copies of the package (an earlier commit's, say:
``git archive <commit> igneous_tpu_torch | tar -x -C DIR0`` makes
DIR0/igneous_tpu_torch) against this checkout's, in turns on the same card,
with equal outputs (edt_pass pass by pass and over the three passes on
the 515^3 field; clahe on each of its cases, where the other copy has
it), and runs phases 1 and 2 only.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost (Hopper white paper)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations per output voxel: 4 loads' sum, round, shift (average);
# 6 compares, 4 counts, 3 score selects (mode)
OPS_PER_OUTPUT = {"average": 5, "mode": 16}
TOLERANCE = 0  # the pooling and CCL contracts are bitwise
CCL_CUTOUT = 449  # the default CCL task's cutout: 448^3 plus the overlap
CCL_TASK_SHAPE = (448, 448, 448)
CCL_TILE_SWEEP = [(8, 16, 64), (16, 16, 32), (8, 16, 32)]
CCL_ODD_TILE = (3, 5, 7)


def fail(msg: str) -> None:
  print(f"FAIL: {msg}", file=sys.stderr)
  sys.exit(1)


def card_line() -> str:
  proc = subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True, timeout=60,
  )
  return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not read"


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
  import torch

  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return float(np.median(times))


def device_ms(fn, reps: int = 10, batch: int = 10) -> float:
  """Device time of one call of ``fn`` (a kernel wrapper): ``batch`` calls
  captured in a CUDA graph and replayed ``reps`` times between CUDA events;
  the median over the replays, divided by ``batch``. Unlike ``cuda_ms``
  this leaves out the host's time to launch, which for a kernel of tens of
  microseconds is as long as the kernel."""
  import torch

  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(batch):
      fn()
  ms = cuda_ms(graph.replay, reps, warmup=1) / batch
  del graph
  torch.cuda.empty_cache()
  return ms


def max_abs_err(outs, refs) -> float:
  import torch

  from igneous_tpu_torch.ops.cuda_pooling import SIGNED_VIEW

  err = 0.0
  for o, r in zip(outs, refs):
    if o.shape != r.shape:
      return float("inf")
    signed = SIGNED_VIEW.get(o.dtype, o.dtype)
    if not torch.equal(o.view(signed), r.view(signed)):
      a = o.cpu().numpy().astype(np.float64)
      b = r.cpu().numpy().astype(np.float64)
      err = max(err, float(np.abs(a - b).max()))
  return err


def bound(method: str, x, outs):
  """(ms, "bytes" or "operations"): the least time for the work, the larger
  of each input byte read once and each output byte written once over the
  memory rate, and the integer operations over the INT32 rate."""
  nbytes = x.numel() * x.element_size() + sum(o.numel() * o.element_size() for o in outs)
  ops = OPS_PER_OUTPUT[method] * sum(o.numel() for o in outs)
  bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT32_OPS_PER_S
  return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def against(fn, others, reps: int = 10):
  """Times ``fn`` against each (name, other) of ``others``, the same
  function from another copy of the package, in turns (other, fn, fn,
  other) on this card with ``device_ms``; returns one record per other,
  with the means of both pairs and whether the two outputs are equal."""
  import torch

  records = []
  for name, other in others:
    o1 = device_ms(other, reps)
    c1 = device_ms(fn, reps)
    c2 = device_ms(fn, reps)
    o2 = device_ms(other, reps)
    a, b = fn(), other()
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    equal = all(
      torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b)
    )
    records.append({"against": name, "ms": (c1 + c2) / 2,
                    "other_ms": (o1 + o2) / 2, "equal": equal})
  return records


def pool_input(dtype: str, shape, g, torch, dev):
  """Seeded test data: uint8 noise, int16 noise with negative sums, uint32
  labels above 2^31 and uint64 labels above 2^32, three labels each."""
  if dtype == "uint8":
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)
  if dtype == "int16":
    return torch.randint(-32768, 32768, shape, dtype=torch.int16, device=dev, generator=g)
  lab = torch.randint(0, 3, shape, dtype=torch.int64, device=dev, generator=g)
  if dtype == "uint32":
    return (lab * 65537 + 2**31).to(torch.uint32)
  return (lab * (2**33 + 7) + 2**40).view(torch.uint64)


# the single step: (dtype, method, plane); every element width on a vector
# path (even widths) and on the element-wise path (odd widths), and the
# 4-byte chunks of a 500 plane (the ragged task's second level)
POOL_CASES = [
  ("uint8", "average", (1000, 1000)),  # the ragged task's first level
  ("uint8", "average", (125, 125)),
  ("uint32", "mode", (1000, 1000)),
  ("uint8", "average", (999, 999)),
  ("uint8", "average", (500, 500)),
  ("int16", "average", (1000, 1000)),
  ("int16", "average", (999, 999)),
  ("uint32", "mode", (999, 999)),
  ("uint64", "mode", (1000, 1000)),
  ("uint64", "mode", (999, 999)),
]


def kernel_phase(cp, torch, dev, others=()):
  """Each pooling kernel against its plain version at the main path's
  shapes and at every element width; ``others`` are (name, cuda_pooling
  of another copy of the package) to time against."""
  g = torch.Generator(device=dev).manual_seed(0)
  cases = []

  def run(name, kernel, plain, x, method, label, other_fns=()):
    outs = kernel()
    refs = plain()
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, list) else [outs]
    refs = refs if isinstance(refs, list) else [refs]
    err = max_abs_err(outs, refs)
    del refs
    bound_ms, bound_by = bound(method, x, outs)
    case = {
      "kernel": name, "case": label, "max_abs_err": err,
      "ms": device_ms(kernel),
      "call_ms": cuda_ms(kernel, reps=20),
      "plain_ms": cuda_ms(plain, reps=3, warmup=1),
      "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if other_fns:
      case["against"] = against(kernel, other_fns)
    print("kernel " + json.dumps(case), flush=True)
    if err > TOLERANCE:
      fail(f"{name} {label}: max abs err {err} against its plain version")
    if not all(r["equal"] for r in case.get("against", ())):
      fail(f"{name} {label}: differs from the other copy's kernel")
    cases.append(case)

  # fused walk: uint8 image, 5 levels (the image layer's task)
  x = pool_input("uint8", (1, 64, 4096, 4096), g, torch, dev)
  run("pyramid2x2x1", lambda: cp.pyramid2x2x1(x, 5, "average"),
      lambda: cp.pyramid2x2x1_plain(x, 5, "average"), x, "average",
      "uint8 average L=5 (1,64,4096,4096)")
  del x
  # fused walk: uint64 labels above 2^32, 4 levels (the segmentation task)
  x = pool_input("uint64", (1, 64, 2048, 2048), g, torch, dev)
  run("pyramid2x2x1", lambda: cp.pyramid2x2x1(x, 4, "mode"),
      lambda: cp.pyramid2x2x1_plain(x, 4, "mode"), x, "mode",
      "uint64 mode L=4 (1,64,2048,2048)")
  del x
  # fused walk: int16 with negative sums (floor, not truncation)
  x = pool_input("int16", (1, 64, 2048, 2048), g, torch, dev)
  run("pyramid2x2x1", lambda: cp.pyramid2x2x1(x, 4, "average"),
      lambda: cp.pyramid2x2x1_plain(x, 4, "average"), x, "average",
      "int16 average L=4 (1,64,2048,2048)")
  del x
  for dtype, method, (Y, X) in POOL_CASES:
    x = pool_input(dtype, (1, 64, Y, X), g, torch, dev)
    vec = cp.row_vector_bytes(X, x.element_size(), x.data_ptr(), 0)
    other_fns = [(n, (lambda m=m: m.pool2x2x1(x, method))) for n, m in others]
    run("pool2x2x1", lambda: cp.pool2x2x1(x, method),
        lambda: cp.pool2x2x1_plain(x, method), x, method,
        f"{dtype} {method} (1,64,{Y},{X}), {vec or 'element'}-byte chunks", other_fns)
    del x
  torch.cuda.empty_cache()
  return cases


def smooth_image(shape, rng, torch, dev) -> np.ndarray:
  """A spatially correlated uint8 surrogate of EM imagery, (x, y, z) in
  Fortran order: grey 128 plus three octaves of trilinearly interpolated
  value noise (cells of 64, 16 and 4 voxels in x and y; 16, 8 and 4 in z)
  and voxel noise of standard deviation 4, clipped to 0..255. Made on the
  card from ``rng``; unlike uniform noise, gzip compresses it."""
  import torch.nn.functional as F

  X, Y, Z = shape
  acc = torch.full((1, 1, Z, Y, X), 128.0, device=dev)
  for cxy, cz, amp in ((64, 16, 40.0), (16, 8, 20.0), (4, 4, 10.0)):
    coarse = rng.standard_normal((Z // cz + 1, Y // cxy + 1, X // cxy + 1), dtype=np.float32)
    acc += amp * F.interpolate(
      torch.from_numpy(coarse).to(dev)[None, None], size=(Z, Y, X),
      mode="trilinear", align_corners=True,
    )
  g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
  acc += 4.0 * torch.randn(acc.shape, device=dev, generator=g)
  img = acc.clamp_(0, 255).round_().to(torch.uint8)[0, 0].cpu().numpy()
  del acc
  torch.cuda.empty_cache()
  return img.transpose(2, 1, 0)  # (z, y, x) C order is (x, y, z) F order


def layer_data(kind: str, rng, torch, dev) -> np.ndarray:
  if kind == "segmentation":
    # labels above 2^32 in 3x3 blocks: odd blocks straddle the 2x2 windows,
    # so the votes see 2-2 ties
    blocks = rng.integers(0, 6, (683, 683, 64), dtype=np.int64).astype(np.uint64)
    blocks = blocks * np.uint64(2**33 + 7) + np.uint64(2**40)
    img = np.repeat(np.repeat(blocks, 3, axis=0), 3, axis=1)[:2048, :2048]
    return np.asfortranarray(img)
  if kind == "smooth":
    return smooth_image((4096, 4096, 64), rng, torch, dev)
  # uniform noise: incompressible, the worst case for gzip (random bytes:
  # a bounded draw of 2^30 uint8 values takes the host some 30 s)
  shape = (4096, 4096, 64) if kind == "image" else (1000, 1000, 64)
  data = bytearray(rng.bytes(int(np.prod(shape))))
  return np.frombuffer(data, np.uint8).reshape(shape, order="F")


LAYERS = [
  # name, data kind, chunk size, num_mips, expected kernel
  ("image", "image", (128, 128, 64), 5, "pyramid2x2x1"),
  ("segmentation", "segmentation", (128, 128, 64), 4, "pyramid2x2x1"),
  ("ragged_image", "ragged", (64, 64, 64), 5, "pool2x2x1"),
  ("smooth_image", "smooth", (128, 128, 64), 5, "pyramid2x2x1"),
]


def written_ratio(root: str, name: str, vol, num_mips: int) -> float:
  """Raw bytes of mips 1..num_mips over the bytes their chunk files take."""
  import os

  raw = stored = 0
  for mip in range(1, num_mips + 1):
    raw += int(np.prod(vol.meta.volume_size(mip))) * vol.dtype.itemsize
    d = os.path.join(root, name, vol.meta.key(mip))
    stored += sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
  return raw / stored


def e2e_phase(root, cp, torch, dev):
  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.ops import pooling
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_downsampling_tasks

  rng = np.random.default_rng(1)
  datas = {}
  for name, kind, chunk, num_mips, _ in LAYERS:
    t0 = time.perf_counter()
    datas[name] = layer_data(kind, rng, torch, dev)
    # mip 0 goes in uncompressed to save host time; the tasks keep gzip
    Volume.from_numpy(
      datas[name], f"file://{root}/{name}", resolution=(8, 8, 40),
      chunk_size=chunk, compress=None,
    )
    print(f"ingest {name}: {datas[name].shape} {datas[name].dtype} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

  for key in cp.LAUNCHES:
    cp.LAUNCHES[key] = 0
  for name, _kind, _chunk, num_mips, expect in LAYERS:
    path = f"file://{root}/{name}"
    before = dict(cp.LAUNCHES)
    tasks = create_downsampling_tasks(path, mip=0, num_mips=num_mips)
    if len(tasks) != 1:
      fail(f"{name}: expected one task, planned {len(tasks)}")
    telemetry.reset_all()
    t0 = time.perf_counter()
    LocalTaskQueue(parallel=1).insert(tasks)
    wall = time.perf_counter() - t0
    stages = {k: round(v["seconds"], 4) for k, v in telemetry.snapshot().items()}
    launched = {k: cp.LAUNCHES[k] - before[k] for k in cp.LAUNCHES}
    ratio = written_ratio(root, name, Volume(path), num_mips)
    print(f"e2e {name}: task wall {wall:.3f} s, stages (s) {json.dumps(stages)}, "
          f"launches {json.dumps(launched)}, gzip ratio {ratio:.3f}", flush=True)
    if launched[expect] < 1:
      fail(f"{name}: the {expect} kernel was not launched")
  main_launches = dict(cp.LAUNCHES)
  for key, n in main_launches.items():
    if n < 1:
      fail(f"e2e: kernel {key} was launched no time on the main path")

  # read every produced mip back; compare with the plain pyramid on the card
  for name, _kind, _chunk, num_mips, _ in LAYERS:
    path = f"file://{root}/{name}"
    vol = Volume(path)
    if vol.meta.num_mips != num_mips + 1:
      fail(f"{name}: {vol.meta.num_mips} scales, expected {num_mips + 1}")
    method = pooling.method_for_layer(vol.layer_type)
    x = torch.from_numpy(datas[name].transpose(2, 1, 0)).to(dev)[None]
    refs = cp.pyramid2x2x1_plain(x, num_mips, method)
    for mip, ref in enumerate(refs, start=1):
      got = Volume(path, mip=mip)
      got = got.download(got.mip_bounds(mip))[..., 0]
      want = ref[0].cpu().numpy().transpose(2, 1, 0)
      if got.shape != want.shape or not np.array_equal(got, want):
        fail(f"{name} mip {mip}: read back differs from the plain pyramid")
    del x, refs
    torch.cuda.empty_cache()
    print(f"e2e {name}: {num_mips} mips read back, equal to the plain pyramid", flush=True)
  return main_launches


# ---------------------------------------------------------------------------
# chunk codecs and the transfer (host codecs, the pyramid on the card)

# chunks of each mip, chosen from seed 1 (all, where fewer); 4 since phase
# 20 (32 before), to make room for it in the time limit
CODEC_SAMPLE = 4
CODEC_MIPS = (0, 3)
XFER_CHUNK = (64, 64, 64)
XFER_MIPS = 4
XFER_CROP = (512, 512, 64)  # the compresso transfer's bounds


def rate(nbytes: int, seconds: float) -> float:
  return round(nbytes / seconds / 1e6, 1) if seconds > 0 else float("inf")


def codec_phase(root: str) -> None:
  """Chunks of phase 3's raw uint64 segmentation through every route of
  the compressed_segmentation codec (native, numpy, the per-block loop
  spec: one stream) and through compresso, each read back equal; rates of
  one thread on the host."""
  import os

  from igneous_tpu_torch import Volume, compresso, cseg

  t_phase = time.perf_counter()
  rng = np.random.default_rng(1)
  block = (8, 8, 8)
  for mip in CODEC_MIPS:
    vol = Volume(f"file://{root}/segmentation", mip=mip)
    chunks = vol._chunks(vol.mip_bounds(mip), mip)
    pick = rng.choice(len(chunks), min(CODEC_SAMPLE, len(chunks)), replace=False)
    secs = {k: 0.0 for k in ("native_enc", "numpy_enc", "loop_enc", "native_dec",
                             "numpy_dec")}
    raw = stored = 0
    cutouts = []
    for i in sorted(pick):
      chan = vol.download(chunks[i], mip)[..., 0]  # (x, y, z), Fortran order
      cutouts.append(chan)
      t0 = time.perf_counter()
      native = cseg._native_encode_channel(chan, block)
      t1 = time.perf_counter()
      numpy_words = cseg._encode_channel(chan, block)
      t2 = time.perf_counter()
      loop = cseg._encode_channel_loop(chan, block)
      t3 = time.perf_counter()
      if not (np.array_equal(native, loop) and np.array_equal(numpy_words, loop)):
        fail(f"codec: cseg routes disagree on chunk {chunks[i]} at mip {mip}")
      words = np.concatenate([np.uint32([1]), loop])
      t4 = time.perf_counter()
      back = cseg._native_decode_channel(words[1:], chan.shape, np.uint64, block)
      t5 = time.perf_counter()
      back_np = np.empty(chan.shape, np.uint64, order="F")
      cseg._decode_channel_np(words, 1, chan.shape, block, 2, np.uint64, out=back_np)
      t6 = time.perf_counter()
      if not (np.array_equal(back, chan) and np.array_equal(back_np, chan)):
        fail(f"codec: cseg decode differs from chunk {chunks[i]} at mip {mip}")
      if cseg.compress(chan) != words.tobytes():
        fail(f"codec: cseg.compress differs from its routes at mip {mip}")
      for key, dt in zip(secs, (t1 - t0, t2 - t1, t3 - t2, t5 - t4, t6 - t5)):
        secs[key] += dt
      raw += chan.nbytes
      stored += words.nbytes
    rates = {k: rate(raw, v) for k, v in secs.items()}
    print(f"codec cseg mip {mip}: {len(pick)} chunks {chunks[0].size3().tolist()} uint64, "
          f"{raw / 2**20:.0f} MiB, native = numpy = loop bytes, decoded equal; "
          f"raw/cseg {raw / stored:.2f}; MB/s one thread {json.dumps(rates)}; "
          f"host cores {os.cpu_count()}", flush=True)

    # compresso: the same chunks, one thread
    enc = dec = 0.0
    stored = 0
    for chan in cutouts:
      t0 = time.perf_counter()
      data = compresso.compress(chan)
      t1 = time.perf_counter()
      back = compresso.decompress(data, chan.shape + (1,), np.uint64)
      t2 = time.perf_counter()
      if not np.array_equal(back[..., 0], chan):
        fail(f"codec: compresso round trip differs at mip {mip}")
      enc += t1 - t0
      dec += t2 - t1
      stored += len(data)
    print(f"codec compresso mip {mip}: {len(cutouts)} chunks round trip equal, "
          f"raw/compresso {raw / stored:.2f}, MB/s one thread "
          f"enc {rate(raw, enc)} dec {rate(raw, dec)}", flush=True)
  print(f"codec: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


def tree_bytes(path: str) -> int:
  import os

  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files)


def xfer_e2e_phase(root, cp, torch, dev):
  """Phase 3's raw segmentation through create_transfer_tasks into a
  compressed_segmentation layer of 64^3 chunks with 4 new mips (compress
  at its default), task by task on a LocalTaskQueue; every mip read back
  equal to the same mip of the raw layer (which phase 3 held against the
  plain pyramid on the card); then a compresso transfer of a crop.
  Returns the kernels' launches."""
  from igneous_tpu_torch import Bbox, Volume, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_transfer_tasks

  t_phase = time.perf_counter()
  src, dest = f"file://{root}/segmentation", f"file://{root}/segmentation_cseg"
  for key in cp.LAUNCHES:
    cp.LAUNCHES[key] = 0
  t0 = time.perf_counter()
  tasks = list(create_transfer_tasks(
    src, dest, chunk_size=XFER_CHUNK, encoding="compressed_segmentation",
    num_mips=XFER_MIPS,
  ))
  plan = time.perf_counter() - t0
  for i, task in enumerate(tasks):
    telemetry.reset_all()
    before = dict(cp.LAUNCHES)
    t0 = time.perf_counter()
    LocalTaskQueue(parallel=1).insert([task])
    wall = time.perf_counter() - t0
    stages = {k: round(v["seconds"], 4) for k, v in telemetry.snapshot().items()}
    launched = {k: cp.LAUNCHES[k] - before[k] for k in cp.LAUNCHES}
    print(f"e2e xfer task {i}: {task.shape.tolist()} at {task.offset.tolist()}, "
          f"wall {wall:.3f} s, stages (s) {json.dumps(stages)}, "
          f"launches {json.dumps(launched)}", flush=True)
  launches = dict(cp.LAUNCHES)
  if launches["pyramid2x2x1"] < 1:
    fail("xfer: pyramid2x2x1 was not launched")

  dvol = Volume(dest)
  if dvol.meta.num_mips != XFER_MIPS + 1:
    fail(f"xfer: {dvol.meta.num_mips} scales, expected {XFER_MIPS + 1}")
  raw = sum(int(np.prod(dvol.meta.volume_size(m))) * 8 for m in range(XFER_MIPS + 1))
  written = tree_bytes(f"{root}/segmentation_cseg")
  print(f"e2e xfer: {len(tasks)} tasks (planned in {plan:.3f} s), launches "
        f"{json.dumps(launches)}, written {written} bytes, raw {raw} bytes, "
        f"raw/written {raw / written:.2f}", flush=True)

  t0 = time.perf_counter()
  for mip in range(XFER_MIPS + 1):
    want = Volume(src, mip=mip)
    got = Volume(dest, mip=mip)
    if got.mip_bounds(mip) != want.mip_bounds(mip) or got.meta.encoding(mip) != \
        "compressed_segmentation":
      fail(f"xfer mip {mip}: bounds or encoding differ")
    a = got.download(got.mip_bounds(mip))
    b = want.download(want.mip_bounds(mip))
    if not np.array_equal(a, b):
      fail(f"xfer mip {mip}: the cseg layer differs from the raw layer")
    del a, b
  print(f"e2e xfer: mips 0-{XFER_MIPS} read back equal to the raw layer's, "
        f"{time.perf_counter() - t0:.1f} s", flush=True)

  # compresso: a crop, no pyramid
  cdest = f"file://{root}/segmentation_compresso"
  crop = Bbox((0, 0, 0), XFER_CROP)
  t0 = time.perf_counter()
  LocalTaskQueue(parallel=1).insert(create_transfer_tasks(
    src, cdest, encoding="compresso", bounds=crop, skip_downsamples=True,
  ))
  wall = time.perf_counter() - t0
  cvol = Volume(cdest)
  if cvol.meta.encoding(0) != "compresso-cpsx":
    fail(f"xfer compresso: info advertises {cvol.meta.encoding(0)!r}")
  if not np.array_equal(cvol.download(crop), Volume(src).download(crop)):
    fail("xfer compresso: the crop read back differs from the raw layer")
  print(f"e2e xfer compresso: {list(XFER_CROP)} crop in {wall:.3f} s, "
        f"{tree_bytes(f'{root}/segmentation_compresso')} bytes written, read back "
        f"equal, info advertises compresso-cpsx", flush=True)
  if any(cp.LAUNCHES[k] != launches[k] for k in launches):
    fail("xfer compresso: a kernel ran on a transfer with no pyramid")
  print(f"e2e xfer: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return launches


# ---------------------------------------------------------------------------
# connected components


def serpentine(n: int, torch, dev):
  """(z, y, x) int32 n^3: one tube that winds through every tile. Even z
  planes hold strips 7 voxels wide in x, each a row-by-row serpentine along
  y (a turn every two rows), joined by the full last row; odd z planes
  join consecutive even planes at one voxel."""
  y = torch.arange(n, device=dev).view(n, 1)
  x = torch.arange(n, device=dev).view(1, n)
  pos = x % 8
  turn_x = torch.where((y // 2) % 2 == 0, 6, 0)
  plane = ((y % 2 == 0) & (pos < 7)) | ((y % 2 == 1) & (pos == turn_x)) | (y == n - 1)
  vol = torch.zeros((n, n, n), dtype=torch.int32, device=dev)
  vol[0::2] = plane.to(torch.int32)
  vol[1::2, n - 1, 0] = 1
  return vol


def ccl_kernel_phase(cc, ccl_ops, torch, dev, others=()):
  """tile_resolve against tile_resolve_plain at the default task's 449^3
  cutout: five cases in the CUDA default tile, then every tile of the
  sweep and an odd tile at connectivity 6 and 26. Each check runs the
  kernel twice and needs the same output both times and bit for bit the
  plain version's. ``others`` are (name, cuda_ccl of another copy of the
  package) to time the five cases against."""
  n = CCL_CUTOUT
  tile = ccl_ops._tile_shape(dev)
  rng = np.random.default_rng(1)
  mask = smooth_image((n, n, n), rng, torch, dev) >= 128  # (x, y, z)
  mask = torch.from_numpy(np.ascontiguousarray(mask.transpose(2, 1, 0))).to(dev).to(torch.int32)
  g = torch.Generator(device=dev).manual_seed(2)
  dense = torch.randint(1, 4, (n, n, n), dtype=torch.int32, device=dev, generator=g)
  inputs = [
    ("mask of the smooth image >= 128", mask, 6),
    ("dense multilabel, 3 labels", dense, 6),
    ("serpentine tube", serpentine(n, torch, dev), 6),
    ("dense multilabel, 3 labels, connectivity 26", dense, 26),
    ("dense multilabel, 3 labels, connectivity 18", dense, 18),
  ]

  def check(label, labt, conn):
    """The kernel twice and its plain version: max abs err, plain ms."""
    first = cc.tile_resolve(labt, conn)
    second = cc.tile_resolve(labt, conn)
    t0 = time.perf_counter()
    plain = cc.tile_resolve_plain(labt, conn)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not torch.equal(first, second):
      fail(f"tile_resolve {label}: two runs gave different outputs")
    err = 0.0 if torch.equal(first, plain) else float(
      (first.to(torch.int64) - plain.to(torch.int64)).abs().max()
    )
    if err > TOLERANCE:
      fail(f"tile_resolve {label}: max abs err {err} against its plain version")
    return err, plain_s

  def instance(labt):
    return "fixed" if cc.fixed_instance(labt.shape[1:], labt.data_ptr()) else "runtime"

  cases = []
  for label, vol, conn in inputs:
    labt = ccl_ops.to_tiles(vol, tile)[0]
    err, _ = check(label, labt, conn)
    nbytes = 2 * labt.numel() * labt.element_size()
    # one label comparison per neighbour pair: half the neighbourhood
    ops = labt.numel() * len(cc.neighbor_offsets(conn)) // 2
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / INT32_OPS_PER_S
    fn = lambda: cc.tile_resolve(labt, conn)  # noqa: E731
    case = {
      "kernel": "tile_resolve",
      "case": f"{label}, {n}^3, tiles {list(labt.shape)}, {instance(labt)} instance",
      "max_abs_err": err,
      "ms": device_ms(fn),
      "call_ms": cuda_ms(fn, reps=20),
      "plain_ms": cuda_ms(lambda: cc.tile_resolve_plain(labt, conn), reps=3, warmup=1),
      "bound_ms": max(bytes_ms, ops_ms),
      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      "library": "none",
    }
    if others:
      case["against"] = against(fn, [(k, lambda m=m: m.tile_resolve(labt, conn)) for k, m in others])
      if not all(r["equal"] for r in case["against"]):
        fail(f"tile_resolve {label}: differs from the other copy's kernel")
    print("kernel " + json.dumps(case), flush=True)
    print("library: none (PyTorch has no connected-components call)", flush=True)
    cases.append(case)
  # every tile of the sweep, and an odd tile (the runtime-shape instance,
  # plain loads), checked on the mask at 6 and on dense labels at 26; the
  # time on the mask, and the share of voxel pairs that straddle a tile
  # face (what the host merge handles)
  for sweep in CCL_TILE_SWEEP + [CCL_ODD_TILE]:
    line = {"tile": list(sweep), "default": tuple(sweep) == tuple(tile),
            "face_pairs_a_voxel": sum(1 / t for t in sweep)}
    for label, vol, conn in (inputs[0], inputs[3]):
      labt = ccl_ops.to_tiles(vol, sweep)[0]
      line["instance"] = instance(labt)
      line[f"plain_s_{conn}"] = check(f"{label}, tile {list(sweep)}", labt, conn)[1]
      fn = lambda: cc.tile_resolve(labt, conn)  # noqa: E731
      line[f"ms_{conn}"] = device_ms(fn)
      if others:
        line[f"against_{conn}"] = against(
          fn, [(k, lambda m=m: m.tile_resolve(labt, conn)) for k, m in others], reps=5)
    print("tile sweep " + json.dumps(line), flush=True)
  del inputs, mask, dense, labt
  torch.cuda.empty_cache()
  return cases


def blobs(shape, n_labels: int, n_blobs: int, rng, torch, dev) -> np.ndarray:
  """(x, y, z) uint64 Fortran-ordered: background 0 and ``n_blobs`` balls
  (radius 8..32) painted with ``n_labels`` labels above 2^32, so one label
  recurs in places that do not touch. Painted on the card from ``rng``."""
  X, Y, Z = shape
  vol = torch.zeros((Z, Y, X), dtype=torch.int64, device=dev)
  values = 2**32 + 7919 * (1 + rng.permutation(10 * n_labels)[:n_labels])
  for _ in range(n_blobs):
    r = int(rng.integers(8, 33))
    cz, cy, cx = (int(rng.integers(0, s)) for s in (Z, Y, X))
    z0, y0, x0 = max(cz - r, 0), max(cy - r, 0), max(cx - r, 0)
    z1, y1, x1 = min(cz + r + 1, Z), min(cy + r + 1, Y), min(cx + r + 1, X)
    zz = torch.arange(z0, z1, device=dev).view(-1, 1, 1) - cz
    yy = torch.arange(y0, y1, device=dev).view(1, -1, 1) - cy
    xx = torch.arange(x0, x1, device=dev).view(1, 1, -1) - cx
    ball = zz * zz + yy * yy + xx * xx <= r * r
    box = vol[z0:z1, y0:y1, x0:x1]
    box[ball] = int(values[int(rng.integers(n_labels))])
  out = vol.cpu().numpy().view(np.uint64).transpose(2, 1, 0)
  del vol
  torch.cuda.empty_cache()
  return out


CCL_LAYERS = [
  # name, shape (x, y, z), dtype, ccl_auto options, cut so that the whole
  # script stays inside its time limit: the mask layer at half the depth of
  # the default 448^3 task (since the mesh phase), half its width (since
  # the device plane's phase 10) and one task (since phase 19), the
  # segmentation at half that depth since phases 8 and 9, a quarter since
  # the storage phase 12 and an eighth since phase 19. The mask layer keeps
  # its depth: its first task is the traced one of phase 10, whose
  # tile_resolve must outlast a launch's host path (the ledger check)
  ("ccl_mask", (448, 448, 224), "uint8", {"threshold_gte": 128}),
  ("ccl_segmentation", (896, 448, 56), "uint64", {}),
]
CCL_BLOBS = 188  # balls of the segmentation layer (1500 at its full depth)


def oracle(data: np.ndarray, kw: dict, torch, dev):
  """scipy.ndimage.label, 6-connected: of the thresholded image, or of each
  label of a segmentation, on the (z, y, x) view (C-contiguous, as the
  arrays are Fortran-ordered (x, y, z)). Returns (components, an int64
  (z, y, x) tensor on the card, and their count)."""
  from scipy import ndimage

  s6 = ndimage.generate_binary_structure(3, 1)
  zyx = data.transpose(2, 1, 0)
  if "threshold_gte" in kw:
    exp, n = ndimage.label(zyx >= kw["threshold_gte"], structure=s6)
    return torch.from_numpy(exp).to(dev).to(torch.int64), n
  seg = torch.from_numpy(zyx.view(np.int64)).to(dev)  # labels are below 2^63
  exp = torch.zeros(seg.shape, dtype=torch.int64, device=dev)
  total = 0
  for v in torch.unique(seg[seg != 0]).tolist():
    m, k = ndimage.label((seg == v).cpu().numpy(), structure=s6)
    m = torch.from_numpy(m).to(dev).to(torch.int64)
    exp = torch.where(m > 0, m + total, exp)
    total += k
  return exp, total


def same_partition(out: np.ndarray, exp, torch, dev) -> bool:
  """True when ``out`` ((x, y, z) uint16 or uint32, Fortran-ordered) and
  ``exp`` (its (z, y, x) oracle on the card) have the same background and a
  bijection between their component ids (checked on the card)."""
  signed = {2: np.int16, 4: np.int32}[out.dtype.itemsize]
  a = torch.from_numpy(out.transpose(2, 1, 0).view(signed)).to(dev).to(torch.int64)
  a &= (1 << (8 * out.dtype.itemsize)) - 1
  fg = a != 0
  if not torch.equal(fg, exp != 0):
    return False
  a, b = a[fg], exp[fg]
  for x, y in ((a, b), (b, a)):
    m = torch.full((int(x.max()) + 1,), -1, dtype=torch.int64, device=dev)
    m[x] = y
    if not torch.equal(m[x], y):
      return False
  return True


class TimedQueue:
  """A LocalTaskQueue that records, for each insert (each pass of
  ccl_auto), its start and end on the host clock, its task count and the
  telemetry stages of its tasks."""

  def __init__(self):
    from igneous_tpu_torch.queues import LocalTaskQueue

    self.queue = LocalTaskQueue(parallel=1)
    self.passes = []

  def insert(self, tasks):
    from igneous_tpu_torch import telemetry

    tasks = list(tasks)
    telemetry.reset_all()
    t0 = time.perf_counter()
    self.queue.insert(tasks)
    t1 = time.perf_counter()
    self.passes.append({
      "start": t0, "end": t1, "tasks": len(tasks),
      "stages": {k: round(v["seconds"], 4) for k, v in telemetry.snapshot().items()},
    })


def ccl_e2e_phase(root, cc, cp, torch, dev):
  """Each CCL layer through ccl_auto; returns tile_resolve's launches."""
  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.task_creation import ccl_auto

  rng = np.random.default_rng(1)
  launches = 0
  for name, shape, dtype, kw in CCL_LAYERS:
    t0 = time.perf_counter()
    if dtype == "uint8":
      data = smooth_image(shape, rng, torch, dev)
    else:
      data = blobs(shape, 16, CCL_BLOBS, rng, torch, dev)
    src, dest = f"file://{root}/{name}", f"file://{root}/{name}_out"
    Volume.from_numpy(data, src, resolution=(8, 8, 40), chunk_size=(64, 64, 64),
                      compress=None)
    print(f"ingest {name}: {data.shape} {data.dtype} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    queue = TimedQueue()
    for counts in (cc.LAUNCHES, cp.LAUNCHES):
      for key in counts:
        counts[key] = 0
    t0 = time.perf_counter()
    max_label = ccl_auto(src, dest, shape=CCL_TASK_SHAPE, queue=queue,
                         encoding="raw", **kw)
    wall = time.perf_counter() - t0
    launched = cc.LAUNCHES["tile_resolve"]
    p1, p2, p4 = queue.passes
    walls = {
      "faces": p1["end"] - p1["start"], "links": p2["end"] - p2["start"],
      "calc-labels": p4["start"] - p2["end"], "relabel": p4["end"] - p4["start"],
      "clean": t0 + wall - p4["end"],
    }
    print(f"e2e {name}: ccl_auto {wall:.3f} s, {p1['tasks']} tasks, "
          f"max_label {max_label}, tile_resolve launches {launched}, "
          f"pass walls (s) {json.dumps({k: round(v, 3) for k, v in walls.items()})}",
          flush=True)
    for pname, p in zip(("faces", "links", "relabel"), queue.passes):
      print(f"e2e {name} {pname}: stages over {p['tasks']} tasks (s) "
            f"{json.dumps(p['stages'])}", flush=True)
    if any(cp.LAUNCHES.values()):
      fail(f"{name}: the pooling kernels ran on the CCL path")
    if launched < 3 * p1["tasks"]:
      fail(f"{name}: tile_resolve launched {launched} times for "
           f"{p1['tasks']} tasks in 3 recomputing passes")
    launches += launched

    t0 = time.perf_counter()
    exp, n = oracle(data, kw, torch, dev)
    vol = Volume(dest)
    out = vol.download(vol.mip_bounds(0))[..., 0]
    ok = same_partition(out, exp, torch, dev)
    print(f"e2e {name}: oracle {n} components, same partition {ok}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not ok or max_label != n:
      fail(f"{name}: destination differs from scipy.ndimage.label "
           f"(max_label {max_label}, oracle {n}, same partition {ok})")
    del data, exp, out
    torch.cuda.empty_cache()
    if name == CCL_LAYERS[0][0]:
      ccl_traced_task(src, kw, cc, cp, torch, dev)
  return launches


def ccl_traced_task(src: str, kw: dict, cc, cp, torch, dev) -> None:
  """The first pass-1 task of a CCL layer once more, under a profiler
  trace: the device ledger against the trace. Runs after the layer's
  launches were read; the next layer sets them to 0."""
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation.ccl import create_ccl_face_tasks
  from torch.profiler import ProfilerActivity, profile

  task = next(iter(create_ccl_face_tasks(src, shape=CCL_TASK_SHAPE, **kw)))
  for counts in (cc.LAUNCHES, cp.LAUNCHES):
    for key in counts:
      counts[key] = 0
  ledger_reset(torch, dev)
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    LocalTaskQueue(parallel=1).insert([task])
    wall = time.perf_counter() - t0
  launched = launch_counts(cc, cp)
  if launched["tile_resolve"] != 1:
    fail(f"ccl traced task: tile_resolve launched {launched['tile_resolve']} times, not once")
  snap = ledger_line("ccl traced task", wall, launched)
  ledger_against_profiler("ccl traced task", snap, prof, wall, launched)


# ---------------------------------------------------------------------------
# meshing

# (x, y, z): two tasks of the default 448^3 shape, at a quarter of its
# depth (half since the skeleton phase, a quarter since the device plane's
# phase 10) so that the whole script stays inside its time limit
MESH_SHAPE = (896, 448, 112)
MESH_SEEDS = 250
MESH_SAMPLE = 64  # labels of the first task held card against CPU, + its largest
# threads for the per-label simplification inside each task (the forge's
# --simplify-parallel; its output does not depend on it): at the default 1
# the host's QEM collapse takes 93% of a 179-201 s task, and the phase would
# not fit half the run's time limit beside the others;
# --mesh-simplify-threads 1 runs the forge with every default
MESH_SIMPLIFY_THREADS = 8
# the XLA device programs of the mesh path that the port runs as torch ops
MESH_PROGRAMS = {
  "X1 mc_count": "igneous_tpu/ops/mesh.py:543",
  "X2 mc_emit": "igneous_tpu/ops/mesh.py:613",
  "X3 mt_count": "igneous_tpu/ops/mesh.py:126",
}


def voronoi_segmentation(shape, n_seeds: int, rng, torch, dev) -> np.ndarray:
  """(x, y, z) uint64 Fortran-ordered: the Voronoi partition (in voxel
  distances) of ``n_seeds`` random seeds, with ids above 2^32, eight of
  them at or above 2^63, and every voxel with a 6-neighbour of another
  label set to 0, like the membrane gaps of an EM segmentation. Made on
  the card from ``rng``."""
  X, Y, Z = shape
  seeds = torch.from_numpy(rng.random((n_seeds, 3)) * np.array([X, Y, Z])).to(dev, torch.float32)
  ids = (2**32 + 7919 * (1 + rng.permutation(10 * n_seeds)[:n_seeds])).astype(np.uint64)
  ids[rng.choice(n_seeds, 8, replace=False)] |= np.uint64(2**63)
  ids = torch.from_numpy(ids.view(np.int64)).to(dev)
  yy, xx = torch.meshgrid(torch.arange(Y, device=dev), torch.arange(X, device=dev), indexing="ij")
  pts = torch.stack([xx.reshape(-1), yy.reshape(-1), torch.zeros_like(xx).reshape(-1)], 1)
  pts = pts.to(torch.float32)
  seg = torch.empty((Z, Y, X), dtype=torch.int64, device=dev)
  for z in range(Z):
    pts[:, 2] = z
    seg[z] = ids[torch.cdist(pts, seeds).argmin(1)].view(Y, X)
  edge = torch.zeros(seg.shape, dtype=torch.bool, device=dev)
  for d in range(3):
    n = seg.shape[d]
    diff = seg.narrow(d, 1, n - 1) != seg.narrow(d, 0, n - 1)
    edge.narrow(d, 1, n - 1).logical_or_(diff)
    edge.narrow(d, 0, n - 1).logical_or_(diff)
  seg.masked_fill_(edge, 0)
  out = seg.cpu().numpy().view(np.uint64).transpose(2, 1, 0)
  del seg, edge, diff
  if dev.type == "cuda":
    torch.cuda.empty_cache()
  return out


def check_manifests(path: str) -> int:
  """Every fragment in the mesh directory is listed in exactly one
  manifest, its label's, and every listed fragment exists. Returns the
  fragment count."""
  from igneous_tpu_torch import CloudFiles, Volume

  mdir = Volume(path).info["mesh"]
  cf = CloudFiles(path)
  names = [k.split("/")[-1] for k in cf.list(f"{mdir}/")]
  frags = {n for n in names if n.count(":") == 2}
  listed = []
  for manifest in (n for n in names if n.count(":") == 1):
    label = manifest.split(":")[0]
    doc = cf.get_json(f"{mdir}/{manifest}")
    for name in doc["fragments"]:
      if name.split(":")[0] != label:
        fail(f"mesh: manifest {manifest} lists another label's fragment {name}")
    listed += doc["fragments"]
  if len(listed) != len(set(listed)) or set(listed) != frags:
    fail(f"mesh: {len(frags)} fragments, {len(listed)} manifest entries "
         f"({len(set(listed))} distinct, {len(set(listed) - frags)} missing)")
  return len(frags)


def mesh_card_against_cpu(task, path: str, sample: int, torch, dev):
  """The first task's label work and ``sample`` of its labels (from seed
  1) plus its largest, on the card and on the CPU: equal jobs and dense
  labels, and byte for byte the same unsimplified and simplified meshes,
  equal to the fragments the run wrote. Returns the card's context."""
  from igneous_tpu_torch import CloudFiles, Volume, set_device
  from igneous_tpu_torch.mesh_io import Mesh, simplify
  from igneous_tpu_torch.ops.mesh import marching_cubes_batch
  from igneous_tpu_torch.tasks import MeshTask

  t0 = time.perf_counter()
  card = task.prepare_jobs()
  set_device("cpu")
  try:
    cpu = task.prepare_jobs()
  finally:
    set_device(dev)
  if card["jobs"] != cpu["jobs"]:
    fail("mesh: the card's labels, boxes or dense ids differ from the CPU's")
  if not torch.equal(card["dense"].cpu(), cpu["dense"]):
    fail("mesh: the card's dense renumbering differs from the CPU's")
  jobs = card["jobs"]
  voxels = torch.bincount(card["dense"].view(-1)).cpu().numpy()
  largest = max(range(len(jobs)), key=lambda j: int(voxels[jobs[j][2]]))
  pick = np.random.default_rng(1).choice(len(jobs), min(sample, len(jobs)), replace=False)
  group = [jobs[j] for j in sorted(set(pick.tolist()) | {largest})]
  mdir = Volume(path).info["mesh"]
  cf = CloudFiles(path)
  meshes = []
  for g0 in range(0, len(group), MeshTask.MESH_BATCH):
    grp = group[g0 : g0 + MeshTask.MESH_BATCH]
    res = [
      marching_cubes_batch(MeshTask.group_masks(ctx, grp), anisotropy=ctx["resolution"],
                           offsets=MeshTask.group_offsets(ctx, grp))
      for ctx in (card, cpu)
    ]
    for (label, _, _), (v, f), (cv, cf_) in zip(grp, *res):
      if v.dtype != cv.dtype or f.dtype != cf_.dtype or not (
        np.array_equal(v, cv) and np.array_equal(f, cf_)
      ):
        fail(f"mesh: label {label}: the card's mesh differs from the CPU's")
      meshes.append((label, Mesh(v, f)))

  def simplified_as_written(item):
    # equal inputs to the same host code: one simplification serves both
    label, mesh = item
    small = simplify(mesh, task.simplification_factor, task.max_simplification_error)
    written = cf.get(f"{mdir}/{label}:0:{card['core'].to_filename()}")
    return written is not None and Mesh.from_precomputed(written) == small

  with ThreadPoolExecutor(MESH_SIMPLIFY_THREADS) as pool:
    same = list(pool.map(simplified_as_written, meshes))
  for (label, _), ok in zip(meshes, same):
    if not ok:
      fail(f"mesh: label {label}: the written fragment differs from the card's mesh")
  faces = sum(len(m.faces) for _, m in meshes)
  big = jobs[largest]
  print(f"e2e mesh check: task 0, {len(group)} of {len(jobs)} labels (the largest, "
        f"{big[0]}, {int(voxels[big[2]])} voxels): card and CPU equal byte for byte "
        f"(jobs, dense ids, {faces} faces unsimplified, the simplified meshes, the "
        f"written fragments) {time.perf_counter() - t0:.1f} s", flush=True)
  return card


def profiled_device_ms(fn, torch, reps: int = 5, attempts: int = 3) -> float:
  """Kernel time on the card per call of ``fn`` (a sequence of torch ops),
  summed from a torch.profiler trace. A trace that shows no kernel time
  is taken again, up to ``attempts`` traces in all (an H100 run once gave
  an empty trace of a program that had traced before); fails where every
  trace shows none."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  for attempt in range(1, attempts + 1):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    us = traced_device_us(prof)
    if us > 0:
      if attempt > 1:
        print(f"profiler: kernel time in trace {attempt} of {attempts}", flush=True)
      return us / 1e3 / reps
    print(f"profiler: trace {attempt} of {attempts} shows no kernel time", flush=True)
  fail("profiler: the trace shows no kernel time on the card")


def traced_device_us(prof) -> float:
  """Microseconds of kernels and copies on the card in a profiler trace."""
  return sum(
    getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    for e in prof.key_averages()
  )


def mesh_programs(ctx, passes_per_task, torch, dev):
  """X1-X3 at the first task's largest count pass (the bucket batch with
  the most voxels): time per call between CUDA events, kernel time from
  the profiler, and the bytes bound (input and output bytes once)."""
  from igneous_tpu_torch.ops import mesh as mesh_ops
  from igneous_tpu_torch.tasks import MeshTask

  best = None
  jobs = ctx["jobs"]
  for g0 in range(0, len(jobs), MeshTask.MESH_BATCH):
    masks = MeshTask.group_masks(ctx, jobs[g0 : g0 + MeshTask.MESH_BATCH])
    buckets = {}
    for i in range(len(masks)):
      buckets.setdefault(mesh_ops._bucket_shape(masks.shape(i)), []).append(i)
    for bucket, idxs in buckets.items():
      size = len(idxs) * int(np.prod(bucket))
      if best is None or size > best[0]:
        best = (size, masks, bucket, idxs)
  _, masks, (bx, by, bz), idxs = best
  batch = torch.empty((len(idxs), bz, by, bx), dtype=torch.uint8, device=dev)
  for k, i in enumerate(idxs):
    masks.fill(i, batch[k])
  case, ntri, _ = mesh_ops._mc_count_kernel(batch)
  mesh_ops._drop_pad_ring(ntri, [tuple(s - 1 for s in masks.shape(i)) for i in idxs])
  nt = ntri.reshape(-1)
  total = int(nt.sum(dtype=torch.int64))
  cells = case.numel()
  label = f"{len(idxs)} masks of bucket {bx}x{by}x{bz}, {total} triangles"
  runs = [
    ("X1 mc_count", lambda: mesh_ops._mc_count_kernel(batch),
     batch.numel() + 2 * cells + 8 * len(idxs), passes_per_task),
    ("X2 mc_emit", lambda: mesh_ops._mc_tris(case, *mesh_ops._emit_slots(nt, total)),
     nt.numel() + 36 * total, passes_per_task),
    ("X3 mt_count", lambda: mesh_ops._count_kernel(batch),
     batch.numel() + 12 * cells + 8 * len(idxs), 0),
  ]
  programs = []
  for name, fn, nbytes, launches in runs:
    programs.append({
      "name": name, "replaces": MESH_PROGRAMS[name], "case": label,
      "launches_per_task": launches,
      "ms": cuda_ms(fn, reps=10), "device_ms": profiled_device_ms(fn, torch),
      "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
    })
  del batch, case, ntri, nt
  torch.cuda.empty_cache()
  return programs


def mesh_e2e_phase(root, torch, dev, shape=MESH_SHAPE, n_seeds=MESH_SEEDS,
                   sample=MESH_SAMPLE, simplify_threads=MESH_SIMPLIFY_THREADS):
  """The mesh forge and merge on a Voronoi segmentation with the defaults
  (task shape 448^3, simplification 100 with error 40, spatial index,
  gzip) but ``simplify_threads``: per task its wall, stage split (a
  stage's seconds are summed over the simplification threads), label and
  face counts, the card's busy time from a profiler trace of the task
  and its peak memory; the merge's wall; manifest coverage; the first
  task's labels held card against CPU; the device programs. Returns the
  programs."""
  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_mesh_manifest_tasks, create_meshing_tasks
  from torch.profiler import ProfilerActivity, profile

  t0 = time.perf_counter()
  data = voronoi_segmentation(shape, n_seeds, np.random.default_rng(1), torch, dev)
  path = f"file://{root}/mesh_segmentation"
  Volume.from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(64, 64, 64),
                    compress=None)
  print(f"ingest mesh_segmentation: {data.shape} {data.dtype}, "
        f"{len(np.unique(data)) - 1} labels {time.perf_counter() - t0:.1f} s", flush=True)
  del data

  tasks = list(create_meshing_tasks(path, parallel=simplify_threads))
  if len(tasks) != 2:
    fail(f"mesh: expected 2 tasks, planned {len(tasks)}")
  queue = LocalTaskQueue(parallel=1)
  passes = 0
  for i, task in enumerate(tasks):
    telemetry.reset_all()
    ledger_reset(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      queue.insert([task])
      wall = time.perf_counter() - t0
    busy = traced_device_us(prof) / 1e6
    if not busy > 0:
      fail(f"mesh task {i}: the trace shows no work on the card")
    ledger_line(f"mesh task {i} (traced busy {busy:.4f} s)", wall)
    snap = telemetry.snapshot()
    counts = telemetry.counters_snapshot()
    passes += snap["count"]["count"]
    print(f"e2e mesh task {i}: wall {wall:.3f} s, {simplify_threads} simplification "
          f"thread(s), {counts['mesh.labels']} labels, "
          f"{counts['mesh.faces']} faces, {counts['mesh.faces_simplified']} simplified, "
          f"card busy {busy:.4f} s (traced; idle {100 * (1 - busy / wall):.2f}%), "
          f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
          f"stages (s) {json.dumps({k: round(v['seconds'], 4) for k, v in snap.items()})}, "
          f"entries {json.dumps({k: v['count'] for k, v in snap.items()})}", flush=True)
  t0 = time.perf_counter()
  queue.insert(create_mesh_manifest_tasks(path, magnitude=2))
  merge = time.perf_counter() - t0
  frags = check_manifests(path)
  print(f"e2e mesh merge: wall {merge:.3f} s, {frags} fragments, each listed in "
        f"exactly one manifest, every listed fragment exists", flush=True)
  ctx = mesh_card_against_cpu(tasks[0], path, sample, torch, dev)
  if dev.type != "cuda":
    return []
  return mesh_programs(ctx, passes / len(tasks), torch, dev)


# ---------------------------------------------------------------------------
# EDT and skeletons

# (x, y, z): two tasks of the default 512^3 shape at a quarter of its depth
# (and a quarter of the tubes of the full depth; half since phases 8 and 9,
# a quarter since the storage phase 12), so that the run fits its limit
SKEL_SHAPE = (1024, 512, 128)
SKEL_TUBES = 75
# labels of the first task held card against CPU, + its largest; 8 since
# phase 20 (32 before), to make room for it in the time limit
SKEL_SAMPLE = 8
SKEL_MIN_CROSSING = 10  # boundary-crossing tube components the merge check needs
# threads for the per-label tracing of each task (the task's ``parallel``;
# its output does not depend on it), as the mesh phase uses 8 threads
SKEL_TRACE_THREADS = 8
EDT_CUTOUT = 513  # the default skeleton task's cutout: 512^3 plus the overlap
# (x, y, z) shapes whose lines exceed the shared-memory threshold (7264
# after the first pass): along z, and along x
EDT_LONG_Z = (32, 32, 8192)
EDT_LONG_X = (8192, 64, 64)
EDT_WORST = 515  # side of the worst-stack-depth case
EDT_REPLACES = "igneous_tpu/ops/edt.py:256"  # _edt_sq_kernel (XLA), three axis passes
# the JAX package's host EDT (threaded C++), timed as context only
HOST_EDT_SOURCE = "igneous_tpu/native/csrc/edt.cpp"


def neurites(shape, n_tubes: int, rng, torch, dev):
  """(z, y, x) int64 on ``dev`` holding uint64 bits: ``n_tubes`` tubes of
  radius 3-12 voxels along random polylines (5-8 segments of 60-160
  voxels, turning by up to 60 degrees), painted in order, so that later
  tubes cut earlier ones, with ids above 2^32, eight of them at or above
  2^63 (all of them if fewer). ``shape`` is (x, y, z). Made on the card
  from ``rng``."""
  X, Y, Z = shape
  vol = torch.zeros((Z, Y, X), dtype=torch.int64, device=dev)
  ids = (2**32 + 7919 * (1 + rng.permutation(10 * n_tubes)[:n_tubes])).astype(np.uint64)
  ids[rng.choice(n_tubes, min(8, n_tubes), replace=False)] |= np.uint64(2**63)
  size = np.array([X, Y, Z], dtype=np.float64)
  for t in range(n_tubes):
    r = float(rng.uniform(3, 12))
    p = rng.random(3) * size
    d = rng.standard_normal(3)
    d /= np.linalg.norm(d)
    label = int(ids.view(np.int64)[t])
    for _ in range(int(rng.integers(5, 9))):
      turn = rng.standard_normal(3)
      turn -= turn.dot(d) * d
      turn /= np.linalg.norm(turn)
      ang = float(rng.uniform(0, np.pi / 3))
      d = np.cos(ang) * d + np.sin(ang) * turn
      q = np.clip(p + d * rng.uniform(60, 160), 0, size - 1)
      lo = np.maximum(np.floor(np.minimum(p, q) - r), 0).astype(int)
      hi = np.minimum(np.ceil(np.maximum(p, q) + r) + 1, size).astype(int)
      xs = torch.arange(lo[0], hi[0], device=dev, dtype=torch.float32).view(1, 1, -1)
      ys = torch.arange(lo[1], hi[1], device=dev, dtype=torch.float32).view(1, -1, 1)
      zs = torch.arange(lo[2], hi[2], device=dev, dtype=torch.float32).view(-1, 1, 1)
      seg = q - p
      den = float(seg.dot(seg)) or 1.0
      u = ((xs - p[0]) * seg[0] + (ys - p[1]) * seg[1] + (zs - p[2]) * seg[2]) / den
      u = u.clamp(0, 1)
      dist2 = (xs - p[0] - u * seg[0]) ** 2 + (ys - p[1] - u * seg[1]) ** 2 \
        + (zs - p[2] - u * seg[2]) ** 2
      box = vol[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]]
      box.masked_fill_(dist2 <= r * r, label)
      p = q
  return vol


def host_edt_lib(torch):
  """The JAX package's host EDT (``HOST_EDT_SOURCE``) built with g++ into
  the port's build directory, or None where the source is absent. It is
  timed as context beside the card's EDT, and its output is held against
  the kernel's."""
  import ctypes
  import hashlib
  import os

  path = os.path.join(os.path.dirname(os.path.abspath(__file__)), HOST_EDT_SOURCE)
  if not os.path.exists(path):
    return None
  from igneous_tpu_torch.ops import _build

  src = open(path, "rb").read()
  out = _build.BUILD_DIR / f"libhostedt-{hashlib.sha256(src).hexdigest()[:8]}.so"
  if not out.exists():
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", *_build.GXX_FLAGS, "-o", str(out), path],
                   check=True, capture_output=True)
  lib = ctypes.CDLL(str(out))
  lib.edt_ml_sq64.restype = None
  lib.edt_ml_sq64.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
  ]
  return lib


def host_squared_edt(lib, lab, anisotropy):
  """Seconds and (z, y, x) float32 result of the host EDT on the (z, y, x)
  int64 tensor ``lab`` (passes along x, y, z, as the port's)."""
  import ctypes

  xyz = np.ascontiguousarray(lab.cpu().numpy().transpose(2, 1, 0))
  out = np.empty(xyz.shape, dtype=np.float32)
  t0 = time.perf_counter()
  lib.edt_ml_sq64(xyz.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
                  *xyz.shape, *(float(a) for a in anisotropy), 0)
  return time.perf_counter() - t0, out.transpose(2, 1, 0)


def squared_edt_with(edt_pass, lab, anisotropy):
  """The three passes of ``ops.edt.squared_edt`` with ``edt_pass``: a plain
  version, or another copy's kernel."""
  import torch

  wx, wy, wz = anisotropy
  a = torch.empty(lab.shape, dtype=torch.float32, device=lab.device)
  b = torch.empty_like(a)
  edt_pass(lab, a, a, 2, wx, True)
  edt_pass(lab, a, b, 1, wy, False)
  edt_pass(lab, b, a, 0, wz, False)
  return a


def plain_squared_edt(ce, lab, anisotropy):
  """The three passes of ``ops.edt.squared_edt`` with the plain version."""
  return squared_edt_with(ce.edt_pass_plain, lab, anisotropy)


# FP64 instructions a voxel, counted from csrc/edt.cu: a __ddiv_rn is
# FP64_PER_DIV of them (the reciprocal's Newton steps and the rounding
# correction nvcc emits for sm_90, its fast path), an add, subtract or
# multiply one
FP64_PER_DIV = 8
# 64 FP64 lanes per SM x 132 SMs x 1.98 GHz boost (Hopper white paper)
FP64_OPS_PER_S = 64 * 132 * 1.98e9


def edt_fp64_ops(lab, anisotropy, torch) -> float:
  """The least FP64 work of the three passes on this field, counted from
  the kernel's code and this run's data: the edge term's two multiplies
  for every voxel of every pass; in the y and z passes, for each value
  below the skip threshold (a push) its height (a division) and its
  offset (an add) and, at the queries, one add and one multiply; and for
  every push but the first of a run one pop test (a division, an add and
  a subtract). The values are the x and y passes' outputs."""
  from igneous_tpu_torch.ops import cuda_edt as ce

  wx, wy, _ = anisotropy
  ops = 3 * 2 * lab.numel()
  vals = torch.empty(lab.shape, dtype=torch.float32, device=lab.device)
  ce.edt_pass(lab, vals, vals, 2, wx, True)
  for axis in (1, 0):
    pushes = int((vals < ce._SKIP).sum())
    moved = lab.movedim(axis, -1)
    runs = int((moved[..., 1:] != moved[..., :-1]).sum()) + moved.numel() // moved.shape[-1]
    ops += pushes * (FP64_PER_DIV + 1 + 2) + max(0, pushes - runs) * (FP64_PER_DIV + 2)
    if axis == 1:
      vals = ce.edt_pass(lab, vals, torch.empty_like(vals), 1, wy, False)
  return float(ops)


def edt_bound(lab, anisotropy, torch):
  """(ms, "bytes" or "operations"): the least time of the three passes,
  the larger of the bytes (labels read once a pass, values read in passes
  2-3 and written in all three, float32) over the memory rate and the
  FP64 work of ``edt_fp64_ops`` over the FP64 rate."""
  nbytes = lab.numel() * (3 * lab.element_size() + 5 * 4)
  bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
  fp64_ms = 1e3 * edt_fp64_ops(lab, anisotropy, torch) / FP64_OPS_PER_S
  return (bytes_ms, "bytes") if bytes_ms >= fp64_ms else (fp64_ms, "operations"), fp64_ms


def edt_single_passes(ce, lab, label, g, torch, reps: int = 0):
  """``edt_pass`` alone on each axis, first and not, on seeded random
  values (uniform in [0, 1000), one in twenty 1e20), against its plain
  version bit for bit; returns {pass: device ms} when ``reps``."""
  dev = lab.device
  val = torch.rand(lab.shape, device=dev, generator=g) * 1000
  val[torch.rand(lab.shape, device=dev, generator=g) < 0.05] = ce.INF
  times = {}
  for axis in (0, 1, 2):
    for first in (True, False):
      got = ce.edt_pass(lab, val, torch.empty_like(val), axis, 3.0, first)
      ref = ce.edt_pass_plain(lab, val, torch.empty_like(val), axis, 3.0, first)
      if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        fail(f"edt_pass {label}: axis {axis} first={first} differs from its plain version")
      if reps:
        out = torch.empty_like(val)
        times[f"axis {axis}{' first' if first else ''}"] = device_ms(
          lambda: ce.edt_pass(lab, val, out, axis, 3.0, first), reps=reps, batch=3)
      del got, ref
  return times


def edt_kernel_phase(ce, edt_ops, torch, dev, others=()):
  """``edt_pass`` against its plain version on the card, bit for bit, on
  five cases: the default task's field (a 513^3 cutout of neurite-like
  uint64 labels, some at or above 2^63, padded to 515^3) at (8, 8, 40);
  a 257^3 crop of it at (1, 1, 1), and its low 32 bits as int32 labels;
  thin slabs; an odd shape. Each case runs twice and must give the same
  output; the float32 square root and cleared background must equal
  numpy's sqrt of the same squared field. The first case is also timed
  pass by pass, against each (name, cuda_edt of another copy of the
  package) of ``others`` in turns with equal outputs, and held against
  the JAX package's host EDT and timed there, as context. Then single
  passes on seeded random values along each axis, first and not, on the
  first case; the worst stack depth (one label, equal values: every
  position a stack entry) at 515^3, timed; and two cases whose lines
  exceed the shared-memory threshold (the long-line kernel), along z and
  along x."""
  rng = np.random.default_rng(1)
  g = torch.Generator(device=dev).manual_seed(1)
  n = EDT_CUTOUT
  field = neurites((n, n, n), 180, rng, torch, dev)
  full = torch.nn.functional.pad(field, (1, 1, 1, 1, 1, 1))
  slabs = torch.zeros((128, 256, 512), dtype=torch.int64, device=dev)  # (z, y, x)
  slabs[:, :, ::2] = 5  # 1-thick x slabs
  slabs[:, :128, :] += 7  # a label wall mid-y
  slabs[32:96, 64:192, 128:384] = 11
  odd = neurites((257, 3, 129), 6, rng, torch, dev)
  crop = full[:257, :257, :257]
  long_z = neurites(EDT_LONG_Z, 40, rng, torch, dev)
  long_x = neurites(EDT_LONG_X, 40, rng, torch, dev)
  inputs = [
    ("neurites 513^3 cutout padded to 515^3, uint64, (8, 8, 40)", full, (8, 8, 40)),
    ("neurites 257^3 crop of it, uint64, (1, 1, 1)", crop, (1, 1, 1)),
    ("neurites 257^3 crop, low 32 bits as int32, (8, 8, 40)", crop.to(torch.int32), (8, 8, 40)),
    ("thin slabs (512, 256, 128), (2, 3, 5)", slabs, (2, 3, 5)),
    ("odd shape (257, 3, 129) neurites, (4, 4, 40)", odd, (4, 4, 40)),
    (f"long lines along z {tuple(long_z.shape[::-1])} neurites, (8, 8, 40)", long_z, (8, 8, 40)),
    (f"long lines along x {tuple(long_x.shape[::-1])} neurites, (8, 8, 40)", long_x, (8, 8, 40)),
  ]
  host = host_edt_lib(torch)
  cases = []
  for label, lab, anis in inputs:
    lab = lab.contiguous()
    first = edt_ops.squared_edt(lab, anis)
    second = edt_ops.squared_edt(lab, anis)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
      fail(f"edt_pass {label}: two runs gave different outputs")
    t0 = time.perf_counter()
    plain = plain_squared_edt(ce, lab, anis)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same = torch.equal(first.view(torch.int32), plain.view(torch.int32))
    err = 0.0 if same else float((first.double() - plain.double()).abs().max())
    dist = edt_ops.distance_field(lab, anis)
    want = np.sqrt(first.cpu().numpy(), dtype=np.float32)
    want[(lab == 0).cpu().numpy()] = 0
    sqrt_same = np.array_equal(dist.cpu().numpy().view(np.uint32), want.view(np.uint32))
    fn = lambda: edt_ops.squared_edt(lab, anis)  # noqa: E731
    (bound_ms, bound_by), fp64_ms = edt_bound(lab, anis, torch)
    case = {
      "kernel": "edt_pass", "case": f"{label}, 3 passes", "max_abs_err": err,
      "ms": device_ms(fn, reps=5, batch=3), "call_ms": cuda_ms(fn, reps=5),
      "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms, "bound_by": bound_by,
      "fp64_bound_ms": fp64_ms,
      "scratch_gb": max(ce.scratch_bytes(lab.shape, a, a == 2) for a in range(3)) / 1e9,
      "long_line_passes": [a for a in range(3) if ce.long_line(lab.shape, a, a == 2)],
      "sqrt_bitwise": sqrt_same, "library": "none",
    }
    if lab is full:
      # each pass on its own input (the previous pass's output) into its
      # own buffer, so that every call of a pass does the same work
      wx, wy, wz = anis
      xo = torch.empty(lab.shape, dtype=torch.float32, device=dev)
      yo = torch.empty_like(xo)
      ce.edt_pass(lab, xo, xo, 2, wx, True)
      ce.edt_pass(lab, xo, yo, 1, wy, False)
      mine, theirs = torch.empty_like(xo), torch.empty_like(xo)
      passes = {
        "x (contiguous lines, first)": lambda m, dst: m.edt_pass(lab, dst, dst, 2, wx, True),
        "y": lambda m, dst: m.edt_pass(lab, xo, dst, 1, wy, False),
        "z": lambda m, dst: m.edt_pass(lab, yo, dst, 0, wz, False),
      }
      case["pass_ms"] = {k: device_ms(lambda f=f: f(ce, mine), reps=5, batch=3)
                         for k, f in passes.items()}
      Z, Y, X = lab.shape
      case["blocks_per_sm"] = {"x": ce.blocks_per_sm(X, 1, True),
                               "y": ce.blocks_per_sm(Y, X, False),
                               "z": ce.blocks_per_sm(Z, Y * X, False)}
      if others:
        case["against"] = {
          k: against(lambda f=f: f(ce, mine),
                     [(nm, lambda f=f, m=m: f(m, theirs)) for nm, m in others], reps=5)
          for k, f in passes.items()
        }
        case["against"]["3 passes"] = against(
          fn, [(nm, lambda m=m: squared_edt_with(m.edt_pass, lab, anis)) for nm, m in others],
          reps=5)
        for rec in [r for recs in case["against"].values() for r in recs]:
          if not rec["equal"]:
            fail(f"edt_pass {label}: differs from {rec['against']}'s kernel")
      del xo, yo, mine, theirs
    if host is not None and lab is full:
      host_s, host_sq = host_squared_edt(host, lab, anis)
      case["host_edt_cpp_ms"] = 1e3 * host_s
      case["host_edt_cpp_equal"] = np.array_equal(
        host_sq.view(np.uint32), first.cpu().numpy().view(np.uint32))
      if not case["host_edt_cpp_equal"]:
        fail(f"edt_pass {label}: differs from the JAX package's host EDT")
    if lab is full or lab is long_z or lab is long_x:
      # single passes on random values (the long-line cases' long passes
      # among them), bit for bit
      case["single_passes_bitwise"] = True
      case["single_pass_ms"] = edt_single_passes(ce, lab, label, g, torch,
                                                 reps=3 if lab is not full else 0)
    print("kernel " + json.dumps(case), flush=True)
    if err > TOLERANCE:
      fail(f"edt_pass {label}: max abs err {err} against its plain version")
    if not sqrt_same:
      fail(f"edt_pass {label}: the distances differ from numpy's sqrt of the squared field")
    cases.append(case)
    del first, second, plain, dist

  # the worst stack depth: one label and equal values, so that every
  # position of every line is a stack entry, along each axis
  one = torch.full((EDT_WORST,) * 3, 3, dtype=torch.int64, device=dev)
  val = torch.full(one.shape, 4.0, dtype=torch.float32, device=dev)
  worst = {}
  for axis in (0, 1, 2):
    out = torch.empty_like(val)
    got = ce.edt_pass(one, val, out, axis, 8.0, False)
    ref = ce.edt_pass_plain(one, val, torch.empty_like(val), axis, 8.0, False)
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
      fail(f"edt_pass worst stack depth: axis {axis} differs from its plain version")
    worst[f"axis {axis}"] = device_ms(lambda: ce.edt_pass(one, val, out, axis, 8.0, False),
                                      reps=5, batch=3)
    del got, ref
  print("kernel " + json.dumps({
    "kernel": "edt_pass", "case": f"worst stack depth: one label, equal values, "
    f"{EDT_WORST}^3, single passes at w = 8", "max_abs_err": 0.0, "pass_ms": worst,
  }), flush=True)
  print("library: none (PyTorch has no multilabel distance transform)", flush=True)
  del inputs, field, full, crop, slabs, odd, long_z, long_x, one, val
  torch.cuda.empty_cache()
  return cases


def crossing_components(seg, boundary: int, dust: int, torch):
  """{label: [(component mask (x, y, z) bool over its box, box lo)]} for
  every 26-connected component of a label with voxels on both sides of
  the plane x = ``boundary``, where the label has at least ``dust`` voxels
  in each task's cutout (x < boundary + 1 and x >= boundary; a task skips
  a label below its dust threshold, so no weld is expected there).
  ``seg``: the (z, y, x) int64 layer on the card."""
  from scipy import ndimage

  out = {}
  both = np.intersect1d(torch.unique(seg[:, :, boundary - 1]).cpu().numpy(),
                        torch.unique(seg[:, :, boundary]).cpu().numpy())
  for label in both[both != 0].tolist():
    hit = seg == label
    if min(int(hit[:, :, : boundary + 1].sum()), int(hit[:, :, boundary:].sum())) < dust:
      continue
    idx = hit.nonzero()
    lo, hi = idx.min(0).values.tolist(), (idx.max(0).values + 1).tolist()
    box = hit[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].cpu().numpy().transpose(2, 1, 0)
    comps, _ = ndimage.label(box, structure=np.ones((3, 3, 3), bool))
    origin = np.array(lo[::-1])
    for ci, sl in enumerate(ndimage.find_objects(comps), start=1):
      if sl is None or not (origin[0] + sl[0].start < boundary < origin[0] + sl[0].stop):
        continue
      out.setdefault(int(np.int64(label).view(np.uint64)), []).append(
        (comps[sl] == ci, origin + np.array([s.start for s in sl])))
  return out


def skeleton_card_against_cpu(task, path: str, sample: int, ce, edt_ops, torch, dev):
  """The first task's field on the card equals the plain version's (run on
  the card, the CPU route's code) bit for bit; ``sample`` of its labels
  (seed 1) plus its largest skeletonize, with the task's border pins, to
  the same bytes on the card and on the CPU route (labels and boxes in
  torch on the CPU, the plain field), equal to the written fragments."""
  import gzip
  import os

  from igneous_tpu_torch import Volume, set_device
  from igneous_tpu_torch.ops.mesh import labels_on_device
  from igneous_tpu_torch.ops.skeletonize import TeasarParams, cutout_labels, skeletonize

  t0 = time.perf_counter()
  vol = Volume(path)
  labels, cutout, core, bounds = task.prepare_labels(vol)
  anis = tuple(float(v) for v in vol.resolution)
  card_field, ids, counts, _, _ = cutout_labels(labels, anis)
  seg, _ = labels_on_device(labels, (0, 0, 0), (0, 0, 0), dev)
  pad = torch.nn.functional.pad(seg, (1, 1, 1, 1, 1, 1))
  sq = plain_squared_edt(ce, pad, (anis[0], anis[1], anis[2]))[1:-1, 1:-1, 1:-1]
  plain_field = torch.sqrt(sq).masked_fill_(seg == 0, 0.0).cpu().numpy().transpose(2, 1, 0)
  del seg, pad, sq
  torch.cuda.empty_cache()
  if not np.array_equal(card_field.view(np.uint32), plain_field.view(np.uint32)):
    fail("skeleton: the card's EDT field differs from the plain version's")
  largest = ids[int(np.argmax(counts))]
  pick = np.random.default_rng(1).choice(len(ids), min(sample, len(ids)), replace=False)
  chosen = sorted({ids[i] for i in pick} | {largest})
  kw = dict(
    anisotropy=anis, params=TeasarParams.from_dict(task.teasar_params),
    offset=tuple(float(v) for v in cutout.minpt), object_ids=chosen,
    dust_threshold=task.local_dust, parallel=SKEL_TRACE_THREADS,
    extra_targets_per_label=task.targets(labels, cutout, core, bounds),
  )
  card = skeletonize(labels, **kw)
  set_device("cpu")
  try:
    cpu = skeletonize(labels, edt_field=plain_field, **kw)
  finally:
    set_device(dev)
  if list(card) != list(cpu):
    fail("skeleton: the card and the CPU route skeletonized different labels")
  sdir = vol.info["skeletons"]
  verts = 0
  for label in card:
    data = card[label].to_precomputed()
    if data != cpu[label].to_precomputed():
      fail(f"skeleton: label {label}: the card's skeleton differs from the CPU route's")
    written = os.path.join(path[len("file://"):], sdir, f"{label}:{core.to_filename()}.sk.gz")
    with open(written, "rb") as f:
      if gzip.decompress(f.read()) != data:
        fail(f"skeleton: label {label}: the written fragment differs from the card's")
    verts += len(card[label].vertices)
  print(f"e2e skeleton check: task 0, {len(card)} of {len(ids)} labels (the largest, "
        f"{largest}, {int(counts.max())} voxels): the EDT field equal to the plain "
        f"version's, the skeletons ({verts} vertices) equal on the card and on the CPU "
        f"route and to the written fragments, {time.perf_counter() - t0:.1f} s", flush=True)


def skeleton_e2e_phase(root, ce, edt_ops, torch, dev):
  """The skeleton forge and merge with the defaults (task shape 512^3,
  +1 overlap, fix_borders, fix_branching, spatial index, TEASAR scale 4
  and const 500, forge dust 1000, merge dust 4000 and tick 6000,
  magnitude 1) but ``SKEL_TRACE_THREADS`` tracing threads: per task its
  wall, stage split, label and vertex counts, the card's busy time from a
  profiler trace and its peak memory, and ``edt_pass``'s launches (three
  a task); the merge's wall; every boundary-crossing tube one connected
  skeleton; the first task held card against CPU. Returns the launches."""
  from igneous_tpu_torch import CloudFiles, Volume, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.skeleton_io import Skeleton
  from igneous_tpu_torch.task_creation import (
    create_skeletonizing_tasks,
    create_unsharded_skeleton_merge_tasks,
  )
  from torch.profiler import ProfilerActivity, profile

  t0 = time.perf_counter()
  shape = SKEL_SHAPE
  seg = neurites(shape, SKEL_TUBES, np.random.default_rng(1), torch, dev)
  data = seg.cpu().numpy()
  path = f"file://{root}/skeleton_segmentation"
  Volume.from_numpy(data.view(np.uint64).transpose(2, 1, 0), path, resolution=(8, 8, 40),
                    chunk_size=(64, 64, 64), compress=None, layer_type="segmentation")
  print(f"ingest skeleton_segmentation: {shape} uint64, {len(torch.unique(seg)) - 1} labels, "
        f"{100 * float((seg != 0).double().mean()):.1f}% foreground "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  del data

  tasks = list(create_skeletonizing_tasks(path, parallel=SKEL_TRACE_THREADS))
  if len(tasks) != 2:
    fail(f"skeleton: expected 2 tasks, planned {len(tasks)}")
  queue = LocalTaskQueue(parallel=1)
  ce.LAUNCHES["edt_pass"] = 0
  for i, task in enumerate(tasks):
    telemetry.reset_all()
    before = ce.LAUNCHES["edt_pass"]
    ledger_reset(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      queue.insert([task])
      wall = time.perf_counter() - t0
    busy = traced_device_us(prof) / 1e6
    if not busy > 0:
      fail(f"skeleton task {i}: the trace shows no work on the card")
    launched = ce.LAUNCHES["edt_pass"] - before
    ledger_line(f"skeleton task {i} (traced busy {busy:.4f} s)", wall, {"edt_pass": launched})
    snap = telemetry.snapshot()
    counts = telemetry.counters_snapshot()
    print(f"e2e skeleton task {i}: wall {wall:.3f} s, {SKEL_TRACE_THREADS} tracing "
          f"threads, {counts.get('skeleton.labels', 0)} labels, {counts.get('skeleton.vertices', 0)} "
          f"vertices, edt_pass launches {launched}, card busy {busy:.4f} s (traced; idle "
          f"{100 * (1 - busy / wall):.2f}%), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, stages (s) "
          f"{json.dumps({k: round(v['seconds'], 4) for k, v in snap.items()})}", flush=True)
    if launched != 3:
      fail(f"skeleton task {i}: edt_pass launched {launched} times, not 3")
  launches = ce.LAUNCHES["edt_pass"]

  t0 = time.perf_counter()
  merges = list(create_unsharded_skeleton_merge_tasks(path))
  queue.insert(merges)
  merge = time.perf_counter() - t0
  cf = CloudFiles(path)
  sdir = Volume(path).info["skeletons"]
  names = [k.split("/")[-1] for k in cf.list(f"{sdir}/")]
  frags = sum(n.endswith(".sk") for n in names)
  merged = [n for n in names if n.isdigit()]
  print(f"e2e skeleton merge: wall {merge:.3f} s, {len(merges)} tasks, {frags} fragments, "
        f"{len(merged)} skeletons", flush=True)

  # every tube component crossing the task boundary is one skeleton there
  res = np.array([8, 8, 40], np.float32)
  crossing = crossing_components(seg, shape[0] // 2, tasks[0].dust_threshold, torch)
  del seg
  torch.cuda.empty_cache()
  checked = spanning = 0
  for label, comps in crossing.items():
    blob = cf.get(f"{sdir}/{label}")
    if blob is None:
      continue
    skel = Skeleton.from_precomputed(blob)
    comp = skel.components_by_vertex()
    vox = np.rint(skel.vertices / res).astype(np.int64)
    for mask, lo in comps:
      local = vox - lo
      inside = np.all((local >= 0) & (local < mask.shape), axis=1)
      inside[inside] = mask[tuple(local[inside].T)]
      if not inside.any():
        continue
      pieces = np.unique(comp[inside])
      if len(pieces) != 1:
        fail(f"skeleton: label {label}: a tube across x = {shape[0] // 2} is "
             f"{len(pieces)} skeleton pieces")
      checked += 1
      xs = vox[inside, 0]
      spanning += int(xs.min() < shape[0] // 2 < xs.max())
  print(f"e2e skeleton merge check: {checked} tube components across x = "
        f"{shape[0] // 2} ({len(crossing)} labels) each one connected skeleton, "
        f"{spanning} with vertices on both sides", flush=True)
  if checked < SKEL_MIN_CROSSING:
    fail(f"skeleton: only {checked} boundary-crossing tubes were checked")
  skeleton_card_against_cpu(tasks[0], path, SKEL_SAMPLE, ce, edt_ops, torch, dev)
  return launches


# ---------------------------------------------------------------------------
# morphology and the voxel-count census (phase 8)

# (x, y, z): two mesh tasks of 224x448x112; half the depth, seeds and specks
# of the layer it had before the storage phase 12, so that the run fits its
# limit
HOLLOW_SHAPE = (448, 448, 112)
HOLLOW_TASK = (224, 448, 112)
HOLLOW_SEEDS = 75
HOLLOW_SPECKS = 200  # a quarter of them across x = 224
HOLLOW_DUST = 100  # the forge's dust threshold, applied to the census counts
HOLLOW_CENSUS_TASK = (224, 224, 112)
HOLLOW_SAMPLE = 32  # labels of the first task held card against CPU, + its largest
X6_REPLACES = "igneous_tpu/ops/morphology.py:19"  # _dilate_kernel (XLA)


def hollow_cells(shape, n_seeds: int, n_specks: int, seed: int, torch, dev) -> np.ndarray:
  """(x, y, z) uint64 Fortran-ordered: ``voronoi_segmentation`` of
  ``n_seeds`` seeds (ids above 2^32, eight at or above 2^63, 6-connected
  boundaries zeroed) with a background ball of radius 3-8 voxels at every
  seed, an enclosed cavity where the ball lies inside its cell; every
  third ball joined to its cell's boundary (or the volume's face) by a
  straight one-voxel channel along +x, which fill_holes levels 1-2 leave
  open and level 3 closes. Then ``n_specks`` specks with ids of their own
  (2^34 + k): three quarters boxes of 2-4 voxels a side (8-64 voxels)
  anywhere, a quarter boxes of 4-8 x 3-6 x 3-6 voxels (36-288) across
  x = X / 2, some of which reach the dust threshold only in the whole
  layer."""
  X, Y, Z = shape
  seeds = np.random.default_rng(seed).random((n_seeds, 3)) * np.array([X, Y, Z])
  out = voronoi_segmentation(shape, n_seeds, np.random.default_rng(seed), torch, dev)
  out = np.asfortranarray(out)
  rng = np.random.default_rng(seed + 1)
  for i, c in enumerate(np.floor(seeds).astype(np.int64)):
    r = float(rng.uniform(3, 8))
    lo = np.maximum(c - int(np.ceil(r)), 0)
    hi = np.minimum(c + int(np.ceil(r)) + 1, [X, Y, Z])
    grid = np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)], indexing="ij")
    ball = sum((g - ci) ** 2 for g, ci in zip(grid, c)) <= r * r
    out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]][ball] = 0
    if i % 3 == 0:
      row = out[:, c[1], c[2]]
      beyond = np.flatnonzero(row[c[0] + int(np.ceil(r)) + 1:] == 0)
      end = c[0] + int(np.ceil(r)) + 1 + int(beyond[0]) if len(beyond) else X
      out[c[0]:end, c[1], c[2]] = 0
  for k in range(n_specks):
    if k % 4 == 0:
      dx = int(rng.integers(4, 9))
      x0 = X // 2 - int(rng.integers(1, dx))
      dims = (dx, int(rng.integers(3, 7)), int(rng.integers(3, 7)))
      lo = (x0, int(rng.integers(0, Y - dims[1])), int(rng.integers(0, Z - dims[2])))
    else:
      dims = tuple(int(v) for v in rng.integers(2, 5, 3))
      lo = tuple(int(rng.integers(0, n - d)) for n, d in zip((X, Y, Z), dims))
    out[lo[0]:lo[0] + dims[0], lo[1]:lo[1] + dims[1], lo[2]:lo[2] + dims[2]] = 2**34 + k
  return out


def morphology_phase(root, cp, cc, ce, torch, dev):
  """Phase 8 on a "hollow cells" layer (``hollow_cells``): ``dilate`` and
  ``erode`` of the first mesh task's cutout on the card and on the CPU
  route, bit for bit, and X6 (``dilate_step``) timed against its bound;
  the census (``create_voxel_counting_tasks`` at 224x224x112 on a
  ``LocalTaskQueue``, then ``accumulate_voxel_counts``), its totals equal
  to numpy's over the whole layer; the mesh forge of two 224x448x112
  tasks with ``fill_holes=3``, ``dust_threshold=100`` and
  ``dust_global``: the meshed labels exactly those whose census count is
  100 or more, the first task's labels (32 and its largest) card against
  CPU and against the written fragments, the level-3 fill count above 0;
  no pooling, CCL or EDT kernel launched. Returns X6's record."""
  from igneous_tpu_torch import Bbox, CloudFiles, Volume, set_device, telemetry
  from igneous_tpu_torch.ops import morphology
  from igneous_tpu_torch.ops.mesh import unique_on_device
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import (
    accumulate_voxel_counts,
    create_meshing_tasks,
    create_voxel_counting_tasks,
  )

  t_phase = time.perf_counter()
  for counts in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES):
    for key in counts:
      counts[key] = 0
  t0 = time.perf_counter()
  data = hollow_cells(HOLLOW_SHAPE, HOLLOW_SEEDS, HOLLOW_SPECKS, 2, torch, dev)
  path = f"file://{root}/hollow_cells"
  Volume.from_numpy(data, path, resolution=(8, 8, 40), chunk_size=(64, 64, 64),
                    compress=None, layer_type="segmentation")
  uniq, counts = np.unique(data, return_counts=True)
  half = HOLLOW_SHAPE[0] // 2
  left, right = (
    {int(l): int(c) for l, c in zip(*np.unique(part, return_counts=True))}
    for part in (data[: half + 1], data[half:])
  )
  big = {int(l) for l, c in zip(uniq, counts) if l and c >= HOLLOW_DUST}
  rescued = [int(l) for l in big if max(left.get(l, 0), right.get(l, 0)) < HOLLOW_DUST]
  print(f"ingest hollow_cells: {HOLLOW_SHAPE} uint64, {len(uniq) - 1} labels, {len(big)} "
        f"of {HOLLOW_DUST}+ voxels, {len(rescued)} of them below it in each task "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  if not rescued:
    fail("morphology: no label reaches the dust threshold only across the task boundary")

  # dilate and erode of the first task's cutout: the card against the CPU route
  img = Volume(path).download(Bbox((0, 0, 0), (half + 1,) + HOLLOW_SHAPE[1:]))[..., 0]
  t0 = time.perf_counter()
  grown, shrunk = morphology.dilate(img), morphology.erode(img)
  card_s = time.perf_counter() - t0
  _, fills3 = morphology.fill_holes(img, return_fill_count=True, level=3)
  _, fills1 = morphology.fill_holes(img, return_fill_count=True, level=1)
  set_device("cpu")
  try:
    t0 = time.perf_counter()
    cpu_grown, cpu_shrunk = morphology.dilate(img), morphology.erode(img)
    cpu_s = time.perf_counter() - t0
  finally:
    set_device(dev)
  if not (np.array_equal(grown, cpu_grown) and np.array_equal(shrunk, cpu_shrunk)):
    fail("morphology: dilate or erode on the card differs from the CPU route")
  n1, n3 = sum(fills1.values()), sum(fills3.values())
  print(f"morphology: dilate and erode of the {img.shape} cutout equal on the card "
        f"({card_s:.3f} s with copies) and the CPU route ({cpu_s:.3f} s); fill_holes "
        f"level 1 fills {n1} voxels of {len(fills1)} labels, level 3 {n3} of "
        f"{len(fills3)}", flush=True)
  if not n3 > n1 > 0:
    fail(f"morphology: fill counts level 1 {n1}, level 3 {n3}")
  del grown, shrunk, cpu_grown, cpu_shrunk

  # X6: one dilation step of the cutout's dense labels on the card
  _, inverse = unique_on_device(img, dev, return_inverse=True)
  x = inverse.to(torch.int32)
  del inverse
  nbytes = 2 * x.numel() * x.element_size()
  x6 = {
    "name": "X6 dilate_step", "replaces": X6_REPLACES,
    "case": f"task 0's cutout {img.shape} (x, y, z), int32 dense ids",
    "launches_per_task": 1, "ms": cuda_ms(lambda: morphology.dilate_step(x), reps=10),
    "device_ms": profiled_device_ms(lambda: morphology.dilate_step(x), torch),
    "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes", "library_ms": None,
  }
  del x, img
  torch.cuda.empty_cache()

  # the census
  telemetry.reset_all()
  t0 = time.perf_counter()
  tasks = list(create_voxel_counting_tasks(path, shape=HOLLOW_CENSUS_TASK))
  LocalTaskQueue(parallel=1).insert(tasks)
  totals = accumulate_voxel_counts(path)
  wall = time.perf_counter() - t0
  snap = telemetry.snapshot()
  if totals != {int(l): int(c) for l, c in zip(uniq, counts)}:
    fail("census: the totals differ from numpy's unique counts of the layer")
  print(f"census: {len(tasks)} tasks of {HOLLOW_CENSUS_TASK}, wall {wall:.3f} s, "
        f"{len(totals)} labels equal to numpy's counts, stages (s) "
        f"{json.dumps(stage_split(snap))}", flush=True)

  # the mesh forge with fill_holes=3 and dust_global
  tasks = list(create_meshing_tasks(
    path, shape=HOLLOW_TASK, fill_holes=3, dust_threshold=HOLLOW_DUST, dust_global=True,
    parallel=MESH_SIMPLIFY_THREADS))
  if len(tasks) != 2:
    fail(f"morphology mesh: expected 2 tasks, planned {len(tasks)}")
  queue = LocalTaskQueue(parallel=1)
  for i, task in enumerate(tasks):
    telemetry.reset_all()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    queue.insert([task])
    wall = time.perf_counter() - t0
    c = telemetry.counters_snapshot()
    print(f"morphology mesh task {i}: wall {wall:.3f} s, {c.get('mesh.labels', 0)} labels, "
          f"{c.get('mesh.faces', 0)} faces, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, stages (s) "
          f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  mdir = Volume(path).info["mesh"]
  names = [k.split("/")[-1] for k in CloudFiles(path).list(f"{mdir}/")]
  meshed = {int(n.split(":")[0]) for n in names if n.count(":") == 2}
  if meshed != big:
    fail(f"morphology mesh: {len(meshed)} labels meshed, {len(big)} of {HOLLOW_DUST}+ "
         f"voxels in the census ({len(meshed - big)} extra, {len(big - meshed)} missing)")
  print(f"morphology mesh: the {len(meshed)} meshed labels are those of {HOLLOW_DUST}+ "
        f"voxels in the census, {len(rescued)} of them below it in each task", flush=True)
  mesh_card_against_cpu(tasks[0], path, HOLLOW_SAMPLE, torch, dev)
  if any(any(c.values()) for c in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES)):
    fail("morphology: a pooling, CCL or EDT kernel launched")
  print(f"morphology: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return x6


# ---------------------------------------------------------------------------
# conv-net inference (phase 9)

# the repo's own inference configuration (bench.py:942-946)
INFER_SPEC = dict(architecture="convnet3d", in_channels=1, out_channels=2,
                  patch_shape=(64, 64, 32), overlap=(16, 16, 8), hidden=(8,))
# of phase 3's image; half the width it had before the worker phase
INFER_BOUNDS = ((0, 0, 0), (1024, 512, 64))
INFER_TASKS = 8  # of the default 256x256x64
INFER_PATCHES = 108  # a task's 288x288x80 halo'd cutout: 6 x 6 x 3 patches
INFER_BATCH = 4
# tasks of the reruns held against the first campaign (IGNEOUS_PIPELINE=off
# and batch 7) and of the identity model's campaigns (card and CPU route):
# half of them since phase 13 and a quarter since phase 16, to make room
# for them in the time limit
INFER_RERUN_TASKS = 2
# card against the CPU route: |a - b| <= RTOL |b| + ATOL max|b| (the two
# sum 27 float32 products a channel in different orders)
INFER_RTOL = INFER_ATOL = 1e-5
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
X7_REPLACES = "igneous_tpu/infer/registry.py:105"  # _convnet3d (XLA)


def dir_files(path: str, sub: str) -> dict:
  """{name: stored bytes} of the files directly under ``sub`` of a
  file:// layer."""
  import os

  base = os.path.join(path[len("file://"):], sub)
  return {n: open(os.path.join(base, n), "rb").read() for n in sorted(os.listdir(base))
          if os.path.isfile(os.path.join(base, n))}


def layer_files(path: str) -> dict:
  """{name: bytes} of a layer's chunk files at mip 0 (``path`` file://)."""
  import os

  info = json.load(open(os.path.join(path[len("file://"):], "info")))
  return dir_files(path, info["scales"][0]["key"])


def inference_phase(root, cp, cc, ce, torch, dev):
  """Phase 9 on phase 3's image (bounds 1024x512x64): the repo's
  inference model (``INFER_SPEC``, ``init_params(seed=0)``) through
  ``create_inference_tasks`` -> ``LocalTaskQueue`` -> ``InferenceTask``,
  8 tasks of 108 patches at batch 4: pipelined with postprocess none,
  the same with ``IGNEOUS_PIPELINE=off`` and with batch 7 (both byte for
  byte the first), argmax (equal to the argmax of the first's floats);
  the identity model on the card and on the CPU route (4 tasks each),
  byte for byte, and equal to the image; the first task's halo'd cutout on the card and on
  the CPU route within the stated tolerance, argmax mismatches only at
  margins within it; X7 (one dispatch) against its bound and cuDNN's
  batched call; the card's busy share over one task from a profiler
  trace. No hand kernel launches. Returns X7's record."""
  import os

  from igneous_tpu_torch import Bbox, Volume, set_device, telemetry
  from igneous_tpu_torch.infer import ModelSpec, infer_cutout, init_params, load_model, save_model
  from igneous_tpu_torch.infer.engine import _to_device_layout
  from igneous_tpu_torch.infer.registry import conv_flags
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_inference_tasks
  from torch.profiler import ProfilerActivity, profile

  t_phase = time.perf_counter()
  src = f"file://{root}/image"
  spec = ModelSpec(**INFER_SPEC)
  model_path, ident_path = f"file://{root}/model", f"file://{root}/model_identity"
  save_model(model_path, spec, init_params(spec, seed=0))
  save_model(ident_path, ModelSpec("identity", 1, 1, spec.patch_shape, spec.overlap), {})
  bounds = Bbox(*INFER_BOUNDS)

  def campaign(name, model, env=(), batch_size=INFER_BATCH, ntasks=INFER_TASKS, **kw):
    dest = f"file://{root}/infer_{name}"
    tasks = list(create_inference_tasks(src, dest, model, bounds=bounds,
                                        batch_size=batch_size, **kw))
    if len(tasks) != INFER_TASKS:
      fail(f"infer {name}: planned {len(tasks)} tasks, expected {INFER_TASKS}")
    tasks = tasks[:ntasks]
    for counts in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES):
      for key in counts:
        counts[key] = 0
    telemetry.reset_all()
    torch.cuda.reset_peak_memory_stats(dev)
    os.environ.update(dict(env))
    queue = LocalTaskQueue(parallel=1)
    ledger_reset(torch, dev)
    t0 = time.perf_counter()
    try:
      queue.insert(tasks)
    finally:
      for k, _ in env:
        os.environ.pop(k, None)
    wall = time.perf_counter() - t0
    ledger_line(f"infer {name}", wall, launch_counts(cp, cc, ce))
    counters = telemetry.counters_snapshot()
    dispatches = -(-INFER_PATCHES // batch_size)
    want = {"infer.patches": ntasks * INFER_PATCHES,
            "infer.dispatches": ntasks * dispatches,
            "infer.padded_slots": ntasks * (dispatches * batch_size - INFER_PATCHES)}
    got = {k: counters.get(k, 0) for k in want}
    print(f"infer {name}: {len(tasks)} tasks, batch {batch_size}, wall {wall:.3f} s, "
          f"{json.dumps(got)}, runner {json.dumps(queue.pipeline_stats)}, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
          f"{pipeline_line(telemetry.snapshot(), telemetry.gauges_snapshot(), counters)}", flush=True)
    if got != want:
      fail(f"infer {name}: counted {got}, expected {want}")
    if queue.completed != ntasks:
      fail(f"infer {name}: {queue.completed} of {ntasks} tasks completed")
    if any(any(c.values()) for c in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES)):
      fail(f"infer {name}: a pooling, CCL or EDT kernel launched")
    return dest, tasks

  first, tasks = campaign("none", model_path)
  ref_files = layer_files(first)
  for name, kw in (("none_serial", {"env": (("IGNEOUS_PIPELINE", "off"),)}),
                   ("none_batch7", {"batch_size": 7})):
    kw["ntasks"] = INFER_RERUN_TASKS
    dest, _ = campaign(name, model_path, **kw)
    files = layer_files(dest)
    if len(files) * INFER_TASKS != len(ref_files) * INFER_RERUN_TASKS or any(
      ref_files.get(n) != data for n, data in files.items()
    ):
      fail(f"infer {name}: the files differ from the pipelined batch-4 run's")
    print(f"infer {name}: {len(files)} chunk files byte for byte the pipelined "
          f"batch-4 run's", flush=True)
  out = Volume(first)
  floats = out.download(bounds)
  want = tuple(int(v) for v in bounds.size3()) + (spec.out_channels,)
  if floats.dtype != np.float32 or floats.shape != want or not np.isfinite(floats).all():
    fail(f"infer: output {floats.dtype} {floats.shape}, finite {np.isfinite(floats).all()}")
  dest, _ = campaign("argmax", model_path, postprocess="argmax")
  labels = Volume(dest).download(bounds)[..., 0]
  if not np.array_equal(labels, np.argmax(floats, axis=3).astype(np.uint8)):
    fail("infer argmax: differs from the argmax of the float run on the card")

  # the identity model: the engine alone, the card against the CPU route
  ident, ran = campaign("identity", ident_path, ntasks=INFER_RERUN_TASKS)
  set_device("cpu")
  try:
    ident_cpu, _ = campaign("identity_cpu", ident_path, ntasks=INFER_RERUN_TASKS)
  finally:
    set_device(dev)
  if layer_files(ident) != layer_files(ident_cpu):
    fail("infer identity: the card's files differ from the CPU route's")
  box = Bbox(np.min([t.offset for t in ran], axis=0),
             np.max([t.offset + t.shape for t in ran], axis=0))
  img = Volume(src).download(box)[..., :1].astype(np.float32)
  got = Volume(ident).download(box)
  if not np.allclose(got, img, rtol=1e-6, atol=1e-3):
    fail("infer identity: the blend does not give the image back")
  print("infer identity: card and CPU route byte for byte, equal to the image within "
        "the blend's rounding", flush=True)

  # the first task: card against the CPU route, within the tolerance
  task = tasks[0]
  halo = np.asarray(task.halo)
  core = Bbox(task.offset, task.offset + task.shape)
  cut = Volume(src, bounded=False).download(Bbox(core.minpt - halo, core.maxpt + halo))
  model = load_model(model_path)
  card, _ = infer_cutout(model, cut, INFER_BATCH)
  set_device("cpu")
  try:
    t0 = time.perf_counter()
    cpu, _ = infer_cutout(model, cut, INFER_BATCH)
    cpu_s = time.perf_counter() - t0
  finally:
    set_device(dev)
  err = np.abs(card - cpu)
  limit = INFER_RTOL * np.abs(cpu) + INFER_ATOL * float(np.abs(cpu).max())
  if not (err <= limit).all():
    fail(f"infer: the card's task 0 differs from the CPU route's by {float(err.max())}")
  hx, hy, hz = (int(v) for v in halo)
  sx, sy, sz = (int(v) for v in task.shape)
  core_cpu = cpu[hx:hx + sx, hy:hy + sy, hz:hz + sz]
  margin = np.abs(core_cpu[..., 0] - core_cpu[..., 1])
  differ = labels[:sx, :sy, :sz] != np.argmax(core_cpu, axis=3)
  tol = INFER_RTOL * np.abs(core_cpu).max(axis=3) + INFER_ATOL * float(np.abs(cpu).max())
  if (differ & (margin > 2 * tol)).any():
    fail("infer argmax: the card and the CPU route disagree at a margin above the tolerance")
  print(f"infer task 0: card and CPU route ({cpu_s:.3f} s) within rtol {INFER_RTOL}, atol "
        f"{INFER_ATOL} x max|out| (max err {float(err.max()):.3e} of max|out| "
        f"{float(np.abs(cpu).max()):.3f}); argmax differs at {int(differ.sum())} voxels, "
        f"all at margins within it", flush=True)

  # X7: one dispatch of the campaign against its bound and cuDNN's batched call
  consts = model.device_params()
  p = spec.patch_shape
  batch = torch.from_numpy(np.stack([
    _to_device_layout(cut[x:x + p[0], 0:p[1], 0:p[2]].astype(np.float32))
    for x in (0, 48, 96, 144)])).to(dev)
  widths = (spec.in_channels,) + tuple(spec.hidden) + (spec.out_channels,)
  voxels = batch.shape[0] * int(np.prod(p))
  nbytes = 4 * voxels * sum(widths)
  flops = 2 * 27 * voxels * sum(a * b for a, b in zip(widths[:-1], widths[1:]))
  bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS

  def batched():
    with torch.inference_mode(), conv_flags():
      return torch.func.functional_call(model.module, consts, (batch,))

  run = lambda: model.apply(consts, batch)  # noqa: E731
  if not torch.equal(run(), run()):
    fail("X7: two runs of one dispatch differ")
  x7 = {
    "name": "X7 convnet3d", "replaces": X7_REPLACES,
    "case": f"one dispatch: {batch.shape[0]} patches {tuple(batch.shape[1:])}, "
            f"widths {widths}, float32, TF32 off",
    "launches_per_task": -(-INFER_PATCHES // INFER_BATCH),
    "ms": cuda_ms(run, reps=20), "device_ms": profiled_device_ms(run, torch),
    "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    "library_ms": cuda_ms(batched, reps=20),
  }
  del batch
  torch.cuda.empty_cache()

  # the card's busy share over one task
  one = list(create_inference_tasks(src, f"file://{root}/infer_traced", model_path,
                                    bounds=Bbox((0, 0, 0), (256, 256, 64))))
  telemetry.reset_all()
  for counts in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES):
    for key in counts:
      counts[key] = 0
  ledger_reset(torch, dev)
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    LocalTaskQueue(parallel=1).insert(one)
    wall = time.perf_counter() - t0
  snap = ledger_line("infer traced task", wall, launch_counts(cp, cc, ce))
  ledger_against_profiler("infer traced task", snap, prof, wall, launch_counts(cp, cc, ce))
  busy = traced_device_us(prof) / 1e6
  if not busy > 0:
    fail("infer: the trace shows no work on the card")
  print(f"infer traced task: wall {wall:.3f} s, card busy {busy:.4f} s (traced; idle "
        f"{100 * (1 - busy / wall):.2f}%), stages (s) "
        f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  print(f"infer: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return x7


# ---------------------------------------------------------------------------
# batched and paged execution

# (layer of phase 3, cutout shape, batch size, mips the chunk guard allows,
# through the command line); the second run is `image downsample --batched`
# at the command line's defaults
BATCHED_RUNS = [
  ("image", (1024, 1024, 64), 8, 3, False),
  ("image", (256, 256, 64), 8, 1, True),
  ("segmentation", (512, 512, 64), 8, 2, False),
  ("ragged_image", (256, 256, 64), 8, 2, False),
]
PAGE = 32  # the default page edge (IGNEOUS_PAGE_SHAPE) and pages a round
X5_REPLACES = "igneous_tpu/parallel/paged.py:163"  # _make_page_kernel (XLA)


def link_layer(src: str, dst: str, every_scale: bool = False) -> None:
  """A new layer at ``dst``: ``src``'s mip-0 chunk files hard-linked (the
  batched runs only read them) and its info cut to mip 0, or with
  ``every_scale`` kept whole (the served layers of phase 19, whose other
  mips are absent)."""
  import os

  info = json.load(open(os.path.join(src, "info")))
  if not every_scale:
    info["scales"] = info["scales"][:1]
  key = info["scales"][0]["key"]
  os.makedirs(os.path.join(dst, key))
  for name in os.listdir(os.path.join(src, key)):
    os.link(os.path.join(src, key, name), os.path.join(dst, key, name))
  with open(os.path.join(dst, "info"), "w") as f:
    json.dump(info, f)


def same_files(a: str, b: str, keep=lambda name: True) -> int:
  """Fails unless directories ``a`` and ``b`` hold the same files (of the
  names ``keep`` accepts) with the same bytes; returns how many."""
  import os

  names = sorted(filter(keep, os.listdir(a)))
  other = sorted(filter(keep, os.listdir(b)))
  if names != other:
    fail(f"{a} and {b} hold other files ({len(names)} against {len(other)})")
  for n in names:
    with open(os.path.join(a, n), "rb") as fa, open(os.path.join(b, n), "rb") as fb:
      if fa.read() != fb.read():
        fail(f"{a}/{n} differs from {b}/{n}")
  return len(names)


def grid_counts(size, shape):
  """(full cutouts, edge cutouts, pages of the edge cutouts) of a layer's
  grid at cutout ``shape`` (x, y, z), with PAGE^3 pages."""
  full = edge = pages = 0
  for x in range(0, size[0], shape[0]):
    for y in range(0, size[1], shape[1]):
      for z in range(0, size[2], shape[2]):
        ext = [min(s, n - o) for s, n, o in zip(shape, size, (x, y, z))]
        if ext == list(shape):
          full += 1
        else:
          edge += 1
          pages += int(np.prod([-(-e // PAGE) for e in ext]))
  return full, edge, pages


def stage_split(snap) -> dict:
  return {k: round(v["seconds"], 4) for k, v in snap.items()}


def batched_downsample_phase(root, cp, torch, dev):
  """Phase 3's layers again through ``batched_downsample`` (and once
  through ``image downsample --batched``) into new layers that share their
  mip 0: per run its wall, dispatches, launches and stage split; a
  profiler trace of the first run for the card's busy share; every
  produced chunk and the scales of the info equal to phase 3's solo
  output."""
  import contextlib
  import io
  import os
  import re

  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.cli import main as cli_main
  from igneous_tpu_torch.parallel.batch_runner import batched_downsample
  from torch.profiler import ProfilerActivity, profile

  for i, (name, shape, batch, mips, via_cli) in enumerate(BATCHED_RUNS):
    src, dst = os.path.join(root, name), os.path.join(root, f"{name}_batched{i}")
    link_layer(src, dst)
    size = [int(v) for v in Volume(f"file://{src}").meta.volume_size(0)]
    full, edge, pages = grid_counts(size, shape)
    rounds = -(-pages // PAGE)
    full_dispatches = -(-full // batch)
    telemetry.reset_all()
    before = dict(cp.LAUNCHES)
    prof = profile(activities=[ProfilerActivity.CUDA]) if i == 0 else contextlib.nullcontext()
    with prof:
      t0 = time.perf_counter()
      if via_cli:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
          rc = cli_main(["image", "downsample", f"file://{dst}", "--batched"])
        m = re.fullmatch(r"batched: (\d+) cutouts in (\d+) dispatches, (\d+) edge "
                         r"cutouts via the task path\n", out.getvalue())
        if rc != 0 or m is None:
          fail(f"batched {name}: the command line said {out.getvalue()!r} (rc {rc})")
        stats = {"batched_cutouts": int(m[1]), "dispatches": int(m[2]),
                 "edge_cutouts": int(m[3]), "paged_cutouts": edge}
        summary = out.getvalue().strip()
      else:
        stats = batched_downsample(f"file://{dst}", num_mips=5, shape=shape, batch_size=batch)
        summary = json.dumps(stats)
      wall = time.perf_counter() - t0
    launched = {k: cp.LAUNCHES[k] - before[k] for k in cp.LAUNCHES}
    busy = ""
    if i == 0:
      us = traced_device_us(prof)
      if not us > 0:
        fail(f"batched {name}: the trace shows no work on the card")
      busy = f", card busy {us / 1e6:.4f} s (traced; idle {100 * (1 - us / 1e6 / wall):.2f}%)"
    print(f"batched {name} at {shape[0]}x{shape[1]}x{shape[2]}, batch {batch}: wall "
          f"{wall:.3f} s, {summary}, launches {json.dumps(launched)}{busy}, stages (s) "
          f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
    want = {"batched_cutouts": full, "edge_cutouts": 0, "paged_cutouts": edge,
            "dispatches": full_dispatches + rounds}
    if any(stats[k] != v for k, v in want.items()):
      fail(f"batched {name}: stats {stats}, expected {want}")
    if launched["pyramid2x2x1"] != full_dispatches:
      fail(f"batched {name}: pyramid2x2x1 launched {launched['pyramid2x2x1']} times "
           f"for {full_dispatches} full-cutout dispatches")
    if launched["pool2x2x1"] != rounds * mips:
      fail(f"batched {name}: pool2x2x1 launched {launched['pool2x2x1']} times for "
           f"{rounds} page rounds of {mips} levels")
    solo, got = Volume(f"file://{src}").info, Volume(f"file://{dst}").info
    if got["scales"] != solo["scales"][: mips + 1]:
      fail(f"batched {name}: the info's scales differ from the solo run's")
    n = sum(same_files(os.path.join(src, s["key"]), os.path.join(dst, s["key"]))
            for s in got["scales"][1:])
    print(f"batched {name}: {n} chunk files of mips 1-{mips} equal to phase 3's solo "
          f"output byte for byte", flush=True)


# ---------------------------------------------------------------------------
# the staged pipeline and the passthrough transfer

# (layer of phase 3, memory_target, tasks, task shape, mips the chunk guard
# allows): the grid of phase 3c's first batched run, and of its
# segmentation run
PIPELINED_RUNS = [
  ("image", 2**27, 16, (1024, 1024, 64), 3),
  ("segmentation", 2**28, 16, (512, 512, 64), 2),
]
# tasks of each stream the serial loop runs: half of them since phase 13,
# a quarter since phase 15 and an eighth since phase 17, to make room for
# them in the time limit (the pipelined runs keep all 16)
SERIAL_TASKS = 2
# (source layer, compress): phase 3b's cseg layer (gzip chunks) and phase
# 3's image, whose mip 0 is stored uncompressed
PASSTHROUGH_RUNS = [("segmentation_cseg", "gzip"), ("image", None)]


def pipeline_line(snap: dict, gauges: dict, counters: dict) -> str:
  """The stage split of a stream: thread-seconds of the pools' stages, the
  caller's waits, the prefetch buffer's stalls and high-water bytes, the
  chunk cache's hits and misses."""
  waits = {k: round(snap[k]["seconds"], 4) for k in (
    "pipeline.download_wait_s", "pipeline.upload_join_s",
    "pipeline.prefetch.producer_stall_s") if k in snap}
  stages = {k: round(v["seconds"], 4) for k, v in snap.items()
            if not k.startswith("pipeline.")}
  cache = {k: counters.get(f"chunk_cache.{k}", 0) for k in ("hits", "misses", "evicted")}
  high = int(gauges.get("pipeline.prefetch.bytes", 0))
  return (f"stages (thread-s) {json.dumps(stages)}, caller waits (s) {json.dumps(waits)}, "
          f"prefetch high-water {high} bytes, chunk cache {json.dumps(cache)}")


def pipelined_phase(root, cp, cc, ce, torch, dev):
  """Phase 3's image and segmentation as 16-task streams through
  ``create_downsampling_tasks`` -> ``LocalTaskQueue`` into new layers that
  share phase 3's mip 0, once with ``IGNEOUS_PIPELINE=off`` (the serial
  loop) and once at the default (the staged pipeline): per run its wall,
  stage split, the caller's waits, the prefetch buffer's stalls and
  high-water bytes and the chunk cache's counts; pyramid2x2x1 once a task
  (counts set to 0 just before each run); the runner's stats; every chunk
  and the info's scales equal to phase 3's solo output. Then the
  passthrough: phase 3b's cseg layer and phase 3's image copied with
  ``skip_downsamples`` into new layers of the same chunking and encoding,
  every chunk file byte for byte the source's, every chunk moved
  verbatim and no kernel launched; then the same copies down the decode
  route (``IGNEOUS_TRANSFER_PASSTHROUGH=off``; the cseg layer's once more
  with ``IGNEOUS_CHUNK_CACHE=off``), with the same bytes. Returns the
  pooling kernels' launches in the pipelined runs and each run's wall."""
  import os

  from igneous_tpu_torch import Volume, chunk_cache, telemetry
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_downsampling_tasks, create_transfer_tasks

  t_phase = time.perf_counter()
  pipelined = {k: 0 for k in cp.LAUNCHES}
  walls = {}
  for name, target, ntasks, shape, mips in PIPELINED_RUNS:
    src = os.path.join(root, name)
    for mode in ("serial", "pipelined"):
      dst = os.path.join(root, f"{name}_{mode}")
      link_layer(src, dst)
      tasks = list(create_downsampling_tasks(f"file://{dst}", mip=0, num_mips=mips,
                                             memory_target=target))
      if len(tasks) != ntasks or [int(v) for v in tasks[0].shape] != list(shape):
        fail(f"pipelined {name}: planned {len(tasks)} tasks of {tasks[0].shape}")
      if mode == "serial":
        os.environ["IGNEOUS_PIPELINE"] = "off"
        tasks = tasks[:SERIAL_TASKS]
      nrun = len(tasks)
      telemetry.reset_all()
      chunk_cache.clear()
      for key in cp.LAUNCHES:
        cp.LAUNCHES[key] = 0
      queue = LocalTaskQueue(parallel=1)
      ledger_reset(torch, dev)
      t0 = time.perf_counter()
      try:
        queue.insert(tasks)
      finally:
        os.environ.pop("IGNEOUS_PIPELINE", None)
      wall = time.perf_counter() - t0
      launched = dict(cp.LAUNCHES)
      ledger_line(f"pipelined {name} {mode}", wall, launched)
      walls[(name, mode)] = wall
      print(f"pipelined {name} {mode}: {nrun} tasks of {shape[0]}x{shape[1]}x{shape[2]}, "
            f"{mips} mips, wall {wall:.3f} s, stats {json.dumps(queue.pipeline_stats)}, "
            f"launches {json.dumps(launched)}, "
            f"{pipeline_line(telemetry.snapshot(), telemetry.gauges_snapshot(), telemetry.counters_snapshot())}",
            flush=True)
      if queue.completed != nrun:
        fail(f"pipelined {name} {mode}: {queue.completed} of {nrun} tasks completed")
      if launched["pyramid2x2x1"] != nrun or launched["pool2x2x1"] != 0:
        fail(f"pipelined {name} {mode}: launches {launched}, expected pyramid2x2x1 "
             f"once for each of {nrun} tasks")
      if mode == "pipelined":
        want = {"executed": ntasks, "staged": ntasks, "solo": 0, "failed": 0,
                "drained": False}
        if queue.pipeline_stats != want:
          fail(f"pipelined {name}: runner stats {queue.pipeline_stats}, expected {want}")
        for key, n in launched.items():
          pipelined[key] += n
      solo, got = Volume(f"file://{src}").info, Volume(f"file://{dst}").info
      if got["scales"] != solo["scales"][: mips + 1]:
        fail(f"pipelined {name} {mode}: the info's scales differ from phase 3's")
      n = mip_files_equal(src, dst, mips, complete=nrun == ntasks)
      print(f"pipelined {name} {mode}: {n} chunk files of mips 1-{mips} equal to phase "
            f"3's solo output byte for byte", flush=True)
    print(f"pipelined {name}: serial {walls[(name, 'serial')]:.3f} s ({SERIAL_TASKS} tasks), "
          f"pipelined {walls[(name, 'pipelined')]:.3f} s ({ntasks} tasks)", flush=True)

  for name, compress in PASSTHROUGH_RUNS:
    src = f"file://{root}/{name}"
    key = Volume(src).meta.key(0)
    routes = [("passthrough", {}), ("decode", {"IGNEOUS_TRANSFER_PASSTHROUGH": "off"})]
    if compress is not None:
      routes.append(("decode_nocache", {"IGNEOUS_TRANSFER_PASSTHROUGH": "off",
                                        "IGNEOUS_CHUNK_CACHE": "off"}))
    for route, env in routes:
      dest = f"{root}/{name}_{route}"
      tasks = list(create_transfer_tasks(src, f"file://{dest}", skip_downsamples=True,
                                         compress=compress))
      os.environ.update(env)
      telemetry.reset_all()
      chunk_cache.clear()
      for counts in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES):
        for k in counts:
          counts[k] = 0
      queue = LocalTaskQueue(parallel=1)
      t0 = time.perf_counter()
      try:
        queue.insert(tasks)
      finally:
        for k in env:
          os.environ.pop(k, None)
      wall = time.perf_counter() - t0
      counters = telemetry.counters_snapshot()
      moved = {k: counters.get(f"transfer.passthrough.{k}", 0)
               for k in ("chunks", "verbatim", "recompressed", "bytes")}
      n = same_files(os.path.join(root, name, key), os.path.join(dest, key))
      print(f"passthrough {name} {route}: {len(tasks)} tasks, wall {wall:.3f} s, "
            f"moved {json.dumps(moved)}, stats {json.dumps(queue.pipeline_stats)}, "
            f"{pipeline_line(telemetry.snapshot(), telemetry.gauges_snapshot(), counters)}; "
            f"{n} chunk files byte for byte the source's", flush=True)
      if any(any(c.values()) for c in (cp.LAUNCHES, cc.LAUNCHES, ce.LAUNCHES)):
        fail(f"passthrough {name} {route}: a kernel launched on a copy with no pyramid")
      want = n if route == "passthrough" else 0
      if moved["verbatim"] != want or moved["chunks"] != want:
        fail(f"passthrough {name} {route}: moved {moved}, expected {want} chunks verbatim")
  print(f"pipelined: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return pipelined, walls


def page_kernel_program(root, cp, torch, dev):
  """X5, the page kernel (``parallel.paged.page_pyramid``: three
  clamp-gathers and one ``pool2x2x1`` a level) on the first round of the
  ragged layer's corner cutout (232x232x64 at the ragged run's cutout
  shape, 2 levels): kernel time from
  the profiler, time between CUDA events, the plain version's (the same
  with ``pool2x2x1_plain``), equal outputs, and the bytes bound (pages in
  and out once)."""
  import torch.nn.functional as F

  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.parallel import paged

  vol = Volume(f"file://{root}/ragged_image")
  size = vol.meta.volume_size(0)
  shape = next(r[1] for r in BATCHED_RUNS if r[0] == "ragged_image")
  img = vol.download(Bbox([(s - 1) // c * c for s, c in zip(size, shape)], size))
  t = torch.from_numpy(img.transpose(3, 2, 1, 0)).to(dev)
  Z, Y, X = t.shape[1:]
  padded = F.pad(t, (0, (-X) % PAGE, 0, (-Y) % PAGE, 0, (-Z) % PAGE))
  pages = paged.to_pages(padded, (PAGE,) * 3)[:PAGE]
  exts = []
  for oz in range(0, Z, PAGE):
    for oy in range(0, Y, PAGE):
      for ox in range(0, X, PAGE):
        exts.append((min(PAGE, Z - oz), min(PAGE, Y - oy), min(PAGE, X - ox)))
  ext = torch.tensor(exts[:PAGE], dtype=torch.int64, device=dev)
  factors = ((2, 2, 1), (2, 2, 1))
  fn = lambda: paged.page_pyramid(pages, ext, factors, "average", False)  # noqa: E731
  outs = fn()
  real = cp.pool2x2x1
  cp.pool2x2x1 = cp.pool2x2x1_plain
  try:
    plain = lambda: paged.page_pyramid(pages, ext, factors, "average", False)  # noqa: E731
    refs = plain()
    plain_ms = cuda_ms(plain, reps=20)
  finally:
    cp.pool2x2x1 = real
  err = max_abs_err(outs, refs)
  if err > TOLERANCE:
    fail(f"X5 page kernel: differs from its plain version (max abs err {err})")
  nbytes = pages.numel() + sum(o.numel() for o in outs)
  return {
    "name": "X5 page_pyramid", "replaces": X5_REPLACES,
    "case": f"{PAGE} pages of the ragged layer's corner cutout, uint8 average, 2 levels",
    "launches_per_round": {"pool2x2x1": len(factors)},
    "ms": cuda_ms(fn, reps=20), "device_ms": profiled_device_ms(fn, torch),
    "plain_ms": plain_ms, "max_abs_err": err,
    "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
  }


def batched_ccl_phase(root, cc, torch, dev):
  """``batched_ccl_faces`` (``paged_ccl`` in rounds of 32 pages) over phase
  4's segmentation layer, against the task path's pass 1
  (``create_ccl_face_tasks``): its wall and the task path's, dispatches,
  ``tile_resolve`` launches (once per page round), stage split, and every
  face file equal byte for byte. Returns tile_resolve's launches."""
  import os
  import shutil

  from igneous_tpu_torch import Volume, telemetry
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.parallel.batch_runner import batched_ccl_faces
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_ccl_face_tasks

  name = "ccl_segmentation"
  src = f"file://{root}/{name}"
  faces = os.path.join(root, name, "ccl", "0", "faces")
  shutil.rmtree(os.path.join(root, name, "ccl"), ignore_errors=True)
  tasks = list(create_ccl_face_tasks(src, shape=CCL_TASK_SHAPE))
  bounds = Volume(src).meta.bounds(0)
  pages = 0
  for t in tasks:
    cut = Bbox.intersection(Bbox(t.offset, t.offset + t.shape + 1), bounds)
    pages += int(np.prod([-(-int(s) // PAGE) for s in cut.size3()]))
  rounds = -(-pages // PAGE)  # one group: every task in one batch of 8
  for key in cc.LAUNCHES:
    cc.LAUNCHES[key] = 0
  telemetry.reset_all()
  t0 = time.perf_counter()
  stats = batched_ccl_faces(src, shape=CCL_TASK_SHAPE)
  wall = time.perf_counter() - t0
  launched = cc.LAUNCHES["tile_resolve"]
  stages = stage_split(telemetry.snapshot())
  batched = os.path.join(root, "faces_batched")
  shutil.move(faces, batched)
  telemetry.reset_all()
  t0 = time.perf_counter()
  LocalTaskQueue(parallel=1).insert(create_ccl_face_tasks(src, shape=CCL_TASK_SHAPE))
  task_wall = time.perf_counter() - t0
  n = same_files(batched, faces)
  print(f"batched ccl {name}: batched_ccl_faces wall {wall:.3f} s ({json.dumps(stats)}, "
        f"{pages} pages in {rounds} rounds, tile_resolve launches {launched}), task path "
        f"pass 1 wall {task_wall:.3f} s; {n} face files equal byte for byte; stages (s) "
        f"batched {json.dumps(stages)}, task path "
        f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  if stats != {"batched_cutouts": len(tasks), "edge_cutouts": 0, "dispatches": 1}:
    fail(f"batched ccl: stats {stats} for {len(tasks)} tasks")
  if launched != rounds:
    fail(f"batched ccl: tile_resolve launched {launched} times for {rounds} page rounds")
  # the task path's faces stay for the worker phase's comparison
  shutil.move(faces, os.path.join(root, "faces_task"))
  shutil.rmtree(os.path.join(root, name, "ccl"))
  return launched


def batched_skeleton_phase(root, ce, edt_ops, torch, dev):
  """``edt_batch`` on phase 6's two skeleton cutouts cut to their common
  shape, and ``paged_edt`` on the whole cutouts (padded to page
  multiples), each bit for bit the solo ``edt``, with walls, launches
  and peak memory (the forge itself runs on phase 15's crop since phase
  16: ``batched_skeleton_forge_phase``). Returns edt_pass's launches."""
  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.parallel.paged import paged_edt
  from igneous_tpu_torch.task_creation import create_skeletonizing_tasks

  path = f"file://{root}/skeleton_segmentation"
  tasks = list(create_skeletonizing_tasks(path, parallel=SKEL_TRACE_THREADS))
  labels = [t.prepare_labels(Volume(path))[0] for t in tasks]
  anis = (8.0, 8.0, 40.0)
  launches = 0
  common = tuple(min(s) for s in zip(*(l.shape for l in labels)))
  crops = np.stack([l[: common[0], : common[1], : common[2]] for l in labels])
  for what, fn, items in (
    ("edt_batch", lambda: edt_ops.edt_batch(crops, anis, black_border=True), crops),
    ("paged_edt", lambda: paged_edt(labels, anis), labels),
  ):
    ce.LAUNCHES["edt_pass"] = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fields = fn()
    wall = time.perf_counter() - t0
    launched = ce.LAUNCHES["edt_pass"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    for lab, field in zip(items, fields):
      if not np.array_equal(field, edt_ops.edt(lab, anis, black_border=True)):
        fail(f"{what}: a field differs from the solo edt of its cutout")
    print(f"batched edt {what}: {len(items)} cutouts {[l.shape for l in items]}, wall "
          f"{wall:.3f} s, edt_pass launches {launched}, peak {peak:.2f} GB, bit for bit "
          f"the solo edt", flush=True)
    if launched != 3:
      fail(f"{what}: edt_pass launched {launched} times, not 3")
    launches += launched
    del fields

  return launches


def batched_skeleton_forge_phase(root, ce, torch, dev):
  """``batched_skeleton_forge`` over phase 15's tube crop (its two tasks of
  FRAGS_SKEL_TASK, sharded) into a second skeleton directory, its .frags
  containers byte for byte phase 15's (c). Returns edt_pass's launches."""
  from igneous_tpu_torch import telemetry
  from igneous_tpu_torch.parallel.batch_runner import batched_skeleton_forge

  path = f"file://{root}/frags_skeletons"
  ce.LAUNCHES["edt_pass"] = 0
  telemetry.reset_all()
  t0 = time.perf_counter()
  stats = batched_skeleton_forge(path, shape=FRAGS_SKEL_TASK, sharded=True,
                                 skel_dir="skeletons_batched", parallel=SKEL_TRACE_THREADS)
  wall = time.perf_counter() - t0
  launched = ce.LAUNCHES["edt_pass"]
  frags = same_files(f"{root}/frags_skeletons/{FRAGS_SKEL_DIR}",
                     f"{root}/frags_skeletons/skeletons_batched",
                     keep=lambda n: n.endswith(".frags"))
  print(f"batched skeleton forge: wall {wall:.3f} s, {json.dumps(stats)}, edt_pass "
        f"launches {launched}, {frags} .frags containers equal to phase 15's byte for byte, "
        f"stages (s) {json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  if stats != {"batched_cutouts": 2, "solo_cutouts": 0, "dispatches": 1} or frags != 2:
    fail(f"batched skeleton forge: stats {stats}, {frags} containers")
  if launched != 3:
    fail(f"batched skeleton forge: edt_pass launched {launched} times, not 3")
  return launched


def entry_phase(cp, torch, dev):
  """The port's ``entry()`` once on the card, equal to the plain pyramid;
  returns pyramid2x2x1's launches (one)."""
  from igneous_tpu_torch.entry import FACTORS, entry
  from igneous_tpu_torch.ops.pooling import _pyramid_impl

  before = cp.LAUNCHES["pyramid2x2x1"]
  fn, (x,) = entry()
  outs = fn(x)
  torch.cuda.synchronize()
  launched = cp.LAUNCHES["pyramid2x2x1"] - before
  refs = _pyramid_impl(torch.from_numpy(x).to(dev), FACTORS, "average", False)
  err = max_abs_err(outs, refs)
  print(f"entry: {len(outs)} mips {[tuple(o.shape) for o in outs]}, pyramid2x2x1 "
        f"launches {launched}, max abs err against the plain pyramid {err}", flush=True)
  if err > TOLERANCE or launched != 1:
    fail(f"entry: max abs err {err}, pyramid2x2x1 launches {launched}")
  return launched


def load_copy(alias: str, path: str):
  """Import another copy of the igneous_tpu_torch package (a directory,
  for example one unpacked from an earlier commit with ``git archive``)
  under the name ``alias``; returns its (_build, cuda_ccl, cuda_pooling,
  cuda_edt, cuda_clahe), cuda_clahe None where the copy has none.
  Its kernels build from its own csrc/ into its own build/."""
  import importlib
  import importlib.util
  import os

  spec = importlib.util.spec_from_file_location(
    alias, os.path.join(path, "__init__.py"), submodule_search_locations=[path]
  )
  if spec is None:
    fail(f"--baseline {alias}={path}: no package there")
  pkg = importlib.util.module_from_spec(spec)
  sys.modules[alias] = pkg
  spec.loader.exec_module(pkg)
  mods = tuple(importlib.import_module(f"{alias}.ops.{m}")
               for m in ("_build", "cuda_ccl", "cuda_pooling", "cuda_edt"))
  has_clahe = os.path.exists(os.path.join(path, "ops", "cuda_clahe.py"))
  return mods + (importlib.import_module(f"{alias}.ops.cuda_clahe") if has_clahe else None,)


# ---------------------------------------------------------------------------
# the device plane (phase 10): the ledger beside the runs above, the library
# store, the tuner

HAND_KERNELS = ("pyramid2x2x1", "pool2x2x1", "tile_resolve", "edt_pass")
# the CUDA functions each hand kernel's launch runs, as the profiler names them
TRACE_NAMES = {"pyramid2x2x1": "pyramid2x2x1_kernel", "pool2x2x1": "pool2x2x1_kernel",
               "tile_resolve": "tile_resolve_kernel", "edt_pass": "edt_"}
# a hand kernel's span time against the profiler's kernel time for the same
# calls: within this share, or this many microseconds a launch if larger
# (each span brackets one launch with two events)
LEDGER_REL_TOL = 0.10
LEDGER_US_PER_LAUNCH = 20.0
SPAN_US = [0.0]  # host microseconds of one span, measured before the e2e phases
LIBRARIES = ("pooling", "ccl", "edt", "simplify", "dijkstra", "fggraph", "cseg")
TUNE_SIZE, TUNE_BUDGET_S = 64, 60.0


def ledger_reset(torch, dev) -> None:
  """A fresh device ledger (its anchor event on the current stream) and
  fresh peak-memory statistics, just before a run."""
  from igneous_tpu_torch.observability import device as ledger

  ledger.reset()
  torch.cuda.reset_peak_memory_stats(dev)


def launch_counts(*modules) -> dict:
  return {k: v for m in modules for k, v in m.LAUNCHES.items()}


def card_label() -> str:
  import torch

  return f"cuda:{torch.cuda.current_device()}"


def card_executes(snap: dict, name: str) -> int:
  """A name's executes on the card (the skeleton task labels its boundary
  planes on the CPU on purpose: those spans are no launches)."""
  return snap["kernels"].get(name, {}).get("devices", {}).get(card_label(), 0)


def ledger_line(label: str, wall: float, launches=None) -> dict:
  """Print the device ledger of the run just ended: the card's busy share
  of ``wall``, dispatches, copies, pad waste, peak memory, the spans' host
  cost (``SPAN_US``) as a share of the wall, and each name's executes and
  span seconds. ``launches``: the hand kernels' counts since the ledger's
  reset, which their executes on the card must equal. Returns the
  snapshot, its ``busy_s`` the card's."""
  from igneous_tpu_torch.observability.device import LEDGER

  LEDGER.sample_hbm()
  snap = LEDGER.snapshot()
  if snap is None:
    fail(f"ledger {label}: no device work recorded")
  snap["busy_s"] = snap["devices"].get(card_label(), 0.0)
  k = snap["kernels"]
  spans = sum(v["executes"] for v in k.values()) + snap["transfers"]
  peak = max((r["peak_bytes_in_use"] for r in snap.get("hbm", {}).values()), default=0)
  pad = snap["pad_waste_ratio"]
  print(f"ledger {label}: wall {wall:.3f} s, card busy {snap['busy_s']:.4f} s (share "
        f"{100 * snap['busy_s'] / wall:.2f}%, idle {100 * (1 - snap['busy_s'] / wall):.2f}%), "
        f"dispatches {snap['dispatches']}, h2d {snap['h2d_bytes']} B, d2h "
        f"{snap['d2h_bytes']} B, pad waste {'none' if pad is None else f'{pad:.4f}'} "
        f"({snap['pad_bytes']} of {snap['real_bytes']} B), hbm peak {peak / 1e9:.3f} GB, "
        f"{spans} spans ({100 * spans * SPAN_US[0] / 1e6 / wall:.4f}% of the wall at "
        f"{SPAN_US[0]:.2f} us a span), executes and span s "
        f"{json.dumps({n: [v['executes'], round(v['execute_s'], 4)] for n, v in k.items()})}",
        flush=True)
  if launches is not None:
    for name in HAND_KERNELS:
      if card_executes(snap, name) != launches.get(name, 0):
        fail(f"ledger {label}: {name} executes {card_executes(snap, name)} on the card, "
             f"launches {launches.get(name, 0)}")
  return snap


def ledger_against_profiler(label: str, snap: dict, prof, wall: float, launches: dict) -> None:
  """The ledger against a torch.profiler trace of the same run: each hand
  kernel's span seconds within ``LEDGER_REL_TOL`` (or
  ``LEDGER_US_PER_LAUNCH`` a launch) of its kernels' traced time, its
  executes equal to its launches, and the busy seconds at least the
  trace's kernel and copy time and at most the wall."""
  traced = traced_device_us(prof) / 1e6
  events = prof.key_averages()
  per = {}
  for name in HAND_KERNELS:
    n = launches.get(name, 0)
    got = snap["kernels"].get(name, {"executes": 0, "execute_s": 0.0})
    if card_executes(snap, name) != n or got["executes"] != n:
      fail(f"ledger {label}: {name} executes {got['executes']}, launches {n}")
    if not n:
      continue
    prof_s = sum(
      getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
      for e in events if TRACE_NAMES[name] in e.key
    ) / 1e6
    tol = max(LEDGER_REL_TOL * prof_s, LEDGER_US_PER_LAUNCH * 1e-6 * n)
    per[name] = {"launches": n, "ledger_s": round(got["execute_s"], 6),
                 "traced_s": round(prof_s, 6), "tol_s": round(tol, 6)}
    if not prof_s > 0 or abs(got["execute_s"] - prof_s) > tol:
      fail(f"ledger {label}: {name} spans {got['execute_s']:.6f} s against the traced "
           f"{prof_s:.6f} s, tolerance {tol:.6f} s")
  busy = snap["busy_s"]
  print(f"ledger against profiler {label}: busy {busy:.4f} s, traced kernels and copies "
        f"{traced:.4f} s, wall {wall:.3f} s, hand kernels {json.dumps(per)}", flush=True)
  if not traced <= busy <= wall:
    fail(f"ledger {label}: busy {busy:.4f} s not between the traced {traced:.4f} s "
         f"and the wall {wall:.3f} s")


def span_cost(torch, dev) -> float:
  """Host microseconds of one execute span on the card: 1000 empty spans,
  their events resolved. Sets ``SPAN_US``."""
  from igneous_tpu_torch.observability import device as ledger

  ledger_reset(torch, dev)
  torch.cuda.synchronize(dev)
  t0 = time.perf_counter()
  for _ in range(1000):
    with ledger.execute_span("empty", device=dev):
      pass
  snap = ledger.LEDGER.snapshot()
  SPAN_US[0] = (time.perf_counter() - t0) / 1000 * 1e6
  if snap["kernels"]["empty"]["executes"] != 1000 or snap["dispatches"] != 1000:
    fail(f"span cost: {snap['kernels']['empty']['executes']} of 1000 spans recorded")
  print(f"span cost: {SPAN_US[0]:.2f} us a span (1000 empty execute spans on the card, "
        f"events resolved), card busy {snap['busy_s'] * 1e3:.3f} ms", flush=True)
  return SPAN_US[0]


STORE_WORKER = r"""
import json, shutil, sys
from pathlib import Path

import numpy as np
import torch

from igneous_tpu_torch import cseg, set_device
from igneous_tpu_torch.ops import _build


def no_nvcc():
  raise RuntimeError("this worker has no nvcc")


_build.nvcc_path = no_nvcc  # /usr/local/cuda/bin/nvcc is off limits too
_build.BUILD_DIR = Path(sys.argv[1])
assert not any(_build.BUILD_DIR.iterdir())
assert shutil.which("nvcc") is None and shutil.which("g++") is None
names = sys.argv[2].split(",")
dev = set_device("cuda")
from igneous_tpu_torch.ops import cuda_ccl as cc, cuda_edt as ce, cuda_pooling as cp, edt

for name in names:
  _build.load(name)
  if _build.BUILD_LOG[name].get("store") != "hit":
    sys.exit(f"{name}: not loaded from the store: {_build.BUILD_LOG[name]}")
g = torch.Generator(device=dev).manual_seed(0)
equal = {}
x = torch.randint(0, 256, (1, 64, 1000, 1000), dtype=torch.uint8, device=dev, generator=g)
equal["pool2x2x1"] = torch.equal(cp.pool2x2x1(x), cp.pool2x2x1_plain(x))
x = torch.randint(0, 256, (1, 64, 1024, 1024), dtype=torch.uint8, device=dev, generator=g)
equal["pyramid2x2x1"] = all(torch.equal(a, b) for a, b in zip(
  cp.pyramid2x2x1(x, 5), cp.pyramid2x2x1_plain(x, 5)))
t = torch.randint(0, 3, (512, 16, 16, 32), dtype=torch.int32, device=dev, generator=g)
equal["tile_resolve"] = torch.equal(cc.tile_resolve(t, 6), cc.tile_resolve_plain(t, 6))
lab = torch.randint(0, 4, (96, 128, 160), dtype=torch.int32, device=dev, generator=g)
card = edt.squared_edt(lab, (8.0, 8.0, 40.0))
edt.edt_pass = ce.edt_pass_plain
equal["edt_pass"] = torch.equal(card, edt.squared_edt(lab, (8.0, 8.0, 40.0)))
torch.cuda.synchronize()
launched = {**cp.LAUNCHES, **cc.LAUNCHES, **ce.LAUNCHES}
seg = np.random.default_rng(0).integers(0, 9, (64, 64, 64, 1)).astype(np.uint64) << np.uint64(40)
equal["cseg"] = bool(np.array_equal(cseg.decompress(cseg.compress(seg), seg.shape, np.uint64), seg))
print(json.dumps({"fetch_s": {n: _build.BUILD_LOG[n]["fetch_s"] for n in names},
                  "saved_s": {n: _build.BUILD_LOG[n]["saved_s"] for n in names},
                  "equal": equal, "launched": launched}))
"""


def store_phase(root: str, torch, dev) -> None:
  """The library store: every library this run built is put into a
  file:// store; a worker process with an empty build directory, no nvcc
  or g++ on its PATH, CUDA_HOME unset and its nvcc lookup made to raise
  loads every library from the store and runs each hand kernel once, bit
  for bit against its plain version (and the cseg codec through a round
  trip); its fetch seconds beside this run's build seconds. Then one
  entry is corrupted: it must be quarantined, rebuilt and put back."""
  import os
  from pathlib import Path

  from igneous_tpu_torch import compile_cache
  from igneous_tpu_torch.observability.device import LEDGER
  from igneous_tpu_torch.ops import _build

  t_phase = time.perf_counter()
  store_root = f"file://{root}/library_store"
  store = compile_cache.CompileCache(store_root)
  built = {n: _build.BUILD_LOG[n]["seconds"] for n in LIBRARIES}
  for name in LIBRARIES:
    src, flags, compiler = _build._source(name)
    kind = "nvcc" if src.suffix == ".cu" else "g++"
    if not compile_cache.publish(store, name, src, flags, kind, compiler,
                                 _build.library_path(name), built[name]):
      fail(f"store: {name} was not put")
  bare = Path(root) / "no_compilers"
  work = Path(root) / "worker_build"
  bare.mkdir()
  work.mkdir()
  env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
  env.update(PATH=str(bare), IGNEOUS_COMPILE_CACHE=store_root,
             PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
  t0 = time.perf_counter()
  proc = subprocess.run([sys.executable, "-c", STORE_WORKER, str(work), ",".join(LIBRARIES)],
                        env=env, capture_output=True, text=True, timeout=600)
  worker_wall = time.perf_counter() - t0
  if proc.returncode != 0:
    fail(f"store: the worker without compilers failed:\n{proc.stderr[-3000:]}")
  res = json.loads(proc.stdout.strip().splitlines()[-1])
  if not all(res["equal"].values()) or not all(res["launched"][k] for k in HAND_KERNELS):
    fail(f"store: the worker's kernels {res['equal']}, launches {res['launched']}")
  print(f"store: {len(LIBRARIES)} libraries put, a worker with no compiler loaded every one "
        f"from the store (wall {worker_wall:.1f} s with its imports and checks); each hand "
        f"kernel bit for bit its plain version there {json.dumps(res['equal'])}, launches "
        f"{json.dumps(res['launched'])}", flush=True)
  for name in LIBRARIES:
    print(f"store {name}: fetch {res['fetch_s'][name]:.4f} s, build {built[name]:.1f} s "
          f"(this run; the entry's {res['saved_s'][name]:.1f} s)", flush=True)

  # a bit-flipped entry: quarantined, rebuilt, a good copy put back
  entries = sorted(Path(root, "library_store", "libraries", "cseg").rglob("*.bin"))
  if len(entries) != 1:
    fail(f"store: {len(entries)} cseg entries")
  data = bytearray(entries[0].read_bytes())
  data[-100] ^= 0x01
  entries[0].write_bytes(bytes(data))
  saved = _build.BUILD_DIR, _build.BUILD_LOG.get("cseg")
  _build.BUILD_DIR = Path(root) / "rebuild"
  os.environ[compile_cache.CACHE_ENV] = store_root
  LEDGER.reset()
  try:
    rebuilt = _build.build("cseg")
    log = _build.BUILD_LOG["cseg"]
  finally:
    os.environ.pop(compile_cache.CACHE_ENV, None)
    _build.BUILD_DIR = saved[0]
    _build.BUILD_LOG["cseg"] = saved[1]
  cache = LEDGER.snapshot()["compile_cache"]
  quarantined = list(Path(root, "library_store", "quarantine").rglob("*.bin"))
  after = sorted(Path(root, "library_store", "libraries", "cseg").rglob("*.bin"))
  good = len(after) == 1 and after[0].read_bytes() != bytes(data)
  body = compile_cache.decode_entry(after[0].read_bytes(), _entry_meta(after[0]))[0] if good else b""
  print(f"store corrupt: cseg entry bit-flipped, quarantined {len(quarantined)}, rebuilt in "
        f"{log['seconds']:.1f} s, put back {good and body == rebuilt.read_bytes()}, "
        f"counts {json.dumps(cache)}", flush=True)
  if len(quarantined) != 1 or "store" in log or cache["corrupt"] != 1 or cache["puts"] != 1 \
     or not good or body != rebuilt.read_bytes():
    fail("store: the corrupt entry was not quarantined, rebuilt and put back")
  print(f"store: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


def _entry_meta(path) -> dict:
  """The key an entry's header carries."""
  data = path.read_bytes()
  hlen = int.from_bytes(data[8:12], "big")
  return json.loads(data[12:12 + hlen])["meta"]


def tune_phase(root: str) -> None:
  """``tune.run(size=64, budget_sec=60)`` on the card: each candidate's
  time, every one byte for byte the default's, ``tuned/<device kind>.json``
  written, and ``resolve`` picking each winner (and no value where the
  default stood). The tuned root is unset afterwards."""
  import os

  from igneous_tpu_torch import tune
  from igneous_tpu_torch.analysis import knobs
  from igneous_tpu_torch.storage import CloudFiles

  t_phase = time.perf_counter()
  pinned = [n for n in tune.TUNABLE if knobs.raw(n)]
  if pinned:
    fail(f"tune: {pinned} pinned in the environment")
  tuned_root = f"file://{root}/tuned_root"
  os.environ[tune.CONFIG_ENV] = tuned_root
  tune.reset_cache()
  try:
    try:
      config = tune.run(size=TUNE_SIZE, budget_sec=TUNE_BUDGET_S,
                        log=lambda m: print(f"tune: {m}", flush=True))
    except AssertionError as e:
      fail(f"tune: {e}")
    kind = tune.device_kind()
    written = CloudFiles(tuned_root).get_json(f"tuned/{kind}.json")
    if not kind.startswith("NVIDIA") or written is None or written["knobs"] != config["knobs"]:
      fail(f"tune: tuned/{kind}.json not written as swept")
    for name in tune.TUNABLE:
      rows = config["measurements"][name]
      if not all(r.get("identical") for r in rows if "seconds" in r):
        fail(f"tune: {name}: a candidate differs from the default")
      if tune.resolve(name) != config["knobs"].get(name):
        fail(f"tune: resolve({name}) = {tune.resolve(name)}, swept {config['knobs'].get(name)}")
    print(f"tune: size {TUNE_SIZE}, budget {TUNE_BUDGET_S:.0f} s, tuned/{kind}.json with "
          f"{json.dumps(config['knobs'])}, every timed candidate byte for byte the default's, "
          f"resolve picks each winner; best over default "
          f"{config['tune_best_vs_default_ratio']:.4f}; skipped "
          f"{sum('skipped' in r for rows in config['measurements'].values() for r in rows)}",
          flush=True)
  finally:
    os.environ.pop(tune.CONFIG_ENV, None)
    tune.reset_cache()
  print(f"tune: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# the queue worker (phase 11)

WORKER_SUMMARY = re.compile(
  r"executed (\d+) tasks \((\d+) batched in (\d+) dispatches, (\d+) solo, "
  r"(\d+) failed, (\d+) released\)"
)
WORKER_LEASE_SEC = 600
# phase 3d's streams that (a) drains with two workers: the image stream
# alone since phase 18 (both before), to make room for phase 18; (c)
# still drains segmentation-stream tasks through a worker process
WORKER_STREAMS = 1
# a card's worker process reaches the card in 8-10 s; the drain, the
# dead letters and the heartbeat each wait on short leases
WORKER_START_S, WORKER_EXIT_S = 180.0, 600.0
DRAIN_POLL_SEC = "0.2"
HEARTBEAT_LEASE_SEC, HEARTBEAT_TASK_S = 2, 6.0
POISON = "chip smoke poison"


def zero_counts(*modules) -> None:
  for m in modules:
    for key in m.LAUNCHES:
      m.LAUNCHES[key] = 0


def run_cli(args) -> str:
  """The port's command line in this process; fails on a non-zero exit.
  Returns what it printed."""
  import contextlib
  import io

  from igneous_tpu_torch.cli import main as cli_main

  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rc = cli_main([str(a) for a in args])
  if rc != 0:
    fail(f"`{' '.join(map(str, args))}` exited {rc}: {out.getvalue()[-2000:]}")
  return out.getvalue()


def worker_summary(text: str, label: str) -> dict:
  """The counts of an ``execute --batch`` run's summary line, and its
  rounds and dispatches by kind from its ``--time`` lines (when there)."""
  m = WORKER_SUMMARY.search(text)
  if m is None:
    fail(f"worker {label}: no summary line in {text[-2000:]!r}")
  keys = ("executed", "batched", "dispatches", "solo", "failed", "released")
  got = dict(zip(keys, map(int, m.groups())))
  rounds = [json.loads(l) for l in text.splitlines() if l.startswith('{"round_members"')]
  by_kind = {}
  for r in rounds:
    for k, v in r["dispatches"].items():
      by_kind[k] = by_kind.get(k, 0) + v
  got["rounds"], got["by_kind"] = len(rounds), by_kind
  got["round_solo"] = sum(r["solo"] for r in rounds)
  got["group_fallbacks"] = sum(r["group_fallbacks"] for r in rounds)
  return got


def start_worker(root: str, label: str, args, env=()):
  """``python -m igneous_tpu_torch execute ...`` as a worker process on the
  card, its output in files under ``root``. Returns (process, out path)."""
  import os

  here = os.path.dirname(os.path.abspath(__file__))
  out = os.path.join(root, f"worker_{label}.out")
  environ = dict(os.environ, PYTHONPATH=here, **dict(env))
  with open(out, "w") as fo, open(out + ".err", "w") as fe:
    proc = subprocess.Popen(
      [sys.executable, "-m", "igneous_tpu_torch", "execute", *map(str, args)],
      cwd=here, env=environ, stdout=fo, stderr=fe,
    )
  return proc, out


def finish_worker(proc, out: str, label: str, codes=(0,)) -> str:
  """Wait for a worker process (killed after ``WORKER_EXIT_S``); fails on
  an exit code outside ``codes``. Returns its standard output."""
  try:
    proc.wait(timeout=WORKER_EXIT_S)
  except subprocess.TimeoutExpired:
    proc.kill()
    proc.wait()
    fail(f"worker {label}: still running after {WORKER_EXIT_S:.0f} s")
  text = open(out).read()
  if proc.returncode not in codes:
    fail(f"worker {label}: exit {proc.returncode}: {open(out + '.err').read()[-3000:]}")
  return text


def wait_for(pred, seconds: float, what: str, proc=None) -> None:
  t0 = time.perf_counter()
  while not pred():
    if proc is not None and proc.poll() is not None:
      return  # it ended: the caller reads its exit
    if time.perf_counter() - t0 > seconds:
      fail(f"worker: {what} not within {seconds:.0f} s")
    time.sleep(0.05)


def mip_files_equal(src: str, dst: str, mips: int, complete: bool = True) -> int:
  """Every chunk file of mips 1..mips under ``dst`` byte for byte the same
  file under ``src`` (phase 3's solo output); with ``complete`` the two
  hold the same files. Returns how many."""
  import os

  from igneous_tpu_torch import Volume

  n = 0
  for scale in Volume(f"file://{dst}").info["scales"][1 : mips + 1]:
    a, b = os.path.join(src, scale["key"]), os.path.join(dst, scale["key"])
    if complete:
      n += same_files(a, b)
      continue
    for name in os.listdir(b):
      with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
        if fa.read() != fb.read():
          fail(f"{b}/{name} differs from phase 3's {a}/{name}")
      n += 1
  return n


def worker_streams(root, cp, cc, ce, walls3d, torch, dev) -> dict:
  """(a) Phase 3d's first ``WORKER_STREAMS`` 16-task streams through
  ``image downsample --queue`` and two workers at once: a worker process (``execute --batch
  4 -x --time``) and, once it holds leases, ``execute --batch 8 -x
  --time`` in this process, whose launches and ledger are read. No group
  of either falls back to solo. The written mips byte
  for byte phase 3's solo output (and so phase 3d's), each task completed
  once (16 tallies, none leased or dead-lettered), and the walls beside
  phase 3d's. Returns this process's launches."""
  import os

  from igneous_tpu_torch.queues import FileQueue

  launches = {}
  for name, target, ntasks, shape, mips in PIPELINED_RUNS[:WORKER_STREAMS]:
    src, dst = os.path.join(root, name), os.path.join(root, f"{name}_worker")
    spec = f"fq://{root}/queue_{name}"
    link_layer(src, dst)
    run_cli(["image", "downsample", f"file://{dst}", "--num-mips", mips,
             "--memory", target, "--queue", spec])
    q = FileQueue(spec)
    if q.inserted != ntasks or q.queue_files != ntasks:
      fail(f"worker {name}: {q.inserted} tasks in {q.queue_files} files, expected {ntasks}")
    proc, out = start_worker(root, name, [spec, "--batch", 4, "-x", "--time", "--lease-sec",
                                          WORKER_LEASE_SEC])
    try:
      wait_for(lambda: q.leased or q.completed, WORKER_START_S,
               f"the worker process of {name} leasing", proc)
      zero_counts(cp, cc, ce)
      ledger_reset(torch, dev)
      t0 = time.perf_counter()
      text = run_cli(["execute", spec, "--batch", 8, "-x", "--time", "--lease-sec",
                      WORKER_LEASE_SEC])
      wall = time.perf_counter() - t0
      launched = launch_counts(cp, cc, ce)
      other = worker_summary(finish_worker(proc, out, name), f"{name} process")
    finally:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    wall_all = time.perf_counter() - t0
    mine = worker_summary(text, name)
    snap = ledger_line(f"worker {name}", wall, launched)
    depth = q.depth_snapshot()
    print(f"worker {name}: {ntasks} tasks of {shape[0]}x{shape[1]}x{shape[2]}, {mips} mips, "
          f"this process {json.dumps(mine)} in {wall:.3f} s (busy "
          f"{100 * snap['busy_s'] / wall:.2f}%), the worker process {json.dumps(other)}, "
          f"both done {wall_all:.3f} s after this one began; phase 3d serial "
          f"{walls3d[(name, 'serial')]:.3f} s ({SERIAL_TASKS} tasks), pipelined "
          f"{walls3d[(name, 'pipelined')]:.3f} s; "
          f"launches {json.dumps(launched)}, queue {json.dumps(depth)}", flush=True)
    if mine["executed"] + other["executed"] != ntasks or mine["failed"] or other["failed"] \
       or other["group_fallbacks"] or other["round_solo"] != other["solo"]:
      fail(f"worker {name}: executed {mine['executed']} + {other['executed']} of {ntasks}, "
           f"the worker process {other}")
    if depth["completed"] != ntasks or depth["enqueued"] or depth["dlq"] or depth["inserted"] != ntasks:
      fail(f"worker {name}: queue {depth} after the workers, expected {ntasks} completions")
    if not mine["executed"]:
      fail(f"worker {name}: this process executed no task")
    # a round that leased one task (the other worker took the rest) runs it
    # solo, which is one pyramid2x2x1 launch too; a group that fell back is
    # a failure
    if mine["group_fallbacks"] or mine["round_solo"] != mine["solo"] \
       or launched["pyramid2x2x1"] != mine["by_kind"].get("downsample", 0) + mine["solo"] \
       or launched["pool2x2x1"] or mine["by_kind"].get("downsample_paged"):
      fail(f"worker {name}: launches {launched} for dispatches {mine['by_kind']}, "
           f"{mine['solo']} solo, {mine['group_fallbacks']} group fallbacks")
    n = mip_files_equal(src, dst, mips)
    print(f"worker {name}: {n} chunk files of mips 1-{mips} equal to phase 3's solo "
          f"output byte for byte", flush=True)
    for k, v in launched.items():
      launches[k] = launches.get(k, 0) + v
  return launches


def worker_ragged(root, cp, cc, ce) -> dict:
  """(b) Phase 3's ragged image as 16 tasks of 256x256x64 (2 mips) through
  a queue and ``poll_batched`` at batch 8 (``execute --batch 8``): full
  members through ``pyramid2x2x1``, clamped ones through the pages
  (``pool2x2x1``); no group falls back; mips 1-2 equal phase 3's."""
  import os

  from igneous_tpu_torch.parallel.lease_batcher import poll_batched
  from igneous_tpu_torch.queues import FileQueue

  name = "ragged_image"
  src, dst = os.path.join(root, name), os.path.join(root, f"{name}_worker")
  spec = f"fq://{root}/queue_{name}"
  link_layer(src, dst)
  run_cli(["image", "downsample", f"file://{dst}", "--num-mips", 2, "--memory", 2**23,
           "--queue", spec])
  q = FileQueue(spec)
  zero_counts(cp, cc, ce)
  t0 = time.perf_counter()
  executed, stats = poll_batched(q, batch_size=8, lease_seconds=WORKER_LEASE_SEC,
                                 verbose=False, stop_fn=lambda executed, empty: empty)
  wall = time.perf_counter() - t0
  launched = launch_counts(cp, cc, ce)
  stats = dict(stats, dispatches=dict(stats["dispatches"]))
  print(f"worker {name}: 16 tasks, wall {wall:.3f} s, stats {json.dumps(stats)}, launches "
        f"{json.dumps(launched)}", flush=True)
  check_groups(name, stats, executed, 16)
  if not (launched["pyramid2x2x1"] and launched["pool2x2x1"]) \
     or stats["dispatches"].get("downsample_paged", 0) < 1:
    fail(f"worker {name}: the full and the paged members did not both launch: {launched}")
  n = mip_files_equal(src, dst, 2)
  print(f"worker {name}: {n} chunk files of mips 1-2 equal to phase 3's solo output "
        f"byte for byte", flush=True)
  return launched


def check_groups(name: str, stats: dict, executed: int, ntasks: int) -> None:
  """A clean queue: every task batched in a group, none solo, failed,
  released or fallen back."""
  if executed != ntasks or stats["batched"] != ntasks or stats["solo"] \
     or stats["failed"] or stats["released"] or stats["group_fallbacks"]:
    fail(f"worker {name}: {stats} for {ntasks} tasks; every one must ride a group")


def worker_lifecycle(root, cp, cc, ce) -> dict:
  """(c) On phase 3's segmentation: eight downsample tasks and a
  ``FailTask`` through ``execute --batch 8 --max-deliveries 2
  --lease-sec 2``: the dead-letter queue holds the ``FailTask`` alone
  with its reason twice, the eight complete and their chunks equal phase
  3's. Then 16 tasks drained by a worker process whose
  ``--drain-sentinel`` appears mid-run: it exits 83 holding no lease,
  and a second worker finishes the queue, every chunk equal. Then a task
  longer than ``--lease-sec 2`` (a ``SleepTask``) runs once under the
  heartbeat: a second worker started after its first lease would have
  expired finds nothing to lease. Returns this process's launches."""
  import os
  import threading

  from igneous_tpu_torch import telemetry
  from igneous_tpu_torch.cli import main as cli_main
  from igneous_tpu_torch.queues import FileQueue
  from igneous_tpu_torch.task_creation import create_downsampling_tasks
  from igneous_tpu_torch.tasks import FailTask, SleepTask

  name, target, ntasks, shape, mips = PIPELINED_RUNS[1]
  src = os.path.join(root, name)
  launches = {}

  def add(counts):
    for k, v in counts.items():
      launches[k] = launches.get(k, 0) + v

  # dead letters
  dst, spec = os.path.join(root, f"{name}_dlq"), f"fq://{root}/queue_dlq"
  link_layer(src, dst)
  tasks = list(create_downsampling_tasks(f"file://{dst}", mip=0, num_mips=mips,
                                         memory_target=target))[:8]
  q = FileQueue(spec)
  q.insert(tasks + [FailTask(POISON)])
  zero_counts(cp, cc, ce)
  t0 = time.perf_counter()
  text = run_cli(["execute", spec, "--batch", 8, "-x", "--max-deliveries", 2,
                  "--lease-sec", 2])
  wall = time.perf_counter() - t0
  add(launch_counts(cp, cc, ce))
  dlq = q.dlq_ls()
  mine = worker_summary(text, "dlq")
  reasons = [f["error"] for rec in dlq for f in rec["failures"]]
  print(f"worker dead letters: 8 tasks and a FailTask, wall {wall:.3f} s, {json.dumps(mine)}, "
        f"dlq {[json.loads(r['payload'])['class'] for r in dlq]}, deliveries "
        f"{[r['deliveries'] for r in dlq]}, reasons {reasons}, queue "
        f"{json.dumps(q.depth_snapshot())}", flush=True)
  if len(dlq) != 1 or json.loads(dlq[0]["payload"])["class"] != "FailTask" \
     or reasons != [f"RuntimeError: {POISON}"] * 2 or dlq[0]["deliveries"] != 2:
    fail(f"worker dead letters: dlq {dlq}")
  if q.completed != 8 or q.enqueued or mine["executed"] != 8:
    fail(f"worker dead letters: {q.completed} of 8 completed, {q.enqueued} left")
  n = mip_files_equal(src, dst, mips, complete=False)

  # a drain mid-run, then a second worker
  dst, spec = os.path.join(root, f"{name}_drain"), f"fq://{root}/queue_drain"
  sentinel = os.path.join(root, "drain_sentinel")
  link_layer(src, dst)
  run_cli(["image", "downsample", f"file://{dst}", "--num-mips", mips, "--memory", target,
           "--queue", spec])
  q = FileQueue(spec)
  proc, out = start_worker(root, "drain", [spec, "--batch", 2, "--drain-sentinel", sentinel,
                                           "--lease-sec", WORKER_LEASE_SEC],
                           env={"IGNEOUS_PREEMPT_POLL_SEC": DRAIN_POLL_SEC})
  try:
    wait_for(lambda: q.completed >= 2, WORKER_START_S, "two completions before the drain",
             proc)
    open(sentinel, "w").close()
    t0 = time.perf_counter()
    drained = finish_worker(proc, out, "drain", codes=(83,))
    t_drain = time.perf_counter() - t0
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait()
  before = q.depth_snapshot()
  zero_counts(cp, cc, ce)
  text = run_cli(["execute", spec, "--batch", 8, "-x", "--lease-sec", WORKER_LEASE_SEC])
  add(launch_counts(cp, cc, ce))
  after = q.depth_snapshot()
  print(f"worker drain: exit 83 {t_drain:.3f} s after the sentinel, its last line "
        f"{drained.strip().splitlines()[-1]!r}; queue then {json.dumps(before)}; the second "
        f"worker {json.dumps(worker_summary(text, 'after the drain'))}, queue "
        f"{json.dumps(after)}", flush=True)
  if before["leased"] or not 2 <= before["completed"] < ntasks:
    fail(f"worker drain: queue {before} after the drained worker exited")
  if after["completed"] != ntasks or after["enqueued"] or after["dlq"]:
    fail(f"worker drain: queue {after} after the second worker")
  n += mip_files_equal(src, dst, mips)

  # the heartbeat
  spec = f"fq://{root}/queue_heartbeat"
  q = FileQueue(spec)
  q.insert([SleepTask(HEARTBEAT_TASK_S)])
  telemetry.reset_all()
  codes = []
  # quiet, so that only the second worker prints (run_cli takes stdout)
  first = threading.Thread(target=lambda: codes.append(cli_main(
    ["execute", spec, "-x", "-q", "--lease-sec", str(HEARTBEAT_LEASE_SEC)])))
  t0 = time.perf_counter()
  first.start()
  time.sleep(HEARTBEAT_LEASE_SEC + 1.0)
  ages = q.lease_ages()
  second = run_cli(["execute", spec, "-x", "--lease-sec", HEARTBEAT_LEASE_SEC])
  first.join()
  wall = time.perf_counter() - t0
  zombies = {k: v for k, v in telemetry.counters_snapshot().items() if k.startswith("zombie")}
  print(f"worker heartbeat: a {HEARTBEAT_TASK_S:.0f} s task at --lease-sec "
        f"{HEARTBEAT_LEASE_SEC}, lease expiry in {ages} s at {HEARTBEAT_LEASE_SEC + 1} s, the "
        f"second worker {second.strip()!r}, wall {wall:.3f} s, completions {q.completed}, "
        f"zombie counts {zombies}", flush=True)
  if not ages or min(ages) <= 0 or "executed 0 tasks" not in second or q.completed != 1 \
     or zombies or q.enqueued or codes != [0]:
    fail("worker heartbeat: the long task was not held by its heartbeat exactly once")
  print(f"worker lifecycle: {n} chunk files equal to phase 3's solo output", flush=True)
  return launches


def worker_ccl(root, cc, cp, ce, faces_task: str) -> dict:
  """(b) CCL pass 1 over phase 4's segmentation layer through ``ccl faces
  --queue`` and ``poll_batched`` at batch 4: one group (``paged_ccl``,
  ``tile_resolve`` once a page round), every face file byte for byte the
  task path's. Returns the launches."""
  import os
  import shutil

  from igneous_tpu_torch.parallel.lease_batcher import poll_batched
  from igneous_tpu_torch.queues import FileQueue

  name = "ccl_segmentation"
  spec = f"fq://{root}/queue_ccl"
  shape = ",".join(map(str, CCL_TASK_SHAPE))
  run_cli(["image", "ccl", "faces", f"file://{root}/{name}", "--shape", shape, "--queue", spec])
  q = FileQueue(spec)
  ntasks = q.inserted
  zero_counts(cp, cc, ce)
  t0 = time.perf_counter()
  executed, stats = poll_batched(q, batch_size=4, lease_seconds=WORKER_LEASE_SEC,
                                 verbose=False, stop_fn=lambda executed, empty: empty)
  wall = time.perf_counter() - t0
  launched = launch_counts(cp, cc, ce)
  stats = dict(stats, dispatches=dict(stats["dispatches"]))
  faces = os.path.join(root, name, "ccl", "0", "faces")
  n = same_files(faces_task, faces)
  print(f"worker ccl faces: {ntasks} tasks, wall {wall:.3f} s, stats {json.dumps(stats)}, "
        f"launches {json.dumps(launched)}, {n} face files equal to the task path's byte for "
        f"byte", flush=True)
  check_groups("ccl faces", stats, executed, ntasks)
  if stats["dispatches"] != {"ccl_faces": 1} or not launched["tile_resolve"]:
    fail(f"worker ccl faces: dispatches {stats['dispatches']}, launches {launched}")
  shutil.rmtree(os.path.join(root, name, "ccl"))
  return launched


def worker_skeleton(root, ce, cp, cc) -> dict:
  """(b) The sharded skeleton forge of phase 15's tube crop through a queue
  (its two tasks of FRAGS_SKEL_TASK, 8 tracing threads each, into
  ``skeletons_worker``) and ``poll_batched`` at batch 2: one group
  (``paged_edt``, three ``edt_pass`` launches), both .frags containers
  byte for byte phase 15's (c). Returns the launches."""
  from igneous_tpu_torch.parallel.lease_batcher import poll_batched
  from igneous_tpu_torch.queues import FileQueue
  from igneous_tpu_torch.task_creation import create_skeletonizing_tasks

  path = f"file://{root}/frags_skeletons"
  q = FileQueue(f"fq://{root}/queue_skeleton")
  tasks = list(create_skeletonizing_tasks(path, shape=FRAGS_SKEL_TASK, sharded=True,
                                          skel_dir="skeletons_worker",
                                          parallel=SKEL_TRACE_THREADS))
  q.insert_batch(tasks, total=len(tasks))
  zero_counts(cp, cc, ce)
  t0 = time.perf_counter()
  executed, stats = poll_batched(q, batch_size=2, lease_seconds=WORKER_LEASE_SEC,
                                 verbose=False, stop_fn=lambda executed, empty: empty)
  wall = time.perf_counter() - t0
  launched = launch_counts(cp, cc, ce)
  stats = dict(stats, dispatches=dict(stats["dispatches"]))
  frags = same_files(f"{root}/frags_skeletons/{FRAGS_SKEL_DIR}",
                     f"{root}/frags_skeletons/skeletons_worker",
                     keep=lambda n: n.endswith(".frags"))
  print(f"worker skeleton forge: {len(tasks)} tasks, wall {wall:.3f} s, stats "
        f"{json.dumps(stats)}, launches {json.dumps(launched)}, {frags} .frags containers "
        f"equal to phase 15's byte for byte", flush=True)
  check_groups("skeleton forge", stats, executed, len(tasks))
  if stats["dispatches"] != {"skeleton": 1} or launched["edt_pass"] != 3 or frags != 2:
    fail(f"worker skeleton forge: dispatches {stats['dispatches']}, launches {launched}")
  return launched


# ---------------------------------------------------------------------------
# the storage plane (phase 12): gs:// and s3:// on the repo's in-process
# fakes, the integrity envelope, audit --heal

# (a) a crop of phase 3's image on gs://: 4 tasks of 1024x1024x64 with 4
# mips, the new mips in 64^3 chunks (a task's mip 4 is 64 voxels wide)
GS_CROP = (2048, 2048, 64)
GS_CHUNK = (128, 128, 64)
GS_NEW_CHUNK = (64, 64, 64)
GS_MIPS, GS_TASKS, GS_TARGET = 4, 4, 2**27
# (b) a crop of phase 3's segmentation on s3://, one task of 3 mips; its
# gzip chunks are larger than the multipart threshold, so mip 0 goes up in
# parts
S3_CROP = (1024, 512, 64)
S3_MIPS = 3
S3_MULTIPART = 64 * 1024
# (c) the damage: (mip, chunk, how); each in another task cell of (a)
DAMAGE = [
  (1, "64-128_0-64_0-64", "flip"),
  (2, "256-320_0-64_0-64", "truncate"),
  (3, "0-64_128-192_0-64", "delete"),
]
UNHEALABLE_CHUNK = "0-128_0-128_0-64"  # mip 0, flipped after the heal
# (d) phase 3d's image stream under each setting of the envelope
ENVELOPE_MODES = {
  "off": {"IGNEOUS_INTEGRITY": "off"},
  "default": {},
  "verify": {"IGNEOUS_INTEGRITY_VERIFY_AFTER_WRITE": "1"},
}
# tasks of phase 3d's image stream each envelope mode runs: half of them
# since phase 13 and a quarter since phase 17, to make room for them in the
# time limit
ENVELOPE_TASKS = 4
FAKE_PAGE_SIZE = 1000  # listing page of the fakes (the tests force 3)
FAKE_BACKLOG = 128  # their listen backlog (socketserver's default is 5)


class StorageCounter:
  """A ``storage.set_backend_wrapper`` wrapper: counts each protocol's
  bytes put (up) and got (down) through the backends it wraps."""

  def __init__(self):
    import threading

    self.lock = threading.Lock()
    self.bytes = {}

  def __call__(self, backend, pth):
    return CountedBackend(backend, pth.protocol, self)

  def add(self, protocol, way, n):
    with self.lock:
      per = self.bytes.setdefault(protocol, {"up": 0, "down": 0})
      per[way] += n

  def take(self) -> dict:
    with self.lock:
      out, self.bytes = self.bytes, {}
    return out


class CountedBackend:
  """A storage backend whose puts and gets a ``StorageCounter`` counts."""

  def __init__(self, backend, protocol: str, counter: StorageCounter):
    self.backend, self.protocol, self.counter = backend, protocol, counter

  def __getattr__(self, name):
    return getattr(self.backend, name)

  def put(self, key, data):
    self.counter.add(self.protocol, "up", len(data))
    return self.backend.put(key, data)

  def get(self, key):
    data = self.backend.get(key)
    self.counter.add(self.protocol, "down", len(data or b""))
    return data

  def get_range(self, key, start, length):
    data = self.backend.get_range(key, start, length)
    self.counter.add(self.protocol, "down", len(data or b""))
    return data


class MonotonicIds(dict):
  """A dict whose ``len`` counts every key ever set. The fakes name a new
  upload session ``<kind>-<len(sessions)>``: once one session completes,
  two concurrent ones could get the same name. Phase 12 uploads from
  several threads, so its fakes keep their sessions in one of these."""

  created = 0

  def __setitem__(self, key, value):
    self.created += 1
    super().__setitem__(key, value)

  def __len__(self):
    return self.created


def fake_servers():
  """The repo's fake GCS and S3 servers (``tests/fake_cloud_servers.py``),
  in this process. The S3 fake checks every signature with
  ``igneous_tpu.storage_s3.SigV4``, which it imports when a request comes
  in: that name is bound to the port's own module first, so that nothing
  of the JAX package is imported (the CPU tests hold the port's signer
  against the JAX package's verifier)."""
  import os

  from igneous_tpu_torch import storage_s3

  sys.modules.setdefault("igneous_tpu.storage_s3", storage_s3)
  tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
  if tests not in sys.path:
    sys.path.insert(0, tests)
  import fake_cloud_servers

  fake_cloud_servers.PAGE_SIZE = FAKE_PAGE_SIZE
  gcs = fake_cloud_servers.FakeCloudServer("gcs")
  s3 = fake_cloud_servers.FakeCloudServer("s3", s3_creds=("AKIACHIPSMOKE", "chip-smoke-secret"))
  for srv in (gcs, s3):
    srv.httpd.socket.listen(FAKE_BACKLOG)
    srv.state.sessions, srv.state.mpu = MonotonicIds(), MonotonicIds()
  return gcs, s3


def server_line(srvs: dict, counter: StorageCounter) -> str:
  """Requests each server logged since the last call, and the bytes up and
  down each protocol moved."""
  reqs = {}
  for name, srv in srvs.items():
    with srv.state.lock:
      reqs[name] = len(srv.state.requests)
      srv.state.requests.clear()
  return f"requests {json.dumps(reqs)}, bytes {json.dumps(counter.take())}"


def plane_counters() -> dict:
  from igneous_tpu_torch import telemetry

  return {k: v for k, v in sorted(telemetry.counters_snapshot().items())
          if k.startswith(("retries.", "integrity."))}


def stored_objects(srv, prefix: str) -> dict:
  """{key under ``prefix``: stored bytes} on a fake server, integrity
  sidecars, info and provenance left out."""
  from igneous_tpu_torch import integrity

  with srv.state.lock:
    items = list(srv.state.objects.items())
  out = {}
  for name, data in items:
    if name.startswith(prefix + "/"):
      key = name[len(prefix) + 1:]
      if not integrity.exempt(key):
        out[key] = bytes(data)
  return out


def check_envelope(label: str, path: str, objects: dict) -> int:
  """Every stored chunk has a manifest record whose digest is its bytes'."""
  from igneous_tpu_torch import integrity

  integrity.flush_all()
  man = integrity.load_manifest(path)
  bad = [k for k, data in objects.items()
         if k not in man or man[k]["digest"] != integrity.digest_hex(data)
         or man[k]["n"] != len(data)]
  if bad or not objects:
    fail(f"storage {label}: {len(bad)} of {len(objects)} stored chunks lack a matching "
         f"manifest record ({bad[:3]})")
  return len(objects)


def file_objects(root: str, mips) -> dict:
  """{"<mip key>/<file>": bytes} of a file:// layer's chunk files at ``mips``."""
  import os

  info = json.load(open(os.path.join(root, "info")))
  out = {}
  for mip in mips:
    key = info["scales"][mip]["key"]
    for name in os.listdir(os.path.join(root, key)):
      with open(os.path.join(root, key, name), "rb") as f:
        out[f"{key}/{name}"] = f.read()
  return out


def audit_cli(args, codes=(0,)):
  """``audit`` in this process: (exit code, output); fails outside ``codes``."""
  import contextlib
  import io

  from igneous_tpu_torch.cli import main as cli_main

  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rc = cli_main([str(a) for a in args])
  if rc not in codes:
    fail(f"`{' '.join(map(str, args))}` exited {rc}: {out.getvalue()[-2000:]}")
  return rc, out.getvalue()


def storage_phase(root, cp, cc, ce, torch, dev) -> dict:
  """Phase 12 on phase 3's layers (see the module docstring). Returns the
  pooling kernels' launches of (a)-(d)."""
  import os

  from igneous_tpu_torch import Volume, integrity, storage, telemetry
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.queues import FileQueue, LocalTaskQueue
  from igneous_tpu_torch.task_creation import create_downsampling_tasks

  t_phase = time.perf_counter()
  launches = {k: 0 for k in cp.LAUNCHES}
  gcs, s3 = fake_servers()
  srvs = {"gcs": gcs, "s3": s3}
  counter = StorageCounter()
  env = {
    "GCS_ENDPOINT_URL": gcs.endpoint, "S3_ENDPOINT_URL": s3.endpoint,
    "AWS_ACCESS_KEY_ID": "AKIACHIPSMOKE", "AWS_SECRET_ACCESS_KEY": "chip-smoke-secret",
    "IGNEOUS_S3_MULTIPART_THRESHOLD": str(S3_MULTIPART),
    "IGNEOUS_S3_MULTIPART_CHUNK": str(S3_MULTIPART),
  }
  prior = os.environ.copy()
  saved = {k: prior.get(k) for k in env}
  os.environ.update(env)
  storage.set_backend_wrapper(counter)
  try:
    with gcs, s3:
      try:
        # (a) the image crop on gs://, downsampled by a queue and execute --batch 4
        telemetry.reset_all()
        t0 = time.perf_counter()
        crop = Volume(f"file://{root}/image").download(Bbox((0, 0, 0), GS_CROP))
        gs_path, ref = "gs://chip-smoke/image", f"{root}/image_gs_ref"
        for path in (gs_path, f"file://{ref}"):
          Volume.from_numpy(crop, path, resolution=(8, 8, 40), chunk_size=GS_CHUNK,
                            compress="gzip")
        del crop
        t_up = time.perf_counter() - t0
        spec = f"fq://{root}/queue_gs"
        run_cli(["image", "downsample", gs_path, "--num-mips", GS_MIPS, "--chunk-size",
                 ",".join(map(str, GS_NEW_CHUNK)), "--memory", GS_TARGET, "--queue", spec])
        q = FileQueue(spec)
        if q.inserted != GS_TASKS:
          fail(f"storage gs: {q.inserted} tasks queued, expected {GS_TASKS}")
        gcs.state.fail_next = 2  # two 503s: the first requests retry
        zero_counts(cp, cc, ce)
        ledger_reset(torch, dev)
        t1 = time.perf_counter()
        text = run_cli(["execute", spec, "--batch", GS_TASKS, "-x", "--time"])
        wall = time.perf_counter() - t1
        launched = launch_counts(cp, cc, ce)
        snap = ledger_line("storage gs execute", wall, launched)
        stats = worker_summary(text, "storage gs")
        if stats["executed"] != GS_TASKS or stats["dispatches"] != 1 or stats["solo"] \
           or launched["pyramid2x2x1"] != 1 or launched["pool2x2x1"]:
          fail(f"storage gs: {json.dumps(stats)}, launches {launched}: expected one group "
               f"of {GS_TASKS} and one pyramid2x2x1 launch")
        for k in launches:
          launches[k] += launched[k]
        counters = plane_counters()
        if counters.get("retries.storage_http", 0) < 2:
          fail(f"storage gs: the injected 503s were not retried ({counters})")
        print(f"storage gs: upload {t_up:.3f} s ({GS_CROP[0]}x{GS_CROP[1]}x{GS_CROP[2]} uint8 "
              f"to gs:// and file://), execute --batch {GS_TASKS} {wall:.3f} s (busy "
              f"{100 * snap['busy_s'] / wall:.2f}%), {json.dumps(stats)}, launches "
              f"{json.dumps(launched)}, {server_line(srvs, counter)}, counters "
              f"{json.dumps(counters)}", flush=True)
        t1 = time.perf_counter()
        LocalTaskQueue(parallel=1).insert(create_downsampling_tasks(
          f"file://{ref}", mip=0, num_mips=GS_MIPS, chunk_size=GS_NEW_CHUNK,
          memory_target=GS_TARGET))
        t_ref = time.perf_counter() - t1
        want = file_objects(ref, range(GS_MIPS + 1))
        before = stored_objects(gcs, "image")
        if before != want:
          diff = sorted(set(before) ^ set(want)) or [k for k in want if before[k] != want[k]]
          fail(f"storage gs: {len(before)} chunks on gs://, {len(want)} on the file:// solo "
               f"route; differing {diff[:3]}")
        n = check_envelope("gs", gs_path, before)
        print(f"storage gs: {len(want)} chunks of mips 0-{GS_MIPS} byte for byte the file:// "
              f"solo route's ({t_ref:.3f} s), {n} with a matching manifest record; part wall "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        # (b) the segmentation crop on s3://, through LocalTaskQueue
        telemetry.reset_all()
        t0 = time.perf_counter()
        seg = Volume(f"file://{root}/segmentation").download(Bbox((0, 0, 0), S3_CROP))
        s3_path, sref = "s3://chip-smoke/segmentation", f"{root}/segmentation_s3_ref"
        for path in (s3_path, f"file://{sref}"):
          Volume.from_numpy(seg, path, resolution=(8, 8, 40), chunk_size=GS_CHUNK,
                            layer_type="segmentation", compress="gzip")
        del seg
        parts = sum("partNumber" in p for m, p, _a in s3.state.requests if m == "PUT")
        t_up = time.perf_counter() - t0
        walls = {}
        for path in (s3_path, f"file://{sref}"):
          zero_counts(cp, cc, ce)
          t1 = time.perf_counter()
          LocalTaskQueue(parallel=1).insert(create_downsampling_tasks(path, mip=0,
                                                                      num_mips=S3_MIPS))
          walls[path] = time.perf_counter() - t1
          launched = launch_counts(cp, cc, ce)
          if launched["pyramid2x2x1"] + launched["pool2x2x1"] < 1:
            fail(f"storage s3: no pooling kernel launched for {path} ({launched})")
          if path == s3_path:
            for k in launches:
              launches[k] += launched[k]
            s3_launched = launched
        got, want = stored_objects(s3, "segmentation"), file_objects(sref, range(S3_MIPS + 1))
        if got != want:
          fail(f"storage s3: {len(got)} chunks on s3://, {len(want)} on file://, not equal")
        if not parts:
          fail("storage s3: mip 0 went up in no multipart part")
        n = check_envelope("s3", s3_path, got)
        print(f"storage s3: upload {t_up:.3f} s ({S3_CROP[0]}x{S3_CROP[1]}x{S3_CROP[2]} uint64, "
              f"{parts} multipart parts), downsample {walls[s3_path]:.3f} s (file:// "
              f"{walls[f'file://{sref}']:.3f} s), launches {json.dumps(s3_launched)}, "
              f"{len(want)} chunks byte for byte the file:// route's, {n} with a matching "
              f"manifest record, {server_line(srvs, counter)}, counters "
              f"{json.dumps(plane_counters())}; part wall {time.perf_counter() - t0:.3f} s",
              flush=True)

        # (c) audit --heal on (a)'s layer
        telemetry.reset_all()
        t0 = time.perf_counter()
        vol = Volume(gs_path)
        intact = stored_objects(gcs, "image")
        with gcs.state.lock:
          for mip, chunk, how in DAMAGE:
            name = f"image/{vol.meta.key(mip)}/{chunk}.gz"
            data = gcs.state.objects[name]
            if how == "flip":
              gcs.state.objects[name] = data[:-9] + bytes([data[-9] ^ 0x01]) + data[-8:]
            elif how == "truncate":
              gcs.state.objects[name] = data[: len(data) // 2]
            else:
              del gcs.state.objects[name]
        spec = f"fq://{root}/queue_audit"
        rc, text = audit_cli(["audit", gs_path, "--queue", spec], codes=(2,))
        named = sorted(l for l in text.splitlines() if l.startswith("CORRUPT"))
        want = sorted(f"CORRUPT {'missing' if how == 'delete' else 'decode_error'} mip={mip} "
                      f"{vol.meta.key(mip)}/{chunk}" for mip, chunk, how in DAMAGE)
        if named != want:
          fail(f"storage audit: named {named}, expected {want}")
        t_audit = time.perf_counter() - t0
        zero_counts(cp, cc, ce)
        ledger_reset(torch, dev)
        t1 = time.perf_counter()
        rc, text = audit_cli(["audit", gs_path, "--heal", "--queue", spec])
        wall = time.perf_counter() - t1
        launched = launch_counts(cp, cc, ce)
        snap = ledger_line("storage audit --heal", wall, launched)
        rounds = [l for l in text.splitlines() if l.startswith("heal round")]
        report = storage.CloudFiles(gs_path).get_json("integrity/audit/report.json")
        if rounds != ["heal round 1: 3 findings -> 3 repair tasks"] or report["rounds"] != 2 \
           or report["findings"] or not report["complete"]:
          fail(f"storage audit --heal: exit {rc}, {text.splitlines()[-6:]}, report rounds "
               f"{report['rounds']}, findings {report['findings']}")
        if launched["pyramid2x2x1"] != 3:
          fail(f"storage audit --heal: launches {launched}, expected pyramid2x2x1 once a "
               f"repair task (3)")
        for k in launches:
          launches[k] += launched[k]
        healed = stored_objects(gcs, "image")
        if healed != intact:
          fail(f"storage audit --heal: the healed layer differs from its bytes before the "
               f"damage ({sorted(k for k in intact if healed.get(k) != intact[k])[:3]})")
        print(f"storage audit: exit 2 naming {named} ({t_audit:.3f} s); audit --heal: "
              f"{rounds[0]}, round 2 clean, exit {rc}, {report['chunks_checked']} chunks "
              f"checked, wall {wall:.3f} s (busy "
              f"{100 * snap['busy_s'] / wall:.2f}%), launches {json.dumps(launched)}, every "
              f"healed chunk its bytes before the damage; {server_line(srvs, counter)}, "
              f"counters {json.dumps(plane_counters())}", flush=True)
        name = f"image/{vol.meta.key(0)}/{UNHEALABLE_CHUNK}.gz"
        with gcs.state.lock:
          data = gcs.state.objects[name]
          gcs.state.objects[name] = data[:-9] + bytes([data[-9] ^ 0x01]) + data[-8:]
        t1 = time.perf_counter()
        rc, text = audit_cli(["audit", gs_path, "--mip", 0, "--heal", "--queue", spec],
                             codes=(2,))
        want_line = f"UNHEALABLE decode_error mip=0 {vol.meta.key(0)}/{UNHEALABLE_CHUNK}"
        if want_line not in text.splitlines():
          fail(f"storage audit: no `{want_line}` line in {text[-1000:]!r}")
        print(f"storage audit: a damaged mip-0 chunk reported `{want_line}`, exit {rc}, "
              f"{time.perf_counter() - t1:.3f} s; {server_line(srvs, counter)}; "
              f"part wall {time.perf_counter() - t0:.3f} s", flush=True)
      finally:
        # the buffered records of the fakes' layers, while they answer
        integrity.flush_all(swallow=True)
  finally:
    storage.set_backend_wrapper(None)
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
  print(f"storage: phase wall (a)-(c) {time.perf_counter() - t_phase:.1f} s", flush=True)

  # (d) the envelope's cost: the first ENVELOPE_TASKS of phase 3d's
  # pipelined image stream once in each mode
  t0 = time.perf_counter()
  name, target, _, _, mips = PIPELINED_RUNS[0]
  src = os.path.join(root, name)
  runs = {mode: [] for mode in ENVELOPE_MODES}
  for i, mode in enumerate(ENVELOPE_MODES):
    menv = ENVELOPE_MODES[mode]
    dst = os.path.join(root, f"{name}_envelope_{i}_{mode}")
    link_layer(src, dst)
    tasks = list(create_downsampling_tasks(f"file://{dst}", mip=0, num_mips=mips,
                                           memory_target=target))[:ENVELOPE_TASKS]
    telemetry.reset_all()
    zero_counts(cp, cc, ce)
    os.environ.update(menv)
    ledger_reset(torch, dev)
    t1 = time.perf_counter()
    try:
      LocalTaskQueue(parallel=1).insert(tasks)
      integrity.flush_all()
    finally:
      for k in menv:
        os.environ.pop(k, None)
    wall = time.perf_counter() - t1
    launched = launch_counts(cp, cc, ce)
    snap = ledger_line(f"storage envelope {mode}", wall, launched)
    if launched["pyramid2x2x1"] != ENVELOPE_TASKS:
      fail(f"storage envelope {mode}: launches {launched}, expected {ENVELOPE_TASKS}")
    for k in launches:
      launches[k] += launched[k]
    has_manifests = os.path.isdir(os.path.join(dst, "integrity", "manifests"))
    if has_manifests != (mode != "off"):
      fail(f"storage envelope {mode}: manifests {'written' if has_manifests else 'missing'}")
    n = mip_files_equal(src, dst, mips, complete=False)
    runs[mode].append((wall, 100 * snap["busy_s"] / wall, plane_counters()))
  print("storage envelope: " + "; ".join(
    f"{mode} wall {r[0][0]:.3f} s, busy {r[0][1]:.2f}%, counters {json.dumps(r[0][2])}"
    for mode, r in runs.items())
    + f"; each run's {n} chunk files of mips 1-{mips} phase 3's byte for byte; part wall "
      f"{time.perf_counter() - t0:.3f} s", flush=True)
  print(f"storage: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return launches


# ---------------------------------------------------------------------------
# sharded image scales (phase 13)

# (b): a crop of the segmentation (a quarter of it, at the origin) and the
# shard byte budget (--memory) of `image xfer --sharded` and `image
# downsample --sharded` on it: 8 shard files of 8 chunks at mip 0, then 4
# downsample tasks of 512x512x64 with 2 mips
SHARD_SEG_CROP = (1024, 1024, 64)
SHARD_SEG_MEMORY = 2**26
SHARD_SEG_MIPS = 2
SHARD_SEG_FILES = 8
SHARD_SEG_TASKS = 4
# (c): the crop of the smooth image downsampled with --isotropic (5 mips at
# its 8x8x40 nm: 2x2x1 twice, then 2x2x2)
ISO_CROP = (2048, 2048, 64)
ISO_KEYS = ["8_8_40", "16_16_40", "32_32_40", "64_64_80", "128_128_160", "256_256_320"]


def morton_id(pt, grid) -> int:
  """Neuroglancer's compressed morton code of a chunk's grid point: the
  bits of x, y and z interleaved, x lowest, each axis dropping out once
  its ceil(log2(grid)) bits are spent."""
  bits = [max(int(g) - 1, 0).bit_length() for g in grid]
  code = out = 0
  for j in range(max(bits)):
    for d in range(3):
      if j < bits[d]:
        code |= ((int(pt[d]) >> j) & 1) << out
        out += 1
  return code


def read_shard_file(data: bytes, spec: dict, name: str) -> dict:
  """{chunk id: chunk bytes} of one neuroglancer_uint64_sharded_v1 shard
  file of an image scale (identity hash), decoded here from the format,
  not by the port's ShardReader: the fixed index of (start, end) byte
  pairs a minishard, each minishard index (ids delta coded, each start
  relative to the previous chunk's end, sizes), then the chunks. Fails on
  an id listed twice or filed under the wrong minishard."""
  import gzip

  def unpack(raw, encoding):
    return gzip.decompress(raw) if encoding == "gzip" else raw

  n = 1 << spec["minishard_bits"]
  base = 16 * n
  fixed = np.frombuffer(data[:base], "<u8").reshape(n, 2)
  chunks = {}  # id -> its stored bytes, inflated on threads below
  for ms, (a, b) in enumerate(fixed.tolist()):
    if a == b:
      continue  # an empty minishard
    index = np.frombuffer(
      unpack(data[base + a : base + b], spec["minishard_index_encoding"]), "<u8"
    ).reshape(3, -1)
    end = 0
    for cid, delta, size in zip(np.cumsum(index[0]).tolist(), index[1].tolist(),
                                index[2].tolist()):
      start, end = end + delta, end + delta + size
      if cid in chunks or (cid >> spec["preshift_bits"]) % n != ms:
        fail(f"shard {name}: chunk id {cid} listed twice or in minishard {ms}")
      chunks[cid] = data[base + start : base + end]
  with ThreadPoolExecutor(8) as pool:
    return dict(zip(chunks, pool.map(
      lambda raw: unpack(raw, spec["data_encoding"]), chunks.values())))


def shard_chunks(path: str, mip: int) -> dict:
  """Every shard file of a sharded scale through ``read_shard_file``: fails
  unless each chunk id of the scale's grid is there exactly once, in the
  file its shard number names. Returns {grid point: chunk bytes} and the
  number of shard files."""
  import itertools
  import os

  from igneous_tpu_torch import Volume

  meta = Volume(path).meta
  spec = meta.sharding(mip)
  grid = -(-np.asarray(meta.volume_size(mip)) // np.asarray(meta.chunk_size(mip)))
  want = {morton_id(pt, grid): pt for pt in itertools.product(*(range(int(g)) for g in grid))}
  d = os.path.join(path[len("file://"):], meta.key(mip))
  digits = max(1, -(-spec["shard_bits"] // 4))
  got, files = {}, sorted(os.listdir(d))
  for name in files:
    with open(os.path.join(d, name), "rb") as f:
      chunks = read_shard_file(f.read(), spec, name)
    for cid, data in chunks.items():
      shard = (cid >> (spec["preshift_bits"] + spec["minishard_bits"])) % (1 << spec["shard_bits"])
      if cid in got or name != f"{shard:0{digits}x}.shard":
        fail(f"sharded {path} mip {mip}: chunk id {cid} twice or in {name} (shard {shard})")
      got[cid] = data
  if set(got) != set(want):
    fail(f"sharded {path} mip {mip}: {len(set(want) - set(got))} chunk ids of the grid "
         f"missing, {len(set(got) - set(want))} not of the grid")
  return {want[cid]: data for cid, data in got.items()}, len(files)


def same_mip0_chunks(src_dir: str, chunks: dict, chunk) -> None:
  """Each decoded mip-0 chunk byte for byte the source's chunk file (phase
  3's mip 0 is stored as uncompressed raw chunks, full at the origin)."""
  import os

  key = json.load(open(os.path.join(src_dir, "info")))["scales"][0]["key"]
  for pt, data in chunks.items():
    lo = [p * c for p, c in zip(pt, chunk)]
    name = "_".join(f"{a}-{a + c}" for a, c in zip(lo, chunk))
    with open(os.path.join(src_dir, key, name), "rb") as f:
      if f.read() != data:
        fail(f"sharded: the chunk at {lo} differs from {src_dir}'s {name}")


def same_mips(path: str, ref: str, mips) -> None:
  """Each mip of ``path`` read back through the port's Volume, voxel for
  voxel the same box of ``ref``'s same mip (phase 3's solo output; a crop
  at the origin holds a box of it)."""
  from igneous_tpu_torch import Volume

  for mip in mips:
    got, want = Volume(path, mip=mip), Volume(ref, mip=mip)
    if not want.bounds.contains_bbox(got.bounds) or not np.array_equal(
      got.download(got.bounds), want.download(got.bounds)
    ):
      fail(f"sharded {path} mip {mip}: differs from {ref}'s solo mip")


def crop_layer(src: str, dst: str, size) -> None:
  """A new layer at ``dst`` holding the crop [0, size) of ``src``'s mip 0:
  the chunk files inside it hard-linked, the info cut to mip 0 and
  ``size``."""
  import os

  info = json.load(open(os.path.join(src, "info")))
  info["scales"] = info["scales"][:1]
  info["scales"][0]["size"] = list(size)
  key = info["scales"][0]["key"]
  os.makedirs(os.path.join(dst, key))
  for name in os.listdir(os.path.join(src, key)):
    ends = [int(r.split("-")[1]) for r in name.split("_")]
    if all(e <= s for e, s in zip(ends, size)):
      os.link(os.path.join(src, key, name), os.path.join(dst, key, name))
  with open(os.path.join(dst, "info"), "w") as f:
    json.dump(info, f)


def sharded_phase(root, cp, cc, ce, torch, dev) -> dict:
  """Phase 13 on phase 3's layers: (a) the smooth image through `image xfer
  --sharded` (one task, one shard file) and `image downsample --sharded
  --num-mips 5` (one ImageShardDownsampleTask, one pyramid2x2x1 launch);
  (b) a 1024x1024x64 crop of the segmentation through `image xfer
  --sharded --memory M` (8 shard files) and `image downsample --sharded
  --memory M --queue fq://` (4 tasks) drained by `execute --batch 4` here,
  every member solo, once;
  (c) a 2048x2048x64 crop of the smooth image through `image downsample
  --isotropic`. Every shard file decoded by ``read_shard_file``, every
  chunk id there once; the mip-0 chunks the source's bytes; every mip read
  back through Volume, voxel for voxel phase 3's solo mips, or (c) the
  plain pyramid of the same schedule on the card. Each run prints its
  wall, stage split, the card's busy share (device ledger) and peak
  memory. Returns the pooling kernels' launches (counts set to 0 just
  before each run)."""
  import os

  from igneous_tpu_torch import Volume, chunk_cache, telemetry
  from igneous_tpu_torch.downsample_scales import near_isotropic_factor_sequence
  from igneous_tpu_torch.ops import pooling
  from igneous_tpu_torch.queues import FileQueue

  t_phase = time.perf_counter()
  launches = {k: 0 for k in cp.LAUNCHES}

  def run(label, args, card=True):
    """One command, timed; ``card=False``: a copy, which puts no work on
    the card (the ledger records none)."""
    zero_counts(cp, cc, ce)
    telemetry.reset_all()
    chunk_cache.clear()
    ledger_reset(torch, dev)
    t0 = time.perf_counter()
    text = run_cli(args)
    wall = time.perf_counter() - t0
    launched = launch_counts(cp, cc, ce)
    busy = ledger_line(f"sharded {label}", wall, launched)["busy_s"] if card else 0.0
    print(f"sharded {label}: wall {wall:.3f} s, card busy {100 * busy / wall:.2f}% "
          f"(ledger), peak card memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, "
          f"launches {json.dumps(launched)}, stages (thread-s) "
          f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
    if any(cc.LAUNCHES.values()) or any(ce.LAUNCHES.values()):
      fail(f"sharded {label}: a CCL or EDT kernel launched")
    for k in launches:
      launches[k] += cp.LAUNCHES[k]
    return text, launched

  # (a) the full-width image: one task a pass
  t0 = time.perf_counter()
  src, dst = f"file://{root}/smooth_image", f"file://{root}/smooth_sharded"
  _, launched = run("(a) image xfer --sharded", ["image", "xfer", src, dst, "--sharded"],
                    card=False)
  if any(launched.values()):
    fail(f"sharded (a): the transfer launched {launched}")
  chunks, nfiles = shard_chunks(dst, 0)
  if nfiles != 1:
    fail(f"sharded (a): {nfiles} shard files at mip 0, expected 1")
  same_mip0_chunks(os.path.join(root, "smooth_image"), chunks, (128, 128, 64))
  n0 = len(chunks)
  del chunks
  _, launched = run("(a) image downsample --sharded --num-mips 5",
                    ["image", "downsample", dst, "--sharded", "--num-mips", 5])
  if launched["pyramid2x2x1"] != 1 or launched["pool2x2x1"] != 0:
    fail(f"sharded (a): launches {launched}, expected one pyramid2x2x1 (one task, L=5)")
  method = Volume(dst).meta.refresh_provenance()["processing"][-1]["method"]
  if method["task"] != "ImageShardDownsampleTask" or method["num_mips"] != 5:
    fail(f"sharded (a): planned {method}")
  counts = [len(shard_chunks(dst, mip)[0]) for mip in range(1, 6)]
  same_mips(dst, src, range(1, 6))
  print(f"sharded (a): {n0} mip-0 chunks in one shard file, each the source's bytes; "
        f"mips 1-5 ({counts} chunks, each id once) voxel for voxel phase 3's solo mips; "
        f"part wall {time.perf_counter() - t0:.3f} s", flush=True)

  # (b) many shards through the worker, on a crop of the segmentation
  t0 = time.perf_counter()
  crop_layer(os.path.join(root, "segmentation"), os.path.join(root, "segmentation_crop"),
             SHARD_SEG_CROP)
  src, dst = f"file://{root}/segmentation_crop", f"file://{root}/segmentation_sharded"
  _, launched = run("(b) image xfer --sharded", ["image", "xfer", src, dst, "--sharded",
                                                "--memory", SHARD_SEG_MEMORY], card=False)
  if any(launched.values()):
    fail(f"sharded (b): the transfer launched {launched}")
  chunks, nfiles = shard_chunks(dst, 0)
  if nfiles != SHARD_SEG_FILES:
    fail(f"sharded (b): {nfiles} shard files at mip 0, expected {SHARD_SEG_FILES}")
  same_mip0_chunks(os.path.join(root, "segmentation_crop"), chunks, (128, 128, 64))
  del chunks
  spec = f"fq://{root}/queue_sharded"
  run_cli(["image", "downsample", dst, "--sharded", "--memory", SHARD_SEG_MEMORY,
           "--num-mips", SHARD_SEG_MIPS, "--queue", spec])
  queue = FileQueue(spec)
  if queue.enqueued != SHARD_SEG_TASKS:
    fail(f"sharded (b): {queue.enqueued} tasks queued, expected {SHARD_SEG_TASKS}")
  text, launched = run("(b) execute --batch 4", ["execute", spec, "--batch", 4, "-x", "--time"])
  got = worker_summary(text, "sharded (b)")
  if (got["executed"], got["solo"], got["batched"], got["dispatches"], got["failed"],
      got["group_fallbacks"]) != (SHARD_SEG_TASKS, SHARD_SEG_TASKS, 0, 0, 0, 0):
    fail(f"sharded (b): worker {got}, expected every member solo, once")
  if queue.completed != SHARD_SEG_TASKS or queue.enqueued != 0:
    fail(f"sharded (b): tallies {queue.completed} completed, {queue.enqueued} queued")
  if launched["pyramid2x2x1"] != SHARD_SEG_TASKS or launched["pool2x2x1"] != 0:
    fail(f"sharded (b): launches {launched}, expected pyramid2x2x1 once a member")
  files = [shard_chunks(dst, mip)[1] for mip in range(1, SHARD_SEG_MIPS + 1)]
  same_mips(dst, f"file://{root}/segmentation", range(1, SHARD_SEG_MIPS + 1))
  print(f"sharded (b): {SHARD_SEG_FILES} shard files at mip 0, each chunk the source's bytes; "
        f"{SHARD_SEG_TASKS} tasks, each completed once and solo (rounds {got['rounds']}); "
        f"mips 1-{SHARD_SEG_MIPS} in {files} shard files, voxel for voxel phase 3's mode "
        f"pyramid; part wall {time.perf_counter() - t0:.3f} s", flush=True)

  # (c) isotropic factors on a crop of the smooth image
  t0 = time.perf_counter()
  crop = os.path.join(root, "smooth_crop")
  crop_layer(os.path.join(root, "smooth_image"), crop, ISO_CROP)
  _, launched = run("(c) image downsample --isotropic",
                    ["image", "downsample", f"file://{crop}", "--isotropic"])
  vol = Volume(f"file://{crop}")
  keys = [s["key"] for s in vol.info["scales"]]
  if keys != ISO_KEYS:
    fail(f"sharded (c): scales {keys}, expected {ISO_KEYS}")
  if launched["pyramid2x2x1"] != 1:
    fail(f"sharded (c): launches {launched}, expected pyramid2x2x1 for the leading 2x2x1 run")
  factors = near_isotropic_factor_sequence((8, 8, 40), len(ISO_KEYS) - 1)
  x = torch.from_numpy(vol.download(vol.bounds)[..., 0].transpose(2, 1, 0)).to(dev)[None]
  refs = pooling._pyramid_impl(x.contiguous(), factors, "average", False)
  for mip, ref in enumerate(refs, start=1):
    got = Volume(f"file://{crop}", mip=mip)
    if not np.array_equal(got.download(got.bounds)[..., 0],
                          ref[0].cpu().numpy().transpose(2, 1, 0)):
      fail(f"sharded (c): mip {mip} differs from the plain pyramid of {factors}")
  del x, refs
  torch.cuda.empty_cache()
  print(f"sharded (c): factors {factors}, every mip voxel for voxel the plain pyramid on "
        f"the card; part wall {time.perf_counter() - t0:.3f} s", flush=True)
  print(f"sharded: phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)
  return launches


# ---------------------------------------------------------------------------
# contrast correction and the image surface (phase 14)

# the JAX package's CLAHE: OpenCV on the host, no TPU kernel
CLAHE_REPLACES = "igneous_tpu/tasks/contrast.py:245"
# a crop of phase 3's smooth image that the default CLAHE task grid
# (2048x2048x64) cuts into 4 tasks, edges, pads and sizes that do not
# divide by the grid among them; and a small crop for the host commands
CONTRAST_CROP = (2560, 2560, 64)
SURFACE_CROP = (512, 512, 64)
CLAHE_TASK, CLAHE_GRID, CLAHE_CLIP = (2048, 2048, 64), (8, 8), 40.0
EQUALIZE_SHAPE = (1280, 1280, 64)
ROI_THRESHOLD = 170
SPATIAL_PREFIX = "mesh_index2"


def clahe_kernel_phase(cl, clahe_ops, torch, dev, others=()):
  """The clahe kernel against clahe_plain on the card, bit for bit: the
  first default task's padded cutout of phase 14 (2304x2304x64 uint8, the
  smooth surrogate, grid 8, clip 40), the same cutout as uint16, a uint16
  stack whose extents do not divide by the grid, rows that divide and
  columns that do not, clip 0, a constant uint16 stack at clip 0 (one bin
  holds a whole tile) and a constant uint8 stack. Bound: the planes' bytes
  in and out over the memory rate; ``lut_mib``: the LUTs a launch writes
  and the blend gathers, beside it. ``kernel_mib``: the most the card held
  during one launch beyond what it held before, the output included;
  ``buffers_mib``: what the wrapper says a launch takes besides the output
  (a batch's LUTs, the weight tables). Each case is also timed against
  each (name, cuda_clahe of another copy of the package) of ``others`` in
  turns, with equal outputs."""
  rng = np.random.default_rng(14)
  img = smooth_image((2304, 2304, 64), rng, torch, dev)  # (x, y, z) F order
  planes = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 1, 0))).to(dev)
  # 16-bit planes: the smooth image's bytes as high bytes, random low bytes
  img16 = img.astype(np.uint16) * np.uint16(257)
  img16 += rng.integers(0, 257, img16.shape, dtype=np.uint16)
  planes16 = torch.from_numpy(np.ascontiguousarray(img16.transpose(2, 1, 0))).to(dev)
  del img, img16
  inputs = [
    ("uint8 grid 8 clip 40, the first task's padded cutout 2304x2304x64", planes, 40.0),
    ("uint16 grid 8 clip 40, the same cutout as uint16 2304x2304x64", planes16, 40.0),
    ("uint16 grid 8 clip 40, 1030x1030x16",
     planes16[:16, :1030, :1030].contiguous(), 40.0),
    ("uint8 grid 8 clip 40, rows 2304 divide, columns 2050 do not",
     planes[:, :2050].contiguous(), 40.0),
    ("uint8 grid 8 clip 0, 2304x2304x64", planes, 0.0),
    ("uint16 grid 8 clip 0, constant 40000, 2304x2304x16",
     torch.from_numpy(np.full((16, 2304, 2304), 40000, np.uint16)).to(dev), 0.0),
    ("uint8 grid 8 clip 40, constant 77, 2304x2304x64",
     torch.full_like(planes, 77), 40.0),
  ]
  cases = []
  for label, x, clip in inputs:
    def kernel(x=x, clip=clip):
      return cl.launch(x, clip, CLAHE_GRID)

    def plain(x=x, clip=clip):
      return clahe_ops.clahe_plain(x.permute(2, 1, 0), clip, CLAHE_GRID).permute(2, 1, 0)

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = kernel()
    torch.cuda.synchronize()
    kernel_mib = (torch.cuda.max_memory_allocated(dev) - held) / 2 ** 20
    again = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = max_abs_err([out, again], [ref, ref])
    del out, again, ref
    nbytes = 2 * x.numel() * x.element_size()
    g = cl.geometry(x.shape[2], x.shape[1], CLAHE_GRID, clip, cl.BINS[x.dtype])
    case = {
      "kernel": "clahe", "case": label, "max_abs_err": err, "kernel_mib": kernel_mib,
      "lut_mib": x.shape[0] * g.gy * g.gx * g.bins * x.element_size() / 2 ** 20,
      "buffers_mib": sum(cl.buffers(x.shape[0], g, x.element_size()).values()) / 2 ** 20,
      "ms": device_ms(kernel), "call_ms": cuda_ms(kernel, reps=10),
      "plain_ms": cuda_ms(plain, reps=2, warmup=1),
      "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
    }
    if others:
      case["against"] = against(
        kernel, [(nm, lambda m=m, x=x, clip=clip: m.launch(x, clip, CLAHE_GRID))
                 for nm, m in others])
      for rec in case["against"]:
        if not rec["equal"]:
          fail(f"clahe {label}: differs from {rec['against']}'s kernel")
    print("kernel " + json.dumps(case), flush=True)
    if err > TOLERANCE:
      fail(f"clahe {label}: max abs err {err} against its plain version")
    cases.append(case)
  del planes, planes16, inputs
  torch.cuda.empty_cache()
  return cases


def stretch_bounds(levels, clip_fraction: float):
  """(low, high) bins clipping ``clip_fraction`` of the mass a tail (the
  equalize command's own rule, written out here as the oracle)."""
  levels = np.asarray(levels)
  total = levels.sum()
  if total == 0:
    return 0, 255
  cdf = np.cumsum(levels) / total
  lower = int(np.searchsorted(cdf, clip_fraction))
  upper = int(np.searchsorted(cdf, 1.0 - clip_fraction))
  return lower, min(max(upper, lower + 1), 255)


def write_nrrd(path: str, arr: np.ndarray) -> None:
  header = (f"NRRD0004\ntype: uint8\ndimension: 3\nsizes: {' '.join(map(str, arr.shape))}\n"
            "encoding: raw\nendian: little\n\n").encode()
  with open(path, "wb") as f:
    f.write(header + np.asfortranarray(arr).tobytes(order="F"))


def surface_run(label, args, cp, cc, ce, cl, torch, dev, card=True):
  """One command of phase 14, timed, the launch counts set to 0 just
  before; ``card=False``: host work only (the ledger records none).
  Returns what it printed and its launches."""
  from igneous_tpu_torch import chunk_cache, telemetry

  zero_counts(cp, cc, ce, cl)
  telemetry.reset_all()
  chunk_cache.clear()
  ledger_reset(torch, dev)
  t0 = time.perf_counter()
  text = run_cli(args)
  wall = time.perf_counter() - t0
  launched = launch_counts(cp, cc, ce, cl)
  busy = 0.0
  if card:
    snap = ledger_line(f"surface {label}", wall, launched)
    busy = snap["busy_s"]
    if card_executes(snap, "clahe") != launched["clahe"]:
      fail(f"surface {label}: clahe executes {card_executes(snap, 'clahe')} on the "
           f"card, launches {launched['clahe']}")
  print(f"surface {label}: wall {wall:.3f} s, card busy {100 * busy / wall:.2f}% "
        f"(ledger), peak card memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, "
        f"launches {json.dumps(launched)}, stages (thread-s) "
        f"{json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  return text, launched


def surface_phase(root, cp, cc, ce, cl, clahe_ops, torch, dev) -> dict:
  """Phase 14 (a)-(d), (f), (g) on crops of phase 3's smooth image (see
  the module docstring). Returns the kernels' launches, each run's counts
  set to 0 just before it."""
  import os

  from scipy import ndimage

  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.lib import Bbox

  t_phase = time.perf_counter()
  launches = {k: 0 for k in launch_counts(cp, cc, ce, cl)}

  def run(label, args, card=True):
    text, launched = surface_run(label, args, cp, cc, ce, cl, torch, dev, card)
    for k, n in launched.items():
      launches[k] += n
    return text, launched

  crop_layer(os.path.join(root, "smooth_image"), os.path.join(root, "contrast_src"),
             CONTRAST_CROP)
  src = f"file://{root}/contrast_src"
  vol = Volume(src)
  data = vol.download(vol.bounds)[..., 0]  # (x, y, z)
  sx, sy, sz = CONTRAST_CROP

  # (a) the luminance levels: the JAX package's sampled columns, in numpy
  _, launched = run("(a) image contrast histogram", ["image", "contrast", "histogram", src])
  if any(launched.values()):
    fail(f"surface (a): a hand kernel launched {launched}")
  rng = np.random.default_rng(0)  # the task's seed: its offset's z
  patch = 256
  n = max(int(np.ceil(sx * sy * 0.01 / patch**2)), 1)
  xs = rng.integers(0, sx - patch + 1, size=n)
  ys = rng.integers(0, sy - patch + 1, size=n)
  hists = np.zeros((sz, 256), np.int64)
  for px, py in zip(xs, ys):
    col = data[px:px + patch, py:py + patch, :]
    for dz in range(sz):
      hists[dz] += np.bincount(col[:, :, dz].ravel(), minlength=256)
  levels = []
  for z in range(sz):
    with open(os.path.join(root, "contrast_src", "levels", "0", str(z))) as f:
      doc = json.load(f)
    want = {"levels": hists[z].tolist(), "bin_width": 1, "patch_size": [patch, patch, 1],
            "num_samples": n * patch * patch, "coverage_ratio": 0.01}
    if doc != want:
      fail(f"surface (a): levels/0/{z} differs from the numpy recomputation")
    levels.append(doc["levels"])
  print(f"surface (a): {sz} levels files equal to the numpy recomputation of {n} "
        f"sampled {patch}x{patch}x{sz} column(s)", flush=True)

  # (b) the stretch, in 4 tasks; the oracle per z in numpy float32
  dst = f"file://{root}/contrast_eq"
  _, launched = run("(b) image contrast equalize",
                    ["image", "contrast", "equalize", src, dst,
                     "--shape", ",".join(map(str, EQUALIZE_SHAPE))])
  if any(launched.values()):
    fail(f"surface (b): a hand kernel launched {launched}")
  got = Volume(dst)
  got = got.download(got.bounds)[..., 0]
  for z in range(sz):
    low, high = stretch_bounds(levels[z], 0.01)
    plane = data[:, :, z].astype(np.float32)
    want = (plane - np.float32(low)) / np.float32(max(high - low, 1)) * np.float32(255)
    want = np.clip(np.round(want + np.float32(0)), 0, 255).astype(np.uint8)
    if not np.array_equal(got[:, :, z], want):
      fail(f"surface (b): z {z} differs from the numpy stretch")
  del got
  print(f"surface (b): {len(os.listdir(os.path.join(root, 'contrast_eq', '8_8_40')))} "
        f"chunk files, every voxel the numpy stretch", flush=True)

  # (c) CLAHE at its defaults: every core against clahe_plain on the card
  dst = f"file://{root}/contrast_clahe"
  _, launched = run("(c) image contrast clahe", ["image", "contrast", "clahe", src, dst])
  tasks = int(np.prod([-(-s // t) for s, t in zip(CONTRAST_CROP, CLAHE_TASK)]))
  if launched["clahe"] != tasks or sum(launched.values()) != tasks:
    fail(f"surface (c): launches {launched}, expected clahe once in each of {tasks} tasks")
  out = Volume(dst)
  for tx in range(0, sx, CLAHE_TASK[0]):
    for ty in range(0, sy, CLAHE_TASK[1]):
      core = Bbox((tx, ty, 0), (min(tx + CLAHE_TASK[0], sx), min(ty + CLAHE_TASK[1], sy), sz))
      pad = np.asarray(core.size3()[:2]) // np.asarray(CLAHE_GRID)
      lo = np.maximum(np.asarray(core.minpt[:2]) - pad, 0)
      hi = np.minimum(np.asarray(core.maxpt[:2]) + pad, (sx, sy))
      cut = np.ascontiguousarray(data[lo[0]:hi[0], lo[1]:hi[1], :].transpose(2, 1, 0))
      ref = clahe_ops.clahe_plain(torch.from_numpy(cut).to(dev).permute(2, 1, 0),
                                  CLAHE_CLIP, CLAHE_GRID)
      a = np.asarray(core.minpt[:2]) - lo
      b = np.asarray(core.maxpt[:2]) - lo
      want = ref[a[0]:b[0], a[1]:b[1], :].cpu().numpy()
      if not np.array_equal(out.download(core)[..., 0], want):
        fail(f"surface (c): the task at {core} differs from clahe_plain on its cutout")
      del ref
  torch.cuda.empty_cache()
  print(f"surface (c): {tasks} tasks, every voxel clahe_plain on the card over the same "
        f"padded cutouts", flush=True)

  # (d) ROIs: 2x2x1 rounds until the plane fits 512^2 (three, to 320x320),
  # then 6-connected components
  text, launched = run("(d) image roi", ["image", "roi", src, "--threshold", ROI_THRESHOLD])
  rounds, (rx, ry) = 0, CONTRAST_CROP[:2]
  while rx * ry > 512**2:
    rounds, rx, ry = rounds + 1, (rx + 1) // 2, (ry + 1) // 2
  if (launched["pyramid2x2x1"] != min(rounds, 1) or launched["tile_resolve"] < 1
      or launched["clahe"]):
    fail(f"surface (d): launches {launched}, expected one pyramid2x2x1 (L={rounds}) "
         f"and tile_resolve")
  small = data
  if rounds:
    x = torch.from_numpy(np.ascontiguousarray(data.transpose(2, 1, 0))).to(dev)[None]
    small = cp.pyramid2x2x1_plain(x, rounds, "average")[-1][0].cpu().numpy().transpose(2, 1, 0)
    del x
    torch.cuda.empty_cache()
  labeled, _ = ndimage.label(small > ROI_THRESHOLD)
  res = np.asarray([8, 8, 40])
  scale = np.asarray([2**rounds, 2**rounds, 1])
  want_rois, want_info = [], []
  for sl in ndimage.find_objects(labeled):
    if np.prod([s.stop - s.start for s in sl]) < 100:
      continue
    mn = np.asarray([s.start for s in sl]) * scale * res
    mx = np.asarray([s.stop for s in sl]) * scale * res
    want_rois.append(f"Bbox({list(map(int, mn))}, {list(map(int, mx))})")
    want_info.append([int(v) for v in mn // res] + [int(v) - 1 for v in mx // res])
  lines = text.splitlines()
  if lines[:-1] != want_rois or lines[-1] != f"{len(want_rois)} ROI detected. info file updated.":
    fail("surface (d): the ROIs differ from scipy.ndimage's on the plain pyramid")
  if Volume(src).info["scales"][0].get("rois") != want_info:
    fail("surface (d): the info's rois differ from scipy.ndimage's")
  print(f"surface (d): {len(want_rois)} ROIs (of {labeled.max()} components) equal to "
        f"scipy.ndimage's, in its order, and in the info", flush=True)
  del data, labeled, small

  # (f) ingest a small crop from .npy and .nrrd; (g) reorder it, z reversed
  small = Volume(src).download(Bbox((0, 0, 0), SURFACE_CROP))[..., 0]
  npy, nrrd = os.path.join(root, "surface.npy"), os.path.join(root, "surface.nrrd")
  np.save(npy, small)
  write_nrrd(nrrd, small)
  for kind, path in (("npy", npy), ("nrrd", nrrd)):
    dst = f"file://{root}/created_{kind}"
    run(f"(f) image create .{kind}", ["image", "create", path, dst, "--resolution", "8,8,40",
                                      "--chunk-size", "128,128,1"], card=False)
    got = Volume(dst)
    if not np.array_equal(got.download(got.bounds)[..., 0], small):
      fail(f"surface (f): the layer created from .{kind} differs from the crop")
  mapping = os.path.join(root, "reverse_z.json")
  with open(mapping, "w") as f:
    json.dump({str(z): SURFACE_CROP[2] - 1 - z for z in range(SURFACE_CROP[2])}, f)
  dst = f"file://{root}/reordered"
  run("(g) image reorder", ["image", "reorder", f"file://{root}/created_npy", dst, mapping],
      card=False)
  got = Volume(dst)
  if not np.array_equal(got.download(got.bounds)[..., 0], small[:, :, ::-1]):
    fail("surface (g): the reordered layer is not the crop with z reversed")
  print("surface (f)-(g): both created layers and the reordered one read back equal",
        flush=True)
  print(f"surface: phase wall (a)-(d), (f), (g) {time.perf_counter() - t_phase:.1f} s",
        flush=True)
  return launches


def spatial_index_phase(root, cp, cc, ce, cl, torch, dev) -> float:
  """Phase 14 (e) on phase 5's mesh layer: `mesh spatial-index create`
  into a second prefix, each .spatial file (label order included) equal
  to a numpy oracle: the labels in numpy's order, each one's box from
  ndimage.find_objects. Returns the part's wall."""
  import gzip
  import os

  from scipy import ndimage

  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.lib import Bbox

  t0 = time.perf_counter()
  path = f"file://{root}/mesh_segmentation"
  run_args = ["mesh", "spatial-index", "create", path, "--mesh-dir", SPATIAL_PREFIX]
  _, launched = surface_run("(e) mesh spatial-index create", run_args, cp, cc, ce, cl,
                            torch, dev)
  if any(launched.values()):
    fail(f"surface (e): a hand kernel launched {launched}")
  vol = Volume(path)
  res = np.asarray(vol.resolution)
  bounds = vol.bounds
  files = 0
  for x0 in range(0, int(bounds.maxpt[0]), 448):
    for y0 in range(0, int(bounds.maxpt[1]), 448):
      for z0 in range(0, int(bounds.maxpt[2]), 448):
        cell = Bbox.intersection(Bbox((x0, y0, z0), (x0 + 448, y0 + 448, z0 + 448)), bounds)
        seg = vol.download(cell)[..., 0]
        uniq = np.unique(seg)
        dense = np.searchsorted(uniq, seg).astype(np.int32)
        want = {}
        for i, sl in enumerate(ndimage.find_objects(dense), start=1):
          if sl is None or uniq[i] == 0:
            continue
          mn = (np.asarray([s.start for s in sl]) + np.asarray(cell.minpt)) * res
          mx = (np.asarray([s.stop for s in sl]) + np.asarray(cell.minpt)) * res
          want[str(int(uniq[i]))] = [list(map(float, mn)), list(map(float, mx))]
        name = Bbox(cell.minpt * res, cell.maxpt * res).to_filename()
        with open(os.path.join(root, "mesh_segmentation", SPATIAL_PREFIX,
                               f"{name}.spatial.gz"), "rb") as f:
          doc = json.loads(gzip.decompress(f.read()))
        if list(doc.items()) != list(want.items()):
          fail(f"surface (e): {name}.spatial differs from the numpy oracle")
        files += 1
  wall = time.perf_counter() - t0
  print(f"surface (e): {files} .spatial files equal to the numpy oracle, keys in its order; "
        f"part wall {wall:.3f} s", flush=True)
  return wall


# ---------------------------------------------------------------------------
# frags and multires (phase 15)

# crops of phase 5's mesh layer (ids above 2^32, some at or above 2^63)
# and of phase 6's tube layer, each cut into 2 tasks; the mesh crop is the
# layer's far corner, whose largest label's simplification (one thread
# each, not divisible) is the shortest of the layer's four quarters
FRAGS_MESH_ORIGIN = (448, 224, 0)
FRAGS_MESH_CROP, FRAGS_MESH_TASK = (448, 224, 112), (224, 224, 112)
FRAGS_SKEL_CROP, FRAGS_SKEL_TASK = (256, 256, 128), (128, 256, 128)
FRAGS_SKEL_DIR = "skeletons_mip_0"  # the crop's skeleton dir (the factory's default)
# labels per shard file in the sharded merges, low enough for several files
FRAGS_MESH_LABELS_PER_SHARD, FRAGS_SKEL_LABELS_PER_SHARD = 16, 4
# no minimum finest-LOD cell: every label's multires mesh has nlod + 1 LODs
FRAGS_MIN_CHUNK = "0,0,0"
FRAGS_NLOD = 1

def crop_reingest(src: str, dst: str, size, origin=(0, 0, 0)) -> np.ndarray:
  """The crop [origin, origin + size) of the layer ``src`` written as a
  new layer at ``dst`` (same resolution, 64^3 chunks, uncompressed, its
  origin at 0). Returns it."""
  from igneous_tpu_torch import Volume
  from igneous_tpu_torch.lib import Bbox

  lo = np.asarray(origin)
  data = Volume(src).download(Bbox(lo, lo + np.asarray(size)))[..., 0]
  Volume.from_numpy(data, dst, resolution=(8, 8, 40), chunk_size=(64, 64, 64),
                    compress=None, layer_type="segmentation")
  return data


def frags_run(label: str, fn, modules, torch, dev, launches_expected, srv=None,
              programs=(), phase: str = "frags") -> dict:
  """One part of phase 15 (or, with ``phase``, 16), timed, the launch
  counts set to 0 just before and read just after: its wall, the card's
  busy share from the device ledger (none recorded: host work only), the
  peak card memory, its launches and stage split (phase 16's
  cross-section and repair seconds among the host stages), the requests
  the fake PCG server ``srv`` answered, and the card's executes of the
  device ``programs`` (the ledger's names), which must each run.
  ``launches_expected``: the hand kernels' launches it must make (the
  nonzero counts; on the CPU, where the plain versions run and count
  none, not checked). Returns the launches."""
  from igneous_tpu_torch import chunk_cache, telemetry
  from igneous_tpu_torch.observability.device import LEDGER

  zero_counts(*modules)
  telemetry.reset_all()
  chunk_cache.clear()
  card = dev.type == "cuda"
  if card:
    ledger_reset(torch, dev)
  requests = len(srv.requests) if srv is not None else 0
  t0 = time.perf_counter()
  fn()
  wall = time.perf_counter() - t0
  launched = launch_counts(*modules)
  busy, executes = 0.0, {}
  if card and LEDGER.snapshot() is not None:
    snap = ledger_line(f"{phase} {label}", wall, launched)
    busy = snap["busy_s"]
    executes = {name: card_executes(snap, name) for name in programs}
    if not all(executes.values()):
      fail(f"{phase} {label}: the device programs executed {executes}")
  if card and {k: v for k, v in launched.items() if v} != launches_expected:
    fail(f"{phase} {label}: launches {launched}, expected {launches_expected}")
  peak = torch.cuda.max_memory_allocated(dev) / 2**30 if card else 0.0
  extra = ""
  if srv is not None or programs:
    extra = (f"programs {json.dumps(executes)}, PCG requests "
             f"{(len(srv.requests) - requests) if srv is not None else 0}, ")
  print(f"{phase} {label}: wall {wall:.3f} s, card busy {100 * busy / wall:.2f}% (ledger), "
        f"peak card memory {peak:.3f} GiB, launches {json.dumps(launched)}, {extra}stages "
        f"(thread-s) {json.dumps(stage_split(telemetry.snapshot()))}", flush=True)
  return launched


def parse_multires_manifest(data: bytes, label: str):
  """(num_lods, fragment sizes in order) of a Neuroglancer multilod
  manifest; fails unless its layout accounts for every byte."""
  (num_lods,) = np.frombuffer(data, "<u4", 1, 24)
  num_lods = int(num_lods)
  pos = 28 + 16 * num_lods
  nfrags = np.frombuffer(data, "<u4", num_lods, pos).tolist()
  pos += 4 * num_lods
  sizes = []
  for n in nfrags:
    sizes += np.frombuffer(data, "<u4", n, pos + 12 * n).tolist()
    pos += 16 * n
  if pos != len(data):
    fail(f"multires {label}: a manifest of {len(data)} bytes lays out {pos}")
  return num_lods, sizes


def check_multires_label(label: str, manifest: bytes, frags: bytes, vqb: int) -> int:
  """A label's manifest parses to FRAGS_NLOD + 1 LODs whose fragment sizes
  sum to its fragment data, and every draco fragment decodes with the
  port's decoder to vertices inside the stored lattice [0, 2^vqb].
  Returns the fragment count."""
  from igneous_tpu_torch.mesh_io import decode_mesh

  num_lods, sizes = parse_multires_manifest(manifest, label)
  if num_lods != FRAGS_NLOD + 1:
    fail(f"multires {label}: {num_lods} LODs, not {FRAGS_NLOD + 1}")
  if sum(sizes) != len(frags):
    fail(f"multires {label}: fragment sizes sum to {sum(sizes)}, its data is {len(frags)}")
  pos = 0
  for size in sizes:
    mesh = decode_mesh(frags[pos : pos + size], "draco")
    pos += size
    if not len(mesh.faces) or mesh.vertices.min() < 0 or mesh.vertices.max() > 2**vqb:
      fail(f"multires {label}: a draco fragment decodes outside the lattice [0, 2^{vqb}] "
           f"or to no face")
  return len(sizes)


def check_sharded_multires(path: str, mdir: str, labels) -> tuple:
  """Every label of ``labels`` read back through the port's ShardReader
  from the sharded multires dir, its fragments the bytes before its
  manifest (the merge writes fragments first). Returns (shard files,
  fragments)."""
  from igneous_tpu_torch import CloudFiles
  from igneous_tpu_torch.sharding import ShardReader, ShardingSpecification

  cf = CloudFiles(path)
  info = cf.get_json(f"{mdir}/info")
  if info.get("@type") != "neuroglancer_multilod_draco":
    fail(f"multires: {mdir}/info is not a multilod draco info")
  spec = ShardingSpecification.from_dict(info["sharding"])
  reader = ShardReader(cf, spec, prefix=mdir)
  shards = sorted(k for k in cf.list(f"{mdir}/") if k.endswith(".shard"))
  stored = sorted(int(i) for sh in range(2**spec.shard_bits)
                  for i in reader.list_labels(sh).tolist())
  if stored != sorted(labels):
    fail(f"multires {mdir}: the shards hold {len(stored)} labels, the forge {len(labels)}")
  base = (1 << spec.minishard_bits) * 16
  nfrags = 0
  for label in stored:
    manifest = reader.get_chunk(label)
    shard = int(spec.shard_number(label))
    index = reader.minishard_index(shard, int(spec.minishard_number(label)))
    pos = int(np.searchsorted(index[0], np.uint64(label)))
    start = base + int(index[1, pos])
    total = sum(parse_multires_manifest(manifest, str(label))[1])
    frags = cf.get_range(f"{mdir}/{spec.shard_filename(shard)}", start - total, total)
    nfrags += check_multires_label(str(label), manifest, frags,
                                   info["vertex_quantization_bits"])
  return len(shards), nfrags


def frags_task_on_cpu(task, path: str, names, dev) -> dict:
  """Run ``task`` (a payload of the card's run) again on the CPU route,
  writing into the directory ``frags_cpu`` of the layer ``path``; returns
  that run's stored files ``names``."""
  from igneous_tpu_torch import set_device
  from igneous_tpu_torch.queues import deserialize

  payload = task.payload()
  field = "mesh_dir" if "mesh_dir" in payload["params"] else "skel_dir"
  payload["params"] = dict(payload["params"], **{field: "frags_cpu"})
  set_device("cpu")
  try:
    deserialize(payload).execute()
  finally:
    set_device(dev)
  stored = dir_files(path, "frags_cpu")
  return {n: stored.get(n) for n in names}


def frags_mesh_phase(root, cp, cc, ce, cl, torch, dev) -> float:
  """Phase 15 (a), (b) and the mesh half of (d), on a 448x224x112 crop of
  phase 5's layer (its corner at FRAGS_MESH_ORIGIN). (a) `mesh forge --sharded` in 2 tasks of 224x224x112
  (one .frags container a task; the first byte for byte the CPU route's),
  `mesh merge-sharded --nlod 1` through fq:// and `execute` into several
  shard files, every label read back and checked; (b) the legacy forge of
  the same crop (every .frags entry its gunzipped fragment), `mesh merge
  --nlod 1` (unsharded multires) and `mesh xfer --sharded --nlod 1` into a
  new layer, checked alike; (d) `mesh clean` of the legacy fragments and
  `mesh rm` of the multires files through the queue, the files left as
  counted. Returns the phase's wall."""
  import gzip

  from igneous_tpu_torch import CloudFiles, Volume
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.mesh_io import FragMap
  from igneous_tpu_torch.task_creation import create_meshing_tasks

  t_phase = time.perf_counter()
  mods = (cp, cc, ce, cl)
  src = f"file://{root}/mesh_segmentation"
  crops = {}
  for name in ("frags_sharded", "frags_legacy"):
    crops[name] = f"file://{root}/{name}"
    data = crop_reingest(src, crops[name], FRAGS_MESH_CROP, FRAGS_MESH_ORIGIN)
  labels = [int(v) for v in np.unique(data) if v != 0]
  high = sum(v >= 2**63 for v in labels)
  print(f"frags: mesh crop {FRAGS_MESH_CROP} at {FRAGS_MESH_ORIGIN} of phase 5's layer, "
        f"{len(labels)} labels, {high} at or above 2^63", flush=True)
  if not high or min(labels) < 2**32:
    fail("frags: the mesh crop lacks ids above 2^32 or at or above 2^63")
  del data
  shape = ",".join(map(str, FRAGS_MESH_TASK))
  q = f"fq://{root}/frags_queue"

  # (a) the sharded forge and merge
  path = crops["frags_sharded"]
  frags_run("(a) mesh forge --sharded", lambda: run_cli(
    ["mesh", "forge", path, "--sharded", "--shape", shape,
     "--simplify-parallel", MESH_SIMPLIFY_THREADS]), mods, torch, dev, {})
  mdir = Volume(path).info["mesh"]
  stored = dir_files(path, mdir)
  containers = [n for n in stored if n.endswith(".frags")]
  if len(containers) != 2 or any(n.count(":") for n in stored):
    fail(f"frags (a): {len(containers)} .frags containers, fragment files "
         f"{sum(n.count(':') == 2 for n in stored)}")
  tasks = list(create_meshing_tasks(path, shape=FRAGS_MESH_TASK, sharded=True,
                                    parallel=MESH_SIMPLIFY_THREADS))
  res = np.asarray(Volume(path).resolution, dtype=np.int64)
  first = Bbox(tasks[0].offset * res, (tasks[0].offset + tasks[0].shape) * res)
  key = f"{first.to_filename()}.frags"
  t0 = time.perf_counter()
  if frags_task_on_cpu(tasks[0], path, [key], dev)[key] != stored[key]:
    fail("frags (a): task 0's .frags differs between the card and the CPU route")
  fm = FragMap(stored[key])
  print(f"frags (a): task 0's .frags ({len(fm)} labels, {len(stored[key])} B) equal on "
        f"the card and the CPU route, {time.perf_counter() - t0:.1f} s", flush=True)
  in_frags = sorted({int(k) for n in containers for k in FragMap(stored[n]).keys().tolist()})
  if in_frags != labels:
    fail(f"frags (a): the containers hold {len(in_frags)} labels, the crop {len(labels)}")

  def merge_sharded():
    run_cli(["mesh", "merge-sharded", path, "--nlod", FRAGS_NLOD, "--min-chunk-size",
             FRAGS_MIN_CHUNK, "--max-labels-per-shard", FRAGS_MESH_LABELS_PER_SHARD,
             "--queue", q])
    run_cli(["execute", q, "-x", "-q"])

  frags_run("(a) mesh merge-sharded via the queue", merge_sharded, mods, torch, dev, {})
  nshards, nfrags = check_sharded_multires(path, mdir, labels)
  if nshards < 2:
    fail(f"frags (a): {nshards} shard file(s), expected at least 2")
  print(f"frags (a): {len(labels)} labels in {nshards} shard files, {nfrags} draco "
        f"fragments, every manifest {FRAGS_NLOD + 1} LODs, read back through ShardReader",
        flush=True)

  # (b) the legacy forge, its multires merge and the sharded transfer
  legacy = crops["frags_legacy"]
  frags_run("(b) mesh forge", lambda: run_cli(
    ["mesh", "forge", legacy, "--shape", shape,
     "--simplify-parallel", MESH_SIMPLIFY_THREADS]), mods, torch, dev, {})
  legacy_files = dir_files(legacy, mdir)
  fragments = [n for n in legacy_files if n.count(":") == 2]
  for name in containers:
    box = Bbox.from_filename(name)
    core = Bbox(box.minpt // res, box.maxpt // res).to_filename()
    fm = FragMap(stored[name])
    for label in fm.keys().tolist():
      blob = legacy_files.get(f"{label}:0:{core}.gz")
      if blob is None or gzip.decompress(blob) != fm.get(label):
        fail(f"frags (b): label {label}'s .frags entry differs from its legacy fragment")
  if len(fragments) != sum(len(FragMap(stored[n])) for n in containers):
    fail(f"frags (b): {len(fragments)} legacy fragments, .frags entries differ in number")
  print(f"frags (b): every one of {len(fragments)} .frags entries equals its gunzipped "
        f"legacy fragment", flush=True)
  dest = f"file://{root}/frags_xfer"
  # before `mesh merge --nlod`, which points the layer at its multires dir:
  # the transfer reads the dir the info names
  frags_run("(b) mesh xfer --sharded", lambda: run_cli(
    ["mesh", "xfer", legacy, dest, "--sharded", "--nlod", FRAGS_NLOD]),
    mods, torch, dev, {})
  xshards, xfrags = check_sharded_multires(dest, f"{mdir}_multires", labels)
  frags_run("(b) mesh merge --nlod", lambda: run_cli(
    ["mesh", "merge", legacy, "--nlod", FRAGS_NLOD, "--min-chunk-size",
     FRAGS_MIN_CHUNK]), mods, torch, dev, {})
  multires = Volume(legacy).info["mesh"]
  out = dir_files(legacy, multires)
  if sorted(n for n in out if n.endswith(".index")) != sorted(f"{v}.index" for v in labels):
    fail("frags (b): the unsharded multires dir lacks some label's manifest")
  vqb = json.loads(out["info"])["vertex_quantization_bits"]
  ufrags = sum(check_multires_label(str(v), out[f"{v}.index"], out[str(v)], vqb)
               for v in labels)
  print(f"frags (b): `mesh merge --nlod {FRAGS_NLOD}`: {len(labels)} labels, {ufrags} "
        f"draco fragments in {multires}/; `mesh xfer --sharded`: {xshards} shard files, "
        f"{xfrags} fragments, every label read back", flush=True)

  # (d) the @queueable deletions and the intermediates' clean
  cf = CloudFiles(legacy)
  before = len(list(cf.list(f"{mdir}/")))
  frags_run("(d) mesh clean", lambda: run_cli(["mesh", "clean", legacy, "--mesh-dir", mdir]),
            mods, torch, dev, {})
  left = sorted(k.split("/")[-1] for k in cf.list(f"{mdir}/"))
  spatial = sum(n.endswith(".spatial.gz") for n in legacy_files)
  if left != ["info"] or before != 1 + len(fragments) + spatial:
    fail(f"frags (d): mesh clean left {left[:5]} of {before} files")

  def rm():
    run_cli(["mesh", "rm", legacy, "--queue", q])
    run_cli(["execute", q, "-x", "-q"])

  frags_run("(d) mesh rm via the queue", rm, mods, torch, dev, {})
  left = sorted(k.split("/")[-1] for k in cf.list(f"{multires}/"))
  if left != ["info"]:
    fail(f"frags (d): mesh rm left {len(left)} files in {multires}/")
  print(f"frags (d): mesh clean deleted {before - 1} intermediate files ({len(fragments)} "
        f"fragments, {spatial} .spatial), mesh rm through the queue {2 * len(labels)} "
        f"multires files; each directory keeps its info", flush=True)
  wall = time.perf_counter() - t_phase
  print(f"frags: mesh parts wall {wall:.1f} s", flush=True)
  return wall


def frags_skeleton_phase(root, ce, cp, cc, cl, torch, dev) -> tuple:
  """Phase 15 (c) and the skeleton half of (d), on a 256x256x128 crop of
  phase 6's tube layer: the sharded skeleton forge (`skeleton forge
  --sharded`'s factory, with phase 6's SKEL_TRACE_THREADS tracing threads,
  which the command line does not set) in 2 tasks of 128x256x128 on the
  card (edt_pass 3 launches a task; task 0's .frags byte for byte the CPU
  route's), `skeleton spatial-index db`, `skeleton
  merge-sharded --spatial-index-db` (every label of the index read back
  from the shard files through ShardReader), then `skeleton xfer` of the
  layer through the queue (exactly the files of the label prefixes 1-9
  copied, byte for byte). Returns (edt_pass launches, the wall)."""
  from igneous_tpu_torch import CloudFiles, Volume
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.mesh_io import FragMap
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.sharding import ShardReader, ShardingSpecification
  from igneous_tpu_torch.skeleton_io import Skeleton
  from igneous_tpu_torch.spatial_index import SpatialIndex
  from igneous_tpu_torch.task_creation import create_skeletonizing_tasks

  t_phase = time.perf_counter()
  mods = (cp, cc, ce, cl)
  path = f"file://{root}/frags_skeletons"
  data = crop_reingest(f"file://{root}/skeleton_segmentation", path, FRAGS_SKEL_CROP)
  uniq, counts = np.unique(data, return_counts=True)
  print(f"frags: skeleton crop {FRAGS_SKEL_CROP} of phase 6's layer, {len(uniq) - 1} "
        f"labels, {int(((uniq >= 2**63) & (counts >= 1000)).sum())} of 1000+ voxels at or "
        f"above 2^63", flush=True)
  del data
  tasks = list(create_skeletonizing_tasks(path, shape=FRAGS_SKEL_TASK, sharded=True,
                                          parallel=SKEL_TRACE_THREADS))
  if len(tasks) != 2:
    fail(f"frags (c): expected 2 tasks, planned {len(tasks)}")
  launched = frags_run("(c) skeleton forge --sharded", lambda: LocalTaskQueue(
    parallel=1).insert(tasks), mods, torch, dev, {"edt_pass": 6})
  sdir = Volume(path).info["skeletons"]
  stored = dir_files(path, sdir)
  containers = [n for n in stored if n.endswith(".frags")]
  if len(containers) != 2 or any(n.endswith(".sk") or n.endswith(".sk.gz") for n in stored):
    fail(f"frags (c): {len(containers)} .frags containers")
  res = np.asarray(Volume(path).resolution, dtype=np.int64)
  first = Bbox(tasks[0].offset * res, (tasks[0].offset + tasks[0].shape) * res)
  key = f"{first.to_filename()}.frags"
  t0 = time.perf_counter()
  if frags_task_on_cpu(tasks[0], path, [key], dev)[key] != stored[key]:
    fail("frags (c): task 0's .frags differs between the card and the CPU route")
  print(f"frags (c): task 0's .frags ({len(FragMap(stored[key]))} labels, "
        f"{len(stored[key])} B) equal on the card and the CPU route, "
        f"{time.perf_counter() - t0:.1f} s", flush=True)

  db = f"{root}/frags_skeletons.db"
  frags_run("(c) skeleton spatial-index db", lambda: run_cli(
    ["skeleton", "spatial-index", "db", path, db]), mods, torch, dev, {})
  # no merge dust: every label the index names keeps a skeleton
  frags_run("(c) skeleton merge-sharded --spatial-index-db", lambda: run_cli(
    ["skeleton", "merge-sharded", path, "--spatial-index-db", db, "--dust-threshold", 0,
     "--max-labels-per-shard", FRAGS_SKEL_LABELS_PER_SHARD]), mods, torch, dev, {})
  cf = CloudFiles(path)
  labels = sorted(SpatialIndex.query_sqlite(db))
  if labels != sorted(SpatialIndex(cf, sdir).query()) or not labels:
    fail("frags (c): the sqlite index and the .spatial files name other labels")
  info = cf.get_json(f"{sdir}/info")
  reader = ShardReader(cf, ShardingSpecification.from_dict(info["sharding"]), prefix=sdir)
  vertices = 0
  for label in labels:
    blob = reader.get_chunk(label)
    if blob is None:
      fail(f"frags (c): label {label} of the index is not in the shard files")
    vertices += len(Skeleton.from_precomputed(blob, info["vertex_attributes"]).vertices)
  shards = sorted(n for n in dir_files(path, sdir) if n.endswith(".shard"))
  print(f"frags (c): every one of the {len(labels)} labels of the index (the db's and the "
        f".spatial files' alike) read back from {len(shards)} shard files, {vertices} "
        f"vertices", flush=True)

  # (d) the skeleton transfer through the queue
  q = f"fq://{root}/frags_queue"
  dest = f"file://{root}/frags_skeletons_copy"
  src_files = dir_files(path, sdir)

  def xfer():
    run_cli(["skeleton", "xfer", path, dest, "--queue", q])
    run_cli(["execute", q, "-x", "-q"])

  frags_run("(d) skeleton xfer via the queue", xfer, mods, torch, dev, {})
  copied = dir_files(dest, sdir)
  want = {n: v for n, v in src_files.items() if n[0] in "123456789"}
  if copied != want:
    fail(f"frags (d): skeleton xfer copied {len(copied)} files, expected {len(want)}")
  print(f"frags (d): skeleton xfer copied {len(copied)} of {len(src_files)} files (label "
        f"prefixes 1-9) byte for byte", flush=True)
  wall = time.perf_counter() - t_phase
  print(f"frags: skeleton parts wall {wall:.1f} s", flush=True)
  return launched["edt_pass"], wall


# ---------------------------------------------------------------------------
# graphene and cross-sections (phase 16)

# the chunk graph's chunk size: the graphene mesh factory's default task is
# twice it, 256x256x128
GRAPHENE_CHUNK = (128, 128, 64)
# a crop of phase 5's layer (its corner at the origin): 2 default graphene
# mesh tasks along x, 2 skeleton tasks
GRAPHENE_CROP = (384, 128, 64)
GRAPHENE_SKEL_TASK = (192, 128, 64)
# roots the graphene skeleton forge traces: the autapse's and the
# smallest others of 1000+ voxels
GRAPHENE_SKEL_ROOTS = 6
# new mips of the agglomerated transfer (mode pyramid2x2x1)
GRAPHENE_MIPS = 2
# the proofreading timeline (UNIX seconds): a merge, then a split; the runs
# read the state between them
T_MERGE, T_SPLIT, T_QUERY = 1_000_000, 2_000_000, 1_500_000
# labels of phase 15's tube crop the cross-section forge measures: the
# smallest of 1000+ voxels that cross its task boundary (the contact
# repair's host cost grows with each clipped vertex: one tube's repair
# takes most of the phase)
XSECTION_LABELS = 1


def graphene_watershed(labels: np.ndarray, chunk_size):
  """A watershed layer over (x, y, z) ``labels``: each label cut at the
  chunk-graph chunks and at the middle of each chunk along y into
  chunk-local supervoxels (ids above 2^32; those of labels at or above 2^63
  at or above 2^63 too). Each label's supervoxels are chained by edges in
  (chunk, half) order, so the two halves of a chunk are joined and a half
  is joined to the next chunk's other half: two touching supervoxels of one
  label in neighbouring chunks share no edge (an autapse). Returns
  (supervoxels, {sv: linear chunk index}, initial edges, {label: its
  supervoxels in chain order}, {label: voxels})."""
  # each voxel's (label rank, chunk, half) as one code: its order is the
  # order of (label, linear chunk index, half)
  grid = [np.arange(n) // c for n, c in zip(labels.shape, chunk_size)]
  nx, ny, nz = (int(g[-1]) + 1 for g in grid)
  local = (grid[2][None, None, :] * ny + grid[1][None, :, None]) * nx + grid[0][:, None, None]
  half = ((np.arange(labels.shape[1]) // (chunk_size[1] // 2)) % 2)[None, :, None]
  fg = labels != 0
  names, rank = np.unique(labels[fg], return_inverse=True)
  code = (rank.reshape(-1) * (nx * ny * nz) + np.broadcast_to(local, labels.shape)[fg]) * 2 \
    + np.broadcast_to(half, labels.shape)[fg]
  codes, inv = np.unique(code, return_inverse=True)
  lab = names[codes // (2 * nx * ny * nz)]
  loc = (codes // 2) % (nx * ny * nz)
  chunk = (loc % nx) + ((loc // nx) % ny << 20) + (loc // (nx * ny) << 40)
  ids = np.where(lab >= np.uint64(2**63), np.uint64(2**63 + 2**40), np.uint64(2**33)) \
    + np.arange(len(codes), dtype=np.uint64)
  sv = np.zeros(labels.shape, np.uint64, order="F")
  sv[fg] = ids[inv.reshape(-1)]
  pieces, sv_chunks = {}, {}
  for lb, c, s in zip(lab.tolist(), chunk.tolist(), ids.tolist()):
    pieces.setdefault(int(lb), []).append(int(s))
    sv_chunks[int(s)] = int(c)
  edges = [(p[i], p[i + 1]) for p in pieces.values() for i in range(len(p) - 1)]
  return sv, sv_chunks, edges, pieces, dict(zip(names.tolist(), np.bincount(rank).tolist()))


def graphene_phase(root, cp, cc, ce, cl, torch, dev) -> tuple:
  """Phase 16's graphene parts, on a GRAPHENE_CROP crop of phase 5's layer
  cut into chunk-local supervoxels (the watershed layer), whose chunk graph
  (the port's LocalChunkGraph: each label's pieces chained by edges, two
  touching labels merged at T_MERGE through pieces apart, so that the
  merged root touches itself with no edge, a label split at T_SPLIT) the
  repo's fake PyChunkGraph server (``tests/fake_pcg_server.py``) serves in
  this process, the layer addressed graphene://http://127.0.0.1:<port>/...
  as of T_QUERY: (a) the graphene mesh forge (2 GrapheneMeshTasks at the
  default task shape, draco .frags of L2 ids; task 0 again on the CPU
  route, the same .frags), (d) the agglomerated transfer with
  GRAPHENE_MIPS new mips (pyramid2x2x1 once; every chunk the CPU route's),
  (b) the skeleton forge with fix_autapses (the card's voxel graph of task
  0's cutout bit for bit its plain version), again from the materialized
  root layer of (d) (root_ids_cloudpath: the same fragments), task 0 on
  the CPU route, (e) the agglomerated census against numpy. Returns
  (pyramid2x2x1 launches, edt_pass launches, the wall)."""
  import os

  from igneous_tpu_torch import CloudFiles, Volume, graphene
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.mesh_io import FragMap
  from igneous_tpu_torch.ops.ccl import (
    voxel_connectivity_graph, voxel_connectivity_graph_plain,
  )
  from igneous_tpu_torch.queues import LocalTaskQueue
  from igneous_tpu_torch.task_creation import (
    create_graphene_meshing_tasks, create_skeletonizing_tasks, create_transfer_tasks,
    create_voxel_counting_tasks,
  )

  t_phase = time.perf_counter()
  mods = (cp, cc, ce, cl)
  tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
  if tests not in sys.path:
    sys.path.insert(0, tests)
  from fake_pcg_server import FakePCGServer

  labels = Volume(f"file://{root}/mesh_segmentation").download(
    Bbox((0, 0, 0), GRAPHENE_CROP))[..., 0]
  sv, sv_chunks, edges, pieces, sizes = graphene_watershed(labels, GRAPHENE_CHUNK)
  ws = f"file://{root}/graphene_watershed"
  Volume.from_numpy(sv, ws, resolution=(8, 8, 40), chunk_size=(64, 64, 64), compress=None,
                    layer_type="segmentation")
  graph = graphene.LocalChunkGraph(initial_edges=edges, chunk_size=GRAPHENE_CHUNK)
  # the merge joins the two smallest labels of 1000+ voxels in two chunks
  # or more (through their first and last supervoxels); the split cuts
  # the first supervoxel off the largest label
  small = sorted((n, lab) for lab, n in sizes.items() if n >= 1000 and len(pieces[lab]) >= 4)
  la, lb = small[0][1], small[1][1]
  graph.merge(pieces[la][0], pieces[lb][-1], T_MERGE)
  split = pieces[max(sizes, key=sizes.get)]
  graph.split([split[0]], split[1:], T_SPLIT)
  ids = np.unique(sv)
  print(f"graphene: watershed {GRAPHENE_CROP} of phase 5's layer, {len(ids) - 1} "
        f"supervoxels ({int((ids >= 2**63).sum())} at or above 2^63) of {len(pieces)} labels "
        f"in chunk-graph chunks of {GRAPHENE_CHUNK}, {len(edges)} edges, a merge at {T_MERGE} "
        f"and a split at {T_SPLIT}", flush=True)
  # the autapses: at T_QUERY roots that touch themselves across
  # supervoxels that share no edge
  roots = graph.get_roots(sv, T_QUERY)
  severed = voxel_connectivity_graph_plain(roots, 6) & ~graph.voxel_connectivity_graph(
    sv, 6, T_QUERY)
  autapses = set(np.unique(roots[severed != 0]).tolist()) - {0}
  merged_root = int(roots[labels == la][0])
  if not autapses or merged_root != int(roots[labels == lb][0]):
    fail(f"graphene: {len(autapses)} roots touch themselves without an edge; the merge "
         f"{'joined' if merged_root == int(roots[labels == lb][0]) else 'did not join'} "
         f"its labels")

  with FakePCGServer(graph, sv_chunks, data_dir=ws) as srv:
    gpath = f"graphene://{srv.base_url}"
    cf = CloudFiles(ws)

    # (a) the graphene mesh forge; simplification off (the QEM is phases
    # 5 and 15's; a graphene task simplifies on one thread)
    tasks = list(create_graphene_meshing_tasks(gpath, timestamp=T_QUERY, simplification=False))
    if len(tasks) != 2 or tuple(tasks[0].shape) != tuple(2 * c for c in GRAPHENE_CHUNK):
      fail(f"graphene (a): {len(tasks)} tasks of {tasks[0].shape}")
    frags_run("(a) graphene mesh forge", lambda: LocalTaskQueue(parallel=1).insert(tasks),
              mods, torch, dev, {}, srv, ("mesh.mc_count", "mesh.mc_emit", "graphene.pairs"),
              phase="graphene")
    mdir = Volume(ws).info["mesh"]
    stored = dir_files(ws, mdir)
    frags = sorted(n for n in stored if n.endswith(".frags"))
    if len(frags) != 2:
      fail(f"graphene (a): {len(frags)} .frags containers")
    l2 = sorted({k for n in frags for k in FragMap.frombytes(stored[n]).keys()})
    if not l2 or min(l2) < 2**40:
      fail(f"graphene (a): the meshes' labels are not L2 ids ({l2[:3]})")
    res = np.asarray(Volume(ws).resolution, dtype=np.int64)
    core = Bbox.intersection(Bbox(tasks[0].offset, tasks[0].offset + tasks[0].shape),
                             Volume(ws).bounds)
    key = f"{Bbox(core.minpt * res, core.maxpt * res).to_filename()}.frags"
    t0 = time.perf_counter()
    if frags_task_on_cpu(tasks[0], ws, [key], dev)[key] != stored[key]:
      fail("graphene (a): task 0's .frags differs between the card and the CPU route")
    print(f"graphene (a): {len(l2)} L2 meshes (ids above 2^40) in 2 .frags; task 0's "
          f"({len(FragMap.frombytes(stored[key]).keys())} meshes, {len(stored[key])} B) equal "
          f"on the card and the CPU route, {time.perf_counter() - t0:.1f} s", flush=True)

    # (d) the agglomerated transfer: roots as of T_QUERY, GRAPHENE_MIPS new mips
    dest = f"file://{root}/graphene_roots"
    kw = dict(agglomerate=True, timestamp=T_QUERY, shape=GRAPHENE_CROP,
              num_mips=GRAPHENE_MIPS, chunk_size=(64, 64, 64))
    launched = frags_run("(d) agglomerated transfer", lambda: LocalTaskQueue(
      parallel=1).insert(create_transfer_tasks(gpath, dest, **kw)), mods, torch, dev,
      {"pyramid2x2x1": 1}, srv, phase="graphene")
    pyramid = launched.get("pyramid2x2x1", 0)
    from igneous_tpu_torch import set_device

    set_device("cpu")
    try:
      cpu_roots = Volume(gpath).download(Bbox((0, 0, 0), GRAPHENE_CROP), agglomerate=True,
                                         timestamp=T_QUERY)[..., 0]
      LocalTaskQueue(parallel=1).insert(create_transfer_tasks(
        gpath, f"file://{root}/graphene_roots_cpu", **kw))
    finally:
      set_device(dev)
    if not np.array_equal(Volume(dest).download(Bbox((0, 0, 0), GRAPHENE_CROP))[..., 0],
                          cpu_roots):
      fail("graphene (d): the transferred roots differ from the CPU route's")
    info = Volume(dest).info
    nfiles = 0
    for scale in info["scales"][: GRAPHENE_MIPS + 1]:
      got = dir_files(dest, scale["key"])
      if got != dir_files(f"file://{root}/graphene_roots_cpu", scale["key"]) or not got:
        fail(f"graphene (d): the chunks of {scale['key']} differ from the CPU route's")
      nfiles += len(got)
    if not np.array_equal(np.unique(cpu_roots), np.unique(roots)):
      fail("graphene (d): the CPU route's roots are not the chunk graph's")
    print(f"graphene (d): {len(np.unique(cpu_roots)) - 1} roots (ids above 2^48), uint64 "
          f"layer, {nfiles} chunk files of mips 0-{GRAPHENE_MIPS} equal on the card and the "
          f"CPU route", flush=True)

    # (b) the skeleton forge with the autapse fix, as of T_QUERY, on the
    # autapse's root and the smallest others of 1000+ voxels
    uniq, counts = np.unique(cpu_roots, return_counts=True)
    by_size = [int(u) for u, c in sorted(zip(uniq.tolist(), counts.tolist()), key=lambda t: t[1])
               if u and c >= 1000 and u != merged_root]
    autapse = next(u for u in by_size if u in autapses)
    chosen = [merged_root, autapse] + [u for u in by_size if u != autapse][
      : GRAPHENE_SKEL_ROOTS - 2]
    skw = dict(shape=GRAPHENE_SKEL_TASK, fix_autapses=True, timestamp=T_QUERY,
               object_ids=chosen, parallel=SKEL_TRACE_THREADS)
    tasks = list(create_skeletonizing_tasks(gpath, skel_dir="skeletons_graphene", **skw))
    if len(tasks) != 2:
      fail(f"graphene (b): expected 2 tasks, planned {len(tasks)}")
    # the card's voxel graph of task 0's cutout (the chunk graph's edges)
    # against its plain version, bit for bit
    cut = sv[: tasks[0].shape[0] + 1, : tasks[0].shape[1], : tasks[0].shape[2]]
    # the chunk graph's edges at T_QUERY as codes of the supervoxels'
    # ranks: the plain version calls the predicate on whole shifted arrays
    n = len(ids)
    edge_codes = np.array(sorted(
      int(np.searchsorted(ids, np.uint64(a))) * n + int(np.searchsorted(ids, np.uint64(b)))
      for a, b in graph._edges_at(T_QUERY)), dtype=np.int64)

    def allowed(a, b):
      ra, rb = np.searchsorted(ids, a), np.searchsorted(ids, b)
      code = np.minimum(ra, rb).astype(np.int64) * n + np.maximum(ra, rb)
      return (a == b) | np.isin(code, edge_codes)

    t0 = time.perf_counter()
    card = voxel_connectivity_graph(cut, 26, allowed)
    t_card = time.perf_counter() - t0
    if not np.array_equal(card, voxel_connectivity_graph_plain(cut, 26, allowed)) or \
        not np.array_equal(voxel_connectivity_graph(cut, 26),
                           voxel_connectivity_graph_plain(cut, 26)):
      fail("graphene (b): the card's voxel graph differs from its plain version")
    print(f"graphene (b): the card's voxel_connectivity_graph of task 0's {cut.shape} cutout "
          f"(26-connected, the chunk graph's edges and label equality) bit for bit its plain "
          f"version, {t_card:.3f} s", flush=True)
    launched = frags_run("(b) skeleton forge --fix-autapses --timestamp", lambda: (
      LocalTaskQueue(parallel=1).insert(tasks)), mods, torch, dev, {"edt_pass": 6}, srv,
      phase="graphene")
    edt = launched["edt_pass"]
    launched = frags_run("(b) skeleton forge --fix-autapses --root-ids", lambda: (
      LocalTaskQueue(parallel=1).insert(create_skeletonizing_tasks(
        gpath, skel_dir="skeletons_rootids", root_ids_cloudpath=dest, **skw))),
      mods, torch, dev, {"edt_pass": 6}, srv, phase="graphene")
    edt += launched["edt_pass"]
    by_ts, by_ids = dir_files(ws, "skeletons_graphene"), dir_files(ws, "skeletons_rootids")
    if by_ts != by_ids or not any(n.endswith(".sk.gz") for n in by_ts):
      fail("graphene (b): the root-ids run's fragments differ from the timestamp run's")
    first = Bbox.intersection(Bbox(tasks[0].offset, tasks[0].offset + tasks[0].shape),
                              Volume(ws).bounds)
    names = sorted(n for n in by_ts if n.endswith(f":{first.to_filename()}.sk.gz"))
    t0 = time.perf_counter()
    if frags_task_on_cpu(tasks[0], ws, names, dev) != {n: by_ts[n] for n in names}:
      fail("graphene (b): task 0's fragments differ between the card and the CPU route")
    print(f"graphene (b): {sum(n.endswith('.sk.gz') for n in by_ts)} fragments of "
          f"{len(chosen)} roots (the merged one and one with an autapse among them), the "
          f"same files from the "
          f"root-ids layer; task 0's {len(names)} equal on the card and the CPU route, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (e) the census of the roots
    frags_run("(e) census --agglomerate", lambda: LocalTaskQueue(parallel=1).insert(
      create_voxel_counting_tasks(gpath, shape=GRAPHENE_CROP, agglomerate=True,
                                  timestamp=T_QUERY)), mods, torch, dev, {}, srv,
      phase="graphene")
    docs = [cf.get_json(k) for k in cf.list("stats/voxel_counts/0/")]
    want = {str(int(u)): int(c) for u, c in zip(uniq, counts)}
    if len(docs) != 1 or docs[0] != want:
      fail("graphene (e): the census differs from numpy's counts of the roots")
    print(f"graphene (e): the census of {len(want)} ids equals numpy's; the fake PCG server "
          f"answered {len(srv.requests)} requests in the phase", flush=True)
  wall = time.perf_counter() - t_phase
  print(f"graphene: graphene parts wall {wall:.1f} s", flush=True)
  return pyramid, edt, wall


def xsection_phase(root, ce, cp, cc, cl, torch, dev) -> tuple:
  """Phase 16 (c), on phase 15's tube crop (``frags_skeletons``): `skeleton
  forge --cross-section 1` (the contact repair on, unlimited) of its
  XSECTION_LABELS smallest labels of 1000+ voxels that cross the task
  boundary, 2 tasks of FRAGS_SKEL_TASK (edt_pass 3 launches a task); task
  0's fragments again on the CPU route, the same bytes; `skeleton merge`
  and `skeleton convert` to SWC (one file a merged skeleton, each read back
  with its vertex count). Returns (edt_pass launches, the wall)."""
  from igneous_tpu_torch import CloudFiles, Volume
  from igneous_tpu_torch.lib import Bbox
  from igneous_tpu_torch.skeleton_io import Skeleton, from_swc
  from igneous_tpu_torch.task_creation import create_skeletonizing_tasks

  t_phase = time.perf_counter()
  mods = (cp, cc, ce, cl)
  path = f"file://{root}/frags_skeletons"
  data = Volume(path).download(Bbox((0, 0, 0), FRAGS_SKEL_CROP))[..., 0]
  half = FRAGS_SKEL_TASK[0]
  uniq, counts = np.unique(data, return_counts=True)
  both = set(np.unique(data[:half]).tolist()) & set(np.unique(data[half:]).tolist())
  chosen = [int(u) for u, c in sorted(zip(uniq.tolist(), counts.tolist()), key=lambda t: t[1])
            if u and c >= 1000 and u in both][:XSECTION_LABELS]
  del data
  # `skeleton forge --cross-section 1 --cross-section-label-repair-sec -1`'s
  # factory call, with phase 6's tracing threads
  tasks = list(create_skeletonizing_tasks(
    path, shape=FRAGS_SKEL_TASK, cross_sectional_area=True, csa_smoothing_window=1,
    csa_repair_sec_per_label=-1, skel_dir="skeletons_csa", object_ids=chosen,
    parallel=SKEL_TRACE_THREADS))
  if len(tasks) != 2:
    fail(f"graphene (c): expected 2 tasks, planned {len(tasks)}")
  from igneous_tpu_torch.queues import LocalTaskQueue

  launched = frags_run("(c) skeleton forge --cross-section 1", lambda: LocalTaskQueue(
    parallel=1).insert(tasks), mods, torch, dev, {"edt_pass": 6}, phase="graphene")
  stored = dir_files(path, "skeletons_csa")
  first = Bbox.intersection(Bbox(tasks[0].offset, tasks[0].offset + tasks[0].shape),
                            Volume(path).bounds)
  names = sorted(n for n in stored if n.endswith(f":{first.to_filename()}.sk.gz"))
  if not names:
    fail("graphene (c): task 0 wrote no fragment")
  t0 = time.perf_counter()
  if frags_task_on_cpu(tasks[0], path, names, dev) != {n: stored[n] for n in names}:
    fail("graphene (c): task 0's fragments differ between the card and the CPU route")
  t_cpu = time.perf_counter() - t0
  attrs = CloudFiles(path).get_json("skeletons_csa/info")["vertex_attributes"]
  import gzip

  areas = np.concatenate([
    Skeleton.from_precomputed(gzip.decompress(v), attrs).extra_attributes["cross_sectional_area"]
    for n, v in stored.items() if n.endswith(".sk.gz")])
  print(f"graphene (c): labels {chosen}, {len(areas)} vertices: {int((areas > 0).sum())} "
        f"areas clean or repaired, {int(((areas < 0) & (areas != -1)).sum())} clipped at the "
        f"dataset boundary, {int((areas == -1).sum())} unmeasured; task 0's {len(names)} "
        f"fragments equal on the card and the CPU route, {t_cpu:.1f} s", flush=True)
  out_dir = f"{root}/swc"
  frags_run("(c) skeleton merge and convert", lambda: (
    run_cli(["skeleton", "merge", path, "--skel-dir", "skeletons_csa", "--dust-threshold", 0]),
    run_cli(["skeleton", "convert", path, out_dir, "--skel-dir", "skeletons_csa"])),
    mods, torch, dev, {}, phase="graphene")
  import os

  # the merged skeletons: <label>.gz (gzip files keep the extension on disk)
  merged = {n.split(".")[0]: v for n, v in dir_files(path, "skeletons_csa").items()
            if n.split(".")[0].isdigit() and ":" not in n}
  swc = sorted(os.listdir(out_dir))
  if not merged or swc != sorted(f"{n}.swc" for n in merged):
    fail(f"graphene (c): {len(swc)} SWC files for {len(merged)} merged skeletons")
  for n, blob in merged.items():
    skel = Skeleton.from_precomputed(gzip.decompress(blob), attrs)
    back = from_swc(open(os.path.join(out_dir, f"{n}.swc")).read())
    if len(back.vertices) != len(skel.vertices) or len(back.edges) != len(skel.edges):
      fail(f"graphene (c): {n}.swc holds another skeleton")
  print(f"graphene (c): {len(merged)} merged skeletons with cross-sections, each its SWC "
        f"file", flush=True)
  wall = time.perf_counter() - t_phase
  print(f"graphene: cross-section parts wall {wall:.1f} s", flush=True)
  return launched["edt_pass"], wall


# ---------------------------------------------------------------------------
# the journaled campaign (phase 17): the fleet observability plane

# 8 of phase 3d's image-stream tasks: the first two columns of phase 3's
# image (4096 wide) at the stream's 1024x1024x64 tasks with 3 mips
JOURNAL_XRANGE = "0,2048"
JOURNAL_TASKS = 8
JOURNAL_BATCH = 4
# the timed runs, in turns: spans on, spans off (IGNEOUS_TRACE_SAMPLE=0,
# which leaves the counters journaled), twice each
JOURNAL_TURNS = ("traced", "untraced", "untraced", "traced")
# the capture opens as the run begins and must outlast its downloads: the
# run took 2.0-3.4 s on the H100's host, and a 2 s window that closed
# before the first cutout arrived held no kernel
PROFILE_SEC = 8.0
PROFILE_WAIT_S = 60.0
JOURNAL_SPANS = 1000  # trace spans timed for the host cost of one


class FlushClock:
  """Seconds of ``Journal.flush`` on the thread that runs the worker loop
  (the poll loop's and the lease batcher's flushes), while installed."""

  def __init__(self):
    import threading

    from igneous_tpu_torch.observability import journal as journal_mod

    self.cls, self.seconds, self.count = journal_mod.Journal, 0.0, 0
    self.orig, self.thread = self.cls.flush, threading.get_ident()

  def __enter__(self):
    import threading

    clock, orig = self, self.orig

    def flush(journal, event=None):
      t0 = time.perf_counter()
      try:
        return orig(journal, event=event)
      finally:
        if threading.get_ident() == clock.thread:
          clock.seconds += time.perf_counter() - t0
          clock.count += 1

    self.cls.flush = flush
    return self

  def __exit__(self, *exc):
    self.cls.flush = self.orig


def journal_stats(spec: str, ntasks: int) -> dict:
  """A queue's journal: segments, bytes, records, records a task."""
  import os

  from igneous_tpu_torch.observability import journal as journal_mod

  path = f"file://{spec[len('fq://'):]}/journal"
  segs = journal_mod.list_segments(path)
  nbytes = sum(os.path.getsize(os.path.join(path[len("file://"):], s)) for s in segs)
  recs = list(journal_mod.read_records(path))
  kinds = {}
  for r in recs:
    kinds[r.get("kind")] = kinds.get(r.get("kind"), 0) + 1
  return {"segments": len(segs), "bytes": nbytes, "records": len(recs),
          "records_per_task": round(len(recs) / ntasks, 2), "kinds": kinds}


def journal_stream(root: str, label: str):
  """A new layer sharing phase 3's mip 0 and its 8 tasks through `image
  downsample --queue`. Returns (queue spec, layer dir, queue)."""
  import os

  from igneous_tpu_torch.queues import FileQueue

  name, target, _n, _shape, mips = PIPELINED_RUNS[0]
  dst = os.path.join(root, f"{name}_journal_{label}")
  link_layer(os.path.join(root, name), dst)
  spec = f"fq://{root}/queue_journal_{label}"
  run_cli(["image", "downsample", f"file://{dst}", "--num-mips", mips, "--memory", target,
           "--xrange", JOURNAL_XRANGE, "--queue", spec])
  q = FileQueue(spec)
  if q.inserted != JOURNAL_TASKS:
    fail(f"journal {label}: {q.inserted} tasks, expected {JOURNAL_TASKS}")
  return spec, dst, q


def trace_span_cost() -> float:
  """Host microseconds of one trace span (``trace.span`` under a sampled
  task context, recorded into its thread's buffer): JOURNAL_SPANS of them."""
  from igneous_tpu_torch.observability import trace

  trace.reset()
  ctx = trace.SpanContext(trace.new_id(), trace.new_id(), True)
  with trace.activate(ctx):
    t0 = time.perf_counter()
    for _ in range(JOURNAL_SPANS):
      with trace.span("chip_smoke.empty"):
        pass
    us = (time.perf_counter() - t0) / JOURNAL_SPANS * 1e6
  n = len(trace.drain_spans())
  if n != JOURNAL_SPANS:
    fail(f"journal: {n} of {JOURNAL_SPANS} trace spans recorded")
  return us


def scrape_metrics(port: int) -> dict:
  """One GET of the worker's /metrics: {sample name: value}."""
  import urllib.request

  with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
    text = r.read().decode()
  out = {}
  for line in text.splitlines():
    if line and not line.startswith("#"):
      name, value = line.rsplit(" ", 1)
      out[name] = float(value)
  return out


def metrics_scrape_run(root, spec, q) -> dict:
  """(b) ``execute --batch 4 --metrics-port 0 --drain-sentinel S`` in this
  process; once the queue has tallied every task, one scrape of its
  /metrics from another thread, then the sentinel: the worker drains
  (exit 83). The scrape's delivery counters (``igneous_device_fastpath_
  {batched,host}_total``, one a completed delivery) must equal the tasks
  completed, and the ``igneous_device_*`` gauges be there."""
  import contextlib
  import io
  import os
  import threading

  from igneous_tpu_torch import telemetry
  from igneous_tpu_torch.cli import main as cli_main
  from igneous_tpu_torch.observability import prom

  sentinel = os.path.join(root, "journal_drain")
  # the counters of this worker run only, as a new worker process has them
  telemetry.reset_all()
  got = {}

  def scraper():
    try:
      t0 = time.perf_counter()
      while q.completed < JOURNAL_TASKS or prom._SERVER is None:
        if time.perf_counter() - t0 > WORKER_START_S:
          got["error"] = f"{q.completed} tasks after {WORKER_START_S:.0f} s"
          return
        time.sleep(0.02)
      got["completed"] = q.completed
      got["metrics"] = scrape_metrics(prom._SERVER.port)
    except Exception as e:  # noqa: BLE001 - reported by the caller
      got["error"] = repr(e)
    finally:
      open(sentinel, "w").close()

  os.environ["IGNEOUS_PREEMPT_POLL_SEC"] = DRAIN_POLL_SEC
  os.environ["IGNEOUS_JOURNAL_FLUSH_SEC"] = "0"  # every round flushes: the gauges publish
  thread = threading.Thread(target=scraper, daemon=True)
  thread.start()
  out = io.StringIO()
  try:
    with contextlib.redirect_stdout(out):
      rc = cli_main(["execute", spec, "--batch", str(JOURNAL_BATCH), "--metrics-port", "0",
                     "--drain-sentinel", sentinel, "-q", "--lease-sec", str(WORKER_LEASE_SEC)])
  finally:
    os.environ.pop("IGNEOUS_PREEMPT_POLL_SEC", None)
    os.environ.pop("IGNEOUS_JOURNAL_FLUSH_SEC", None)
    thread.join(timeout=WORKER_EXIT_S)
  if "error" in got:
    fail(f"journal (b): no scrape: {got['error']}")
  if rc != 83:
    fail(f"journal (b): the drained worker exited {rc}, expected 83: {out.getvalue()[-2000:]}")
  will = json.loads(out.getvalue().splitlines()[-1])  # the drain's counters line
  if will["event"] != "drain" or will["executed"] != JOURNAL_TASKS:
    fail(f"journal (b): the drain's last will {will['event']}, {will['executed']} executed")
  m = got["metrics"]
  delivered = m.get("igneous_device_fastpath_batched_total", 0) + \
    m.get("igneous_device_fastpath_host_total", 0)
  gauges = sorted(k for k in m if k.startswith("igneous_device_") and not k.endswith(
    ("_total", "_sum", "_count")) and "_bucket" not in k)
  print(f"journal (b): one /metrics scrape of the running worker: {len(m)} samples, "
        f"deliveries {delivered:.0f} against {got['completed']} tasks the queue tallied, "
        f"device gauges {json.dumps({k: m[k] for k in gauges})}", flush=True)
  if delivered != got["completed"]:
    fail(f"journal (b): the scrape counts {delivered} deliveries, the queue {got['completed']}")
  for gauge in ("igneous_device_busy_ratio", "igneous_device_fastpath_ratio",
                "igneous_device_hbm_bytes_limit"):
    if gauge not in m:
      fail(f"journal (b): {gauge} missing from the scrape")
  return m


def check_profile(path: str) -> int:
  """(c) `profile ls` lists the capture, and its Chrome trace holds
  pyramid2x2x1 kernels on the card. Returns how many."""
  import os

  from igneous_tpu_torch.observability import device as device_mod

  t0 = time.perf_counter()
  while not device_mod.list_profiles(path) or device_mod._PROFILE_STATE["active"]:
    if time.perf_counter() - t0 > PROFILE_WAIT_S:
      fail(f"journal (c): no profile under {path} within {PROFILE_WAIT_S:.0f} s")
    time.sleep(0.05)
  keys = run_cli(["profile", "ls", "--journal", path]).split()
  if not keys or keys != device_mod.list_profiles(path):
    fail(f"journal (c): profile ls printed {keys}")
  events = json.load(open(os.path.join(path[len("file://"):], keys[0])))["traceEvents"]
  kernels = [e for e in events if e.get("cat") == "kernel"]
  pyr = [e for e in kernels if TRACE_NAMES["pyramid2x2x1"] in e.get("name", "")]
  print(f"journal (c): profile {keys[0]}: {len(events)} events, {len(kernels)} kernel "
        f"events on the card, {len(pyr)} of pyramid2x2x1 "
        f"({sum(e.get('dur', 0) for e in pyr):.1f} us)", flush=True)
  if not pyr:
    fail("journal (c): the profile holds no pyramid2x2x1 kernel on the card")
  return len(pyr)


def fleet_checks(spec: str, q) -> None:
  """(d) The fleet commands over the solo run's journal."""
  import contextlib
  import io
  import os

  import torch

  from igneous_tpu_torch.cli import main as cli_main
  from igneous_tpu_torch.observability import fleet

  path = f"file://{spec[len('fq://'):]}/journal"
  status = json.loads(run_cli(["fleet", "status", "--journal", path, "--json"]))
  print("journal (d): fleet status\n" + run_cli(["fleet", "status", "--journal", path]).rstrip(),
        flush=True)
  if status["tasks"] != q.completed or q.completed != JOURNAL_TASKS or q.enqueued or q.leased:
    fail(f"journal (d): status counts {status['tasks']} tasks, the queue "
         f"{q.completed} completed, {q.enqueued} enqueued, {q.leased} leased")
  top = run_cli(["fleet", "top", "--journal", path, "-n", "3"])
  print("journal (d): fleet top\n" + top.rstrip(), flush=True)
  devices = run_cli(["fleet", "devices", "--journal", path])
  report = json.loads(run_cli(["fleet", "devices", "--journal", path, "--json"]))
  print("journal (d): fleet devices\n" + devices.rstrip(), flush=True)
  last = max(report["workers"].values(), key=lambda r: r["ts"])
  ratio = f"{last['busy_ratio'] * 100:.1f}%"
  if torch.cuda.get_device_name() not in devices or ratio not in devices:
    fail(f"journal (d): fleet devices names no {torch.cuda.get_device_name()} or "
         f"no busy share {ratio}")
  # one task's trace: its pyramid2x2x1 execute span under its task span
  recs = fleet.load(path)
  task = next(r for r in recs if r.get("name") == "task")
  spans = fleet.trace_records(recs, task["trace"])
  dev = [s for s in spans if s["name"] == "device.execute" and s.get("kernel") == "pyramid2x2x1"]
  if not dev or any(s["parent"] != task["span"] for s in dev):
    fail(f"journal (d): trace {task['trace']} holds {len(dev)} pyramid2x2x1 spans, "
         f"not all under its task span")
  out = os.path.join(os.path.dirname(spec[len("fq://"):]), "journal_trace.json")
  lines = run_cli(["fleet", "trace", task["trace"], "--journal", path, "-o", out])
  print(f"journal (d): fleet trace {task['trace']}\n" + lines.rstrip(), flush=True)
  # render_trace: "<offset>ms <two spaces a level><name> [...]"
  rows = [l.split("ms ", 1)[1] for l in lines.splitlines() if "ms " in l]
  level = lambda row: (len(row) - len(row.lstrip())) // 2
  task_level = min(level(r) for r in rows if r.lstrip().startswith("task "))
  if not any(level(r) > task_level for r in rows if r.lstrip().startswith("device.execute ")):
    fail("journal (d): fleet trace prints no execute span under the task")
  doc = json.load(open(out))
  tracks = [e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"]
  if f"device {card_label()}" not in tracks:
    fail(f"journal (d): the Perfetto export has no device track ({tracks})")
  # `fleet check` exits 2 where it finds anomalies: they are printed, not failed on
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    rc = cli_main(["fleet", "check", "-q", spec, "--json"])
  report_h = json.loads(buf.getvalue())
  print(f"journal (d): fleet check exit {rc}, healthy {report_h['healthy']}, anomalies "
        f"{json.dumps(report_h['anomalies'])}, stragglers "
        f"{json.dumps(report_h['stragglers'])}, devices {json.dumps(report_h['devices'])}",
        flush=True)
  if rc not in (0, 2) or rc != (0 if report_h["healthy"] else 2):
    fail(f"journal (d): fleet check exited {rc}")
  # rollups against raw segments, in every count
  raw = fleet.status(fleet.load(path))
  compact = json.loads(run_cli(["fleet", "compact", "--journal", path, "--min-segments", "1"]))
  eff = json.loads(run_cli(["fleet", "status", "--journal", path, "--json"]))
  counts = lambda st: (st["tasks"], st["tasks_failed"], st["workers"], st["counters"],
                       {k: v["count"] for k, v in st["stages"].items()})
  if not compact["segments_compacted"] or counts(eff) != counts(raw):
    fail(f"journal (d): status from rollups {counts(eff)} against raw {counts(raw)}")
  gc = json.loads(run_cli(["fleet", "gc", "--journal", path, "--retain-sec", "0"]))
  print(f"journal (d): fleet compact {json.dumps(compact)}, status from rollups equal to raw "
        f"in every count ({eff['tasks']} tasks, {len(eff['stages'])} stages), fleet gc "
        f"{json.dumps(gc)}, Perfetto export {len(doc['traceEvents'])} events, tracks "
        f"{json.dumps(tracks)}", flush=True)


def journal_phase(root, cp, cc, ce, torch, dev) -> tuple:
  """Phase 17 (a)-(e) on phase 3's image. Returns (launches, wall)."""
  import os

  from igneous_tpu_torch.observability import trace
  from igneous_tpu_torch.queues import FileQueue

  t_phase = time.perf_counter()
  mods = (cp, cc, ce)
  launches = {k: 0 for m in mods for k in m.LAUNCHES}
  name, _target, _n, _shape, mips = PIPELINED_RUNS[0]
  # what the phases before recorded with no journal to take it: each
  # thread's buffer holds up to trace.MAX_SPANS_PER_THREAD, then drops
  print(f"journal: spans buffered with no journal before phase 17: "
        f"{trace.pending_spans()} pending, {trace.dropped_spans()} dropped", flush=True)
  span_us = trace_span_cost()

  def run(label, args, env=()):
    zero_counts(*mods)
    ledger_reset(torch, dev)
    trace.reset()  # this run's spans only
    for k, v in env:
      os.environ[k] = v
    try:
      spec, dst, q = journal_stream(root, label)
      with FlushClock() as clock:
        t0 = time.perf_counter()
        run_cli(["execute", spec, *args, "-q", "--lease-sec", WORKER_LEASE_SEC])
        wall = time.perf_counter() - t0
    finally:
      for k, _v in env:
        os.environ.pop(k, None)
    launched = launch_counts(*mods)
    for k, v in launched.items():
      launches[k] += v
    snap = ledger_line(f"journal {label}", wall, launched)
    stats = journal_stats(spec, JOURNAL_TASKS)
    if q.completed != JOURNAL_TASKS or q.enqueued or q.leased:
      fail(f"journal {label}: the queue tallied {q.completed} of {JOURNAL_TASKS}")
    row = {"wall_s": round(wall, 4), "busy_pct": round(100 * snap["busy_s"] / wall, 2),
           "flush_s": round(clock.seconds, 4), "flushes": clock.count, **stats,
           "launches": launched}
    print(f"journal {label}: {json.dumps(row)}", flush=True)
    return spec, dst, q, row

  # (a) the timed turns
  rows, dsts = [], {}
  for i, mode in enumerate(JOURNAL_TURNS):
    env = (("IGNEOUS_TRACE_SAMPLE", "0"),) if mode == "untraced" else ()
    spec, dsts[f"{mode}{i}"], q, row = run(f"{mode}{i}", ["--batch", JOURNAL_BATCH,
                                                         "--metrics-port", 0, "-x"], env)
    rows.append((mode, row))
    if (mode == "traced") != bool(row["kinds"].get("span")):
      fail(f"journal {mode}{i}: {row['kinds']} records")
  walls = {m: [r["wall_s"] for mm, r in rows if mm == m] for m in ("traced", "untraced")}
  print(f"journal (a): walls {json.dumps(walls)} s, trace span {span_us:.2f} us on the host "
        f"({JOURNAL_SPANS} spans)", flush=True)

  # (c) a profile requested before the solo run, which (d) reads
  spec, dsts["solo"], q = journal_stream(root, "solo")
  path = f"file://{spec[len('fq://'):]}/journal"
  run_cli(["profile", "capture", "--journal", path, "--duration", PROFILE_SEC])
  zero_counts(*mods)
  ledger_reset(torch, dev)
  trace.reset()
  with FlushClock() as clock:
    t0 = time.perf_counter()
    try:
      # --pipeline: each task's encodes and puts on the pool (and their
      # spans under the task), joined before its lease is deleted
      run_cli(["execute", spec, "-x", "-q", "--pipeline", "--lease-sec", WORKER_LEASE_SEC])
    finally:
      os.environ.pop("IGNEOUS_PIPELINE", None)  # --pipeline set it for spawned workers
    wall = time.perf_counter() - t0
  launched = launch_counts(*mods)
  for k, v in launched.items():
    launches[k] += v
  if launched["pyramid2x2x1"] != JOURNAL_TASKS:
    fail(f"journal solo: launches {launched}, expected {JOURNAL_TASKS} pyramid2x2x1")
  print(f"journal solo: wall {wall:.3f} s (a {PROFILE_SEC:.0f} s capture opened with it), "
        f"flush {clock.seconds:.4f} s in {clock.count} flushes, "
        f"{json.dumps(journal_stats(spec, JOURNAL_TASKS))}", flush=True)
  n_prof = check_profile(path)
  fleet_checks(spec, q)

  # (b) the scrape
  zero_counts(*mods)
  spec, dsts["scraped"], q = journal_stream(root, "scraped")
  metrics_scrape_run(root, spec, q)
  for k, v in launch_counts(*mods).items():
    launches[k] += v

  # (e) the same tasks through LocalTaskQueue, no journal, and every layer alike
  target = PIPELINED_RUNS[0][1]
  ref = os.path.join(root, f"{name}_journal_local")
  link_layer(os.path.join(root, name), ref)
  zero_counts(*mods)
  run_cli(["image", "downsample", f"file://{ref}", "--num-mips", mips, "--memory", target,
           "--xrange", JOURNAL_XRANGE])
  for k, v in launch_counts(*mods).items():
    launches[k] += v
  if os.path.exists(os.path.join(ref, "journal")):
    fail("journal (e): LocalTaskQueue wrote a journal")
  n = 0
  for label, dst in dsts.items():
    n = mip_files_equal(ref, dst, mips)
  print(f"journal (e): the {len(dsts)} journaled runs' layers ({', '.join(dsts)}) each "
        f"{n} chunk files of mips 1-{mips}, byte for byte the LocalTaskQueue run's; "
        f"{n_prof} profiled pyramid2x2x1 kernels", flush=True)
  wall = time.perf_counter() - t_phase
  print(f"journal: phase wall (a)-(e) {wall:.1f} s, launches {json.dumps(launches)}",
        flush=True)
  return launches, wall


def journal_skeleton_phase(root, ce, cp, cc) -> tuple:
  """Phase 17 (a), its skeleton group: phase 11's sharded skeleton forge of
  phase 15's tube crop (2 tasks) through `execute --batch 2`, journaled
  (one group, three edt_pass launches), its .frags phase 15's byte for
  byte. Returns (edt_pass launches, the wall)."""
  from igneous_tpu_torch.queues import FileQueue
  from igneous_tpu_torch.task_creation import create_skeletonizing_tasks

  t0 = time.perf_counter()
  path = f"file://{root}/frags_skeletons"
  spec = f"fq://{root}/queue_skeleton_journal"
  tasks = list(create_skeletonizing_tasks(path, shape=FRAGS_SKEL_TASK, sharded=True,
                                          skel_dir="skeletons_journal",
                                          parallel=SKEL_TRACE_THREADS))
  FileQueue(spec).insert_batch(tasks, total=len(tasks))
  zero_counts(cp, cc, ce)
  with FlushClock() as clock:
    t1 = time.perf_counter()
    run_cli(["execute", spec, "--batch", 2, "-x", "-q", "--lease-sec", WORKER_LEASE_SEC])
    wall = time.perf_counter() - t1
  launched = launch_counts(cp, cc, ce)
  frags = same_files(f"{root}/frags_skeletons/{FRAGS_SKEL_DIR}",
                     f"{root}/frags_skeletons/skeletons_journal",
                     keep=lambda n: n.endswith(".frags"))
  stats = journal_stats(spec, len(tasks))
  print(f"journal skeleton: {len(tasks)} tasks, wall {wall:.3f} s, flush "
        f"{clock.seconds:.4f} s in {clock.count} flushes, {json.dumps(stats)}, launches "
        f"{json.dumps(launched)}, {frags} .frags containers equal to phase 15's", flush=True)
  if launched["edt_pass"] != 3 or frags != 2 or not stats["kinds"].get("device"):
    fail(f"journal skeleton: launches {launched}, {frags} .frags, {stats['kinds']}")
  return launched["edt_pass"], time.perf_counter() - t0


# ---------------------------------------------------------------------------
# campaign survival (phase 18): straggler speculation, autoscale, work
# stealing, a flagged worker's paged split and the fleet simulator

# (a) S holds its ranges at a lease short enough to expire while it is
# stopped; the campaign runner ticks every second and calls S silent after 2 s
CAMPAIGN_HOLDER_LEASE_SEC = 8
CAMPAIGN_STALL_SEC = "2"
CAMPAIGN_TICK_SEC = 1
CAMPAIGN_MAX_WORKERS = 2
CAMPAIGN_MAX_WALL_SEC = 240
# (b) H renews every second (lease/3) and holds its prefetched round while
# it sleeps through the SleepTask that leads its range; T may claim a
# range held half a second and polls for 8 s
STEAL_HOLDER_LEASE_SEC = 3
STEAL_SLEEP_S = 6.0
STEAL_MIN_HELD_SEC = "0.5"
STEAL_THIEF_SEC = 8.0
STEAL_BATCH = 8
RAGGED_TASKS = 16  # phase 11 (b)'s: 256x256x64 over the 1000x1000x64 image, 2 mips


class EnvSet:
  """Set environment variables for a block and restore them after."""

  def __init__(self, **env):
    self.env, self.saved = env, {}

  def __enter__(self):
    import os

    prior = os.environ.copy()
    for k, v in self.env.items():
      self.saved[k] = prior.get(k)
      os.environ[k] = str(v)
    return self

  def __exit__(self, *exc):
    import os

    for k, v in self.saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v


def worker_id_of(pid: int) -> str:
  """The journal's worker id of a process on this host."""
  import socket

  return f"{socket.gethostname().split('.')[0] or 'worker'}-{pid}"


def journal_kernel_executes(jpath: str, name: str, skip=()) -> int:
  """A kernel's executes in the device records of a journal, summed over
  its workers but those in ``skip``."""
  from igneous_tpu_torch.observability import device as device_mod
  from igneous_tpu_torch.observability import fleet

  ledgers = device_mod.device_ledgers(fleet.load_effective(jpath))
  return sum(int((rec.get("kernels") or {}).get(name, {}).get("executes", 0))
             for worker, rec in ledgers.items() if worker not in skip)


def stop_process(proc) -> None:
  """Resume and kill a worker process the phase left behind."""
  import signal

  if proc.poll() is None:
    proc.send_signal(signal.SIGCONT)
    proc.kill()
    proc.wait()


def campaign_speculation(root, cp, cc, ce) -> dict:
  """Phase 18 (a): 8 of phase 3d's image-stream tasks in two ranges of 4
  (``IGNEOUS_QUEUE_SHARDS=2``); worker S leases and is stopped (SIGSTOP,
  a signal to this script's own child); ``campaign run --actuator local``
  twins S's silent ranges and its spawned workers finish the campaign on
  the card; S resumes and drains, its late acks fenced. Every chunk
  equals phase 17's LocalTaskQueue layer."""
  import os
  import signal

  from igneous_tpu_torch import telemetry
  from igneous_tpu_torch.observability import fleet
  from igneous_tpu_torch.queues import FileQueue

  here = os.path.dirname(os.path.abspath(__file__))
  name, target, _n, _shape, mips = PIPELINED_RUNS[0]
  dst = os.path.join(root, f"{name}_campaign")
  link_layer(os.path.join(root, name), dst)
  spec = f"fq://{root}/queue_campaign"
  jpath = f"file://{root}/queue_campaign/journal"
  with EnvSet(IGNEOUS_QUEUE_SHARDS=2):
    run_cli(["image", "downsample", f"file://{dst}", "--num-mips", mips, "--memory", target,
             "--xrange", JOURNAL_XRANGE, "--queue", spec])
  q = FileQueue(spec)
  if q.inserted != JOURNAL_TASKS or q.queue_files != 2:
    fail(f"campaign (a): {q.inserted} tasks in {q.queue_files} files, expected "
         f"{JOURNAL_TASKS} in 2 ranges")
  t0 = time.perf_counter()
  proc, out = start_worker(root, "campaign_straggler",
                           [spec, "--batch", 4, "--journal", jpath, "--lease-sec",
                            CAMPAIGN_HOLDER_LEASE_SEC])
  sid = worker_id_of(proc.pid)
  try:
    wait_for(lambda: any(r["holder"] == sid for r in q.range_leases()), WORKER_START_S,
             "worker S holding a range lease", proc)
    proc.send_signal(signal.SIGSTOP)
    held = sorted(r["count"] for r in q.range_leases() if r["holder"] == sid)
    t_stopped = time.perf_counter()
    telemetry.reset_all()
    with EnvSet(IGNEOUS_HEALTH_STALL_SEC=CAMPAIGN_STALL_SEC, PYTHONPATH=here):
      text = run_cli(["campaign", "run", "-q", spec, "--actuator", "local",
                      "--worker-arg", "--batch", "--worker-arg", 4,
                      "--worker-arg", "-q", "--tick-sec", CAMPAIGN_TICK_SEC,
                      "--min-workers", 0, "--max-workers", CAMPAIGN_MAX_WORKERS,
                      "--cooldown-sec", 0, "--max-wall-sec", CAMPAIGN_MAX_WALL_SEC, "--json"])
    t_campaign = time.perf_counter() - t_stopped
    issued = telemetry.counters_snapshot().get("speculation.issued", 0)
    proc.send_signal(signal.SIGCONT)
    proc.send_signal(signal.SIGTERM)
    straggler = finish_worker(proc, out, "campaign S", codes=(83, 0))
  finally:
    stop_process(proc)
  wall = time.perf_counter() - t0
  ticks = [json.loads(line) for line in text.strip().splitlines()]
  summary = ticks.pop()
  counters = fleet.status(fleet.load_effective(jpath))["counters"]
  exits = summary["actuator"]["exits"]
  won, fenced = q.speculation_won, q.speculation_fenced
  spawned_pyramids = journal_kernel_executes(jpath, "pyramid2x2x1", skip=(sid,))
  auto = {k: v for k, v in counters.items() if k.startswith("autoscale.")}
  row = {
    "wall_s": round(wall, 3), "campaign_s": round(t_campaign, 3), "held": held,
    "ticks": summary["ticks"], "actions": summary["actions"],
    "spawned": summary["actuator"]["spawned"], "exits": exits,
    "issued": issued, "won": won, "fenced": fenced,
    "journal": {k: counters.get(k, 0) for k in (
      "speculation.issued", "speculation.won", "speculation.fenced",
      "speculation.duplicate_ack", "speculation.deduped", "zombie.delete")},
    "autoscale": auto, "completed": q.completed, "spawned_pyramid2x2x1": spawned_pyramids,
    "straggler": straggler.strip().splitlines()[-1:] if straggler.strip() else [],
  }
  print(f"campaign (a): {json.dumps(row)}", flush=True)
  if q.completed != JOURNAL_TASKS or q.enqueued or q.leased or q.dlq_count:
    fail(f"campaign (a): the queue tallied {q.completed} of {JOURNAL_TASKS} "
         f"({json.dumps(q.depth_snapshot())})")
  if issued < 1 or won + fenced != issued:
    fail(f"campaign (a): speculation issued {issued}, won {won}, fenced {fenced}")
  if counters.get("speculation.won", 0) + counters.get("speculation.fenced", 0) != issued \
     or counters.get("speculation.issued", 0) != issued:
    fail(f"campaign (a): the journal's speculation counters {row['journal']} against "
         f"issued {issued}")
  if not auto.get("autoscale.scale_up") or not auto.get("autoscale.scale_down"):
    fail(f"campaign (a): autoscale counters {auto}: a scale-up and a scale-down must show")
  if not exits or set(exits) - {"83", "0"}:
    fail(f"campaign (a): the spawned workers exited {exits}")
  if spawned_pyramids < 1:
    fail("campaign (a): no pyramid2x2x1 launch in the spawned workers' device records")
  n = mip_files_equal(os.path.join(root, f"{name}_journal_local"), dst, mips)
  print(f"campaign (a): {n} chunk files of mips 1-{mips} byte for byte phase 17's "
        f"LocalTaskQueue layer", flush=True)
  row["jpath"] = jpath
  return row


def ragged_queue(root: str, label: str, lead=()):
  """Phase 11 (b)'s 16 ragged tasks into a new layer sharing phase 3's
  ragged mip 0, after the tasks in ``lead``, as one range. Returns (spec,
  layer dir, queue)."""
  import os

  from igneous_tpu_torch.queues import FileQueue
  from igneous_tpu_torch.task_creation import create_downsampling_tasks

  dst = os.path.join(root, f"ragged_image_{label}")
  link_layer(os.path.join(root, "ragged_image"), dst)
  tasks = list(create_downsampling_tasks(f"file://{dst}", mip=0, num_mips=2,
                                         memory_target=2**23))
  if len(tasks) != RAGGED_TASKS:
    fail(f"campaign {label}: {len(tasks)} ragged tasks, expected {RAGGED_TASKS}")
  spec = f"fq://{root}/queue_{label}"
  q = FileQueue(spec)
  with EnvSet(IGNEOUS_QUEUE_SHARDS=1):
    q.insert_batch(list(lead) + tasks, total=len(lead) + len(tasks))
  if q.queue_files != 1:
    fail(f"campaign {label}: {q.queue_files} queue files, expected one range")
  return spec, dst, q


def campaign_stealing(root, cp, cc, ce, torch, dev) -> tuple:
  """Phase 18 (b): holder H (a worker process, ``--batch 8 --lease-sec
  3``) leases a range led by a 6 s ``SleepTask`` and pre-leases its next
  round, which sits unstarted while H sleeps; thief T (``IGNEOUS_STEAL=1``,
  the lease batcher at batch 4 in this process) finds the queue empty,
  claims that range, and runs the tail H's next renewal releases, on the
  card. Returns (row, launches)."""
  import os

  from igneous_tpu_torch import telemetry
  from igneous_tpu_torch.observability import fleet
  from igneous_tpu_torch.parallel.lease_batcher import poll_batched
  from igneous_tpu_torch.queues import FileQueue
  from igneous_tpu_torch.tasks import SleepTask

  t0 = time.perf_counter()
  spec, dst, q = ragged_queue(root, "steal", lead=[SleepTask(STEAL_SLEEP_S)])
  ntasks = RAGGED_TASKS + 1
  jpath = f"file://{root}/queue_steal/journal"
  proc, out = start_worker(root, "campaign_holder",
                           [spec, "--batch", STEAL_BATCH, "-x", "--lease-sec",
                            STEAL_HOLDER_LEASE_SEC])
  hid = worker_id_of(proc.pid)
  try:
    # H holds its round and the next one it pre-leased
    wait_for(lambda: sum(r["holder"] == hid for r in q.range_leases()) >= 2, WORKER_START_S,
             "holder H holding two ranges", proc)
    zero_counts(cp, cc, ce)
    ledger_reset(torch, dev)
    telemetry.reset_all()
    thief = FileQueue(spec, worker_id="thief")
    t1 = time.perf_counter()
    with EnvSet(IGNEOUS_STEAL=1, IGNEOUS_STEAL_MIN_HELD_SEC=STEAL_MIN_HELD_SEC):
      executed, stats = poll_batched(
        thief, batch_size=4, lease_seconds=WORKER_LEASE_SEC,
        stop_fn=lambda executed, empty: empty and time.perf_counter() - t1 > STEAL_THIEF_SEC,
      )
    t_thief = time.perf_counter() - t1
    launched = launch_counts(cp, cc, ce)
    snap = ledger_line("campaign (b) thief", t_thief, launched)
    holder = worker_summary(finish_worker(proc, out, "campaign H"), "campaign H")
  finally:
    stop_process(proc)
  counters = fleet.status(fleet.load_effective(jpath))["counters"]
  steal = {k: counters.get(k, 0) for k in ("steal.granted", "steal.tasks", "steal.denied")}
  row = {
    "wall_s": round(time.perf_counter() - t0, 3), "thief_s": round(t_thief, 3),
    "thief_executed": executed, "steal_claims": stats["steal_claims"],
    "claims": telemetry.counters_snapshot().get("steal.claims", 0), **steal,
    "holder": holder, "completed": q.completed, "launches": launched,
    "busy_pct": round(100 * snap["busy_s"] / t_thief, 2),
  }
  print(f"campaign (b): {json.dumps(row)}", flush=True)
  if row["claims"] < 1 or stats["steal_claims"] < 1 or steal["steal.granted"] < 1 \
     or steal["steal.tasks"] < 1:
    fail(f"campaign (b): no steal claimed and granted: {row}")
  # H also runs the members granted away from its pre-leased round (their
  # acks are fenced), so only the thief's count is bounded below
  if executed < steal["steal.tasks"]:
    fail(f"campaign (b): the thief ran {executed} tasks of the {steal['steal.tasks']} granted")
  if q.completed != ntasks or q.enqueued or q.dlq_count:
    fail(f"campaign (b): the queue tallied {q.completed} of {ntasks}")
  if not (launched["pyramid2x2x1"] or launched["pool2x2x1"]):
    fail(f"campaign (b): the stolen tasks launched no kernel: {launched}")
  n = mip_files_equal(os.path.join(root, "ragged_image"), dst, 2)
  print(f"campaign (b): {n} chunk files of mips 1-2 byte for byte phase 3's (and phase "
        f"11 (b)'s)", flush=True)
  return row, launched


def campaign_paged_split(root, cp, cc, ce, torch, dev) -> tuple:
  """Phase 18 (c): worker F, named in ``<journal>/health/flags.json``
  before it leases, takes the 16 ragged tasks at batch 16: its 9 full
  members run in one ``pyramid2x2x1`` dispatch and it sheds the 7 clamped
  members, none of whose pages ran, back to the queue; a healthy worker G
  runs their ``pool2x2x1`` page rounds. Returns (row, launches)."""
  import os

  from igneous_tpu_torch.observability import health
  from igneous_tpu_torch.observability import journal as journal_mod
  from igneous_tpu_torch.parallel.lease_batcher import poll_batched
  from igneous_tpu_torch.queues import FileQueue

  t0 = time.perf_counter()
  spec, dst, q = ragged_queue(root, "split")
  jpath = f"file://{root}/queue_split/journal"
  health.write_flags(jpath, {"ts": time.time(), "flagged_workers": ["flagged-F"],
                             "autoscale": {"desired_workers": 1}})
  zero_counts(cp, cc, ce)
  ledger_reset(torch, dev)
  journal_mod.set_active(journal_mod.Journal(jpath, worker_id="flagged-F"))
  try:
    t1 = time.perf_counter()
    f_exec, f_stats = poll_batched(
      FileQueue(spec, worker_id="flagged-F"), batch_size=RAGGED_TASKS,
      lease_seconds=WORKER_LEASE_SEC, task_budget=RAGGED_TASKS,
      stop_fn=lambda executed, empty: empty or executed > 0,
    )
    t_f = time.perf_counter() - t1
  finally:
    journal_mod.flush_active(event="exit")
    journal_mod.set_active(None)
  f_launched = launch_counts(cp, cc, ce)
  snap_f = ledger_line("campaign (c) F", t_f, f_launched)
  shed = f_stats["paged_splits"]
  left = q.depth_snapshot()
  zero_counts(cp, cc, ce)
  ledger_reset(torch, dev)
  t1 = time.perf_counter()
  g_exec, g_stats = poll_batched(FileQueue(spec, worker_id="healthy-G"), batch_size=8,
                                 lease_seconds=WORKER_LEASE_SEC,
                                 stop_fn=lambda executed, empty: empty)
  t_g = time.perf_counter() - t1
  g_launched = launch_counts(cp, cc, ce)
  snap_g = ledger_line("campaign (c) G", t_g, g_launched)
  row = {
    "wall_s": round(time.perf_counter() - t0, 3), "F_s": round(t_f, 3), "G_s": round(t_g, 3),
    "F_executed": f_exec, "paged_splits": shed, "F_released": f_stats["released"],
    "F_dispatches": dict(f_stats["dispatches"]), "F_launches": f_launched,
    "queue_after_F": left, "G_executed": g_exec, "G_dispatches": dict(g_stats["dispatches"]),
    "G_launches": g_launched, "completed": q.completed,
    "busy_pct": round(100 * (snap_f["busy_s"] + snap_g["busy_s"]) / (t_f + t_g), 2),
  }
  print(f"campaign (c): {json.dumps(row)}", flush=True)
  if shed < 1 or f_stats["released"] != shed or left["enqueued"] != shed \
     or f_exec + shed != RAGGED_TASKS or f_stats["solo"] or f_stats["group_fallbacks"]:
    fail(f"campaign (c): F shed {shed} and executed {f_exec}: {row}")
  if f_launched["pyramid2x2x1"] != 1 or f_stats["dispatches"].get("downsample") != 1:
    fail(f"campaign (c): F's full members took {f_launched} launches, not one pyramid2x2x1")
  if g_exec != shed or not g_launched["pool2x2x1"] or g_stats["paged_splits"]:
    fail(f"campaign (c): G ran {g_exec} of the {shed} shed members: {g_launched}")
  if q.completed != RAGGED_TASKS or q.enqueued or q.dlq_count:
    fail(f"campaign (c): the queue tallied {q.completed} of {RAGGED_TASKS}")
  n = mip_files_equal(os.path.join(root, "ragged_image"), dst, 2)
  print(f"campaign (c): {n} chunk files of mips 1-2 byte for byte phase 3's (and (b)'s)",
        flush=True)
  launched = {k: f_launched[k] + g_launched[k] for k in f_launched}
  return row, launched


def campaign_simulation(root, jpath: str, wall: float) -> dict:
  """Phase 18 (d): (a)'s journal mined and simulated twice (``fleet
  simulate --workers 2 --seed 0 --speculate``): equal forecasts and
  equal emitted journal bytes; ``fleet status`` reads the emitted
  journal. The forecast's makespan is printed beside (a)'s wall."""
  import os

  runs = []
  for i in (1, 2):
    emit = f"file://{root}/campaign_sim{i}"
    text = run_cli(["fleet", "simulate", "--from-journal", jpath, "--workers", 2, "--seed", 0,
                    "--speculate", "--emit-journal", emit, "--json"])
    files = {}
    for base, _dirs, names in os.walk(emit[len("file://"):]):
      for n in names:
        path = os.path.join(base, n)
        with open(path, "rb") as f:
          files[os.path.relpath(path, emit[len("file://"):])] = f.read()
    runs.append((json.loads(text.replace(emit, "EMIT")), files))
  (a, fa), (b, fb) = runs
  if a != b or fa != fb or not fa:
    fail("campaign (d): two simulations of one journal, seed and config differ")
  status = run_cli(["fleet", "status", "--journal", f"file://{root}/campaign_sim1"])
  f = a["forecast"]
  row = {"tasks": f["tasks"], "predicted_s": f["makespan_sec"], "measured_s": round(wall, 3),
         "error_pct": round(100 * (f["makespan_sec"] - wall) / wall, 1) if wall else None,
         "speculation": f["speculation"], "segments": len(fa), "completed_all": f["completed_all"]}
  print(f"campaign (d): {json.dumps(row)}; fleet status of the emitted journal: "
        f"{status.strip().splitlines()[0]!r}", flush=True)
  return row


def campaign_phase(root, cp, cc, ce, torch, dev) -> tuple:
  """Phase 18 (a)-(d) on phase 3's image and ragged image. Returns
  (launches in this process, wall)."""
  t0 = time.perf_counter()
  launches = {k: 0 for m in (cp, cc, ce) for k in m.LAUNCHES}
  walls = {}
  t = time.perf_counter()
  a = campaign_speculation(root, cp, cc, ce)
  walls["a"] = time.perf_counter() - t
  t = time.perf_counter()
  b, launched = campaign_stealing(root, cp, cc, ce, torch, dev)
  walls["b"] = time.perf_counter() - t
  for k, v in launched.items():
    launches[k] += v
  t = time.perf_counter()
  c, launched = campaign_paged_split(root, cp, cc, ce, torch, dev)
  walls["c"] = time.perf_counter() - t
  for k, v in launched.items():
    launches[k] += v
  t = time.perf_counter()
  d = campaign_simulation(root, a["jpath"], a["campaign_s"])
  walls["d"] = time.perf_counter() - t
  wall = time.perf_counter() - t0
  print(f"campaign: phase wall {wall:.1f} s, parts {json.dumps({k: round(v, 1) for k, v in walls.items()})}, "
        f"workers (a) S + {a['spawned']} spawned, (b) H + this process, (c) this process "
        f"twice; busy (b) {b['busy_pct']}% (c) {c['busy_pct']}%; survival: issued {a['issued']} "
        f"won {a['won']} fenced {a['fenced']}, steal claims {b['claims']} granted "
        f"{b['steal.granted']} tasks {b['steal.tasks']}, paged splits {c['paged_splits']}; "
        f"simulated {d['predicted_s']} s against {d['measured_s']} s measured; launches "
        f"{json.dumps(launches)}", flush=True)
  return launches, wall


# ---------------------------------------------------------------------------
# serving and chaos (phase 19): mip synthesis on the card through the
# serving tier, a peer fill across two replicas, a downsample under faults

# (a) every mip-4 chunk of phase 3's image (a walk of 4 levels from mip 0),
# 16 of its mip-1 chunks and every mip-3 chunk of its segmentation (mode),
# at this many clients, then the same list again from the RAM tier
SERVE_CLIENTS = 16
SERVE_MIP1_CHUNKS = 16
# (b) mip-2 chunks of the image that (a)'s replica owns, each requested
# twice through the second replica
SERVE_FED_CHUNKS = 8
# (c) phase 3d's image stream on the first two columns of phase 3's image
# (8 tasks of 1024x1024x64, 3 mips), clean and under faults. get_corrupt on
# phase 3's uncompressed mip 0 would hand a task wrong voxels silently (a
# raw chunk carries nothing a reader can check), so the columns are
# re-ingested with gzip, whose CRC turns a flipped byte into a failed task
CHAOS_SEED = 19
CHAOS_FAULTS_PER_KIND = 6
CHAOS_LEASE_SEC = 3.0
CHAOS_BATCH = 4


def http_get(port: int, path: str):
  """(status, headers, body, seconds) of one GET with gzip accepted."""
  import http.client

  t0 = time.perf_counter()
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
  try:
    conn.request("GET", path, headers={"Accept-Encoding": "gzip"})
    resp = conn.getresponse()
    body = resp.read()
    return resp.status, dict(resp.getheaders()), body, time.perf_counter() - t0
  finally:
    conn.close()


def chunk_keys(root: str, name: str, mip: int) -> list:
  """The chunk keys of ``mip`` of phase 3's layer ``name`` (its offline
  chunk files, gzip), sorted."""
  import os

  from igneous_tpu_torch import Volume

  key = Volume(f"file://{root}/{name}").meta.key(mip)
  return sorted(f"{key}/{f[:-3]}" for f in os.listdir(os.path.join(root, name, key)))


def offline_bytes(root: str, name: str, key: str) -> bytes:
  import os

  with open(os.path.join(root, name, key + ".gz"), "rb") as f:
    return f.read()


def serve_requests(port, reqs, label: str, root: str) -> list:
  """``reqs`` ((layer, key) pairs) at SERVE_CLIENTS clients; fails unless
  each answer is 200 with the offline chunk's stored bytes. Returns
  (status, headers, body, seconds) in order."""
  with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
    out = list(pool.map(lambda lk: http_get(port, f"/{lk[0]}_serve/{lk[1]}"), reqs))
  for (name, key), (status, headers, body, _s) in zip(reqs, out):
    if status != 200 or headers.get("Content-Encoding") != "gzip":
      fail(f"serve {label}: {name} {key} answered {status} {headers}")
    if body != offline_bytes(root, name, key):
      fail(f"serve {label}: {name} {key} differs from phase 3's offline chunk")
  return out


def serve_phase(root, cp, cc, ce, torch, dev) -> tuple:
  """Phase 19 (a)-(b): phase 3's image and segmentation served from new
  layers that hold only their mip 0; the missing chunks synthesized on
  the card. Returns (launches, wall)."""
  import os

  from igneous_tpu_torch.observability import metrics
  from igneous_tpu_torch.serve import Federation, HashRing, ServeApp, ServeConfig, ServeServer

  t_phase = time.perf_counter()
  mods = (cp, cc, ce)
  for name in ("image", "segmentation"):
    link_layer(os.path.join(root, name), os.path.join(root, f"{name}_serve"), every_scale=True)
  layers = {f"{n}_serve": f"file://{root}/{n}_serve" for n in ("image", "segmentation")}
  mip1 = chunk_keys(root, "image", 1)
  reqs = ([("image", k) for k in chunk_keys(root, "image", 4)]
          + [("image", k) for k in mip1[::max(len(mip1) // SERVE_MIP1_CHUNKS, 1)]]
          + [("segmentation", k) for k in chunk_keys(root, "segmentation", 3)])
  metrics.reset_all()
  config = ServeConfig(ram_mb=4096.0, synth_mips=True)
  a = ServeServer(ServeApp(dict(layers), config=config), host="127.0.0.1", port=0)
  b = None
  try:
    port_a = a.server_address[1]
    # (a) the synthesis: every chunk once, then again from RAM
    zero_counts(*mods)
    ledger_reset(torch, dev)
    t0 = time.perf_counter()
    first = serve_requests(port_a, reqs, "(a)", root)
    wall_a = time.perf_counter() - t0
    launched = launch_counts(*mods)
    snap = ledger_line("serve (a)", wall_a, launched)
    tiers = sorted({h["X-Igneous-Cache"] for _s, h, _b, _t in first})
    if launched["pyramid2x2x1"] != len(reqs) or any(
        n for k, n in launched.items() if k != "pyramid2x2x1"):
      fail(f"serve (a): launches {launched} for {len(reqs)} synthesized chunks")
    zero_counts(*mods)
    t0 = time.perf_counter()
    again = serve_requests(port_a, reqs, "(a) repeated", root)
    wall_again = time.perf_counter() - t0
    if any(launch_counts(*mods).values()):
      fail(f"serve (a): the repeated requests launched {launch_counts(*mods)}")
    if {h["X-Igneous-Cache"] for _s, h, _b, _t in again} != {"ram"}:
      fail("serve (a): a repeated request missed the RAM tier")
    secs = np.array([t for _s, _h, _b, t in first])
    c = metrics.counters_snapshot()
    kinds = {k: sum(1 for r in reqs if (r[0], r[1].split("/")[0]) == k)
             for k in dict.fromkeys((r[0], r[1].split("/")[0]) for r in reqs)}
    print(f"serve (a): {len(reqs)} chunks ({', '.join(f'{n} {lk[0]} {lk[1]}' for lk, n in kinds.items())}; "
          f"image mip 4 from mip 0, segmentation by mode) at {SERVE_CLIENTS} clients: wall "
          f"{wall_a:.3f} s, request p50 {np.percentile(secs, 50) * 1e3:.1f} ms p99 "
          f"{np.percentile(secs, 99) * 1e3:.1f} ms (server p50 "
          f"{metrics.histogram_quantile('serve.request', 0.5) * 1e3:.1f} ms, p99 "
          f"{metrics.histogram_quantile('serve.request', 0.99) * 1e3:.1f} ms), tiers {tiers}, "
          f"launches {json.dumps(launched)}, synth {c.get('serve.synth', 0)}, card busy "
          f"{100 * snap['busy_s'] / wall_a:.2f}%; repeated: wall {wall_again:.3f} s, launches 0, ram hits "
          f"{c.get('serve.cache.ram.hits', 0)}, every chunk phase 3's offline bytes", flush=True)
    launches = dict(launched)

    # (b) the peer fill: B misses, asks its ring owner A, A synthesizes once
    b = ServeServer(ServeApp(dict(layers), config=config), host="127.0.0.1", port=0)
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in (a, b)]
    fed = Federation(peers=urls, timeout_ms=120000.0, retry_sec=30.0)
    fed.activate(urls[1])
    b.app.federation = fed
    ring = HashRing(urls)
    owned = [k for k in chunk_keys(root, "image", 2)
             if ring.owner("image_serve", k) == urls[0]][:SERVE_FED_CHUNKS]
    if len(owned) != SERVE_FED_CHUNKS:
      fail(f"serve (b): only {len(owned)} mip-2 chunks owned by (a)'s replica")
    zero_counts(*mods)
    c0 = metrics.counters_snapshot()
    t0 = time.perf_counter()
    fills = serve_requests(b.server_address[1], [("image", k) for k in owned] * 2, "(b)", root)
    wall_b = time.perf_counter() - t0
    launched = launch_counts(*mods)
    c1 = metrics.counters_snapshot()
    delta = {k: c1.get(k, 0) - c0.get(k, 0)
             for k in ("serve.peer.hits", "serve.peer.served", "serve.synth", "serve.peer.errors")}
    tiers = sorted({h["X-Igneous-Cache"] for _s, h, _b, _t in fills})
    if launched["pyramid2x2x1"] != SERVE_FED_CHUNKS or delta["serve.peer.errors"]:
      fail(f"serve (b): launches {launched}, counters {delta} for {SERVE_FED_CHUNKS} chunks")
    if delta["serve.synth"] != SERVE_FED_CHUNKS or delta["serve.peer.hits"] != SERVE_FED_CHUNKS:
      fail(f"serve (b): counters {delta}: each chunk synthesized once and filled once")
    print(f"serve (b): {2 * SERVE_FED_CHUNKS} requests for {SERVE_FED_CHUNKS} mip-2 chunks "
          f"owned by (a)'s replica through the second: wall {wall_b:.3f} s, tiers {tiers}, "
          f"launches {json.dumps(launched)}, counters {json.dumps(delta)}, every chunk phase 3's "
          f"offline bytes", flush=True)
    for k, n in launched.items():
      launches[k] += n
  finally:
    if b is not None:
      b.shutdown()
    a.shutdown()
  return launches, time.perf_counter() - t_phase


def budgeted_chaos(**rates):
  """Phase 19 (c)'s ``ChaosConfig``: each kind of fault fires at its rate
  until CHAOS_FAULTS_PER_KIND of it have fired in the run, and the crash
  between compute and upload fires once, on the first put of a mip-1
  chunk. A task reads 64 mip-0 chunks: with the per-key budget alone,
  get_corrupt at 0.1 fails nearly every delivery until each of them has
  faulted twice (some 20 deliveries a task)."""
  from dataclasses import dataclass, field

  from igneous_tpu_torch import telemetry
  from igneous_tpu_torch.chaos import ChaosConfig

  @dataclass
  class Config(ChaosConfig):
    crashed: str = ""
    fired: dict = field(default_factory=dict)

    def should_fault(self, op, key, rate):
      if op == "crash_put":
        if self.crashed or not key.startswith("16_16_40/"):
          return False
        self.crashed = key
        telemetry.incr("chaos.crash_put")
        return True
      if self.fired.get(op, 0) >= CHAOS_FAULTS_PER_KIND:
        return False
      hit = super().should_fault(op, key, rate)
      self.fired[op] = self.fired.get(op, 0) + int(hit)
      return hit

  return Config(**rates)


def chaos_phase(root, cp, cc, ce, torch, dev) -> tuple:
  """Phase 19 (c): phase 3d's image stream on the first two columns of
  phase 3's image, drained by this process's lease batcher clean and then
  under chaos_storage and ChaosQueue. Returns (launches, wall)."""
  import os

  from igneous_tpu_torch import Bbox, Volume, telemetry
  from igneous_tpu_torch.chaos import ChaosQueue, chaos_storage
  from igneous_tpu_torch.parallel.lease_batcher import poll_batched
  from igneous_tpu_torch.queues import FileQueue

  t_phase = time.perf_counter()
  mods = (cp, cc, ce)
  name, target, _n, _shape, mips = PIPELINED_RUNS[0]
  t0 = time.perf_counter()
  x1 = int(JOURNAL_XRANGE.split(",")[1])
  src = Volume(f"file://{root}/{name}")
  cols = src.download(Bbox((0, 0, 0), (x1, *src.meta.volume_size(0)[1:])))
  Volume.from_numpy(cols, f"file://{root}/chaos_src", resolution=(8, 8, 40),
                    chunk_size=tuple(src.meta.chunk_size(0)), compress="gzip")
  del cols
  t_ingest = time.perf_counter() - t0
  out = {}
  for label, cfg in (("clean", None), ("chaos", budgeted_chaos(
      seed=CHAOS_SEED, put_fail=0.2, get_corrupt=0.1, drop_delete=0.2,
      max_faults_per_key=2))):
    dst = os.path.join(root, f"chaos_{label}")
    link_layer(os.path.join(root, "chaos_src"), dst)
    spec = f"fq://{root}/queue_chaos_{label}"
    run_cli(["image", "downsample", f"file://{dst}", "--num-mips", mips, "--memory", target,
             "--queue", spec])
    q = FileQueue(spec, max_deliveries=25)
    if q.inserted != JOURNAL_TASKS:
      fail(f"chaos {label}: {q.inserted} tasks, expected {JOURNAL_TASKS}")
    telemetry.reset_all()
    zero_counts(*mods)
    ledger_reset(torch, dev)
    deadline = time.monotonic() + 240.0

    def stop(executed, empty):
      if time.monotonic() > deadline:
        fail(f"chaos {label}: the queue did not drain (enqueued {q.enqueued})")
      return empty and q.enqueued == 0

    t0 = time.perf_counter()
    if cfg is None:
      executed, stats = poll_batched(q, batch_size=CHAOS_BATCH, lease_seconds=CHAOS_LEASE_SEC,
                                     stop_fn=stop, max_backoff_window=0.2)
    else:
      with chaos_storage(cfg):
        executed, stats = poll_batched(ChaosQueue(q, cfg), batch_size=CHAOS_BATCH,
                                       lease_seconds=CHAOS_LEASE_SEC, stop_fn=stop,
                                       max_backoff_window=0.2)
    wall = time.perf_counter() - t0
    c = telemetry.counters_snapshot()
    faults = {k: v for k, v in c.items() if k.startswith("chaos.")}
    if not q.is_empty() or q.dlq_count or q.completed != JOURNAL_TASKS:
      last = [f["error"][:300] for r in q.dlq_ls()[:2] for f in r.get("failures", [])[-2:]]
      fail(f"chaos {label}: completed {q.completed}, dlq {q.dlq_count}, empty {q.is_empty()}, "
           f"last failures {last}")
    out[label] = dict(wall=wall, launches=launch_counts(*mods), faults=faults,
                      failed=c.get("tasks.failed", 0), executed=executed)
    ledger_line(f"chaos {label}", wall, out[label]["launches"])
    print(f"chaos {label}: {JOURNAL_TASKS} tasks at batch {CHAOS_BATCH}, lease "
          f"{CHAOS_LEASE_SEC} s: wall {wall:.3f} s, executions {executed}, failed deliveries "
          f"{out[label]['failed']}, faults fired {json.dumps(faults)}, launches "
          f"{json.dumps(out[label]['launches'])}", flush=True)
  if not out["chaos"]["faults"].get("chaos.crash_put") or len(out["chaos"]["faults"]) < 3:
    fail(f"chaos: faults {out['chaos']['faults']}: put, corrupt, crash_put and drop_delete "
         "should fire")
  if out["chaos"]["failed"] < 1:
    fail("chaos: no delivery failed: the faults were absorbed before the queue saw them")
  vol = Volume(f"file://{root}/chaos_clean")
  n = 0
  for mip in range(1, vol.meta.num_mips):
    key = vol.meta.key(mip)
    n += same_files(os.path.join(root, "chaos_clean", key), os.path.join(root, "chaos_chaos", key),
                    keep=lambda f: ".tmp." not in f)
  same_files(root + "/chaos_clean", root + "/chaos_chaos", keep=lambda f: f == "info")
  print(f"chaos: the faulted layer equals the clean one byte for byte ({n} chunk files of mips "
        f"1-{vol.meta.num_mips - 1}); ingest of the gzip columns {t_ingest:.1f} s", flush=True)
  launches = {k: out["clean"]["launches"][k] + out["chaos"]["launches"][k]
              for k in out["clean"]["launches"]}
  return launches, time.perf_counter() - t_phase



# ---------------------------------------------------------------------------
# phase 20: pods over torch.distributed (two ranks sharing the card over
# gloo; a one-rank NCCL group in this process)

POD_RANKS = 2
POD_IMAGE = (7, (1024, 1024, 64), 3)  # (a): cutouts of phase 3's image, size, mips
POD_SEGMENTATION = (3, (512, 512, 64), 3)  # (b): of phase 3's segmentation, by mode
POD_PAGE_MIPS = 3  # (c): phase 3's ragged image in pages, its mips
POD_TIMEOUT_S = 300.0


def pod_boxes(vol, n: int, size):
  """The first ``n`` cutouts of ``size`` on ``vol``'s mip-0 grid, x fastest."""
  from igneous_tpu_torch import Bbox

  X, Y, _Z = (int(v) for v in vol.meta.volume_size(0))
  sx, sy, sz = size
  return [Bbox((x, y, 0), (x + sx, y + sy, sz))
          for y in range(0, Y - sy + 1, sy) for x in range(0, X - sx + 1, sx)][:n]


def at_mip(box, mip: int):
  """A mip-0 box of (2, 2, 1) factors in mip ``mip``'s voxels."""
  from igneous_tpu_torch import Bbox

  f = np.array([2 ** mip, 2 ** mip, 1])
  return Bbox(np.asarray(box.minpt) // f, np.asarray(box.maxpt) // f)


def stored_zyx(path: str, mip: int, box) -> np.ndarray:
  """Phase 3's stored mip ``mip`` of ``box`` (mip-0 voxels) as (c, z, y, x)."""
  from igneous_tpu_torch import Volume

  return Volume(path, mip=mip).download(at_mip(box, mip)).transpose(3, 2, 1, 0)


def pod_rank(root: str, report_path: str) -> int:
  """One rank of phase 20's pod, started by ``pod_phase`` with the rank's
  ``IGNEOUS_COORDINATOR``, ``IGNEOUS_NUM_PROCESSES`` and
  ``IGNEOUS_PROCESS_ID``: (a) ``ChunkExecutor.run_global`` on its rows of
  a lease of phase 3's image cutouts, (b) the plane-pair mode pyramid on
  its rows of a lease of segmentation cutouts, (c) ``PagedGlobalRunner``
  on its range of phase 3's ragged image's pages. Every real row it
  addresses must equal phase 3's stored mips; its launches are counted
  from 0 before each part. Writes its report as JSON."""
  import torch
  import torch.distributed as dist

  from igneous_tpu_torch import Volume, set_device
  from igneous_tpu_torch.ops import cuda_pooling as cp
  from igneous_tpu_torch.parallel import ChunkExecutor, multihost
  from igneous_tpu_torch.parallel.paged import PagedGlobalRunner, page_shape, to_pages

  dev = set_device("cuda")
  t0 = time.perf_counter()
  multihost.initialize()
  pod = multihost.pod_mesh()
  report = {"rank": pod.rank, "backend": dist.get_backend(), "device": str(pod.device),
            "init_s": time.perf_counter() - t0}
  if report["backend"] != "gloo" or pod.world_size != POD_RANKS or pod.device.type != "cuda":
    fail(f"pod rank: {report}, world {pod.world_size}: expected gloo ranks on the card")

  # (a) the image lease by run_global
  n, size, mips = POD_IMAGE
  path = f"file://{root}/image"
  t0 = time.perf_counter()
  boxes = pod_boxes(Volume(path), n, size)
  mine, per = multihost.lease_partition(n)
  vol = Volume(path)
  local = np.stack([vol.download(boxes[k]).transpose(3, 2, 1, 0) for k in mine])
  zero_counts(cp)
  batch = multihost.from_process_local(pod, local, per)
  outs, nonzero = ChunkExecutor(((2, 2, 1),) * mips, "average").run_global(batch)
  torch.cuda.synchronize(dev)
  launched = dict(cp.LAUNCHES)
  rows = 0
  for mip, out in enumerate(outs, start=1):
    for shard in out.addressable_shards:
      k = shard.index[0].start
      if k >= n:
        continue
      if not np.array_equal(shard.data[0].cpu().numpy(), stored_zyx(path, mip, boxes[k])):
        fail(f"pod (a) rank {pod.rank}: cutout {k} mip {mip} differs from phase 3's")
      rows += 1
  report["a"] = dict(wall=time.perf_counter() - t0, rows=rows, per=per, cutouts=list(mine),
                     nonzero=nonzero, local_nonzero=int(np.count_nonzero(local)),
                     launches=launched)
  del local, batch, outs

  # (b) the segmentation lease, uint64 as (lo, hi) planes, by mode
  n, size, mips = POD_SEGMENTATION
  path = f"file://{root}/segmentation"
  t0 = time.perf_counter()
  boxes = pod_boxes(Volume(path), n, size)
  mine, per = multihost.lease_partition(n)
  vol = Volume(path)
  local = np.stack([vol.download(boxes[k]).transpose(3, 2, 1, 0) for k in mine])
  zero_counts(cp)
  planes = (multihost.from_process_local(pod, (local & np.uint64(0xFFFFFFFF)).astype(np.uint32), per),
            multihost.from_process_local(pod, (local >> np.uint64(32)).astype(np.uint32), per))
  outs, nonzero = ChunkExecutor(((2, 2, 1),) * mips, "mode", planes=2).run_global(planes)
  torch.cuda.synchronize(dev)
  launched = dict(cp.LAUNCHES)
  rows = 0
  for mip, (lo, hi) in enumerate(outs, start=1):
    for slo, shi in zip(lo.addressable_shards, hi.addressable_shards):
      k = slo.index[0].start
      if k >= n:
        continue
      got = (slo.data[0].cpu().numpy().astype(np.uint64)
             | (shi.data[0].cpu().numpy().astype(np.uint64) << np.uint64(32)))
      if not np.array_equal(got, stored_zyx(path, mip, boxes[k])):
        fail(f"pod (b) rank {pod.rank}: cutout {k} mip {mip} differs from phase 3's")
      rows += 1
  report["b"] = dict(wall=time.perf_counter() - t0, rows=rows, per=per, cutouts=list(mine),
                     nonzero=nonzero, local_nonzero=int(np.count_nonzero(local)),
                     launches=launched)
  del local, planes, outs

  # (c) the ragged image's pages by PagedGlobalRunner
  path = f"file://{root}/ragged_image"
  t0 = time.perf_counter()
  vol = Volume(path)
  page = page_shape()
  img = torch.from_numpy(vol.download(vol.mip_bounds(0)).transpose(3, 2, 1, 0).copy()).to(dev)
  Z, Y, X = img.shape[1:]
  pads = [(-s) % p for s, p in zip((Z, Y, X), page)]
  pages = to_pages(torch.nn.functional.pad(img, (0, pads[2], 0, pads[1], 0, pads[0])), page)
  exts = np.array([(min(page[0], Z - oz), min(page[1], Y - oy), min(page[2], X - ox))
                   for oz in range(0, Z, page[0]) for oy in range(0, Y, page[1])
                   for ox in range(0, X, page[2])], np.int32)
  start, stop, per = multihost.page_partition(len(pages))
  zero_counts(cp)
  outs = PagedGlobalRunner(((2, 2, 1),) * POD_PAGE_MIPS, "average", mesh=pod)(
    multihost.from_process_local(pod, pages[start:stop], per),
    multihost.from_process_local(pod, exts[start:stop], per))
  torch.cuda.synchronize(dev)
  launched = dict(cp.LAUNCHES)
  rows = 0
  for mip, out in enumerate(outs, start=1):
    ref = Volume(path, mip=mip)
    ref = torch.from_numpy(ref.download(ref.mip_bounds(mip)).transpose(3, 2, 1, 0).copy())
    q = (page[0], page[1] >> mip, page[2] >> mip)
    rz, ry, rx = ref.shape[1:]
    ref = to_pages(torch.nn.functional.pad(
      ref, (0, (-rx) % q[2], 0, (-ry) % q[1], 0, (-rz) % q[0])), q).to(dev)
    for shard in out.addressable_shards:
      k = shard.index[0].start
      if not start <= k < stop:
        continue
      ez, ey, ex = (int(exts[k][0]), -(-int(exts[k][1]) >> mip), -(-int(exts[k][2]) >> mip))
      if not torch.equal(shard.data[0][:, :ez, :ey, :ex], ref[k][:, :ez, :ey, :ex]):
        fail(f"pod (c) rank {pod.rank}: page {k} mip {mip} differs from phase 3's")
      rows += 1
  report["c"] = dict(wall=time.perf_counter() - t0, rows=rows, per=per, pages=[start, stop],
                     launches=launched)
  with open(report_path, "w") as f:
    json.dump(report, f)
  multihost.shutdown()
  return 0


def pod_phase(root, cp, torch, dev) -> tuple:
  """Phase 20: POD_RANKS rank processes on the card (``pod_rank``), their
  group over gloo (they share one card), on phase 3's image,
  segmentation and ragged image; then (d) a one-rank NCCL group in this
  process, whose ``run_global`` all-reduces its count as a CUDA tensor.
  Returns (launches of the ranks and of (d), wall)."""
  import os
  import socket

  import torch.distributed as dist

  from igneous_tpu_torch import Volume, set_device
  from igneous_tpu_torch.parallel import ChunkExecutor, multihost

  t_phase = time.perf_counter()
  here = os.path.dirname(os.path.abspath(__file__))

  def free_port() -> int:
    with socket.socket() as s:
      s.bind(("127.0.0.1", 0))
      return s.getsockname()[1]

  port = free_port()
  procs, reports = [], []
  src = ("import sys; sys.path.insert(0, {!r}); import chip_smoke; "
         "sys.exit(chip_smoke.pod_rank({!r}, {!r}))")
  for rank in range(POD_RANKS):
    env = dict(os.environ, PYTHONPATH=here, IGNEOUS_TORCH_DEVICE="cuda",
               IGNEOUS_COORDINATOR=f"tcp://127.0.0.1:{port}",
               IGNEOUS_NUM_PROCESSES=str(POD_RANKS), IGNEOUS_PROCESS_ID=str(rank))
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE"):
      env.pop(name, None)
    report = os.path.join(root, f"pod_rank{rank}.json")
    reports.append(report)
    with open(report + ".err", "w") as fe:
      procs.append(subprocess.Popen(
        [sys.executable, "-c", src.format(here, root, report)],
        cwd=here, env=env, stdout=fe, stderr=subprocess.STDOUT))
  deadline = time.monotonic() + POD_TIMEOUT_S
  for rank, proc in enumerate(procs):
    try:
      proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
      for q in procs:
        q.kill()
        q.wait()
      fail(f"pod: rank {rank} still running after {POD_TIMEOUT_S:.0f} s")
  for rank, proc in enumerate(procs):
    if proc.returncode != 0:
      fail(f"pod: rank {rank} exit {proc.returncode}: "
           f"{open(reports[rank] + '.err').read()[-3000:]}")
  ranks = [json.load(open(r)) for r in reports]
  t_ranks = time.perf_counter() - t_phase
  launches = {k: 0 for k in cp.LAUNCHES}
  for r in ranks:
    for part, kernel in (("a", "pyramid2x2x1"), ("b", "pyramid2x2x1"), ("c", "pool2x2x1")):
      if r[part]["launches"][kernel] < 1:
        fail(f"pod ({part}) rank {r['rank']}: {kernel} launched no time")
      for k, v in r[part]["launches"].items():
        launches[k] += v
  for part, n, mips in (("a", POD_IMAGE[0], POD_IMAGE[2]),
                        ("b", POD_SEGMENTATION[0], POD_SEGMENTATION[2])):
    total = sum(r[part]["local_nonzero"] for r in ranks)
    if any(r[part]["nonzero"] != total for r in ranks):
      fail(f"pod ({part}): all-reduced counts {[r[part]['nonzero'] for r in ranks]}, "
           f"the cutouts hold {total} nonzero voxels")
    if sum(r[part]["rows"] for r in ranks) != n * mips:
      fail(f"pod ({part}): {sum(r[part]['rows'] for r in ranks)} rows checked, expected "
           f"{n * mips}")
  pages = ranks[-1]["c"]["pages"][1]
  if sum(r["c"]["rows"] for r in ranks) != pages * POD_PAGE_MIPS:
    fail(f"pod (c): {sum(r['c']['rows'] for r in ranks)} page rows checked, expected "
         f"{pages * POD_PAGE_MIPS}")
  for r in ranks:
    print(f"pod rank {r['rank']} ({r['backend']}, {r['device']}): init {r['init_s']:.2f} s; "
          f"(a) cutouts {r['a']['cutouts']} of {POD_IMAGE[0]} in {r['a']['per']} slots, wall "
          f"{r['a']['wall']:.3f} s, launches {json.dumps(r['a']['launches'])}; (b) cutouts "
          f"{r['b']['cutouts']} in {r['b']['per']} slots, wall {r['b']['wall']:.3f} s, launches "
          f"{json.dumps(r['b']['launches'])}; (c) pages {r['c']['pages']} in {r['c']['per']} "
          f"slots, wall {r['c']['wall']:.3f} s, launches {json.dumps(r['c']['launches'])}",
          flush=True)
  print(f"pod: (a) tally {ranks[0]['a']['nonzero']} nonzero voxels all-reduced over "
        f"{POD_RANKS} ranks, (b) {ranks[0]['b']['nonzero']}; every real row of mips 1-"
        f"{POD_IMAGE[2]} equal to phase 3's stored bytes ({POD_IMAGE[0]} image and "
        f"{POD_SEGMENTATION[0]} segmentation cutouts, {pages} ragged-image pages); the ranks' "
        f"wall {t_ranks:.1f} s", flush=True)

  # (d) a one-rank NCCL group in this process
  t0 = time.perf_counter()
  multihost.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0)
  try:
    if dist.get_backend() != "nccl":
      fail(f"pod (d): backend {dist.get_backend()}, expected nccl for one rank on its card")
    pod = multihost.pod_mesh()
    path = f"file://{root}/image"
    box = pod_boxes(Volume(path), 1, POD_IMAGE[1])[0]
    local = Volume(path).download(box).transpose(3, 2, 1, 0)[None]
    zero_counts(cp)
    mine, per = multihost.lease_partition(1)
    outs, nonzero = ChunkExecutor(((2, 2, 1),) * POD_IMAGE[2], "average").run_global(
      multihost.from_process_local(pod, local, per))
    for k, v in cp.LAUNCHES.items():
      launches[k] += v
    if nonzero != int(np.count_nonzero(local)) or cp.LAUNCHES["pyramid2x2x1"] != 1:
      fail(f"pod (d): count {nonzero} of {np.count_nonzero(local)}, launches {cp.LAUNCHES}")
    if not np.array_equal(outs[-1].data[0].cpu().numpy(),
                          stored_zyx(path, POD_IMAGE[2], box)):
      fail("pod (d): the cutout's last mip differs from phase 3's")
  finally:
    multihost.shutdown()
    set_device(dev)
  t_nccl = time.perf_counter() - t0
  wall = time.perf_counter() - t_phase
  print(f"pod (d): one rank over nccl on {pod.device}, tally {nonzero} all-reduced as a CUDA "
        f"tensor, the group destroyed: wall {t_nccl:.3f} s", flush=True)
  print(f"pod: phase wall {wall:.1f} s (ranks {t_ranks:.1f} s, (d) {t_nccl:.1f} s), launches "
        f"{json.dumps(launches)}", flush=True)
  return launches, wall


def main() -> int:
  import argparse
  import os

  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument(
    "--mesh-simplify-threads", type=int, default=MESH_SIMPLIFY_THREADS, metavar="N",
    help="simplification threads of each mesh task (the forge's "
         "--simplify-parallel; 1 is its default)",
  )
  parser.add_argument(
    "--baseline", action="append", default=[], metavar="NAME=DIR",
    help="time the kernels of another copy of the package (DIR holds its "
         "__init__.py) against this checkout's, in turns on the same card, "
         "and check that their outputs agree; runs the build and kernel "
         "phases only and prints no result line",
  )
  args = parser.parse_args()
  try:
    import torch
  except ImportError:
    fail("torch is not installed")
  if not torch.cuda.is_available():
    fail("no CUDA device: chip_smoke drives the port on the GPU only")
  try:
    from igneous_tpu_torch import set_device
    from igneous_tpu_torch.ops import _build, ccl as ccl_ops
    from igneous_tpu_torch.ops import cuda_ccl as cc, cuda_pooling as cp
    from igneous_tpu_torch.ops import cuda_edt as ce, edt as edt_ops
    from igneous_tpu_torch.ops import clahe as clahe_ops, cuda_clahe as cl
  except ImportError as e:
    fail(f"igneous_tpu_torch is not importable here ({e}); run from the repo root")

  t_all = time.perf_counter()
  dev = set_device("cuda")
  print(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}", flush=True)

  copies = [(spec.split("=", 1)[0], load_copy(*spec.split("=", 1)))
            for spec in args.baseline]
  t0 = time.perf_counter()
  sources = ("pooling", "ccl", "edt")
  builds = [(b, name) for b in [_build] + [c[0] for _, c in copies] for name in sources]
  # the kernel of phase 14, which the other copies need not have
  builds += [(b, "clahe") for b in [_build] + [c[0] for _, c in copies if c[4] is not None]]
  # the host libraries of the mesh and skeleton paths and the codec (g++)
  host_libs = ("simplify", "dijkstra", "fggraph", "cseg", "xsection")
  builds += [(_build, name) for name in host_libs]
  with ThreadPoolExecutor(len(builds)) as pool:
    # one compiler per source, together
    list(pool.map(lambda job: job[0].build(job[1]), builds))
  print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
  for name in sources + ("clahe",) + host_libs:
    log = _build.BUILD_LOG[name]
    print(f"build {name}: {log['seconds']:.1f} s", flush=True)
    for line in log["ptxas"].splitlines():
      if "Used" in line or "spill" in line:
        print(f"ptxas {name}: {line.strip()}")

  cases = kernel_phase(cp, torch, dev, [(k, c[2]) for k, c in copies])
  ccl_cases = ccl_kernel_phase(cc, ccl_ops, torch, dev, [(k, c[1]) for k, c in copies])
  edt_cases = edt_kernel_phase(ce, edt_ops, torch, dev, [(k, c[3]) for k, c in copies])
  clahe_cases = clahe_kernel_phase(cl, clahe_ops, torch, dev,
                                   [(k, c[4]) for k, c in copies if c[4] is not None])
  if copies:
    print(f"wall: {time.perf_counter() - t_all:.1f} s")
    print(card_line())
    print("compared with " + ", ".join(args.baseline) + "; e2e phases not run")
    return 0
  span_cost(torch, dev)
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    launches = e2e_phase(root, cp, torch, dev)
    codec_phase(root)
    xfer_launches = xfer_e2e_phase(root, cp, torch, dev)
    # the batched phase: its own counts, set to 0 just before each part
    t_phase = time.perf_counter()
    for counts in (cc.LAUNCHES, cp.LAUNCHES, ce.LAUNCHES):
      for key in counts:
        counts[key] = 0
    batched_downsample_phase(root, cp, torch, dev)
    batched_launches = dict(cp.LAUNCHES)
    batched_launches["pyramid2x2x1"] += entry_phase(cp, torch, dev)
    if any(cc.LAUNCHES.values()) or any(ce.LAUNCHES.values()):
      fail("batched: the CCL or EDT kernels ran on the batched downsample path")
    # measured after the counts were read: its launches are no path's
    x5 = page_kernel_program(root, cp, torch, dev)
    t_batched = time.perf_counter() - t_phase
    pipelined_launches, walls3d = pipelined_phase(root, cp, cc, ce, torch, dev)
    # the queue worker (phase 11): its own counts, set to 0 just before each part
    t_worker = time.perf_counter()
    worker_launches = worker_streams(root, cp, cc, ce, walls3d, torch, dev)
    for part in (worker_ragged(root, cp, cc, ce), worker_lifecycle(root, cp, cc, ce)):
      for key, n in part.items():
        worker_launches[key] += n
    t_worker = time.perf_counter() - t_worker
    x7 = inference_phase(root, cp, cc, ce, torch, dev)
    storage_launches = storage_phase(root, cp, cc, ce, torch, dev)
    sharded_launches = sharded_phase(root, cp, cc, ce, torch, dev)
    t_surface = time.perf_counter()
    surface_launches = surface_phase(root, cp, cc, ce, cl, clahe_ops, torch, dev)
    t_surface = time.perf_counter() - t_surface
    # phase 17 on phase 3's image (its skeleton group runs in phase 6's root)
    journal_launches, t_journal = journal_phase(root, cp, cc, ce, torch, dev)
    # phase 18 on phase 3's image and ragged image, after phase 17's layer
    campaign_launches, t_campaign = campaign_phase(root, cp, cc, ce, torch, dev)
    # phase 19 on phase 3's image and segmentation: the serving tier, then chaos
    serve_launches, t_serve = serve_phase(root, cp, cc, ce, torch, dev)
    chaos_launches, t_chaos = chaos_phase(root, cp, cc, ce, torch, dev)
    print(f"serve: phase wall {t_serve + t_chaos:.1f} s ((a)-(b) {t_serve:.1f} s, "
          f"(c) {t_chaos:.1f} s)", flush=True)
    # phase 20 on phase 3's image, segmentation and ragged image: pods
    pod_launches, _t_pod = pod_phase(root, cp, torch, dev)
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    launches["tile_resolve"] = ccl_e2e_phase(root, cc, cp, torch, dev)
    t_phase = time.perf_counter()
    batched_launches["tile_resolve"] = batched_ccl_phase(root, cc, torch, dev)
    t_batched += time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    worker_launches["tile_resolve"] = worker_ccl(
      root, cc, cp, ce, os.path.join(root, "faces_task"))["tile_resolve"]
    t_worker += time.perf_counter() - t_phase
  for counts in (cc.LAUNCHES, cp.LAUNCHES, ce.LAUNCHES):
    for key in counts:
      counts[key] = 0
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    programs = mesh_e2e_phase(root, torch, dev,
                              simplify_threads=args.mesh_simplify_threads)
    if any(cc.LAUNCHES.values()) or any(cp.LAUNCHES.values()) or any(ce.LAUNCHES.values()):
      fail("mesh: the pooling, CCL or EDT kernels ran on the mesh path")
    t_surface += spatial_index_phase(root, cp, cc, ce, cl, torch, dev)
    t_frags = frags_mesh_phase(root, cp, cc, ce, cl, torch, dev)
    graphene_pyramid, graphene_edt, t_graphene = graphene_phase(root, cp, cc, ce, cl, torch, dev)
  print(f"surface: phase wall {t_surface:.1f} s", flush=True)
  for counts in (cc.LAUNCHES, cp.LAUNCHES):
    for key in counts:
      counts[key] = 0
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    launches["edt_pass"] = skeleton_e2e_phase(root, ce, edt_ops, torch, dev)
    if any(cc.LAUNCHES.values()) or any(cp.LAUNCHES.values()):
      fail("skeleton: the pooling or CCL kernels ran on the skeleton path")
    t_phase = time.perf_counter()
    batched_launches["edt_pass"] = batched_skeleton_phase(root, ce, edt_ops, torch, dev)
    t_batched += time.perf_counter() - t_phase
    frags_launches, t_phase = frags_skeleton_phase(root, ce, cp, cc, cl, torch, dev)
    t_frags += t_phase
    # the batched and worker skeleton forges on phase 15's crop (phase 6's
    # tasks before phase 16)
    t_phase = time.perf_counter()
    batched_launches["edt_pass"] += batched_skeleton_forge_phase(root, ce, torch, dev)
    t_batched += time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    worker_launches["edt_pass"] = worker_skeleton(root, ce, cp, cc)["edt_pass"]
    t_worker += time.perf_counter() - t_phase
    launched, t_phase = xsection_phase(root, ce, cp, cc, cl, torch, dev)
    graphene_edt += launched
    t_graphene += t_phase
    launched, t_phase = journal_skeleton_phase(root, ce, cp, cc)
    journal_launches["edt_pass"] += launched
    t_journal += t_phase
  print(f"frags: phase wall {t_frags:.1f} s", flush=True)
  print(f"journal: phase wall {t_journal:.1f} s", flush=True)
  print(f"campaign: phase wall {t_campaign:.1f} s", flush=True)
  if not campaign_launches["pyramid2x2x1"] or not campaign_launches["pool2x2x1"]:
    fail(f"campaign: launches {campaign_launches}: pyramid2x2x1 and pool2x2x1 must launch")
  if not journal_launches["pyramid2x2x1"] or not journal_launches["edt_pass"]:
    fail(f"journal: launches {journal_launches}: pyramid2x2x1 and edt_pass must launch")
  print(f"graphene: phase wall {t_graphene:.1f} s", flush=True)
  print(f"batched: phase wall {t_batched:.1f} s", flush=True)
  print(f"worker: phase wall {t_worker:.1f} s", flush=True)
  missing = [k for k in HAND_KERNELS if not worker_launches.get(k)]
  if missing:
    fail(f"worker: {missing} launched no time on the worker's paths")
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    x6 = morphology_phase(root, cp, cc, ce, torch, dev)
  programs += [x5, x6, x7]
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
    store_phase(root, torch, dev)
    tune_phase(root)

  kernels = []
  replaces = {
    "pyramid2x2x1": "igneous_tpu/ops/pallas_pooling.py:114",
    "pool2x2x1": "igneous_tpu/ops/pallas_pooling.py:95",
  }
  for name in ("pyramid2x2x1", "pool2x2x1"):
    first = next(c for c in cases if c["kernel"] == name)  # the main-path case
    kernels.append({
      "name": name, "route": "cuda",
      "source": "igneous_tpu_torch/csrc/pooling.cu",
      "replaces": replaces[name], "launches": launches[name],
      "launches_xfer": xfer_launches[name],
      "launches_batched": batched_launches[name],
      "launches_pipelined": pipelined_launches[name],
      "launches_worker": worker_launches[name],
      "launches_storage": storage_launches[name],
      "launches_sharded": sharded_launches[name],
      "launches_surface": surface_launches[name],
      "launches_graphene": graphene_pyramid if name == "pyramid2x2x1" else 0,
      "launches_journal": journal_launches[name],
      "launches_campaign": campaign_launches[name],
      "launches_serve": serve_launches[name],
      "launches_chaos": chaos_launches[name],
      "launches_pod": pod_launches[name],
      "max_abs_err": max(c["max_abs_err"] for c in cases if c["kernel"] == name),
      "ms": first["ms"], "plain_ms": first["plain_ms"],
      "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
      "library_ms": None, "case": first["case"],
    })
  first = ccl_cases[0]  # the main path's mask case
  kernels.append({
    "name": "tile_resolve", "route": "cuda",
    "source": "igneous_tpu_torch/csrc/ccl.cu",
    "replaces": "igneous_tpu/ops/pallas_ccl.py:118",
    "launches": launches["tile_resolve"],
    "launches_batched": batched_launches["tile_resolve"],
    "launches_worker": worker_launches["tile_resolve"],
    "launches_surface": surface_launches["tile_resolve"],
    "launches_journal": journal_launches["tile_resolve"],
    "max_abs_err": max(c["max_abs_err"] for c in ccl_cases),
    "ms": first["ms"], "plain_ms": first["plain_ms"],
    "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
    "library_ms": None, "case": first["case"],
  })
  first = edt_cases[0]  # the default skeleton task's field
  kernels.append({
    "name": "edt_pass", "route": "cuda",
    "source": "igneous_tpu_torch/csrc/edt.cu",
    "replaces": EDT_REPLACES, "launches": launches["edt_pass"],
    "launches_batched": batched_launches["edt_pass"],
    "launches_worker": worker_launches["edt_pass"],
    "launches_frags": frags_launches,
    "launches_graphene": graphene_edt,
    "launches_journal": journal_launches["edt_pass"],
    "max_abs_err": max(c["max_abs_err"] for c in edt_cases),
    "ms": first["ms"], "plain_ms": first["plain_ms"],
    "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
    "library_ms": None, "case": first["case"],
  })
  first = clahe_cases[0]  # the first default CLAHE task's cutout
  kernels.append({
    "name": "clahe", "route": "cuda",
    "source": "igneous_tpu_torch/csrc/clahe.cu",
    "replaces": CLAHE_REPLACES, "launches": surface_launches["clahe"],
    "max_abs_err": max(c["max_abs_err"] for c in clahe_cases),
    "ms": first["ms"], "plain_ms": first["plain_ms"],
    "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
    "library_ms": None, "case": first["case"],
  })
  print(f"wall: {time.perf_counter() - t_all:.1f} s")
  print(card_line())
  print(json.dumps({"programs": programs}))
  print(json.dumps({"kernels": kernels}))
  print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": torch.cuda.get_device_name(0),
    "count": torch.cuda.device_count(),
  }}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
