"""Drive the port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed N] [--dat-gib G] [--second-gib G] [--variant-gib G]

Phases, one JSON line each:
  device   the card (nvidia-smi name and power limit), the torch and CUDA
           versions, and whether grpc and google.protobuf import (their
           versions, or null); exits 1 without CUDA
  build    compiles every kernel library from seaweedfs_tpu_torch/csrc/,
           and beside them the host codecs' library (csrc/gf_host.cc, g++)
  sanitizer
           while the kernels build: the host codecs' threaded entry points
           under ThreadSanitizer and AddressSanitizer on the card's host
           (`ops/host_sanitizer.py`: `csrc/xs_san_driver.cc` linked with
           `csrc/gf_host.cc`, the XOR-schedule executor's tile pool,
           `gf_matrix_apply_mt` and `gf_matrix_apply_batch` at 1 2 4 8
           threads against their byte oracles); the host's fingerprint, the
           XOR executor's SIMD level, each binary's compiler, build and run
           seconds, exit code and last line, and the phase's seconds; exits
           1 unless both print "all clean" and exit 0
  lowering the build proof (`ops/cuda_lowering.py`): every library again
           (now from the cache: its kept ptxas log must name as many
           kernels as the cold build's), each one's registers, spill bytes
           and static shared memory, and every variant at each of the ten
           proof shapes (the reference's TPU lowering shapes) through
           `rs_cuda.apply_matrix`, one launch each, byte-exact against its
           plain version on the card and the int8 kernel; the counts are
           set to 0 just before and read after (10 launches per variant);
           exits 1 on any entry that is not ok
  kernel_checks
           each of the five kernels (variants int8, bf16, u8, mplane, dma)
           against its own plain PyTorch version on the card, byte-exact
           (tolerance 0), at the main path's shapes and ragged/batched/
           strided/other family shapes, and all five against each other;
           at the three main-path shapes and the degraded read's three
           bucketed shapes (degraded4k (1, 10, 4096), degraded64k (3, 10,
           65536), degraded1m (2, 10, 1 MiB), R = 1), kernel_ms (20 launches in a CUDA
           graph, replayed between CUDA events, per launch, their inputs
           rotated over as many buffers as take twice the L2 (at most 20,
           so degraded4k's and degraded64k's take less than the L2)), call_ms
           (one eager call of the wrapper, its host time included), plain_ms
           (the plain version: the median of three warm eager calls; dma's,
           which takes a second or more at the large shapes, one warm call
           after its checking call), and bound_ms/bound_by (`measure.bound_ms`: bytes, or the product at
           the variant's own tensor-core rate, bf16 989e12 op/s); one case
           has rows that are not 16-byte aligned (offset 3), so that the
           dma kernel's masked producer path runs on the card; the repair
           phase's shapes are timed too: project (a holder's (1, 3)
           projection of 4 MiB), project_local (the local group's (1, 1)
           projection of 4 MiB), combine (the all-ones (1, 4) over 4 MiB),
           fused_block (a 12+3 decode, R = 3, C = 12, on a device view at
           column 3 of a (20, 4 MiB + 128) staging batch; the same at
           column 0, fused_block_aligned, for what the offset costs) and
           fused_block_v10 (the 10+4 volume's (2, 10) decode, on a view at
           column 5); and the ingest, convert and scrub phases' shapes:
           delta_odd and delta_1m (an overwrite's parity column, R = 4,
           C = 1, at 4113 bytes and at 1 MiB), encode_c12 and encode_m20
           (the 12+3 and 20+4 parity products over 4 MiB) and rebuild_m20
           (the 20+4 decode of three lost shards, (3, 20), over 4 MiB); and
           the fleet phase's fused blocks, fleet_rebuild3 (3, 10) and
           fleet_rebuild2 (2, 10) over 4 MiB
  dma_ring the dma kernel's ring as it launches (`gf_dma_plan`: stages,
           columns per pass, shared memory, blocks per SM by the occupancy
           calculator) at the main path's shapes and at (32, 32), checked
           against `rs_cuda.dma_plan`, and `ptxas -v` of its kernels
           (registers, spills, static shared memory)
  sweep    the kernel sweep (`--quick`, full size) into JSONL under
           _smoke_tmp/, assembled into a GPU_MEASUREMENT file there; checks
           that `pick_device_backend` on it names the best configuration
           that beats int8, or int8
  e2e      a seeded volume (default 2 GiB .dat + .idx, small rows only as
           upstream lays out volumes under 10 GiB) and a second one with
           64 MiB large blocks (default 1 GiB, both tiers) through the CLI's
           own functions with the factory's encoder (int8: no evidence is
           committed), then one 0.5 GiB two-tier volume (32 MiB large
           blocks) per other variant
           with `Encoder(10, 4, variant=v)`: encode, verify, delete shards
           0/5/10/13 [degraded read], delete the .dat, rebuild, decode;
           asserts rebuilt CRCs match the .eci, the decoded .dat hashes equal
           to the original, and the volume's kernel launched in both encode
           and rebuild
  degraded_read
           for the two factory volumes, with the four shards lost: the
           port's EcVolume mounted with the run's encoder reads a seeded
           sample of 256 needles (1 MiB records, crossing blocks and lost
           shards) and the overwritten 64-byte record, serially (latency of
           local and degraded reads, the cold first degraded read, launches
           per degraded read, ec.gather/ec.decode seconds), then from 8
           threads, then 32 degraded ones again, which the decoded-interval
           cache must serve with no launch; and a few 12 MiB ranges through
           `read_intervals`, whose two intervals per lost shard decode in one
           bucketed `reconstruct_batch`. Every blob must equal the .dat bytes,
           zero-padded past its end; a deleted needle raises NeedleDeleted
  host_codec
           right after e2e: the host codecs of `csrc/gf_host.cc` on the
           card's host (its CPU model and cores, AVX2, the XOR executor's
           SIMD level; a host where the library does not build fails):
           native, xorsched and xorsched's numpy interpreter byte-exact
           (tolerance 0) against the int8 kernel and its plain version at
           (4, 10) x 4 MiB and (1, 10) x 4 KiB, with their GB/s; volume 1
           loses shards 0/5/10/13 again and is rebuilt by
           `command.local.rebuild` with a native and an xorsched encoder,
           every rebuilt shard's sha256 equal to the card rebuild's; each
           rebuild's survivor GB/s beside the card's from this run and the
           card/native ratio (the AVX2 baseline on the card's own host).
           Must take 20 s or less
  mesh     right after e2e, with the launch counts reset: volume 2 (the
           1 GiB factory volume, 64 MiB large blocks) through
           `command.local.encode` with a mesh encoder (`Encoder(backend=
           "mesh")`, 2x2 over this card named 4 times): all 14 shard files
           must equal the single-card ones; shards 0/5/11/13 deleted and
           rebuilt by `command.local.rebuild` with the ring, then the
           all_to_all formulation, each byte-equal; then the dry run
           (`parallel/dryrun.py`: the EC cycle's zero mismatches, parity
           equal to the host's, ring equal to all_to_all) over the card
           named 4 times at its small scale and 64 MiB, and 8 times for the
           dcn pass. Launches by (R, C) must be the mesh's positions times
           the single-card encode's (4, 10) launches, the same for the
           all_to_all rebuild, and positions x sp (4, 5) launches for the
           ring. On a host with more cards the same runs again over all of
           them. Walls and launches by device
  repair   after the two factory volumes' local rebuilds, with the launch
           counts reset: (a) remote: volume 1 loses 0/5/10/13 again and is
           rebuilt through `RemoteSlabSource`s (two holders per survivor,
           reading the shard files by position; the first holder of shards
           1 and 6 fails from its fourth fetch, so failover happens mid-
           rebuild); (b) trace: volume 1 loses shard 5 and is rebuilt from
           three remote holder groups, whose fetch projects the group's
           window with `Encoder.project` on the card, and one
           `LocalProjectionSource`, combined by one launch per batch; (c)
           fused: volume 2 (LOST), a 12+3 volume losing 0/13/14 and a 10+4
           volume losing 2/11 (REPAIR_GIB each) through
           `rebuild_ec_files_batch`, fused then unfused. Each rebuilt file's
           CRC must equal the .eci and its sha256 the local rebuild's; each
           path's launches, counted by matrix shape where they launch
           (`rs_cuda.launches_by_shape`), must equal its batches (trace:
           one (1, 3) projection per holder fetch, one (1, 1) local
           projection and one (1, 4) combine per batch; fused: one per
           block per batch); wall seconds and GB/s (survivor bytes)
  ingest   (the earlier volumes removed first) a 2 GiB volume laid out as
           `make_volume` lays one out grows in 8 MiB appends, each followed
           by `InlineStripeBuilder.poll()` (64 MiB large blocks, so rows 0-2
           of 640 MiB encode inline), takes 64 seeded overwrites of 4 KiB to
           1 MiB into encoded rows (every fourth across a block edge) through
           `overwrite(..., mutate=...)`, and seals; every shard's sha256 and
           the .eci must equal a warm `write_ec_files` of the final .dat,
           and the launches by (R, C) must be the batches' (4, 10) plus one
           (4, 1) per patched segment. An `IngestManager` over a stand-in
           store then seals a 160 MiB volume on its worker and seal threads.
           Seconds of the appends, polls, overwrites and seal against the
           warm encode's
  convert  the sealed volume, its .dat kept aside: (a) data shards 0 and 7
           deleted, `convert_ec_files` to cauchy_12_3 (verify on); (b)
           `cutover`, then the port's EcVolume reads 64 sampled needles with
           shards 0, 5 and 13 away; (c) cauchy_12_3 -> merge_20_4 from the
           healthy set, `cutover`, the same needles at 20+4. Each staged set
           must equal a warm encode of the kept .dat at its family, every
           needle the .dat's bytes, the (1, 10) launches the degraded runs
           decoded and the parity launches the conversion's batches; the
           degraded runs' reconstructs are timed (`reconstruct_s`)
  scrub    on the 20+4 set: a byte flipped in shard 5, shard 9 one byte
           short, shard 21 deleted; one unthrottled `Scrubber.run_cycle()`
           (4 MiB chunks) whose findings quarantine on the EcVolume must be
           exactly those three; needles on shard 5 read through
           reconstruction; the three rebuilt by `rebuild_ec_files` (one
           (3, 20) launch per batch), remounted, and `verify_ec_volume` all
           ok with no quarantine entry left in the cursor
  store    on an emptied scratch directory, upstream's `weed benchmark`
           volume (files of 1 KiB, collection benchmark, replication 000;
           131 072 of its 1 048 576 for the script's time) through the
           port's `Store`: every needle written
           (needles/s), a seeded tenth deleted, a seeded sample of 4096 read
           with cookies (live ones equal their data, deleted ones not found);
           `fix` from the .dat alone (the rebuilt .idx replays to the same
           map), `export` (one record per live needle, ascending, each with
           its cookie and size), `compact`, and a
           fresh `Store.load()` with the memory map and twice with the
           sorted_file map (the first builds the .sdx), the sample read after
           each; then `command.local.encode` on the card, shards 0/5/10/13
           and the .dat/.idx removed, and a fresh load that must discover
           the EC volume with its 10 shards and serve the sample: p50/p99 by
           class (local, degraded), one (1, 10) launch per lost shard a
           needle's intervals touch (predicted from the .ecx and `ec.locate`),
           every reconstruct at a `RECONSTRUCT_BUCKETS` width; the compiled
           CRC32C must be the one loaded
  obs      the store phase's EC volume loaded again: its sample read twice
           through `Store.read_needle`, each pass from a cleared decoded-
           interval cache, first with WEEDTPU_TRACE=off, then with every read
           inside a `trace.start("http.read")` root (the volume server's GET)
           into a `TraceRing(sample=1.0, seed=--seed)` that keeps every root.
           Both passes must launch the store phase's predicted (1, 10) count,
           and `weedtpu_ec_reconstruct_seconds_count` on the served /metrics
           (`stats.start_metrics_server`) must rise by the same; the ring must
           hold every traced read, every degraded one with `ec.recover` over
           `ec.gather` and `ec.decode`, as many `ec.decode` spans as launches,
           and `attribute_stages` summing to each root's duration; then one
           unthrottled `Scrubber.run_cycle()` over the volume's shards (its
           `scrub.cycle` root lands in the ring), and /debug/traces (a
           `utils/httpd` server over `trace.debug_payload`) must report every
           root kept. Prints p50/p99 by class (local, degraded) for both
           passes and their difference, with no limit on them
  cluster  the users' EC path over real gRPC and HTTP on loopback, in this
           process: a port MasterServer and three VolumeServers A, B, C
           (racks rack0/rack1/rack0, heartbeat 0.4 s, each on the factory's
           encoder); A serves the store phase's compacted volume (hard-linked
           after its compact). Volume 1 marked read-only, then 1024 seeded
           1 KiB needles assigned and uploaded through `MasterClient` (upstream
           `weed benchmark`'s write path; the master grows new volumes) and
           read back; `VolumeEcShardsGenerate` on A must launch what the store
           phase's encode launched, and its .ecx and the ten shards the store
           phase kept must equal that phase's; B pulls 5-9 and C 10-13
           (`VolumeEcShardsCopy`), A drops them and the volume, all mount; LOST
           are lost (0 on A, 5 on B, 10 and 13 on C); every other needle of
           the store phase's sample through `MasterClient.read` (HTTP GET on
           A), serially without hedging (one (1, 10) launch per lost shard a
           needle's intervals touch, each at a bucket width; p50/p99 by
           class: local, remote, degraded), then with
           the default hedging; B rebuilds LOST with `remote: true` over the
           slab stream (one (4, 10) launch per batch, the sha256s of
           generate), then loses shard 5 again and rebuilds it from holder
           projections (`trace_mode: on`; the holders project on the card;
           launches by (R, C) as the plan's groups, wire bytes against the
           slab path's); `VolumeEcShardsVerify` all ok on every holder
  ha       upstream's production layout, in this process: three port
           MasterServers with `peers` (raft, the default (1.0, 2.0) s
           election timeout) and a raft directory each, and three
           VolumeServers on the card (racks rack0-rack2) heartbeating to all
           three; A serves the store phase's compacted volume (a second hard
           link). (1) seconds until all three agree on one leader; (2) 1024
           seeded 1 KiB needles through `MasterClient("m1,m2,m3")` from 8
           threads, read back; (3) `lock; volume.tier.move -volumeId 1 -dest local:<dir>;
           unlock` through the port shell connected to a follower (it must
           follow the leader): the .dat leaves A's disk, the `.tierinfo`
           names the vendor, key and size; the sample read serially over HTTP
           through the tiered .dat (p50/p99), then `volume.tier.fetch`
           through the other follower, the fetched .dat's sha256 the
           original's; move and fetch seconds and GB/s; (4) `lock; ec.encode
           -volumeId 1 -force; unlock` through the shell, every lease acked
           by the quorum, launching the store phase's (4, 10) encode count,
           the kept shards equal to the store phase's; (5) the leader stops:
           seconds to a new agreed leader of a greater term and to the
           client's first assign, 1024 more needles with no fid repeating
           one from (2), LOST deleted on their holders, a seeded 1024 of the
           sample read serially through the new leader's lookups (degraded
           p50/p99, (1, 10) launches); (6) the stopped master restarted on its raft
           directory resumes a term at least its old one, follows the
           leader within 10 s, and `cluster.raft.ps` against it names the
           leader
  filer    (on an emptied scratch directory) the SeaweedFS wiki's "Filer
           Setup" over its "Erasure Coding for warm storage", in this
           process: a port master, three VolumeServers on the card (racks
           rack0-rack2, 32 volume slots each as `weed volume -max 32`, six
           volumes of collection warm grown up front) and
           a FilerServer on the log store (4 MiB chunks, its chunk cache
           off). (1) 1024 seeded files, sizes log-uniform from 4 KiB to 8 MiB,
           in 4 x 8 directories, each by HTTP PUT from 8 threads (each
           reply's etag the file's md5; seconds, files/s, MB/s); (2) `lock;
           ec.encode -collection warm -force; unlock` through the port shell
           ((4, 10) launches only, every volume of the collection EC'd);
           (3) data shards 0 and 5 deleted on their holders; (4) every file
           by HTTP GET through the filer, serially, server caches cleared,
           hedging off: each file's sha256 the written one, p50/p99 by class
           (degraded: a chunk on a lost shard; healthy), launches exactly
           (1, 10) x the lost shards the chunks' needles touch (from the
           .ecx and `ec.locate`); (5) 256 seeded 64 KiB ranges (server
           caches off), each equal to the file's bytes, launches predicted
           the same way; (6) the default caches (the servers' decoded-
           interval cache, the filer's 64 MiB chunk cache; hedging still
           off) over 48 MiB of degraded files: first the predicted launches
           and a chunk cache miss per chunk, then with the chunk cache off
           an interval cache hit per lost interval and no launch, then with
           it on a chunk cache hit per chunk and no launch; (7) 32 more
           files into a fresh plain volume, `fs.du` and `fs.tree` (counts and bytes), `fs.mv` of a
           leaf directory (the moved files read back, the old paths 404),
           `fs.rm -r` of leaf directories holding a tenth of the files (they
           404, their chunks no longer read), `volume.fsck -cutoffTimeAgo 0`
           (0 orphans, 0 missing); (8) `fs.meta.save` of the namespace, the
           filer stopped and started again on its store and ports, the
           second dump byte-equal to the first, files read back. Prints
           launches by shape and kernel ms x launches against the wall
  s3       on the filer phase's cluster before it stops (its own launch
           count), the SeaweedFS wiki's "Amazon S3 API", "Amazon IAM API"
           and "Erasure Coding for warm storage": the port's S3ApiServer
           with an admin identity from a `-config` identities file, an
           IamApiServer with a bootstrap token and a WebDavServer, all on
           the filer, its chunk cache off. (1) Through IAM (signed by the
           admin) CreateUser loader, CreateAccessKey, PutUserPolicy (Read,
           Write, List on bucket s3warm); `s3.bucket.create -name s3warm`
           (and s3cold) through the port shell, three volumes of
           collection s3warm grown up front; (2) 384 seeded objects, sizes
           log-uniform from 4 KiB to 8 MiB, under 4 x 8 prefixes, by signed
           PUT from 8 threads under the loader's key (each ETag the md5;
           seconds, objects/s, MB/s, p50/p99), a 6 x 8 MiB multipart object
           (ETag the md5 of the part md5s, -6) and an upload abandoned after
           two parts; (3) `lock; ec.encode -collection s3warm -force;
           unlock`, data shards 0 and 5 deleted on their holders; (4) every
           object by signed GET on one keep-alive connection, hedging off,
           server caches cleared and off: each sha256 the written one,
           p50/p99 by class, launches exactly (1, 10) x the lost shards the
           chunks' needles touch (from the .ecx); (5) 128 seeded signed 64
           KiB ranges (16 inside the multipart object), 16 degraded objects
           by presigned GET and the same 16 by WebDAV GET, each byte-equal
           with launches predicted the same way, and a `PROPFIND Depth: 1`
           of one prefix listing exactly its keys; (6) ListObjectsV2 in
           pages of 100 returning every key once in order, an unsigned GET
           403, the loader on s3cold 403 AccessDenied, DeleteObjects of 32
           keys (each then 404 NoSuchKey), `s3.bucket.list` and
           `s3.clean.uploads -timeAgoSeconds 0` (the abandoned upload's
           staged parts gone). Prints launches by shape and kernel ms x
           launches against the wall
  sync     on the filer phase's cluster after the s3 phase (its own launch
           count), the SeaweedFS wiki's "Filer Active Active cross cluster
           continuous synchronization", "Async Backup", "FUSE Mount" and
           "Path-Specific Configuration", and upstream's `weed mq.broker`,
           the filer's chunk cache off, server caches cleared and off,
           hedging off. (1) filer.sync: a second FilerServer on its own log
           store, `fs.configure -locationPrefix /replica/ -collection
           replica` on it, a Replicator with a FilerSink (the `filer.sync`
           loop, `-targetPath /replica`) over /warm/t1 until it has applied
           every event there: each replicated file's sha256 the source's,
           (1, 10) launches the .ecx prediction for one read of every file;
           then 12 overwrites, 10 renames and 10 deletes on the source, the
           sync started again from its checkpoint (the source filer's KV):
           exactly those events apply, the replica equals the source
           subtree; (2) `filer.backup` (the command's entry point) of
           /warm/t2 into a local directory, byte-equal; an S3Sink of
           /warm/t3 into a bucket of a port S3ApiServer, each object's ETag
           its md5 and its sha256 the file's; (3) `filer.copy` of 64 seeded
           local files, read back byte-equal; `filer.meta.tail` from the
           phase's start: one JSON line per event; (4) a WFS mount (chunk
           cache off): 64 degraded files read whole and 128 seeded 64 KiB
           ranges, byte-equal, launches predicted; a 64 MiB file by seeded
           random writes with auto-flush, truncated, renamed, read back; (5)
           `fs.configure -locationPrefix /topics/ -collection mqwarm`, the
           `mq.broker` command's Broker, `mq.topic.configure -partitions 4`
           through the shell, 2048 seeded 1 KiB records from 4 publishers,
           the broker stopped (its segments flush), `ec.encode -collection
           mqwarm` with shards 0 and 5 lost, a broker started again and a
           consumer group of two reading every record from the start:
           each once, in ts_ns order per partition, committed offsets each
           partition's last ts_ns, (1, 10) launches the .ecx prediction for
           the segments' needles. Prints replicate files/s and MB/s, read
           p50/p99 by class per step, publish and consume records/s, and
           kernel ms x launches against the wall
  bench    (on an emptied scratch directory) the measurement harness
           `seaweedfs_tpu_torch/bench.py` on the card, in this process (its
           launches counted), at the reference smokes' sizes: a `probe`
           child (`python -m seaweedfs_tpu_torch.bench`), `xor --smoke`
           (the four matrix forms through both XOR executors and the int8
           kernel, byte-exact to the gf8 golden), `rebuild_batch --smoke`
           (one fused dispatch for 5 signatures, 5 unfused, bytes equal),
           `rebuild_remote` and `rebuild_trace` (in-process servers, 1 MiB;
           rebuilt shards equal the golden, the trace wire 2/10 of the
           slab's), `ingest` (inline equal to warm, delta bytes < 0.5x) and
           `convert` (both pairs equal to the oracle, moved <= 0.5x); the
           `device` mode on one (10, 4 MiB) batch (the plain version and the
           five kernels: per-call and steady GB/s, device ms, each equal to
           int8's; the rebuild matrix; a `torch.profiler` trace under the
           scratch directory); and `scripts/device_window.py --window` with
           a 300 s budget (stage 1 at (8, 10, 4 MiB), the sweep skipped,
           the 128 MiB e2e encode and both rebuilds, the remote rebuild
           at 8 MiB, not 48), every output under the scratch directory and its
           GPU_MEASUREMENT file the one `pick_device_backend` reads there.
           Prints each mode's ok, seconds and headline numbers, and the
           phase's launches by kernel
  shell    (on an emptied scratch directory) the SeaweedFS wiki's EC
           deployment: a port master with WEEDTPU_REPAIR=on and a 256 MiB
           volume size limit, five volume servers in racks r0-r4 (each on
           the factory's encoder), and 8 volumes of 255 seeded 1 MiB needles
           (collection storm) written with the port's storage engine into
           their directories; each .dat first encoded locally on the card
           (`write_ec_files`, hard-linked aside) as the oracle. Through the
           port shell (`CommandEnv(device=...)`, `run_script`): lock,
           volume.list, cluster.ps and ec.backend (int8 on the card);
           ec.encode -collection storm -fullPercent 95 -checkpoint (every
           volume EC'd and its source gone, the checkpoint removed, each
           rack holding at most 4 shards of a stripe, each holder's shards
           and .ecx equal to the oracle's, its (4, 10) launches equal to the
           oracle's); ec.balance, ec.verify (all clean), ec.status, unlock
           (the scheduler defers while the admin lock is held). Seconds and
           launches by (R, C) per command, shards per server and rack
  fleet    a reader thread reads a seeded sample of 512 needles through
           `MasterClient.read` into an `slo.LatencyRecorder` (phase steady,
           then chaos; class degraded when an interval lies on the victim's
           shards); after one full pass, the server holding the most shards
           stops (LeaveCluster kicks the scheduler), and time to repair runs
           until the master lists 14 shards of every volume. Checks: no
           backoff, failure or loss in RepairStatus; dispatches in non-
           increasing missing count; each batch's block_missing non-
           increasing; fused_volumes_total the batches' volumes; launches
           of R >= 2 by (R, C) as `_fused_prediction` works them out from
           the batches; rebuilt shards' sha256 the oracle's; zero read
           errors or wrong bytes; then lock, ec.verify (all clean),
           ec.decode of one volume (its .dat the original's), unlock.
           Prints batches, volumes per batch, survivor GB/s, read p50/p99 by
           phase and class, `slo.slo_verdict` (a reading) and kernel ms x
           launches against the wall time
  load     (on an emptied scratch directory) the reference's open-loop SLO
           harness as the port's `scripts/weedload.main`: --seconds 30 --rps
           1000 --procs 4 --chaos --rebuild-storm --objects 1000 --device
           cuda. The master runs here with WEEDTPU_REPAIR=on; each of the
           three volume servers is a `python -m seaweedfs_tpu_torch volume
           --device cuda` process with its own CUDA context, each generator
           worker a process that opens none. Checks: rc 0, no lost byte,
           healthy, ec_intact and degraded objects, degraded and cached
           reads, kills or wedges, every storm rebuild without error, every
           server generation's /metrics selecting the cuda backend,
           degraded reads, reconstructs and a cache hit counted on the
           servers (the report's own totals include the master's /metrics,
           which this process's earlier phases share),
           the servers' contexts listed by `nvidia-smi --query-compute-apps`
           while they ran and none after. Prints offered, issued and
           completed rps, p50/p99 by phase and class, the SLO verdict (a
           reading), the degraded class's per-stage p99, the storm's modes
           and wire bytes, the servers' cache hit rate, the set-up's seconds by
           stage, os.cpu_count() and the servers' decodes times the (1, 10)
           read kernels' ms against the load's seconds
  rack     (on an emptied scratch directory) `scripts/chaos_soak --rack
           --seconds 60 --device cuda`: seven volume server processes on the
           card in racks rk0, rk0, rk1..rk5, four EC volumes, open-loop reads
           at 20/s, the rk5 node killed, then both rk0 nodes. Checks the
           reference's gates (ok, no lost byte, priority_ok and
           coverage_complete in both phases, no placement violation,
           fusion.collapsed), a batch of two or more volumes in one
           dispatch group, the cuda backend on every server and the
           contexts as in load. Prints heal seconds, the batches, read
           p50/p99 and the servers' decode and rebuild counts
then the kernel table, the nvidia-smi line, and {"ok": true, ...} last.
Any mismatch or error exits nonzero without the last line. The load and
rack servers launch their kernels in their own processes, so the kernel
table's launches (`slice.launches` included) count only this process's;
those two lines report the servers' /metrics counts instead.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "_smoke_tmp")
LOST = (0, 5, 10, 13)
#: the degraded read's bucketed reconstruct shapes (B, C, bucket), R = 1
DEGRADED_SHAPES = {"degraded4k": (1, 10, 4096), "degraded64k": (3, 10, 65536),
                   "degraded1m": (2, 10, 1 << 20)}
#: the trace repair of shard 5: the first ten other shards survive, in three
#: remote holder groups and one local group (the last survivor)
TRACE_SURVIVORS = (0, 1, 2, 3, 4, 6, 7, 8, 9, 10)
TRACE_GROUPS = ((0, 1, 2), (3, 4, 6), (7, 8, 9))
#: the fused batch's two extra volumes and their losses (volume 2 loses LOST)
FUSED_LOST = {"c12": (0, 13, 14), "v10": (2, 11)}
#: the kernel cases the repair phase launches at
REPAIR_SHAPES = ("project", "project_local", "combine", "fused_block", "fused_block_aligned",
                 "fused_block_v10")
#: the size in GiB of each of the fused batch's two extra volumes
REPAIR_GIB = 0.25
#: the kernel cases the ingest, convert and scrub phases launch at
SLICE_SHAPES = ("delta_odd", "delta_1m", "encode_c12", "encode_m20", "rebuild_m20",
                "fleet_rebuild3", "fleet_rebuild2")
#: the fleet phase's two loss classes (the stopped server held 3 or 2 shards)
FLEET_LOST = {"fleet_rebuild3": (0, 5, 10), "fleet_rebuild2": (3, 12)}
#: the ingest phase's volume: .dat GiB, large block, append size, overwrites
INGEST_GIB = 2.0
INGEST_LARGE = 64 << 20
INGEST_APPEND = 8 << 20
OVERWRITES = 64
#: the convert phase's lost source data shards, and the 12+3 set's lost
#: shards while its needles are read
CONVERT_LOST = (0, 7)
C12_LOST = (0, 5, 13)
#: the scrub phase's damage to the 20+4 set, by shard: its verdict
SCRUB_DAMAGE = {5: "corrupt", 9: "truncated", 21: "missing"}
#: needles sampled for the convert and scrub phases' reads
NEEDLES = 64
#: the store phase: upstream's `weed benchmark` volume (-size 1024; an eighth of its
#: -n 1048576, for the script's time), a seeded tenth deleted, a seeded
#: sample of reads, and its volume id
STORE_FILES = 1 << 17
STORE_SIZE = 1024
STORE_DELETE = 0.10
STORE_SAMPLE = 4096
STORE_VID = 1


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _put_env(knobs: dict) -> None:
    """Set each environment variable to its value, or unset it where the
    value is None (as a phase found it, from `os.environ.get`)."""
    for name, value in knobs.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


#: variant -> (kernel name, source, the TPU kernel it replaces)
KERNELS = {
    "int8": ("gf_bitplane", "seaweedfs_tpu_torch/csrc/gf_bitplane.cu",
             "seaweedfs_tpu/ops/rs_pallas.py:112"),
    "bf16": ("gf_bf16", "seaweedfs_tpu_torch/csrc/gf_bf16.cu",
             "seaweedfs_tpu/ops/rs_pallas.py:146"),
    "u8": ("gf_u8", "seaweedfs_tpu_torch/csrc/gf_mma.cu", "seaweedfs_tpu/ops/rs_pallas.py:187"),
    "mplane": ("gf_mplane", "seaweedfs_tpu_torch/csrc/gf_mma.cu",
               "seaweedfs_tpu/ops/rs_pallas.py:210"),
    "dma": ("gf_dma", "seaweedfs_tpu_torch/csrc/gf_dma.cu", "seaweedfs_tpu/ops/rs_pallas.py:234"),
}


def check_kernels(seed: int) -> dict[str, list[dict]]:
    """{variant: [one row per case]}: each kernel against its own plain
    version, and against the int8 kernel (`agrees`)."""
    from seaweedfs_tpu_torch.ops import gf8, measure, rs_codec, rs_cuda

    rng = np.random.default_rng(seed)
    par = gf8.parity_matrix(10, 4)
    enc = rs_codec.Encoder(10, 4, device="cuda")
    surv = [s for s in range(14) if s not in LOST][:10]
    cases = [
        # (label, matrix, data shape, timed)
        ("encode", par, (10, 6_553_600), True),
        ("rebuild4", enc.reconstruction_matrix(surv, LOST), (10, 4_194_304), True),
        ("rebuild1", enc.reconstruction_matrix(
            [s for s in range(14) if s != 5][:10], (5,)), (10, 4_194_304), True),
        ("ragged1", par, (10, 1), False),
        ("ragged100", par, (10, 100), False),
        ("ragged8321", par, (10, 8321), False),
        ("batch2", par, (2, 10, 8321), False),
        ("cauchy_12_3", gf8.parity_matrix(12, 3, "cauchy"), (12, 8321), False),
        ("merge_20_4", gf8.parity_matrix(20, 4, "cauchy"), (20, 1_048_583), False),
        ("merge_20_4_decode", rs_codec.Encoder(20, 4, "cauchy", device="cuda")
         .reconstruction_matrix(list(range(2, 22)), (0, 1, 22, 23)), (20, 8321), False),
    ]
    # the degraded read's bucketed reconstructs: one lost data shard (R = 1)
    # from the 13 others, at each of Encoder.RECONSTRUCT_BUCKETS
    one_lost = enc.reconstruction_matrix([s for s in range(14) if s != 5][:10], (5,))
    cases += [(label, one_lost, shape, True) for label, shape in DEGRADED_SHAPES.items()]
    # the repair phase's launches: a holder's projection of three survivors
    # for shard 5 (R = 1, C = 3), and the trace combine of four groups
    plan = enc.repair_projection_plan(TRACE_SURVIVORS, (5,))
    cases += [
        ("project", np.stack([plan[s] for s in TRACE_GROUPS[0]], axis=1), (3, 4 << 20), True),
        ("project_local", np.stack([plan[s] for s in TRACE_SURVIVORS[9:]], axis=1),
         (1, 4 << 20), True),
        ("combine", np.ones((1, len(TRACE_GROUPS) + 1), np.uint8), (4, 4 << 20), True),
    ]
    # the ingest, convert and scrub phases' launches: a delta's parity column
    # (R = 4, C = 1) at an odd and a 1 MiB width, the 12+3 and 20+4 parity
    # products, and the 20+4 decode of the scrub's three lost shards
    m20 = rs_codec.Encoder(20, 4, "cauchy", device="cuda")
    lost20 = tuple(SCRUB_DAMAGE)
    cases += [
        ("delta_odd", np.ascontiguousarray(par[:, 5:6]), (1, 4113), True),
        ("delta_1m", np.ascontiguousarray(par[:, 5:6]), (1, 1 << 20), True),
        ("encode_c12", gf8.parity_matrix(12, 3, "cauchy"), (12, 4 << 20), True),
        ("encode_m20", m20.parity_matrix, (20, 4 << 20), True),
        ("rebuild_m20", m20.reconstruction_matrix(
            [s for s in range(24) if s not in lost20][:20], lost20), (20, 4 << 20), True),
    ]
    # the fleet phase's fused rebuild blocks: a stripe missing three shards
    # and one missing two, decoded from ten survivors over a 4 MiB span
    cases += [(label, enc.reconstruction_matrix([s for s in range(14) if s not in lost][:10],
                                                 lost), (10, 4 << 20), True)
              for label, lost in FLEET_LOST.items()]
    rows: dict[str, list[dict]] = {v: [] for v in KERNELS}
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)

    def compare(label, m, data, timed, contiguous=None, twin=None):
        """`twin()`, where given, makes another input laid out as `data`."""
        outs = {}
        for v in KERNELS:
            got = rs_cuda.apply_matrix(m, data, variant=v)
            want = rs_cuda.plain_apply(m, data if contiguous is None else contiguous, variant=v)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
            row = {"shape": label, "matrix": list(m.shape), "data": list(data.shape),
                   "equal": bool(torch.equal(got, want)), "max_abs_err": err}
            del want
            if timed:
                c, r, n = m.shape[1], m.shape[0], data.shape[-1]
                batch = data.shape[0] if data.ndim == 3 else 1
                # the graph's 20 launches rotate over inputs that together
                # take twice the L2, so that no launch finds its input there
                n_bufs = min(20, max(2, -(-2 * l2 // data.numel()) + 1))
                bufs = [data] + [data.clone() if twin is None else twin()
                                 for _ in range(n_bufs - 1)]
                row["kernel_ms"] = measure.graph_ms(
                    lambda i: rs_cuda.apply_matrix(m, bufs[i % n_bufs], variant=v))
                row["rotated_inputs"] = n_bufs
                del bufs
                row["call_ms"] = measure.eager_ms(lambda: rs_cuda.apply_matrix(m, data, variant=v), 50)
                # dma's plain version steps its ring in PyTorch, a second or
                # more a call at the large shapes: the checking call above
                # warms it, and one call is timed
                def plain():
                    return rs_cuda.plain_apply(m, data, variant=v)

                row["plain_ms"] = (measure.eager_ms(plain, 1, warmed=True) if v == "dma"
                                   else measure.eager_ms(plain, 3))
                row["bound_ms"], row["bound_by"] = measure.bound_ms(v, c, r, n, batch)
                row["kernel_gbps"] = (c + r) * n * batch / row["kernel_ms"] / 1e6
            outs[v] = got
            rows[v].append(row)
        for v in KERNELS:  # the five kernels byte for byte against each other
            rows[v][-1]["agrees"] = bool(torch.equal(outs[v], outs["int8"]))
        torch.cuda.empty_cache()

    for label, m, shape, timed in cases:
        data = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).cuda()
        compare(label, m, data, timed)
    # a strided view, as the stripe engine hands over staging[:, :aw]
    slot = torch.from_numpy(rng.integers(0, 256, (10, 6_553_600), dtype=np.uint8)).cuda()
    view = slot[:, :1_000_003]
    compare("strided", par, view, False, contiguous=view.contiguous())
    # rows that are not 16-byte aligned: the masked loads of every kernel
    view = slot[:, 3:8324]
    compare("unaligned", par, view, False, contiguous=view.contiguous())
    del slot, view
    # fused blocks as `Encoder.reconstruct_block` launches them: the 12+3
    # decode of three lost shards and the 10+4 decode of two, on device
    # views at columns 3, 0 and 5 of staging batches whose rows are
    # 4 MiB + 128 bytes apart
    c12 = rs_codec.Encoder(12, 3, "cauchy", device="cuda")
    m12 = c12.reconstruction_matrix(list(range(1, 13)), FUSED_LOST["c12"])
    lost10 = FUSED_LOST["v10"]
    m10 = enc.reconstruction_matrix([s for s in range(14) if s not in lost10][:10], lost10)
    slot_shape = (20, (4 << 20) + 128)
    slot = torch.from_numpy(rng.integers(0, 256, slot_shape, dtype=np.uint8)).cuda()
    for label, m, c0 in (("fused_block", m12, 3), ("fused_block_aligned", m12, 0),  # the offset's cost
                         ("fused_block_v10", m10, 5)):
        k, cols = m.shape[1], slice(c0, c0 + (4 << 20))
        view = slot[:k, cols]
        compare(label, m, view, True, contiguous=view.contiguous(),
                twin=lambda k=k, cols=cols: torch.randint(
                    0, 256, slot_shape, dtype=torch.uint8, device="cuda")[:k, cols])
    del slot, view
    torch.cuda.empty_cache()
    return rows


def dma_ring(ptxas_log: str) -> dict:
    """The dma kernel's ring as it launches, held against `rs_cuda.dma_plan`,
    and `ptxas -v` of its instantiations (NW = ceil(C/4) words per column,
    NT = R for R <= 4, else 0), from the log `_build.build()` keeps beside
    the library (a cached library's too). The main path's two, NW3_NT4 and
    NW3_NT1, must be in it."""
    import re

    from seaweedfs_tpu_torch.ops import _build, rs_cuda

    plans = {}
    for label, c, r in (("encode_rebuild4", 10, 4), ("rebuild1", 10, 1),
                        ("merge_20_4", 20, 4), ("random_32x32", 32, 32)):
        got = rs_cuda.dma_device_plan(c, r)
        want = rs_cuda.dma_plan(c, r)
        check((got["stages"], got["pass_cols"], got["smem"]) == (want.stages, want.pass_cols, want.smem),
              f"dma plan at ({c}, {r}): kernel {got}, rs_cuda {want}")
        check(got["blocks_per_sm"] >= 1, f"dma at ({c}, {r}): no block fits an SM: {got}")
        plans[label] = {"c": c, "r": r, **got, "smem_blocks_per_sm": want.blocks_per_sm}
    kernels = {}
    for name, rep in _build.ptxas_report(ptxas_log).items():
        m = re.search(r"gf_dma_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            kernels[f"NW{m.group(1)}_NT{m.group(2)}"] = rep
    main = {k: kernels.get(k) for k in ("NW3_NT4", "NW3_NT1")}  # (10, 4) and (10, 1)
    check(all(main.values()), f"the build's ptxas log lacks the main path's dma kernels: {main}")
    return {
        "plans": plans, "ptxas_main_path": main,
        "ptxas_kernels": len(kernels),
        "max_registers": max((v["registers"] for v in kernels.values()), default=None),
        "spilling": sorted(k for k, v in kernels.items() if v["spill_stores"] or v["spill_loads"]),
    }


def run_lowering(card: str, built: dict) -> dict:
    """The lowering phase: `cuda_lowering.run_lowering_proof()` on the card
    (every library built, now from the cache, with its ptxas report, and
    every variant at every proof shape against its plain version and the
    int8 kernel), with the launch counts set to 0 just before it. `built`
    is the build phase's report: each library's cached report must name
    as many kernels as its cold build's log. Returns the phase's line."""
    from seaweedfs_tpu_torch.ops import _build, cuda_lowering, rs_cuda

    t0 = time.perf_counter()
    rs_cuda.reset_launches()
    entries = cuda_lowering.run_lowering_proof()
    launches = dict(rs_cuda.launches_by_variant)
    seconds = time.perf_counter() - t0
    libraries = {e["library"]: {k: e.get(k) for k in (
        "ok", "cached", "instantiations", "max_registers", "spill_bytes", "max_smem", "error")}
        for e in entries if e["kind"] == "library"}
    shapes: dict[str, dict] = {}
    for e in entries:
        if e["kind"] == "launch":
            shapes.setdefault(e["shape"], {})[e["variant"]] = e["ok"]
    failed = [{k: e.get(k) for k in ("kind", "library", "shape", "variant", "error")}
              for e in entries if not e["ok"]]
    cold = {name: len(_build.ptxas_report(b["ptxas"])) for name, b in built.items()}
    for name, lib in libraries.items():
        if lib["ok"] and lib["instantiations"] != cold[name]:
            failed.append({"kind": "library", "library": name,
                           "error": f"cached ptxas report names {lib['instantiations']} kernels, "
                                    f"the build's {cold[name]}"})
    want = {v: len(cuda_lowering.PROOF_SHAPES) for v in cuda_lowering.VARIANTS}
    if launches != want:
        failed.append({"kind": "launches", "error": f"launched {launches}, want {want}"})
    return {"phase": "lowering", "card": card, "seconds": seconds, "ok": not failed,
            "entries": len(entries), "launches": launches, "libraries": libraries,
            "shapes": shapes, "failed": failed}


def run_sweep(seed: int) -> dict:
    """The quick kernel sweep at full size, assembled into a GPU_MEASUREMENT
    file under SCRATCH, and the factory's decision on that file."""
    import contextlib

    from seaweedfs_tpu_torch.ops import rs_codec
    from seaweedfs_tpu_torch.scripts import device_window, kernel_sweep

    jsonl = os.path.join(SCRATCH, "SWEEP_r02.jsonl")
    meas_path = os.path.join(SCRATCH, "GPU_MEASUREMENT_r02.json")
    log = os.path.join(SCRATCH, "sweep.log")
    t0 = time.perf_counter()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        rc = kernel_sweep.main(["--quick", "--out", jsonl, "--no-resume", "--seed", str(seed)])
        device_window.main(["--sweep", jsonl, "--out", meas_path, "--round", "2"])
    seconds = time.perf_counter() - t0
    check(rc == 0, f"kernel_sweep exited {rc}")
    recs = [json.loads(x) for x in open(jsonl)]
    bad = [r["variant"] for r in recs if r.get("error") or not r.get("exact")]
    check(not bad, f"sweep configurations failed: {bad}")
    with open(meas_path) as f:
        meas = json.load(f)
    table = meas["sweep"]["encode"]
    anchor = table["cuda-auto"]
    others = {k: v for k, v in table.items() if k != "cuda-auto"}
    best = max(others, key=others.get)
    want = rs_codec.parse_fused_variant(best) if others[best] > anchor else ("int8", None)
    variant, decision = rs_codec.pick_device_backend(art_dir=SCRATCH)
    check((variant, decision["tile"]) == want, f"decision {variant, decision} != {want}")
    return {
        "seconds": seconds, "records": len(recs), "card": meas.get("card"),
        "steady_gbps": {r["variant"]: r["steady_gbps"] for r in recs},
        "per_call_gbps": {r["variant"]: r["per_call_gbps"] for r in recs},
        "chain": sorted({r.get("chain") for r in recs}),
        "decision": {k: decision.get(k) for k in ("variant", "tile", "reason")},
    }


def make_volume(base: str, gib: float, seed: int, on_append=None,
                append_bytes: int = 64 << 20) -> tuple[int, str, list]:
    """A seeded .dat plus an .idx whose entries cover it (1 MiB needles, one
    overwritten and one deleted); returns (size, sha256, keys). With
    `on_append`, the .dat grows in `append_bytes` writes, each flushed and
    followed by `on_append()` (the ingest phase's polls)."""
    size = int(gib * (1 << 30))
    rng = np.random.default_rng(seed)
    h = hashlib.sha256()
    chunk = 64 << 20
    with open(base + ".dat", "wb") as f:
        left = size
        while left:
            b = rng.bytes(min(chunk, left))
            step = append_bytes if on_append is not None else len(b)
            for i in range(0, len(b), step):
                f.write(memoryview(b)[i: i + step])
                if on_append is not None:
                    f.flush()
                    on_append()
            h.update(b)
            left -= len(b)
    span = 1 << 20
    n = max(1, size // span)
    keys = rng.permutation(n) + 1
    with open(base + ".idx", "wb") as f:
        for i, key in enumerate(keys):
            f.write(int(key).to_bytes(8, "big") + ((8 + i * span) // 8).to_bytes(4, "big")
                    + (span - 8).to_bytes(4, "big", signed=True))
        f.write(int(keys[0]).to_bytes(8, "big") + (1).to_bytes(4, "big")
                + (64).to_bytes(4, "big", signed=True))
        f.write(int(keys[-1]).to_bytes(8, "big") + (0).to_bytes(4, "big")
                + (-1).to_bytes(4, "big", signed=True))
    return size, h.hexdigest(), [int(k) for k in keys]


def _expected(f, offset: int, length: int) -> bytes:
    """.dat bytes [offset, offset + length), zero-padded past its end, as
    the stripe pads the last row."""
    f.seek(offset)
    got = f.read(length)
    return got + bytes(length - len(got))


def _pct(xs: list, q: float) -> float | None:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


def decode_anatomy(ev, nid: int, lost_data: set, runs: int = 7) -> dict:
    """Where one degraded interval's time goes (median ms of `runs`): the
    survivor gather, the (10, N) host stack, the host-to-device copy, the
    kernel call (wrapper included) to its sync, the copy back, and the
    whole `Encoder.reconstruct` that a read makes, for `nid`'s interval on
    a lost data shard."""
    import statistics

    from seaweedfs_tpu_torch.ops import rs_cuda

    iv = next(iv for iv in ev.locate_needle(nid)[2]
              if iv.to_shard_id_and_offset(ev.large, ev.small)[0] in lost_data)
    sid, off = iv.to_shard_id_and_offset(ev.large, ev.small)
    enc = ev.encoder
    on_card = enc.device.type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    parts: dict[str, list] = {k: [] for k in ("gather", "stack", "h2d", "kernel", "d2h",
                                              "reconstruct")}
    for _ in range(runs):
        t = time.perf_counter()
        shards = ev.planner._gather_survivors(sid, off, iv.size)
        parts["gather"].append(time.perf_counter() - t)
        survivors = [i for i, x in enumerate(shards) if x is not None][: enc.data_shards]
        m = enc.reconstruction_matrix(survivors, [sid])
        t = time.perf_counter()
        stack = np.stack([shards[i] for i in survivors])
        parts["stack"].append(time.perf_counter() - t)
        t = time.perf_counter()
        dev = torch.from_numpy(stack).to(enc.device)
        sync()
        parts["h2d"].append(time.perf_counter() - t)
        t = time.perf_counter()
        out = rs_cuda.apply_matrix(m, dev, enc.tile, enc.variant)
        sync()
        parts["kernel"].append(time.perf_counter() - t)
        t = time.perf_counter()
        host = out.cpu().numpy()
        parts["d2h"].append(time.perf_counter() - t)
        t = time.perf_counter()
        rec = enc.reconstruct(shards, wanted=[sid])[sid]
        parts["reconstruct"].append(time.perf_counter() - t)
        check(np.array_equal(rec, host[0]), "decode anatomy: the parts disagree with reconstruct")
    out_ms = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
    out_ms["width"] = iv.size
    return out_ms


def degraded_read(base: str, enc, keys: list, size: int, seed: int, card: str) -> dict:
    """The degraded read through the port's EcVolume, with shards LOST gone
    and the .dat still on disk to compare against (see the module doc)."""
    import concurrent.futures

    from seaweedfs_tpu_torch.ec import ec_volume, locate, read_planner
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.storage import types

    span = 1 << 20
    record = types.actual_size(span - 8)
    rng = np.random.default_rng(seed + 100)
    # keys[0] now names the overwritten 64-byte record at offset 8; keys[-1]
    # was deleted in the .idx; keys[i] is the 1 MiB record at 8 + i * span
    sample = sorted(int(i) for i in rng.choice(np.arange(1, len(keys) - 1),
                                               min(256, len(keys) - 2), replace=False))
    want = {}
    with open(base + ".dat", "rb") as f:
        for i in sample:
            want[keys[i]] = _expected(f, 8 + i * span, record)
        want[keys[0]] = _expected(f, 8, types.actual_size(64))
    lost_data = {s for s in LOST if s < enc.data_shards}

    def count() -> int:
        return rs_cuda.launches_by_variant.get(enc.variant, 0)

    env0 = {k: os.environ.get(k) for k in ("WEEDTPU_READ_CACHE_MB", "WEEDTPU_READ_CACHE_TTL_S")}
    os.environ.update(WEEDTPU_READ_CACHE_MB="1024", WEEDTPU_READ_CACHE_TTL_S="0")
    read_planner.CACHE.clear()
    try:
        n_warm = count()
        t0 = time.perf_counter()
        ev = ec_volume.EcVolume(base, encoder=enc)
        mount_s = time.perf_counter() - t0
        with ev:
            ev.warm_thread.join()
            warm_s = time.perf_counter() - t0
            warm_launches = count() - n_warm

            def lost_intervals(nid: int) -> int:
                return sum(iv.to_shard_id_and_offset(ev.large, ev.small)[0] in lost_data
                           for iv in ev.locate_needle(nid)[2])

            degraded = {nid for nid in want if lost_intervals(nid)}
            check(degraded and len(degraded) < len(want), f"{len(degraded)} of {len(want)} degraded")
            # a degraded needle's lost interval is its 1 MiB body part or the
            # 32-byte tail it runs into the next block: timed apart
            big = {nid for nid in degraded if max(
                iv.size for iv in ev.locate_needle(nid)[2]
                if iv.to_shard_id_and_offset(ev.large, ev.small)[0] in lost_data) >= 64 << 10}
            lat: dict[str, list] = {"local": [], "degraded": [], "degraded_1m": [],
                                    "degraded_tail": []}
            cold_ms = None
            n0 = count()
            t_serial = time.perf_counter()
            with trace.collect() as spans:
                for nid in want:
                    t = time.perf_counter()
                    blob = ev.read_needle_blob(nid)
                    ms = (time.perf_counter() - t) * 1e3
                    check(blob == want[nid], f"needle {nid}: blob differs from the .dat")
                    if nid in degraded and cold_ms is None:
                        cold_ms = ms
                    lat["degraded" if nid in degraded else "local"].append(ms)
                    if nid in degraded:
                        lat["degraded_1m" if nid in big else "degraded_tail"].append(ms)
            serial_launches = count() - n0
            serial_s = time.perf_counter() - t_serial
            anatomy = {label: decode_anatomy(ev, nid, lost_data) for label, nid in (
                ("1m", min(big)), ("tail", min(degraded - big)))} if big and degraded - big else None
            on_card = enc.device.type == "cuda"  # a CPU rehearsal launches nothing
            check(serial_launches > 0 or not on_card,
                  f"{enc.variant} never launched in the serial reads")
            span_s = {k: sum(x["seconds"] for x in spans if x["name"] == k)
                      for k in ("ec.recover", "ec.gather", "ec.decode")}
            n_intervals = sum(lost_intervals(nid) for nid in degraded)

            # ranges of 12 small blocks: two intervals on each lost data
            # shard, decoded together by one bucketed reconstruct_batch
            n_large = locate.large_row_count(size, ev.large)
            small0 = n_large * ev.large * 10
            rows = (size - small0) // (10 * ev.small)  # whole small rows
            range_ms, n1 = [], count()
            starts = rng.choice(rows - 1, min(4, rows - 1), replace=False) if rows >= 2 else []
            with open(base + ".dat", "rb") as f:
                for row in starts:
                    off, length = small0 + int(row) * 10 * ev.small, 12 * ev.small
                    ivs = locate.locate_data(ev.large, ev.small, ev.dat_file_size, off, length)
                    t = time.perf_counter()
                    got = ev.read_intervals(ivs)
                    range_ms.append((time.perf_counter() - t) * 1e3)
                    check(got == _expected(f, off, length), f"range at {off} differs from the .dat")
            range_launches = count() - n1

            read_planner.CACHE.clear()  # the threaded pass decodes again
            n2 = count()
            t = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                blobs = dict(zip(want, pool.map(ev.read_needle_blob, want)))
            threaded_s = time.perf_counter() - t
            threaded_launches = count() - n2
            check(blobs == want, "a blob read from 8 threads differs from the .dat")
            check(threaded_launches > 0 or not on_card, "the threaded pass launched nothing")

            again = sorted(degraded)[:32]
            n3 = count()
            with trace.collect() as repeat_spans:
                for nid in again:
                    check(ev.read_needle_blob(nid) == want[nid], f"cached needle {nid} differs")
            hits = sum(x["name"] == "cache.hit" for x in repeat_spans)
            repeat_launches = count() - n3
            check(hits > 0 and repeat_launches == 0,
                  f"repeat pass: {hits} cache hits, {repeat_launches} launches")

            deleted = keys[sample[-1]]  # every read is done: a sampled needle will do
            check(ev.delete_needle(deleted), "delete_needle found nothing to delete")
            for nid, cls in ((deleted, ec_volume.NeedleDeleted), (keys[-1], ec_volume.NeedleNotFound)):
                try:
                    ev.read_needle_blob(nid)
                    check(False, f"needle {nid} read after its delete")
                except cls:
                    pass
    finally:
        _put_env(env0)
        read_planner.CACHE.clear()
    n_deg = len(lat["degraded"])
    return {
        "card": card, "variant": enc.variant, "needles": len(want), "degraded_needles": n_deg,
        "degraded_intervals": n_intervals,
        "record_bytes": record, "mount_s": mount_s, "warm_s": warm_s,
        "warm_launches": warm_launches, "cold_first_degraded_ms": cold_ms,
        "local_p50_ms": _pct(lat["local"], 0.5), "local_p99_ms": _pct(lat["local"], 0.99),
        "degraded_p50_ms": _pct(lat["degraded"], 0.5),
        "degraded_p99_ms": _pct(lat["degraded"], 0.99),
        "degraded_1m_reads": len(lat["degraded_1m"]),
        "degraded_1m_p50_ms": _pct(lat["degraded_1m"], 0.5),
        "degraded_1m_p99_ms": _pct(lat["degraded_1m"], 0.99),
        "degraded_tail_p50_ms": _pct(lat["degraded_tail"], 0.5),
        "degraded_tail_p99_ms": _pct(lat["degraded_tail"], 0.99),
        "serial_launches": serial_launches, "launches_per_degraded_read": serial_launches / n_deg,
        "span_s": span_s,
        "range_reads": len(range_ms), "range_bytes": 12 * ev.small,
        "range_p50_ms": _pct(range_ms, 0.5), "range_launches": range_launches,
        "serial_s": serial_s, "threaded_s": threaded_s, "threaded_launches": threaded_launches,
        "decode_anatomy_ms": anatomy,
        "repeat_reads": len(again), "repeat_cache_hits": hits, "repeat_launches": repeat_launches,
        "all_equal": True, "deleted_raises": "NeedleDeleted",
    }


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(64 << 20)
            if not b:
                return h.hexdigest()
            h.update(b)


def run_volume(base: str, gib: float, large_block: int, seed: int, card: str,
               device: str = "cuda", variant: str | None = None) -> dict:
    """One volume through encode, verify, loss, rebuild and decode. With
    `variant` None the commands build their encoder with the factory;
    otherwise they get `Encoder(10, 4, variant=variant)`. Launches are
    counted for the variant the encoder runs."""
    from seaweedfs_tpu_torch.command import local
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda

    enc = (rs_codec.new_encoder(device=device) if variant is None
           else rs_codec.Encoder(10, 4, device=device, variant=variant))

    def count() -> int:
        return rs_cuda.launches_by_variant.get(enc.variant, 0)

    size, digest, keys = make_volume(base, gib, seed)
    n0 = count()
    with trace.collect() as spans:
        t0 = time.perf_counter()
        enc_out = local.encode(base, device, large_block=large_block, encoder=enc)
        encode_s = time.perf_counter() - t0
    encode_launches = count() - n0
    ver = local.verify(base, device, encoder=enc)
    check(ver["verified"], ver)
    for s in LOST:
        os.remove(stripe.shard_file_name(base, s))
    degraded = degraded_read(base, enc, keys, size, seed, card) if variant is None else None
    os.remove(base + ".dat")  # decode must bring it back from the shards alone
    n1 = count()
    with trace.collect() as rebuild_spans:
        t0 = time.perf_counter()
        reb = local.rebuild(base, device, encoder=enc)
        rebuild_s = time.perf_counter() - t0
    rebuild_launches = count() - n1
    check(reb["rebuilt_shards"] == list(LOST), reb)
    crcs = stripe.read_ec_info(base)["shard_crc32"]
    for s in LOST:
        with open(stripe.shard_file_name(base, s), "rb") as f:
            crc = 0
            while b := f.read(64 << 20):
                crc = zlib.crc32(b, crc)
        check(crc == crcs[s], f"rebuilt shard {s} crc {crc} != .eci {crcs[s]}")
    t0 = time.perf_counter()
    local.decode(base, device)
    decode_s = time.perf_counter() - t0
    check(sha256_file(base + ".dat") == digest, f"{variant}: decoded .dat differs from the original")
    check(os.path.exists(base + ".idx") and os.path.exists(base + ".ecx"), "decode wrote no .idx")
    if device == "cuda":  # the plain version on a CPU rehearsal launches nothing
        check(encode_launches > 0 and rebuild_launches > 0,
              f"{enc.variant} launches: encode {encode_launches}, rebuild {rebuild_launches}")
    n_large, n_small = stripe.stripe_layout(size, large_block, 1 << 20)

    def total(recorded: list, name: str) -> tuple[int, float]:
        hits = [s["seconds"] for s in recorded if s["name"] == name]
        return len(hits), sum(hits)

    encode_batches, stage = total(spans, "encode.stage")
    _, drain = total(spans, "encode.drain")
    rebuild_batches, rebuild_stage = total(rebuild_spans, "rebuild.stage")
    _, rebuild_drain = total(rebuild_spans, "rebuild.drain")
    shard = enc_out["shard_bytes"]
    return {
        "variant": enc.variant, "tile": enc.tile, "selection": enc.selection.get("source"),
        "dat_bytes": size, "large_block": large_block, "rows_large": n_large,
        "rows_small": n_small, "shard_bytes": shard,
        "encode_s": encode_s, "encode_gbps": size / encode_s / 1e9,
        "encode_stage_s": stage, "encode_drain_s": drain,
        "rebuild_s": rebuild_s, "rebuild_gbps": 10 * shard / rebuild_s / 1e9,
        "rebuild_stage_s": rebuild_stage, "rebuild_drain_s": rebuild_drain,
        "decode_s": decode_s,
        "encode_batches": encode_batches, "encode_launches": encode_launches,
        "rebuild_batches": rebuild_batches, "rebuild_launches": rebuild_launches,
        "verified": True, "crc_match": True, "decoded_sha256_match": True,
        "card": card, "degraded_read": degraded,
    }


def run_sanitizer(card: str) -> dict:
    """The host codecs' sanitizer driver, built with each sanitizer and
    run at `host_sanitizer.THREADS` on this host. `ok` only where every
    binary exits 0 with its all-clean line; a sanitizer's report goes to
    stderr."""
    from seaweedfs_tpu_torch.ops import host_sanitizer, rs_codec, xorsched

    t0 = time.perf_counter()
    binaries = {}
    for kind, b in host_sanitizer.build().items():
        r = host_sanitizer.run(b["path"])
        binaries[kind] = {"compiler": b["compiler"], "build_s": b["seconds"],
                          "run_s": r["seconds"], "rc": r["rc"], "clean": r["clean"],
                          "lines": r["lines"], "last_line": r["last_line"]}
        if not r["clean"]:
            print(f"[sanitizer {kind}] {r['stderr']}", file=sys.stderr)
    return {"phase": "sanitizer", "card": card, "host": rs_codec._host_fingerprint(),
            "xor_simd": xorsched.native_level(), "threads": list(host_sanitizer.THREADS),
            "binaries": binaries, "seconds": time.perf_counter() - t0,
            "ok": all(b["clean"] for b in binaries.values())}


def _host_gbps(fn, in_bytes: int, runs: int) -> tuple:
    """(fn's result, GB/s of input bytes over its best of `runs` calls)."""
    best, out = float("inf"), None
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, in_bytes / best / 1e9


def run_host_codec(base: str, vol: dict, seed: int, card: str, device: str = "cuda") -> dict:
    """The host codecs on the card's host (`native`, the AVX2 split table
    of `csrc/gf_host.cc` on all cores, and `xorsched`, its XOR-schedule
    executor at the knobs' defaults, and that executor's numpy
    interpreter): the host's fingerprint and SIMD levels, each codec
    byte-exact (tolerance 0) against the int8 kernel and its plain version
    at the encode shape (4, 10) x 4 MiB and the degraded shape (1, 10) x
    4 KiB, with its GB/s there; then the factory volume at `base` (its
    shards rebuilt on the card by `run_volume`) loses LOST again and is
    rebuilt by `command.local.rebuild` with a native and then an xorsched
    encoder, each rebuilt shard's sha256 equal to the card rebuild's. Its
    rebuild GB/s (survivor bytes, the survivors in the page cache from the
    card's run) beside the card's from `vol`: the card/native ratio is the
    AVX2 baseline on the card's own host, a reading."""
    from seaweedfs_tpu_torch.command import local
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda, xorsched
    from seaweedfs_tpu_torch.utils import native

    t_phase = time.perf_counter()
    out = {"phase": "host_codec", "card": card, "host": rs_codec._host_fingerprint(),
           "has_avx2": native.has_avx2(), "has_mt": native.has_mt(),
           "xor_simd": xorsched.native_level(), "native_available": xorsched.native_available(),
           "tolerance": 0}
    check(out["native_available"] and out["xor_simd"] != "unavailable",
          "csrc/gf_host.cc did not build on the card's host: only the interpreter would run")
    rng = np.random.default_rng(seed)
    one_lost = rs_codec.Encoder(10, 4, device="cpu").reconstruction_matrix(
        [s for s in range(14) if s != 5][:10], (5,))
    codecs = {"native": rs_codec.Encoder(10, 4, backend="native"),
              "xorsched": rs_codec.Encoder(10, 4, backend="xorsched")}
    cases = []
    for label, m, n in (("encode", gf8.parity_matrix(10, 4), 4 << 20), ("degraded4k", one_lost, 4096)):
        data = rng.integers(0, 256, (10, n), dtype=np.uint8)
        dev = torch.from_numpy(data).to(device)
        int8 = rs_cuda.apply_matrix(m, dev, variant="int8").cpu().numpy()
        plain = rs_cuda.plain_apply(m, dev, variant="int8").cpu().numpy()
        row = {"shape": label, "matrix": list(m.shape), "data": list(data.shape),
               "plain_equal": bool(np.array_equal(plain, int8))}
        runs = 3 if label == "encode" else 20
        for name, enc in codecs.items():
            got, row[f"{name}_gbps"] = _host_gbps(lambda e=enc: e.project(m, data), data.nbytes, runs)
            row[f"{name}_equal"] = bool(np.array_equal(got, int8))
        # the interpreter at a 64 KiB tile (fewer numpy calls; the bytes are the same)
        prog = xorsched.compile_schedule(m, tile_sym=64 << 10)
        got, row["interpreter_gbps"] = _host_gbps(
            lambda: np.stack(xorsched.apply(prog, list(data))), data.nbytes, 1)
        row["interpreter_equal"] = bool(np.array_equal(got, int8))
        row["equal"] = all(v for k, v in row.items() if k.endswith("_equal"))
        row["max_abs_err"] = 0 if row["equal"] else 255
        cases.append(row)
    out["cases"] = cases
    check(all(c["equal"] for c in cases), f"host codecs disagree with the int8 kernel: {cases}")
    card_sha = {s: sha256_file(stripe.shard_file_name(base, s)) for s in LOST}
    shard = vol["shard_bytes"]
    rebuilds = {"card": {"gbps": vol["rebuild_gbps"], "seconds": vol["rebuild_s"],
                         "variant": vol["variant"]}}
    for name, enc in codecs.items():
        for s in LOST:
            os.remove(stripe.shard_file_name(base, s))
        t0 = time.perf_counter()
        reb = local.rebuild(base, "cpu", encoder=enc)
        seconds = time.perf_counter() - t0
        check(reb["rebuilt_shards"] == list(LOST), reb)
        same = {s: sha256_file(stripe.shard_file_name(base, s)) == card_sha[s] for s in LOST}
        check(all(same.values()), f"{name} rebuild differs from the card's: {same}")
        rebuilds[name] = {"seconds": seconds, "gbps": 10 * shard / seconds / 1e9,
                          "sha256_equal": True}
    out["rebuild"] = {"shard_bytes": shard, "survivor_bytes": 10 * shard, "lost": list(LOST),
                      "page_cache": "warm", **rebuilds}
    out["card_over_native"] = rebuilds["card"]["gbps"] / rebuilds["native"]["gbps"]
    out["card_over_xorsched"] = rebuilds["card"]["gbps"] / rebuilds["xorsched"]["gbps"]
    out["schedule_cache"] = xorsched.schedule_cache_info()
    out["seconds"] = time.perf_counter() - t_phase
    check(out["seconds"] <= 20.0, f"the host_codec phase took {out['seconds']:.1f} s (> 20 s)")
    return out


MESH_LOST = (0, 5, 11, 13)


def _mesh_group(src: str, work: str, devices: list, single: dict, device: str) -> dict:
    """One mesh over `devices`: volume `src` encoded, then MESH_LOST rebuilt
    with each formulation, every shard file held to `src`'s single-card
    ones; the launches by (R, C) held to `single` (the e2e line of `src`)
    times the mesh's positions (x sp for the ring); then the dry run."""
    from seaweedfs_tpu_torch.command import local
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda
    from seaweedfs_tpu_torch.parallel import backend as mesh_backend
    from seaweedfs_tpu_torch.parallel import dryrun
    from seaweedfs_tpu_torch.scripts.mesh_bench import same_file

    dp, sp = mesh_backend.default_mesh_shape(len(devices))
    base = os.path.join(work, "2")
    os.makedirs(work)
    for ext in (".dat", ".idx"):
        os.link(src + ext, base + ext)
    out: dict = {"devices": [str(d) for d in devices], "mesh": f"{dp}x{sp}"}

    def mesh_encoder(rebuild=None):
        return rs_codec.Encoder(10, 4, backend="mesh", device=device, mesh_shape=(dp, sp),
                                mesh_rebuild=rebuild, mesh_devices=devices)

    shapes0 = dict(rs_cuda.launches_by_shape)
    t0 = time.perf_counter()
    local.encode(base, device, large_block=64 << 20, encoder=mesh_encoder())
    out["encode_s"] = time.perf_counter() - t0
    out["encode_launches"] = _shape_keys(_shape_launches(shapes0))
    t0 = time.perf_counter()
    for s in range(14):
        check(same_file(stripe.shard_file_name(base, s), stripe.shard_file_name(src, s)),
              f"mesh {dp}x{sp}: shard {s} differs from the single-card encode")
    out["compare_s"] = time.perf_counter() - t0
    positions = dp * sp
    if device == "cuda":
        check(_shape_launches(shapes0) == {(4, 10): positions * single["encode_launches"]},
              f"mesh encode launched {out['encode_launches']}, want {positions} x "
              f"{single['encode_launches']} (4, 10)")
    for rebuild in ("ring", "alltoall"):
        for s in MESH_LOST:
            os.remove(stripe.shard_file_name(base, s))
        shapes0 = dict(rs_cuda.launches_by_shape)
        t0 = time.perf_counter()
        reb = local.rebuild(base, device, encoder=mesh_encoder(rebuild))
        out[f"rebuild_{rebuild}_s"] = time.perf_counter() - t0
        got = _shape_launches(shapes0)
        out[f"rebuild_{rebuild}_launches"] = _shape_keys(got)
        check(reb["rebuilt_shards"] == list(MESH_LOST), reb)
        for s in MESH_LOST:
            check(same_file(stripe.shard_file_name(base, s), stripe.shard_file_name(src, s)),
                  f"mesh {dp}x{sp} {rebuild}: rebuilt shard {s} differs")
        if device == "cuda":
            want = ({(4, -(-10 // sp)): positions * sp * single["rebuild_launches"]}
                    if rebuild == "ring" else
                    {(4, -(-10 // sp) * sp): positions * single["rebuild_launches"]})
            check(got == want, f"mesh {rebuild} rebuild launched {got}, want {want}")
    shutil.rmtree(work)
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.dryrun(devices, large_mib=64)
    if len(devices) < 8:
        out["dryrun_dcn"] = dryrun.dryrun(devices * -(-8 // len(devices)), large_mib=64)
    out["dryrun_s"] = time.perf_counter() - t0
    return out


def run_mesh(scratch: str, single: dict, card: str, device: str = "cuda") -> dict:
    """The mesh phase (see the module doc) over volume 2 as e2e left it;
    `single` is that volume's e2e line. Returns the phase's line, with the
    launches of its run by variant and by device."""
    from seaweedfs_tpu_torch.ops import rs_cuda

    t_phase = time.perf_counter()
    one = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    groups = [[one] * 4]
    if device == "cuda" and torch.cuda.device_count() > 1:
        groups.append([torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    rs_cuda.reset_launches()  # the mesh path's run starts here
    out = {"card": card, "groups": [
        _mesh_group(os.path.join(scratch, "2"), os.path.join(scratch, f"mesh{k}"), devs,
                    single, device)
        for k, devs in enumerate(groups)]}
    out["launches"] = dict(rs_cuda.launches_by_variant)
    out["launches_by_device"] = dict(rs_cuda.launches_by_device)
    out["seconds"] = time.perf_counter() - t_phase
    if device == "cuda":
        check(set(out["launches_by_device"]) == {str(d) for g in groups for d in g},
              f"mesh launches by device {out['launches_by_device']}")
    return out


def _crc_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while b := f.read(64 << 20):
            crc = zlib.crc32(b, crc)
    return crc


def _check_rebuilt(base: str, shards, golden: dict, what: str) -> dict:
    """Each rebuilt shard's CRC equals the .eci record, and its sha256 the
    one taken of the locally rebuilt file before it was deleted; returns
    {shard: sha256}."""
    from seaweedfs_tpu_torch.ec import stripe

    crcs = stripe.read_ec_info(base)["shard_crc32"]
    shas = {}
    for s in shards:
        path = stripe.shard_file_name(base, s)
        check(_crc_file(path) == crcs[s], f"{what}: shard {s} crc differs from the .eci")
        shas[s] = sha256_file(path)
        check(shas[s] == golden[s], f"{what}: shard {s} differs from the local rebuild's")
    return shas


def _shape_launches(before: dict) -> dict:
    """Launches by matrix (R, C) since the `rs_cuda.launches_by_shape`
    snapshot `before`."""
    from seaweedfs_tpu_torch.ops import rs_cuda

    now = dict(rs_cuda.launches_by_shape)
    return {k: n - before.get(k, 0) for k, n in now.items() if n > before.get(k, 0)}


def _shape_keys(by_shape: dict) -> dict:
    """{"RxC": n}: launches by shape as a JSON object."""
    return {f"{r}x{c}": n for (r, c), n in sorted(by_shape.items())}


def _stage_drain(recorded: list) -> dict:
    return {name: sum(x["seconds"] for x in recorded if x["name"] == name)
            for name in ("rebuild.stage", "rebuild.drain")}


def repair_remote(base: str, enc, golden: dict, on_card: bool) -> dict:
    """(a) LOST rebuilt from `RemoteSlabSource`s, two holders per survivor,
    whose `fetch` reads the shard file by position; the first holder of
    shards 1 and 6 fails from its fourth fetch on."""
    import threading

    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_cuda

    for s in LOST:
        os.remove(stripe.shard_file_name(base, s))
    present = [s for s in range(enc.total_shards) if s not in LOST]
    shard = os.path.getsize(stripe.shard_file_name(base, present[0]))
    lock = threading.Lock()
    served = {"dying": 0}

    def make_fetch(fd: int):
        def fetch(addr: str, offset: int, size: int) -> bytes:
            if addr == "dying":
                with lock:
                    served["dying"] += 1
                    gone = served["dying"] > 3
                if gone:
                    raise IOError("holder 'dying' lost mid-rebuild")
            return os.pread(fd, size, offset)
        return fetch

    with contextlib.ExitStack() as stack:
        sources = {}
        for s in present:
            fd = os.open(stripe.shard_file_name(base, s), os.O_RDONLY)
            stack.callback(os.close, fd)
            holders = ["dying" if s in (1, 6) else f"p{s}", f"b{s}"]
            sources[s] = stack.enter_context(stripe.RemoteSlabSource(s, holders, make_fetch(fd)))
        n0, shape0 = rs_cuda.launches, dict(rs_cuda.launches_by_shape)
        with trace.collect() as spans:
            t0 = time.perf_counter()
            rebuilt = stripe.rebuild_ec_files_from_sources(base, sources, shard, encoder=enc)
            seconds = time.perf_counter() - t0
        launches, by_shape = rs_cuda.launches - n0, _shape_launches(shape0)
    batches = sum(x["name"] == "rebuild.stage" for x in spans)
    failovers = {s: src.failovers for s, src in sources.items() if src.failovers}
    check(rebuilt == list(LOST), f"remote rebuilt {rebuilt}")
    _check_rebuilt(base, LOST, golden, "remote")
    check(sorted(failovers) in ([1], [6], [1, 6]) and served["dying"] > 3,
          f"no failover where the holder died: {failovers}, {served}")
    check(by_shape == ({(len(LOST), 10): batches} if on_card else {}),
          f"remote: launches {by_shape} for {batches} batches")
    return {"shard_bytes": shard, "seconds": seconds, "gbps": 10 * shard / seconds / 1e9,
            "batches": batches, "launches": launches,
            "launches_by_shape": _shape_keys(by_shape), "failovers": failovers,
            "dying_fetches": served["dying"],
            "bytes_fetched": sum(src.bytes_fetched for src in sources.values()),
            "span_s": _stage_drain(spans)}


def repair_trace(base: str, enc, golden: dict, on_card: bool) -> dict:
    """(b) Shard 5 rebuilt from projections: three remote holder groups
    whose `fetch` plays the holder's half (read the group's window, project
    it with `enc.project` from the source's fetch threads) and the last
    survivor as a `LocalProjectionSource`."""
    import threading

    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_cuda

    os.remove(stripe.shard_file_name(base, 5))
    shard = os.path.getsize(stripe.shard_file_name(base, 0))
    plan = enc.repair_projection_plan(TRACE_SURVIVORS, (5,))
    cols = lambda sids: np.stack([plan[s] for s in sids], axis=1)  # noqa: E731
    lock = threading.Lock()
    projections = {"n": 0}

    def holder(fds: list, coeffs: np.ndarray):
        def fetch(offset: int, size: int) -> bytes:
            actual = max(0, min(size, shard - offset))
            stack = np.empty((len(fds), actual), dtype=np.uint8)
            for i, fd in enumerate(fds):
                check(os.preadv(fd, [stack[i]], offset) == actual, "short survivor read")
            with lock:
                projections["n"] += 1
            return enc.project(coeffs, stack).tobytes()
        return fetch

    with contextlib.ExitStack() as stack:
        groups = []
        for i, sids in enumerate(TRACE_GROUPS):
            fds = [os.open(stripe.shard_file_name(base, s), os.O_RDONLY) for s in sids]
            for fd in fds:
                stack.callback(os.close, fd)
            groups.append(stack.enter_context(
                stripe.TraceSlabSource(f"h{i}", sids, 1, holder(fds, cols(sids)))))
        local = TRACE_SURVIVORS[9:]
        groups.append(stack.enter_context(stripe.LocalProjectionSource(
            [stripe.shard_file_name(base, s) for s in local], cols(local), enc)))
        n0, shape0 = rs_cuda.launches, dict(rs_cuda.launches_by_shape)
        with trace.collect() as spans:
            t0 = time.perf_counter()
            rebuilt = stripe.rebuild_ec_files_from_projections(base, groups, shard, [5], encoder=enc)
            seconds = time.perf_counter() - t0
        launches, by_shape = rs_cuda.launches - n0, _shape_launches(shape0)
    batches = sum(x["name"] == "rebuild.stage" for x in spans)
    wire = sum(g.bytes_fetched for g in groups)
    check(rebuilt == [5], f"trace rebuilt {rebuilt}")
    _check_rebuilt(base, [5], golden, "trace")
    check(wire == len(TRACE_GROUPS) * shard < 9 * shard, f"trace wire bytes {wire}")
    # each kind launches at its own (R, C): a holder's (1, 3) projection per
    # fetch, the local group's (1, 1) projection and the (1, 4) combine per
    # batch
    kinds = {"holder_projections": (1, 3), "local_projections": (1, 1), "combines": (1, 4)}
    by_kind = {kind: by_shape.get(rc, 0) for kind, rc in kinds.items()}
    want = {"holder_projections": projections["n"], "local_projections": batches,
            "combines": batches}
    check((by_kind == want and sum(by_kind.values()) == launches) if on_card else not by_shape,
          f"trace: launches {by_shape} by shape, want {want}")
    return {"shard_bytes": shard, "seconds": seconds, "gbps": 10 * shard / seconds / 1e9,
            "batches": batches, "launches": launches, "holder_fetches": projections["n"],
            "launches_by_kind": by_kind,
            "wire_bytes": wire, "slab_wire_bytes": 9 * shard, "span_s": _stage_drain(spans)}


def repair_fused(vols: list, enc, goldens: dict, on_card: bool) -> dict:
    """(c) Three volumes of two geometries and three loss patterns through
    `rebuild_ec_files_batch`, fused and then unfused; `vols` is [(base,
    lost)]."""
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_cuda

    runs, shas = {}, {}
    for fuse in (True, False):
        with contextlib.ExitStack() as stack:
            jobs = []
            for base, lost in vols:
                venc = stripe.encoder_for_base(base, enc)
                for s in lost:
                    os.remove(stripe.shard_file_name(base, s))
                present = [s for s in range(venc.total_shards) if s not in lost]
                jobs.append({
                    "base": base, "encoder": venc, "missing": list(lost),
                    "shard_size": os.path.getsize(stripe.shard_file_name(base, present[0])),
                    "sources": {s: stack.enter_context(
                        stripe.LocalSlabSource(stripe.shard_file_name(base, s))) for s in present},
                })
            n0, shape0 = rs_cuda.launches, dict(rs_cuda.launches_by_shape)
            with trace.collect() as spans:
                t0 = time.perf_counter()
                res = stripe.rebuild_ec_files_batch(jobs, encoder=enc, fuse=fuse)
                seconds = time.perf_counter() - t0
            launches, by_shape = rs_cuda.launches - n0, _shape_launches(shape0)
        check(not res["errors"], f"fused={fuse}: {res['errors']}")
        check(res["signature_groups"] == 3 and res["dispatch_groups"] == (1 if fuse else 3), res)
        check(res["rebuilt"] == {b: list(lost) for b, lost in vols}, res["rebuilt"])
        shas[fuse] = {b: _check_rebuilt(b, lost, goldens[b], f"fused={fuse}") for b, lost in vols}
        # the launches each pipeline makes, at its volume's (len(lost), k):
        # one per block per batch fused, one per batch of each signature's
        # own pipeline unfused
        sizes = [j["shard_size"] for j in jobs]
        if fuse:
            span = _aligned_span(max(j["encoder"].data_shards for j in jobs))
            starts = np.cumsum([0] + sizes)
            per_volume = [(b - 1) // span - a // span + 1 for a, b in zip(starts, starts[1:])]
        else:
            per_volume = [-(-n // _aligned_span(j["encoder"].data_shards))
                          for n, j in zip(sizes, jobs)]
        want = {(len(j["missing"]), j["encoder"].data_shards): n for j, n in zip(jobs, per_volume)}
        check(by_shape == (want if on_card else {}) and sum(by_shape.values()) == launches,
              f"fused={fuse}: launches {by_shape} by shape, want {want}")
        survivor_bytes = sum(j["encoder"].data_shards * j["shard_size"] for j in jobs)
        runs["fused" if fuse else "unfused"] = {
            "seconds": seconds, "gbps": survivor_bytes / seconds / 1e9, "launches": launches,
            "launches_by_shape": _shape_keys(by_shape),
            "batches": sum(x["name"] == "rebuild.stage" for x in spans),
            "dispatch_groups": res["dispatch_groups"], "signature_groups": res["signature_groups"],
            "volumes_fused": res["volumes_fused"], "span_s": _stage_drain(spans),
        }
    runs["volumes"] = [{"base": os.path.basename(b), "lost": list(lost),
                        "geometry": stripe.geometry_from_info(stripe.read_ec_info(b)).family,
                        "shard_bytes": os.path.getsize(stripe.shard_file_name(b, lost[0]))}
                       for b, lost in vols]
    check(shas[True] == shas[False], "the fused and unfused runs wrote different bytes")
    runs["same_bytes"] = shas[True] == shas[False]
    return runs


def _aligned_span(k: int, buffer_size: int = 4 << 20, max_batch_bytes: int = 64 << 20) -> int:
    """A rebuild batch's span for k survivor rows at the pipelines' defaults."""
    return max(1, max_batch_bytes // (k * buffer_size)) * buffer_size


def run_repair(scratch: str, seed: int, card: str, extra_gib: float = REPAIR_GIB,
               device: str = "cuda") -> dict:
    """The repair phase over volumes 1 and 2 as `run_volume` left them
    (every shard present, the lost ones rebuilt locally): golden sha256s of
    the files to be rebuilt, two more volumes for the fused batch (made and
    encoded before the launch counts are reset), then the remote, trace and
    fused rebuilds. Returns the phase's line, with the launches of its run
    by variant."""
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda

    enc = rs_codec.new_encoder(device=device)
    on_card = device == "cuda"
    v1, v2 = os.path.join(scratch, "1"), os.path.join(scratch, "2")
    c12, v10 = os.path.join(scratch, "c12"), os.path.join(scratch, "v10")
    for base, family, k in ((c12, "cauchy_12_3", 7), (v10, "rs_10_4", 8)):
        make_volume(base, extra_gib, seed + k)
        stripe.write_ec_files(base, encoder=rs_codec.new_encoder(family=family, device=device))
    vols = [(v2, LOST), (c12, FUSED_LOST["c12"]), (v10, FUSED_LOST["v10"])]
    goldens = {b: {s: sha256_file(stripe.shard_file_name(b, s)) for s in lost} for b, lost in vols}
    golden1 = {s: sha256_file(stripe.shard_file_name(v1, s)) for s in LOST}
    rs_cuda.reset_launches()  # the repair path's run starts here
    out = {"card": card, "variant": enc.variant,
           "remote": repair_remote(v1, enc, golden1, on_card),
           "trace": repair_trace(v1, enc, golden1, on_card),
           "fused": repair_fused(vols, enc, goldens, on_card)}
    out["launches"] = dict(rs_cuda.launches_by_variant)
    check(out["launches"].get(enc.variant, 0) > 0 or not on_card,
          f"the repair path never launched {enc.variant}")
    return out


def _encode_batches(n_rows: int, block: int, buffer: int, max_batch: int, k: int) -> int:
    """Batches (one launch each on a card) of one `_encode_rows` call: its
    segments of `buffer` bytes per row, `max_batch // (k * buffer)` a batch."""
    buffer = min(buffer, block)
    return -(-n_rows * (block // buffer) // max(1, max_batch // (k * buffer)))


def _convert_batches(dat_size: int, large: int, small: int, geom, buffer: int = 1 << 20,
                     batch: int = 64 << 20, journal: int = 64 << 20) -> int:
    """Launches of a conversion to `geom` at `convert_ec_files`' defaults: each
    row tier in journal chunks of rows, one `_encode_rows` call per chunk."""
    from seaweedfs_tpu_torch.ec import stripe

    n_large, n_small = stripe.stripe_layout(dat_size, large, small, geom.data_shards)
    total = 0
    for block, rows in ((large, n_large), (small, n_small)):
        per_chunk = max(1, journal // (block * geom.total_shards))
        for row in range(0, rows, per_chunk):
            total += _encode_batches(min(per_chunk, rows - row), block, buffer, batch,
                                     geom.data_shards)
    return total


def _sha_set(base: str, total: int) -> list:
    from seaweedfs_tpu_torch.ec import stripe

    return [sha256_file(stripe.shard_file_name(base, s)) for s in range(total)]


def _unlink_set(base: str, total: int) -> None:
    from seaweedfs_tpu_torch.ec import stripe

    for s in range(total):
        os.remove(stripe.shard_file_name(base, s))
    os.remove(base + ".eci")


def _warm_oracle(kept: str, d: str, name: str, enc, large: int, small: int = 1 << 20) -> dict:
    """sha256 of every shard and the .eci of a warm encode of the .dat
    `kept` with `enc`, and its seconds; the files are removed after."""
    from seaweedfs_tpu_torch.ec import stripe

    ob = os.path.join(d, name)
    os.link(kept, ob + ".dat")
    t0 = time.perf_counter()
    stripe.write_ec_files(ob, large, small, encoder=enc)
    seconds = time.perf_counter() - t0
    out = {"shards": _sha_set(ob, enc.total_shards), "eci": stripe.read_ec_info(ob),
           "seconds": seconds}
    _unlink_set(ob, enc.total_shards)
    os.remove(ob + ".dat")
    return out


def run_ingest(scratch: str, seed: int, card: str, gib: float = INGEST_GIB,
               large: int = INGEST_LARGE, append: int = INGEST_APPEND,
               overwrites: int = OVERWRITES, manager_mib: int = 160,
               device: str = "cuda") -> dict:
    """The ingest phase (see the module doc). Returns its line, with the
    volume's base, keys and size for the next phases under "_volume"."""
    import threading

    from seaweedfs_tpu_torch.ec import ingest, stripe
    from seaweedfs_tpu_torch.ec.constants import EC_BUFFER_SIZE
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda

    enc = rs_codec.new_encoder(device=device)
    on_card = device == "cuda"
    small, k = 1 << 20, enc.data_shards
    d = os.path.join(scratch, "slice")
    os.makedirs(d, exist_ok=True)
    base = os.path.join(d, "1")
    state = {"builder": None, "poll_s": 0.0, "polls": 0, "rows": []}

    def on_append() -> None:
        if state["builder"] is None:
            state["builder"] = ingest.InlineStripeBuilder(base, enc, large, small)
        t = time.perf_counter()
        n = state["builder"].poll()
        state["poll_s"] += time.perf_counter() - t
        state["polls"] += 1
        if n:
            state["rows"].append(n)

    rs_cuda.reset_launches()  # the ingest path's run starts here
    t_grow = time.perf_counter()
    size, _, keys = make_volume(base, gib, seed, on_append=on_append, append_bytes=append)
    grow_s = time.perf_counter() - t_grow
    b = state["builder"]
    n_large, n_small = stripe.stripe_layout(size, large, small)
    check(b.rows_done == n_large, f"ingest: {b.rows_done} rows inline, layout has {n_large}")
    # overwrites into encoded rows; every fourth straddles a block edge
    rng = np.random.default_rng(seed + 300)
    limit = b.encoded_limit()
    segments, patched = 0, 0
    t0 = time.perf_counter()
    with open(base + ".dat", "r+b") as f:
        for i in range(overwrites):
            length = int(rng.integers(4096, (1 << 20) + 1))
            if i % 4 == 0:
                off = int(rng.integers(1, limit // large)) * large - length // 2
            else:
                off = int(rng.integers(4096, limit - length))
            f.seek(off)
            old, new = f.read(length), rng.bytes(length)

            def mutate(off=off, new=new) -> None:
                f.seek(off)
                f.write(new)
                f.flush()

            patched += b.overwrite(off, old, new, mutate=mutate)
            segments += (off + length - 1) // large - off // large + 1
    overwrite_s = time.perf_counter() - t0
    delta = dict(b.delta_stats)
    t0 = time.perf_counter()
    info = b.seal()
    seal_s = time.perf_counter() - t0
    by_shape = _shape_launches({})
    launches = dict(rs_cuda.launches_by_variant)
    stripe.write_sorted_file_from_idx(base)
    # the launches the phase predicts: a poll of n rows batches them under
    # min(64 MiB, n rows); the seal encodes the small-row tail
    want_batches = sum(_encode_batches(n, large, EC_BUFFER_SIZE, min(64 << 20, n * large * k), k)
                       for n in state["rows"])
    want_batches += _encode_batches(n_small, small, EC_BUFFER_SIZE, 64 << 20, k)
    want = {(enc.parity_shards, k): want_batches, (enc.parity_shards, 1): segments}
    check(by_shape == (want if on_card else {}), f"ingest: launches {by_shape}, want {want}")
    check(delta["updates"] == overwrites and patched == delta["changed_bytes"],
          f"ingest: delta stats {delta}, patched {patched}")
    warm = _warm_oracle(base + ".dat", d, "warm", enc, large)
    check(_sha_set(base, enc.total_shards) == warm["shards"],
          "ingest: a sealed shard differs from the warm encode of the final .dat")
    check(stripe.read_ec_info(base) == warm["eci"], "ingest: the .eci differs from the warm one")

    # an IngestManager seals a small volume on its own threads: the worker
    # polls, the seal trigger's thread seals, the main thread only appends
    mbase = os.path.join(d, "m")
    mlarge = 4 << 20

    class _Vol:
        base_path, dat_path, read_only, tiered = mbase, mbase + ".dat", False, False

    class _Store:
        encoder = enc

        def get_volume(self, vid):
            return _Vol()

    sealed, threads, done = {}, set(), threading.Event()

    def trigger(vid: int) -> None:
        try:
            threads.add(threading.current_thread().name)
            sealed.update(mgr.seal_volume(vid, mbase))
        finally:
            done.set()

    mgr = ingest.IngestManager(_Store(), seal_bytes=manager_mib << 20, large_block_size=mlarge,
                               small_block_size=small, seal_trigger=trigger)
    shape0, variant0 = dict(rs_cuda.launches_by_shape), dict(rs_cuda.launches_by_variant)
    try:
        t0 = time.perf_counter()
        make_volume(mbase, manager_mib / 1024, seed + 301, on_append=lambda: mgr.on_write(2),
                    append_bytes=append)
        check(done.wait(300), "manager: the seal never finished")
        manager_s = time.perf_counter() - t0
    finally:
        mgr.close()
    manager_shape = _shape_launches(shape0)
    for v, n in rs_cuda.launches_by_variant.items():
        launches[v] = launches.get(v, 0) + n - variant0.get(v, 0)
    check(sealed.get("mode") == "inline" and threads and "MainThread" not in threads,
          f"manager: {sealed}, seal on {threads}")
    check(sum(manager_shape.values()) > 0 or not on_card, "manager: no launch off the main thread")
    mwarm = _warm_oracle(mbase + ".dat", d, "mwarm", enc, mlarge)
    check(_sha_set(mbase, enc.total_shards) == mwarm["shards"], "manager: shards differ from warm")
    _unlink_set(mbase, enc.total_shards)
    for ext in (".dat", ".idx"):
        os.remove(mbase + ext)
    check(launches.get(enc.variant, 0) > 0 or not on_card,
          f"the ingest path never launched {enc.variant}")
    return {
        "card": card, "variant": enc.variant, "dat_bytes": size, "large_block": large,
        "append_bytes": append, "appends": state["polls"], "rows_inline": info["rows_inline"],
        "rows_total": info["rows_total"], "small_rows": info["small_rows"],
        "grow_s": grow_s, "poll_s": state["poll_s"], "overwrites": overwrites,
        "overwrite_s": overwrite_s, "delta_updates": delta["updates"],
        "delta_changed_bytes": delta["changed_bytes"], "delta_bytes": delta["accounted_bytes"],
        "delta_segments": segments, "seal_s": seal_s, "warm_encode_s": warm["seconds"],
        "launches_by_shape": _shape_keys(by_shape),
        "manager": {"dat_bytes": manager_mib << 20, "mode": sealed["mode"],
                    "seal_threads": sorted(threads), "seconds": manager_s,
                    "launches_by_shape": _shape_keys(manager_shape)},
        "launches": launches, "sha256_match": True, "eci_match": True,
        "_volume": {"base": base, "keys": keys, "size": size, "large": large},
    }


def _sample_needles(keys: list, seed: int, n: int = NEEDLES) -> list:
    rng = np.random.default_rng(seed + 400)
    return sorted(int(i) for i in rng.choice(np.arange(1, len(keys) - 1),
                                             min(n, len(keys) - 2), replace=False))


def _read_needles(ev, keys: list, sample: list, kept: str) -> dict:
    """Each sampled needle through `ev` against the kept .dat's bytes."""
    from seaweedfs_tpu_torch.storage import types

    record = types.actual_size((1 << 20) - 8)
    t0 = time.perf_counter()
    with open(kept, "rb") as f:
        for i in sample:
            check(ev.read_needle_blob(keys[i]) == _expected(f, 8 + i * (1 << 20), record),
                  f"needle {keys[i]} differs from the .dat")
    return {"needles": len(sample), "seconds": time.perf_counter() - t0}


def run_convert(vol: dict, seed: int, card: str, device: str = "cuda") -> dict:
    """The convert phase (see the module doc) on the sealed ingest volume."""
    from seaweedfs_tpu_torch.ec import convert, ec_volume, stripe
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda

    enc = rs_codec.new_encoder(device=device)
    on_card = device == "cuda"
    base, keys, size, large = vol["base"], vol["keys"], vol["size"], vol["large"]
    d = os.path.dirname(base)
    kept = os.path.join(d, "kept.dat")
    os.replace(base + ".dat", kept)  # the conversions never read a .dat
    sample = _sample_needles(keys, seed)
    fams = ("cauchy_12_3", "merge_20_4")
    oracles = {f: _warm_oracle(kept, d, f, rs_codec.new_encoder(family=f, device=device), large)
               for f in fams}
    rs_cuda.reset_launches()  # the convert path's run starts here
    runs, run_s = [], []
    reconstruct = enc.reconstruct

    def counted(shards, **kw):  # a degraded run's reconstruct, synchronous: host bytes back
        runs.append(kw.get("wanted"))
        t = time.perf_counter()
        rec = reconstruct(shards, **kw)
        run_s.append(time.perf_counter() - t)
        return rec

    enc.reconstruct = counted
    out = {"card": card, "variant": enc.variant, "dat_bytes": size}
    for step, (fam, lost) in enumerate(((fams[0], CONVERT_LOST), (fams[1], ()))):
        for s in lost:
            os.remove(stripe.shard_file_name(base, s))
        geom = rs_codec.geometry_for(fam)
        shape0, n_runs = dict(rs_cuda.launches_by_shape), len(runs)
        t0 = time.perf_counter()
        res = convert.convert_ec_files(base, fam, encoder=enc)
        seconds = time.perf_counter() - t0
        by_shape = _shape_launches(shape0)
        staged = convert.stage_base(base)
        check(_sha_set(staged, geom.total_shards) == oracles[fam]["shards"],
              f"convert to {fam}: a staged shard differs from the warm encode")
        check(stripe.read_ec_info(staged) == oracles[fam]["eci"], f"convert to {fam}: .eci differs")
        decoded = len(runs) - n_runs
        decode_s = sum(run_s[n_runs:])
        check((res["reconstructed_bytes"] > 0) == bool(lost) and bool(decoded) == bool(lost),
              f"convert to {fam}: {res['reconstructed_bytes']} bytes from {decoded} runs")
        want = {(geom.parity_shards, geom.data_shards): _convert_batches(size, large, 1 << 20, geom)}
        if lost:
            want[(1, 10)] = decoded
        check(by_shape == (want if on_card else {}), f"convert to {fam}: {by_shape}, want {want}")
        acct = convert.reencode_oracle_bytes(base, fam)
        check(acct["total"] == 3 * size + res["bytes_written"], f"oracle bytes {acct}")
        convert.cutover(base)
        # (b) the 12+3 set read with three shards lost; (c) the 20+4 set whole
        aside = C12_LOST if step == 0 else ()
        for s in aside:
            os.replace(stripe.shard_file_name(base, s), stripe.shard_file_name(base, s) + ".aside")
        shape1 = dict(rs_cuda.launches_by_shape)
        with ec_volume.EcVolume(base, encoder=enc, warm_on_mount=False) as ev:
            check((ev.data_shards, ev.total_shards) == (geom.data_shards, geom.total_shards),
                  f"mounted {ev.data_shards} of {ev.total_shards} after cut-over to {fam}")
            reads = _read_needles(ev, keys, sample, kept)
        for s in aside:
            os.replace(stripe.shard_file_name(base, s) + ".aside", stripe.shard_file_name(base, s))
        reads["lost"] = list(aside)
        reads["launches_by_shape"] = _shape_keys(_shape_launches(shape1))
        out[f"to_{fam}"] = {
            "seconds": seconds, "dat_gbps": size / seconds / 1e9, "lost": list(lost),
            "bytes_read": res["bytes_read"], "bytes_written": res["bytes_written"],
            "reconstructed_bytes": res["reconstructed_bytes"], "degraded_runs": decoded,
            "reconstruct_s": decode_s, "reconstruct_share": decode_s / seconds,
            "launches_by_shape": _shape_keys(by_shape), "oracle_bytes": acct["total"],
            "warm_oracle_s": oracles[fam]["seconds"], "reads": reads,
        }
    enc.reconstruct = reconstruct
    out["launches"] = dict(rs_cuda.launches_by_variant)
    check(out["launches"].get(enc.variant, 0) > 0 or not on_card,
          f"the convert path never launched {enc.variant}")
    out.update(sha256_match=True, needles_equal=True, _kept=kept, _sample=sample)
    return out


def run_scrub(vol: dict, kept: str, sample: list, card: str, device: str = "cuda") -> dict:
    """The scrub phase (see the module doc) on the 20+4 set the convert
    phase left."""
    from seaweedfs_tpu_torch.ec import ec_volume, scrub, stripe
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda

    enc = rs_codec.new_encoder(device=device)
    on_card = device == "cuda"
    base, keys = vol["base"], vol["keys"]
    cursor = scrub.ScrubCursor(os.path.join(os.path.dirname(base), "scrub_cursor.json"))
    with ec_volume.EcVolume(base, encoder=enc, warm_on_mount=False) as ev:
        total = ev.total_shards
        shard = os.path.getsize(stripe.shard_file_name(base, 0))
        for s, verdict in SCRUB_DAMAGE.items():
            path = stripe.shard_file_name(base, s)
            if verdict == "corrupt":
                with open(path, "r+b") as f:
                    f.seek(shard // 2)
                    byte = f.read(1)[0]
                    f.seek(shard // 2)
                    f.write(bytes([byte ^ 0x40]))
            elif verdict == "truncated":
                os.truncate(path, shard - 1)
            else:
                os.remove(path)
        rs_cuda.reset_launches()  # the scrub path's run starts here

        def on_finding(vid: int, s: int, verdict: str) -> None:
            ev.quarantine_shard(s, verdict)
            cursor.add_quarantine(vid, s, verdict)

        scrubber = scrub.Scrubber(volumes=lambda: {1: ev}, on_finding=on_finding, cursor_path="",
                                  cursor=cursor, rate_mb=0.0, chunk_bytes=4 << 20)
        t0 = time.perf_counter()
        found = scrubber.run_cycle()
        scan_s = time.perf_counter() - t0
        check({s: v for _, s, v in found["findings"]} == SCRUB_DAMAGE
              and found["shards_ok"] == total - len(SCRUB_DAMAGE),
              f"scrub findings {found['findings']}, {found['shards_ok']} ok")
        # needles with an interval on the corrupt shard read through reconstruction
        bad = next(s for s, v in SCRUB_DAMAGE.items() if v == "corrupt")
        on_bad = [i for i in sample if any(
            iv.to_shard_id_and_offset(ev.large, ev.small)[0] == bad
            for iv in ev.locate_needle(keys[i])[2])]
        check(on_bad, f"no sampled needle lies on shard {bad}")
        shape0 = dict(rs_cuda.launches_by_shape)
        reads = _read_needles(ev, keys, on_bad, kept)
        reads["launches_by_shape"] = _shape_keys(_shape_launches(shape0))
        check(bool(reads["launches_by_shape"]) or not on_card, "quarantined reads launched nothing")
        # the repair: the quarantined files rebuilt by the stripe engine
        for q in cursor.quarantine:
            path = stripe.shard_file_name(base, q["shard"])
            if os.path.exists(path):
                os.remove(path)
        shape1 = dict(rs_cuda.launches_by_shape)
        t0 = time.perf_counter()
        rebuilt = stripe.rebuild_ec_files(base, encoder=ev.encoder)
        repair_s = time.perf_counter() - t0
        repair_shape = _shape_launches(shape1)
        check(rebuilt == sorted(SCRUB_DAMAGE), f"rebuilt {rebuilt}")
        want = {(len(SCRUB_DAMAGE), ev.data_shards): -(-shard // _aligned_span(ev.data_shards))}
        check(repair_shape == (want if on_card else {}), f"repair: {repair_shape}, want {want}")
        for q in list(cursor.quarantine):
            check(ev.mount_local_shard(q["shard"]), f"remount of shard {q['shard']}")
            cursor.remove_quarantine(q["vid"], q["shard"])
        verdicts, has_crcs = scrub.verify_ec_volume(ev)
        check(has_crcs and set(verdicts.values()) == {scrub.OK} and len(verdicts) == total,
              f"after repair: {verdicts}")
    check(scrub.ScrubCursor(cursor.path).quarantine == [], "the cursor keeps quarantine entries")
    launches = dict(rs_cuda.launches_by_variant)
    check(launches.get(enc.variant, 0) > 0 or not on_card,
          f"the scrub path never launched {enc.variant}")
    return {
        "card": card, "variant": enc.variant, "shards": total, "shard_bytes": shard,
        "scanned_bytes": found["scanned_bytes"], "scan_s": scan_s,
        "scan_gbps": found["scanned_bytes"] / scan_s / 1e9,
        "findings": {str(s): v for _, s, v in found["findings"]},
        "quarantined_reads": reads, "repair_s": repair_s, "rebuilt": rebuilt,
        "repair_launches_by_shape": _shape_keys(repair_shape), "verified": True,
        "launches": launches,
    }


def _timed_reads(st, vid: int, sample: list, data, cookies: list, deleted: set) -> dict:
    """Each sampled needle through `Store.read_needle` with its cookie: a
    live one must equal its data, a deleted one raise not-found."""
    ms = []
    for nid in sample:
        t = time.perf_counter()
        try:
            n = st.read_needle(vid, nid, cookie=cookies[nid - 1])
        except KeyError:
            check(nid in deleted, f"live needle {nid} not found")
            continue
        ms.append((time.perf_counter() - t) * 1e3)
        check(nid not in deleted, f"deleted needle {nid} read back")
        check(n.data == data[(nid - 1) * STORE_SIZE: nid * STORE_SIZE], f"needle {nid} differs")
    return {"live": len(ms), "deleted": len(sample) - len(ms), "seconds": sum(ms) / 1e3,
            "p50_ms": _pct(ms, 0.5), "p99_ms": _pct(ms, 0.99)}


def _needle_shards(base: str, sample: list) -> dict:
    """{needle id: the shards its intervals lie on}, for the sampled
    needles the .ecx holds, from the .ecx, the .eci and `ec.locate` alone."""
    from seaweedfs_tpu_torch.ec import locate, stripe
    from seaweedfs_tpu_torch.storage import idx, types

    info = stripe.read_ec_info(base)
    with open(base + ".ecx", "rb") as f:
        index = idx.index_entries_array(f.read())
    out = {}
    for nid in sample:
        pos = int(np.searchsorted(index["key"], np.uint64(nid)))
        if pos == len(index) or int(index["key"][pos]) != nid:
            continue
        size = int(index["size"][pos])
        ivs = locate.locate_data(info["large_block_size"], info["small_block_size"],
                                 info["dat_size"], types.offset_to_actual(int(index["offset"][pos])),
                                 types.actual_size(size), 10)
        out[nid] = {iv.to_shard_id_and_offset(info["large_block_size"],
                                              info["small_block_size"])[0] for iv in ivs}
    return out


def _lost_intervals(base: str, sample: list, lost: tuple) -> dict:
    """{needle id: distinct lost shards its intervals lie on}: a degraded
    read launches once per such shard."""
    return {nid: len(shards & set(lost)) for nid, shards in _needle_shards(base, sample).items()}


def run_store(scratch: str, seed: int, card: str, files: int = STORE_FILES,
              device: str = "cuda") -> dict:
    """The store phase (see the module doc): upstream's `weed benchmark`
    volume through the port's `Store`, its maintenance commands and both
    needle maps, then EC-encoded with four shards lost and read degraded."""
    from seaweedfs_tpu_torch.command import local
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda
    from seaweedfs_tpu_torch.storage import needle, needle_map, store
    from seaweedfs_tpu_torch.utils import native

    check(native.crc32c_impl() == "library", "the compiled CRC32C did not load")
    on_card = device == "cuda"
    d = os.path.join(scratch, "store")
    os.makedirs(d)
    rs_cuda.reset_launches()  # the store path's run starts here
    enc = rs_codec.new_encoder(device=device)
    rng = np.random.default_rng(seed + 500)
    data = rng.bytes(files * STORE_SIZE)
    cookies = rng.integers(0, 1 << 32, files, dtype=np.uint64).tolist()
    deleted = set((rng.choice(files, int(files * STORE_DELETE), replace=False) + 1).tolist())
    sample = sorted((rng.choice(files, min(STORE_SAMPLE, files), replace=False) + 1).tolist())
    out = {"card": card, "source": "weed/command/benchmark.go: -n 1048576 -size 1024 "
           "-collection benchmark -replication 000",
           "reduced": [f"{files} needles, not upstream's -n 1048576 (the script's time)",
                       f"{len(deleted)} seeded deletes added (upstream -deletePercent 0)",
                       f"reads cut to a seeded sample of {len(sample)} of {files}"],
           "files": files, "file_bytes": STORE_SIZE, "crc32c": native.crc32c_impl()}

    # 1-2: write every needle, delete the seeded tenth, read the sample back
    st = store.Store([d], encoder=enc)
    v = st.create_volume(STORE_VID, collection="benchmark", replication="000")
    base = v.base_path
    t0 = time.perf_counter()
    for i in range(files):
        st.write_needle(STORE_VID, needle.Needle(cookie=cookies[i], id=i + 1,
                                                 data=data[i * STORE_SIZE: (i + 1) * STORE_SIZE]))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for nid in sorted(deleted):
        check(st.delete_needle(STORE_VID, nid), f"delete of {nid}")
    out["write"] = {"seconds": write_s, "needles_per_s": files / write_s,
                    "delete_seconds": time.perf_counter() - t0, "dat_bytes": v.content_size(),
                    "garbage_ratio": v.garbage_ratio()}
    out["reads_written"] = _timed_reads(st, STORE_VID, sample, data, cookies, deleted)
    check(st.unmount_volume(STORE_VID), "unmount")

    # 3: fix rebuilds the .idx from the .dat alone
    os.replace(base + ".idx", base + ".idx.orig")
    t0 = time.perf_counter()
    fixed = local.fix(base)
    fix_s = time.perf_counter() - t0
    maps = []
    for path in (base + ".idx.orig", base + ".idx"):
        db = needle_map.MemDb()
        db.load_from_idx(path)
        maps.append(list(db.ascending_visit()))
    check(maps[0] == maps[1], "the rebuilt .idx replays to another map")
    check(fixed["records"] == files + len(deleted), f"fix counted {fixed['records']} records")
    with open(base + ".idx.orig", "rb") as a, open(base + ".idx", "rb") as b:
        same_bytes = a.read() == b.read()
    os.remove(base + ".idx.orig")
    out["fix"] = {"seconds": fix_s, "records": fixed["records"],
                  "live": len(maps[1]), "idx_bytes_equal": same_bytes}

    # 4: export the live needles, one JSON line each, ascending by id
    t0 = time.perf_counter()
    live = [i for i in range(1, files + 1) if i not in deleted]
    lines = wrong = 0
    with open(os.path.join(scratch, "store_export.jsonl"), "w") as f:
        for rec in local.export(base):
            nid = live[lines] if lines < len(live) else 0
            wrong += (rec["id"], rec["cookie"], rec["data_size"]) != (
                f"{nid:x}", f"{cookies[nid - 1]:08x}", STORE_SIZE)
            f.write(json.dumps(rec) + "\n")
            lines += 1
    check(lines == len(live) and not wrong,
          f"export wrote {lines} lines for {len(live)} live needles, {wrong} of them wrong")
    out["export"] = {"seconds": time.perf_counter() - t0, "lines": lines,
                     "bytes": os.path.getsize(os.path.join(scratch, "store_export.jsonl"))}
    os.remove(os.path.join(scratch, "store_export.jsonl"))

    # 5: compact drops the tombstones and the deleted needles
    t0 = time.perf_counter()
    compacted = local.compact(base)
    out["compact"] = {"seconds": time.perf_counter() - t0, "bytes_before": compacted["bytes_before"],
                      "bytes_after": compacted["bytes_after"]}
    check(compacted["bytes_after"] < compacted["bytes_before"], f"compact {compacted}")
    # the cluster and ha phases serve this compacted volume from their first
    # server (ha tiers it: its .dat leaves that directory for remote storage)
    cluster_srv0 = os.path.join(scratch, "cluster", "srv0")
    for srv0 in (cluster_srv0, os.path.join(scratch, "ha", "srv0")):
        os.makedirs(srv0)
        for ext in (".dat", ".idx"):
            dst = os.path.join(srv0, os.path.basename(base) + ext)
            try:
                os.link(base + ext, dst)
            except OSError:
                shutil.copyfile(base + ext, dst)
    check(st.mount_volume(STORE_VID), "remount after compact")
    out["reads_compacted"] = _timed_reads(st, STORE_VID, sample, data, cookies, deleted)
    st.close()

    # 6: a fresh load with each needle-map kind (sorted_file twice: the first
    # mount builds the .sdx, the second maps it)
    out["mounts"] = []
    for kind in ("memory", "sorted_file", "sorted_file"):
        t0 = time.perf_counter()
        st = store.Store([d], encoder=enc, needle_map_kind=kind)
        st.load()
        mount_s = time.perf_counter() - t0
        nm = st.get_volume(STORE_VID).nm
        out["mounts"].append({"kind": kind, "seconds": mount_s,
                              "rebuilt_full": getattr(nm, "rebuilt_full", None),
                              "reads": _timed_reads(st, STORE_VID, sample, data, cookies, deleted)})
        st.close()
    check(out["mounts"][1]["rebuilt_full"] and not out["mounts"][2]["rebuilt_full"],
          "the sorted_file mounts did not build the .sdx once")

    # 7: EC-encode on the card, lose four shards and the .dat, load, read
    t0 = time.perf_counter()
    shape0 = dict(rs_cuda.launches_by_shape)
    encoded = local.encode(base, device=device)
    encode_shape = _shape_launches(shape0)
    out["ec_encode"] = {"seconds": time.perf_counter() - t0, "dat_bytes": encoded["dat_bytes"],
                        "shard_bytes": encoded["shard_bytes"],
                        "launches_by_shape": _shape_keys(encode_shape)}
    for ext in (".dat", ".idx", ".sdx", ".sdx.meta"):
        if os.path.exists(base + ext):
            os.remove(base + ext)
    for s in LOST:
        os.remove(stripe.shard_file_name(base, s))
    lost_on = _lost_intervals(base, sample, LOST)
    check(set(lost_on) == set(sample) - deleted, "the .ecx holds another set of sampled needles")
    widths = []
    dispatch = enc._apply_lazy

    def recorded(m, shards, donate=False, width=None):  # every launch's (R, C, N)
        widths.append((m.shape[0], m.shape[1], int(width or shards.shape[-1])))
        return dispatch(m, shards, donate=donate, width=width)

    enc._apply_lazy = recorded
    try:
        st = store.Store([d], encoder=enc)
        st.load()
        ev = st.get_ec_volume(STORE_VID)
        check(ev is not None and ev.encoder is enc, "the load did not mount the EC volume")
        if ev.warm_thread is not None:
            ev.warm_thread.join()
        infos = [i.to_dict() for i in st.ec_volume_infos()]
        check(len(infos) == 1 and infos[0]["shard_bits"]
              == sum(1 << s for s in range(14) if s not in LOST), f"ec_volume_infos {infos}")
        warm = len(widths)
        shape0 = dict(rs_cuda.launches_by_shape)
        by_class = {"local": [], "degraded": []}
        for nid in sample:
            t = time.perf_counter()
            try:
                n = st.read_needle(STORE_VID, nid, cookie=cookies[nid - 1])
            except KeyError:
                check(nid in deleted, f"live needle {nid} not found in the EC volume")
                continue
            by_class["degraded" if lost_on[nid] else "local"].append(
                (time.perf_counter() - t) * 1e3)
            check(n.data == data[(nid - 1) * STORE_SIZE: nid * STORE_SIZE],
                  f"EC needle {nid} differs")
        by_shape = _shape_launches(shape0)
        st.close()
    finally:
        enc._apply_lazy = dispatch
    predicted = sum(lost_on.values())
    check(by_shape == ({(1, 10): predicted} if on_card else {}),
          f"EC reads launched {by_shape}, predicted (1, 10) x {predicted}")
    check(len(widths) - warm == predicted or not on_card,
          f"{len(widths) - warm} recorded reconstructs for {predicted} launches")
    check(all(n in enc.RECONSTRUCT_BUCKETS for _, _, n in widths) or not on_card,
          f"a reconstruct launched off the buckets: {sorted(set(widths))}")
    out["ec_reads"] = {
        "infos": infos, "lost": list(LOST),
        **{f"{k}_{q}": v for k, xs in by_class.items()
           for q, v in (("reads", len(xs)), ("p50_ms", _pct(xs, 0.5)), ("p99_ms", _pct(xs, 0.99)))},
        "one_lost_interval": sum(1 for x in lost_on.values() if x == 1),
        "launches_by_shape": _shape_keys(by_shape), "predicted_1x10": predicted,
        "warm_launches": warm, "widths": sorted({n for _, _, n in widths}),
    }
    out["launches"] = dict(rs_cuda.launches_by_variant)
    check(out["launches"].get(enc.variant, 0) > 0 or not on_card,
          f"the store path never launched {enc.variant}")
    # the obs and cluster phases read the same volume and sample again
    out["_obs"] = {"dir": d, "encoder": enc, "sample": sample, "data": data, "cookies": cookies,
                   "deleted": deleted, "lost_on": lost_on, "base": base,
                   "encode_shape": encode_shape,
                   "cluster_dir": os.path.dirname(cluster_srv0),
                   "ha_dir": os.path.join(scratch, "ha")}
    return out


def _fetch(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        check(r.status == 200, f"GET {url}: {r.status}")
        return r.read()


def _reconstruct_count(metrics_url: str) -> int:
    """`weedtpu_ec_reconstruct_seconds_count` as the /metrics endpoint
    exposes it."""
    for line in _fetch(metrics_url).decode().splitlines():
        if line.startswith("weedtpu_ec_reconstruct_seconds_count "):
            return int(float(line.split()[-1]))
    raise RuntimeError("/metrics has no weedtpu_ec_reconstruct_seconds_count")


def _obs_pass(st, state: dict, traced: bool, metrics_url: str) -> dict:
    """One pass of the sample through `Store.read_needle` from a cold
    decoded-interval cache; traced: each read inside the `http.read` root the
    volume server's GET opens. -> latencies by class, (1, 10) launches, and
    the rise of the exposed reconstruct count."""
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_cuda

    data, cookies, deleted, lost_on = (state[k] for k in ("data", "cookies", "deleted", "lost_on"))
    os.environ["WEEDTPU_TRACE"] = "on" if traced else "off"
    read_planner.CACHE.clear()  # both passes decode the same intervals
    count0, shape0 = _reconstruct_count(metrics_url), dict(rs_cuda.launches_by_shape)
    by_class = {"local": [], "degraded": []}
    for nid in state["sample"]:
        t = time.perf_counter()
        try:
            with trace.start("http.read", klass="healthy") if traced else contextlib.nullcontext():
                n = st.read_needle(STORE_VID, nid, cookie=cookies[nid - 1])
        except KeyError:
            check(nid in deleted, f"live needle {nid} not found")
            continue
        by_class["degraded" if lost_on[nid] else "local"].append((time.perf_counter() - t) * 1e3)
        check(n.data == data[(nid - 1) * STORE_SIZE: nid * STORE_SIZE], f"needle {nid} differs")
    return {"by_class": {k: {"reads": len(xs), "p50_ms": _pct(xs, 0.5), "p99_ms": _pct(xs, 0.99)}
                         for k, xs in by_class.items()},
            "launches_by_shape": _shape_launches(shape0),
            "count_rise": _reconstruct_count(metrics_url) - count0}


def run_obs(state: dict, seed: int, card: str, device: str = "cuda") -> dict:
    """The obs phase (see the module doc): the store phase's EC volume read
    twice, tracing off then on into a ring that keeps every root, one scrub
    cycle traced, and both endpoints served and read over loopback."""
    import threading

    from seaweedfs_tpu_torch import stats
    from seaweedfs_tpu_torch.ec import scrub
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.storage import store
    from seaweedfs_tpu_torch.utils import httpd

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    sample, lost_on, deleted = state["sample"], state["lost_on"], state["deleted"]
    live = [n for n in sample if n not in deleted]
    predicted = sum(lost_on[n] for n in live)
    ring = trace.TraceRing(capacity=len(sample) + 8, slowest_n=len(sample) + 8, sample=1.0,
                           seed=seed, errors_cap=len(sample) + 8)

    class DebugTraces(httpd.QuietHandler):
        def do_GET(self):  # noqa: N802 — the /debug/traces surface of the servers
            body = json.dumps(trace.debug_payload(self.path, ring=ring)).encode()
            self.send_reply(200, body, "application/json")

    metrics = stats.start_metrics_server(0)
    debug = httpd.ThreadingHTTPServer(("127.0.0.1", 0), DebugTraces)
    threading.Thread(target=debug.serve_forever, daemon=True).start()
    metrics_url = f"http://127.0.0.1:{metrics.server_address[1]}/metrics"
    debug_url = f"http://127.0.0.1:{debug.server_address[1]}/debug/traces"
    saved_ring, saved_env = trace.RING, os.environ.get("WEEDTPU_TRACE")
    trace.RING = ring  # the process ring: the scrub cycle's root lands here too
    rs_cuda.reset_launches()  # the obs path's run starts here
    st = store.Store([state["dir"]], encoder=state["encoder"])
    try:
        st.load()
        ev = st.get_ec_volume(STORE_VID)
        check(ev is not None, "the load did not mount the EC volume")
        if ev.warm_thread is not None:
            ev.warm_thread.join()
        passes = {"off": _obs_pass(st, state, False, metrics_url)}
        check(ring.stats()["offered"] == 0, f"tracing off offered {ring.stats()}")
        passes["on"] = _obs_pass(st, state, True, metrics_url)
        for name, p in passes.items():
            want = {(1, 10): predicted} if on_card else {}
            check(p["launches_by_shape"] == want,
                  f"{name} pass launched {p['launches_by_shape']}, predicted (1, 10) x {predicted}")
            check(p["count_rise"] == predicted,
                  f"{name} pass: reconstruct count rose {p['count_rise']}, predicted {predicted}")
            p["launches_by_shape"] = _shape_keys(p["launches_by_shape"])

        # the ring holds every traced read, each tree as the reference records it
        reads = ring.snapshot(kind="http.read", limit=10 * len(sample))
        check(len(reads) == len(sample) == ring.stats()["kept"] == ring.stats()["offered"],
              f"{len(reads)} traced reads retained of {len(sample)}: {ring.stats()}")
        decodes, by_class, worst = 0, {}, 0.0
        for t in reads:
            spans = list(trace.iter_spans(t))
            decodes += sum(s["name"] == "ec.decode" for s in spans)
            by_class[t["class"]] = by_class.get(t["class"], 0) + 1
            if t["class"] == "degraded":
                recovers = [s for s in spans if s["name"] == "ec.recover"]
                check(recovers and all({c["name"] for c in s.get("spans", ())}
                                       == {"ec.gather", "ec.decode"} for s in recovers),
                      f"degraded trace {t['trace_id']} lacks ec.recover over gather and decode")
            worst = max(worst, abs(sum(trace.attribute_stages(t).values()) - t["duration_s"]))
        check(worst < 1e-9, f"attribute_stages misses a root's duration by {worst} s")
        check(decodes == predicted, f"{decodes} ec.decode spans, predicted {predicted}")
        check(by_class.get("degraded", 0) == sum(1 for n in live if lost_on[n]),
              f"classes {by_class}")

        # one unthrottled scrub cycle over the volume's shards, traced
        t0 = time.perf_counter()
        cycle = scrub.Scrubber(volumes=lambda: {STORE_VID: ev}, on_finding=lambda *a: None,
                               cursor_path="", rate_mb=0.0).run_cycle()
        scrub_s = time.perf_counter() - t0
        check(cycle["findings"] == [] and cycle["shards_ok"] == 14 - len(LOST),
              f"scrub cycle {cycle['findings']}, {cycle['shards_ok']} ok")
        [root] = ring.snapshot(kind="scrub.cycle")
        check(root["class"] == "scrub" and root["root"]["attrs"] == {
            "scanned_bytes": cycle["scanned_bytes"], "shards_ok": cycle["shards_ok"],
            "findings": 0}, f"scrub root {root['root']}")

        # both endpoints, over loopback
        t0 = time.perf_counter()
        payload = json.loads(_fetch(f"{debug_url}?limit={10 * len(sample)}"))
        fetch_s = time.perf_counter() - t0
        roots = len(sample) + 1
        check(payload["enabled"] and payload["stats"]["kept"] == roots == len(payload["traces"]),
              f"/debug/traces kept {payload['stats']}, {len(payload['traces'])} traces")
        slow = json.loads(_fetch(f"{debug_url}?kind=http.read&class=degraded&limit=5"))["traces"]
        check(len(slow) == 5 and all(t["class"] == "degraded" for t in slow)
              and [t["duration_s"] for t in slow] == sorted(
                  (t["duration_s"] for t in slow), reverse=True), "the slowest degraded reads")
        exposed = _fetch(metrics_url).decode()
        check(exposed.count("# TYPE ") == 50, "/metrics lacks families")
    finally:
        st.close()
        metrics.shutdown()
        metrics.server_close()
        debug.shutdown()
        debug.server_close()
        trace.RING = saved_ring
        _put_env({"WEEDTPU_TRACE": saved_env})
    cost = {k: {q: (passes["on"]["by_class"][k][q] - passes["off"]["by_class"][k][q])
                for q in ("p50_ms", "p99_ms")} for k in ("local", "degraded")}
    return {
        "card": card, "sample": len(sample), "live": len(live), "predicted_1x10": predicted,
        "passes": passes, "tracing_cost_ms": cost, "decode_spans": decodes,
        "classes": by_class, "attribution_max_err_s": worst,
        "slowest_degraded_ms": [round(t["duration_s"] * 1e3, 3) for t in slow],
        "scrub": {"seconds": scrub_s, "scanned_bytes": cycle["scanned_bytes"],
                  "spans": sorted({s["name"] for s in trace.iter_spans(root)})},
        "debug_traces": {"kept": payload["stats"]["kept"], "fetch_s": fetch_s},
        "metrics_bytes": len(exposed), "seconds": time.perf_counter() - t_phase,
        "launches": dict(rs_cuda.launches_by_variant),
    }


#: the cluster phase: new 1 KiB needles written through the master (cut
#: from 4096 in PR 17, as its two read passes were cut to every other
#: needle of the sample, so that the script keeps its time with the ha
#: phase), the servers' racks, where the generated volume's shards go (A
#: keeps 0-4, B pulls 5-9, C pulls 10-13), and which server loses which
#: shards (LOST)
CLUSTER_WRITES = 1024
CLUSTER_RACKS = ("rack0", "rack1", "rack0")
CLUSTER_SPREAD = ((0, 1, 2, 3, 4), (5, 6, 7, 8, 9), (10, 11, 12, 13))
CLUSTER_LOSS = ((0,), (5,), (10, 13))


def _cluster_wait(cond, what, timeout: float = 60.0) -> float:
    """Poll `cond` until it holds (-> seconds waited); fail after `timeout`
    (`what` names the wait, or is a callable that describes it then)."""
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 >= timeout:
            check(False, f"timed out waiting for {what() if callable(what) else what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _cluster_join_warm(servers: list) -> None:
    """Wait for every mounted EC volume's warm-up launches, so that the
    counts that follow are the step's own."""
    for vs in servers:
        ev = vs.store.get_ec_volume(STORE_VID)
        if ev is not None and ev.warm_thread is not None:
            ev.warm_thread.join()


def _cluster_reads(client, state: dict, sample: list, shards_of: dict, local: set,
                   lost: set) -> dict:
    """The store phase's sample through `MasterClient.read` (the HTTP GET on
    the first holder the master names): live needles equal their data,
    deleted ones are not found; ms by class: local (every interval on the
    serving server's shards), remote (one on another server's shard),
    degraded (one on a lost shard)."""
    from seaweedfs_tpu_torch.cluster.client import ClusterError
    from seaweedfs_tpu_torch.storage.file_id import FileId

    data, cookies, deleted = state["data"], state["cookies"], state["deleted"]
    by_class = {"local": [], "remote": [], "degraded": []}
    for nid in sample:
        fid = str(FileId(STORE_VID, nid, cookies[nid - 1]))
        t = time.perf_counter()
        try:
            body = client.read(fid)
        except ClusterError:
            check(nid in deleted, f"live needle {nid} not found through the cluster")
            continue
        ms = (time.perf_counter() - t) * 1e3
        check(nid not in deleted, f"deleted needle {nid} read back through the cluster")
        check(body == data[(nid - 1) * STORE_SIZE: nid * STORE_SIZE], f"needle {nid} differs")
        klass = ("degraded" if shards_of[nid] & lost else
                 "local" if shards_of[nid] <= local else "remote")
        by_class[klass].append(ms)
    return {k: {"reads": len(xs), "p50_ms": _pct(xs, 0.5), "p99_ms": _pct(xs, 0.99)}
            for k, xs in by_class.items()}


def _cluster_stages(ring, klass: str) -> dict:
    """Where a class's reads spent their time on the serving server: the
    median ms of each stage (`trace.attribute_stages`) over the `http.read`
    roots of that class in the ring (which keeps every root of a pass)."""
    from seaweedfs_tpu_torch.obs import trace

    reads = ring.snapshot(kind="http.read", klass=klass, limit=1 << 20)
    per = [trace.attribute_stages(t) for t in reads]
    names = sorted({k for st in per for k in st})
    return {"traces": len(per), "median_ms": {
        k: _pct([st.get(k, 0.0) * 1e3 for st in per], 0.5) for k in names}}


def _cluster_batches(ring) -> int:
    """`rebuild.stage` spans, one per batch, of the one `rebuild.run` root
    the ring holds."""
    from seaweedfs_tpu_torch.obs import trace

    runs = ring.snapshot(kind="rebuild.run")
    check(len(runs) == 1, f"{len(runs)} rebuild.run traces in the ring")
    return sum(sp["name"] == "rebuild.stage" for sp in trace.iter_spans(runs[0]))


def run_cluster(state: dict, seed: int, card: str, device: str = "cuda") -> dict:
    """The cluster phase (see the module doc): the users' EC path through a
    master and three volume servers over gRPC and HTTP on loopback."""
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import read_planner, stripe
    from seaweedfs_tpu_torch.obs import trace
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    root, coll = state["cluster_dir"], "benchmark"
    # the servers' roots land here: every read pass's (its HTTP reads and
    # the holders' RPCs) and each rebuild's
    ring = trace.TraceRing(capacity=1 << 14, slowest_n=4, sample=1.0, seed=seed)
    saved_ring, saved_hedge = trace.RING, os.environ.get("WEEDTPU_HEDGE_READS")
    trace.RING = ring
    rs_cuda.reset_launches()  # the cluster path's run starts here
    master = MasterServer(port=0, reap_interval=3600)
    servers, clients = [], []
    out = {"card": card, "writes": CLUSTER_WRITES, "racks": list(CLUSTER_RACKS)}

    def call(vs, method: str, req: dict, timeout: float = 600) -> dict:
        with rpc.RpcClient(vs.grpc_address) as c:
            return c.call(VOLUME_SERVICE, method, {"volume_id": STORE_VID, "collection": coll,
                                                   **req}, timeout=timeout)

    def ec_holders() -> dict:
        return master.topology.lookup_ec_shards(STORE_VID)

    try:
        # 1: the master and servers A, B, C; A loads the store phase's volume
        t0 = time.perf_counter()
        master.start()
        for i, rack in enumerate(CLUSTER_RACKS):
            d = os.path.join(root, f"srv{i}")
            os.makedirs(d, exist_ok=True)
            vs = VolumeServer([d], master.address, heartbeat_interval=0.4, rack=rack,
                              encoder=rs_codec.new_encoder(device=device))
            vs.start()
            servers.append(vs)
        a, b, c = servers
        check(a.store.get_volume(STORE_VID) is not None, "server A did not load the volume")
        _cluster_wait(lambda: master.topology.lookup(STORE_VID, coll), "the master to list volume 1")
        out["start_s"] = time.perf_counter() - t0

        # 2: volume 1 read-only; upstream `weed benchmark`'s write path (one
        # assign and one upload per file) into new volumes the master grows
        call(a, "VolumeMarkReadonly", {})
        _cluster_wait(lambda: all(vi.read_only for n in master.topology.nodes.values()
                                  for v, vi in n.volumes.items() if v == STORE_VID),
                      "the master to see volume 1 read-only")
        client = MasterClient(master.address)
        clients.append(client)
        rng = np.random.default_rng(seed + 900)
        blobs = rng.bytes(CLUSTER_WRITES * STORE_SIZE)
        fids, ms = [], []
        t0 = time.perf_counter()
        for i in range(CLUSTER_WRITES):
            t = time.perf_counter()
            fid = client.assign(collection=coll).fid
            client.upload(fid, blobs[i * STORE_SIZE: (i + 1) * STORE_SIZE])
            ms.append((time.perf_counter() - t) * 1e3)
            fids.append(fid)
        write_s = time.perf_counter() - t0
        check(all(int(f.split(",")[0]) != STORE_VID for f in fids), "a write went to volume 1")
        rms = []
        t0 = time.perf_counter()
        for i, fid in enumerate(fids):
            t = time.perf_counter()
            check(client.read(fid) == blobs[i * STORE_SIZE: (i + 1) * STORE_SIZE],
                  f"written needle {fid} differs")
            rms.append((time.perf_counter() - t) * 1e3)
        read_s = time.perf_counter() - t0
        out["client"] = {"write_s": write_s, "writes_per_s": CLUSTER_WRITES / write_s,
                         "write_p50_ms": _pct(ms, 0.5), "write_p99_ms": _pct(ms, 0.99),
                         "read_s": read_s, "reads_per_s": CLUSTER_WRITES / read_s,
                         "read_p50_ms": _pct(rms, 0.5), "read_p99_ms": _pct(rms, 0.99),
                         "volumes": len({f.split(",")[0] for f in fids})}

        # 3: EC generate on A: the store phase's 16 (4, 10) batches; the .ecx
        # and the shards the store phase kept must equal its own
        base_a = a.store.get_volume(STORE_VID).base_path
        shape0 = dict(rs_cuda.launches_by_shape)
        t0 = time.perf_counter()
        gen = call(a, "VolumeEcShardsGenerate", {})
        gen_s = time.perf_counter() - t0
        gen_shape = _shape_launches(shape0)
        check(gen["shard_ids"] == list(range(14)) and gen["mode"] == "warm", f"generate {gen}")
        check(gen_shape == (state["encode_shape"] if on_card else {}),
              f"generate launched {gen_shape}, the store phase's encode {state['encode_shape']}")
        shas = {s: sha256_file(stripe.shard_file_name(base_a, s)) for s in range(14)}
        store_base = state["base"]
        for s in range(14):
            if s not in LOST:
                check(shas[s] == sha256_file(stripe.shard_file_name(store_base, s)),
                      f"generated shard {s} differs from the store phase's")
        check(sha256_file(base_a + ".ecx") == sha256_file(store_base + ".ecx"),
              "the generated .ecx differs from the store phase's")
        shard_bytes = os.path.getsize(stripe.shard_file_name(base_a, 0))
        out["generate"] = {"seconds": gen_s, "dat_bytes": os.path.getsize(base_a + ".dat"),
                           "shard_bytes": shard_bytes, "launches_by_shape": _shape_keys(gen_shape),
                           "equal_to_store_phase": True, "sha256": shas}

        # 4: the spread (test_cluster.py's plan): B and C pull, A drops the
        # rest and the volume, all three mount
        t0 = time.perf_counter()
        for vs, sids in zip((b, c), CLUSTER_SPREAD[1:]):
            call(vs, "VolumeEcShardsCopy", {"shard_ids": list(sids),
                                            "source_data_node": a.grpc_address})
        call(a, "VolumeEcShardsDelete", {"shard_ids": [s for s in range(14)
                                                       if s not in CLUSTER_SPREAD[0]]})
        call(a, "VolumeDelete", {})
        for vs in servers:
            call(vs, "VolumeEcShardsMount", {})
        _cluster_wait(lambda: len(ec_holders()) == 14 and not master.topology.lookup(STORE_VID, coll),
                      "the master to list 14 shards")
        out["spread"] = {"seconds": time.perf_counter() - t0,
                         "bytes_copied": shard_bytes * 9}

        # 5: lose LOST: 0 on A, 5 on B, 10 and 13 on C
        for vs, sids in zip(servers, CLUSTER_LOSS):
            call(vs, "VolumeEcShardsUnmount", {})
            call(vs, "VolumeEcShardsDelete", {"shard_ids": list(sids)})
        _cluster_wait(lambda: len(ec_holders()) == 10, "the master to list 10 shards")
        shards_of = _needle_shards(base_a, state["sample"])
        lost_on = {nid: len(sh & set(LOST)) for nid, sh in shards_of.items()}
        check(lost_on == state["lost_on"], "the cluster's .ecx places the sample otherwise")
        locations = client.lookup(STORE_VID, refresh=True)
        check(locations and locations[0].url == a.url, "the master names A first")
        local = set(CLUSTER_SPREAD[0]) - set(LOST)
        reads_sample = state["sample"][::2]
        predicted = sum(lost_on.get(nid, 0) for nid in reads_sample)

        # 6-7: the sample through the cluster, serially without hedging
        # (launches = the store phase's prediction, each at a bucket), then
        # with the default hedging
        passes = {}
        for name, hedge in (("serial", "off"), ("hedged", None)):
            _put_env({"WEEDTPU_HEDGE_READS": hedge})
            read_planner.CACHE.clear()
            _cluster_join_warm(servers)
            shape0 = dict(rs_cuda.launches_by_shape)
            widths = []
            encoders = {id(vs.store.encoder): vs.store.encoder for vs in servers}.values()
            dispatch = {id(e): e._apply_lazy for e in encoders}

            def recording(inner):  # every launch's width, on whichever server
                def recorded(m, shards, donate=False, width=None):
                    widths.append(int(width or shards.shape[-1]))
                    return inner(m, shards, donate=donate, width=width)
                return recorded

            for e in encoders:
                e._apply_lazy = recording(dispatch[id(e)])
            ring.clear()
            try:
                t0 = time.perf_counter()
                by_class = _cluster_reads(client, state, reads_sample, shards_of, local,
                                          set(LOST))
                seconds = time.perf_counter() - t0
            finally:
                for e in encoders:
                    e._apply_lazy = dispatch[id(e)]
            by_shape = _shape_launches(shape0)
            passes[name] = {"seconds": seconds, "by_class": by_class,
                            "launches_by_shape": _shape_keys(by_shape),
                            "widths": sorted(set(widths)),
                            "degraded_stages": _cluster_stages(ring, "degraded")}
            if name == "serial":
                check(by_shape == ({(1, 10): predicted} if on_card else {}),
                      f"serial reads launched {by_shape}, predicted (1, 10) x {predicted}")
                check(len(widths) == predicted or not on_card,
                      f"{len(widths)} recorded reconstructs for {predicted} launches")
                check(all(w in a.store.encoder.RECONSTRUCT_BUCKETS for w in widths)
                      or not on_card, f"a reconstruct launched off the buckets: {set(widths)}")
        out["reads"] = {"predicted_1x10": predicted, **passes}

        # 8: B rebuilds LOST over the slab stream: A's 1-4, its own 6-9, C's
        # 11-12; one (4, 10) launch per batch
        ring.clear()
        shape0 = dict(rs_cuda.launches_by_shape)
        t0 = time.perf_counter()
        rb = call(b, "VolumeEcShardsRebuild", {"remote": True, "trace_mode": "off"})
        rb_s = time.perf_counter() - t0
        rb_shape = _shape_launches(shape0)
        batches = _cluster_batches(ring)
        base_b = b._base_path_for(STORE_VID, coll)
        check(rb["rebuilt_shard_ids"] == list(LOST) and rb["mode"] == "slab", f"rebuild {rb}")
        check(rb_shape == ({(4, 10): batches} if on_card else {}),
              f"remote rebuild launched {rb_shape} for {batches} batches")
        for s in LOST:
            check(sha256_file(stripe.shard_file_name(base_b, s)) == shas[s],
                  f"remote rebuild: shard {s} differs")
        call(b, "VolumeEcShardsMount", {})
        _cluster_wait(lambda: len(ec_holders()) == 14, "the master to list the rebuilt shards")
        survivor_bytes = 10 * shard_bytes
        out["remote_rebuild"] = {
            "seconds": rb_s, "gbps": survivor_bytes / rb_s / 1e9, "batches": batches,
            "launches_by_shape": _shape_keys(rb_shape), "wire_bytes": rb["wire_bytes"],
            "local_survivors": rb["local_survivors"], "remote_survivors": rb["remote_survivors"]}

        # 9: B loses shard 5 again and rebuilds it from projections: each
        # holder projects its window on its card, B its local group, one
        # combine per batch
        call(b, "VolumeEcShardsUnmount", {})
        call(b, "VolumeEcShardsDelete", {"shard_ids": [5]})
        _cluster_wait(lambda: len(ec_holders()) == 13, "the master to drop shard 5")
        _cluster_join_warm(servers)
        ring.clear()
        shape0 = dict(rs_cuda.launches_by_shape)
        t0 = time.perf_counter()
        tr = call(b, "VolumeEcShardsRebuild", {"remote": True, "trace_mode": "on"})
        tr_s = time.perf_counter() - t0
        tr_shape = _shape_launches(shape0)
        tbatches = _cluster_batches(ring)
        check(tr["rebuilt_shard_ids"] == [5] and tr["mode"] == "trace", f"trace rebuild {tr}")
        check(sha256_file(stripe.shard_file_name(base_b, 5)) == shas[5],
              "trace rebuild: shard 5 differs")
        groups = [len(label.split("=", 1)[1].split("+")) for label in tr["trace_groups"]]
        want: dict = {(1, len(groups)): tbatches}  # the combine
        for k in groups:  # each group's projection, one per batch window
            want[(1, k)] = want.get((1, k), 0) + tbatches
        chosen = sum(groups)
        check(chosen == 10 and len(tr["remote_survivors"]) + len(tr["local_survivors"]) == 10,
              f"the trace plan covers {chosen} survivors")
        check(tr_shape == (want if on_card else {}),
              f"trace rebuild launched {tr_shape}, the plan wants {want}")
        slab_wire = len(tr["remote_survivors"]) * shard_bytes
        check(tr["wire_bytes"] == (len(groups) - 1) * shard_bytes < slab_wire,
              f"trace wire bytes {tr['wire_bytes']}")
        call(b, "VolumeEcShardsMount", {})
        out["trace_rebuild"] = {
            "seconds": tr_s, "gbps": survivor_bytes / tr_s / 1e9, "batches": tbatches,
            "groups": tr["trace_groups"], "launches_by_shape": _shape_keys(tr_shape),
            "wire_bytes": tr["wire_bytes"], "slab_wire_bytes": slab_wire}

        # 10: every holder's shards verify against the .eci
        t0 = time.perf_counter()
        verified = {}
        for name, vs in zip("ABC", servers):
            v = call(vs, "VolumeEcShardsVerify", {})
            check(v["has_crcs"] and v["verdicts"] and all(x == "ok" for x in v["verdicts"].values()),
                  f"verify on {name}: {v['verdicts']}")
            verified[name] = sorted(int(s) for s in v["verdicts"])
        check(sorted(s for sids in verified.values() for s in sids) == list(range(14)),
              f"verified shards {verified}")
        out["verify"] = {"seconds": time.perf_counter() - t0, "shards": verified}
    finally:
        for cl in clients:
            cl.close()
        for vs in servers:
            vs.stop()
        master.stop()
        trace.RING = saved_ring
        _put_env({"WEEDTPU_HEDGE_READS": saved_hedge})
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(rs_cuda.launches_by_variant)
    check(out["launches"].get(a.store.encoder.variant, 0) > 0 or not on_card,
          "the cluster path never launched the factory's kernel")
    return out


#: the ha phase: upstream's production layout of three masters under raft
#: (`weed master -peers=...`, default election timeout), three volume
#: servers on the card heartbeating to all of them (racks), the needles
#: written before and after the leader stops (from 8 threads, as upstream
#: `weed benchmark -c` writes), and how many of the store
#: phase's sample are read after the failover (a seeded quarter: the whole
#: sample through the EC volume's remote and degraded reads would take the
#: phase past its minute)
HA_MASTERS = 3
HA_RACKS = ("rack0", "rack1", "rack2")
HA_WRITES = 1024
HA_WRITERS = 8
HA_FAILOVER_READS = 1024


def _free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        return [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()


def _agreed_leader(masters: list):
    """The one master that leads with every other live master naming it."""
    leaders = [m for m in masters if m.raft.is_leader]
    if len(leaders) == 1 and all(m.raft.leader == leaders[0].address
                                 for m in masters if m is not leaders[0]):
        return leaders[0]
    return None


def _ha_write(client, blobs: bytes, coll: str) -> tuple[list, list]:
    """HA_WRITES needles through assign + upload from HA_WRITERS threads
    (upstream `weed benchmark -c`), ms each, then read back."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i: int) -> tuple[str, float]:
        t = time.perf_counter()
        fid = client.assign(collection=coll).fid
        client.upload(fid, blobs[i * STORE_SIZE: (i + 1) * STORE_SIZE])
        return fid, (time.perf_counter() - t) * 1e3

    def back(i: int, fid: str) -> bool:
        return client.read(fid) == blobs[i * STORE_SIZE: (i + 1) * STORE_SIZE]

    with ThreadPoolExecutor(HA_WRITERS) as pool:
        fids, ms = zip(*pool.map(one, range(HA_WRITES)))
        same = list(pool.map(back, range(HA_WRITES), fids))
    check(all(same), f"{same.count(False)} written needles differ")
    return list(fids), list(ms)


def _sha_many(paths: list) -> list:
    """sha256 of each file, from several threads (hashlib drops the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(sha256_file, paths))


def _ha_reads(client, state: dict, sample: list, degraded: set) -> dict:
    """`sample` of the store phase's needles through `MasterClient.read`,
    serially: live needles equal their data, deleted ones are not found;
    ms by class (degraded: an interval on a lost shard)."""
    from seaweedfs_tpu_torch.cluster.client import ClusterError
    from seaweedfs_tpu_torch.storage.file_id import FileId

    data, cookies, deleted = state["data"], state["cookies"], state["deleted"]
    by_class = {"local": [], "degraded": []}
    t0 = time.perf_counter()
    for nid in sample:
        fid = str(FileId(STORE_VID, nid, cookies[nid - 1]))
        t = time.perf_counter()
        try:
            body = client.read(fid)
        except ClusterError:
            check(nid in deleted, f"live needle {nid} not found through the quorum")
            continue
        ms = (time.perf_counter() - t) * 1e3
        check(nid not in deleted, f"deleted needle {nid} read back")
        check(body == data[(nid - 1) * STORE_SIZE: nid * STORE_SIZE], f"needle {nid} differs")
        by_class["degraded" if nid in degraded else "local"].append(ms)
    return {"seconds": time.perf_counter() - t0, "needles": len(sample), **{
        k: {"reads": len(xs), "p50_ms": _pct(xs, 0.5), "p99_ms": _pct(xs, 0.99)}
        for k, xs in by_class.items() if xs}}


def _shard_paths(dirs: list, base_name: str) -> dict:
    """{shard id: path} of the EC volume's shard files on the servers."""
    from seaweedfs_tpu_torch.ec import stripe

    out = {}
    for d in dirs:
        for s in range(14):
            p = stripe.shard_file_name(os.path.join(d, base_name), s)
            if os.path.exists(p):
                check(s not in out, f"shard {s} on two servers")
                out[s] = p
    return out


def run_ha(state: dict, seed: int, card: str, device: str = "cuda") -> dict:
    """The ha phase (see the module doc): a three-master raft quorum over
    three volume servers on the card; tiering, EC, failover and rejoin."""
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.client import ClusterError, MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import read_planner, stripe
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    root, coll = state["ha_dir"], "benchmark"
    base_name = f"{coll}_{STORE_VID}"
    addresses = [f"127.0.0.1:{p}" for p in _free_ports(HA_MASTERS)]
    raft_dirs = [os.path.join(root, f"raft{i}") for i in range(HA_MASTERS)]
    rs_cuda.reset_launches()  # the ha path's run starts here

    def new_master(i: int):
        os.makedirs(raft_dirs[i], exist_ok=True)
        return MasterServer(port=int(addresses[i].rsplit(":", 1)[1]), peers=addresses,
                            raft_dir=raft_dirs[i], reap_interval=3600, http_port=None)

    masters = [new_master(i) for i in range(HA_MASTERS)]
    servers, envs, clients, stopped = [], [], [], []
    out = {"card": card, "masters": HA_MASTERS, "election_timeout_s": [1.0, 2.0],
           "source": "SeaweedFS wiki, Production Setup: three masters `weed master "
           "-peers=m1,m2,m3`; volume.tier.upload to a cloud tier; ec.encode",
           "reduced": ["the store phase's weed benchmark volume (1 GiB) for upstream's 30 GB "
                       "volume limit", "a local-directory vendor for the cloud tier",
                       f"{HA_FAILOVER_READS} of the sample's reads after the failover"]}

    def call(vs, method: str, req: dict, timeout: float = 600) -> dict:
        with rpc.RpcClient(vs.grpc_address) as c:
            return c.call(VOLUME_SERVICE, method, {"volume_id": STORE_VID, "collection": coll,
                                                   **req}, timeout=timeout)

    def shell(address: str, script: str) -> tuple[str, float]:
        env = CommandEnv(address, device=device)
        envs.append(env)
        buf = io.StringIO()
        t = time.perf_counter()
        for cmd in script.split(";"):
            run_command(env, cmd.strip(), buf)
        return buf.getvalue(), time.perf_counter() - t

    try:
        # 1: elect: three masters with -peers and a raft directory each
        t0 = time.perf_counter()
        for m in masters:
            m.start()
        _cluster_wait(lambda: _agreed_leader(masters) is not None, "an agreed leader", 30)
        leader = _agreed_leader(masters)
        out["elect"] = {"seconds": time.perf_counter() - t0, "term": leader.raft.term,
                        "leader": masters.index(leader)}
        followers = [m for m in masters if m is not leader]

        # 2: three volume servers heartbeating to all three masters; A holds
        # the store phase's volume; 1024 new needles through the quorum
        quorum = ",".join(addresses)
        for i, rack in enumerate(HA_RACKS):
            d = os.path.join(root, f"srv{i}")
            os.makedirs(d, exist_ok=True)
            vs = VolumeServer([d], quorum, heartbeat_interval=0.4, rack=rack,
                              encoder=rs_codec.new_encoder(device=device))
            vs.start()
            servers.append(vs)
        a = servers[0]
        check(a.store.get_volume(STORE_VID) is not None, "server A did not load the volume")
        _cluster_wait(lambda: all(m.topology.lookup(STORE_VID, coll) for m in masters),
                      "every master to list volume 1")
        call(a, "VolumeMarkReadonly", {})
        _cluster_wait(lambda: all(vi.read_only for n in leader.topology.nodes.values()
                                  for v, vi in n.volumes.items() if v == STORE_VID),
                      "the leader to see volume 1 read-only")
        client = MasterClient(quorum)
        clients.append(client)
        blobs = np.random.default_rng(seed + 1700).bytes(2 * HA_WRITES * STORE_SIZE)
        t0 = time.perf_counter()
        fids1, ms = _ha_write(client, blobs[:HA_WRITES * STORE_SIZE], coll)
        out["write"] = {"seconds": time.perf_counter() - t0, "p50_ms": _pct(ms, 0.5),
                        "p99_ms": _pct(ms, 0.99),
                        "volumes": sorted({f.split(",")[0] for f in fids1})}

        # 3: tier: volume.tier.move through a follower's address (the shell
        # follows the leader), the sample read through the tiered .dat over
        # HTTP, volume.tier.fetch, the fetched .dat's sha256 the original's
        base_a = os.path.join(a.store.locations[0].directory, base_name)
        dat_bytes = os.path.getsize(base_a + ".dat")
        dat_sha = sha256_file(base_a + ".dat")
        cold = os.path.join(root, "cold")
        text, move_s = shell(followers[0].address,
                             f"lock; volume.tier.move -volumeId {STORE_VID} -dest local:{cold}; unlock")
        check(f"{dat_bytes} bytes -> volumes/{base_name}.dat" in text, f"tier move: {text}")
        check(not os.path.exists(base_a + ".dat") and os.path.exists(base_a + ".tierinfo"),
              "the .dat did not move")
        check(a.store.get_volume(STORE_VID).tiered, "server A does not serve it tiered")
        with open(base_a + ".tierinfo") as f:
            tierinfo = json.load(f)
        check(tierinfo == {"location": {"vendor": "local", "root": cold},
                           "key": f"volumes/{base_name}.dat", "size": dat_bytes},
              f".tierinfo {tierinfo}")
        read_planner.CACHE.clear()
        tiered = _ha_reads(client, state, state["sample"], set())
        text2, fetch_s = shell(followers[1].address,
                               f"lock; volume.tier.fetch -volumeId {STORE_VID}; unlock")
        check("local again" in text2, f"tier fetch: {text2}")
        check(sha256_file(base_a + ".dat") == dat_sha,
              "the fetched-back .dat differs from the original")
        out["tier"] = {"dat_bytes": dat_bytes, "move_s": move_s,
                       "move_gbps": dat_bytes / move_s / 1e9, "fetch_s": fetch_s,
                       "fetch_gbps": dat_bytes / fetch_s / 1e9, "tiered_reads": tiered,
                       "sha256_equal": True, "shell_via_follower": True}
        # 4: encode: lock; ec.encode -volumeId 1 -force; unlock through the
        # shell, every lease acked by the quorum; the store phase's launches;
        # the kept shards the store phase's
        acks = []
        replicate = leader.raft.replicate_now

        def counted():
            ok = replicate()
            acks.append(ok)
            return ok

        leader.raft.replicate_now = counted
        shape0 = dict(rs_cuda.launches_by_shape)
        _, enc_s = shell(addresses[0], f"lock; ec.encode -volumeId {STORE_VID} -force; unlock")
        leader.raft.replicate_now = replicate
        enc_shape = _shape_launches(shape0)
        check(acks and all(acks), f"lease acks {acks}")
        want = state["encode_shape"] if on_card else {}
        check({k: v for k, v in enc_shape.items() if k[0] > 1} == want,
              f"ec.encode launched {enc_shape}, the store phase's encode {want}")
        dirs = [vs.store.locations[0].directory for vs in servers]
        paths = _shard_paths(dirs, base_name)
        check(sorted(paths) == list(range(14)), f"shards after ec.encode: {sorted(paths)}")
        kept = [s for s in range(14) if s not in LOST]
        shas = _sha_many([paths[s] for s in kept]
                         + [stripe.shard_file_name(state["base"], s) for s in kept])
        check(shas[:len(kept)] == shas[len(kept):],
              f"ec.encode: shards differ from the store phase's: {kept}")
        check(not any(os.path.exists(os.path.join(d, base_name + ".dat")) for d in dirs),
              "the source volume survived ec.encode")
        holders = {i: sorted(s for s, p in paths.items() if p.startswith(d + os.sep))
                   for i, d in enumerate(dirs)}
        out["encode"] = {"seconds": enc_s, "launches_by_shape": _shape_keys(enc_shape),
                         "lease_acks": len(acks), "shards_by_server": holders,
                         "kept_equal_to_store_phase": True}

        # 5: fail over: stop the leader; a new agreed leader of a greater
        # term; the client's first assign; 1024 more needles, no fid
        # repeated; LOST deleted on their holders; the sample through the
        # new leader's lookups, degraded
        old, old_term = leader, leader.raft.term
        t0 = time.perf_counter()
        old.stop()
        stopped.append(old)
        live = [m for m in masters if m is not old]
        _cluster_wait(lambda: _agreed_leader(live) is not None, "a new leader", 30)
        new = _agreed_leader(live)
        failover_s = time.perf_counter() - t0
        check(new.raft.term > old_term, f"new term {new.raft.term} <= {old_term}")
        while True:
            try:
                first = client.assign(collection=coll).fid
                break
            except Exception:  # noqa: BLE001 — the client follows the new leader
                check(time.perf_counter() - t0 < 30, "no assign after the failover")
                time.sleep(0.05)
        assign_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        fids2, ms2 = _ha_write(client, blobs[HA_WRITES * STORE_SIZE:], coll)
        write2_s = time.perf_counter() - t1

        def key(fid: str) -> tuple:  # (volume id, needle key): the cookie apart
            vid, rest = fid.split(",")
            return vid, rest[:-8]

        before, after_keys = {key(f) for f in fids1}, {key(f) for f in [first, *fids2]}
        check(len(after_keys) == len(fids2) + 1 and not before & after_keys,
              "a fid issued after the failover repeats one issued before")
        for i, vs in enumerate(servers):
            mine = [s for s in LOST if s in holders[i]]
            if mine:
                call(vs, "VolumeEcShardsDelete", {"shard_ids": mine})
        _cluster_wait(lambda: len(new.topology.lookup_ec_shards(STORE_VID)) == 10,
                      "the new leader to list 10 shards")
        for vs in servers:
            ev = vs.store.get_ec_volume(STORE_VID)
            if ev is not None and ev.warm_thread is not None:
                ev.warm_thread.join()
        degraded = {nid for nid, n in state["lost_on"].items() if n}
        read_planner.CACHE.clear()
        shape0 = dict(rs_cuda.launches_by_shape)
        quarter = sorted(np.random.default_rng(seed + 1701).choice(
            state["sample"], HA_FAILOVER_READS, replace=False).tolist())
        reads = _ha_reads(client, state, quarter, degraded)
        read_shape = _shape_launches(shape0)
        check(all(c == 10 for _, c in read_shape)
              and (sum(read_shape.values()) > 0 if on_card else not read_shape),
              f"degraded reads after the failover launched {read_shape}")
        out["failover"] = {"seconds": failover_s, "first_assign_s": assign_s,
                           "old_term": old_term, "new_term": new.raft.term,
                           "new_leader": masters.index(new), "write_s": write2_s,
                           "write_p50_ms": _pct(ms2, 0.5), "write_p99_ms": _pct(ms2, 0.99),
                           "fids_repeated": 0, "reads": reads,
                           "launches_by_shape": _shape_keys(read_shape)}

        # 6: rejoin: the stopped master again on its raft directory; its
        # persisted term at least its old one; a follower of the current
        # leader within 10 s; cluster.raft.ps against it names that leader
        i_old = masters.index(old)
        t0 = time.perf_counter()
        back = new_master(i_old)
        resumed_term = back.raft.term
        check(resumed_term >= old_term, f"resumed term {resumed_term} < {old_term}")
        masters[i_old] = back
        back.start()
        _cluster_wait(lambda: back.raft.leader == new.address and not back.is_leader,
                      lambda: "the restarted master to follow the leader: " + str(
                          [(m.address, m.raft.state, m.raft.term, m.raft.leader)
                           for m in masters]) + f" (leader {new.address})", 10)
        rejoin_s = time.perf_counter() - t0
        while True:  # clients redial it within the transport's reconnect cap
            try:
                ps, _ = shell(back.address, "cluster.raft.ps")
                break
            except ClusterError:
                check(time.perf_counter() - t0 < 10, "cluster.raft.ps cannot reach it")
                time.sleep(0.05)
        reachable_s = time.perf_counter() - t0
        check(f"leader: {new.address}" in ps and f"* {new.address}" in ps, f"raft.ps: {ps}")
        out["rejoin"] = {"seconds": rejoin_s, "shell_s": reachable_s,
                         "resumed_term": resumed_term,
                         "term": back.raft.term, "raft_ps": ps.splitlines()[0]}
    finally:
        for env in envs:
            env.close()
        for cl in clients:
            cl.close()
        # side by side: each HTTP front waits up to its poll interval
        halt = [threading.Thread(target=srv.stop) for srv in [*servers, *masters]
                if srv not in stopped]
        for t in halt:
            t.start()
        for t in halt:
            t.join()
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = dict(rs_cuda.launches_by_variant)
    check(out["launches"].get(servers[0].store.encoder.variant, 0) > 0 or not on_card,
          "the ha path never launched the factory's kernel")
    return out


#: the filer phase's deployment: the SeaweedFS wiki's "Filer Setup" (one
#: `weed filer` over a master, default -maxMB 4 chunking, the log store)
#: and "Erasure Coding for warm storage" (the filer's collection encoded by
#: `ec.encode`); 1024 files log-uniform from 4 KiB to 8 MiB in 4 x 8
#: directories
FILER_FILES = 1024
FILER_MIN, FILER_MAX = 4 << 10, 8 << 20
FILER_TREE = (4, 8)
FILER_WRITERS = 8
FILER_VOLUMES = 6  # grown up front, two per server (upstream grows 7 at a time for 000)
FILER_COLLECTION = "warm"
FILER_SLOTS = 32  # volume slots per server
FILER_LOST = (0, 5)
FILER_RANGES = 256
FILER_RANGE = 64 << 10
FILER_LATE = 32
FILER_REPEAT_BYTES = 48 << 20  # the degraded files read again with the default caches


def _filer_files(seed: int, n: int, lo: int, hi: int) -> list:
    """[(path, size, data seed)]: log-uniform sizes in [lo, hi], each file
    in one of the FILER_TREE leaf directories, all seeded."""
    rng = np.random.default_rng(seed + 1800)
    sizes = np.exp(rng.uniform(np.log(lo), np.log(hi), n)).astype(np.int64)
    leaves = rng.integers(0, FILER_TREE[0] * FILER_TREE[1], n)
    return [(f"/{FILER_COLLECTION}/t{leaf // FILER_TREE[1]}/d{leaf % FILER_TREE[1]}/f{i:04d}.bin",
             int(size), seed * 100_000 + i) for i, (size, leaf) in enumerate(zip(sizes, leaves))]


def _filer_data(data_seed: int, size: int) -> bytes:
    return np.random.default_rng(data_seed).bytes(size)


def _filer_put(conns: threading.local, url: str, path: str, data: bytes) -> dict:
    """One HTTP PUT on this thread's keep-alive connection -> its JSON reply."""
    import http.client
    import urllib.parse

    conn = getattr(conns, "c", None)
    if conn is None:
        host, port = url.rsplit(":", 1)
        conn = conns.c = http.client.HTTPConnection(host, int(port), timeout=120)
    conn.request("PUT", urllib.parse.quote(path), body=data)
    r = conn.getresponse()
    body = r.read()
    check(r.status == 201, f"PUT {path}: {r.status} {body[:200]!r}")
    return json.loads(body)


def _filer_get(conn, path: str, rng: tuple | None = None) -> tuple[int, bytes]:
    import urllib.parse

    headers = {"Range": f"bytes={rng[0]}-{rng[1] - 1}"} if rng else {}
    conn.request("GET", urllib.parse.quote(path), headers=headers)
    r = conn.getresponse()
    return r.status, r.read()


def _filer_chunk_shards(servers: list, vids: set, chunks_of: dict, coll: str) -> dict:
    """{fid: the shards its needle's intervals lie on}, from each EC
    volume's .ecx and .eci on a server that holds them."""
    keys: dict[int, set] = {}
    for chunks in chunks_of.values():
        for fid in chunks:
            vid, rest = fid.split(",")
            keys.setdefault(int(vid), set()).add(int(rest[:-8], 16))
    out: dict = {}
    for vid in vids:
        base = next((b for b in (vs._base_path_for(vid, coll) for vs in servers)
                     if os.path.exists(b + ".ecx")), None)
        check(base is not None, f"no server holds the .ecx of volume {vid}")
        by_key = _needle_shards(base, sorted(keys.get(vid, ())))
        for chunks in chunks_of.values():
            for fid in chunks:
                v, rest = fid.split(",")
                if int(v) == vid:
                    out[fid] = by_key[int(rest[:-8], 16)]
    return out


def run_filer(scratch: str, seed: int, card: str, kernel_ms: dict, device: str = "cuda",
              files: int = FILER_FILES, max_bytes: int = FILER_MAX, then=None) -> dict:
    """The filer phase (see the module doc): files through the port's filer
    onto card volume servers, EC-encoded, read back degraded. `then(master,
    servers, filer, tree)`, when given, runs on the same cluster after the
    phase's own line is complete and before it stops (`tree`: the
    collection, and each live file's sha256, size, data seed and chunk fids,
    and the shards each EC chunk's needle lies on); what it returns is the
    line's `_then`."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch import rpc, stats
    from seaweedfs_tpu_torch.cluster.client import ClusterError, MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.filer import FilerServer, make_store
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    root, coll = os.path.join(scratch, "filer"), FILER_COLLECTION
    meta = os.path.join(root, "meta")
    os.makedirs(meta)
    http_port, grpc_port = _free_ports(2)
    rs_cuda.reset_launches()  # the filer path's run starts here
    master = MasterServer(port=0, reap_interval=3600)
    servers, envs, filers, conns = [], [], [], []
    saved_hedge = os.environ.get("WEEDTPU_HEDGE_READS")
    saved_cache = os.environ.get("WEEDTPU_READ_CACHE_MB")
    out = {"card": card,
           "source": "SeaweedFS wiki, Filer Setup (weed filer -maxMB 4 over a master, the "
                     "leveldb-like log store) and Erasure Coding for warm storage (ec.encode "
                     "of the filer's collection)",
           "reduced": [f"{files} files of {FILER_MIN}-{max_bytes} bytes, not a deployment's "
                       "millions", f"{FILER_VOLUMES} volumes grown up front, each far below "
                       "30 GB", "one host: master, 3 volume servers, the filer and the shell "
                       "in one process over loopback gRPC and HTTP"],
           "files": files, "dirs": FILER_TREE[0] * FILER_TREE[1], "chunk_size": 4 << 20,
           "volumes": FILER_VOLUMES, "lost": list(FILER_LOST)}

    def start_filer(cache_bytes: int = 0):
        fs = FilerServer(master.address, store=make_store("log", meta), port=http_port,
                         grpc_port=grpc_port, log_dir=meta, collection=coll,
                         chunk_cache_bytes=cache_bytes)
        fs.start()
        filers.append(fs)
        _cluster_wait(lambda: any(f["grpc_address"] == fs.grpc_address for f in
                                  master._rpc_list_cluster_nodes({}, None)["filers"]),
                      "the filer to announce itself")
        return fs

    def shell(script: str) -> tuple[str, float, dict]:
        env = CommandEnv(master.address, device=device)
        envs.append(env)
        buf = io.StringIO()
        shape0 = dict(rs_cuda.launches_by_shape)
        t = time.perf_counter()
        for cmd in script.split(";"):
            run_command(env, cmd.strip(), buf)
        return buf.getvalue(), time.perf_counter() - t, _shape_launches(shape0)

    def call(vs, method: str, req: dict) -> dict:
        with rpc.RpcClient(vs.grpc_address) as c:
            return c.call(VOLUME_SERVICE, method, {"collection": coll, **req}, timeout=600)

    def connection(fs):
        c = http.client.HTTPConnection("127.0.0.1", fs.port, timeout=120)
        conns.append(c)
        return c

    try:
        master.start()
        for i in range(3):
            d = os.path.join(root, f"srv{i}")
            os.makedirs(d)
            # upstream's `weed volume -max 32`: the s3 and sync phases grow
            # their collections on these servers after the filer's six volumes
            # (an EC volume's shards take a slot on each holder)
            vs = VolumeServer([d], master.address, heartbeat_interval=0.4, rack=f"rack{i}",
                              max_volume_count=FILER_SLOTS,
                              encoder=rs_codec.new_encoder(device=device))
            vs.start()
            servers.append(vs)
        _cluster_wait(lambda: len(master.topology.nodes) == 3, "three volume servers")
        grown = master._rpc_volume_grow({"collection": coll, "count": FILER_VOLUMES}, None)
        check(grown["grown"] == FILER_VOLUMES, f"volume grow: {grown}")
        fs = start_filer()

        # 1: the seeded files through the filer's HTTP PUT from FILER_WRITERS
        # threads (each file's sha256 kept, its etag its md5)
        plan = _filer_files(seed, files, FILER_MIN, max_bytes)
        local = threading.local()

        def put(item) -> tuple:
            path, size, ds = item
            data = _filer_data(ds, size)
            t = time.perf_counter()
            reply = _filer_put(local, fs.url, path, data)
            ms = (time.perf_counter() - t) * 1e3
            check(reply["size"] == size and reply["etag"] == hashlib.md5(data).hexdigest(),
                  f"PUT {path}: {reply}")
            return hashlib.sha256(data).hexdigest(), ms

        t0 = time.perf_counter()
        with ThreadPoolExecutor(FILER_WRITERS) as pool:
            puts = list(pool.map(put, plan))
        write_s = time.perf_counter() - t0
        total = sum(size for _, size, _ in plan)
        digest = {path: h for (path, _, _), (h, _) in zip(plan, puts)}
        sizes = {path: size for path, size, _ in plan}
        seed_of = {path: ds for path, _, ds in plan}
        chunks_of = {path: [c.fid for c in fs.filer.find_entry(path).chunks] for path in sizes}
        check(all(len(c) == -(-sizes[p] // (4 << 20)) for p, c in chunks_of.items()),
              "a file's chunk count is not ceil(size / 4 MiB)")
        ms = [m for _, m in puts]
        out["write"] = {"seconds": write_s, "files_per_s": files / write_s,
                        "mb_per_s": total / write_s / 1e6, "bytes": total,
                        "chunks": sum(map(len, chunks_of.values())),
                        "p50_ms": _pct(ms, 0.5), "p99_ms": _pct(ms, 0.99),
                        "writers": FILER_WRITERS}

        # 2: ec.encode of every volume of the collection through the shell
        vids = {v for n in master.topology.nodes.values()
                for v, vi in n.volumes.items() if vi.collection == coll}
        check(vids == {int(f.split(",")[0]) for c in chunks_of.values() for f in c},
              f"the collection's volumes {sorted(vids)} hold other chunks")
        dat_bytes = sum(os.path.getsize(vs.store.get_volume(v).base_path + ".dat")
                        for vs in servers for v in vids if vs.store.get_volume(v) is not None)
        text, enc_s, enc_shape = shell(f"lock; ec.encode -collection {coll} -force; unlock")
        check(all(f"ec.encode volume {v}" in text for v in vids), f"ec.encode: {text}")
        _cluster_wait(lambda: all(len(master.topology.lookup_ec_shards(v)) == 14 for v in vids)
                      and not any(master.topology.lookup(v, coll) for v in vids),
                      "every volume of the collection EC-encoded")
        # (4, 10) per batch, and each mounted EC volume's (1, 10) warm-ups
        check(set(enc_shape) <= {(4, 10), (1, 10)} and (enc_shape.get((4, 10), 0) > 0
                                                         if on_card else not enc_shape),
              f"ec.encode launched {enc_shape}")
        out["encode"] = {"seconds": enc_s, "volumes": len(vids), "dat_bytes": dat_bytes,
                         "gbps": dat_bytes / enc_s / 1e9,
                         "launches_by_shape": _shape_keys(enc_shape)}

        # 3: two data shards lost cluster-wide
        for vid in vids:
            for vs in servers:
                ev = vs.store.get_ec_volume(vid)
                mine = [s for s in FILER_LOST if ev is not None and s in ev.shard_ids]
                if mine:
                    call(vs, "VolumeEcShardsDelete", {"volume_id": vid, "shard_ids": mine})
        _cluster_wait(lambda: all(len([s for s, ns in master.topology.lookup_ec_shards(v).items()
                                       if ns]) == 12 for v in vids),
                      "the master to list 12 shards of every volume")
        for vs in servers:
            for vid in vids:
                ev = vs.store.get_ec_volume(vid)
                if ev is not None and ev.warm_thread is not None:
                    ev.warm_thread.join()
        shards = _filer_chunk_shards(servers, vids, chunks_of, coll)
        lost = set(FILER_LOST)
        degraded = {p for p, cs in chunks_of.items() if any(shards[f] & lost for f in cs)}

        def predict(fids) -> int:  # one (1, 10) launch per lost shard a needle touches
            return sum(len(shards[f] & lost) for f in fids)

        # 4: the cold pass: every file by HTTP GET through the filer, serially,
        # chunk cache off, server caches cleared, hedging off
        os.environ["WEEDTPU_HEDGE_READS"] = "off"
        read_planner.CACHE.clear()
        order = [plan[i][0] for i in np.random.default_rng(seed + 1801).permutation(files)]
        conn = connection(fs)

        def read_pass(paths) -> dict:
            by_class = {"degraded": [], "healthy": []}
            mib = {"degraded": [], "healthy": []}  # the files of 0.5-2 MiB
            shape0 = dict(rs_cuda.launches_by_shape)
            t = time.perf_counter()
            for p in paths:
                t1 = time.perf_counter()
                status, body = _filer_get(conn, p)
                ms = (time.perf_counter() - t1) * 1e3
                check(status == 200 and len(body) == sizes[p]
                      and hashlib.sha256(body).hexdigest() == digest[p], f"GET {p} differs")
                klass = "degraded" if p in degraded else "healthy"
                by_class[klass].append(ms)
                if 512 << 10 <= sizes[p] < 2 << 20:
                    mib[klass].append(ms)
            seconds = time.perf_counter() - t
            n = sum(sizes[p] for p in paths)
            return {"seconds": seconds, "files": len(paths), "mb_per_s": n / seconds / 1e6,
                    "launches": _shape_launches(shape0), **{
                        k: {"files": len(v), "p50_ms": _pct(v, 0.5), "p99_ms": _pct(v, 0.99),
                            "p50_ms_1mib": _pct(mib[k], 0.5)}
                        for k, v in by_class.items()}}

        cold = read_pass(order)
        cold_pred = predict([f for p in order for f in chunks_of[p]])
        check(cold["launches"] == ({(1, 10): cold_pred} if on_card and cold_pred else {}),
              f"the cold pass launched {cold['launches']}, predicted (1, 10) x {cold_pred}")
        cold["launches_by_shape"] = _shape_keys(cold.pop("launches"))
        cold["predicted_1x10"] = cold_pred

        # 5: FILER_RANGES seeded 64 KiB ranges (server caches off: each
        # range reads its chunks' whole needles, decoding every lost interval)
        os.environ["WEEDTPU_READ_CACHE_MB"] = "0"
        rng = np.random.default_rng(seed + 1802)
        big = [e for e in plan if e[1] > FILER_RANGE]
        picks = [big[int(i)] for i in rng.integers(0, len(big), FILER_RANGES)]
        shape0 = dict(rs_cuda.launches_by_shape)
        range_ms, range_fids = [], []
        t0 = time.perf_counter()
        for path, size, ds in picks:
            lo = int(rng.integers(0, size - FILER_RANGE + 1))
            t1 = time.perf_counter()
            status, body = _filer_get(conn, path, (lo, lo + FILER_RANGE))
            range_ms.append((time.perf_counter() - t1) * 1e3)
            check(status == 206 and body == _filer_data(ds, size)[lo: lo + FILER_RANGE],
                  f"range {lo} of {path} differs")
            c0, c1 = lo // (4 << 20), (lo + FILER_RANGE - 1) // (4 << 20)
            range_fids += chunks_of[path][c0: c1 + 1]
        range_s = time.perf_counter() - t0
        range_shape = _shape_launches(shape0)
        range_pred = predict(range_fids)
        check(range_shape == ({(1, 10): range_pred} if on_card and range_pred else {}),
              f"the range reads launched {range_shape}, predicted (1, 10) x {range_pred}")
        out["ranges"] = {"reads": FILER_RANGES, "bytes": FILER_RANGE, "seconds": range_s,
                         "p50_ms": _pct(range_ms, 0.5), "p99_ms": _pct(range_ms, 0.99),
                         "launches_by_shape": _shape_keys(range_shape),
                         "predicted_1x10": range_pred}

        # 6: the default caches over the first degraded files of the cold
        # pass's order (FILER_REPEAT_BYTES in all), hedging still off so that
        # the prediction holds: (a) the servers' decoded-interval cache at
        # its defaults and cleared, the filer's 64 MiB chunk cache on: the
        # predicted launches, a chunk cache miss per chunk; (b) the same files
        # with the chunk cache off, within the interval cache's TTL: a hit per
        # lost interval (one per lost shard a needle touches), no launch;
        # (c) again with the chunk cache: a hit per chunk, no server lookup
        _put_env({"WEEDTPU_READ_CACHE_MB": saved_cache})
        read_planner.CACHE.clear()
        fs.chunk_io.cache = cache = ChunkCache()
        repeat, held = [], 0
        for p in [q for q in order if q in degraded]:
            if held + sizes[p] > FILER_REPEAT_BYTES:
                break
            repeat.append(p)
            held += sizes[p]
        fids = [f for p in repeat for f in chunks_of[p]]
        pred = predict(fids)

        def cached_pass() -> tuple[dict, dict]:
            rc0 = (stats.ReadCacheHits.value, stats.ReadCacheMisses.value)
            cc0 = (cache.hits, cache.misses)
            res = read_pass(repeat)
            launched = res.pop("launches")
            res["launches_by_shape"] = _shape_keys(launched)
            res["interval_cache"] = {"hits": stats.ReadCacheHits.value - rc0[0],
                                     "misses": stats.ReadCacheMisses.value - rc0[1]}
            res["chunk_cache"] = {"hits": cache.hits - cc0[0], "misses": cache.misses - cc0[1]}
            return res, launched

        what = f"over {len(repeat)} files, {len(fids)} chunks, predicted (1, 10) x {pred}"
        first, launched = cached_pass()
        check(launched == ({(1, 10): pred} if on_card else {})
              and first["interval_cache"]["hits"] == 0
              and first["chunk_cache"] == {"hits": 0, "misses": len(fids)},
              f"the first cached pass {what}: {first}")
        fs.chunk_io.cache = None
        by_interval, launched = cached_pass()
        check(not launched and by_interval["interval_cache"]["hits"] == pred,
              f"the interval cache's repeat {what}: {by_interval}")
        fs.chunk_io.cache = cache
        by_chunk, launched = cached_pass()
        check(not launched and by_chunk["chunk_cache"] == {"hits": len(fids), "misses": 0}
              and by_chunk["interval_cache"] == {"hits": 0, "misses": 0},
              f"the chunk cache's repeat {what}: {by_chunk}")
        _put_env({"WEEDTPU_HEDGE_READS": saved_hedge})
        out["reads"] = {"cold": cold, "degraded_files": len(degraded),
                        "default_caches": {"files": len(repeat), "bytes": held, "chunks": len(fids),
                                           "predicted_1x10": pred, "first": first,
                                           "interval_cache": by_interval,
                                           "chunk_cache": by_chunk}}

        # 7: FILER_LATE more files after the encode (a fresh, plain volume:
        # the one volume.fsck audits), then fs.du, fs.tree, fs.mv of a leaf
        # subtree, fs.rm -r of a tenth of the files, volume.fsck
        late = [(f"/{coll}/t{i % FILER_TREE[0]}/d{i // FILER_TREE[0] % FILER_TREE[1]}/"
                 f"late{i:02d}.bin", int(s), seed * 100_000 + 50_000 + i)
                for i, s in enumerate(np.random.default_rng(seed + 1803).integers(
                    4 << 10, 1 << 20, FILER_LATE))]
        for path, size, ds in late:
            data = _filer_data(ds, size)
            _filer_put(local, fs.url, path, data)
            digest[path], sizes[path] = hashlib.sha256(data).hexdigest(), size
            seed_of[path] = ds
            chunks_of[path] = [c.fid for c in fs.filer.find_entry(path).chunks]
        all_bytes = sum(sizes.values())
        n_dirs = FILER_TREE[0] + FILER_TREE[0] * FILER_TREE[1]
        du, du_s, _ = shell(f"fs.du /{coll}")
        check(f"/{coll}: {len(sizes)} files, {all_bytes} bytes" in du, f"fs.du: {du}")
        tree, tree_s, _ = shell(f"fs.tree /{coll}")
        check(tree.rstrip().endswith(f"{n_dirs} directories, {len(sizes)} files"),
              f"fs.tree: {tree[-200:]}")
        src, dst = f"/{coll}/t{FILER_TREE[0] - 1}/d{FILER_TREE[1] - 1}", f"/{coll}/t0/moved"
        moved = sorted(p for p in sizes if p.startswith(src + "/"))
        mv, mv_s, _ = shell(f"fs.mv {src} {dst}")
        for p in moved:
            q = dst + p[len(src):]
            digest[q], sizes[q], chunks_of[q] = digest.pop(p), sizes.pop(p), chunks_of.pop(p)
            seed_of[q] = seed_of.pop(p)
            status, body = _filer_get(conn, q)
            check(status == 200 and hashlib.sha256(body).hexdigest() == digest[q],
                  f"{q} after fs.mv")
            check(_filer_get(conn, p)[0] == 404, f"{p} still there after fs.mv")
        leaves = sorted({p.rsplit("/", 1)[0] for p in sizes})
        doomed, gone = [], []
        for leaf in (leaves[int(i)] for i in np.random.default_rng(seed + 1804).permutation(
                len(leaves))):
            if len(gone) * 10 >= len(sizes):
                break
            doomed.append(leaf)
            gone += [p for p in sizes if p.startswith(leaf + "/")]
        rm, rm_s, _ = shell("; ".join(f"fs.rm -r {d}" for d in doomed))
        gone_fids = [f for p in gone for f in chunks_of[p]]
        for p in gone:
            check(_filer_get(conn, p)[0] == 404, f"{p} still there after fs.rm -r")
            digest.pop(p), sizes.pop(p), chunks_of.pop(p), seed_of.pop(p)
        reader = MasterClient(master.address)
        try:
            for fid in gone_fids[:: max(1, len(gone_fids) // 32)]:
                try:
                    reader.read(fid)
                    check(False, f"a chunk of a removed file still reads: {fid}")
                except ClusterError:
                    pass
        finally:
            reader.close()
        fsck, fsck_s, _ = shell("lock; volume.fsck -cutoffTimeAgo 0; unlock")
        check("volume.fsck: found 0 orphan needles (0 bytes), 0 missing references" in fsck
              and "orphan" not in fsck.replace("found 0 orphan", ""), f"volume.fsck: {fsck}")
        out["namespace"] = {"du_s": du_s, "tree_s": tree_s, "mv_s": mv_s, "moved": len(moved),
                            "rm_s": rm_s, "removed_dirs": len(doomed), "removed": len(gone),
                            "removed_chunks": len(gone_fids), "live": len(sizes),
                            "late_files": FILER_LATE, "fsck_s": fsck_s,
                            "fsck": fsck.strip().splitlines()[-2]}

        # 8: fs.meta.save, a filer restart on the same store and ports, again
        dumps = [os.path.join(root, "meta_before.jsonl"), os.path.join(root, "meta_after.jsonl")]
        saved, save_s, _ = shell(f"fs.meta.save -o {dumps[0]} /")
        conn.close()
        t0 = time.perf_counter()
        fs.stop()
        filers.remove(fs)
        fs = start_filer(64 << 20)
        restart_s = time.perf_counter() - t0
        conn = connection(fs)
        saved2, _, _ = shell(f"fs.meta.save -o {dumps[1]} /")
        with open(dumps[0], "rb") as a, open(dumps[1], "rb") as b:
            before, after = a.read(), b.read()
        check(before == after and saved.split(" to ")[0] == saved2.split(" to ")[0],
              "fs.meta.save differs across the filer restart")
        for p in sorted(sizes)[:: max(1, len(sizes) // 64)]:
            status, body = _filer_get(conn, p)
            check(status == 200 and hashlib.sha256(body).hexdigest() == digest[p],
                  f"{p} after the restart")
        out["restart"] = {"seconds": restart_s, "meta_save_s": save_s,
                          "entries": before.count(b"\n"), "bytes": len(before),
                          "byte_equal": True}
        out["seconds"] = time.perf_counter() - t_phase
        by_shape = dict(rs_cuda.launches_by_shape)
        out["launches_by_shape"] = _shape_keys(by_shape)
        out["launches"] = dict(rs_cuda.launches_by_variant)
        out["busy"] = _busy(by_shape, kernel_ms, out["seconds"])
        check(all(c == 10 for _, c in by_shape) and (by_shape.get((1, 10), 0) > 0 if on_card
                                                      else not by_shape),
              f"the filer path launched {by_shape}")
        if then is not None:
            out["_then"] = then(master, servers, fs, {
                "coll": coll, "digest": digest, "sizes": sizes, "seed_of": seed_of,
                "chunks_of": chunks_of, "shards": shards})
    finally:
        _put_env({"WEEDTPU_HEDGE_READS": saved_hedge, "WEEDTPU_READ_CACHE_MB": saved_cache})
        for c in conns:
            c.close()
        for env in envs:
            env.close()
        halt = [threading.Thread(target=s.stop) for s in [*filers, *servers, master]]
        for t in halt:
            t.start()
        for t in halt:
            t.join()
    return out


#: the s3 phase's deployment (the SeaweedFS wiki's "Amazon S3 API", "Amazon
#: IAM API" and "Erasure Coding for warm storage"), on the filer phase's cluster
S3_BUCKET = "s3warm"
S3_OTHER_BUCKET = "s3cold"
S3_OBJECTS = 384
S3_MIN, S3_MAX = 4 << 10, 8 << 20
S3_TREE = (4, 8)
S3_WRITERS = 8
S3_VOLUMES = 3
S3_PARTS, S3_PART = 6, 8 << 20
S3_ABANDONED_PARTS = 2
S3_RANGES = 128
S3_RANGES_IN_MULTIPART = 16
S3_RANGE = 64 << 10
S3_PRESIGNED = 16
S3_PAGE = 100
S3_DELETES = 32
S3_MULTIPART_KEY = "mp/o-multipart.bin"


def _s3_request(conn, host: str, creds: tuple, method: str, path: str, body: bytes = b"",
                query: str = "", headers: dict | None = None) -> tuple[int, dict, bytes]:
    """One SigV4-signed request (`creds` = (access key, secret key), or None
    for an unsigned one) on the keep-alive connection `conn`."""
    import urllib.parse

    from seaweedfs_tpu_torch.s3api.auth import sign_request

    target = urllib.parse.quote(path) + (f"?{query}" if query else "")
    h = dict(headers or {})
    if creds is not None:
        h = sign_request(creds[0], creds[1], method, f"http://{host}{target}", body,
                         extra_headers=h)
    conn.request(method, target, body=body or None, headers=h)
    r = conn.getresponse()
    return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()


def _s3_code(body: bytes) -> str:
    import re

    m = re.search(rb"<Code>([^<]*)</Code>", body)
    return m.group(1).decode() if m else ""


def _iam_request(url: str, creds: tuple, **form) -> tuple[int, bytes]:
    import urllib.error
    import urllib.parse
    import urllib.request

    from seaweedfs_tpu_torch.s3api.auth import sign_request

    data = urllib.parse.urlencode(form).encode()
    h = sign_request(creds[0], creds[1], "POST", url, data, service="iam")
    req = urllib.request.Request(url, data=data, method="POST", headers=h)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _chunks_in(chunks: list, lo: int, hi: int) -> list:
    """The fids of the chunks (fid, offset, size) that bytes [lo, hi) touch."""
    return [fid for fid, off, size in chunks if off < hi and lo < off + size]


def run_s3(root: str, master, servers: list, fs, seed: int, card: str, kernel_ms: dict,
           device: str = "cuda", objects: int = S3_OBJECTS, max_bytes: int = S3_MAX,
           part_bytes: int = S3_PART) -> dict:
    """The s3 phase (see the module doc), on the filer phase's running
    master, volume servers and filer: objects through the port's S3 gateway
    under an IAM-issued key, the bucket's collection EC-encoded, read back
    degraded by signed, presigned and WebDAV GETs."""
    import http.client
    import re
    import urllib.parse
    import xml.etree.ElementTree as ET
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.iamapi import IamApiServer
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.s3api import Iam, S3ApiServer
    from seaweedfs_tpu_torch.s3api.auth import presign_url
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.webdav import WebDavServer

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    rs_cuda.reset_launches()  # the s3 path's run starts here
    bucket, lost = S3_BUCKET, set(FILER_LOST)
    rng = np.random.default_rng(seed + 1900)
    admin = ("s3admin", rng.bytes(15).hex())
    saved = {k: os.environ.get(k) for k in ("WEEDTPU_HEDGE_READS", "WEEDTPU_READ_CACHE_MB")}
    chunk_cache = fs.chunk_io.cache
    fs.chunk_io.cache = None  # the filer's chunk cache off for the whole phase
    gateways, conns, envs = [], [], []
    out = {"card": card,
           "source": "SeaweedFS wiki: Amazon S3 API (weed s3 -config identities.json; "
                     "/buckets/<name> with its own collection), Amazon IAM API (weed iam), "
                     "Erasure Coding for warm storage (ec.encode -collection)",
           "reduced": [f"{objects} objects of {S3_MIN}-{max_bytes} bytes and one "
                       f"{S3_PARTS} x {part_bytes} byte multipart object, not a "
                       "deployment's millions", f"{S3_VOLUMES} volumes of collection "
                       f"{bucket} grown up front, each far below 30 GB", "one host: the "
                       "filer phase's master, 3 volume servers and filer, with the S3, "
                       "IAM and WebDAV gateways and the shell, in one process over loopback"],
           "bucket": bucket, "objects": objects, "volumes": S3_VOLUMES, "lost": sorted(lost)}

    def shell(script: str) -> str:
        env = CommandEnv(master.address, device=device)
        envs.append(env)
        buf = io.StringIO()
        for cmd in script.split(";"):
            run_command(env, cmd.strip(), buf)
        return buf.getvalue()

    def connection(port: int):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conns.append(c)
        return c

    try:
        # 1: the gateway with a -config admin identity (the s3 command's file
        # shape), the IAM API with a bootstrap token, WebDAV; the loader user
        # and its key minted through IAM, the bucket made by the shell
        os.makedirs(root)
        conf = os.path.join(root, "identities.json")
        with open(conf, "w", encoding="utf-8") as f:
            json.dump({"identities": [{"name": "admin", "credentials": [
                {"accessKey": admin[0], "secretKey": admin[1]}], "actions": ["Admin"]}]}, f)
        with open(conf, encoding="utf-8") as f:
            s3 = S3ApiServer(fs.url, fs.grpc_address, iam=Iam.from_config(json.load(f)))
        s3.start()
        gateways.append(s3)
        iam = IamApiServer(fs.grpc_address, bootstrap_token=rng.bytes(8).hex())
        iam.start()
        gateways.append(iam)
        dav = WebDavServer(fs.url, fs.grpc_address)
        dav.start()
        gateways.append(dav)
        iam_url = f"http://{iam.url}/"
        ns = "{https://iam.amazonaws.com/doc/2010-05-08/}"
        status, body = _iam_request(iam_url, admin, Action="CreateUser", UserName="loader")
        check(status == 200, f"IAM CreateUser: {status} {body[:200]!r}")
        status, body = _iam_request(iam_url, admin, Action="CreateAccessKey", UserName="loader")
        check(status == 200, f"IAM CreateAccessKey: {status} {body[:200]!r}")
        doc = ET.fromstring(body)
        loader = (doc.find(f".//{ns}AccessKeyId").text, doc.find(f".//{ns}SecretAccessKey").text)
        policy = {"Statement": [{"Effect": "Allow", "Action": [
            "s3:GetObject", "s3:PutObject", "s3:ListBucket"],
            "Resource": f"arn:aws:s3:::{bucket}/*"}]}
        status, body = _iam_request(iam_url, admin, Action="PutUserPolicy", UserName="loader",
                                    PolicyName="warm", PolicyDocument=json.dumps(policy))
        check(status == 200, f"IAM PutUserPolicy: {status} {body[:200]!r}")
        granted = sorted(iam.iam.lookup(loader[0]).actions)
        check(granted == [f"List:{bucket}", f"Read:{bucket}", f"Write:{bucket}"],
              f"the loader's actions: {granted}")
        made = shell(f"s3.bucket.create -name {bucket}; s3.bucket.create -name {S3_OTHER_BUCKET}")
        check(f"created bucket {bucket}" in made, f"s3.bucket.create: {made}")
        grown = master._rpc_volume_grow({"collection": bucket, "count": S3_VOLUMES}, None)
        check(grown["grown"] == S3_VOLUMES, f"volume grow: {grown}")
        out["identities"] = {"loader_actions": granted, "config_identities": 1}

        # 2: the seeded objects by signed PUT from S3_WRITERS threads under
        # the loader's key (each ETag the object's md5), the multipart
        # object, and an upload abandoned after its first parts
        plan = [(f"p{leaf // S3_TREE[1]}/q{leaf % S3_TREE[1]}/o{i:04d}.bin", size, ds)
                for i, (size, leaf, ds) in enumerate(zip(
                    np.exp(rng.uniform(np.log(S3_MIN), np.log(max_bytes), objects)).astype(
                        np.int64).tolist(),
                    rng.integers(0, S3_TREE[0] * S3_TREE[1], objects).tolist(),
                    (seed * 100_000 + 70_000 + np.arange(objects)).tolist()))]
        local = threading.local()

        def put(item) -> tuple:
            key, size, ds = item
            data = _filer_data(ds, size)
            conn = getattr(local, "c", None)
            if conn is None:
                conn = local.c = connection(s3.port)
            t = time.perf_counter()
            status, h, body = _s3_request(conn, s3.url, loader, "PUT", f"/{bucket}/{key}", data)
            ms = (time.perf_counter() - t) * 1e3
            check(status == 200 and h.get("etag") == f'"{hashlib.md5(data).hexdigest()}"',
                  f"PUT {key}: {status} {h.get('etag')} {body[:200]!r}")
            return hashlib.sha256(data).hexdigest(), ms

        t0 = time.perf_counter()
        with ThreadPoolExecutor(S3_WRITERS) as pool:
            puts = list(pool.map(put, plan))
        write_s = time.perf_counter() - t0
        digest = {key: h for (key, _, _), (h, _) in zip(plan, puts)}
        sizes = {key: size for key, size, _ in plan}
        data_of = {key: ds for key, _, ds in plan}
        ms = [m for _, m in puts]
        total = sum(sizes.values())
        out["write"] = {"seconds": write_s, "objects_per_s": objects / write_s,
                        "mb_per_s": total / write_s / 1e6, "bytes": total,
                        "p50_ms": _pct(ms, 0.5), "p99_ms": _pct(ms, 0.99), "writers": S3_WRITERS}

        conn = connection(s3.port)

        def upload_parts(key: str, n: int, base_seed: int) -> tuple[str, list, list]:
            status, _, body = _s3_request(conn, s3.url, loader, "POST", f"/{bucket}/{key}",
                                          query="uploads")
            check(status == 200, f"CreateMultipartUpload {key}: {status} {body[:200]!r}")
            upload = re.search(rb"<UploadId>([^<]*)</UploadId>", body).group(1).decode()
            parts, etags = [], []
            for i in range(1, n + 1):
                data = _filer_data(base_seed + i, part_bytes)
                status, h, body = _s3_request(conn, s3.url, loader, "PUT", f"/{bucket}/{key}",
                                              data, query=f"partNumber={i}&uploadId={upload}")
                check(status == 200 and h.get("etag") == f'"{hashlib.md5(data).hexdigest()}"',
                      f"UploadPart {i} of {key}: {status} {body[:200]!r}")
                parts.append(data)
                etags.append(h["etag"])
            return upload, parts, etags

        t0 = time.perf_counter()
        upload, parts, etags = upload_parts(S3_MULTIPART_KEY, S3_PARTS, seed * 100_000 + 80_000)
        done = "".join(f"<Part><PartNumber>{i}</PartNumber><ETag>{t}</ETag></Part>"
                       for i, t in enumerate(etags, start=1))
        status, _, body = _s3_request(
            conn, s3.url, loader, "POST", f"/{bucket}/{S3_MULTIPART_KEY}",
            f"<CompleteMultipartUpload>{done}</CompleteMultipartUpload>".encode(),
            query=f"uploadId={upload}")
        want_etag = hashlib.md5(b"".join(hashlib.md5(p).digest() for p in parts)).hexdigest()
        check(status == 200 and f"{want_etag}-{S3_PARTS}".encode() in body,
              f"CompleteMultipartUpload: {status} {body[:300]!r}")
        multipart_s = time.perf_counter() - t0
        mp = b"".join(parts)
        digest[S3_MULTIPART_KEY] = hashlib.sha256(mp).hexdigest()
        sizes[S3_MULTIPART_KEY] = len(mp)
        abandoned, _, _ = upload_parts("abandoned.bin", S3_ABANDONED_PARTS,
                                       seed * 100_000 + 90_000)
        out["multipart"] = {"parts": S3_PARTS, "part_bytes": part_bytes, "seconds": multipart_s,
                            "etag": f"{want_etag}-{S3_PARTS}",
                            "abandoned_parts": S3_ABANDONED_PARTS}

        def entry_chunks(key: str) -> list:
            e = fs.filer.find_entry(f"/buckets/{bucket}/{key}")
            return [(c.fid, c.offset, c.size) for c in e.chunks]

        chunks = {key: entry_chunks(key) for key in sizes}
        chunks_of = {key: [fid for fid, _, _ in cs] for key, cs in chunks.items()}

        # 3: ec.encode of the bucket's collection through the shell, then
        # data shards 0 and 5 lost cluster-wide
        vids = {v for n in master.topology.nodes.values()
                for v, vi in n.volumes.items() if vi.collection == bucket}
        check({int(f.split(",")[0]) for c in chunks_of.values() for f in c} <= vids,
              f"an object's chunk lies outside the collection's volumes {sorted(vids)}")
        shape0 = dict(rs_cuda.launches_by_shape)
        t0 = time.perf_counter()
        text = shell(f"lock; ec.encode -collection {bucket} -force; unlock")
        enc_s = time.perf_counter() - t0
        check(all(f"ec.encode volume {v}" in text for v in vids), f"ec.encode: {text}")
        _cluster_wait(lambda: all(len(master.topology.lookup_ec_shards(v)) == 14 for v in vids)
                      and not any(master.topology.lookup(v, bucket) for v in vids),
                      "every volume of the bucket's collection EC-encoded")
        enc_shape = _shape_launches(shape0)
        check(set(enc_shape) <= {(4, 10), (1, 10)} and (enc_shape.get((4, 10), 0) > 0
                                                         if on_card else not enc_shape),
              f"ec.encode launched {enc_shape}")
        out["encode"] = {"seconds": enc_s, "volumes": len(vids),
                         "launches_by_shape": _shape_keys(enc_shape)}
        for vid in vids:
            for vs in servers:
                ev = vs.store.get_ec_volume(vid)
                mine = [sh for sh in sorted(lost) if ev is not None and sh in ev.shard_ids]
                if mine:
                    with rpc.RpcClient(vs.grpc_address) as c:
                        c.call(VOLUME_SERVICE, "VolumeEcShardsDelete",
                               {"volume_id": vid, "collection": bucket, "shard_ids": mine},
                               timeout=600)
        _cluster_wait(lambda: all(len([sh for sh, ns in master.topology.lookup_ec_shards(v).items()
                                       if ns]) == 12 for v in vids),
                      "the master to list 12 shards of every volume")
        for vs in servers:  # the mounts' warm-up launches, before the reads count theirs
            for vid in vids:
                ev = vs.store.get_ec_volume(vid)
                if ev is not None and ev.warm_thread is not None:
                    ev.warm_thread.join()
        shards = _filer_chunk_shards(servers, vids, chunks_of, bucket)
        degraded = {k for k, cs in chunks_of.items() if any(shards[f] & lost for f in cs)}

        def predict(fids) -> int:  # one (1, 10) launch per lost shard a needle touches
            return sum(len(shards[f] & lost) for f in fids)

        def expect(launched: dict, fids, what: str) -> int:
            pred = predict(fids)
            check(launched == ({(1, 10): pred} if on_card and pred else {}),
                  f"{what} launched {launched}, predicted (1, 10) x {pred}")
            return pred

        # 4: the cold pass: every object by signed GET, serially on one
        # keep-alive connection, hedging off, server caches cleared and off
        _put_env({"WEEDTPU_HEDGE_READS": "off", "WEEDTPU_READ_CACHE_MB": "0"})
        read_planner.CACHE.clear()
        order = sorted(sizes)
        order = [order[i] for i in rng.permutation(len(order))]
        by_class = {"degraded": [], "healthy": []}
        mib = {"degraded": [], "healthy": []}  # the objects of 0.5-2 MiB
        shape0 = dict(rs_cuda.launches_by_shape)
        t0 = time.perf_counter()
        for key in order:
            t1 = time.perf_counter()
            status, _, body = _s3_request(conn, s3.url, loader, "GET", f"/{bucket}/{key}")
            ms = (time.perf_counter() - t1) * 1e3
            check(status == 200 and len(body) == sizes[key]
                  and hashlib.sha256(body).hexdigest() == digest[key], f"GET {key} differs")
            klass = "degraded" if key in degraded else "healthy"
            by_class[klass].append(ms)
            if 512 << 10 <= sizes[key] < 2 << 20:
                mib[klass].append(ms)
        cold_s = time.perf_counter() - t0
        cold_pred = expect(_shape_launches(shape0), [f for k in order for f in chunks_of[k]],
                           "the cold pass")
        out["cold"] = {"seconds": cold_s, "objects": len(order),
                       "mb_per_s": sum(sizes.values()) / cold_s / 1e6,
                       "predicted_1x10": cold_pred, "degraded_objects": len(degraded), **{
                           k: {"objects": len(v), "p50_ms": _pct(v, 0.5), "p99_ms": _pct(v, 0.99),
                               "p50_ms_1mib": _pct(mib[k], 0.5)} for k, v in by_class.items()}}

        # 5: seeded signed 64 KiB ranges (some inside the multipart object),
        # presigned GETs and WebDAV GETs of degraded objects, a PROPFIND
        big = [k for k in sorted(sizes) if sizes[k] > S3_RANGE and k != S3_MULTIPART_KEY]
        picks = [big[int(i)] for i in rng.integers(0, len(big), S3_RANGES - S3_RANGES_IN_MULTIPART)]
        picks += [S3_MULTIPART_KEY] * S3_RANGES_IN_MULTIPART
        range_ms, range_fids = [], []
        shape0 = dict(rs_cuda.launches_by_shape)
        for key in picks:
            lo = int(rng.integers(0, sizes[key] - S3_RANGE + 1))
            t1 = time.perf_counter()
            status, _, body = _s3_request(conn, s3.url, loader, "GET", f"/{bucket}/{key}",
                                          headers={"Range": f"bytes={lo}-{lo + S3_RANGE - 1}"})
            range_ms.append((time.perf_counter() - t1) * 1e3)
            whole = mp if key == S3_MULTIPART_KEY else _filer_data(data_of[key], sizes[key])
            check(status == 206 and body == whole[lo: lo + S3_RANGE], f"range {lo} of {key}")
            range_fids += _chunks_in(chunks[key], lo, lo + S3_RANGE)
        ranges_pred = expect(_shape_launches(shape0), range_fids, "the signed ranges")
        out["ranges"] = {"reads": len(picks), "bytes": S3_RANGE,
                         "in_multipart": S3_RANGES_IN_MULTIPART, "p50_ms": _pct(range_ms, 0.5),
                         "p99_ms": _pct(range_ms, 0.99), "predicted_1x10": ranges_pred}

        chosen = [k for k in order if k in degraded and k != S3_MULTIPART_KEY][:S3_PRESIGNED]
        check(len(chosen) == S3_PRESIGNED, f"only {len(chosen)} degraded objects")

        def unsigned_pass(c, target_of, what: str) -> dict:
            """The chosen objects by plain GET of `target_of(key)` on `c`."""
            shape0 = dict(rs_cuda.launches_by_shape)
            ms = []
            for key in chosen:
                t1 = time.perf_counter()
                c.request("GET", target_of(key))
                r = c.getresponse()
                body = r.read()
                ms.append((time.perf_counter() - t1) * 1e3)
                check(r.status == 200 and hashlib.sha256(body).hexdigest() == digest[key],
                      f"{what} {key}: {r.status}")
            pred = expect(_shape_launches(shape0), [f for k in chosen for f in chunks_of[k]],
                          f"the {what}s")
            return {"reads": len(chosen), "p50_ms": _pct(ms, 0.5), "p99_ms": _pct(ms, 0.99),
                    "predicted_1x10": pred}

        out["presigned"] = unsigned_pass(
            connection(s3.port), lambda key: presign_url(
                loader[0], loader[1], "GET", f"http://{s3.url}/{bucket}/{key}",
                expires=600).split(s3.url, 1)[1], "presigned GET")
        dconn = connection(dav.port)
        out["webdav"] = unsigned_pass(dconn, lambda key: f"/buckets/{bucket}/{key}", "WebDAV GET")
        prefix = "p0/q3"
        dconn.request("PROPFIND", f"/buckets/{bucket}/{prefix}", headers={"Depth": "1"})
        r = dconn.getresponse()
        body = r.read()
        hrefs = [h.text for h in ET.fromstring(body).findall(".//{DAV:}href")]
        want = [f"/buckets/{bucket}/{prefix}/"] + sorted(
            f"/buckets/{bucket}/{k}" for k in sizes if k.startswith(prefix + "/"))
        check(r.status == 207 and sorted(hrefs) == sorted(want),
              f"PROPFIND {prefix}: {r.status} {hrefs[:5]} ...")
        out["webdav"]["propfind_entries"] = len(hrefs) - 1

        # 6: the listing in pages, the refusals, DeleteObjects, the shell
        listed, token, pages = [], "", 0
        while True:
            q = f"list-type=2&max-keys={S3_PAGE}"
            if token:
                q += f"&continuation-token={urllib.parse.quote(token)}"
            status, _, body = _s3_request(conn, s3.url, loader, "GET", f"/{bucket}", query=q)
            check(status == 200, f"ListObjectsV2 page {pages}: {status}")
            pages += 1
            listed += [m.decode() for m in re.findall(rb"<Key>([^<]*)</Key>", body)]
            if b"<IsTruncated>true</IsTruncated>" not in body:
                break
            token = re.search(rb"<NextContinuationToken>([^<]*)<", body).group(1).decode()
        check(listed == sorted(sizes), f"the listing: {len(listed)} keys in {pages} pages")
        key0 = order[0]
        status, _, body = _s3_request(conn, s3.url, None, "GET", f"/{bucket}/{key0}")
        check(status == 403 and _s3_code(body) == "AccessDenied", f"unsigned GET: {status}")
        status, _, body = _s3_request(conn, s3.url, loader, "GET", f"/{S3_OTHER_BUCKET}",
                                      query="list-type=2")
        check(status == 403 and _s3_code(body) == "AccessDenied",
              f"the loader on {S3_OTHER_BUCKET}: {status} {_s3_code(body)}")
        doomed = [k for k in sorted(sizes) if k != S3_MULTIPART_KEY]
        doomed = [doomed[int(i)] for i in rng.choice(len(doomed), S3_DELETES, replace=False)]
        xml = "".join(f"<Object><Key>{k}</Key></Object>" for k in doomed)
        status, _, body = _s3_request(conn, s3.url, loader, "POST", f"/{bucket}",
                                      f"<Delete>{xml}</Delete>".encode(), query="delete")
        check(status == 200 and body.count(b"<Deleted>") == S3_DELETES
              and b"<Error>" not in body, f"DeleteObjects: {status} {body[:300]!r}")
        for k in doomed:
            status, _, body = _s3_request(conn, s3.url, loader, "GET", f"/{bucket}/{k}")
            check(status == 404 and _s3_code(body) == "NoSuchKey", f"{k} after DeleteObjects")
        buckets = shell("s3.bucket.list")
        check(f"{bucket}\n" in buckets and "total 2 buckets" in buckets,
              f"s3.bucket.list: {buckets}")
        staged = f"/buckets/.uploads/{bucket}/{abandoned}"
        check(s3.filer.lookup(staged) is not None, "the abandoned upload's staging dir")
        cleaned = shell("lock; s3.clean.uploads -timeAgoSeconds 0; unlock")
        check(f"aborted stale upload {bucket}/{abandoned}" in cleaned
              and "1 aborted, 0 kept" in cleaned, f"s3.clean.uploads: {cleaned}")
        check(s3.filer.lookup(staged) is None, "the abandoned upload survived")
        out["checks"] = {"listed": len(listed), "pages": pages, "unsigned": 403,
                         "other_bucket": "AccessDenied", "deleted": S3_DELETES,
                         "buckets": buckets.strip().splitlines()[-1],
                         "clean_uploads": next(ln for ln in cleaned.splitlines()
                                               if ln.startswith("s3.clean.uploads:"))}
    finally:
        _put_env(saved)
        fs.chunk_io.cache = chunk_cache
        for c in conns:
            c.close()
        for env in envs:
            env.close()
        for g in reversed(gateways):
            g.stop()
    out["seconds"] = time.perf_counter() - t_phase
    by_shape = dict(rs_cuda.launches_by_shape)
    out["launches_by_shape"] = _shape_keys(by_shape)
    out["launches"] = dict(rs_cuda.launches_by_variant)
    out["busy"] = _busy(by_shape, kernel_ms, out["seconds"])
    check(all(c == 10 for _, c in by_shape) and (by_shape.get((1, 10), 0) > 0 if on_card
                                                  else not by_shape),
          f"the s3 path launched {by_shape}")
    return out


#: the sync phase's deployment (the SeaweedFS wiki's "Filer Active Active
#: cross cluster continuous synchronization", "Async Backup", "FUSE Mount",
#: "Path-Specific Configuration" and upstream's `weed mq.broker`), on the
#: filer phase's cluster after the s3 phase
SYNC_DIRS = ("t1", "t2", "t3")  # filer.sync, filer.backup, the S3 sink
SYNC_MUTATIONS = (12, 10, 10)  # overwrites, renames, deletes on the synced directory
SYNC_REPLICA = "replica"  # the second filer's /replica/ collection
SYNC_BUCKET = "syncbkt"
SYNC_VOLUMES = 3  # grown up front for the replica and the bucket
SYNC_COPY_FILES = 64
SYNC_MOUNT_FILES = 64
SYNC_MOUNT_RANGES = 128  # cut from 256 for the script's time
SYNC_MOUNT_RANGE = 64 << 10
SYNC_MOUNT_WRITE = 64 << 20
SYNC_MQ_COLLECTION = "mqwarm"
SYNC_MQ_TOPIC = "events"
SYNC_MQ_PARTITIONS = 4
SYNC_MQ_RECORDS = 2048  # cut from 8192 for the script's time: each publish is one unary call
SYNC_MQ_RECORD = 1 << 10
SYNC_MQ_PUBLISHERS = 4
SYNC_MQ_COMMIT_EVERY = 64


@contextlib.contextmanager
def _timed_file_reads(cls):
    """Every `cls.read_file(path)` in the block appends (path, ms) to the
    list it yields."""
    log: list = []
    orig = cls.read_file

    def read_file(self, path):
        t = time.perf_counter()
        data = orig(self, path)
        log.append((path, (time.perf_counter() - t) * 1e3))
        return data

    cls.read_file = read_file
    try:
        yield log
    finally:
        cls.read_file = orig


def _read_classes(ms_of: list, degraded) -> dict:
    """p50/p99 of (path, ms) reads by class (degraded: `degraded(path)`)."""
    out = {}
    for klass in ("degraded", "healthy"):
        ms = [m for p, m in ms_of if bool(degraded(p)) == (klass == "degraded")]
        out[klass] = {"reads": len(ms), "p50_ms": _pct(ms, 0.5), "p99_ms": _pct(ms, 0.99)}
    return out


def run_sync(root: str, master, servers: list, fs, tree: dict, seed: int, card: str,
             kernel_ms: dict, device: str = "cuda", mount_files: int = SYNC_MOUNT_FILES,
             mount_ranges: int = SYNC_MOUNT_RANGES, mount_bytes: int = SYNC_MOUNT_WRITE,
             mq_records: int = SYNC_MQ_RECORDS) -> dict:
    """The sync phase (see the module doc), on the filer phase's running
    master, volume servers and filer: filer.sync into a second filer,
    filer.backup, an S3 sink, filer.copy, filer.meta.tail, a mount and a
    consumer group, each reading the warm collection's EC-degraded files."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.__main__ import main as cli
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.filer import FilerServer, make_store
    from seaweedfs_tpu_torch.filer.client import FilerClient
    from seaweedfs_tpu_torch.mount import WFS
    from seaweedfs_tpu_torch.mq import Broker, BrokerClient
    from seaweedfs_tpu_torch.ops import rs_cuda
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.replication import FilerSink, Replicator, S3Sink
    from seaweedfs_tpu_torch.s3api import Iam, Identity, S3ApiServer
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    phase_ns = time.time_ns()
    rs_cuda.reset_launches()  # the sync path's run starts here
    coll, lost = tree["coll"], set(FILER_LOST)
    digest, sizes, seed_of = dict(tree["digest"]), dict(tree["sizes"]), dict(tree["seed_of"])
    chunks_of, shards = dict(tree["chunks_of"]), dict(tree["shards"])
    rng = np.random.default_rng(seed + 2000)
    saved = {k: os.environ.get(k) for k in ("WEEDTPU_HEDGE_READS", "WEEDTPU_READ_CACHE_MB")}
    chunk_cache = fs.chunk_io.cache
    fs.chunk_io.cache = None  # the filer's chunk cache off for the whole phase
    started, envs, conns, mounts = [], [], [], []
    local = threading.local()
    out = {"card": card,
           "source": "SeaweedFS wiki: Filer Active Active cross cluster continuous "
                     "synchronization, Async Backup, FUSE Mount, Path-Specific Configuration; "
                     "upstream weed mq.broker; over Erasure Coding for warm storage",
           "reduced": [f"the filer phase's ~{len(sizes)} files, not millions; one top-level "
                       "directory each for filer.sync, filer.backup and the S3 sink",
                       f"{mq_records} records of {SYNC_MQ_RECORD} bytes on one topic of "
                       f"{SYNC_MQ_PARTITIONS} partitions", "one process: the filer phase's "
                       "master, 3 volume servers and filer, a second filer, the S3 gateway, "
                       "the broker and the mount over loopback"],
           "lost": sorted(lost)}

    def predict(fids) -> int:  # one (1, 10) launch per lost shard a needle touches
        return sum(len(shards.get(f, set()) & lost) for f in fids)

    def under(d: str) -> list:
        return sorted(p for p in sizes if p.startswith(f"/{coll}/{d}/"))

    def is_degraded(path: str) -> bool:
        return path in chunks_of and predict(chunks_of[path]) > 0

    def counted(what: str, fids, fn):
        """fn() with the decoded-interval cache cleared -> (its value, seconds,
        the launches by shape and the .ecx prediction, which they must equal)."""
        read_planner.CACHE.clear()
        shape0 = dict(rs_cuda.launches_by_shape)
        t = time.perf_counter()
        value = fn()
        seconds = time.perf_counter() - t
        launched = _shape_launches(shape0)
        pred = predict(fids)
        check(launched == ({(1, 10): pred} if on_card and pred else {}),
              f"{what} launched {launched}, predicted (1, 10) x {pred}")
        return value, seconds, {"launches_by_shape": _shape_keys(launched),
                                "predicted_1x10": pred}

    def shell(script: str, filer=None) -> str:
        env = CommandEnv(master.address, device=device)
        envs.append(env)
        if filer is not None:  # the fs.* commands on this filer, not the first one listed
            env._filer_client, env._filer_http = FilerClient(filer.grpc_address), filer.url
        buf = io.StringIO()
        for cmd in script.split(";"):
            run_command(env, cmd.strip(), buf)
        return buf.getvalue()

    def connection(port: int):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conns.append(c)
        return c

    def cli_out(argv: list) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(argv)
        check(rc == 0, f"{argv[0]} exited {rc}: {buf.getvalue()[-300:]}")
        return buf.getvalue()

    def sha_of(conn, path: str) -> str:
        status, body = _filer_get(conn, path)
        check(status == 200, f"GET {path}: {status}")
        return hashlib.sha256(body).hexdigest()

    try:
        os.makedirs(root)
        _put_env({"WEEDTPU_HEDGE_READS": "off", "WEEDTPU_READ_CACHE_MB": "0"})
        for c in (SYNC_REPLICA, SYNC_BUCKET):
            grown = master._rpc_volume_grow({"collection": c, "count": SYNC_VOLUMES}, None)
            check(grown["grown"] == SYNC_VOLUMES, f"volume grow {c}: {grown}")

        # 1: filer.sync: a second filer on the same master (its own log
        # store, /replica/ routed to a plain collection by fs.configure); a
        # Replicator with a FilerSink (-targetPath /replica) over one
        # top-level directory until it has applied every event there
        meta2 = os.path.join(root, "replica_meta")
        os.makedirs(meta2)
        fs2 = FilerServer(master.address, store=make_store("log", meta2), log_dir=meta2)
        fs2.start()
        started.append(fs2)
        rule = shell(f"fs.configure -locationPrefix /{SYNC_REPLICA}/ -collection {SYNC_REPLICA} "
                     "-apply", filer=fs2)
        src = f"/{coll}/{SYNC_DIRS[0]}"
        with FilerClient(fs.grpc_address) as fc:
            history = list(fc.subscribe(since_ns=0, path_prefix=src, max_idle_s=0.5))
        synced = under(SYNC_DIRS[0])
        sink_id = f"filer.{fs2.url}"
        applied, failed = [], []

        def sync_until(n_events: int, what: str) -> float:
            """A Replicator.run (the filer.sync loop) from the checkpoint until
            `applied` holds n_events, then stopped -> its wall seconds."""
            rep = Replicator(fs.grpc_address, FilerSink(fs2.url, target_root=f"/{SYNC_REPLICA}"),
                             prefix=src, sink_id=sink_id)
            apply = rep.apply

            def counting(ev):
                try:
                    apply(ev)
                except Exception as e:  # noqa: BLE001 — the run loop would retry it
                    failed.append(repr(e))
                    raise
                applied.append(ev)

            rep.apply = counting
            stop = threading.Event()
            t = threading.Thread(target=rep.run, args=(stop,), kwargs={"max_idle_s": 0.5})
            t0 = time.perf_counter()
            t.start()
            try:
                _cluster_wait(lambda: len(applied) >= n_events or failed, what, timeout=900)
                took = time.perf_counter() - t0
            finally:
                stop.set()
                t.join()
                rep.close()
            check(not failed and len(applied) == n_events,
                  f"{what}: {len(applied)} of {n_events} applied, {failed[:3]}")
            return took

        with _timed_file_reads(FilerClient) as reads:
            took, _, launched = counted("filer.sync", [f for p in synced for f in chunks_of[p]],
                                        lambda: sync_until(len(history), "filer.sync"))
        c2 = connection(fs2.port)
        target = {e.path[len(SYNC_REPLICA) + 2:]: e.size for e in fs2.filer.walk(f"/{SYNC_REPLICA}")
                  if not e.is_directory}
        check(target == {p[len(src) + 1:]: sizes[p] for p in synced},
              f"the replica holds {len(target)} files, the source {len(synced)}")
        for p in synced:
            check(sha_of(c2, f"/{SYNC_REPLICA}/{p[len(src) + 1:]}") == digest[p],
                  f"{p} differs in the replica")
        n_bytes = sum(sizes[p] for p in synced)
        with FilerClient(fs.grpc_address) as fc:
            checkpoint = int(fc.kv_get(f"replication.offset.{sink_id}").decode())
        check(checkpoint == history[-1].ts_ns, "the checkpoint is not the last event")
        out["sync"] = {"prefix": src, "target": f"/{SYNC_REPLICA}", "rule": rule.strip(),
                       "events": len(history), "files": len(synced), "bytes": n_bytes,
                       "seconds": took, "files_per_s": len(synced) / took,
                       "mb_per_s": n_bytes / took / 1e6,
                       "reads": _read_classes(reads, is_degraded), **launched}

        # then seeded overwrites, renames and deletes on the source, and the
        # sync started again from its checkpoint: exactly those events apply
        picks = [synced[int(i)] for i in rng.permutation(len(synced))[:sum(SYNC_MUTATIONS)]]
        n_over, n_ren = min(SYNC_MUTATIONS[0], len(picks)), SYNC_MUTATIONS[1]
        expect = []
        for i, p in enumerate(picks[:n_over]):
            ds = seed * 100_000 + 60_000 + i
            data = _filer_data(ds, int(rng.integers(4 << 10, 1 << 20)))
            _filer_put(local, fs.url, p, data)
            digest[p], sizes[p], seed_of[p] = hashlib.sha256(data).hexdigest(), len(data), ds
            chunks_of[p] = [c.fid for c in fs.filer.find_entry(p).chunks]
            expect.append((p, p))
        renamed = []
        for p in picks[n_over:n_over + n_ren]:
            q = p.rsplit("/", 1)[0] + "/renamed-" + p.rsplit("/", 1)[1]
            fs.filer.rename(p, q)
            for d in (digest, sizes, seed_of, chunks_of):
                d[q] = d.pop(p)
            renamed.append(q)
            expect.append((p, q))
        for p in picks[n_over + n_ren:]:
            fs.filer.delete_entry(p)
            for d in (digest, sizes, seed_of, chunks_of):
                d.pop(p)
            expect.append((p, None))
        before = len(applied)
        with _timed_file_reads(FilerClient) as reads:
            took, _, launched = counted(
                "the resumed filer.sync", [f for p in renamed for f in chunks_of[p]],
                lambda: sync_until(before + len(expect), "the resumed filer.sync"))
        resumed = applied[before:]
        def in_order(pairs) -> list:
            return sorted(pairs, key=lambda e: (e[0] or "", e[1] or ""))

        got = in_order(((ev.old_entry or {}).get("path"), (ev.new_entry or {}).get("path"))
                       for ev in resumed)
        check(got == in_order(expect) and all(
            ev.ts_ns > checkpoint for ev in resumed), f"the resumed sync applied {got[:4]} ...")
        synced = under(SYNC_DIRS[0])
        target = {e.path[len(SYNC_REPLICA) + 2:]: e.size for e in fs2.filer.walk(f"/{SYNC_REPLICA}")
                  if not e.is_directory}
        check(target == {p[len(src) + 1:]: sizes[p] for p in synced},
              "the replica differs from the source after the resumed sync")
        for p in picks[:n_over] + renamed:
            check(sha_of(c2, f"/{SYNC_REPLICA}/{p[len(src) + 1:]}") == digest[p],
                  f"{p} differs in the replica after the resumed sync")
        out["sync"]["resumed"] = {"mutations": {"overwrites": n_over, "renames": len(renamed),
                                                "deletes": len(expect) - n_over - len(renamed)},
                                  "events": len(resumed), "seconds": took,
                                  "reads": _read_classes(reads, is_degraded), **launched}

        # 2: filer.backup of a second directory into a local one (the
        # command's own entry point), byte-equal; then an S3Sink of a third
        # directory into a bucket of the port's S3 gateway, each object's
        # md5 its file's
        bdir, src = os.path.join(root, "backup"), f"/{coll}/{SYNC_DIRS[1]}"
        backed = under(SYNC_DIRS[1])
        with _timed_file_reads(FilerClient) as reads:
            said, took, launched = counted(
                "filer.backup", [f for p in backed for f in chunks_of[p]],
                lambda: cli_out(["filer.backup", "-filerGrpc", fs.grpc_address, "-dir", bdir,
                                 "-prefix", src]))
        local_tree = {}
        for d, _, names in os.walk(bdir):
            for name in names:
                local_tree[os.path.relpath(os.path.join(d, name), bdir)] = sha256_file(
                    os.path.join(d, name))
        check(local_tree == {p[len(src) + 1:]: digest[p] for p in backed},
              f"the backup holds {len(local_tree)} files, the source {len(backed)}")
        n_bytes = sum(sizes[p] for p in backed)
        out["backup"] = {"prefix": src, "said": said.strip(), "files": len(backed),
                         "bytes": n_bytes, "seconds": took, "files_per_s": len(backed) / took,
                         "mb_per_s": n_bytes / took / 1e6,
                         "reads": _read_classes(reads, is_degraded), **launched}

        creds = ("syncer", rng.bytes(15).hex())
        s3 = S3ApiServer(fs.url, fs.grpc_address, iam=Iam([Identity("syncer", *creds)]))
        s3.start()
        started.append(s3)
        sconn = connection(s3.port)
        status, _, body = _s3_request(sconn, s3.url, creds, "PUT", f"/{SYNC_BUCKET}")
        check(status == 200, f"CreateBucket {SYNC_BUCKET}: {status} {body[:200]!r}")
        src = f"/{coll}/{SYNC_DIRS[2]}"
        objects = under(SYNC_DIRS[2])
        rep = Replicator(fs.grpc_address, S3Sink(s3.url, SYNC_BUCKET, *creds), prefix=src,
                         sink_id=f"s3.{SYNC_BUCKET}")
        try:
            with _timed_file_reads(FilerClient) as reads:
                n_events, took, launched = counted(
                    "the S3 sink", [f for p in objects for f in chunks_of[p]],
                    lambda: rep.run_once(max_idle_s=0.5))
        finally:
            rep.close()
        for p in objects:
            status, h, body = _s3_request(sconn, s3.url, creds, "GET",
                                          f"/{SYNC_BUCKET}/{p[len(src) + 1:]}")
            check(status == 200 and h.get("etag") == f'"{hashlib.md5(body).hexdigest()}"'
                  and hashlib.sha256(body).hexdigest() == digest[p], f"object of {p}")
        in_bucket = [e for e in fs.filer.walk(f"/buckets/{SYNC_BUCKET}") if not e.is_directory]
        check(len(in_bucket) == len(objects), f"{len(in_bucket)} objects for {len(objects)} files")
        n_bytes = sum(sizes[p] for p in objects)
        out["s3_sink"] = {"prefix": src, "bucket": SYNC_BUCKET, "events": n_events,
                          "objects": len(objects), "bytes": n_bytes, "seconds": took,
                          "files_per_s": len(objects) / took, "mb_per_s": n_bytes / took / 1e6,
                          "reads": _read_classes(reads, is_degraded), **launched}

        # 3: filer.copy of a seeded local tree, read back byte-equal; then
        # filer.meta.tail over the phase's events: one JSON line per event
        csrc = os.path.join(root, "copysrc")
        copied = {}
        for i in range(SYNC_COPY_FILES):
            rel = f"c{i % 4}/f{i:02d}.bin"
            os.makedirs(os.path.join(csrc, f"c{i % 4}"), exist_ok=True)
            data = _filer_data(seed * 100_000 + 65_000 + i, int(rng.integers(1 << 10, 256 << 10)))
            with open(os.path.join(csrc, rel), "wb") as f:
                f.write(data)
            copied[rel] = data
        said, took, launched = counted("filer.copy", [], lambda: cli_out(
            ["filer.copy", "-filer", fs.url, csrc, "/copied/"]))
        check(f"{SYNC_COPY_FILES} copied, 0 failed" in said, f"filer.copy: {said[-300:]}")
        conn = connection(fs.port)
        for rel, data in copied.items():
            check(_filer_get(conn, f"/copied/copysrc/{rel}") == (200, data), f"copied {rel}")
        out["copy"] = {"files": SYNC_COPY_FILES, "bytes": sum(map(len, copied.values())),
                       "seconds": took, "said": said.strip().splitlines()[-1], **launched}
        tail = cli_out(["filer.meta.tail", "-filerGrpc", fs.grpc_address, "-sinceNs",
                        str(phase_ns), "-maxIdleSeconds", "0.5"]).splitlines()
        with FilerClient(fs.grpc_address) as fc:
            events = list(fc.subscribe(since_ns=phase_ns, path_prefix="/", max_idle_s=0.5))
        check(len(tail) == len(events) and [json.loads(line)["ts_ns"] for line in tail]
              == [ev.ts_ns for ev in events], f"filer.meta.tail printed {len(tail)} lines "
              f"for {len(events)} events")
        out["meta_tail"] = {"lines": len(tail), "events": len(events)}

        # 4: a mount (WFS, its chunk cache off): degraded files read whole
        # and seeded 64 KiB ranges, byte-equal; then a file written by
        # seeded random writes with auto-flush, truncated, renamed, read back
        w = WFS(fs.grpc_address, chunk_cache_bytes=0)
        mounts.append(w)
        order = sorted(sizes)
        order = [order[int(i)] for i in rng.permutation(len(order))]
        whole = [p for p in order if is_degraded(p)][:mount_files]
        check(len(whole) == mount_files, f"only {len(whole)} degraded files")
        ms_whole = []

        def read_whole():
            for p in whole:
                t1 = time.perf_counter()
                fh = w.open(p)
                data = fh.read(0, fh.size)
                fh.release()
                ms_whole.append((p, (time.perf_counter() - t1) * 1e3))
                check(len(data) == sizes[p] and hashlib.sha256(data).hexdigest() == digest[p],
                      f"the mount's read of {p}")

        _, took_whole, launched_whole = counted(
            "the mount's whole reads", [f for p in whole for f in chunks_of[p]], read_whole)
        big = [p for p in order if sizes[p] > SYNC_MOUNT_RANGE]
        picks = [(big[int(i)], 0) for i in rng.integers(0, len(big), mount_ranges)]
        picks = [(p, int(rng.integers(0, sizes[p] - SYNC_MOUNT_RANGE + 1))) for p, _ in picks]
        range_fids, ms_ranges = [], []
        for p, lo in picks:
            c0, c1 = lo // (4 << 20), (lo + SYNC_MOUNT_RANGE - 1) // (4 << 20)
            range_fids += chunks_of[p][c0: c1 + 1]

        def read_ranges():
            for p, lo in picks:
                t1 = time.perf_counter()
                fh = w.open(p)
                data = fh.read(lo, SYNC_MOUNT_RANGE)
                fh.release()
                ms_ranges.append((p, (time.perf_counter() - t1) * 1e3))
                want = _filer_data(seed_of[p], sizes[p])[lo: lo + SYNC_MOUNT_RANGE]
                check(data == want, f"the mount's range {lo} of {p}")

        _, took_ranges, launched_ranges = counted("the mount's ranges", range_fids, read_ranges)

        def write_back() -> dict:
            model = bytearray(mount_bytes)
            piece = 1 << 20
            fh = w.create("/mnt/big.bin")
            for i in rng.permutation(mount_bytes // piece):
                data = rng.bytes(piece)
                fh.write(int(i) * piece, data)
                model[int(i) * piece: (int(i) + 1) * piece] = data
            for _ in range(64):
                off = int(rng.integers(0, mount_bytes - 1))
                data = rng.bytes(min(int(rng.integers(1, 256 << 10)), mount_bytes - off))
                fh.write(off, data)
                model[off: off + len(data)] = data
            fh.flush()
            cut = int(rng.integers(mount_bytes // 2, mount_bytes))
            fh.truncate(cut)
            fh.flush()
            fh.release()
            w.rename("/mnt/big.bin", "/mnt/big-renamed.bin")
            check(w.getattr("/mnt/big.bin") is None, "the renamed file is still there")
            check(w.getattr("/mnt/big-renamed.bin").size == cut, "the truncated size")
            fh = w.open("/mnt/big-renamed.bin")
            data = fh.read(0, fh.size)
            fh.release()
            check(data == bytes(model[:cut]), "the mount's written file reads back differently")
            chunks = len(fs.filer.find_entry("/mnt/big-renamed.bin").chunks)
            return {"bytes": mount_bytes, "truncated_to": cut, "chunks": chunks}

        written, took_write, launched_write = counted("the mount's write", [], write_back)
        out["mount"] = {
            "whole": {"files": len(whole), "seconds": took_whole, **_read_classes(
                ms_whole, is_degraded)["degraded"], **launched_whole},
            "ranges": {"reads": len(picks), "bytes": SYNC_MOUNT_RANGE, "seconds": took_ranges,
                       "by_class": _read_classes(ms_ranges, is_degraded), **launched_ranges},
            "write": {**written, "seconds": took_write, "auto_flush_bytes": w.auto_flush_bytes,
                      **launched_write}}

        # 5: mq: /topics/ routed to a collection of its own, the mq.broker
        # command's Broker, a topic of 4 partitions; seeded 1 KiB records
        # from 4 publishers, flushed; the collection EC-encoded with shards 0
        # and 5 lost; the broker restarted; a consumer group of two reads
        # every record from the start and commits
        rule = shell(f"fs.configure -locationPrefix /topics/ -collection {SYNC_MQ_COLLECTION} "
                     "-apply", filer=fs)
        grown = master._rpc_volume_grow({"collection": SYNC_MQ_COLLECTION, "count": 1}, None)
        check(grown["grown"] == 1, f"volume grow {SYNC_MQ_COLLECTION}: {grown}")
        broker = Broker(fs.url, fs.grpc_address)
        broker.start()
        started.append(broker)
        _cluster_wait(lambda: any(b["grpc_address"] == broker.address for b in
                                  master._rpc_list_cluster_nodes({}, None)["brokers"]),
                      "the broker to announce itself")
        brokers = shell("mq.broker.list")
        made = shell(f"mq.topic.configure -topic {SYNC_MQ_TOPIC} -partitions {SYNC_MQ_PARTITIONS}")
        check(f"default/{SYNC_MQ_TOPIC} -> {SYNC_MQ_PARTITIONS} partitions" in made,
              f"mq.topic.configure: {made}")
        keys = [rng.bytes(16) for _ in range(mq_records)]
        values = [rng.bytes(SYNC_MQ_RECORD) for _ in range(mq_records)]

        def publish(t: int) -> list:
            with BrokerClient(broker.address) as c:
                return [(i, c.publish(SYNC_MQ_TOPIC, keys[i], values[i]))
                        for i in range(t, mq_records, SYNC_MQ_PUBLISHERS)]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(SYNC_MQ_PUBLISHERS) as pool:
            placed = {i: (r["partition"], r["ts_ns"]) for part in pool.map(
                publish, range(SYNC_MQ_PUBLISHERS)) for i, r in part}
        publish_s = time.perf_counter() - t0
        check(all(placed[i][0] == int.from_bytes(hashlib.md5(keys[i]).digest()[:4], "big")
                  % SYNC_MQ_PARTITIONS for i in placed), "a record off its key's partition")
        t0 = time.perf_counter()
        broker.stop()  # the live tails flush to segments on the filer
        started.remove(broker)
        flush_s = time.perf_counter() - t0
        segments = {}
        for part in range(SYNC_MQ_PARTITIONS):
            for e in fs.filer.list_entries(f"/topics/default/{SYNC_MQ_TOPIC}/{part:04d}"):
                check(e.name.endswith(".seg") and e.attributes.collection == SYNC_MQ_COLLECTION,
                      f"segment {e.path} in collection {e.attributes.collection!r}")
                segments[e.path] = [c.fid for c in e.chunks]
        vids = {v for n in master.topology.nodes.values()
                for v, vi in n.volumes.items() if vi.collection == SYNC_MQ_COLLECTION}
        check({int(f.split(",")[0]) for cs in segments.values() for f in cs} == vids,
              f"the segments lie outside the collection's volumes {sorted(vids)}")
        t0 = time.perf_counter()
        text = shell(f"lock; ec.encode -collection {SYNC_MQ_COLLECTION} -force; unlock")
        enc_s = time.perf_counter() - t0
        check(all(f"ec.encode volume {v}" in text for v in vids), f"ec.encode: {text}")
        _cluster_wait(lambda: all(len(master.topology.lookup_ec_shards(v)) == 14 for v in vids)
                      and not any(master.topology.lookup(v, SYNC_MQ_COLLECTION) for v in vids),
                      "every volume of the topics' collection EC-encoded")
        for vid in vids:
            for vs in servers:
                ev = vs.store.get_ec_volume(vid)
                mine = [sh for sh in sorted(lost) if ev is not None and sh in ev.shard_ids]
                if mine:
                    with rpc.RpcClient(vs.grpc_address) as c:
                        c.call(VOLUME_SERVICE, "VolumeEcShardsDelete",
                               {"volume_id": vid, "collection": SYNC_MQ_COLLECTION,
                                "shard_ids": mine}, timeout=600)
        _cluster_wait(lambda: all(len([sh for sh, ns in master.topology.lookup_ec_shards(v).items()
                                       if ns]) == 12 for v in vids),
                      "the master to list 12 shards of every topics volume")
        for vs in servers:  # the mounts' warm-up launches, before the reads count theirs
            for vid in vids:
                ev = vs.store.get_ec_volume(vid)
                if ev is not None and ev.warm_thread is not None:
                    ev.warm_thread.join()
        shards.update(_filer_chunk_shards(servers, vids, segments, SYNC_MQ_COLLECTION))
        broker = Broker(fs.url, fs.grpc_address)
        broker.start()
        started.append(broker)
        group = "readers"
        with BrokerClient(broker.address) as c:
            for cid in ("c0", "c1"):  # both members before either reads: one split
                joined = c.join_group(SYNC_MQ_TOPIC, group, cid)
        check(len(joined["partitions"]) == SYNC_MQ_PARTITIONS // 2, f"the split: {joined}")

        def consume(cid: str) -> list:
            got = []
            with BrokerClient(broker.address) as c:
                for part, rec in c.consume(SYNC_MQ_TOPIC, group, cid, max_rounds=1,
                                           commit_every=SYNC_MQ_COMMIT_EVERY):
                    got.append((part, rec.ts_ns, rec.key, rec.value))
            return got

        def consume_all() -> list:
            with ThreadPoolExecutor(2) as pool:
                return list(pool.map(consume, ("c0", "c1")))

        with _timed_file_reads(FilerClient) as reads:
            got, consume_s, launched = counted(
                "the consumer group", [f for cs in segments.values() for f in cs], consume_all)
        received = [r for part in got for r in part]
        check(sorted((k, v) for _, _, k, v in received) == sorted(zip(keys, values)),
              f"{len(received)} records received for {mq_records} published")
        last = {}
        for part, ts, _, _ in received:
            check(ts > last.get(part, 0), f"partition {part} out of ts_ns order")
            last[part] = ts
        by_part = {}
        for part, ts in placed.values():
            by_part[part] = max(by_part.get(part, 0), ts)
        index = {k: i for i, k in enumerate(keys)}
        check(len(index) == mq_records and all(
            placed[index[k]] == (part, ts) for part, ts, k, _ in received),
            "a record came back off the partition or stamp it was published with")
        with BrokerClient(broker.address) as c:
            committed = {p: c.fetch_offset(SYNC_MQ_TOPIC, group, p)
                         for p in range(SYNC_MQ_PARTITIONS)}
        check(committed == by_part, f"committed {committed}, last {by_part}")
        check(not on_card or launched["predicted_1x10"] > 0, "no segment read was degraded")
        out["mq"] = {"rule": rule.strip(), "brokers": brokers.strip().splitlines()[-1],
                     "records": mq_records, "record_bytes": SYNC_MQ_RECORD,
                     "partitions": SYNC_MQ_PARTITIONS, "publishers": SYNC_MQ_PUBLISHERS,
                     "publish_s": publish_s, "publish_per_s": mq_records / publish_s,
                     "flush_s": flush_s, "segments": len(segments),
                     "segment_bytes": sum(fs.filer.find_entry(p).size for p in segments),
                     "encode_s": enc_s, "volumes": len(vids), "consumers": 2,
                     "consume_s": consume_s, "consume_per_s": mq_records / consume_s,
                     "per_partition": {str(p): sum(1 for q, *_ in received if q == p)
                                       for p in range(SYNC_MQ_PARTITIONS)},
                     "segment_reads": _read_classes(reads, lambda p: any(
                         shards.get(f, set()) & lost for f in segments.get(p, ()))),
                     **launched}
    finally:
        _put_env(saved)
        fs.chunk_io.cache = chunk_cache
        c = getattr(local, "c", None)
        if c is not None:
            c.close()
        for c in conns:
            c.close()
        for w in mounts:
            w.close()
        for env in envs:
            env.close()
        for srv in reversed(started):
            srv.stop()
    out["seconds"] = time.perf_counter() - t_phase
    by_shape = dict(rs_cuda.launches_by_shape)
    out["launches_by_shape"] = _shape_keys(by_shape)
    out["launches"] = dict(rs_cuda.launches_by_variant)
    out["busy"] = _busy(by_shape, kernel_ms, out["seconds"])
    check(all(c == 10 for _, c in by_shape) and (by_shape.get((1, 10), 0) > 0 if on_card
                                                  else not by_shape),
          f"the sync path launched {by_shape}")
    return out


#: the shell and fleet phases' deployment (the SeaweedFS wiki's "Erasure
#: Coding for warm storage": 10+4, volumes sealed once full, ec.encode
#: -fullPercent=95, rack-aware spread, ec.rebuild/ec.balance under the lock)
BENCH_WINDOW_BUDGET = 300  # under the 600 s the sweep needs: the sweep phase runs it
BENCH_REMOTE_MIB = 8  # the window's remote rebuild, cut from 48 MiB for the call's time


def _bench_mode(modes: dict, name: str, fn):
    """Run one bench mode, keeping its report's ok, its seconds and its
    launches by kernel under `modes[name]`."""
    from seaweedfs_tpu_torch.ops import rs_cuda

    before = dict(rs_cuda.launches_by_variant)
    t0 = time.perf_counter()
    rep = fn()
    modes[name] = {"ok": rep.get("ok"), "seconds": time.perf_counter() - t0,
                   "launches": {k: v - before.get(k, 0)
                                for k, v in rs_cuda.launches_by_variant.items()
                                if v > before.get(k, 0)}}
    return rep


def run_bench(scratch: str, card: str, device: str = "cuda") -> dict:
    """The bench phase (see the module doc): the harness's smoke modes, the
    device mode and the device window on `device`, each report checked."""
    from seaweedfs_tpu_torch import bench
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda
    from seaweedfs_tpu_torch.scripts import device_window

    on_card = device == "cuda"
    os.makedirs(scratch, exist_ok=True)
    before = dict(rs_cuda.launches_by_variant)
    t_phase = time.perf_counter()
    modes: dict = {}

    def sub(name: str) -> str:
        path = os.path.join(scratch, name)
        os.makedirs(path, exist_ok=True)
        return path

    if on_card:
        probe = _bench_mode(modes, "probe", lambda: bench._run_child("probe", timeout=120)[0] or {})
        check(probe.get("ok") and probe.get("count") == torch.cuda.device_count(),
              f"bench probe: {probe}")
    xor = _bench_mode(modes, "xor", lambda: bench.mode_xor(device, smoke=True))
    check(xor["ok"] and xor["match"] and xor["device_match"] and all(xor["verify"].values())
          and all(xor["device_verify"].values()) and "when" not in xor
          and xor["cache"]["size"] == 4, f"bench xor: {xor}")
    rb = _bench_mode(modes, "rebuild_batch", lambda: bench.mode_rebuild_batch(device, smoke=True))
    check(rb["ok"] and "when" not in rb and rb["fused"]["dispatch_groups"] == 1
          and rb["unfused"]["dispatch_groups"] == rb["storm"]["signatures"] > 1
          and rb["homogeneous_fused"]["dispatch_groups"] == 1
          and rb["homogeneous_unfused"]["dispatch_groups"] == 1
          and rb["verify"]["fused_bytes_match"] and rb["verify"]["unfused_bytes_match"]
          and rb["rebuilt_bytes"] > 0, f"bench rebuild_batch: {rb}")
    rr = _bench_mode(modes, "rebuild_remote", lambda: bench._measure_rebuild_remote(
        sub("rebuild_remote"), **bench.SMOKE_REMOTE, device=device))
    check(rr["ok"] and rr["match"] and rr["rebuilt_shard_ids"] == [10, 11, 12, 13]
          and rr["remote_survivors"] == list(range(10))
          and all(isinstance(rr.get(k), float) for k in (
              "remote_rebuild_gbps", "local_rebuild_gbps", "overlap_efficiency",
              "pipelined_vs_serial_fetch_then_decode")), f"bench rebuild_remote: {rr}")
    rt = _bench_mode(modes, "rebuild_trace", lambda: bench._measure_rebuild_trace(
        sub("rebuild_trace"), **bench.SMOKE_REMOTE, device=device))
    check(rt["ok"] and rt["trace"]["match"] and rt["slab"]["match"]
          and rt["trace"]["mode_reported"] == "trace" and rt["wire_ratio"] <= 0.6
          and rt["trace"]["wire_bytes"] == 2 * rt["slab"]["wire_bytes"] // 10
          and rt["trace"]["rebuilt_sha256"] == rt["slab"]["rebuilt_sha256"],
          f"bench rebuild_trace: {rt}")
    ing = _bench_mode(modes, "ingest", lambda: bench._measure_ingest(
        sub("ingest"), **bench.SMOKE_INGEST, device=device))
    check(ing["ok"] and ing["match"] and ing["delta"]["match"]
          and ing["inline"]["rows_inline"] == ing["inline"]["rows_total"] > 0
          and ing["delta"]["bytes_ratio"] < 0.5 and ing["delta"]["overwrite_fraction"] <= 0.011,
          f"bench ingest: {ing}")
    cv = _bench_mode(modes, "convert", lambda: bench._measure_convert(
        sub("convert"), **bench.SMOKE_CONVERT, device=device))
    check(cv["ok"] and all(p["match"] and p["moved_over_reencode"] <= 0.5
                           and p["oracle_total_measured"] == p["oracle_total_bytes"]
                           for p in cv["pairs"].values()) and len(cv["pairs"]) == 2,
          f"bench convert: {cv}")
    # --smoke: one (10, 4 MiB) batch, not the reference's eight
    dv = _bench_mode(modes, "device", lambda: bench.mode_device(
        device, smoke=True, trace_dir=sub("trace")))
    check(dv["ok"], f"bench device: {dv}")
    win_dir = sub("window")
    with open(os.path.join(scratch, "window.log"), "w") as sink, \
            contextlib.redirect_stdout(sink):
        win = _bench_mode(modes, "window", lambda: device_window.window(
            win_dir, budget=BENCH_WINDOW_BUDGET, device=device, remote_mib=BENCH_REMOTE_MIB))
    check(win["ok"] and win["stages"]["sweep"] == "skipped: budget"
          and isinstance(win["stages"]["e2e"], dict) and isinstance(win["stages"]["remote"], dict),
          f"bench window: {win}")
    check(set(win["files"]) <= {"GPU_MEASUREMENT_r00.json", "E2E_DEVICE.json",
                                "REMOTE_REBUILD.json", "device_window.log",
                                "GPU_MULTICHIP_r00.json"},
          f"bench window wrote {win['files']}")
    _variant, decision = rs_codec.pick_device_backend(art_dir=win_dir)
    check(decision.get("evidence_file") == "GPU_MEASUREMENT_r00.json",
          f"bench window: the factory read {decision}")
    launches = {k: v - before.get(k, 0) for k, v in rs_cuda.launches_by_variant.items()
                if v > before.get(k, 0)}
    if on_card:
        check(all(launches.get(v) for v in KERNELS), f"bench: launches {launches}")
    e2e, remote = win["stages"]["e2e"], win["stages"]["remote"]
    return {
        "phase": "bench", "card": card, "seconds": time.perf_counter() - t_phase,
        "modes": modes, "launches": launches,
        "xor": {"verify": xor["verify"], "device_verify": xor["device_verify"],
                "compile": xor["compile"], "native_level": xor["native_level"]},
        "rebuild_batch": {k: rb[k] for k in ("storm", "fused", "unfused", "verify",
                                             "rebuilt_bytes")},
        "rebuild_remote": {k: rr.get(k) for k in (
            "n_batches", "local_rebuild_gbps", "remote_rebuild_gbps", "overlap_efficiency",
            "pipelined_vs_serial_fetch_then_decode", "serial_fetch_then_decode_s",
            "remote_rebuild_wall_s", "match")},
        "rebuild_trace": {"wire_ratio": rt["wire_ratio"], "wall_ratio": rt["wall_ratio"],
                          **{m: {k: rt[m][k] for k in ("wall_s", "wire_bytes", "match")}
                             for m in ("trace", "slab")}},
        "ingest": {"amortized_over_warm": ing["amortized_over_warm"], "warm": ing["warm"],
                   "inline": ing["inline"], "delta_bytes_ratio": ing["delta"]["bytes_ratio"]},
        "convert": {f: {k: p[k] for k in ("convert_s", "oracle_s", "moved_over_reencode", "match")}
                    for f, p in cv["pairs"].items()},
        "device": {"shape": dv["shape"], "kernels": dv["kernels"],
                   **{k: dv.get(k) for k in ("compile_check_secs", "best_gbps", "best_backend",
                                             "rebuild_torch_steady_gbps",
                                             "rebuild_cuda_steady_gbps", "trace")}},
        "window": {"seconds": win["seconds"], "measure": win["stages"]["measure"],
                   "e2e": {k: e2e.get(k) for k in (
                       "e2e_seconds", "e2e_gbps", "rebuild_e2e_seconds", "rebuild_e2e_gbps",
                       "rebuild_e2e_depth1_seconds", "rebuild_match")},
                   "remote": {k: remote.get(k) for k in (
                       "remote_rebuild_gbps", "local_rebuild_gbps", "overlap_efficiency",
                       "pipelined_vs_serial_fetch_then_decode", "rpc_delay_ms", "match")},
                   "launches_stage1": win["launches_stage1"], "files": win["files"],
                   "decision": {k: decision.get(k) for k in ("variant", "tile", "reason")}},
    }


STORM_VOLUMES = 8
STORM_NEEDLE = 1 << 20
STORM_NEEDLES = 255  # per volume: 255 needles of 1 MiB fill a 256 MiB volume
STORM_RACKS = ("r0", "r1", "r2", "r3", "r4")
STORM_SAMPLE = 512
STORM_COLLECTION = "storm"


def _storm_write(root: str, seed: int, needle_bytes: int) -> dict:
    """The storm's volumes, written with the port's storage engine straight
    into the servers' directories (volume v on server (v - 1) % 5), and a
    seeded sample of STORM_SAMPLE needles across them with their bytes."""
    from seaweedfs_tpu_torch.storage import needle, volume

    rng = np.random.default_rng(seed + 1400)
    flat = rng.choice(STORM_VOLUMES * STORM_NEEDLES, STORM_SAMPLE, replace=False)
    picked = {(int(i) // STORM_NEEDLES + 1, int(i) % STORM_NEEDLES + 1) for i in flat}
    sample, bases = {}, {}
    t0 = time.perf_counter()
    for vid in range(1, STORM_VOLUMES + 1):
        d = os.path.join(root, f"srv{(vid - 1) % len(STORM_RACKS)}")
        os.makedirs(d, exist_ok=True)
        vrng = np.random.default_rng(seed + 1400 + vid)
        data = vrng.bytes(STORM_NEEDLES * needle_bytes)
        cookies = vrng.integers(0, 1 << 32, STORM_NEEDLES, dtype=np.uint64).tolist()
        v = volume.Volume(d, vid, collection=STORM_COLLECTION)
        for i in range(STORM_NEEDLES):
            body = data[i * needle_bytes: (i + 1) * needle_bytes]
            v.write_needle(needle.Needle(cookie=int(cookies[i]), id=i + 1, data=body))
            if (vid, i + 1) in picked:
                sample[(vid, i + 1)] = (int(cookies[i]), body)
        bases[vid] = v.base_path
        v.close()
    return {"sample": sample, "bases": bases, "write_s": time.perf_counter() - t0}


def _storm_oracle(root: str, bases: dict, enc) -> dict:
    """{vid: sha256 of the .dat, the .ecx and each shard} of a local
    `write_ec_files` of each volume's .dat (hard-linked aside, one volume at
    a time, on `enc`), and the launches by (R, C) of those encodes."""
    from concurrent import futures

    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops import rs_cuda

    d = os.path.join(root, "oracle")
    os.makedirs(d)
    out = {}
    shape0 = dict(rs_cuda.launches_by_shape)
    with futures.ThreadPoolExecutor(8) as pool:
        for vid, base in sorted(bases.items()):
            ob = os.path.join(d, os.path.basename(base))
            for ext in (".dat", ".idx"):
                os.link(base + ext, ob + ext)
            stripe.write_ec_files(ob, encoder=enc)
            stripe.write_sorted_file_from_idx(ob)
            paths = [ob + ".dat", ob + ".ecx"] + [stripe.shard_file_name(ob, s)
                                                  for s in range(14)]
            shas = list(pool.map(sha256_file, paths))
            out[vid] = {"dat": shas[0], "ecx": shas[1], "shards": dict(enumerate(shas[2:])),
                        "shard_bytes": os.path.getsize(paths[2])}
            for name in os.listdir(d):
                os.remove(os.path.join(d, name))
    os.rmdir(d)
    return out, _shape_launches(shape0)


def _fused_prediction(batches: list, missing_of: dict, shard_bytes: dict, align: int) -> dict:
    """{(R, C): launches} the scheduler's batches make on their targets, as
    `stripe._rebuild_fused` packs them: each batch's volumes in block order
    (signature groups in first-seen order) fill staging spans of one 4 MiB
    chunk per row (64 MiB // (10 x 4 MiB) chunks), and each run of one
    signature's columns in a span is one (len(missing), 10) launch."""
    span = -(-max(1, (64 << 20) // (10 * (4 << 20))) * (4 << 20) // align) * align
    want: dict = {}
    for b in batches:
        sigs: list = []
        for v in b["block_order"]:
            if missing_of[v] not in sigs:
                sigs.append(missing_of[v])
        order = sorted(b["block_order"], key=lambda v: sigs.index(missing_of[v]))
        room, last = span, None
        for v in order:
            left = shard_bytes[v]
            while left:
                if last != missing_of[v]:
                    key = (len(missing_of[v]), 10)
                    want[key] = want.get(key, 0) + 1
                    last = missing_of[v]
                take = min(room, left)
                left -= take
                room -= take
                if room == 0:
                    room, last = span, None
    return want


def _busy(launches: dict, kernel_ms: dict, wall_s: float) -> dict:
    """Kernel milliseconds x launches by (R, C), against the wall time."""
    ms = {f"{r}x{c}": n * kernel_ms[(r, c)] for (r, c), n in launches.items()
          if (r, c) in kernel_ms}
    total = sum(ms.values())
    return {"kernel_ms_by_shape": ms, "kernel_ms": total, "wall_s": wall_s,
            "busy_share": total / 1e3 / wall_s if wall_s else None}


def run_storm(scratch: str, seed: int, card: str, kernel_ms: dict, device: str = "cuda",
              needle_bytes: int = STORM_NEEDLE) -> tuple[dict, dict]:
    """The shell and fleet phases (see the module doc), on one fresh cluster:
    the operator shell's EC lifecycle, then a repair storm under the
    master's scheduler. -> (shell line, fleet line)."""
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import slo, stripe
    from seaweedfs_tpu_torch.ops import rs_codec, rs_cuda
    from seaweedfs_tpu_torch.shell import CommandEnv, run_script
    from seaweedfs_tpu_torch.storage.file_id import FileId

    on_card = device == "cuda"
    root = os.path.join(scratch, "storm")
    limit = (STORM_NEEDLES + 1) * needle_bytes  # 256 MiB: the 255 needles fill 95%+
    coll = STORM_COLLECTION
    written = _storm_write(root, seed, needle_bytes)
    sample, bases = written["sample"], written["bases"]
    t0 = time.perf_counter()
    oracle, oracle_shape = _storm_oracle(root, bases, rs_codec.new_encoder(device=device))
    deployment = {
        "card": card,
        "source": "SeaweedFS wiki, Erasure Coding for warm storage: 10+4, ec.encode "
                  "-fullPercent=95, rack-aware spread, ec.rebuild/ec.balance under the "
                  "admin lock; WEEDTPU_REPAIR=on",
        "reduced": [f"volumes of {limit} bytes, not 30 GB", f"{STORM_VOLUMES} volumes, not "
                    "hundreds", "one host: master, 5 volume servers and the shell in one "
                    "process over loopback gRPC and HTTP"],
        "volumes": STORM_VOLUMES, "needle_bytes": needle_bytes, "racks": list(STORM_RACKS),
        "volume_size_limit": limit, "write_s": written["write_s"],
        "oracle_s": time.perf_counter() - t0,
        "dat_bytes": sum(os.path.getsize(b + ".dat") for b in bases.values())}
    saved = os.environ.get("WEEDTPU_REPAIR")
    os.environ["WEEDTPU_REPAIR"] = "on"
    master = MasterServer(port=0, reap_interval=3600, volume_size_limit=limit)
    servers, env, stopped = [], None, set()

    def sh(env, script: str) -> dict:
        out = io.StringIO()
        shape0 = dict(rs_cuda.launches_by_shape)
        t = time.perf_counter()
        run_script(env, script, out)
        return {"seconds": time.perf_counter() - t, "launches": _shape_launches(shape0),
                "text": out.getvalue()}

    def holders(vid: int) -> dict:
        return {s: [n.url for n in ns]
                for s, ns in master.topology.lookup_ec_shards(vid).items() if ns}

    def covered() -> bool:
        return all(len(holders(v)) == 14 for v in bases)

    def placement() -> dict:
        """{vid: {server index: [shard ids]}} from the master's registry."""
        idx = {vs.url: i for i, vs in enumerate(servers)}
        out: dict = {}
        for v in bases:
            for s, urls in holders(v).items():
                for u in urls:
                    out.setdefault(v, {}).setdefault(idx[u], []).append(s)
        return {v: {i: sorted(ss) for i, ss in sorted(m.items())} for v, m in out.items()}

    def shard_path(vs, vid: int, s: int) -> str:
        return stripe.shard_file_name(vs._base_path_for(vid, coll), s)

    try:
        master.start()
        for i, rack in enumerate(STORM_RACKS):
            vs = VolumeServer([os.path.join(root, f"srv{i}")], master.address,
                              heartbeat_interval=0.4, rack=rack,
                              encoder=rs_codec.new_encoder(device=device))
            vs.start()
            servers.append(vs)
        by_url = {vs.url: vs for vs in servers}
        _cluster_wait(lambda: sum(len(n.volumes) for n in master.topology.nodes.values())
                      == STORM_VOLUMES, "the master to list the storm's volumes")
        env = CommandEnv(master.address, device=device)

        # -- shell: lock, the listings, ec.backend, ec.encode, balance, verify, status
        rs_cuda.reset_launches()  # the shell path's run starts here
        t_phase = time.perf_counter()
        steps = {"lock_list_backend": sh(env, "lock; volume.list; cluster.ps; ec.backend")}
        text = steps["lock_list_backend"]["text"]
        backend = [ln for ln in text.splitlines() if ln.startswith("ec.backend: ")]
        want = ("backend=cuda", "variant=int8") if on_card else ("backend=torch",)
        check(backend and all(w in backend[0] for w in want), f"ec.backend said {backend}")
        check(text.count("volume server ") == len(STORM_RACKS), "cluster.ps lists 5 servers")
        ckpt = os.path.join(root, "ec_encode.checkpoint")
        steps["ec.encode"] = sh(env, f"ec.encode -collection {coll} -fullPercent 95 "
                                     f"-checkpoint {ckpt}")
        check(steps["ec.encode"]["text"].count("ec.encode volume ") == STORM_VOLUMES,
              f"ec.encode: {steps['ec.encode']['text']}")
        checkpoint_removed = not os.path.exists(ckpt)
        check(checkpoint_removed, "the finished encode left its checkpoint")
        _cluster_wait(lambda: covered() and not any(
            n.volumes for n in master.topology.nodes.values()), "14 shards of every volume")
        gen = {k: v for k, v in steps["ec.encode"]["launches"].items() if k[0] > 1}
        check(gen == oracle_shape, f"ec.encode launched {gen}, the local encodes {oracle_shape}")
        place = placement()
        for vid, per in place.items():
            check(max(len(ss) for ss in per.values()) <= 4, f"volume {vid} spread {per}")
            for i, ss in per.items():
                for s in ss:
                    check(sha256_file(shard_path(servers[i], vid, s)) == oracle[vid]["shards"][s],
                          f"volume {vid} shard {s} differs from the local encode")
                check(sha256_file(servers[i]._base_path_for(vid, coll) + ".ecx")
                      == oracle[vid]["ecx"], f"volume {vid} .ecx differs")
        steps["ec.balance"] = sh(env, f"ec.balance -collection {coll}")
        _cluster_wait(covered, "14 shards of every volume after the balance")
        steps["ec.verify"] = sh(env, f"ec.verify -collection {coll}")
        check("ec.verify: all shards verified clean" in steps["ec.verify"]["text"],
              f"ec.verify: {steps['ec.verify']['text'][-2000:]}")
        steps["ec.status"] = sh(env, "ec.status; unlock")
        shell_wall = time.perf_counter() - t_phase
        place = placement()
        per_server = {i: sum(len(per.get(i, [])) for per in place.values())
                      for i in range(len(servers))}
        per_rack = {STORM_RACKS[i]: n for i, n in per_server.items()}
        launches = dict(rs_cuda.launches_by_shape)
        shell = {
            "phase": "shell", **deployment,
            "steps": {k: {"seconds": v["seconds"], "launches_by_shape": _shape_keys(v["launches"])}
                      for k, v in steps.items()},
            "backend": backend[0], "encode_launches_equal_local": True,
            "checkpoint_removed": checkpoint_removed,
            "shards_equal_local_encode": True, "cap_ok": True,
            "balance": steps["ec.balance"]["text"].strip().splitlines()[-1:],
            "verify_lines": steps["ec.verify"]["text"].count("\n"),
            "status": steps["ec.status"]["text"].splitlines()[:3],
            "shards_per_server": per_server, "shards_per_rack": per_rack,
            "seconds": shell_wall, "launches_by_shape": _shape_keys(launches),
            "busy": _busy(launches, kernel_ms, shell_wall),
            "launches": dict(rs_cuda.launches_by_variant)}
        check(not on_card or shell["launches"].get("int8", 0) > 0,
              "the shell path never launched the factory's kernel")

        # -- fleet: a reader, the server holding most shards stops, the scheduler repairs
        rs_cuda.reset_launches()  # the fleet path's run starts here
        t_phase = time.perf_counter()
        vi = max(range(len(servers)), key=lambda i: (per_server[i], -i))
        victim = servers[vi]
        lost = {v: set(per.get(vi, [])) for v, per in place.items()}
        shards_of = {}
        for vid in bases:
            nids = sorted(n for v, n in sample if v == vid)
            base = servers[(vi + 1) % len(servers)]._base_path_for(vid, coll)
            for nid, ss in _needle_shards(base, nids).items():
                shards_of[(vid, nid)] = ss
        klass = {k: ("degraded" if shards_of[k] & lost[k[0]] else "healthy") for k in sample}
        order = [sorted(sample)[i] for i in np.random.default_rng(seed + 1500).permutation(
            len(sample))]
        rec = slo.LatencyRecorder()
        phase = ["steady"]
        stop_reads, steady_done = threading.Event(), threading.Event()
        reads = {"count": 0, "errors": 0, "wrong": 0, "by_phase": {}}
        client = MasterClient(master.address)

        def reader() -> None:
            i = 0
            while not stop_reads.is_set():
                key = order[i % len(order)]
                cookie, body = sample[key]
                ph, kl = phase[0], klass[key]
                t = time.perf_counter()
                try:
                    got = client.read(str(FileId(key[0], key[1], cookie)))
                except Exception:  # noqa: BLE001 — counted: the check wants none
                    reads["errors"] += 1
                    rec.error(ph, kl)
                else:
                    if got == body:
                        rec.observe(ph, kl, time.perf_counter() - t)
                    else:
                        reads["wrong"] += 1
                        rec.error(ph, kl)
                reads["count"] += 1
                reads["by_phase"][ph] = reads["by_phase"].get(ph, 0) + 1
                i += 1
                if i == len(order):
                    steady_done.set()

        th = threading.Thread(target=reader, name="storm-reader", daemon=True)
        th.start()
        check(steady_done.wait(600), "the reader's steady pass did not finish")
        shape0 = dict(rs_cuda.launches_by_shape)
        t_kill = time.perf_counter()
        phase[0] = "chaos"
        stopped.add(vi)
        victim.stop()  # LeaveCluster: the master's on_ec_shrink kicks the scheduler
        _cluster_wait(covered, "the scheduler to restore 14 shards of every volume", 600)
        ttr = time.perf_counter() - t_kill
        stop_reads.set()
        th.join(60)
        client.close()
        storm_shape = _shape_launches(shape0)
        st = env.master_call("RepairStatus", {})
        check(st["enabled"], "the master's scheduler is off")
        events = sorted(st["events"], key=lambda e: e["seq"])
        bad = [e for e in events if e["state"] in ("backoff", "failed", "lost")]
        check(not bad, f"repair events {bad}")
        dispatched = [e for e in events if e["state"] == "dispatched"]
        missing = [e["missing"] for e in dispatched]
        check(sorted(e["volume_id"] for e in dispatched) == sorted(v for v in bases if lost[v]),
              f"dispatched {dispatched}")
        check(missing == sorted(missing, reverse=True),
              f"dispatch order by missing count {missing}")
        for v in bases:
            check(len(lost[v]) == next(e["missing"] for e in dispatched if e["volume_id"] == v),
                  f"volume {v} dispatched with the wrong missing count")
        batches = st["batches"]
        for b in batches:
            check(b["block_missing"] == sorted(b["block_missing"], reverse=True),
                  f"batch block order {b}")
        check(st["fused_volumes_total"] == sum(b["volumes"] for b in batches),
              f"fused_volumes_total {st['fused_volumes_total']}")
        missing_of = {v: tuple(sorted(lost[v])) for v in bases}
        shard_bytes = {v: oracle[v]["shard_bytes"] for v in bases}
        align = servers[(vi + 1) % len(servers)].store.encoder.width_align
        predicted = _fused_prediction(batches, missing_of, shard_bytes, align)
        got = {k: n for k, n in storm_shape.items() if k[0] > 1}
        check(got == (predicted if on_card else {}),
              f"the storm launched {got}, the batches predict {predicted}")
        for v in bases:
            for s in lost[v]:
                (u,) = [u for u in holders(v)[s]]
                check(u != victim.url and sha256_file(shard_path(by_url[u], v, s))
                      == oracle[v]["shards"][s], f"rebuilt shard {s} of volume {v} differs")
        check(reads["errors"] == 0 and reads["wrong"] == 0, f"reader {reads}")
        repair_wall = time.perf_counter() - t_phase
        storm_busy = _busy(storm_shape, kernel_ms, ttr)

        # -- after the storm: verify, decode one volume, unlock ----------------------
        decode_vid = min(v for v in bases if lost[v])
        after = {"ec.verify": sh(env, f"lock; ec.verify -collection {coll}")}
        check("ec.verify: all shards verified clean" in after["ec.verify"]["text"],
              f"ec.verify after the storm: {after['ec.verify']['text'][-2000:]}")
        after["ec.decode"] = sh(env, f"ec.decode -volumeId {decode_vid}; unlock")
        owner = next(vs for i, vs in enumerate(servers)
                     if i not in stopped and vs.store.get_volume(decode_vid) is not None)
        decoded_sha = sha256_file(owner.store.get_volume(decode_vid).base_path + ".dat")
        check(decoded_sha == oracle[decode_vid]["dat"], "ec.decode gave back another .dat")
        survivor_bytes = sum(10 * shard_bytes[v] for v in bases if lost[v])
        fleet = {
            "phase": "fleet", "card": card, "victim": {"server": vi, "rack": STORM_RACKS[vi],
                                                       "shards": per_server[vi]},
            "stripes_by_missing": {str(n): sum(len(lost[v]) == n for v in bases)
                                   for n in sorted({len(x) for x in lost.values()})},
            "time_to_repair_s": ttr, "batches": len(batches),
            "dispatch_groups": [b["dispatch_groups"] for b in batches],
            "volumes_per_batch": [b["volumes"] for b in batches],
            "batch_wall_s": [b["wall_s"] for b in batches],
            "fused_volumes_total": st["fused_volumes_total"],
            "dispatch_missing": missing, "survivor_bytes": survivor_bytes,
            "gbps": survivor_bytes / ttr / 1e9,
            "launches_by_shape": _shape_keys(storm_shape),
            "predicted": _shape_keys(predicted), "rebuilt_equal": True,
            "reads": {**reads, "sample": len(sample),
                      "degraded_needles": sum(k == "degraded" for k in klass.values()),
                      "phases": rec.phases()},
            "slo": slo.slo_verdict(rec), "busy": storm_busy,
            "after": {k: {"seconds": v["seconds"], "launches_by_shape": _shape_keys(v["launches"])}
                      for k, v in after.items()},
            "decoded_volume": decode_vid, "decoded_equal": True,
            "seconds": time.perf_counter() - t_phase, "repair_wall_s": repair_wall,
            "launches": dict(rs_cuda.launches_by_variant)}
        check(not on_card or fleet["launches"].get("int8", 0) > 0,
              "the fleet path never launched the factory's kernel")
    finally:
        if env is not None:
            env.close()
        for i, vs in enumerate(servers):
            if i not in stopped:
                vs.stop()
        master.stop()
        _put_env({"WEEDTPU_REPAIR": saved})
    return shell, fleet


#: the load phase: the reference harness's real run (`weedload.py`'s usage
#: line) plus the storm, over 1000 objects (cut from 4000 so that the script
#: keeps its time with the ha phase: the preload is serial); the rack
#: phase's seconds
LOAD_ARGV = ("--seconds", "30", "--rps", "1000", "--procs", "4", "--chaos", "--rebuild-storm",
             "--objects", "1000")
RACK_SECONDS = 60


def _compute_pids() -> list[int]:
    """The pids `nvidia-smi --query-compute-apps=pid` lists, one per process
    holding a CUDA context on the card (in a container they may all read as
    one pid of another namespace: count them, do not name them)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return sorted(int(x) for x in out.stdout.split() if x.strip().isdigit())


@contextlib.contextmanager
def _contexts_watched(out: dict):
    """Samples the compute processes every 0.5 s while the body runs; `out`
    gets the list before, the most seen at once, and the list after (polled
    up to 30 s for a killed server's context to be released)."""
    out["before"] = _compute_pids()
    out["most_at_once"] = len(out["before"])
    stop = threading.Event()

    def sample() -> None:  # a server's context appears at its first launch
        while not stop.wait(0.5):
            out["most_at_once"] = max(out["most_at_once"], len(_compute_pids()))

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        deadline = time.monotonic() + 30
        while True:
            out["after"] = _compute_pids()
            if len(out["after"]) <= len(out["before"]) or time.monotonic() > deadline:
                break
            time.sleep(1.0)


def _check_contexts(ctx: dict, servers: int, what: str) -> None:
    """The servers' CUDA contexts were visible while they ran and none
    outlived the phase: after it, only the compute processes listed before
    it (this script's own) remain."""
    check(ctx["most_at_once"] >= len(ctx["before"]) + servers,
          f"{what}: nvidia-smi listed at most {ctx['most_at_once']} compute processes, "
          f"want {len(ctx['before'])} + {servers} servers")
    check(len(ctx["after"]) <= len(ctx["before"]),
          f"{what}: compute processes {ctx['after']} outlived the phase (before: {ctx['before']})")


def _server_evidence(by_server: dict, backends: dict, names: tuple, expect: int) -> dict:
    """The `expect` servers' counters, each summed over its process
    generations, and the backends their /metrics selected; every generation
    must have selected exactly the card's backend (`cuda`), so no server ran
    the plain version."""
    servers = {k: v for k, v in by_server.items() if k.startswith("n")}
    check(len(servers) == expect, f"scraped servers {sorted(servers)}, want {expect}")
    for name, gens in backends.items():
        if name.startswith("n"):
            check(gens and all(g == ["cuda"] for g in gens),
                  f"server {name} selected {gens}, not the card's backend")
    return {"servers": len(servers),
            "backends": {k: v for k, v in backends.items() if k.startswith("n")},
            **{c: sum(v.get(c, 0.0) for v in servers.values()) for c in names}}


@contextlib.contextmanager
def _isolated_env():
    """The harnesses set their knobs with os.environ.setdefault: each phase
    starts from the environment as it was and leaves it so."""
    saved = dict(os.environ)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def run_load(scratch: str, seed: int, card: str, kernel_ms: dict) -> dict:
    """The load phase (see the module doc): `weedload.main` with LOAD_ARGV on
    the card, three volume server subprocesses, four generator workers."""
    from seaweedfs_tpu_torch.scripts import weedload

    out, trace_out = os.path.join(scratch, "SLO_load.json"), os.path.join(scratch, "TA_load.json")
    argv = [*LOAD_ARGV, "--seed", str(seed), "--device", "cuda", "--out", out,
            "--trace-out", trace_out]
    ctx: dict = {}
    t0 = time.perf_counter()
    with _isolated_env(), _contexts_watched(ctx), \
            open(os.path.join(scratch, "load_report.txt"), "w") as sink, \
            contextlib.redirect_stdout(sink):
        rc = weedload.main(argv)
    wall = time.perf_counter() - t0
    with open(out, encoding="utf-8") as f:
        r = json.load(f)
    check(rc == 0 and r["lost"] == [] and r["ok"], f"load: rc {rc}, lost {r['lost'][:5]}")
    by_class = r["workload"]["objects_by_class"]
    check(all(by_class[k] > 0 for k in ("healthy", "ec_intact", "degraded")),
          f"load: objects by class {by_class}")
    check(r["overall"]["degraded"]["count"] > 0 and r["overall"]["cached"]["count"] > 0,
          f"load: degraded/cached reads {r['overall']}")
    chaos = r["chaos"]
    check(chaos["kills"] + chaos["wedges"] > 0, f"load: no chaos {chaos}")
    check(chaos["rebuilds"] and not any("error" in b for b in chaos["rebuilds"]),
          f"load: storm rebuilds {chaos['rebuilds']}")
    names = ("weedtpu_degraded_read_seconds_count", "weedtpu_ec_reconstruct_seconds_count",
             "weedtpu_ec_rebuild_seconds_count", "weedtpu_read_cache_hits_total",
             "weedtpu_read_cache_misses_total")
    servers = _server_evidence(r["counters_by_server"], r["server_backends"], names, 3)
    check(servers["weedtpu_degraded_read_seconds_count"] > 0
          and servers["weedtpu_ec_reconstruct_seconds_count"] > 0,
          f"load: no server decoded {servers}")
    # the report's own cache block sums the master's /metrics too, and the
    # master shares this process's registry with the earlier phases' reads
    hits, misses = (servers["weedtpu_read_cache_hits_total"],
                    servers["weedtpu_read_cache_misses_total"])
    check(hits >= 1, f"load: the servers' decoded-interval cache never hit {servers}")
    _check_contexts(ctx, 3, "load")
    load_s = r["workload"]["seconds"]
    completed = sum(v["count"] for v in r["overall"].values())
    decodes = servers["weedtpu_ec_reconstruct_seconds_count"]
    attrib = r["trace_attribution"]["classes"].get("degraded", {})
    return {
        "phase": "load", "card": card, "cpu_count": os.cpu_count(), "argv": argv,
        "seconds": wall, "stage_seconds": r["stage_seconds"],
        "offered_rps": r["workload"]["rps"], "issued": r["workload"]["issued"],
        "issued_rps": r["workload"]["issued"] / load_s, "completed_rps": completed / load_s,
        "objects_by_class": by_class,
        "by_phase": {ph: {k: {q: v[q] for q in ("count", "errors", "p50", "p99")}
                          for k, v in cells.items()} for ph, cells in r["phases"].items()},
        "overall": {k: {q: v[q] for q in ("count", "errors", "p50", "p99")}
                    for k, v in r["overall"].items()},
        "slo": r["slo"],
        "degraded_stage_p99": {k: v["p99"] for k, v in attrib.get("stages", {}).items()},
        "chaos": chaos, "cache": {"hits": hits, "misses": misses,
                                  "hit_rate": hits / (hits + misses)},
        "servers": servers, "contexts": ctx,
        # the servers' launches are counted in their own processes: this is
        # their /metrics decode count times the (1, 10) read kernels' ms
        "decode_busy": {
            "decodes": decodes,
            "kernel_ms_4k_to_64k": [decodes * kernel_ms["degraded4k"],
                                    decodes * kernel_ms["degraded64k"]],
            "share_of_load_s": [decodes * kernel_ms["degraded4k"] / 1e3 / load_s,
                                decodes * kernel_ms["degraded64k"] / 1e3 / load_s]},
    }


def run_rack(scratch: str, card: str) -> dict:
    """The rack phase (see the module doc): `chaos_soak --rack` on the card,
    seven volume server subprocesses in six racks."""
    from seaweedfs_tpu_torch.cluster import topology
    from seaweedfs_tpu_torch.scripts import chaos_soak

    out = os.path.join(scratch, "SOAK_rack.json")
    argv = ["--rack", "--seconds", str(RACK_SECONDS), "--device", "cuda", "--out", out]
    dead_s = topology.DEAD_NODE_SECONDS
    ctx: dict = {}
    t0 = time.perf_counter()
    try:
        with _isolated_env(), _contexts_watched(ctx), \
                open(os.path.join(scratch, "rack_report.txt"), "w") as sink, \
                contextlib.redirect_stdout(sink):
            rc = chaos_soak.main(argv)
    finally:
        topology.DEAD_NODE_SECONDS = dead_s
    wall = time.perf_counter() - t0
    with open(out, encoding="utf-8") as f:
        r = json.load(f)
    phases = {p: r.get(p, {}) for p in ("phase1_node", "phase2_rack")}
    gates = {name: {k: ph.get(k) for k in ("victims", "heal_seconds", "coverage_complete",
                                            "victims_expelled", "priority_ok")}
                    | {"block_missing": [b["block_missing"] for b in ph.get("batches", [])]}
             for name, ph in phases.items()}
    check(rc == 0 and r["ok"] and r["lost"] == [],
          f"rack: rc {rc}, ok {r['ok']}, lost {r['lost']}, phases {gates}, fusion "
          f"{r.get('fusion')}, violations {r.get('placement_violations')}")
    for name, ph in phases.items():
        check(ph.get("priority_ok") and ph.get("coverage_complete") and ph.get("victims_expelled"),
              f"rack {name}: {ph}")
    check(r["placement_violations"] == [], f"rack: violations {r['placement_violations']}")
    check(r["fusion"]["collapsed"], f"rack: fusion {r['fusion']}")
    batches = [b for ph in phases.values() for b in ph["batches"]]
    check(any(b["volumes"] >= 2 and b["dispatch_groups"] == 1 for b in batches),
          f"rack: no multi-volume batch in one dispatch group {batches}")
    names = chaos_soak.RACK_COUNTERS
    servers = _server_evidence(r["server_counters"], r["server_backends"], names, 7)
    check(servers["weedtpu_ec_rebuild_seconds_count"] > 0, f"rack: no server rebuilt {servers}")
    _check_contexts(ctx, 7, "rack")
    return {
        "phase": "rack", "card": card, "cpu_count": os.cpu_count(), "argv": argv,
        "seconds": wall,
        "heal_seconds": {p: ph["heal_seconds"] for p, ph in phases.items()},
        "batches": {p: [{k: b[k] for k in ("volumes", "signature_groups", "dispatch_groups",
                                           "block_missing", "wall_s")}
                        for b in ph["batches"]] for p, ph in phases.items()},
        "fusion": r["fusion"], "read": r["traffic"]["latency"].get("read", {}),
        "reads": r["reads"], "files": r["files"], "servers": servers, "contexts": ctx,
    }


def _version_if_importable(name: str) -> str | None:
    """A reading for the device line: the module's version where it imports
    on this machine, else None. Nothing here depends on it: the card's path
    needs neither grpc nor protobuf (only the transport would)."""
    import importlib

    try:
        return str(getattr(importlib.import_module(name), "__version__", "unknown"))
    except ImportError:
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dat-gib", type=float, default=2.0)
    ap.add_argument("--second-gib", type=float, default=1.0)
    ap.add_argument("--variant-gib", type=float, default=0.5)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from seaweedfs_tpu_torch.ops import _build, measure, rs_cuda

    card = measure.card_line()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "grpc": _version_if_importable("grpc"),
          "protobuf": _version_if_importable("google.protobuf")})

    from seaweedfs_tpu_torch.utils import native

    t0 = time.perf_counter()
    # the host codecs' library (g++) builds beside the kernels (nvcc), and
    # the host sanitizer phase runs meanwhile
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        host_lib = pool.submit(native.load_gf)
        sanitizer = pool.submit(run_sanitizer, card)
        built = _build.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "libraries": {k: {"seconds": v["seconds"]} for k, v in built.items()},
              "gf_host": host_lib.result() is not None})
        sanitizer = sanitizer.result()
    emit(sanitizer)
    if not sanitizer["ok"]:
        print("chip_smoke: the host codecs are not sanitizer-clean", file=sys.stderr)
        return 1
    check(set(built) == set(_build.SOURCES), f"built {sorted(built)}")
    for name, v in built.items():
        print(f"[{name}] {v['ptxas']}", file=sys.stderr)
    lowering = run_lowering(card, built)
    emit(lowering)
    if not lowering["ok"]:
        print(f"chip_smoke: the build proof failed: {lowering['failed']}", file=sys.stderr)
        return 1
    emit({"phase": "dma_ring", "card": card, **dma_ring(built["gf_dma"]["ptxas"])})

    checks = check_kernels(args.seed)
    for v, rows in checks.items():
        emit({"phase": "kernel_checks", "kernel": KERNELS[v][0], "variant": v, "card": card,
              "tolerance": 0, "cases": rows})
    bad = [(v, c["shape"]) for v, rows in checks.items() for c in rows
           if not (c["equal"] and c["agrees"])]
    if bad:
        print(f"chip_smoke: kernels disagree at {bad}", file=sys.stderr)
        return 1

    os.makedirs(SCRATCH, exist_ok=True)
    try:
        sweep = run_sweep(args.seed)
        emit({"phase": "sweep", "card": card, **sweep})
        # .dat + 14 shards of the larger volume, then the decoded .dat, and
        # the repair phase's two volumes; the earlier volumes are removed
        # before the ingest phase, whose peak is the .dat, its partials, a
        # warm oracle set and a staged set; the storm's peak (4 GiB of .dat,
        # its shards, the rebuilt ones and a decoded .dat) stays below both
        need = int(max(2.5 * (max(args.dat_gib, args.second_gib, args.variant_gib)
                              + 2 * REPAIR_GIB), 5.1 * INGEST_GIB) * (1 << 30))
        free = shutil.disk_usage(SCRATCH).free
        check(free > need, f"{free} bytes free under {SCRATCH}, the e2e phase needs {need}")
        rs_cuda.reset_launches()  # the main path's run starts here
        vols = [
            run_volume(os.path.join(SCRATCH, "1"), args.dat_gib, 1 << 30, args.seed, card),
            run_volume(os.path.join(SCRATCH, "2"), args.second_gib, 64 << 20,
                       args.seed + 1, card),
        ]
        # 32 MiB large blocks: a 0.5 GiB volume keeps a large row (both tiers)
        for k, v in enumerate(("dma", "mplane", "u8", "bf16")):
            vols.append(run_volume(os.path.join(SCRATCH, str(3 + k)), args.variant_gib,
                                   32 << 20, args.seed + 2 + k, card, variant=v))
        main_launches = dict(rs_cuda.launches_by_variant)
        reads = [v.pop("degraded_read") for v in vols]
        emit({"phase": "e2e", "card": card, "volumes": vols, "launches": main_launches})
        emit({"phase": "degraded_read", "card": card, "volumes": [r for r in reads if r]})
        # the host codecs on this host, against the card, on volume 1
        emit(run_host_codec(os.path.join(SCRATCH, "1"), vols[0], args.seed, card))
        # the mesh path counts its own launches (reset inside, read after)
        slice_lines = {"mesh": run_mesh(SCRATCH, vols[1], card)}
        emit({"phase": "mesh", **slice_lines["mesh"]})
        # the repair path counts its own launches (reset inside, read after)
        repair = run_repair(SCRATCH, args.seed, card)
        emit({"phase": "repair", **repair})
        for name in os.listdir(SCRATCH):  # the earlier volumes, before the slice's peak
            if os.path.isfile(os.path.join(SCRATCH, name)):
                os.remove(os.path.join(SCRATCH, name))
        # the ingest, convert and scrub paths each count their own launches
        slice_lines["ingest"] = run_ingest(SCRATCH, args.seed, card)
        vol = slice_lines["ingest"].pop("_volume")
        emit({"phase": "ingest", **slice_lines["ingest"]})
        slice_lines["convert"] = run_convert(vol, args.seed, card)
        kept, sample = slice_lines["convert"].pop("_kept"), slice_lines["convert"].pop("_sample")
        emit({"phase": "convert", **slice_lines["convert"]})
        slice_lines["scrub"] = run_scrub(vol, kept, sample, card)
        emit({"phase": "scrub", **slice_lines["scrub"]})
        shutil.rmtree(SCRATCH)  # the store phase starts on an empty directory
        os.makedirs(SCRATCH)
        slice_lines["store"] = run_store(SCRATCH, args.seed, card)
        obs_state = slice_lines["store"].pop("_obs")
        emit({"phase": "store", **slice_lines["store"]})
        slice_lines["obs"] = run_obs(obs_state, args.seed, card)
        emit({"phase": "obs", **slice_lines["obs"]})
        slice_lines["cluster"] = run_cluster(obs_state, args.seed, card)
        emit({"phase": "cluster", **slice_lines["cluster"]})
        slice_lines["ha"] = run_ha(obs_state, args.seed, card)
        del obs_state
        emit({"phase": "ha", **slice_lines["ha"]})
        int8 = {c["shape"]: c["kernel_ms"] for c in checks["int8"] if "kernel_ms" in c}
        kernel_ms = {(4, 10): int8["encode"], (3, 10): int8["fleet_rebuild3"],
                     (2, 10): int8["fleet_rebuild2"], (1, 10): int8["degraded1m"]}
        shutil.rmtree(SCRATCH)  # the filer phase starts on an empty directory
        os.makedirs(SCRATCH)
        # the s3 and sync phases run on the filer phase's cluster before it
        # stops, in turn, and each counts its own launches (reset inside,
        # read after)
        slice_lines["filer"] = run_filer(
            SCRATCH, args.seed, card, kernel_ms,
            then=lambda master, servers, fs, tree: (
                run_s3(os.path.join(SCRATCH, "s3"), master, servers, fs, args.seed, card,
                       kernel_ms),
                run_sync(os.path.join(SCRATCH, "sync"), master, servers, fs, tree, args.seed,
                         card, kernel_ms)))
        slice_lines["s3"], slice_lines["sync"] = slice_lines["filer"].pop("_then")
        emit({"phase": "filer", **slice_lines["filer"]})
        emit({"phase": "s3", **slice_lines["s3"]})
        emit({"phase": "sync", **slice_lines["sync"]})
        shutil.rmtree(SCRATCH)  # the bench phase starts on an empty directory
        os.makedirs(SCRATCH)
        slice_lines["bench"] = run_bench(SCRATCH, card)
        emit(slice_lines["bench"])
        shutil.rmtree(SCRATCH)  # the storm starts on an empty directory
        os.makedirs(SCRATCH)
        slice_lines["shell"], slice_lines["fleet"] = run_storm(SCRATCH, args.seed, card,
                                                               kernel_ms)
        emit(slice_lines["shell"])
        emit(slice_lines["fleet"])
        # the harnesses' servers are processes of their own and count their
        # launches there: these two lines carry the servers' /metrics instead
        shutil.rmtree(SCRATCH)
        os.makedirs(SCRATCH)
        emit(run_load(SCRATCH, args.seed, card, int8))
        shutil.rmtree(SCRATCH)
        os.makedirs(SCRATCH)
        emit(run_rack(SCRATCH, card))
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    idle = [v for v in KERNELS if not main_launches.get(v)]
    if idle:
        print(f"chip_smoke: the main path never launched {idle}", file=sys.stderr)
        return 1

    table = []
    for v, (name, source, replaces) in KERNELS.items():
        rows = checks[v]
        enc = next(c for c in rows if c["shape"] == "encode")
        table.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_launches[v],
            "equal": all(c["equal"] and c["agrees"] for c in rows),
            "tolerance": 0,
            "max_abs_err": max(c["max_abs_err"] for c in rows),
            "ms": enc["kernel_ms"],
            "kernel_ms": enc["kernel_ms"],
            "call_ms": enc["call_ms"],
            "plain_ms": enc["plain_ms"],
            "bound_ms": enc["bound_ms"],
            "bound_by": enc["bound_by"],
            "library_ms": None,
            "degraded": {c["shape"]: {k: c[k] for k in ("kernel_ms", "call_ms", "plain_ms", "bound_ms")}
                         for c in rows if c["shape"] in DEGRADED_SHAPES},
            "repair": {"launches": repair["launches"].get(v, 0), **{
                c["shape"]: {k: c[k] for k in ("kernel_ms", "call_ms", "plain_ms", "bound_ms",
                                               "bound_by")}
                for c in rows if c["shape"] in REPAIR_SHAPES}},
            "slice": {"launches": {p: line["launches"].get(v, 0) for p, line in slice_lines.items()},
                      **{c["shape"]: {k: c[k] for k in ("kernel_ms", "call_ms", "plain_ms",
                                                        "bound_ms", "bound_by")}
                         for c in rows if c["shape"] in SLICE_SHAPES}},
        })
    emit({"kernels": table})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
