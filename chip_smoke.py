#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on past an
error (no phase catches its own failure):

1. card:    print the card's name and power limit (nvidia-smi) and
            torch.cuda.get_device_name(0); fail when no card is found;
2. build:   build the hand-written kernels from ops/csrc (nvcc, one process
            per source, all started together, with measure/k7_leads.cu, the
            kernels that only measure) and print the build seconds; build
            (or load) the host kernel library (daft_tpu_torch/csrc/
            kernels.cpp, the host compiler) and print its path and build
            seconds: a failed build fails the script;
   data:    generate TPC-H lineitem (about 6.0 M rows), orders (1.5 M
            rows), part (200,000), customer (150,000), supplier (10,000),
            nation (25) and region (5) at SF1
            with numpy from a fixed seed, in the value domains of
            benchmarking/tpch/datagen.py (string columns as codes mapped
            through a small object array, or unique strings);
3. kernels: at the slices' shapes run each kernel on inputs built from the
            generated tables and require the same output as its plain
            PyTorch version; time the kernel, the plain version, one PyTorch
            library call computing the same function where there is one, and
            print the bound. Segment kernels at the supplier query's shapes
            (N = 2^23 rows, cap = 16384, P = 15 separate planes, as the
            stage passes them; Q = 1 for K2; K3's four launches, int64 min
            and max of l_shipdate and l_orderkey; K1a on the (N, 15) stack
            of K1's planes, also equal to K1's output cast to f32), K1
            (P = 5) and K2 (Q = 1) again at q12's cap 8, K1, K2, K3 and K1a
            again at cap 2^17 (l_partkey folded into 2^17 groups) and at
            cap 8 (every kept row on l_shipmode's 7 codes), and K1 on 73
            planes at cap 4096 (past one 64-plane chunk). K1's, K2's and
            K1a's bound counts the bytes the function needs (a trash row's
            plane values are not), beside every input read once; K4 at q12's
            (orders' 1.5 M keys into a 2^22-slot table, 2^23 lineitem keys
            probed, then the same keys shifted past the largest order key:
            every probe misses and walks to an empty slot). K4's build is
            compared as the sorted set of its (key, row) entries: where a
            key lands depends on the order the threads claim their slots.
            K5 on K4's table (lineitem's keys, orders' high/low priority
            planes) at q12's shapes (q12's ship-mode codes), equal to q12's
            oracle for MAIL and SHIP, and with every real row kept on its
            ship mode (about 6.0 M probes that hit), equal to a per-mode
            numpy count; its bound reads each distinct kept key's slot and
            each matched dim row's planes once; probe_timings.py times K5
            through the same functions. K6 at the repartition cell's shapes (8 x 8 blocks of
            23 x 2^20 + 4 words). K7 at q1's shapes (cap 8, its seven
            f32 sum planes, about 98 % of the real rows kept), the same in
            f64, at the supplier's cap with lineitem's four float columns
            (and the same columns by l_suppkey folded into caps 64 and
            1024: the warp tier and the block tier's one table), and at cap
            2^20 (l_orderkey folded), within twice the worst case of f64
            summation of its plain version, its block- and global-tier
            cases with an atomics floor (their adds at the card's f64
            atomic rate at the same shape, measured by k7_atomic_rate: the
            floor of adding each value by an atomic); K1, K2 and K3 at
            cap 2^20 too; K1, K2, K3 and K7 at the partkey cell's own inputs
            (cap 2^18, parts numbered by first row, K7 on
            l_extendedprice in f64, K3 on l_quantity's order-preserving
            key); K1, K2 and K7 at the join TopN's shapes, q3's own inputs
            at its cap 2^21 (its rows and revenue-count planes, first-row
            index, f32 revenue) and the same planes at the kernels' ceiling
            2^22 (K3 there too); K4 at q14's and q19's shapes (part's
            200,000 keys, lineitem's l_partkey probed); at the window
            phase's W2 inputs (w2_inputs): K4's build over part and probe of
            every l_partkey, K1, K2 and K7 at cap 4096 (25 brands x 150
            types; the rows of its 30 days kept). The ooc phase's cells run
            the scan phase's shapes, held above. Every kernel also by
            its device time under
            torch.profiler (K4's build with the table's clearing, where it
            has one). K1a and K5 have no engine caller, in the port or in
            the reference: they are held here alone;
3a. native: the host kernel library against its plain versions
            (DAFT_TPU_DISABLE_NATIVE set), in one process: the in-memory
            supplier, q3, q12 and partkey cells under device_mode="off"
            both ways in turns (library, plain, library, plain), every
            result equal, each way's warm ms and the library's calls
            printed;
4. slice:   the per-supplier shipment summary over lineitem through the port
            with device="cuda", device_mode="on"; the counters are zeroed
            just before that run and read just after it. The result must equal
            the port's host path and an independent numpy oracle exactly,
            K1-K3 must show launches, and no stage may fall back. Then the
            warm query time (median of 3) and peak device memory;
5. profile: one more warm supplier query under torch.profiler, for the
            device's busy time and idle share and its longest activities
            (a capture holding fewer kernel activities than the run counted
            launches is taken again, up to three times, then reported as
            not measured; so for every profile below);
6. q12:     TPC-H q12 (lineitem joined to orders, grouped by ship mode)
            through the port with device="cuda", the counters zeroed just
            before the cold run and read just after it: K4 (build and
            probe), K1 and K2 must show launches, with at least one device
            join batch and no fallback, and the result must equal the host
            path and a numpy oracle exactly. Then the warm query (median of
            3, which must launch K4 zero times: its index plane is resident),
            peak device memory, and one warm query under torch.profiler;
7. q1:      TPC-H q1 at SF1 (float sums and means by return flag and line
            status) with device="cuda", the counters zeroed just before the
            cold run and read just after it: K7, K1 and K2 must launch, with
            a device grouped batch, no fallback and no refusal, and the
            result must equal the host path and a numpy oracle (floats at
            rtol 1e-5, the rest exactly); then q1 with l_extendedprice's min
            and max, a stage in f64, counted the same way: K3 must launch
            too and the extremes equal bit for bit. Cold time, warm median
            of 3, peak device memory, and one warm q1 under torch.profiler;
8. partkey: groupby(l_partkey) over lineitem (200,000 groups, cap 2^18)
            with sum(l_extendedprice), count and max(l_quantity), counted
            and checked the same way, with the time of one warm run's
            finalize against the whole, and a profile;
9. q6:      TPC-H q6 at SF1 through the ungrouped device stage, counted and
            checked the same way (device_stage_batches), and a profile;
10. q14, q19, q3, q10: the join tails at SF1 (lineitem the fact; part the
            dim of q14 and q19, orders of q3 and q10 with customer and
            nation chained) through the port with device="cuda": the
            counters zeroed just before the cold run and read just after
            it: a device join batch, no fallback, one device TopN run for
            q3 and q10, K4's build and probe once (one adjacent dim) and on
            the three warm runs never; the result equal to the host path
            and a numpy oracle (row order, integers, strings and dates
            exactly, float sums at rtol 1e-5), q3's and q10's oracle margin
            at the limit and their cold host factorize time printed; cold
            time, warm median of 2, peak memory and a profile each;
11. q1 chain, q6 chain: q1 and q6 written with their derived columns
            as ``with_column`` (q1: two, then ``where`` and ``groupby``;
            q6: ``where``, one, ``agg``) at SF1: each must plan as one
            device node over the scan (the fused region, ops/region.py) with
            no host Project or Filter, count one region dispatch per run
            with its ops (4 and 3), upload nothing on a warm run, and equal
            the host path, the numpy oracle and its plain cell's result
            (q1's bit for bit); the device time of one evaluation of the
            projected disc_price, which the composed q1 evaluates twice, is
            printed; counted, timed and profiled as the cells above;
12. q5:     TPC-H q5 at SF1 (lineitem the fact; orders and supplier
            adjacent; customer, nation and region chained behind orders):
            counted from zero as above, no rejection and no fallback, K4 on
            the cold run (launches printed) and never warm, equal to the
            host path and a numpy oracle; cold, warm, peak memory, profile;
    sql:    TPC-H q1, q6, q3, q5, q12, q14 and q19 in SQL (``TPCH_SQL``,
            the texts tests/test_torch_sql.py holds against the reference)
            over the tables their DataFrame cells ran over, bound by name:
            for each, parse + plan, optimize() and translate() times; the
            DataFrame form's run and the SQL form's first run, each counted
            from zero, count the same device stages and kernel launches, and
            the three warm SQL runs three times as many; the results are
            equal (floats within rtol 1e-5, the rest exactly); first-run and
            warm median-of-3 wall time; a warm SQL run uploads nothing where
            the DataFrame form's does not;
    serve:  the serving tier (daft_tpu_torch/serving/, gateway/): one
            in-process GatewayServer on 127.0.0.1 with four serving
            workers, four tenants on their own connections and threads,
            each sending TPC-H q1, q3, q5, q6, q12, q14 (their TPCH_SQL
            texts) and one grouped MIN/MAX over lineitem (K3) in a rotated
            order, over SF1 tables that hold every column the mix reads
            (``serve_tables``). Rounds: cold (prepared misses, K1-K4 and K7
            captured at the inputs the run gave them); warm with the result
            cache off (prepared hits; q6 with another discount range, a
            literal the prepared cache replans once); the result cache on
            (each tenant's second pass served from it, equal to its first);
            hbm_budget_bytes at the largest reservation of the warm round
            (admission waits); and a one-worker gateway where one tenant
            queues eight queries and cancels the last (the typed
            "cancelled" error; afterwards no reservation and no pin). Every
            answer equals the same SQL in-process under device_mode="off"
            (floats within rtol 1e-5, the rest exactly), every executed
            query's plan holds a device stage that ran with no fallback and
            no rejection, and the captured kernel calls equal their plain
            versions; each query's p50 and p99 latency through the wire per
            round, admission waits, prepared and result-cache hits, the
            bytes streamed and one warm round under torch.profiler;
    dist:   the distributed workers (daft_tpu_torch/distributed/): q1 with
            l_extendedprice's min and max at SF1 through
            DistributedRunner(num_workers=2, n_partitions=2,
            device_workers=2), both workers fresh subprocesses leased the
            card: the partial DeviceGroupedAgg stages run K1, K2, K3 and K7
            in the workers (their launches summed from the tasks' engine
            counters; K1 or K7 at 0 fails), then the hash shuffle and the
            final aggregate. Its keys, counts and min / max equal the
            single-process card run and device_mode "off" bit for bit, its
            float sums the f64 numpy oracle within rtol 1e-9. The repeat
            counts affinity hits and leaves each worker's h2d bytes (from
            heartbeats) flat; q12 through the runner (its device join on the
            coordinator, then its host plan through the workers); a worker
            killed after its map with its files lost (one respawn) and the
            query equal; four tenants' q1 and q6 through
            ServingSession(runner=...) equal to the single-process runs.
            Cold and warm wall times beside the single-process run's, the
            workers' launches and h2d bytes, each run's slowest task;
13. topn order: the join TopN's row order on the card against the host
            path: 4,000 rows of negative int64 sums, sums past 2^53 that tie
            in f64, and float sums with +inf, NaN and a null group, each in
            the four (desc x nulls_first) settings; then lineitem joined to
            orders by customer at SF1, a signed int64 sum in eight digit
            planes, counted, descending against the host path and a numpy
            oracle, ascending against the oracle; profiled;
14. coalesce: q6 over lineitem cut into morsels of 16,384 rows through
            the dispatch coalescer: fewer dispatches than morsels, buckets
            at least half full, the result equal to the one-batch run's and
            the oracle's; three warm runs (every coalesced batch a new
            Series, its planes rebound by content: no upload), and a
            profile;
15. repartition: lineitem's eight numeric columns at SF1 (about 6.0 M rows)
            repartitioned by ``l_orderkey`` into 8 partitions over a mesh of
            8 shard slots on the card (mesh_devices=8), the counters zeroed
            just before the run and read just after it: K6 must launch once,
            with no all_to_all dispatch. Every partition must equal the
            port's host path and a numpy oracle (splitmix64 of the key bits
            mod 8, rows in input order), rows in order; then the
            kernel_mode="off" tier (all_to_all) must give the same
            partitions. Then the wall time (median of 3), peak device memory
            and one run under torch.profiler;
16. scan:   the port's files at SF1 (daft_tpu_torch/io/, no pyarrow):
            lineitem, orders, part, customer, supplier, nation and region
            written with write_parquet (snappy), the four dims with
            write_csv too, each with its bytes and seconds; every table
            read back whole, each column equal to the in-memory table's
            (floats bit for bit), with seconds and MB/s; a slice of each
            table's snappy pages decoded by the library and the plain
            Python decoder, equal; the fingerprints of q1's columns against
            their uploads. Then, each through run_cell (counters from zero,
            cold, warm median of 2, host path, peak memory, optimize /
            translate) and equal to its in-memory cell's result, with the
            scan's own numbers (tasks, row groups read and pruned, morsels,
            decode ms) and the warm runs' rebinding (fingerprint ms,
            hbm_stable_rehits), no upload on a warm run, and a profile:
            q1 and q6 over read_parquet(lineitem); q12 and q14 with orders
            and part from Parquet (K4's cold and warm launches printed); q5
            in SQL through current_session() with lineitem and orders from
            Parquet and its dims from CSV (CSV scans give no row estimate,
            so, as in the reference, the joins keep the text's order and run
            on the host into the grouped stage); q6 over a copy of lineitem
            sorted by l_shipdate (the zone maps must prune row groups);
            and q3 over Parquet, whose join TopN takes the host plan for a
            fact of many morsels (the fallback's reason printed). The scan
            cells' coalescer flushes by size alone (SCAN_FLUSH_MS);
17. pipeline: the pipelined executor (daft_tpu_torch/execution/pipeline.py;
            pipeline_mode "on", the default every other phase runs under)
            against the sequential one ("off"), over the scan phase's files:
            q1, q6, q12, q14 and q3 over Parquet, q5 in SQL with its dims
            from CSV, and the in-memory supplier, q1 and q12 cells, each in
            turns off, on (q5 off, on, on, off: cold and warm in each
            mode), counted from zero each run: every run equal
            to the cell's result (held to its numpy oracle) and to the other
            mode's, its stage counter above 0, in "on" every kernel call and
            device feed made from the thread the plan puts it on (a stage
            thread for a device node under a stage node), and after each
            run no stage thread alive and no residency pin held; each
            cell's warm medians in both modes and the scan tasks read at
            once; the host's cores and the compute pool's width; q5's host
            joins timed before (the per-batch join) and after the
            build-once probe; file-fed q1 under "on" in torch.profiler;
18. obs:    the observability tier (daft_tpu_torch/observability/) over
            cells already loaded: EXPLAIN ANALYZE of q1, q12 and q3 in
            memory and q6 over the scan phase's Parquet lineitem under
            pipeline_mode "on", each warm: the result equal to an
            unobserved run's (floats within rtol 1e-5), the engine counters
            (device batches, launches, fallbacks, the coalescer's and the
            scan's counts) equal count for count, the root operator's rows
            out equal to the result's, the file-fed cell's starve and
            blocked columns there and its stages stalled; each operator
            table printed; q12's explain_analyze(profile=...) trace holding
            device.h2d, device.dispatch and device.d2h spans inside the
            run's wall clock; a subscriber on q1 seeing start, optimized,
            operator stats and end in order, QueryEnd.metrics holding the
            device counters; warm medians of q1, q6 and q12 in turns, no
            observer with the flight recorder off, the default (recorder
            on), one subscriber, explain_analyze, on one line;
19. ooc:    bench.py:1129-1276's out-of-core capture on the port: TPC-H q1,
            q3, q4, q5, q6, q10, q12, q14 and q19 (benchmarking/tpch/
            queries.py, its import rewritten to the port) over the scan
            phase's Parquet lineitem and the in-memory dims, each (a)
            device_mode="off" unbudgeted, (b) "off" under B10 (10 % of the
            SF1 tables' size_bytes) in one query scope, equal to (a)
            exactly, spill_bytes > 0 over (b), (c) "on" under B10 on the
            card, equal to (a) by the exactness rule, after the same query
            unbudgeted on the card: both fall back exactly where
            OOC_FALLBACKS says (q3's and q10's TopN once, the rest never),
            and (c)'s device stages feed, dispatch and launch what the
            unbudgeted run's do, count for count; each run's ms and the
            spill, scan and ledger counters, the scope's peak and ru_maxrss.
            Then under B1 (1 %): lineitem's sort keys and l_quantity sorted
            by (l_extendedprice, l_orderkey, l_linenumber) in a sync and an
            async leg, each equal to the in-memory sort as arrays; q4 in
            both device modes (its semi join's build side Grace-partitions)
            and an inner join of lineitem with orders, each equal to its
            unbudgeted run. Spill goes to a temporary directory that the
            phase deletes;
    auto:   device_mode="auto" (ops/costmodel.py): the cost model
            calibrated on the card (its link terms printed with the card's
            name and power limit), every default rate of costmodel.RATES
            measured again beside its committed value
            (tools/calibrate.py measure_rates), then the ooc phase's nine
            queries over the Parquet lineitem (unbudgeted) and the
            in-memory supplier, q1, q12 and partkey cells, each run once
            and then once warm under "auto" (the warm run counted from
            zero): each result equal to the cell's "off" result by the
            exactness rule, every stage's verdict printed with its device
            and host totals, their terms and the margin, and the warm
            time beside the cell's "off" and "on" times where an earlier
            phase measured them. The ai embed cell runs under "auto" in the
            ai phase (its weights resident), within 1e-5 of its "on" run
            and of the CPU's first 256 rows;
20. window: W1, six window functions over SF1 lineitem's first 1,500,000
            rows by supplier in ship-date order, unbudgeted and under B1
            (the Grace window), equal as rows keyed by (l_orderkey,
            l_linenumber) and to a numpy oracle; W2, TPC-DS q98's shape on
            TPC-H tables (30 days of lineitem joined to part, revenue by
            brand and type, each group's share of its type by a window),
            as a DataFrame and in SQL through run_cell (the aggregate on
            the card as the device join stage), equal to each other, the
            "off" run and a numpy oracle, each with a profile;
20a. functions: SF1 lineitem filtered on l_linenumber.is_in([1, 3, 5])
            and l_orderkey % 7 != 0, eight aggregates of the device
            functions (log10, sqrt, //, abs, round, **, clip, exp) by flag
            and status as one f64 DeviceGroupedAgg through run_cell, equal
            to the "off" run and a numpy oracle, with a profile;
20c. temporal: SF1 lineitem with two timestamp("us") columns (l_shipts,
            l_receiptts: the day's date plus a seeded microsecond of the
            day). T1, a filter by TIMESTAMP literals and a transit over
            INTERVAL '20' DAY, then count, sum, min / max of the
            timestamp and of the transit by flag and status, as a
            DataFrame and in SQL: one fused region under a
            DeviceGroupedAgg, K1, K7 and at least four K3 launches, equal
            to "off" and a numpy oracle, cold and warm (median of 2). T2,
            the host functions at SF1 (hour, the zone conversion to
            America/New_York, truncate to the day, total_hours), each
            timed, feeding grouped device stages held to "off" and to
            numpy (the zone's offsets from Python's zoneinfo, per hour).
            T1 file-fed: the table sorted by l_shipts written with the
            port's Parquet writer and read back, the timestamp statistics
            pruning row groups, no upload warm. Over the first 1,500,000
            rows: windowed stddev / var by supplier over three preceding
            rows in l_shipts order: var
            within the f64 prefix sums' rounding bound of numpy's, stddev
            its sqrt bit for bit (both are held bit for bit against the
            JAX package by tests/test_torch_temporal.py). The surface:
            sample -> groupby (a device stage; its kept count within 6 sd
            of the binomial law, the rows it keeps held to the JAX
            package's by tests/test_torch_temporal.py), into_batches -> q6,
            and over the first 1,500,000 rows unpivot and pivot of the flags,
            count_rows and add_monotonically_increasing_id, each held to
            "off". K1, K3 and K7 held at T1's captured inputs against
            their plain versions ("at_t1_..." rows). Prints where the zone
            database was found;
20d. nested: SF1 lineitem with its ship mode as dictionary-coded
            strings, a struct of (l_linenumber, l_returnflag) and a seeded
            three-word l_comment. N1 (host): by l_orderkey, agg_list of
            l_suppkey, l_quantity, l_extendedprice, l_shipmode and the
            struct, agg_set of l_shipmode, any_value of l_comment: 1.5 M
            rows, 6 M elements a list column, held to numpy. N2 (card):
            the three numeric lists exploded, then count, sums, float and
            int64 extremes by l_suppkey: one DeviceGroupedAgg over the
            explode, K1, K2, K7 and K3 launched, equal to the flat
            aggregation over lineitem, "off" and numpy, cold and warm,
            uploads on a warm run, a profile. N3: N1 written with the
            port's Parquet writer and read back equal, then N2 over the
            file, no upload warm. N4: the host functions (list_length,
            list_sum, list_max, list_get, list_sort, list_distinct,
            list_contains, list_join, struct_get, partition_iceberg_bucket
            over N1's rows; to_json -> json_query, encode_base64, sha256
            and a gzip round trip, a Python call a value, over its first
            25,000), host clock, median of 3, each held to a plain-Python
            oracle on 10,000 seeded rows; explode and agg_list alone. N5:
            the build in SQL (ARRAY_AGG, LIST_AGG), the explode, N2's
            aggregate in SQL, equal to N2. K1, K2, K3 and K7 held at N2's
            captured inputs ("at_n2_..." rows);
20e. multimodal (the full script: M1 1,024 files, M2 50,000 documents;
            alone at the sizes below): M1: 4,096 seeded PNG files (sides
            128-512, 80 % RGB, 10 % L, 10 % RGBA, 1 % of no image) written by the port's
            encoder, then from_glob_path -> url.download -> image.decode
            (on_error="null") -> to_fixed_shape("RGB", 224, 224) -> an
            on_device UDF over the (bucket, 224, 224, 3) uint8 tensor (64
            f32 features) -> cosine_distance to a fixed query -> count,
            sum, mean, min and max by channels x width bucket on the
            grouped stage (K1, K2, K7): the UDF within rtol 1e-5 of the
            CPU, equal to "off" and the oracle, 0 bytes uploaded warm,
            the host split, a profile. M2: 200,000 documents, minhash(32,
            3) equal to a numpy / hashlib oracle, the first band's int64
            key grouped on the card (K1), its candidate pairs the
            oracle's; tokenize_encode's lengths. M3: approx_count_distinct
            of l_orderkey (registers and estimate the oracle's, within 2 %)
            and approx_percentile of l_extendedprice by flag and status
            (within alpha of the exact quantiles). The stage's kernels held
            at the inputs M1's and M2's cold runs gave them ("at_m1_...",
            "at_m2_..." rows);
20f. ingest: J1: 4,096 JPEG files (sides 128-640; RGB 4:2:0 at quality
            75, 85 or 95, RGB 4:4:4, L, RGB 4:1:1; 41 of no image) written
            by the port's encoder and a manifest of 4 JSONL shards, then
            read_json -> url.download -> image.decode(on_error="null") ->
            to_fixed_shape("RGB", 224, 224) -> M1's device UDF -> cosine
            distance -> count, mean, min and max by label on the grouped
            stage (K1, K2, K3, K7): as M1, and the library's JPEG decode
            equal to the plain one on 256 files and the committed
            fixtures (PIL's pixels). W1: 4 gzipped WARC files of 4,096
            request / response pairs (2,048 hosts, 10 % duplicate
            payloads of Zipf text in mixed scripts), then read_warc -> the
            responses -> host by str.extract, tokens by tokenize_encode
            with tests/data/w1_tokenizer.json -> count, sum of tokens and
            mean content length by host on the grouped stage (K1, K2):
            equal to "off" and a plain-Python oracle, 0 bytes uploaded
            warm. Each with its host split and a profile; the stage's
            kernels held at the inputs the cold runs gave them
            ("at_j1_...", "at_w1_..." rows);
20b. tpcds:  the 25 queries of benchmarking/tpcds/queries.py at SF1 over
            tpcds_tables (the reference's generator in numpy), each "off",
            then "on" cold and warm (median of 2), "on" equal to "off";
            each query's stage, times, launches and run-time fallbacks;
21. ai:     the UDF tier (daft_tpu_torch/ops/udf_stage.py) and the torch
            provider's encoder at sentence-transformers/all-MiniLM-L6-v2's
            widths (vocab 30,522, hidden 384, 6 layers, 12 heads, FFN
            1,536, max_len 128), seeded weights (about 90 MB) put in the
            provider's embedder cache first, as a model load does; a corpus
            of 65,536 texts (8-64 words drawn Zipf-like from 50,000
            synthetic words, some null or empty) in morsels of 512 rows.
            embed (batch_size 1,024): counters from zero, the morsels
            coalesced into fewer dispatches, cold time, one warm run
            with no weight bytes uploaded, rows/s, peak memory, unit-norm
            rows and null texts null, one warm run under torch.profiler
            (host tokenization against device busy time, the encoder's
            FLOP/s against the 67 TFLOP/s f32 peak), and the first 256
            rows within 1e-5 of the same query on the CPU. classify ->
            groupby -> count: equal to the argmax of the embed cell's own
            embeddings against the label matrix (the rows of a top-two
            margin under 1e-5 counted), only the label matrix's bytes
            uploaded, only int32 codes copied back, K1 and K2 launched, its
            time (the encoder already resident: one run),
            and both held at the run's own inputs against their plain
            versions. fused: a scalar device UDF under a sum over SF1
            lineitem feeds the ungrouped stage in the same dispatch (no
            DeviceUdfRun finalized, so the UDF plane never comes back; one
            aggregate finalize), equal to a numpy oracle (rtol 1e-5),
            uploading nothing warm;
22. print the ``native {...}`` line (the host kernel library's path, its
   build seconds and each of its 25 exports' calls over the script), the
   {"kernels": [...]} line (each kernel's launches by path:
   every cell's counted run, the sql phase's SQL first runs, summed,
   under "sql", the serve phase's rounds, summed, under "serve", and the
   dist phase's first q1 run, its workers' launches, under "dist"), the
   card line, and last the {"ok": true, "device": {...}} line.

Every DataFrame runs through ``collect``, which optimizes its plan
(daft_tpu_torch/plan/optimizer.py) before translating it; each cell prints
one "optimize ms / translate ms" line (host clock, medians of PLANS calls).

Every relational cell runs at SF1: nothing is cut; the ai cells run the
model at its published widths with its depth uncut. It imports torch,
numpy and the port; nothing of JAX, pyarrow or daft_tpu.

    python3 chip_smoke.py --phase ooc|window|obs|auto|functions|tpcds|native|temporal|nested|
                                  multimodal|ingest|serve|dist

runs phases 1-3, then that phase alone (ooc, obs and auto write lineitem's
Parquet files themselves; auto alone computes each cell's "off" result and
runs the ai embed cell after one "on" run; native first times make_groups,
grouped_reduce, join_indices, ProbeTable's build and probe and the
selection vector at SF1 shapes both ways (host ms, median of 3, the
results equal), and adds, both ways, in-memory q1, file-fed q3 and q5 in
SQL over the scan phase's files, the ooc phase's nine queries under B10,
TPC-DS q65 and q51 and the functions cell).

    python3 chip_smoke.py --kernels-only [--root DIR]

runs phases 1-3 alone, on the daft_tpu_torch of the checkout at DIR (by
default the one beside this script): to time an unpacked parent commit's
kernels and this tree's in one call, on one card, in turns. The checkout
must take the same kernel arguments as this script's package: an older
parent is driven by its own unpacked chip_smoke.py.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 20261016
SF1_ORDERS = 1_500_000
SF1_SUPPLIERS = 10_000
BUCKET = 1 << 23          # 6.0 M rows pad to this bucket
CAP = 16384               # 10,000 suppliers pad to this group capacity
Q12_CAP = 8               # 7 ship modes pad to this group capacity
K3_SMALL_CAP = 8          # K3 with every kept row on l_shipmode's 7 codes
K3_LARGE_CAP = 1 << 17    # K3 (and K1, K2) at their global tiers' start
MAX_CAP = 1 << 20         # the grouped stage's segment ceiling (MAX_SORT_SEGMENTS)
Q3_CAP = 1 << 21          # q3's 1.5 M orders (its TopN run's groups) pad to this capacity
TOPN_CAP = 1 << 22        # the kernels' ceiling (the join TopN's TOPN_MAX_SEGMENTS)
Q5_CAP = 32               # q5's groups, the 25 nations' names, pad to this capacity
TOPN_SF1_CAP = 1 << 18    # the TopN order cell's ~150,000 customers pad to this capacity
SCAN_MORSEL_ROWS = 128 * 1024  # rows a Parquet read yields per morsel (morsel_size_rows)
WIDE_CAP, WIDE_PLANES = 4096, 73  # K1 past one 64-plane chunk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
CELL_KERNEL_PREFIX = "launches_"  # the counters a cell reads its kernels' launches from
EPOCH = datetime.date(1970, 1, 1)
D_1992 = (datetime.date(1992, 1, 1) - EPOCH).days
D_1998 = (datetime.date(1998, 12, 1) - EPOCH).days
CUTOFF = datetime.date(1998, 9, 2)  # TPC-H Q1's ship-date predicate
Q12_FROM, Q12_TO = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
# benchmarking/tpch/datagen.py:36-37
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
# benchmarking/tpch/datagen.py:188-189
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["O", "F"]
Q1_CAP = 8                # q1's 3 x 2 flag and status codes pad to this capacity
Q6_FROM, Q6_TO = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)
SF1_PARTS = 200_000
SF1_CUSTOMERS = 150_000
# benchmarking/tpch/datagen.py:26-47
NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA", "FRANCE",
           "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA",
           "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM",
           "RUSSIA", "UNITED KINGDOM", "UNITED STATES"]
# each nation's region key, and the regions (benchmarking/tpch/datagen.py:26-33)
NATION_REGIONS = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2, 3, 3, 1]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPES_P1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPES_P2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPES_P3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS_P1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINERS_P2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_TYPES = [f"{a} {b} {c}" for a in TYPES_P1 for b in TYPES_P2 for c in TYPES_P3]
P_BRANDS = [f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6)]
P_CONTAINERS = [f"{a} {b}" for a in CONTAINERS_P1 for b in CONTAINERS_P2]
PARTKEY_CAP = 1 << 18     # 200,000 parts pad to this group capacity
K7_SMALL_CAPS = (64, 1024)  # K7 on the supplier's float columns, l_suppkey folded
MESH = 8                  # the repartition cell's partitions and shard slots
SEGMENT_SOURCE = "daft_tpu_torch/ops/csrc/segment_reduce.cu"
PROBE_SOURCE = "daft_tpu_torch/ops/csrc/hash_probe.cu"
PERMUTE_SOURCE = "daft_tpu_torch/ops/csrc/ring_permute.cu"
# kernels that only measure (the card's f64 atomic rate, K7's cluster
# designs): built from this checkout whatever package --root names
MEASURE_SOURCE = "measure/k7_leads.cu"
KERNELS = {  # name -> (source, the TPU kernel or host function it replaces)
    "segment_sum_planes": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:129"),
    "segment_extreme_planes": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:184"),
    "segment_extreme_int64": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:248"),
    "hash_probe_build": (PROBE_SOURCE, "daft_tpu/ops/pallas_kernels.py:310"),
    "hash_probe_index": (PROBE_SOURCE, "daft_tpu/ops/pallas_kernels.py:369"),
    "segment_sum_planes_f32": (SEGMENT_SOURCE, "daft_tpu/ops/pallas_kernels.py:82"),
    "hash_probe_segment_sum": (PROBE_SOURCE, "daft_tpu/ops/pallas_kernels.py:421"),
    "ring_permute_words": (PERMUTE_SOURCE, "daft_tpu/ops/pallas_kernels.py:515"),
    # no Pallas kernel: the reference's XLA reduction of float "sum" planes
    "segment_sum_float_planes": (SEGMENT_SOURCE, "daft_tpu/ops/grouped_stage.py:393"),
}
# the repartition cell's columns: lineitem's numeric ones
REPART_COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
                  "l_extendedprice", "l_discount", "l_tax")

# TPC-H's 22 queries in SQL, from the public TPC-H specification (2.4-2.25) with
# the validation parameters substituted, calendar intervals written as explicit
# DATE bounds and q15's view as a CTE. Three departures, each so that the text
# computes what the spec means over the generated data: q6's discount bounds
# are written as 0.05 and 0.07 (0.06 - 0.01 and 0.06 + 0.01 fold to floats just
# inside them); q19 takes the join equality that its three OR groups share out
# of the OR (inside it no equi-join can be recovered, and the comma list would
# stay a cross join) and its ship mode is 'REG AIR', dbgen's value (the spec's
# text reads 'AIR REG', which no row holds); q22 calls SUBSTRING(c_phone, 1, 2)
# (the parser has no FROM/FOR form). The card run and tests/test_torch_sql.py
# read these texts. q11 (a scalar subquery in HAVING), q13 (a LEFT JOIN with a
# residual ON predicate) and q21 (a correlated <> predicate) are refused by the
# reference's planner, and so by the port's.
TPCH_SQL = {
    1: """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus""",
    2: """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey and p_size = 15
  and p_type like '%BRASS' and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (select min(ps_supplycost) from partsupp, supplier, nation, region
                       where p_partkey = ps_partkey and s_suppkey = ps_suppkey
                         and s_nationkey = n_nationkey and n_regionkey = r_regionkey
                         and r_name = 'EUROPE')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100""",
    3: """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, o_orderdate,
       o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10""",
    4: """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01' and o_orderdate < date '1993-10-01'
  and exists (select * from lineitem
              where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority""",
    5: """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey and l_suppkey = s_suppkey
  and c_nationkey = s_nationkey and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01' and o_orderdate < date '1995-01-01'
group by n_name
order by revenue desc""",
    6: """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07 and l_quantity < 24""",
    7: """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (select n1.n_name as supp_nation, n2.n_name as cust_nation,
             extract(year from l_shipdate) as l_year,
             l_extendedprice * (1 - l_discount) as volume
      from supplier, lineitem, orders, customer, nation n1, nation n2
      where s_suppkey = l_suppkey and o_orderkey = l_orderkey and c_custkey = o_custkey
        and s_nationkey = n1.n_nationkey and c_nationkey = n2.n_nationkey
        and ((n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
             or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE'))
        and l_shipdate between date '1995-01-01' and date '1996-12-31') as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year""",
    8: """
select o_year, sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume)
       as mkt_share
from (select extract(year from o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount) as volume, n2.n_name as nation
      from part, supplier, lineitem, orders, customer, nation n1, nation n2, region
      where p_partkey = l_partkey and s_suppkey = l_suppkey and l_orderkey = o_orderkey
        and o_custkey = c_custkey and c_nationkey = n1.n_nationkey
        and n1.n_regionkey = r_regionkey and r_name = 'AMERICA'
        and s_nationkey = n2.n_nationkey
        and o_orderdate between date '1995-01-01' and date '1996-12-31'
        and p_type = 'ECONOMY ANODIZED STEEL') as all_nations
group by o_year
order by o_year""",
    9: """
select nation, o_year, sum(amount) as sum_profit
from (select n_name as nation, extract(year from o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey and ps_partkey = l_partkey
        and p_partkey = l_partkey and o_orderkey = l_orderkey and s_nationkey = n_nationkey
        and p_name like '%green%') as profit
group by nation, o_year
order by nation, o_year desc""",
    10: """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue, c_acctbal,
       n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01' and o_orderdate < date '1994-01-01'
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc
limit 20""",
    11: """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
    select sum(ps_supplycost * ps_availqty) * 0.0001
    from partsupp, supplier, nation
    where ps_suppkey = s_suppkey and s_nationkey = n_nationkey and n_name = 'GERMANY')
order by value desc""",
    12: """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
                then 1 else 0 end) as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT' and o_orderpriority <> '2-HIGH'
                then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01' and l_receiptdate < date '1995-01-01'
group by l_shipmode
order by l_shipmode""",
    13: """
select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey)
      from customer left outer join orders
        on c_custkey = o_custkey and o_comment not like '%special%requests%'
      group by c_custkey) as c_orders (c_custkey, c_count)
group by c_count
order by custdist desc, c_count desc""",
    14: """
select 100.00 * sum(case when p_type like 'PROMO%'
                         then l_extendedprice * (1 - l_discount) else 0 end)
       / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01' and l_shipdate < date '1995-10-01'""",
    15: """
with revenue0 as (
    select l_suppkey as supplier_no, sum(l_extendedprice * (1 - l_discount)) as total_revenue
    from lineitem
    where l_shipdate >= date '1996-01-01' and l_shipdate < date '1996-04-01'
    group by l_suppkey)
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue0
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue0)
order by s_suppkey""",
    16: """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%' and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (select s_suppkey from supplier
                         where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size""",
    17: """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey and p_brand = 'Brand#23' and p_container = 'MED BOX'
  and l_quantity < (select 0.2 * avg(l_quantity) from lineitem
                    where l_partkey = p_partkey)""",
    18: """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem group by l_orderkey
                     having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100""",
    19: """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where p_partkey = l_partkey
  and ((p_brand = 'Brand#12' and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
        and l_quantity >= 1 and l_quantity <= 1 + 10 and p_size between 1 and 5
        and l_shipmode in ('AIR', 'REG AIR') and l_shipinstruct = 'DELIVER IN PERSON')
    or (p_brand = 'Brand#23' and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
        and l_quantity >= 10 and l_quantity <= 10 + 10 and p_size between 1 and 10
        and l_shipmode in ('AIR', 'REG AIR') and l_shipinstruct = 'DELIVER IN PERSON')
    or (p_brand = 'Brand#34' and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
        and l_quantity >= 20 and l_quantity <= 20 + 10 and p_size between 1 and 15
        and l_shipmode in ('AIR', 'REG AIR') and l_shipinstruct = 'DELIVER IN PERSON'))""",
    20: """
select s_name, s_address
from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (select p_partkey from part where p_name like 'forest%')
      and ps_availqty > (select 0.5 * sum(l_quantity) from lineitem
                         where l_partkey = ps_partkey and l_suppkey = ps_suppkey
                           and l_shipdate >= date '1994-01-01'
                           and l_shipdate < date '1995-01-01'))
  and s_nationkey = n_nationkey and n_name = 'CANADA'
order by s_name""",
    21: """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey and o_orderstatus = 'F'
  and l1.l_receiptdate > l1.l_commitdate
  and exists (select * from lineitem l2
              where l2.l_orderkey = l1.l_orderkey and l2.l_suppkey <> l1.l_suppkey)
  and not exists (select * from lineitem l3
                  where l3.l_orderkey = l1.l_orderkey and l3.l_suppkey <> l1.l_suppkey
                    and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100""",
    22: """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (select substring(c_phone, 1, 2) as cntrycode, c_acctbal
      from customer
      where substring(c_phone, 1, 2) in ('13', '31', '23', '29', '30', '18', '17')
        and c_acctbal > (select avg(c_acctbal) from customer
                         where c_acctbal > 0.00
                           and substring(c_phone, 1, 2)
                               in ('13', '31', '23', '29', '30', '18', '17'))
        and not exists (select * from orders where o_custkey = c_custkey)) as custsale
group by cntrycode
order by cntrycode""",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_PHASE = {"name": None, "t0": 0.0}


def phase(name: "str | None") -> None:
    """Start phase ``name`` (None: end the last one): the phase before it
    prints its seconds on a line of its own."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"phase seconds: {_PHASE['name']} {now - _PHASE['t0']:.1f} s", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"== {name}", flush=True)


# ---- data ----------------------------------------------------------------------


def tpch_sf1(seed: int, n_orders: int = SF1_ORDERS, n_parts: int = SF1_PARTS,
             n_customers: int = SF1_CUSTOMERS):
    """(lineitem columns, orders columns, {"part", "customer", "nation",
    "region", "supplier"} columns) of every cell, with the value domains of
    the repo's TPC-H generator (benchmarking/tpch/datagen.py: 26-37,
    90-125, 143-190). Dates
    are int32 days; ``l_shipmode``, ``o_orderpriority``, ``l_returnflag``,
    ``l_linestatus``, ``l_shipinstruct``, ``c_mktsegment``, ``p_type``,
    ``p_brand``, ``p_container`` and ``c_nationkey`` are codes into
    SHIPMODES, PRIORITIES, RETURNFLAGS, LINESTATUS, INSTRUCTIONS, SEGMENTS,
    P_TYPES, P_BRANDS, P_CONTAINERS and NATIONS. Each cell's columns are
    drawn after the earlier cells' (the repartition cell's after the first
    cells', then q1's flags, then the join tails' columns and tables, then
    q5's supplier nations), so the earlier cells' data does not depend on
    the later ones. The sizes
    are SF1's unless a test asks for fewer rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    o_orderdate = rng.integers(D_1992, D_1998 - 151, n_orders).astype(np.int32)
    lines_per_order = rng.integers(1, 8, n_orders)
    n_line = int(lines_per_order.sum())
    starts = np.cumsum(lines_per_order) - lines_per_order
    l_orderdate = np.repeat(o_orderdate, lines_per_order)
    lineitem = {
        "l_orderkey": np.repeat(np.arange(1, n_orders + 1, dtype=np.int64),
                                lines_per_order),
        "l_suppkey": rng.integers(1, SF1_SUPPLIERS + 1, n_line).astype(np.int64),
        "l_linenumber": (np.arange(n_line) - np.repeat(starts, lines_per_order)
                         + 1).astype(np.int32),
        "l_shipdate": (l_orderdate + rng.integers(1, 122, n_line)).astype(np.int32),
    }
    lineitem["l_commitdate"] = (l_orderdate + rng.integers(30, 91, n_line)).astype(np.int32)
    lineitem["l_receiptdate"] = (lineitem["l_shipdate"]
                                 + rng.integers(1, 31, n_line)).astype(np.int32)
    lineitem["l_shipmode"] = rng.integers(0, len(SHIPMODES), n_line).astype(np.int8)
    orders = {"o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
              "o_orderpriority": rng.integers(0, len(PRIORITIES),
                                              n_orders).astype(np.int8)}
    lineitem["l_partkey"] = rng.integers(1, n_parts + 1, n_line).astype(np.int64)
    quantity = rng.integers(1, 51, n_line).astype(np.float64)
    lineitem["l_quantity"] = quantity
    lineitem["l_extendedprice"] = np.round(quantity * rng.uniform(900, 2000, n_line) / 10, 2)
    lineitem["l_discount"] = np.round(rng.uniform(0.0, 0.10, n_line), 2)
    lineitem["l_tax"] = np.round(rng.uniform(0.0, 0.08, n_line), 2)
    lineitem["l_returnflag"] = rng.integers(0, len(RETURNFLAGS), n_line).astype(np.int8)
    lineitem["l_linestatus"] = rng.integers(0, len(LINESTATUS), n_line).astype(np.int8)
    # the join tails' (q3, q10, q14, q19): datagen.py:97-113, 143-163, 193
    orders["o_orderdate"] = o_orderdate
    orders["o_custkey"] = rng.integers(1, n_customers + 1, n_orders).astype(np.int64)
    orders["o_shippriority"] = np.zeros(n_orders, dtype=np.int32)
    lineitem["l_shipinstruct"] = rng.integers(0, len(INSTRUCTIONS), n_line).astype(np.int8)
    p_type = (rng.integers(0, len(TYPES_P1), n_parts) * len(TYPES_P2)
              + rng.integers(0, len(TYPES_P2), n_parts)) * len(TYPES_P3) \
        + rng.integers(0, len(TYPES_P3), n_parts)
    part = {"p_partkey": np.arange(1, n_parts + 1, dtype=np.int64),
            "p_type": p_type.astype(np.int16),
            "p_brand": (rng.integers(0, 5, n_parts) * 5
                        + rng.integers(0, 5, n_parts)).astype(np.int8),
            "p_size": rng.integers(1, 51, n_parts).astype(np.int32),
            "p_container": (rng.integers(0, len(CONTAINERS_P1), n_parts) * len(CONTAINERS_P2)
                            + rng.integers(0, len(CONTAINERS_P2), n_parts)).astype(np.int8)}
    ids = np.arange(1, n_customers + 1)
    phone = [rng.integers(lo, hi, n_customers) for lo, hi in
             ((10, 35), (100, 1000), (100, 1000), (1000, 10000))]
    customer = {
        "c_custkey": ids.astype(np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in ids.tolist()], dtype=object),
        "c_address": np.array([f"caddr {i}" for i in range(n_customers)], dtype=object),
        "c_nationkey": rng.integers(0, len(NATIONS), n_customers).astype(np.int64),
        "c_phone": np.array(["-".join(map(str, p)) for p in zip(*(a.tolist() for a in phone))],
                            dtype=object),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_customers), 2),
        "c_mktsegment": rng.integers(0, len(SEGMENTS), n_customers).astype(np.int8),
        "c_comment": np.array([f"customer comment {i}" for i in range(n_customers)],
                              dtype=object)}
    nation = {"n_nationkey": np.arange(len(NATIONS), dtype=np.int64),
              "n_name": np.array(NATIONS, dtype=object),
              "n_regionkey": np.array(NATION_REGIONS, dtype=np.int64)}
    # q5's (datagen.py:115-125): drawn after every earlier cell's columns
    region = {"r_regionkey": np.arange(len(REGIONS), dtype=np.int64),
              "r_name": np.array(REGIONS, dtype=object)}
    supplier = {"s_suppkey": np.arange(1, SF1_SUPPLIERS + 1, dtype=np.int64),
                "s_nationkey": rng.integers(0, len(NATIONS), SF1_SUPPLIERS).astype(np.int64)}
    return lineitem, orders, {"part": part, "customer": customer, "nation": nation,
                              "region": region, "supplier": supplier}


def supplier_query(df):
    from daft_tpu_torch import col, lit

    return (df.where(col("l_shipdate") <= lit(CUTOFF))
            .groupby("l_suppkey")
            .agg(col("l_orderkey").count().alias("n_lines"),
                 col("l_linenumber").sum().alias("sum_linenumber"),
                 col("l_shipdate").min().alias("first_ship"),
                 col("l_shipdate").max().alias("last_ship"),
                 col("l_orderkey").min().alias("first_order"),
                 col("l_orderkey").max().alias("last_order"))
            .sort("l_suppkey"))


def numpy_oracle(cols) -> dict:
    """The query's answer computed with numpy alone."""
    import numpy as np

    keep = cols["l_shipdate"] <= (CUTOFF - EPOCH).days
    supp = cols["l_suppkey"][keep]
    keys, inv = np.unique(supp, return_inverse=True)
    g = len(keys)

    def reduce(ufunc, vals, ident):
        out = np.full(g, ident, dtype=vals.dtype)
        ufunc.at(out, inv, vals)
        return out

    ship, order = cols["l_shipdate"][keep], cols["l_orderkey"][keep]
    line = cols["l_linenumber"][keep].astype(np.int64)
    sum_line = np.zeros(g, dtype=np.int64)
    np.add.at(sum_line, inv, line)

    def dates(days):
        return [EPOCH + datetime.timedelta(days=int(d)) for d in days]

    return {
        "l_suppkey": keys.tolist(),
        "n_lines": np.bincount(inv, minlength=g).tolist(),
        "sum_linenumber": sum_line.tolist(),
        "first_ship": dates(reduce(np.minimum, ship, np.iinfo(np.int32).max)),
        "last_ship": dates(reduce(np.maximum, ship, np.iinfo(np.int32).min)),
        "first_order": reduce(np.minimum, order, np.iinfo(np.int64).max).tolist(),
        "last_order": reduce(np.maximum, order, np.iinfo(np.int64).min).tolist(),
    }


def q12_frames(lineitem, orders):
    """The port's DataFrames of q12: string columns as object arrays."""
    import numpy as np

    import daft_tpu_torch as dt

    modes = np.array(SHIPMODES, dtype=object)
    prios = np.array(PRIORITIES, dtype=object)
    dates = {c: lineitem[c].astype("datetime64[D]")
             for c in ("l_shipdate", "l_commitdate", "l_receiptdate")}
    df_l = dt.from_pydict({"l_orderkey": lineitem["l_orderkey"],
                           "l_shipmode": modes[lineitem["l_shipmode"]], **dates})
    df_o = dt.from_pydict({"o_orderkey": orders["o_orderkey"],
                           "o_orderpriority": prios[orders["o_orderpriority"]]})
    return df_l, df_o


def q12_query(df_l, df_o):
    """TPC-H q12 as benchmarking/tpch/queries.py:220-237 writes it."""
    from daft_tpu_torch import col, lit

    high = col("o_orderpriority").is_in(["1-URGENT", "2-HIGH"])
    return (df_l.where(col("l_shipmode").is_in(["MAIL", "SHIP"])
                       & (col("l_commitdate") < col("l_receiptdate"))
                       & (col("l_shipdate") < col("l_commitdate"))
                       & (col("l_receiptdate") >= lit(Q12_FROM))
                       & (col("l_receiptdate") < lit(Q12_TO)))
            .join(df_o, left_on="l_orderkey", right_on="o_orderkey")
            .with_column("high_line", high.if_else(lit(1), lit(0)))
            .with_column("low_line", (~high).if_else(lit(1), lit(0)))
            .groupby("l_shipmode")
            .agg(col("high_line").sum().alias("high_line_count"),
                 col("low_line").sum().alias("low_line_count"))
            .sort("l_shipmode"))


def q12_keep(lineitem):
    """q12's lineitem predicate in numpy."""
    import numpy as np

    mode = np.array(SHIPMODES)[lineitem["l_shipmode"]]
    receipt = lineitem["l_receiptdate"]
    return (np.isin(mode, ["MAIL", "SHIP"])
            & (lineitem["l_commitdate"] < receipt)
            & (lineitem["l_shipdate"] < lineitem["l_commitdate"])
            & (receipt >= (Q12_FROM - EPOCH).days) & (receipt < (Q12_TO - EPOCH).days))


def q12_high(lineitem, orders):
    """Per lineitem row: its order's priority is 1-URGENT or 2-HIGH
    (o_orderkey is 1..SF1_ORDERS, so the join is an index)."""
    return orders["o_orderpriority"][lineitem["l_orderkey"] - 1] <= 1


def q12_oracle(lineitem, orders) -> dict:
    """q12's answer computed with numpy alone."""
    import numpy as np

    keep = q12_keep(lineitem)
    high = q12_high(lineitem, orders)[keep]
    mode = lineitem["l_shipmode"][keep]
    present = sorted({SHIPMODES[m] for m in np.unique(mode)})
    out = {"l_shipmode": present, "high_line_count": [], "low_line_count": []}
    for name in present:
        rows = mode == SHIPMODES.index(name)
        out["high_line_count"].append(int(np.count_nonzero(high[rows])))
        out["low_line_count"].append(int(np.count_nonzero(~high[rows])))
    return out


# ---- timing --------------------------------------------------------------------


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls after
    a warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, label: str = "") -> float | None:
    """Mean device time of one call: the device activities' own times under
    torch.profiler over ``iters`` calls after a warm-up. Unlike time_ms it
    leaves out the gaps where the card waits for the host to launch: for a
    call whose kernels take less time than its Python wrapper, time_ms
    measures the host. The profiler on the card has been seen to drop a
    call's activities: a capture where some activity did not run a whole
    number of times per call, or none ran, is taken again, up to three
    times; then the time is None, not measured. With a ``label``, print
    each activity's count and mean time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and all(e.count % iters == 0 for e in events):
            break
    else:
        print(f"  {label}: torch.profiler lost device activities three times: not measured "
              "(last capture: " + "; ".join(f"{e.key[:50]} x{e.count}" for e in events) + ")")
        return None
    if label:
        print(f"  {label} device activities over {iters} calls: " + "; ".join(
            f"{e.key[:60]} x{e.count} {e.self_device_time_total / max(e.count, 1):.2f} us"
            for e in events))
    return sum(e.self_device_time_total for e in events) / iters / 1e3


def activity_ms(fn, iters: int) -> float | None:
    """Device time of one call of ``fn``: each device activity's mean time
    over the calls it was seen in, summed, under torch.profiler over
    ``iters`` calls after a warm-up. Where the profiler drops a call's
    activities (it has dropped the first call's of a capture), the means
    still hold; None when it saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
    print("  activities over " f"{iters} calls: " + "; ".join(
        f"{e.key[:50]} x{e.count} {e.self_device_time_total / e.count:.2f} us" for e in events))
    if not events:
        return None
    return sum(e.self_device_time_total / e.count for e in events) / 1e3


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_s(fn, runs: int = 3):
    """Host-clock seconds of ``runs`` calls, each ending in a synchronize."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        _synchronize()
        out.append(time.perf_counter() - t0)
    return out


def plane_case(sk, op: str, planes, codes, cap: int, plain_iters: int = 5) -> dict:
    """K1 (op "sum") or K2 (op "min") on a list of planes at one shape: equal
    to its plain version bit for bit, then the kernel's time by CUDA events
    and on the device (torch.profiler), the plain version's, one library
    call's on the (N, P) stack of the same planes (``index_add_`` or
    ``scatter_reduce_`` into a table with a trash row, which the port never
    calls), and two bounds: ``bound_ms``, what the function needs (the codes,
    the 32-byte sectors of the kept rows' planes, the output: a trash row's
    plane values are never needed), and ``bound_read_once_ms``, every input
    read once and the output written once."""
    import torch

    if op == "sum":
        def call():
            return sk.segment_sum_planes(planes, codes, cap)

        def plain():
            return sk.segment_sum_planes_plain(planes, codes, cap)
    else:
        def call():
            return sk.segment_extreme_planes(planes, codes, cap, op)

        def plain():
            return sk.segment_extreme_planes_plain(planes, codes, cap, op)
    got, want = call(), plain()
    torch.cuda.synchronize()
    n, p = codes.numel(), len(planes)
    kernel = "K1 segment_sum_planes" if op == "sum" else "K2 segment_extreme_planes"
    check(torch.equal(got, want), f"{kernel} at cap {cap}, P {p} differs from its plain "
                                  "version")
    stack = torch.stack(planes, dim=1)
    idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    if op == "sum":
        table = torch.zeros((cap + 1, p), device=codes.device)

        def library():
            return table.index_add_(0, idx, stack)
        out_bytes = cap * p * 8
    else:
        table = torch.full((cap + 1, p), float("inf"), device=codes.device)
        idx = idx[:, None].expand(n, p)

        def library():
            return table.scatter_reduce_(0, idx, stack, "amin")
        out_bytes = cap * p * 4
    kept = (codes >= 0) & (codes < cap)
    sectors = int(kept.view(-1, 8).any(dim=1).sum())  # n is a multiple of 8 here
    result = {
        "cap": cap, "planes": p, "tier": list(sk.segment_planes_tier(cap, min(p, 64))),
        "kept_share": float(kept.float().mean()),
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, 20),
        "device_ms": device_ms(call, 20, f"{kernel} cap {cap} P {p}"),
        "plain_ms": time_ms(plain, plain_iters), "library_ms": time_ms(library, 20),
        "bound_ms": bound_ms(n * 4 + sectors * 32 * p + out_bytes),
        "bound_read_once_ms": bound_ms(n * p * 4 + n * 4 + out_bytes),
    }
    del got, want, stack, table, idx, kept
    return result


def k3_case(sk, v, keep, codes, cap: int, op: str) -> dict:
    """K3 at one shape: equal to its plain version bit for bit, then the
    kernel's, the plain version's and ``scatter_reduce_``'s times and the
    bound (13 bytes read per row, 9 written per segment)."""
    import torch

    gv, gn = sk.segment_extreme_int64(v, keep, codes, cap, op)
    wv, wn = sk.segment_extreme_int64_plain(v, keep, codes, cap, op)
    torch.cuda.synchronize()
    check(torch.equal(gv, wv) and torch.equal(gn, wn),
          f"K3 segment_extreme_int64 ({op}, cap {cap}) differs from its plain version")
    info = torch.iinfo(torch.int64)
    ident = info.max if op == "min" else info.min
    lib_vals = torch.where(keep, v, ident)
    lib_idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    lib_table = torch.full((cap + 1,), ident, dtype=torch.int64, device=v.device)
    reduce = "amin" if op == "min" else "amax"
    n = v.numel()
    return {
        "cap": cap,
        "tier": list(sk.segment_extreme_int64_tier(cap)),
        "max_abs_err": max_abs_err(gv, wv),
        "ms": time_ms(lambda: sk.segment_extreme_int64(v, keep, codes, cap, op), 20),
        "device_ms": device_ms(lambda: sk.segment_extreme_int64(v, keep, codes, cap, op), 20),
        "plain_ms": time_ms(
            lambda: sk.segment_extreme_int64_plain(v, keep, codes, cap, op), 20),
        "library_ms": time_ms(
            lambda: lib_table.scatter_reduce_(0, lib_idx, lib_vals, reduce), 20),
        "bound_ms": bound_ms(n * 8 + n * 1 + n * 4 + cap * 8 + cap * 1),
    }


def k1a_case(sk, stack, codes, cap: int) -> dict:
    """K1a on the (N, P) stack at one shape: equal to its plain version bit
    for bit (integer-valued planes, segment totals below 2^24), then the
    kernel's, the plain version's and ``index_add_``'s times (into a table
    with a trash row, which the port never calls) and two bounds, as
    plane_case's: ``bound_ms``, what the function needs (the codes, the
    32-byte sectors of the stack that the kept rows' floats lie in, the f32
    output), and ``bound_read_once_ms``, every input read once."""
    import torch

    def call():
        return sk.segment_sum_planes_f32(stack, codes, cap)
    got = call()
    want = sk.segment_sum_planes_f32_plain(stack, codes, cap)
    torch.cuda.synchronize()
    n, p = stack.shape
    check(torch.equal(got, want), f"K1a segment_sum_planes_f32 at cap {cap}, P {p} differs "
                                  "from its plain version")
    idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    table = torch.zeros((cap + 1, p), dtype=torch.float32, device=codes.device)
    # the kept rows' byte ranges [r * 4P, (r + 1) * 4P) in 32-byte sectors;
    # two adjacent kept rows may share one
    rows = torch.nonzero((codes >= 0) & (codes < cap)).squeeze(1)
    first, last = (rows * (4 * p)) >> 5, (rows * (4 * p) + 4 * p - 1) >> 5
    sectors = int((last - first + 1).sum()) - int((first[1:] == last[:-1]).sum())
    result = {
        "cap": cap, "planes": p, "kept_share": rows.numel() / n,
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(call, 20),
        "device_ms": device_ms(call, 20, f"K1a cap {cap} P {p}"),
        "plain_ms": time_ms(lambda: sk.segment_sum_planes_f32_plain(stack, codes, cap), 5),
        "library_ms": time_ms(lambda: table.index_add_(0, idx, stack), 20),
        "bound_ms": bound_ms(n * 4 + sectors * 32 + cap * p * 4),
        "bound_read_once_ms": bound_ms(n * p * 4 + n * 4 + cap * p * 4),
    }
    del got, want, idx, table, rows, first, last
    return result


def f64_order_bound(planes, codes, cap: int):
    """Per entry, the worst case of f64 summation in any order: each of a
    segment's n_seg additions rounds by at most 2^-53 of a partial sum, and
    no partial sum exceeds the sum of |v|."""
    import torch

    idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    mags = torch.zeros((cap + 1, len(planes)), dtype=torch.float64, device=codes.device)
    for j, t in enumerate(planes):
        mags[:, j].index_add_(0, idx, t.double().abs())
    n_seg = torch.bincount(idx, minlength=cap + 1).double()[:, None]
    return (n_seg * 2.0 ** -53 * mags)[:cap]


K7_RATE_REPS = 8  # adds per code read when the atomic rate is measured


def k7_atomic_rate(codes, cap: int, nplanes: int, reps: int = K7_RATE_REPS,
                   shared: bool = False) -> dict:
    """The card's rate of f64 atomic adds at one shape (measure/k7_leads.cu
    ``k7_atomic_rate_kernel``): every code in [0, cap) adds 1.0 to its
    row's ``nplanes`` entries of a (cap x nplanes) f64 table, ``reps``
    times (at the code, then at the code shifted by a fixed stride), so the
    adds spread over a table of K7's size as the codes do while each code is
    read once: native reductions into device memory (K7's global tier), or
    with ``shared`` compare-and-swap loops on a table in each block's shared
    memory (K7's block tier). Device ms under torch.profiler, and adds per
    second."""
    import torch

    fn = measure_library().daft_k7_atomic_rate
    out = torch.zeros(cap * nplanes, dtype=torch.float64, device=codes.device)
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    n = codes.numel()

    def call():
        rc = fn(codes.data_ptr(), out.data_ptr(), n, cap, nplanes, reps, int(shared), stream)
        check(rc == 0, f"the atomic rate kernel failed to launch (CUDA error {rc})")
    kept = int(((codes >= 0) & (codes < cap)).sum())
    where = "shared" if shared else "device"
    ms = device_ms(call, 10, f"f64 atomics ({where} memory) cap {cap} P {nplanes} x{reps}")
    adds = kept * nplanes * reps
    return {"cap": cap, "planes": nplanes, "reps": reps, "memory": where, "adds": adds,
            "device_ms": ms, "adds_per_s": None if not ms else adds / (ms / 1e3)}


def k7_case(sk, planes, codes, cap: int, label: str) -> dict:
    """K7 on a list of float planes at one shape: within twice the worst
    case of f64 summation of its plain version (both add in an order of
    their own: the plain version by ``index_add_``'s atomics), then the
    kernel's time by CUDA events and on the device, the plain version's,
    ``index_add_``'s on the (N, P) f64 stack (into a table with a trash row;
    the port never calls it), and the bound: what the function needs (the
    codes, the kept rows' 32-byte sectors of each plane, the f64 output).
    In the global and block tiers also ``bound_atomics_ms``: the call's
    nonzero adds at the card's rate of f64 atomics measured at the same
    shape (k7_atomic_rate), the floor of a design that adds each value by
    an atomic (not of the function)."""
    import torch

    def call():
        return sk.segment_sum_float_planes(planes, codes, cap)

    def plain():
        return sk.segment_sum_float_planes_plain(planes, codes, cap)
    got, want = call(), plain()
    torch.cuda.synchronize()
    n, p = codes.numel(), len(planes)
    err = (got - want).abs()
    check(bool((err <= 2 * f64_order_bound(planes, codes, cap)).all()),
          f"K7 segment_sum_float_planes ({label}) differs from its plain version past the "
          "f64 order bound")
    stack = torch.stack([t.double() for t in planes], dim=1)
    idx = torch.where((codes >= 0) & (codes < cap), codes, cap).long()
    table = torch.zeros((cap + 1, p), dtype=torch.float64, device=codes.device)
    kept = (codes >= 0) & (codes < cap)
    per_sector = 32 // planes[0].element_size()
    sectors = int(kept.view(-1, per_sector).any(dim=1).sum())  # n is a multiple of 8
    result = {
        "cap": cap, "planes": p, "dtype": str(planes[0].dtype).replace("torch.", ""),
        "held": "within twice the f64 order bound of plain",
        "tier": list(sk.segment_sum_float_tier(cap, min(p, sk.PLANE_CHUNK))),
        "kept_share": float(kept.float().mean()),
        "max_abs_err": float(err.max()),
        "ms": time_ms(call, 20),
        "device_ms": device_ms(call, 20, f"K7 {label}"),
        "plain_ms": time_ms(plain, 5),
        "library_ms": time_ms(lambda: table.index_add_(0, idx, stack), 20),
        "bound_ms": bound_ms(n * 4 + sectors * 32 * p + cap * p * 8),
        "bound_read_once_ms": bound_ms(n * 4 + n * p * planes[0].element_size() + cap * p * 8),
    }
    kind, group = result["tier"]
    if kind in ("global", "block"):
        # the call's nonzero adds at the card's atomic rate at this shape:
        # the global tier's into device memory, the block tier's into a
        # table of its group's planes in shared memory (compare-and-swap
        # loops). A floor of a design that adds each value by an atomic, not
        # a bound of the function
        adds = sum(int((kept & (t != 0)).sum()) for t in planes)
        rate = k7_atomic_rate(codes, cap, group if kind == "block" else p,
                              shared=kind == "block")
        result["atomic_rate"] = rate
        result["bound_atomics_ms"] = (adds / rate["adds_per_s"] * 1e3 if rate["adds_per_s"]
                                      else None)
    del got, want, err, stack, idx, table, kept
    return result


def q1_inputs(cols, dev, dtype):
    """q1's codes on ``dev`` (flag x 2 + status where the ship date passes
    q1's predicate, about 98 % of the real rows; trash Q1_CAP elsewhere) and
    its seven sum planes as the stage builds them in ``dtype`` (quantity,
    price, discounted price, charge, and the three means' quantity, price,
    discount), zero on dropped rows."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    keep = cols["l_shipdate"] <= (CUTOFF - EPOCH).days
    codes = torch.full((BUCKET,), Q1_CAP, dtype=torch.int32)
    codes[:n] = torch.from_numpy(np.where(
        keep, cols["l_returnflag"].astype(np.int32) * 2 + cols["l_linestatus"], Q1_CAP)
        .astype(np.int32))

    def plane(values):
        out = torch.zeros(BUCKET, dtype=dtype)
        out[:n] = torch.from_numpy(np.where(keep, values, 0.0)).to(dtype)
        return out.to(dev)

    qty, price = cols["l_quantity"], cols["l_extendedprice"]
    disc, tax = cols["l_discount"], cols["l_tax"]
    disc_price = price * (1 - disc)
    values = [qty, price, disc_price, disc_price * (1 + tax), qty, price, disc]
    return codes.to(dev), [plane(v) for v in values]


def first_occurrence_codes(values):
    """(codes numbering ``values`` in the order of their first occurrence,
    the number of distinct values)."""
    import numpy as np

    _u, first, inverse = np.unique(values, return_index=True, return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inverse.reshape(-1)], len(first)


def partkey_inputs(cols, dev) -> dict:
    """The kernels' inputs in the partkey cell, as its f64 stage builds them
    (ops/grouped_stage.py): codes numbering the parts in the order of their
    first row (the stage's host factorize of an int64 key) at cap 2^18,
    padding rows in the trash segment; K1's rows plane and the three
    aggregations' valid-count planes;
    K2's first-row-index plane; K7's l_extendedprice plane in f64; K3's two
    launches for max(l_quantity): the order-preserving int64 key of its f64
    bits (``_float_extreme``, every real row kept), and the row index over
    the zero rows (none here), whose first row gives a zero result its
    sign."""
    import numpy as np
    import torch

    n = len(cols["l_partkey"])
    keep = torch.zeros(BUCKET, dtype=torch.bool)
    keep[:n] = True
    codes = torch.full((BUCKET,), PARTKEY_CAP, dtype=torch.int32)
    codes[:n] = torch.from_numpy(first_occurrence_codes(cols["l_partkey"])[0].astype(np.int32))
    price = torch.zeros(BUCKET, dtype=torch.float64)
    price[:n] = torch.from_numpy(cols["l_extendedprice"])
    qty = torch.zeros(BUCKET, dtype=torch.float64)
    qty[:n] = torch.from_numpy(cols["l_quantity"])
    bits = (qty + 0.0).view(torch.int64)
    rows = torch.arange(BUCKET, dtype=torch.int64)
    return {"codes": codes.to(dev), "keep": keep.to(dev),
            "planes": [keep.float().to(dev) for _ in range(4)],
            "first": [torch.where(keep, rows.float(), float("inf")).to(dev)],
            "price": [price.to(dev)],
            "qty_key": (bits ^ ((bits >> 63) & 0x7FFF_FFFF_FFFF_FFFF)).to(dev),
            "rows": rows.to(dev), "zero": (keep & (qty == 0)).to(dev)}


def k5_inputs(cols, orders, table, dev) -> dict:
    """K5's inputs on K4's table of orders: lineitem's keys padded to the
    bucket (padding rows invalid), orders' high/low priority planes, and two
    code columns: q12's ship-mode codes (trash where its predicate drops the
    row: 31,585 rows kept) and every real row coded by its ship mode
    (``all_kept``: q12's date and mode predicates dropped, about 6.0 M
    probes that all hit, padding in the trash). The one input function of
    chip_smoke.py and probe_timings.py."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    keys = torch.zeros(BUCKET, dtype=torch.int64)
    keys[:n] = torch.from_numpy(cols["l_orderkey"])
    valid = torch.zeros(BUCKET, dtype=torch.bool)
    valid[:n] = True
    high = orders["o_orderpriority"] <= 1
    planes = torch.from_numpy(np.stack([high, ~high], axis=1).astype(np.float32))
    keep_np, q12 = q12_codes(cols, dev)
    every = torch.full((BUCKET,), Q12_CAP, dtype=torch.int32)
    every[:n] = torch.from_numpy(cols["l_shipmode"].astype(np.int32))
    return {"keys": keys.to(dev), "valid": valid.to(dev), "planes": planes.to(dev),
            "table": table, "codes": {"q12": q12, "all_kept": every.to(dev)},
            "kept": {"q12": int(keep_np.sum()), "all_kept": n}}


def k5_case(pk, inputs: dict, shape: str, cols, orders) -> dict:
    """K5 at one of k5_inputs' shapes, the one timing of K5 both scripts
    use: equal to its plain version bit for bit (integer-valued planes) and
    to a numpy oracle (q12's for MAIL and SHIP; per ship mode for all_kept),
    then its time by CUDA events and on the device (torch.profiler), each
    over 20 calls after a warm-up, the plain version's, and the bound: every
    code read, each kept row's key and validity byte, each distinct kept
    key's 16-byte slot and each distinct matched dim row's P planes (rows
    sorted by order key share them), then the outputs written."""
    import numpy as np
    import torch

    keys, valid, table = inputs["keys"], inputs["valid"], inputs["table"]
    planes, codes = inputs["planes"], inputs["codes"][shape]

    def call():
        return pk.hash_probe_segment_sum(keys, valid, codes, table, planes, Q12_CAP)
    got_s, got_c = call()
    want_s, want_c = pk.hash_probe_segment_sum_plain(keys, valid, codes, table, planes,
                                                     Q12_CAP)
    torch.cuda.synchronize()
    check(torch.equal(got_s, want_s) and torch.equal(got_c, want_c),
          f"K5 hash_probe_segment_sum ({shape}) differs from its plain version")
    high = q12_high(cols, orders)
    if shape == "q12":
        oracle = q12_oracle(cols, orders)
        modes = oracle["l_shipmode"]
        want = {m: (h, lo) for m, h, lo in zip(modes, oracle["high_line_count"],
                                                oracle["low_line_count"])}
    else:
        mode = cols["l_shipmode"]
        modes = SHIPMODES
        want = {m: (int(np.count_nonzero(high[mode == i])),
                    int(np.count_nonzero(~high[mode == i]))) for i, m in enumerate(modes)}
    for m in modes:
        code = SHIPMODES.index(m)
        h, lo = want[m]
        check(got_s[code].tolist() == [h, lo] and got_c[code].item() == h + lo,
              f"K5 ({shape}) {m}: {got_s[code].tolist()} / {got_c[code].item()}, "
              f"the oracle's {h} / {lo}")
    print(f"K5 ({shape}) sums equal the numpy oracle: "
          f"{ {m: got_s[SHIPMODES.index(m)].tolist() for m in modes} }")
    kept, p = inputs["kept"][shape], planes.shape[1]
    inside = (codes >= 0) & (codes < Q12_CAP)
    dim_row = pk.hash_probe_index_plain(keys, valid, table)
    slots = torch.unique(keys[inside & valid]).numel()
    matched = torch.unique(dim_row[inside & (dim_row >= 0)]).numel()
    del inside, dim_row
    result = {
        "cap": Q12_CAP, "planes": p, "kept_rows": kept, "distinct_keys": slots,
        "matched_dim_rows": matched,
        "max_abs_err": max(max_abs_err(got_s, want_s), max_abs_err(got_c, want_c)),
        "ms": time_ms(call, 20),
        "device_ms": device_ms(call, 20, f"K5 {shape}"),
        "plain_ms": time_ms(lambda: pk.hash_probe_segment_sum_plain(
            keys, valid, codes, table, planes, Q12_CAP), 5),
        "library_ms": None,
        "bound_ms": bound_ms(BUCKET * 4 + kept * (8 + 1) + slots * 16 + matched * p * 4
                             + Q12_CAP * p * 8 + Q12_CAP * 8),
    }
    del got_s, got_c, want_s, want_c
    return result


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the entries; equal entries (infinities
    included) count 0."""
    import torch

    diff = (a.double() - b.double()).abs()
    diff = torch.where(a == b, torch.zeros_like(diff), diff)
    return float(diff.max().item()) if diff.numel() else 0.0


# ---- phases --------------------------------------------------------------------


def phase_card():
    import torch

    phase("card")
    check(torch.cuda.is_available(), "no CUDA card: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {card}")
    print(f"torch.cuda.get_device_name(0): {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return card, name


_MEASURE = {}


def measure_library():
    """The library of MEASURE_SOURCE (kernels that only measure; no query
    loads them), built at first use with the package's nvcc flags into
    measure/_kbuild/ (listed in .gitignore) and loaded. Raises when the
    build fails."""
    import ctypes
    import hashlib

    from daft_tpu_torch.ops import _build

    if "lib" in _MEASURE:
        return _MEASURE["lib"]
    src = os.path.join(HERE, MEASURE_SOURCE)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(HERE, "measure", "_kbuild", f"libk7_leads_{digest[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        check(proc.returncode == 0, f"nvcc failed for {MEASURE_SOURCE}: {proc.stderr}")
        os.replace(tmp, out)
        print(f"built {MEASURE_SOURCE}: nvcc {time.perf_counter() - t0:.2f} s")
    lib = ctypes.CDLL(out)
    vp, i32, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.daft_k7_atomic_rate.argtypes = [vp, vp, ll, i32, i32, i32, i32, vp]
    lib.daft_k7_cluster_shape.argtypes = [i32, i32, i32, ctypes.POINTER(i32),
                                          ctypes.POINTER(i32), ctypes.POINTER(ll)]
    lib.daft_k7_cluster.argtypes = [i32, ctypes.POINTER(vp), i32, vp, vp, vp, ll, i32, i32, vp]
    lib.daft_k7_split_blocks.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.daft_k7_split.argtypes = [ctypes.POINTER(vp), i32, vp, vp, vp, ll, i32, i32, i32, i32,
                                  vp]
    for fn in (lib.daft_k7_atomic_rate, lib.daft_k7_cluster_shape, lib.daft_k7_cluster,
               lib.daft_k7_split_blocks, lib.daft_k7_split):
        fn.restype = i32
    _MEASURE["lib"] = lib
    return lib


def phase_build(card: str) -> None:
    import threading

    from daft_tpu_torch.ops import _build, permute_kernels, probe_kernels, segment_kernels

    phase("build")
    t0 = time.perf_counter()
    failed = []

    def build_measure():
        try:
            measure_library()
        except (SmokeFailure, RuntimeError, OSError) as exc:  # raised below, on this thread
            failed.append(exc)
    side = threading.Thread(target=build_measure)
    side.start()
    _build.build_all()
    side.join()
    if failed:
        raise failed[0]
    segment_kernels.build()
    probe_kernels.build()
    permute_kernels.build()
    wall = time.perf_counter() - t0
    for source, info in sorted(_build.BUILD_INFO.items()):
        print(f"built {source}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build wall {wall:.2f} s [{card}]", flush=True)


def slice_inputs(cols, device):
    """The kernels' inputs at the query's shapes and values: codes with
    filtered and padding rows in the trash segment, the 15 sum planes (rows,
    6 counts, 8 digits of l_linenumber) as separate tensors, as the stage
    builds them, and their (N, 15) stack for K1a, the first-row-index plane,
    and the int64 value columns with their keep mask."""
    import numpy as np
    import torch

    n = len(cols["l_suppkey"])
    keep_np = cols["l_shipdate"] <= (CUTOFF - EPOCH).days
    keep = torch.zeros(BUCKET, dtype=torch.bool)
    keep[:n] = torch.from_numpy(keep_np)
    codes = torch.full((BUCKET,), CAP, dtype=torch.int32)
    codes[:n] = torch.from_numpy(np.where(keep_np, cols["l_suppkey"] - 1, CAP)
                                 .astype(np.int32))
    line = torch.zeros(BUCKET, dtype=torch.int64)
    line[:n] = torch.from_numpy(cols["l_linenumber"].astype(np.int64))
    planes = [keep.float() for _ in range(7)] + [((line >> (8 * k)) & 255).float() * keep
                                                 for k in range(8)]
    first = torch.where(keep, torch.arange(BUCKET, dtype=torch.float32),
                        torch.tensor(float("inf")))
    ints = {}
    for name in ("l_orderkey", "l_shipdate"):
        v = torch.zeros(BUCKET, dtype=torch.int64)
        v[:n] = torch.from_numpy(cols[name].astype(np.int64))
        ints[name] = v.to(device)
    planes = [t.to(device) for t in planes]
    return {"codes": codes.to(device), "keep": keep.to(device), "planes": planes,
            "stack": torch.stack(planes, dim=-1), "first": [first.to(device)],
            "ints": ints}


def q12_codes(cols, dev):
    """(q12's lineitem predicate in numpy, the int32[BUCKET] ship-mode codes
    on ``dev`` with dropped and padding rows in the trash segment Q12_CAP)."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    keep_np = q12_keep(cols)
    codes8 = torch.full((BUCKET,), Q12_CAP, dtype=torch.int32)
    codes8[:n] = torch.from_numpy(np.where(keep_np, cols["l_shipmode"], Q12_CAP)
                                  .astype(np.int32))
    return keep_np, codes8.to(dev)


def k4_build_case(pk, dim_keys, label: str, dim_valid=None, slots=None):
    """K4's build over ``dim_keys`` (all valid unless ``dim_valid`` says,
    into ``probe_table_slots``' slots unless ``slots`` says): the table and
    its case, equal to the plain build as the sorted set of its (key, row)
    entries, timed by events (its clearing is part of the build) and on the
    device, beside its bound."""
    import torch

    n = dim_keys.numel()
    if dim_valid is None:
        dim_valid = torch.ones(n, dtype=torch.bool, device=dim_keys.device)
    slots = pk.probe_table_slots(n) if slots is None else slots
    table = pk.build_probe_table(dim_keys, dim_valid, slots)
    plain_table = pk.build_probe_table_plain(dim_keys, dim_valid, slots)
    torch.cuda.synchronize()
    (gk, gr), (wk, wr) = pk.table_entries(table), pk.table_entries(plain_table)
    check(torch.equal(gk, wk) and torch.equal(gr, wr),
          f"K4 build ({label}): the table's (key, row) entries differ from the plain build's")
    print(f"K4 table ({label}): {n} keys, {slots} slots, load {n / slots:.3f}, "
          f"{table.numel() * table.element_size()} bytes")

    def build():
        return pk.build_probe_table(dim_keys, dim_valid, slots)
    case = {
        "max_abs_err": max(max_abs_err(gk, wk), max_abs_err(gr, wr)),
        "ms": time_ms(build, 20),
        "device_ms": device_ms(build, 20, f"K4 build {label}"),
        "plain_ms": time_ms(lambda: pk.build_probe_table_plain(dim_keys, dim_valid, slots), 2),
        "library_ms": None,
        "bound_ms": bound_ms(n * 9 + slots * 12),
        "keys": n, "slots": slots,
    }
    return table, case


def k4_probe_case(pk, keys, valid, table, sorted_keys, label: str):
    """K4's probe of ``keys`` into ``table``: the index and its case, equal
    to the plain probe, timed by events and on the device, beside its bound
    and ``searchsorted``'s time over the sorted dim keys."""
    import torch

    got = pk.hash_probe_index(keys, valid, table)
    want = pk.hash_probe_index_plain(keys, valid, table)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"K4 probe ({label}) differs from its plain version")
    n, slots = keys.numel(), table.shape[0]

    def probe():
        return pk.hash_probe_index(keys, valid, table)
    case = {
        "max_abs_err": max_abs_err(got, want),
        "ms": time_ms(probe, 20),
        "device_ms": device_ms(probe, 20, f"K4 probe {label}"),
        "plain_ms": time_ms(lambda: pk.hash_probe_index_plain(keys, valid, table), 5),
        "library_ms": time_ms(lambda: torch.searchsorted(sorted_keys, keys), 20),
        "bound_ms": bound_ms(n * 8 + n + slots * 12 + n * 4),
    }
    del want
    return got, case


def fact_keys_on(cols, name: str, dev):
    """(int64[BUCKET] keys, bool[BUCKET] valid) of a lineitem key column on
    ``dev``, the padding rows invalid."""
    import torch

    n = len(cols[name])
    keys = torch.zeros(BUCKET, dtype=torch.int64)
    keys[:n] = torch.from_numpy(cols[name])
    valid = torch.zeros(BUCKET, dtype=torch.bool)
    valid[:n] = True
    return keys.to(dev), valid.to(dev)


def probe_cases(pk, cols, orders, dev, results: dict) -> None:
    """K4's build and probe and K5 at q12's shapes, into ``results``: K4
    over orders' keys, every lineitem key probed, then every lineitem key
    shifted past the largest order key, so that every probe walks to an
    empty slot; K5 on K4's table."""
    import torch

    n = len(cols["l_orderkey"])
    dim_keys = torch.from_numpy(orders["o_orderkey"]).to(dev)
    table, results["hash_probe_build"] = k4_build_case(pk, dim_keys, "orders")
    fact_keys, fact_valid = fact_keys_on(cols, "l_orderkey", dev)
    sorted_keys = torch.sort(dim_keys)[0]
    got, results["hash_probe_index"] = k4_probe_case(pk, fact_keys, fact_valid, table,
                                                     sorted_keys, "hits")
    check(torch.equal(got[:n].cpu(), torch.from_numpy(cols["l_orderkey"] - 1).int()),
          "K4 probe: a lineitem row does not find its order")
    got, results["hash_probe_index"]["all_miss"] = k4_probe_case(
        pk, fact_keys + SF1_ORDERS, fact_valid, table, sorted_keys, "all_miss")
    check(bool((got == -1).all()), "K4 probe (all_miss): a shifted key found a row")
    del got, sorted_keys, fact_keys, fact_valid

    # K5 on K4's table at q12's shapes, then with every real row kept
    k5 = k5_inputs(cols, orders, table, dev)
    results["hash_probe_segment_sum"] = k5_case(pk, k5, "q12", cols, orders)
    results["hash_probe_segment_sum"]["all_kept"] = k5_case(pk, k5, "all_kept", cols, orders)
    del table, k5
    torch.cuda.empty_cache()


def part_probe_cases(pk, cols, dims, dev, results: dict) -> None:
    """K4 at q14's and q19's shapes: the build over part's keys and the probe
    of lineitem's l_partkey (every row finds its part)."""
    import torch

    n = len(cols["l_partkey"])
    dim_keys = torch.from_numpy(dims["part"]["p_partkey"]).to(dev)
    table, results["hash_probe_build"]["at_part"] = k4_build_case(pk, dim_keys, "part")
    keys, valid = fact_keys_on(cols, "l_partkey", dev)
    got, results["hash_probe_index"]["at_l_partkey"] = k4_probe_case(
        pk, keys, valid, table, torch.sort(dim_keys)[0], "l_partkey")
    check(torch.equal(got[:n].cpu(), torch.from_numpy(cols["l_partkey"] - 1).int()),
          "K4 probe: a lineitem row does not find its part")
    del table, keys, valid, got
    torch.cuda.empty_cache()


def topn_inputs(cols, orders, dims, dev) -> dict:
    """The join TopN's kernel inputs for q3 at SF1, as the stage builds them:
    the codes (each row's order, q3's groups in first-occurrence order, where
    q3's predicate keeps the row; trash Q3_CAP elsewhere), K1's rows and
    revenue-count planes, K2's first-row-index plane and K7's f32 revenue
    plane; and at the kernels' ceiling 2^22 the same planes over every real
    row, each order's lines spread over four codes."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    customer = dims["customer"]
    cust_ok = customer["c_mktsegment"] == SEGMENTS.index("BUILDING")
    order_ok = cust_ok[orders["o_custkey"] - 1] & (orders["o_orderdate"] < days(Q3_DATE))
    okey = cols["l_orderkey"] - 1
    out = {}
    for label, cap, keep_np, group in (
            ("q3", Q3_CAP, order_ok[okey] & (cols["l_shipdate"] > days(Q3_DATE)), okey),
            ("max", TOPN_CAP, np.ones(n, dtype=bool),
             (okey * 4 + (cols["l_linenumber"] - 1) % 4) % TOPN_CAP)):
        keep = torch.zeros(BUCKET, dtype=torch.bool)
        keep[:n] = torch.from_numpy(keep_np)
        codes = torch.full((BUCKET,), cap, dtype=torch.int32)
        codes[:n] = torch.from_numpy(np.where(keep_np, group, cap).astype(np.int32))
        price = torch.zeros(BUCKET, dtype=torch.float32)
        price[:n] = torch.from_numpy(cols["l_extendedprice"].astype(np.float32))
        disc = torch.zeros(BUCKET, dtype=torch.float32)
        disc[:n] = torch.from_numpy(cols["l_discount"].astype(np.float32))
        kf = keep.float().to(dev)
        out[label] = {
            "cap": cap, "codes": codes.to(dev), "planes": [kf, kf.clone()],
            "first": [torch.where(keep, torch.arange(BUCKET, dtype=torch.float32),
                                  torch.tensor(float("inf"))).to(dev)],
            "revenue": [torch.where(keep, price * (1 - disc), 0.0).to(dev)],
            "keep": keep.to(dev)}
    return out


def q5_inputs(cols, orders, dims, dev) -> dict:
    """q5's kernel inputs at SF1, as its device join run builds them: the
    codes (each row's nation, the dictionary code of n_name, where q5 keeps
    the row: its order in 1994, its customer's nation in ASIA and its
    supplier of that nation; trash Q5_CAP elsewhere), K1's rows and
    revenue-count planes, K2's first-row-index plane and K7's f32 revenue
    plane."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    date = orders["o_orderdate"]
    okey = cols["l_orderkey"] - 1
    nat = dims["customer"]["c_nationkey"][orders["o_custkey"] - 1][okey]
    supp_nat = dims["supplier"]["s_nationkey"][cols["l_suppkey"] - 1]
    keep_np = (((date >= days(Q5_FROM)) & (date < days(Q5_TO)))[okey]
               & (np.array(NATION_REGIONS)[nat] == REGIONS.index("ASIA")) & (supp_nat == nat))
    keep = torch.zeros(BUCKET, dtype=torch.bool)
    keep[:n] = torch.from_numpy(keep_np)
    codes = torch.full((BUCKET,), Q5_CAP, dtype=torch.int32)
    codes[:n] = torch.from_numpy(np.where(keep_np, nat, Q5_CAP).astype(np.int32))
    price = torch.zeros(BUCKET, dtype=torch.float32)
    price[:n] = torch.from_numpy(cols["l_extendedprice"].astype(np.float32))
    disc = torch.zeros(BUCKET, dtype=torch.float32)
    disc[:n] = torch.from_numpy(cols["l_discount"].astype(np.float32))
    kf = keep.float().to(dev)
    return {"cap": Q5_CAP, "codes": codes.to(dev), "planes": [kf, kf.clone()],
            "first": [torch.where(keep, torch.arange(BUCKET, dtype=torch.float32),
                                  torch.tensor(float("inf"))).to(dev)],
            "revenue": [torch.where(keep, price * (1 - disc), 0.0).to(dev)]}


def topn_sf1_inputs(cols, orders, dev) -> dict:
    """The TopN order cell's kernel inputs at SF1 (topn_sf1_query), as its
    TopN run builds them: the codes (each row's customer, numbered in first
    occurrence over lineitem; every real row is kept), K1's eleven planes
    (rows, the valid count of the int64 sum, its eight two's-complement
    digit planes, the valid count of the quantity sum), K2's
    first-row-index plane and K7's f32 quantity plane."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    cust = orders["o_custkey"][cols["l_orderkey"] - 1]
    group, groups = first_occurrence_codes(cust)
    codes = torch.full((BUCKET,), TOPN_SF1_CAP, dtype=torch.int32)
    codes[:n] = torch.from_numpy(group.astype(np.int32))
    keep = torch.zeros(BUCKET, dtype=torch.bool)
    keep[:n] = True
    s = torch.zeros(BUCKET, dtype=torch.int64)
    s[:n] = torch.from_numpy(cols["l_partkey"] - 100_000)
    digits = [torch.where(keep, ((s >> (8 * k)) & 255).to(torch.float32), 0.0)
              for k in range(8)]
    kf = keep.float()
    qty = torch.zeros(BUCKET, dtype=torch.float32)
    qty[:n] = torch.from_numpy(cols["l_quantity"].astype(np.float32))
    return {"cap": TOPN_SF1_CAP, "codes": codes.to(dev),
            "planes": [t.to(dev) for t in [kf, kf] + digits + [kf]],
            "first": [torch.where(keep, torch.arange(BUCKET, dtype=torch.float32),
                                  torch.tensor(float("inf"))).to(dev)],
            "qty": [qty.to(dev)], "groups": groups}


def scan_inputs(cols, orders, dims, dev) -> dict:
    """The kernels' inputs of the first morsel of lineitem read from Parquet
    (its first SCAN_MORSEL_ROWS rows, less those the predicate pushed into
    the reader drops), as the file-fed cells' runs build them: each morsel
    is a dispatch of its own, padded to its own bucket.

    - "q1": the grouped stage's codes (each string key numbered in first
      occurrence within the morsel, radix-combined: flag x 2 + status) at
      cap 8, K1's nine row planes, K2's first-row-index plane and K7's
      seven f32 planes (q1_inputs' values, computed in f32 as the stage
      computes them).
    - "q3": its fallback's grouped join batch: K4's probe of the morsel's
      l_orderkey ("keys", "valid") into the table of the orders that q3's
      date predicate keeps ("dim_keys"; "index", each row's order row or
      -1), the codes (a host factorize of each row's order row and miss
      flag, in first occurrence; trash where the order misses or its
      customer is not in BUILDING) at the cap of the morsel's groups, K1's
      two planes, K2's plane and K7's f32 revenue plane."""
    import numpy as np
    import torch

    from daft_tpu_torch.ops.grouped_stage import _pad_groups
    from daft_tpu_torch.ops.stage import pad_bucket

    rows = slice(0, SCAN_MORSEL_ROWS)

    def planes(n, cap, group, keep_np):
        bucket = pad_bucket(n)
        keep = torch.zeros(bucket, dtype=torch.bool)
        keep[:n] = torch.from_numpy(keep_np)
        codes = torch.full((bucket,), cap, dtype=torch.int32)
        codes[:n] = torch.from_numpy(np.where(keep_np, group, cap).astype(np.int32))
        first = torch.where(keep, torch.arange(bucket, dtype=torch.float32),
                            torch.tensor(float("inf")))
        return bucket, keep, {"cap": cap, "codes": codes.to(dev), "first": [first.to(dev)]}

    # q1: the reader keeps the rows of q1's ship-date predicate
    q1_keep = cols["l_shipdate"][rows] <= (CUTOFF - EPOCH).days
    q1 = {name: v[rows][q1_keep] for name, v in cols.items()}
    n = int(q1_keep.sum())
    flag, k_flag = first_occurrence_codes(q1["l_returnflag"])
    status, k_status = first_occurrence_codes(q1["l_linestatus"])
    bucket, keep, out_q1 = planes(n, _pad_groups(k_flag * k_status), flag * k_status + status,
                                  np.ones(n, dtype=bool))
    kf = keep.float().to(dev)
    out_q1["planes"] = [kf] + [kf.clone() for _ in range(8)]
    qty, price, disc, tax = (torch.from_numpy(q1[c]).float() for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (1 - disc)  # the f32 stage's arithmetic
    out_q1["floats"] = []
    for v in (qty, price, disc_price, disc_price * (1 + tax), qty, price, disc):
        t = torch.zeros(bucket, dtype=torch.float32)
        t[:n] = v
        out_q1["floats"].append(t.to(dev))

    # q3: the reader keeps the rows shipped after Q3_DATE; orders' table
    # holds the orders placed before it
    l_keep = cols["l_shipdate"][rows] > days(Q3_DATE)
    okey = cols["l_orderkey"][rows][l_keep]
    n = len(okey)
    dim_keys = orders["o_orderkey"][orders["o_orderdate"] < days(Q3_DATE)]
    pos = np.full(len(orders["o_orderkey"]) + 1, -1, dtype=np.int64)
    pos[dim_keys] = np.arange(len(dim_keys))
    index = pos[okey]
    miss = index < 0
    gid, groups = first_occurrence_codes(np.maximum(index, 0) * 2 + miss)
    cust_ok = dims["customer"]["c_mktsegment"] == SEGMENTS.index("BUILDING")
    keep_np = ~miss & cust_ok[orders["o_custkey"][okey - 1] - 1]
    bucket, keep, out_q3 = planes(n, _pad_groups(groups), gid, keep_np)
    kf = keep.float().to(dev)
    price = torch.zeros(bucket, dtype=torch.float32)
    price[:n] = torch.from_numpy(cols["l_extendedprice"][rows][l_keep].astype(np.float32))
    disc = torch.zeros(bucket, dtype=torch.float32)
    disc[:n] = torch.from_numpy(cols["l_discount"][rows][l_keep].astype(np.float32))
    keys = torch.zeros(bucket, dtype=torch.int64)
    keys[:n] = torch.from_numpy(okey)
    valid = torch.zeros(bucket, dtype=torch.bool)
    valid[:n] = True
    out_q3.update(planes=[kf, kf.clone()],
                  floats=[torch.where(keep, price * (1 - disc), 0.0).to(dev)],
                  keys=keys.to(dev), valid=valid.to(dev),
                  dim_keys=torch.from_numpy(dim_keys).to(dev),
                  index=torch.from_numpy(index.astype(np.int32)))
    return {"q1": out_q1, "q3": out_q3}


def scan_probe_cases(pk, t: dict, results: dict) -> None:
    """K4 at scan q3's fallback's shapes (scan_inputs' "q3"): the build over
    the orders before Q3_DATE and the probe of the first morsel's keys."""
    import torch

    table, results["hash_probe_build"]["at_scan_q3_orders"] = k4_build_case(
        pk, t["dim_keys"], "scan q3 orders")
    got, results["hash_probe_index"]["at_scan_q3"] = k4_probe_case(
        pk, t["keys"], t["valid"], table, torch.sort(t["dim_keys"])[0], "scan q3 morsel")
    n = t["index"].numel()
    check(torch.equal(got[:n].cpu(), t["index"]) and bool((got[n:] == -1).all()),
          "K4 probe (scan q3): a morsel row does not find its order")
    del table, got
    torch.cuda.empty_cache()


def supplier_probe_cases(pk, cols, dims, dev, results: dict) -> None:
    """K4 at q5's supplier shapes: the build over supplier's 10,000 keys and
    the probe of lineitem's l_suppkey (every row finds its supplier)."""
    import torch

    n = len(cols["l_suppkey"])
    dim_keys = torch.from_numpy(dims["supplier"]["s_suppkey"]).to(dev)
    table, results["hash_probe_build"]["at_supplier"] = k4_build_case(pk, dim_keys,
                                                                      "supplier")
    keys, valid = fact_keys_on(cols, "l_suppkey", dev)
    got, results["hash_probe_index"]["at_l_suppkey"] = k4_probe_case(
        pk, keys, valid, table, torch.sort(dim_keys)[0], "l_suppkey")
    check(torch.equal(got[:n].cpu(), torch.from_numpy(cols["l_suppkey"] - 1).int()),
          "K4 probe: a lineitem row does not find its supplier")
    del table, keys, valid, got
    torch.cuda.empty_cache()


def phase_kernels(cols, orders, dims, card: str):
    import numpy as np
    import torch

    from daft_tpu_torch.ops import grouped_stage
    from daft_tpu_torch.ops import permute_kernels as rk
    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk

    phase("kernels")
    dev = torch.device("cuda")
    x = slice_inputs(cols, dev)
    codes, keep = x["codes"], x["keep"]
    p = x["stack"].shape[1]
    results = {}

    # K1 over the 15 planes; K2 over the first-row-index plane, min
    results["segment_sum_planes"] = plane_case(sk, "sum", x["planes"], codes, CAP)
    results["segment_extreme_planes"] = plane_case(sk, "min", x["first"], codes, CAP)

    # K3: the supplier's four launches (both int64 columns, both ops); the
    # top-level numbers are l_orderkey min's. Then cap 8 (l_shipmode's 7
    # codes: every kept row on 7 addresses) and cap 2^17 (l_partkey folded
    # into 2^17 groups: past one block's shared memory), l_orderkey min.
    # K1 and K2 at both too (cap 8 with 98 % of rows kept, as in TPC-H q1's
    # few groups; cap 2^17 their global tier), and K1 on 73 planes at cap
    # 4096 (l_suppkey folded): past one 64-plane chunk
    cases = {f"{name} {op}": k3_case(sk, v, keep, codes, CAP, op)
             for name, v in x["ints"].items() for op in ("min", "max")}
    orderkey = x["ints"]["l_orderkey"]
    results["segment_extreme_int64"] = {
        **cases["l_orderkey min"],
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "by_column_op": cases}
    rows = len(cols["l_suppkey"])
    k1a_at = {}
    for label, group_np, groups in (
            ("at_cap8", cols["l_shipmode"], K3_SMALL_CAP),
            ("at_cap131072", (cols["l_partkey"] - 1) % K3_LARGE_CAP, K3_LARGE_CAP),
            ("at_cap4096_p73", (cols["l_suppkey"] - 1) % WIDE_CAP, WIDE_CAP)):
        group = torch.full((BUCKET,), groups, dtype=torch.int32)
        group[:rows] = torch.from_numpy(group_np.astype(np.int32))
        codes_k = torch.where(keep, group.to(dev), groups)
        if label == "at_cap4096_p73":
            # 73 distinct planes (copies of the 15): planes that alias would
            # be read from L2, under the bound's bytes
            wide = [x["planes"][j % p].clone() for j in range(WIDE_PLANES)]
            results["segment_sum_planes"][label] = plane_case(sk, "sum", wide, codes_k,
                                                              groups, 2)
            del wide
        else:
            results["segment_extreme_int64"][label] = k3_case(sk, orderkey, keep, codes_k,
                                                              groups, "min")
        if label in ("at_cap8", "at_cap131072"):
            results["segment_sum_planes"][label] = plane_case(sk, "sum", x["planes"], codes_k,
                                                              groups)
            results["segment_extreme_planes"][label] = plane_case(sk, "min", x["first"],
                                                                  codes_k, groups)
            k1a_at[label] = k1a_case(sk, x["stack"], codes_k, groups)
        del group, codes_k

    # K1a: K1's planes, stacked to (N, 15), and codes in one f32 window; the
    # same at cap 8 and cap 2^17 (above)
    results["segment_sum_planes_f32"] = k1a_case(sk, x["stack"], codes, CAP)
    results["segment_sum_planes_f32"].update(k1a_at)
    check(torch.equal(sk.segment_sum_planes_f32(x["stack"], codes, CAP),
                      sk.segment_sum_planes(x["planes"], codes, CAP).float()),
          "K1a segment_sum_planes_f32 differs from K1's output cast to f32")

    # K7: q1's seven f32 planes at cap 8 (about 98 % of real rows kept), the
    # same planes in f64, the supplier's cap with lineitem's four float
    # columns, and cap 2^20 (l_orderkey folded, the stage's ceiling) with
    # K1, K2 and K3 there too
    q1_codes, q1_planes = q1_inputs(cols, dev, torch.float32)
    k7 = results["segment_sum_float_planes"] = k7_case(sk, q1_planes, q1_codes, Q1_CAP,
                                                        "q1 cap 8 f32")
    q1_codes, q1_planes = q1_inputs(cols, dev, torch.float64)
    k7["at_q1_cap8_f64"] = k7_case(sk, q1_planes, q1_codes, Q1_CAP, "q1 cap 8 f64")
    del q1_planes, q1_codes
    floats = []
    for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        t = torch.zeros(BUCKET, dtype=torch.float32)
        t[:rows] = torch.from_numpy(cols[name].astype(np.float32))
        floats.append(torch.where(keep, t.to(dev), 0.0))
    k7["at_supplier_cap16384"] = k7_case(sk, floats, codes, CAP, "supplier cap 16384")
    for small in K7_SMALL_CAPS:  # the warp tier's and the block tier's one-table shapes
        folded = torch.full((BUCKET,), small, dtype=torch.int32)
        folded[:rows] = torch.from_numpy(((cols["l_suppkey"] - 1) % small).astype(np.int32))
        codes_s = torch.where(keep, folded.to(dev), small)
        k7[f"at_cap{small}"] = k7_case(sk, floats, codes_s, small, f"cap {small}")
        del folded, codes_s
    folded = torch.full((BUCKET,), MAX_CAP, dtype=torch.int32)
    folded[:rows] = torch.from_numpy(((cols["l_orderkey"] - 1) % MAX_CAP).astype(np.int32))
    codes_max = torch.where(keep, folded.to(dev), MAX_CAP)
    k7["at_cap1048576"] = k7_case(sk, floats[:2], codes_max, MAX_CAP, "cap 2^20")
    results["segment_sum_planes"]["at_cap1048576"] = plane_case(sk, "sum", x["planes"],
                                                                codes_max, MAX_CAP, 2)
    results["segment_extreme_planes"]["at_cap1048576"] = plane_case(sk, "min", x["first"],
                                                                    codes_max, MAX_CAP, 2)
    results["segment_extreme_int64"]["at_cap1048576"] = k3_case(sk, orderkey, keep,
                                                                codes_max, MAX_CAP, "min")
    del x, orderkey, floats, folded, codes_max
    torch.cuda.empty_cache()

    # the partkey cell's launches at its own inputs (cap 2^18, an f64 stage)
    check(grouped_stage._pad_groups(SF1_PARTS) == PARTKEY_CAP,
          f"the partkey stage pads {SF1_PARTS} groups to {grouped_stage._pad_groups(SF1_PARTS)}, "
          f"not {PARTKEY_CAP}")
    pk_in = partkey_inputs(cols, dev)
    pk_codes = pk_in["codes"]
    results["segment_sum_planes"]["at_partkey_cap262144"] = plane_case(
        sk, "sum", pk_in["planes"], pk_codes, PARTKEY_CAP, 2)
    results["segment_extreme_planes"]["at_partkey_cap262144"] = plane_case(
        sk, "min", pk_in["first"], pk_codes, PARTKEY_CAP, 2)
    k7["at_partkey_cap262144_f64"] = k7_case(sk, pk_in["price"], pk_codes, PARTKEY_CAP,
                                             "partkey cap 2^18 f64")
    results["segment_extreme_int64"]["at_partkey_cap262144_max"] = k3_case(
        sk, pk_in["qty_key"], pk_in["keep"], pk_codes, PARTKEY_CAP, "max")
    results["segment_extreme_int64"]["at_partkey_cap262144_zero_rows"] = k3_case(
        sk, pk_in["rows"], pk_in["zero"], pk_codes, PARTKEY_CAP, "min")
    del pk_in, pk_codes
    torch.cuda.empty_cache()

    # the join TopN's launches: q3's own inputs at its cap 2^21 (the global
    # tiers), and the kernels' ceiling 2^22 (K3 too)
    check(grouped_stage._pad_groups(SF1_ORDERS) == Q3_CAP,
          f"q3's {SF1_ORDERS} orders pad to {grouped_stage._pad_groups(SF1_ORDERS)}, "
          f"not {Q3_CAP}")
    for label, t in topn_inputs(cols, orders, dims, dev).items():
        cap, tcodes = t["cap"], t["codes"]
        at = f"at_{label}_cap{cap}"
        results["segment_sum_planes"][at] = plane_case(sk, "sum", t["planes"], tcodes, cap, 2)
        results["segment_extreme_planes"][at] = plane_case(sk, "min", t["first"], tcodes, cap,
                                                           2)
        k7[at] = k7_case(sk, t["revenue"], tcodes, cap, f"{label} cap {cap}")
        if label == "max":
            okey = torch.zeros(BUCKET, dtype=torch.int64)
            okey[:rows] = torch.from_numpy(cols["l_orderkey"])
            results["segment_extreme_int64"][at] = k3_case(sk, okey.to(dev), t["keep"], tcodes,
                                                           cap, "min")
            del okey
        del t, tcodes
    torch.cuda.empty_cache()

    # q5's launches at its own inputs (25 nations in cap 32: K7's thread
    # tier), and the TopN order cell's (eight int64 digit planes among K1's
    # eleven at cap 2^18, K7 on the quantity plane)
    check(grouped_stage._pad_groups(len(NATIONS)) == Q5_CAP,
          f"q5's {len(NATIONS)} nations pad to {grouped_stage._pad_groups(len(NATIONS))}, "
          f"not {Q5_CAP}")
    t = q5_inputs(cols, orders, dims, dev)
    at = f"at_q5_cap{Q5_CAP}"
    results["segment_sum_planes"][at] = plane_case(sk, "sum", t["planes"], t["codes"], Q5_CAP)
    results["segment_extreme_planes"][at] = plane_case(sk, "min", t["first"], t["codes"],
                                                       Q5_CAP)
    k7[at] = k7_case(sk, t["revenue"], t["codes"], Q5_CAP, f"q5 cap {Q5_CAP}")
    t = topn_sf1_inputs(cols, orders, dev)
    check(grouped_stage._pad_groups(t["groups"]) == TOPN_SF1_CAP,
          f"the TopN order cell's {t['groups']} customers pad to "
          f"{grouped_stage._pad_groups(t['groups'])}, not {TOPN_SF1_CAP}")
    at = f"at_topn_order_cap{TOPN_SF1_CAP}"
    results["segment_sum_planes"][at] = plane_case(sk, "sum", t["planes"], t["codes"],
                                                   TOPN_SF1_CAP, 2)
    results["segment_extreme_planes"][at] = plane_case(sk, "min", t["first"], t["codes"],
                                                       TOPN_SF1_CAP, 2)
    k7[at] = k7_case(sk, t["qty"], t["codes"], TOPN_SF1_CAP, f"topn order cap {TOPN_SF1_CAP}")
    del t
    torch.cuda.empty_cache()

    # W2's launches at its own inputs (the window phase's q98-shaped join
    # aggregate): K4's build over part and probe of every l_partkey, K1, K2
    # and K7 at the brand x type dictionary product's cap 4096
    check(grouped_stage._pad_groups(len(P_BRANDS) * len(P_TYPES)) == W2_CAP,
          f"W2's {len(P_BRANDS)} x {len(P_TYPES)} groups do not pad to {W2_CAP}")
    t = w2_inputs(cols, dims, dev)
    at = f"at_w2_cap{W2_CAP}"
    results["segment_sum_planes"][at] = plane_case(sk, "sum", t["planes"], t["codes"], W2_CAP)
    results["segment_extreme_planes"][at] = plane_case(sk, "min", t["first"], t["codes"],
                                                       W2_CAP)
    k7[at] = k7_case(sk, t["revenue"], t["codes"], W2_CAP, f"w2 cap {W2_CAP}")
    w2_probe = {k: t[k] for k in ("dim_keys", "keys", "valid")}
    del t
    torch.cuda.empty_cache()

    # the file-fed cells' launches at the first lineitem morsel's inputs:
    # scan q1's grouped stage at cap 8, and scan q3's fallback (a grouped
    # join batch: K4's build over the orders before Q3_DATE, its probe of
    # the morsel's keys, K1, K2 and K7 at the morsel's group cap)
    scan = scan_inputs(cols, orders, dims, dev)
    check(scan["q1"]["cap"] == Q1_CAP, f"scan q1's first morsel codes cap {scan['q1']['cap']}, "
                                       f"not {Q1_CAP}")
    for label, t in scan.items():
        at = f"at_scan_{label}_cap{t['cap']}"
        results["segment_sum_planes"][at] = plane_case(sk, "sum", t["planes"], t["codes"],
                                                       t["cap"])
        results["segment_extreme_planes"][at] = plane_case(sk, "min", t["first"], t["codes"],
                                                           t["cap"])
        k7[at] = k7_case(sk, t["floats"], t["codes"], t["cap"], f"scan {label} cap {t['cap']}")
    scan_q3 = scan.pop("q3")
    del scan, t
    torch.cuda.empty_cache()

    # K1 at q12's shapes: 7 ship modes in cap 8, P = 5 planes (kept rows, and
    # the valid count and one digit plane of each CASE-WHEN sum); K2 over the
    # first-row-index plane and the same codes, Q = 1
    n = len(cols["l_orderkey"])
    keep_np, codes8 = q12_codes(cols, dev)
    high_np = q12_high(cols, orders)
    kf = torch.zeros(BUCKET)
    kf[:n] = torch.from_numpy(keep_np.astype(np.float32))
    hf = torch.zeros(BUCKET)
    hf[:n] = torch.from_numpy(high_np.astype(np.float32))
    planes8 = [t.to(dev) for t in (kf, kf, kf * hf, kf, kf * (1 - hf))]
    first8 = torch.where(torch.from_numpy(np.pad(keep_np, (0, BUCKET - n))),
                         torch.arange(BUCKET, dtype=torch.float32),
                         torch.tensor(float("inf"))).to(dev)
    results["segment_sum_planes"]["at_q12_cap8"] = plane_case(sk, "sum", planes8, codes8,
                                                              Q12_CAP)
    results["segment_extreme_planes"]["at_q12_cap8"] = plane_case(sk, "min", [first8], codes8,
                                                                  Q12_CAP, 20)
    del planes8, first8

    del codes8
    probe_cases(pk, cols, orders, dev, results)
    part_probe_cases(pk, cols, dims, dev, results)
    table, results["hash_probe_build"]["at_w2_part"] = k4_build_case(
        pk, w2_probe["dim_keys"], "w2 part")
    _got, results["hash_probe_index"]["at_w2_l_partkey"] = k4_probe_case(
        pk, w2_probe["keys"], w2_probe["valid"], table, torch.sort(w2_probe["dim_keys"])[0],
        "w2 l_partkey")
    del w2_probe, table, _got
    torch.cuda.empty_cache()
    supplier_probe_cases(pk, cols, dims, dev, results)
    scan_probe_cases(pk, scan_q3, results)
    del scan_q3

    # K6 at the repartition cell's shapes: 8 x 8 blocks of 23 x 2^20 + 4
    # words (7 eight-byte planes, 1 four-byte plane, 8 validity planes, the
    # counts and the alignment pad)
    w = 23 * (1 << 20) + 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    send = torch.randint(-2**31, 2**31 - 1, (MESH, MESH, w), dtype=torch.int32,
                         device=dev, generator=gen)
    got = rk.ring_permute_words(send)
    want = rk.ring_permute_words_plain(send)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "K6 ring_permute_words differs from its plain version")
    del got, want
    results["ring_permute_words"] = {
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: rk.ring_permute_words(send), 20),
        "device_ms": device_ms(lambda: rk.ring_permute_words(send), 5),
        "plain_ms": time_ms(lambda: rk.ring_permute_words_plain(send), 5),
        "library_ms": time_ms(lambda: send.transpose(0, 1).contiguous(), 20),
        "bound_ms": bound_ms(2 * send.numel() * 4),
    }
    k6 = results["ring_permute_words"]
    k6["share_of_memory_rate"] = k6["bound_ms"] / k6["ms"]
    del send
    torch.cuda.empty_cache()

    print_cases(results, card)
    return results


def print_cases(results: dict, card: str) -> None:
    """One line per case: the top-level one of each kernel, then its other
    shapes."""
    def fmt(v):
        return "null" if v is None else f"{v:.4f}"

    rows = []
    for kname, r in results.items():
        rows.append((kname, r))
        for label, sub in r.items():
            if label == "by_column_op":
                rows += [(f"{kname} {case}", c) for case, c in sub.items()]
            elif isinstance(sub, dict) and "max_abs_err" in sub:
                rows.append((f"{kname} {label}", sub))
    for name, r in rows:
        shape = f" cap {r['cap']}" if "cap" in r else ""
        shape += f" P {r['planes']}" if "planes" in r else ""
        tier = f" tier {r['tier']}" if r.get("tier") else ""
        dev = f" (device {fmt(r['device_ms'])})" if "device_ms" in r else ""
        once = (f", bound_read_once_ms {fmt(r['bound_read_once_ms'])}"
                if "bound_read_once_ms" in r else "")
        # the share against the kernel's own device time where it was taken:
        # the events also hold the wrapper's host time
        held, by = ((r["device_ms"], "device") if r.get("device_ms")
                    else (r["ms"], "kernel_ms"))
        against = r.get("held", "identical to plain")
        if r.get("atomic_rate"):
            rate = r["atomic_rate"]
            once += (f", bound_atomics_ms {fmt(r['bound_atomics_ms'])} ({rate['adds']} f64 "
                     f"atomics in {rate['memory']} memory in {fmt(rate['device_ms'])} ms: the "
                     "floor of adding each value by an atomic)")
        print(f"{name}:{shape}{tier} {against} (max_abs_err {r['max_abs_err']}); "
              f"kernel_ms {fmt(r['ms'])}{dev}, plain_ms {fmt(r['plain_ms'])}, "
              f"library_ms {fmt(r['library_ms'])}, bound_ms {fmt(r['bound_ms'])}{once} "
              f"(bytes at 3.35 TB/s; {by} at {r['bound_ms'] / held:.1%} of bound_ms) "
              f"[{card}]", flush=True)


def phase_slice(cols, card: str):
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase("slice")
    data = {k: cols[k] for k in ("l_orderkey", "l_suppkey", "l_linenumber")}
    data["l_shipdate"] = cols["l_shipdate"].astype("datetime64[D]")
    df = dt.from_pydict(data)
    print(f"lineitem SF1: {len(cols['l_suppkey'])} rows, seed {SEED}", flush=True)

    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        got = supplier_query(df).to_pydict()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        snap = counters.snapshot()
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        warm = time_s(lambda: supplier_query(df).to_pydict())
        peak = torch.cuda.max_memory_allocated()
    print(f"device run counters: {json.dumps(snap, sort_keys=True)}")
    check(snap["device_grouped_batches"] >= 1, "no device grouped batch in the query")
    check(snap["device_fallbacks"] == 0, "the device stage fell back to the host")
    for k in counters.SEGMENT_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the query")

    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        host = supplier_query(df).to_pydict()
        host_s = time.perf_counter() - t0
    oracle = numpy_oracle(cols)
    n_groups = len(got["l_suppkey"])
    check(n_groups == SF1_SUPPLIERS, f"{n_groups} groups, expected {SF1_SUPPLIERS}")
    check(got == host, "device result differs from the port's host path")
    check(got == oracle, "device result differs from the numpy oracle")
    check(all(isinstance(v, int) for v in got["n_lines"]), "counts are not ints")
    check(int(np.sum(got["n_lines"])) == int(np.count_nonzero(
        cols["l_shipdate"] <= (CUTOFF - EPOCH).days)), "counts do not cover the kept rows")
    print(f"result: {n_groups} groups, equal to the host path and the numpy oracle")
    remember("supplier", host_s, warm, host)
    print(f"query cold {cold_s:.3f} s; warm median {statistics.median(warm):.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in warm)}); host path {host_s:.3f} s; "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)
    plan_ms("supplier", lambda: supplier_query(df), card)
    return df, launches


def port_kernel_names() -> tuple:
    """The names of the port's own CUDA kernels: every ``__global__``
    function in the csrc/*.cu of the daft_tpu_torch imported."""
    import glob
    import re

    from daft_tpu_torch.ops import _build

    names = set()
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            text = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)", "", f.read())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))
    return tuple(sorted(names))


def own_activities(events, names) -> int:
    """How many of the profiler's device activities ran one of ``names``
    (a demangled key holds the name followed by its template or argument
    list)."""
    import re

    pattern = re.compile(r"\b(?:" + "|".join(map(re.escape, names)) + r")[<(]")
    return sum(e.count for e in events if pattern.search(e.key))


def phase_profile(run, card: str, name: str = "profile", host_ops: bool = True,
                  **cfg) -> None:
    """One warm device run of ``run()`` under torch.profiler: device busy
    time (the sum of the device activities' own times), the run's wall time
    under the profiler, the idle share, and the device activities that took
    longest. ``cfg`` adds to the execution config. The profiler on the card
    has been seen to lose a run's activities: each kernel launch the run
    counted (ops/counters.py) makes at least one activity of the port's own
    kernels (port_kernel_names), so a capture that holds fewer of those is
    taken again, up to three times, recording the device's activities alone
    (not the host's torch ops, ``host_ops`` False: a long host run's ops
    fill the profiler's buffers), with the activities it holds printed;
    then the phase prints "not measured" in place of a busy time, and the
    last capture's busy time as a lower bound. What follows the profile
    counts to the phase it interrupted again ("... (continued)")."""
    resume = _PHASE["name"]
    try:
        _profile_run(run, card, name, host_ops, **cfg)
    finally:
        if resume is not None:
            phase(resume.removesuffix(" (continued)") + " (continued)")


def _profile_run(run, card: str, name: str, host_ops: bool, **cfg) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase(name)
    names = port_kernel_names()
    for attempt in range(1, 4):
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops \
            else [ProfilerActivity.CUDA]
        with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on", **cfg):
            counters.reset()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            snap = counters.snapshot()
        launches = sum(snap[f"launches_{k}"] for k in counters.KERNEL_NAMES)
        # device-side activities only (kernels, copies): the CPU op that
        # launched a kernel carries the same device time again
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        own = own_activities(events, names)
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if busy_ms > 0 and own >= launches:
            break
        print(f"  capture {attempt} ({'host and device' if host_ops else 'device'} "
              f"activities): {own} activities of the port's kernels for {launches} counted "
              f"launches: taken again, device activities alone; it held: " + "; ".join(
                  f"{e.key[:60]} x{e.count}" for e in events))
        host_ops = False
    else:
        # every capture missed a launch: the last one's busy time is a lower
        # bound, short of the missing launches' own time
        print(f"warm run under the profiler: wall {wall_ms:.3f} ms, device busy not measured "
              f"(torch.profiler lost the run's activities three times; the last capture "
              f"holds {busy_ms:.3f} ms, idle share at most {1 - busy_ms / wall_ms:.4f}, "
              f"with {launches - own} of the port's {launches} launches missing) [{card}]")
        sys.stdout.flush()
        return
    print(f"warm run under the profiler: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}; {own} activities of "
          f"the port's kernels, {launches} counted launches [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms x{e.count}: {e.key[:90]}")
    sys.stdout.flush()


def phase_q12(lineitem, orders, card: str, sql_tables: dict):
    """TPC-H q12 at SF1 on the card: the cold run (counted), the host path,
    the numpy oracle, the warm runs, peak memory. Returns (the query as a
    callable, the cold run's launches); its tables go into ``sql_tables``
    (so for the q1, q6 and q5 phases)."""
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase("q12")
    t0 = time.perf_counter()
    df_l, df_o = q12_frames(lineitem, orders)
    print(f"lineitem {len(lineitem['l_orderkey'])} rows, orders {SF1_ORDERS} rows: "
          f"frames {time.perf_counter() - t0:.2f} s", flush=True)

    def query():
        return q12_query(df_l, df_o)

    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        got = query().to_pydict()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        snap = counters.snapshot()
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        counters.reset()
        warm = time_s(lambda: query().to_pydict())
        warm_snap = counters.snapshot()
        peak = torch.cuda.max_memory_allocated()
    print(f"cold run counters: {json.dumps(snap, sort_keys=True)}")
    print(f"warm runs counters (3 runs): {json.dumps(warm_snap, sort_keys=True)}")
    check(snap["device_join_batches"] >= 1, "no device join batch in q12")
    check(snap["device_fallbacks"] == 0, "the join stage fell back to the host")
    for k in ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
              "segment_extreme_planes"):
        check(launches[k] > 0, f"kernel {k} was not launched by q12")
    check(warm_snap["device_join_batches"] == 3 and warm_snap["device_fallbacks"] == 0,
          "a warm q12 run left the device join path")
    check(warm_snap["launches_hash_probe_index"] == 0
          and warm_snap["launches_hash_probe_build"] == 0,
          "a warm q12 run probed again: the index plane is not resident")

    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        host = query().to_pydict()
        host_s = time.perf_counter() - t0
    oracle = q12_oracle(lineitem, orders)
    check(got == host, "q12 on the card differs from the port's host path")
    check(got == oracle, "q12 on the card differs from the numpy oracle")
    check(got["l_shipmode"] == ["MAIL", "SHIP"], f"q12 groups {got['l_shipmode']}")
    check(all(isinstance(v, int) for v in got["high_line_count"] + got["low_line_count"]),
          "q12 counts are not ints")
    print(f"result: {json.dumps(got)}, equal to the host path and the numpy oracle")
    remember("q12", host_s, warm, host)
    print(f"q12 cold {cold_s:.3f} s; warm median {statistics.median(warm):.4f} s "
          f"(runs {', '.join(f'{w:.4f}' for w in warm)}); host path {host_s:.3f} s; "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)
    plan_ms("q12", query, card)
    sql_tables["q12"] = {"lineitem": df_l, "orders": df_o}
    return query, launches


def clear_residency() -> None:
    """Drop the earlier cells' resident planes, so that a cell's peak
    memory is its own."""
    import torch

    import daft_tpu_torch.device.residency as residency

    residency.manager().clear()
    torch.cuda.empty_cache()


def q1_frame(lineitem):
    """The port's DataFrame of q1's columns: flags and statuses as object
    arrays of strings, dates as days."""
    import numpy as np

    import daft_tpu_torch as dt

    return dt.from_pydict({
        "l_returnflag": np.array(RETURNFLAGS, dtype=object)[lineitem["l_returnflag"]],
        "l_linestatus": np.array(LINESTATUS, dtype=object)[lineitem["l_linestatus"]],
        **{c: lineitem[c] for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax")},
        "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]"),
    })


def q1_query(df, extremes: bool = False):
    """TPC-H q1 as benchmarking/tpch/queries.py:19-35 writes it; with
    ``extremes``, l_extendedprice's min and max too (a stage in f64)."""
    from daft_tpu_torch import col, lit

    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    aggs = [col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            disc_price.sum().alias("sum_disc_price"),
            (disc_price * (1 + col("l_tax"))).sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order")]
    if extremes:
        aggs += [col("l_extendedprice").min().alias("min_price"),
                 col("l_extendedprice").max().alias("max_price")]
    return (df.where(col("l_shipdate") <= lit(CUTOFF))
            .groupby("l_returnflag", "l_linestatus").agg(*aggs)
            .sort(["l_returnflag", "l_linestatus"]))


Q1_FLOATS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
             "avg_price", "avg_disc")


def q1_oracle(cols, extremes: bool = False) -> dict:
    """q1's answer computed with numpy alone, in f64."""
    import numpy as np

    keep = cols["l_shipdate"] <= (CUTOFF - EPOCH).days
    code = cols["l_returnflag"][keep].astype(np.int64) * 2 + cols["l_linestatus"][keep]
    qty, price = cols["l_quantity"][keep], cols["l_extendedprice"][keep]
    disc, tax = cols["l_discount"][keep], cols["l_tax"][keep]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    groups = sorted((RETURNFLAGS[c // 2], LINESTATUS[c % 2]) for c in np.unique(code))
    out = {k: [] for k in ("l_returnflag", "l_linestatus") + Q1_FLOATS + ("count_order",)}
    if extremes:
        out["min_price"], out["max_price"] = [], []
    for rf, ls in groups:
        rows = code == RETURNFLAGS.index(rf) * 2 + LINESTATUS.index(ls)
        n = int(rows.sum())
        out["l_returnflag"].append(rf)
        out["l_linestatus"].append(ls)
        for name, v in (("sum_qty", qty), ("sum_base_price", price),
                        ("sum_disc_price", disc_price), ("sum_charge", charge)):
            out[name].append(float(v[rows].sum()))
        for name, v in (("avg_qty", qty), ("avg_price", price), ("avg_disc", disc)):
            out[name].append(float(v[rows].sum()) / n)
        out["count_order"].append(n)
        if extremes:
            out["min_price"].append(float(price[rows].min()))
            out["max_price"].append(float(price[rows].max()))
    return out


def same_result(got: dict, want: dict, floats=()) -> bool:
    """Equal column for column: ``floats`` within rtol 1e-5 (the reference's
    own device-vs-host tolerance, tests/test_device_path.py; nulls in the
    same places), the rest exactly (floats bit for bit)."""
    import numpy as np

    if list(got) != list(want) or any(len(got[c]) != len(want[c]) for c in got):
        return False
    for c in got:
        if c in floats:
            g, w = ([np.nan if v is None else v for v in x[c]] for x in (got, want))
            if [v is None for v in got[c]] != [v is None for v in want[c]] or \
                    not np.allclose(np.array(g, dtype=float), np.array(w, dtype=float),
                                    rtol=1e-5, atol=0.0, equal_nan=True):
                return False
        elif [np.float64(v).tobytes() if isinstance(v, float) else v for v in got[c]] != \
                [np.float64(v).tobytes() if isinstance(v, float) else v for v in want[c]]:
            return False
    return True


# what the cells' phases measured, for the auto phase: label -> {"off_ms":
# the host path's run, "on_ms" and "on_what": the card's run, "want": the
# host path's result}
KNOWN = {}


def remember(label: str, host_s: float, warm, host: dict) -> None:
    KNOWN[label] = {"off_ms": host_s * 1e3, "on_ms": statistics.median(warm) * 1e3,
                    "on_what": f"warm median of {len(warm)}", "want": host}


def plan_ms(label: str, query, card: str):
    """optimize() and translate() of one cell's query under the cells'
    config, on the host's clock: the medians of PLANS calls, in ms."""
    from daft_tpu_torch.plan import physical as pp

    opt, tr = [], []
    with dt_ctx():
        frame = query()
        for _ in range(PLANS):
            t0 = time.perf_counter()
            plan = frame.optimized_plan()
            t1 = time.perf_counter()
            pp.translate(plan)
            opt.append(t1 - t0)
            tr.append(time.perf_counter() - t1)
    out = statistics.median(opt) * 1e3, statistics.median(tr) * 1e3
    print(f"{label}: optimize {out[0]:.4f} ms / translate {out[1]:.4f} ms (host clock, "
          f"medians of {PLANS}) [{card}]", flush=True)
    return out


def run_cell(label: str, query, kernels, card: str, floats=(), oracle=None,
             counter: str = "device_grouped_batches", extra_checks=None, host_reasons=(),
             warm_runs: int = 2, captured=None):
    """One query cell on the card: the counters zeroed just before the cold
    run and read just after it, then ``warm_runs`` warm runs (their median,
    counted apart), peak device memory, the host path, and the checks: ``kernels``
    launched, ``counter`` above 0, no fallback, no rejection,
    ``extra_checks(cold counters, warm counters)``, the result equal to the
    host path and ``oracle`` (a callable is called for it just after the
    cold run); a rejection is allowed only for a reason in
    ``host_reasons`` (a part of the plan the cell keeps on the host by
    design). The warm counters carry ``hbm_h2d_bytes``, the bytes the warm
    runs uploaded. ``captured``, a dict, receives the cold run's calls of
    the grouped stage's kernels (``capture_kernel_calls`` over
    GROUPED_WRAPPERS). Returns the cold run's launches."""
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.observability.metrics import registry
    from daft_tpu_torch.ops import counters

    on_card = torch.cuda.is_available()
    with dt_ctx():
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        if captured is None:
            got = query().to_pydict()
        else:
            out = []
            captured.update(capture_kernel_calls(lambda: out.append(query().to_pydict()),
                                                 GROUPED_WRAPPERS))
            got = out[0]
        _synchronize()
        cold_s = time.perf_counter() - t0
        snap = counters.snapshot()
        rejected = dict(counters.rejections)
        launches = {k: snap[f"{CELL_KERNEL_PREFIX}{k}"] for k in counters.KERNEL_NAMES}
        if callable(oracle):
            oracle = oracle()
        counters.reset()
        before = registry().snapshot()
        warm = time_s(lambda: query().to_pydict(), warm_runs)
        warm_snap = counters.snapshot()
        warm_snap["hbm_h2d_bytes"] = registry().diff(before).get("hbm_h2d_bytes", 0)
        warm_snap["warm_runs"] = len(warm)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
    print(f"{label} cold run counters: {json.dumps(snap, sort_keys=True)}")
    check(snap[counter] >= 1, f"{label}: no {counter} in the cold run")
    check(snap["device_fallbacks"] == 0, f"{label}: the stage fell back to the host")
    check(not set(rejected) - set(host_reasons), f"{label}: a stage was refused: {rejected}")
    if rejected:
        print(f"{label}: kept on the host by design: {json.dumps(rejected, sort_keys=True)}")
    for k in kernels:
        check(launches[k] > 0, f"{label}: kernel {k} was not launched")
    if extra_checks is not None:
        print(f"{label} warm runs counters ({len(warm)} runs): "
              f"{json.dumps(warm_snap, sort_keys=True)}")
        extra_checks(snap, warm_snap)
    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        host = query().to_pydict()
        host_s = time.perf_counter() - t0
    check(same_result(got, host, floats), f"{label} on the card differs from the host path")
    if oracle is not None:
        check(same_result(got, oracle, floats), f"{label} on the card differs from the numpy "
                                                "oracle")
    rows = len(next(iter(got.values())))
    print(f"{label}: {rows} result rows, equal to the host path"
          + (" and the numpy oracle" if oracle is not None else ""))
    remember(label, host_s, warm, host)
    plan_ms(label, query, card)
    print(f"{label} cold {cold_s:.3f} s; warm median of {len(warm)} "
          f"{statistics.median(warm):.4f} s "
          f"(runs {', '.join(f'{w:.4f}' for w in warm)}); host path {host_s:.3f} s; "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)
    return got, launches


def phase_q1(lineitem, card: str, sql_tables: dict):
    """TPC-H q1 at SF1 on the card (K7, K1, K2), then q1 with
    l_extendedprice's min and max (an f64 stage: K3 too), each its own
    counted cold run. Returns (the query as a callable, the two runs'
    launches)."""
    phase("q1")
    clear_residency()
    t0 = time.perf_counter()
    df = q1_frame(lineitem)
    print(f"q1 frame {time.perf_counter() - t0:.2f} s", flush=True)
    _got, launches = run_cell(
        "q1", lambda: q1_query(df), ("segment_sum_float_planes", "segment_sum_planes",
                                     "segment_extreme_planes"),
        card, Q1_FLOATS, q1_oracle(lineitem))
    got, launches_f64 = run_cell(
        "q1 with min/max", lambda: q1_query(df, extremes=True),
        ("segment_sum_float_planes", "segment_sum_planes", "segment_extreme_planes",
         "segment_extreme_int64"), card, Q1_FLOATS, q1_oracle(lineitem, extremes=True))
    print(f"q1 result: {json.dumps(got)}")
    sql_tables["q1"] = {"lineitem": df}
    return (lambda: q1_query(df).to_pydict()), launches, launches_f64


def partkey_frame(lineitem):
    import daft_tpu_torch as dt

    return dt.from_pydict({c: lineitem[c] for c in ("l_partkey", "l_extendedprice",
                                                     "l_quantity")})


def partkey_query(df):
    from daft_tpu_torch import col

    return (df.groupby("l_partkey")
            .agg(col("l_extendedprice").sum().alias("revenue"),
                 col("l_partkey").count().alias("lines"),
                 col("l_quantity").max().alias("top_qty"))
            .sort("l_partkey"))


def phase_partkey(lineitem, card: str):
    """groupby(l_partkey) over SF1 lineitem: 200,000 groups at cap 2^18,
    past the kernels' former ceiling of 2^17, in an f64 stage (a float
    max). Also the run's split: the finalize (the one device-to-host copy
    and the host merge of 200,000 groups) against the rest. Returns (the
    query as a callable, the run's launches)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import grouped_stage

    phase("partkey")
    clear_residency()
    df = partkey_frame(lineitem)

    def query():
        return partkey_query(df)

    keys, inv = np.unique(lineitem["l_partkey"], return_inverse=True)
    top = np.full(len(keys), -np.inf)
    np.maximum.at(top, inv, lineitem["l_quantity"])
    oracle = {"l_partkey": keys.tolist(),
              "revenue": np.bincount(inv, weights=lineitem["l_extendedprice"]).tolist(),
              "lines": np.bincount(inv).tolist(), "top_qty": top.tolist()}
    check(len(keys) == SF1_PARTS, f"{len(keys)} parts, expected {SF1_PARTS}")
    _got, launches = run_cell("partkey", query, ("segment_sum_float_planes",
                                                 "segment_sum_planes", "segment_extreme_planes",
                                                 "segment_extreme_int64"),
                              card, ("revenue",), oracle)
    # the split of one warm run: time in finalize against the whole
    spent = []
    finalize = grouped_stage.GroupedAggRun.finalize

    def timed(self):
        t0 = time.perf_counter()
        try:
            return finalize(self)
        finally:
            spent.append(time.perf_counter() - t0)

    grouped_stage.GroupedAggRun.finalize = timed
    try:
        with dt.execution_config_ctx(device="cuda", device_mode="on"):
            wall = time_s(lambda: query().to_pydict(), 1)[0]
    finally:
        grouped_stage.GroupedAggRun.finalize = finalize
    print(f"partkey warm run {wall:.4f} s: finalize (device-to-host copy and host merge of "
          f"{SF1_PARTS} groups) {spent[0]:.4f} s, the rest {wall - spent[0]:.4f} s [{card}]",
          flush=True)
    return (lambda: query().to_pydict()), launches


def q6_query(df):
    """q6 as benchmarking/tpch/queries.py:104-113 writes it."""
    from daft_tpu_torch import col, lit

    return (df.where((col("l_shipdate") >= lit(Q6_FROM)) & (col("l_shipdate") < lit(Q6_TO))
                     & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                     & (col("l_quantity") < 24))
            .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue")))


def q6_frame(lineitem):
    """The port's DataFrame of q6's columns, dates as days."""
    import daft_tpu_torch as dt

    return dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                        "l_discount")},
                           "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})


def phase_q6(lineitem, card: str, sql_tables: dict):
    """TPC-H q6 at SF1 through the ungrouped device stage (DeviceFilterAgg).
    Returns (the query as a callable, the run's launches)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import physical as pp

    phase("q6")
    clear_residency()
    df = q6_frame(lineitem)

    def query():
        return q6_query(df)

    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        plan = pp.translate(query().optimized_plan())
    check(any(isinstance(n, pp.DeviceFilterAgg) for n in plan.walk()),
          "q6 did not plan to the ungrouped device stage")
    ship = lineitem["l_shipdate"]
    keep = ((ship >= (Q6_FROM - EPOCH).days) & (ship < (Q6_TO - EPOCH).days)
            & (lineitem["l_discount"] >= 0.05) & (lineitem["l_discount"] <= 0.07)
            & (lineitem["l_quantity"] < 24))
    oracle = {"revenue": [float((lineitem["l_extendedprice"][keep]
                                 * lineitem["l_discount"][keep]).sum())]}
    got, launches = run_cell("q6", query, (), card, ("revenue",), oracle,
                             counter="device_stage_batches")
    print(f"q6 result: {json.dumps(got)} over {int(keep.sum())} kept rows")
    sql_tables["q6"] = {"lineitem": df}
    return (lambda: query().to_pydict()), launches


# ---- the join tails: TPC-H q14, q19, q3, q10 -------------------------------------


Q3_DATE = datetime.date(1995, 3, 15)
Q10_FROM, Q10_TO = datetime.date(1993, 10, 1), datetime.date(1994, 1, 1)
Q14_FROM, Q14_TO = datetime.date(1995, 9, 1), datetime.date(1995, 10, 1)
Q19_BRANCHES = (  # (brand, containers, quantity from, quantity to, largest size)
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5),
    ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10, 20, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15))


def days(d: datetime.date) -> int:
    return (d - EPOCH).days


def tails_frames(lineitem, orders, dims) -> dict:
    """The port's DataFrames of the join tails' tables: string columns as
    object arrays, dates as days."""
    import numpy as np

    import daft_tpu_torch as dt

    def strings(vocab, codes):
        return np.array(vocab, dtype=object)[codes]

    part, customer, nation = dims["part"], dims["customer"], dims["nation"]
    return {
        "lineitem": dt.from_pydict({
            **{c: lineitem[c] for c in ("l_orderkey", "l_partkey", "l_quantity",
                                        "l_extendedprice", "l_discount")},
            "l_returnflag": strings(RETURNFLAGS, lineitem["l_returnflag"]),
            "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]"),
            "l_shipinstruct": strings(INSTRUCTIONS, lineitem["l_shipinstruct"]),
            "l_shipmode": strings(SHIPMODES, lineitem["l_shipmode"])}),
        "orders": dt.from_pydict({
            "o_orderkey": orders["o_orderkey"], "o_custkey": orders["o_custkey"],
            "o_orderdate": orders["o_orderdate"].astype("datetime64[D]"),
            "o_shippriority": orders["o_shippriority"]}),
        "part": dt.from_pydict({
            "p_partkey": part["p_partkey"], "p_type": strings(P_TYPES, part["p_type"]),
            "p_brand": strings(P_BRANDS, part["p_brand"]), "p_size": part["p_size"],
            "p_container": strings(P_CONTAINERS, part["p_container"])}),
        "customer": dt.from_pydict({
            **customer, "c_mktsegment": strings(SEGMENTS, customer["c_mktsegment"])}),
        "nation": dt.from_pydict(nation),
    }


def q14_query(t):
    """TPC-H q14 as benchmarking/tpch/queries.py:255-264 writes it."""
    from daft_tpu_torch import col, lit

    return (t["lineitem"].where((col("l_shipdate") >= lit(Q14_FROM))
                                & (col("l_shipdate") < lit(Q14_TO)))
            .join(t["part"], left_on="l_partkey", right_on="p_partkey")
            .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
            .with_column("promo", col("p_type").str.startswith("PROMO")
                         .if_else(col("revenue"), lit(0.0)))
            .agg(col("promo").sum().alias("promo_sum"), col("revenue").sum().alias("total_sum"))
            .select((lit(100.0) * col("promo_sum") / col("total_sum")).alias("promo_revenue")))


def q19_query(t):
    """TPC-H q19 as benchmarking/tpch/queries.py:337-355 writes it."""
    from daft_tpu_torch import col

    joined = (t["lineitem"].where(col("l_shipmode").is_in(["AIR", "REG AIR"])
                                  & (col("l_shipinstruct") == "DELIVER IN PERSON"))
              .join(t["part"], left_on="l_partkey", right_on="p_partkey"))
    sm, med, lg = [(col("p_brand") == brand) & col("p_container").is_in(list(containers))
                   & (col("l_quantity") >= lo) & (col("l_quantity") <= hi)
                   & (col("p_size") <= size)
                   for brand, containers, lo, hi, size in Q19_BRANCHES]
    return (joined.where((col("p_size") >= 1) & (sm | med | lg))
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue")))


def q3_query(t):
    """TPC-H q3 as benchmarking/tpch/queries.py:59-72 writes it."""
    from daft_tpu_torch import col, lit

    return (t["customer"].where(col("c_mktsegment") == "BUILDING")
            .join(t["orders"], left_on="c_custkey", right_on="o_custkey")
            .where(col("o_orderdate") < lit(Q3_DATE))
            .join(t["lineitem"], left_on="o_orderkey", right_on="l_orderkey")
            .where(col("l_shipdate") > lit(Q3_DATE))
            .groupby(col("o_orderkey").alias("l_orderkey"), "o_orderdate", "o_shippriority")
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue"))
            .select("l_orderkey", "revenue", "o_orderdate", "o_shippriority")
            .sort(["revenue", "o_orderdate"], desc=[True, False])
            .limit(10))


def q10_query(t):
    """TPC-H q10 as benchmarking/tpch/queries.py:185-199 writes it."""
    from daft_tpu_torch import col, lit

    return (t["orders"].where((col("o_orderdate") >= lit(Q10_FROM))
                              & (col("o_orderdate") < lit(Q10_TO)))
            .join(t["lineitem"].where(col("l_returnflag") == "R"), left_on="o_orderkey",
                  right_on="l_orderkey")
            .join(t["customer"], left_on="o_custkey", right_on="c_custkey")
            .join(t["nation"], left_on="c_nationkey", right_on="n_nationkey")
            .groupby(col("o_custkey").alias("c_custkey"), "c_name", "c_acctbal", "c_phone",
                     "n_name", "c_address", "c_comment")
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue"))
            .select("c_custkey", "c_name", "revenue", "c_acctbal", "n_name", "c_address",
                    "c_phone", "c_comment")
            .sort(["revenue", "c_custkey"], desc=[True, False])
            .limit(20))


def revenue(lineitem):
    return lineitem["l_extendedprice"] * (1 - lineitem["l_discount"])


def q14_oracle(lineitem, orders, dims) -> dict:
    """q14's answer with numpy alone, in f64 (p_partkey is 1..parts, so the
    join is an index)."""
    import numpy as np

    ship = lineitem["l_shipdate"]
    keep = (ship >= days(Q14_FROM)) & (ship < days(Q14_TO))
    promo = np.array([t.startswith("PROMO") for t in P_TYPES])[
        dims["part"]["p_type"][lineitem["l_partkey"][keep] - 1]]
    rev = revenue(lineitem)[keep]
    return {"promo_revenue": [float(100.0 * rev[promo].sum() / rev.sum())]}


def q19_oracle(lineitem, orders, dims) -> dict:
    """q19's answer with numpy alone, in f64 (None where no row is kept)."""
    import numpy as np

    part = dims["part"]
    rows = lineitem["l_partkey"] - 1
    brand = np.array(P_BRANDS, dtype=object)[part["p_brand"]][rows]
    container = np.array(P_CONTAINERS, dtype=object)[part["p_container"]][rows]
    size, qty = part["p_size"][rows], lineitem["l_quantity"]
    mode = lineitem["l_shipmode"]
    keep = ((mode == SHIPMODES.index("AIR")) | (mode == SHIPMODES.index("REG AIR"))) \
        & (lineitem["l_shipinstruct"] == INSTRUCTIONS.index("DELIVER IN PERSON")) & (size >= 1)
    any_branch = np.zeros(len(rows), dtype=bool)
    for b, containers, lo, hi, largest in Q19_BRANCHES:
        any_branch |= ((brand == b) & np.isin(container, containers) & (qty >= lo)
                       & (qty <= hi) & (size <= largest))
    keep &= any_branch
    return {"revenue": [float(revenue(lineitem)[keep].sum()) if keep.any() else None]}


def top_groups(sums, present, tie, k: int):
    """The k groups of largest sum, ties by ascending ``tie``, and the
    relative margin between the k-th and the next sum (None when there is
    no next one)."""
    import numpy as np

    live = np.flatnonzero(present)
    order = live[np.lexsort((tie[live], -sums[live]))]
    top = order[:k]
    margin = (float((sums[order[k - 1]] - sums[order[k]]) / sums[order[k - 1]])
              if len(order) > k else None)
    return top, margin


def q3_oracle(lineitem, orders, dims) -> dict:
    """q3's answer with numpy alone, in f64, and the margin at its limit
    (o_orderkey and c_custkey are 1..n: the joins are indices)."""
    import numpy as np

    customer = dims["customer"]
    cust_ok = customer["c_mktsegment"] == SEGMENTS.index("BUILDING")
    order_ok = cust_ok[orders["o_custkey"] - 1] & (orders["o_orderdate"] < days(Q3_DATE))
    okey = lineitem["l_orderkey"] - 1
    keep = order_ok[okey] & (lineitem["l_shipdate"] > days(Q3_DATE))
    n = len(orders["o_orderkey"])
    sums = np.bincount(okey[keep], weights=revenue(lineitem)[keep], minlength=n)
    present = np.bincount(okey[keep], minlength=n) > 0
    top, margin = top_groups(sums, present, orders["o_orderdate"], 10)
    return {"l_orderkey": orders["o_orderkey"][top].tolist(),
            "revenue": sums[top].tolist(),
            "o_orderdate": [EPOCH + datetime.timedelta(days=int(d))
                            for d in orders["o_orderdate"][top]],
            "o_shippriority": orders["o_shippriority"][top].tolist()}, margin


def q10_oracle(lineitem, orders, dims) -> dict:
    """q10's answer with numpy alone, in f64, and the margin at its limit."""
    import numpy as np

    customer = dims["customer"]
    date = orders["o_orderdate"]
    order_ok = (date >= days(Q10_FROM)) & (date < days(Q10_TO))
    okey = lineitem["l_orderkey"] - 1
    keep = order_ok[okey] & (lineitem["l_returnflag"] == RETURNFLAGS.index("R"))
    cust = orders["o_custkey"][okey[keep]] - 1
    n = len(customer["c_custkey"])
    sums = np.bincount(cust, weights=revenue(lineitem)[keep], minlength=n)
    present = np.bincount(cust, minlength=n) > 0
    top, margin = top_groups(sums, present, customer["c_custkey"], 20)
    names = np.array(NATIONS, dtype=object)[customer["c_nationkey"][top]]
    return {"c_custkey": customer["c_custkey"][top].tolist(),
            "c_name": customer["c_name"][top].tolist(),
            "revenue": sums[top].tolist(),
            "c_acctbal": customer["c_acctbal"][top].tolist(),
            "n_name": names.tolist(),
            "c_address": customer["c_address"][top].tolist(),
            "c_phone": customer["c_phone"][top].tolist(),
            "c_comment": customer["c_comment"][top].tolist()}, margin


# (query, oracle, float columns, a TopN run, the adjacent dim's probe)
TAILS = {"q14": (q14_query, q14_oracle, ("promo_revenue",), False),
         "q19": (q19_query, q19_oracle, ("revenue",), False),
         "q3": (q3_query, q3_oracle, ("revenue",), True),
         "q10": (q10_query, q10_oracle, ("revenue",), True)}


def phase_tail(name: str, frames: dict, lineitem, orders, dims, card: str):
    """One join tail at SF1 on the card: the cold run (counters zeroed just
    before it and read just after), the warm runs, the host path and the
    numpy oracle, with the counters' checks: a device join batch, no
    fallback, one TopN run for q3 and q10, K4's build and probe once on the
    cold run (one adjacent dim each) and never on the warm runs. Returns
    (the query as a callable, the cold run's launches)."""
    from daft_tpu_torch.ops import device_join as dj

    phase(name)
    clear_residency()
    query, oracle, floats, topn = TAILS[name]
    t0 = time.perf_counter()
    want = oracle(lineitem, orders, dims)
    if topn:
        want, margin = want
        print(f"{name} oracle: relative margin between the limit's last revenue and the next "
              f"{margin!r} (the device's f32 products summed in f64 stay within 1e-6 of the "
              "oracle's f64)")
        check(margin is not None and margin > 1e-5,
              f"{name}: the oracle's revenues at the limit are too close to order")
    print(f"{name} oracle {time.perf_counter() - t0:.2f} s", flush=True)

    spent = []
    build = dj._FactorizedCodes.__init__

    def timed(self, *args, **kwargs):
        t1 = time.perf_counter()
        try:
            return build(self, *args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t1)

    def checks(snap, warm):
        check(snap["device_join_batches"] >= 1, f"{name}: no device join batch")
        check(snap["device_topn_runs"] == (1 if topn else 0),
              f"{name}: {snap['device_topn_runs']} device TopN runs")
        for k in ("hash_probe_build", "hash_probe_index"):
            check(snap[f"launches_{k}"] == 1,
                  f"{name}: K4 {k} launched {snap[f'launches_{k}']} times on the cold run, "
                  "expected once (one adjacent dim)")
            check(warm[f"launches_{k}"] == 0, f"{name}: a warm run launched K4 {k}")
        check(warm["device_fallbacks"] == 0
              and warm["device_join_batches"] == warm["warm_runs"],
              f"{name}: a warm run left the device join path")
        check(warm["device_topn_runs"] == (warm["warm_runs"] if topn else 0),
              f"{name}: a warm run left the device TopN")

    kernels = ("hash_probe_build", "hash_probe_index")
    if topn:
        kernels += ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes")
    dj._FactorizedCodes.__init__ = timed
    try:
        got, launches = run_cell(name, lambda: query(frames), kernels, card, floats, want,
                                 counter="device_join_batches", extra_checks=checks)
    finally:
        dj._FactorizedCodes.__init__ = build
    if topn:
        check(len(spent) == 1, f"{name}: {len(spent)} host factorizes over the runs, "
                               "expected one (cached)")
        print(f"{name} cold host factorize of the group keys over "
              f"{len(lineitem['l_orderkey'])} fact rows: {spent[0]:.3f} s [{card}]", flush=True)
    print(f"{name} result: {json.dumps(got, default=str)}")
    return (lambda: query(frames).to_pydict()), launches


# ---- fused regions: q1 and q6 written as chains of derived columns --------------


def q1_chain_query(df):
    """TPC-H q1 as dataframe users write an aggregate: the derived columns
    first (``with_column``), then the filter, then ``groupby``. Composed
    over the scan, its expressions are q1's own."""
    from daft_tpu_torch import col, lit

    return (df.with_column("disc_price", col("l_extendedprice") * (1 - col("l_discount")))
            .with_column("charge", col("disc_price") * (1 + col("l_tax")))
            .where(col("l_shipdate") <= lit(CUTOFF))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_base_price"),
                 col("disc_price").sum().alias("sum_disc_price"),
                 col("charge").sum().alias("sum_charge"),
                 col("l_quantity").mean().alias("avg_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("count_order"))
            .sort(["l_returnflag", "l_linestatus"]))


def q6_chain_query(df):
    """TPC-H q6 with its product written as a column after the filter:
    ``where``, ``with_column("rev", ...)``, ``agg(sum)``."""
    from daft_tpu_torch import col, lit

    return (df.where((col("l_shipdate") >= lit(Q6_FROM)) & (col("l_shipdate") < lit(Q6_TO))
                     & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                     & (col("l_quantity") < 24))
            .with_column("rev", col("l_extendedprice") * col("l_discount"))
            .agg(col("rev").sum().alias("revenue")))


def q6_oracle(cols) -> dict:
    ship = cols["l_shipdate"]
    keep = ((ship >= days(Q6_FROM)) & (ship < days(Q6_TO))
            & (cols["l_discount"] >= 0.05) & (cols["l_discount"] <= 0.07)
            & (cols["l_quantity"] < 24))
    return {"revenue": [float((cols["l_extendedprice"][keep] * cols["l_discount"][keep]).sum())]}


def region_plan_check(label: str, plan, node_type, ops) -> None:
    """The chain planned as one device node of ``node_type`` directly over
    the scan, fusing ``ops``; no host Project or Filter left."""
    from daft_tpu_torch.plan import physical as pp

    nodes = [n for n in plan.walk() if isinstance(n, (pp.DeviceGroupedAgg, pp.DeviceFilterAgg))]
    check(len(nodes) == 1 and isinstance(nodes[0], node_type),
          f"{label}: planned {[type(n).__name__ for n in nodes]}, not one {node_type.__name__}")
    check(isinstance(nodes[0].input, pp.InMemoryScan), f"{label}: the device node is not "
                                                       "over the scan")
    check(not any(isinstance(n, (pp.Project, pp.PhysFilter)) for n in plan.walk()),
          f"{label}: a host Project or Filter is left in the plan")
    check(tuple(nodes[0].region_ops) == ops,
          f"{label}: fused {nodes[0].region_ops}, expected {ops}")
    print(f"{label} plan: one {node_type.__name__} over the scan, fused region "
          f"{'→'.join(ops)}", flush=True)


def count_uploads(run) -> int:
    """The column uploads (``Series.to_device``: a residency miss) one call
    of ``run`` makes."""
    from daft_tpu_torch.core.series import Series

    calls = []
    real = Series.to_device

    def counting(self, *args, **kwargs):
        calls.append(self.name)
        return real(self, *args, **kwargs)

    Series.to_device = counting
    try:
        run()
    finally:
        Series.to_device = real
    return len(calls)


def region_counter_checks(label: str, counter: str, n_ops: int):
    def checks(snap, warm):
        for s, runs in ((snap, 1), (warm, warm["warm_runs"])):
            check(s["device_region_dispatches"] == s[counter] == runs,
                  f"{label}: {s['device_region_dispatches']} region dispatches for "
                  f"{s[counter]} {counter}, expected {runs}")
            check(s["device_region_ops_fused"] == n_ops * runs,
                  f"{label}: {s['device_region_ops_fused']} ops fused, expected "
                  f"{n_ops * runs}")
    return checks


CHAIN_ROUNDS = 3  # interleaved rounds of the chain cells' warm comparison
PLANS = 20        # translate() calls timed per query


def chain_gap(label: str, df, chain, plain, card: str) -> dict:
    """The chain's warm cost beside its plain query's, both over ``df`` in
    one phase: CHAIN_ROUNDS interleaved rounds of (the plain query, the
    fused chain, the chain under region_mode="off", whose Projects and
    deeper Filters run as host operators in front of the device stage),
    each run ending in a synchronize; then, on the host's clock, the median
    of building each query's DataFrame and of translate() over it (PLANS
    calls each). Returns the medians in ms."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import physical as pp

    runs = {"plain": [], "fused": [], "unfused": []}
    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        for _ in range(CHAIN_ROUNDS):
            for name, q, mode in (("plain", plain, "on"), ("fused", chain, "on"),
                                  ("unfused", chain, "off")):
                with dt.execution_config_ctx(region_mode=mode):
                    runs[name] += time_s(lambda q=q: q(df).to_pydict(), 1)
        out = {f"{k}_warm_ms": statistics.median(v) * 1e3 for k, v in runs.items()}
        for name, q in (("plain", plain), ("fused", chain)):
            build, plan = [], []
            for _ in range(PLANS):
                t0 = time.perf_counter()
                frame = q(df)
                t1 = time.perf_counter()
                pp.translate(frame.optimized_plan())
                plan.append(time.perf_counter() - t1)
                build.append(t1 - t0)
            out[f"{name}_build_ms"] = statistics.median(build) * 1e3
            out[f"{name}_translate_ms"] = statistics.median(plan) * 1e3
    print(f"{label} beside its plain query ({CHAIN_ROUNDS} interleaved rounds, medians): "
          f"warm plain {out['plain_warm_ms']:.4f} ms, fused chain {out['fused_warm_ms']:.4f} "
          f"ms, unfused chain (region_mode=\"off\") {out['unfused_warm_ms']:.4f} ms; "
          f"DataFrame build plain {out['plain_build_ms']:.4f} ms, chain "
          f"{out['fused_build_ms']:.4f} ms; translate() plain {out['plain_translate_ms']:.4f} "
          f"ms, chain {out['fused_translate_ms']:.4f} ms (host clock) [{card}]", flush=True)
    return out


def phase_q1_chain(lineitem, q1_result: dict, card: str):
    """q1 written as a chain (q1_chain_query) at SF1: planned as one
    DeviceGroupedAgg over the scan fusing filter, project, project and agg
    (the optimizer moves the Filter under the Projects);
    the region counters of the cold and warm runs; a warm run uploads
    nothing; the result equal, bit for bit, to the q1 cell's. Also the
    device time of one evaluation of the projected ``disc_price``, which
    the composed program evaluates twice (under sum_disc_price and inside
    charge), as q1's own expressions do: what a CSE would save. Returns (the
    query as a callable, the cold run's launches)."""
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import device_eval
    from daft_tpu_torch.plan import physical as pp
    from daft_tpu_torch.utils.torch_setup import resolve_device

    phase("q1 chain")
    clear_residency()
    df = q1_frame(lineitem)
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        plan = pp.translate(q1_chain_query(df).optimized_plan())
    region_plan_check("q1 chain", plan, pp.DeviceGroupedAgg,
                      ("filter", "project", "project", "agg"))
    node = next(n for n in plan.walk() if isinstance(n, pp.DeviceGroupedAgg))
    got, launches = run_cell(
        "q1 chain", lambda: q1_chain_query(df),
        ("segment_sum_float_planes", "segment_sum_planes", "segment_extreme_planes"), card,
        Q1_FLOATS, q1_oracle(lineitem),
        extra_checks=region_counter_checks("q1 chain", "device_grouped_batches", 4))
    check(same_result(got, q1_result), "q1 chain differs from the q1 cell's result")
    print("q1 chain: equal bit for bit to the q1 cell's result")
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        uploads = count_uploads(lambda: q1_chain_query(df).to_pydict())
    check(uploads == 0, f"q1 chain: a warm run uploaded {uploads} columns")
    print("q1 chain warm run: 0 column uploads (every plane resident)")
    chain_gap("q1 chain", df, q1_chain_query, q1_query, card)

    # the projected expression the substitution copies
    disc = next(e for e in node.aggregations if e.name() == "sum_disc_price").child.child
    copies = sum(repr(sub) == repr(disc) for e in node.aggregations for sub in e.walk())
    batch = df._plan.partitions[0].batches[0]
    with dt_ctx():
        dev = resolve_device(dt.execution_config().device)
    cols = {c: batch.get_column(c).to_device_cached(BUCKET, f32=True, device=dev)
            for c in disc.referenced_columns()}
    fn = device_eval.build_device_expr(disc, df.schema, float_dtype=torch.float32)
    one = activity_ms(lambda: fn(cols, dev), 20)
    events_ms = time_ms(lambda: fn(cols, dev), 20)
    print(f"q1 chain: the composed program evaluates {disc!r} {copies} times (q1's own "
          f"expressions too); one evaluation over the {BUCKET}-row bucket takes "
          f"{'not measured' if one is None else f'{one:.4f} ms'} on the device (each "
          f"activity's mean, summed), {events_ms:.4f} ms by CUDA events (host launch "
          f"gaps included): what a CSE would save a run [{card}]", flush=True)
    return (lambda: q1_chain_query(df).to_pydict()), launches


def phase_q6_chain(lineitem, q6_result: dict, card: str):
    """q6 written as a chain (q6_chain_query) at SF1: one DeviceFilterAgg
    over the scan fusing filter, project and agg; its region counters; the
    result equal to the q6 cell's (rtol 1e-5) and the oracle. Returns (the
    query as a callable, the cold run's launches)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import physical as pp

    phase("q6 chain")
    clear_residency()
    df = dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                      "l_discount")},
                         "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        plan = pp.translate(q6_chain_query(df).optimized_plan())
    region_plan_check("q6 chain", plan, pp.DeviceFilterAgg, ("filter", "project", "agg"))
    got, launches = run_cell(
        "q6 chain", lambda: q6_chain_query(df), (), card, ("revenue",), q6_oracle(lineitem),
        counter="device_stage_batches",
        extra_checks=region_counter_checks("q6 chain", "device_stage_batches", 3))
    check(same_result(got, q6_result, ("revenue",)), "q6 chain differs from the q6 cell's result")
    print(f"q6 chain result: {json.dumps(got)}, the q6 cell's {json.dumps(q6_result)}")
    chain_gap("q6 chain", df, q6_chain_query, q6_query, card)
    return (lambda: q6_chain_query(df).to_pydict()), launches


# ---- TPC-H in SQL over the DataFrame cells' tables --------------------------------


SQL_CELLS = {  # TPC-H query -> (the DataFrame cell's tables, its query, its float columns)
    1: ("q1", lambda t: q1_query(t["lineitem"]), Q1_FLOATS),
    6: ("q6", lambda t: q6_query(t["lineitem"]), ("revenue",)),
    3: ("tails", lambda t: q3_query(t), ("revenue",)),
    5: ("q5", lambda t: q5_query(t), ("revenue",)),
    12: ("q12", lambda t: q12_query(t["lineitem"], t["orders"]), ()),
    14: ("tails", lambda t: q14_query(t), ("promo_revenue",)),
    19: ("tails", lambda t: q19_query(t), ("revenue",)),
}


def sql_counts(text: str, tables: dict, df_query):
    """The counted runs of one SQL cell under the current config: one run of
    the DataFrame form (after one more that warms the shared tables) and the
    column uploads of one more, then the SQL form's first run, its three warm
    runs and the uploads of one more, each run counted from zero. Each form's
    uploads are read straight after its own runs: the two forms' hoisted
    columns may share a residency slot by name, so a run of one after the
    other rebuilds them. Returns (the DataFrame form's result, the SQL
    form's, the DataFrame run's counters, the SQL first run's, the SQL warm
    runs', the SQL first run's seconds, the warm runs' seconds, the
    DataFrame form's warm uploads, the SQL form's)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    def stage_counts():
        # the stages' and kernels' counters: the residency's and the scan's
        # depend on which form ran first (the hoisted columns share slots)
        return {k: v for k, v in counters.snapshot().items()
                if not k.startswith(("hbm_", "scan_")) and k != "fingerprint_ms"}

    want = df_query(tables).to_pydict()
    counters.reset()
    df_query(tables).to_pydict()
    df_snap = stage_counts()
    df_uploads = count_uploads(lambda: df_query(tables).to_pydict())
    counters.reset()
    t0 = time.perf_counter()
    got = dt.sql(text, **tables).to_pydict()
    _synchronize()
    first_s = time.perf_counter() - t0
    snap = stage_counts()
    counters.reset()
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        dt.sql(text, **tables).to_pydict()
        _synchronize()
        warm.append(time.perf_counter() - t0)
    warm_snap = stage_counts()
    uploads = count_uploads(lambda: dt.sql(text, **tables).to_pydict())
    return want, got, df_snap, snap, warm_snap, first_s, warm, df_uploads, uploads


def _synchronize() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def phase_sql(sql_tables: dict, card: str) -> dict:
    """TPC-H q1, q6, q3, q5, q12, q14 and q19 in SQL (TPCH_SQL) at SF1 over
    the tables their DataFrame cells ran over (``sql_tables``, by cell),
    bound by name, so the two forms share dictionaries and resident planes. Each: parse + plan (``sql``),
    optimize() and translate() on the host's clock (medians of PLANS calls);
    the DataFrame form's run and the SQL form's first run, each counted from
    zero, must count the same device stages and kernel launches, and the
    three warm SQL runs three times as many; the results equal (floats within
    rtol 1e-5, the rest exactly); a warm SQL run uploads nothing where the
    DataFrame form's warm run uploads nothing. Returns the SQL first runs'
    launches, summed over the queries."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import physical as pp

    phase("sql")
    launches = {k: 0 for k in counters.KERNEL_NAMES}
    for qn, (cell, df_query, floats) in SQL_CELLS.items():
        label = f"q{qn} sql"
        tables = sql_tables[cell]
        text = TPCH_SQL[qn]
        clear_residency()
        with dt_ctx():
            parse, opt, tr = [], [], []
            for _ in range(PLANS):
                t0 = time.perf_counter()
                frame = dt.sql(text, **tables)
                t1 = time.perf_counter()
                plan = frame.optimized_plan()
                t2 = time.perf_counter()
                pp.translate(plan)
                parse.append(t1 - t0)
                opt.append(t2 - t1)
                tr.append(time.perf_counter() - t2)
            (want, got, df_snap, snap, warm_snap, first_s, warm, df_uploads,
             uploads) = sql_counts(text, tables, df_query)
        print(f"{label} first run counters: {json.dumps(snap, sort_keys=True)}")
        check(snap == df_snap, f"{label}: the SQL run counts "
              f"{ {k: v for k, v in snap.items() if v != df_snap[k]} }, the DataFrame form "
              f"{ {k: v for k, v in df_snap.items() if v != snap[k]} }")
        check(warm_snap == {k: 3 * v for k, v in df_snap.items()},
              f"{label}: the warm SQL runs count differently from the DataFrame form")
        check(not counters.rejections, f"{label}: a stage was refused: {counters.rejections}")
        check(same_result(got, want, floats), f"{label} differs from its DataFrame cell")
        check(df_uploads > 0 or uploads == 0,
              f"{label}: a warm run uploaded {uploads} columns (its DataFrame form none)")
        for k in counters.KERNEL_NAMES:
            launches[k] += snap[f"launches_{k}"]
        print(f"{label}: equal to its DataFrame cell, the same device counters and launches "
              f"({', '.join(f'{k} {v}' for k, v in snap.items() if k.startswith('launches_') and v)}"
              f"); parse + plan {statistics.median(parse) * 1e3:.4f} ms, optimize "
              f"{statistics.median(opt) * 1e3:.4f} ms, translate "
              f"{statistics.median(tr) * 1e3:.4f} ms (host clock, medians of {PLANS}); first "
              f"run {first_s:.4f} s; warm median {statistics.median(warm):.4f} s (runs "
              f"{', '.join(f'{w:.4f}' for w in warm)}); warm uploads {uploads} (the "
              f"DataFrame form's {df_uploads}) [{card}]", flush=True)
    return launches


# ---- serve: the serving tier on the card -----------------------------------------

# the mix: TPC-H q1, q3, q5, q6, q12 and q14 as TPCH_SQL writes them, and a
# grouped MIN/MAX over lineitem, whose int64 and date extremes run on K3
# (none of the six launches it)
SERVE_MINMAX_SQL = """
select l_returnflag, l_linestatus, min(l_shipdate) as first_ship,
       max(l_shipdate) as last_ship, min(l_orderkey) as first_order,
       max(l_orderkey) as last_order, count(*) as n
from lineitem
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""
SERVE_MIX = (("q1", TPCH_SQL[1]), ("q3", TPCH_SQL[3]), ("q5", TPCH_SQL[5]),
             ("q6", TPCH_SQL[6]), ("q12", TPCH_SQL[12]), ("q14", TPCH_SQL[14]),
             ("minmax", SERVE_MINMAX_SQL))
# the warm round's q6: another discount range, so its prepared entry
# replans once (the literal contract) and executes
SERVE_Q6_WARM = TPCH_SQL[6].replace("between 0.05 and 0.07", "between 0.04 and 0.06")
SERVE_FLOATS = {"q1": Q1_FLOATS, "q3": ("revenue",), "q5": ("revenue",), "q6": ("revenue",),
                "q12": (), "q14": ("promo_revenue",), "minmax": ()}
SERVE_TENANTS = 4
SERVE_CONCURRENT = 4          # the gateway's serving workers (max_concurrent_queries)
SERVE_CANCEL_QUEUE = 8        # the cancel round's queued queries (one tenant)
SERVE_RESULT_CACHE = 256 << 20  # the result cache's budget in the cached round
SERVE_TIMEOUT_S = 600.0       # each client socket's timeout and each thread's join
SERVE_KERNEL_CALLS = 4        # calls of each kernel the cold round keeps for its cases
SERVE_WRAPPERS = {"segment_sum_planes": "segment_kernels",
                  "segment_extreme_planes": "segment_kernels",
                  "segment_sum_float_planes": "segment_kernels",
                  "segment_extreme_int64": "segment_kernels",
                  "build_probe_table": "probe_kernels", "hash_probe_index": "probe_kernels"}
# the reservation the cancel round holds while its tenant queues (past any
# card's memory, and the round's hbm_budget_bytes: every served query waits)
SERVE_HOLD_BYTES = 1 << 40
SERVE_KERNELS = ("segment_sum_planes", "segment_extreme_planes", "segment_extreme_int64",
                 "hash_probe_build", "hash_probe_index", "segment_sum_float_planes")
SERVE_STAGES = ("device_grouped_batches", "device_stage_batches", "device_join_batches",
                "device_topn_runs")


def serve_tables(lineitem, orders, dims) -> dict:
    """The serve phase's tables: every column the mix reads, string columns
    as object arrays of their strings, dates as days."""
    import numpy as np

    import daft_tpu_torch as dt

    def strings(vocab, codes):
        return np.array(vocab, dtype=object)[codes]

    day = {c: lineitem[c].astype("datetime64[D]")
           for c in ("l_shipdate", "l_commitdate", "l_receiptdate")}
    part, customer = dims["part"], dims["customer"]
    return {
        "lineitem": dt.from_pydict({
            **{c: lineitem[c] for c in ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                                        "l_extendedprice", "l_discount", "l_tax")},
            "l_returnflag": strings(RETURNFLAGS, lineitem["l_returnflag"]),
            "l_linestatus": strings(LINESTATUS, lineitem["l_linestatus"]),
            "l_shipmode": strings(SHIPMODES, lineitem["l_shipmode"]), **day}),
        "orders": dt.from_pydict({
            "o_orderkey": orders["o_orderkey"], "o_custkey": orders["o_custkey"],
            "o_orderdate": orders["o_orderdate"].astype("datetime64[D]"),
            "o_shippriority": orders["o_shippriority"],
            "o_orderpriority": strings(PRIORITIES, orders["o_orderpriority"])}),
        "customer": dt.from_pydict({
            "c_custkey": customer["c_custkey"], "c_nationkey": customer["c_nationkey"],
            "c_mktsegment": strings(SEGMENTS, customer["c_mktsegment"])}),
        "part": dt.from_pydict({"p_partkey": part["p_partkey"],
                                "p_type": strings(P_TYPES, part["p_type"])}),
        "supplier": dt.from_pydict(dims["supplier"]),
        "nation": dt.from_pydict(dims["nation"]),
        "region": dt.from_pydict(dims["region"]),
    }


def serve_off(tables: dict):
    """The mix's answers in-process under device_mode="off": (by query, the
    same with the warm round's q6)."""
    import daft_tpu_torch as dt

    with dt.execution_config_ctx(device_mode="off"):
        want = {name: dt.sql(text, **tables).to_pydict() for name, text in SERVE_MIX}
        return want, {**want, "q6": dt.sql(SERVE_Q6_WARM, **tables).to_pydict()}


def serve_round(srv, label: str, mix, passes: int = 1) -> list:
    """Each of SERVE_TENANTS tenants on its own connection and thread sends
    ``mix`` rotated by its number, ``passes`` times over: [(tenant, pass,
    name, source, seconds, result), ...]. A tenant's failure fails the
    round."""
    import threading

    from daft_tpu_torch.gateway import GatewayClient

    out, errors = [], []
    lock = threading.Lock()

    def tenant(t: int) -> None:
        try:
            with GatewayClient(srv.host, srv.port, tenant=f"tenant-{t}",
                               timeout=SERVE_TIMEOUT_S) as c:
                order = list(mix[t % len(mix):]) + list(mix[:t % len(mix)])
                for p in range(passes):
                    for name, text in order:
                        t0 = time.perf_counter()
                        got = c.query(text)
                        dt_s = time.perf_counter() - t0
                        with lock:
                            out.append((t, p, name, c.last_source, dt_s, got))
        except Exception as e:  # noqa: BLE001 -- carried to the phase as a failure
            with lock:
                errors.append(f"tenant-{t}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=tenant, args=(t,), name=f"serve-tenant-{t}")
               for t in range(SERVE_TENANTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(SERVE_TIMEOUT_S)
    check(not any(th.is_alive() for th in threads), f"{label}: a tenant did not finish")
    check(not errors, f"{label}: {errors}")
    return out


def serve_latencies(label: str, rows: list, wall_s: float, card: str) -> None:
    """Each query's p50 and p99 latency through the wire over a round's
    samples, and the round's wall time."""
    import numpy as np

    by = {}
    for _t, _p, name, _src, sec, _got in rows:
        by.setdefault(name, []).append(sec * 1e3)
    print(f"{label}: wall {wall_s:.3f} s, {len(rows)} queries; latency through the wire, "
          "ms (p50 / p99 over the round's samples): " + "; ".join(
              f"{n} {np.percentile(v, 50):.3f} / {np.percentile(v, 99):.3f} (n {len(v)})"
              for n, v in by.items()) + f" [{card}]", flush=True)


def serve_checks(label: str, rows: list, want: dict, prepared, card: str) -> None:
    """Every answer equals the "off" run (SERVE_FLOATS within rtol 1e-5,
    the rest exactly), every executed query's plan holds a device stage,
    and none fell back or was refused."""
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import physical as pp

    for t, p, name, _src, _sec, got in rows:
        check(same_result(got, want[name], SERVE_FLOATS[name]),
              f"{label}: tenant-{t}'s {name} (pass {p}) differs from the \"off\" run")
    device = (pp.DeviceGroupedAgg, pp.DeviceFilterAgg, pp.DeviceJoinAgg, pp.DeviceJoinTopN)
    with prepared._lock:
        entries = list(prepared._entries.values())
    for e in entries:
        check(any(isinstance(n, device) for n in e.physical.walk()),
              f"{label}: a served plan holds no device stage:\n{e.physical.display()}")
    snap = counters.snapshot()
    check(snap["device_fallbacks"] == 0, f"{label}: a device stage fell back to the host")
    check(not counters.rejections, f"{label}: a stage was refused: {counters.rejections}")
    print(f"{label}: {len(rows)} answers equal to the \"off\" runs; every served plan holds a "
          f"device stage; no fallback, no rejection [{card}]", flush=True)


def serve_kernel_cases(calls: dict, kernel_results: dict, card: str) -> None:
    """K1, K2, K3 and K7 (``stage_kernel_cases``) and K4's builds and probes
    at the inputs the cold round gave them, each held against its plain
    version, into ``kernel_results`` under "at_serve_..."."""
    import torch

    from daft_tpu_torch.ops import probe_kernels as pk

    stage_kernel_cases("serve", "serve", {w: calls[w] for w in GROUPED_WRAPPERS},
                       GROUPED_WRAPPERS, kernel_results, card)
    check(calls["build_probe_table"] and calls["hash_probe_index"],
          "serve: K4 was not called in the cold round")
    new = {}
    for i, ((keys, valid, slots), _out) in enumerate(calls["build_probe_table"]):
        _table, new[("hash_probe_build", f"at_serve_{i}")] = k4_build_case(
            pk, keys, f"serve build {i}", valid, slots)
    for i, ((keys, valid, table), _out) in enumerate(calls["hash_probe_index"]):
        _got, new[("hash_probe_index", f"at_serve_{i}")] = k4_probe_case(
            pk, keys, valid, table, pk.table_entries(table)[0], f"serve probe {i}")
    for (kname, case_label), case in new.items():
        kernel_results[kname][case_label] = case
    del calls, new
    torch.cuda.empty_cache()


def phase_serve(lineitem, orders, dims, card: str, kernel_results: dict) -> dict:
    """The serve phase (see the module doc): five rounds through one gateway
    (the fifth through a one-worker gateway), every check a SmokeFailure.
    Returns the launches of the rounds, summed (the kernel cases' and the
    profile's launches fall outside them)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.gateway import GatewayClient, GatewayError, GatewayServer, ResultCache
    from daft_tpu_torch.observability import Subscriber, attach_subscriber, detach_subscriber
    from daft_tpu_torch.observability.metrics import registry
    from daft_tpu_torch.ops import counters

    phase("serve")
    t_phase = time.perf_counter()
    tables = serve_tables(lineitem, orders, dims)
    warm_mix = tuple((n, SERVE_Q6_WARM if n == "q6" else text) for n, text in SERVE_MIX)
    t0 = time.perf_counter()
    want, want_warm = serve_off(tables)
    print(f"serve: the mix's \"off\" runs {time.perf_counter() - t0:.3f} s (host clock)",
          flush=True)

    class Records(Subscriber):
        def __init__(self):
            self.recs = []

        def on_serve_query(self, rec):
            self.recs.append(rec)

    records = Records()
    attach_subscriber(records)
    clear_residency()
    reg0 = registry().snapshot()
    try:
        with dt_ctx():
            counters.reset()
            srv = GatewayServer(tables=tables, max_concurrent=SERVE_CONCURRENT,
                                result_cache_budget=0).start()
            try:
                prepared = srv._session.prepared
                # 1. cold: every plan prepared anew, the kernels' calls kept
                rows = []
                t0 = time.perf_counter()
                calls = capture_kernel_calls(
                    lambda: rows.extend(serve_round(srv, "serve cold", SERVE_MIX)),
                    SERVE_WRAPPERS, limit=SERVE_KERNEL_CALLS)
                serve_latencies("serve cold", rows, time.perf_counter() - t0, card)
                serve_checks("serve cold", rows, want, prepared, card)
                check(all(src == "executed" for *_x, src, _s, _g in rows),
                      "serve cold: a query did not execute")
                # 2. warm, the result cache off: prepared hits, q6 replanned once
                hits0 = registry().get("serve_prepared_hits")
                miss0 = registry().get("serve_prepared_misses")
                n_recs = len(records.recs)
                t0 = time.perf_counter()
                rows = serve_round(srv, "serve warm", warm_mix)
                serve_latencies("serve warm", rows, time.perf_counter() - t0, card)
                serve_checks("serve warm", rows, want_warm, prepared, card)
                check(all(r[3] == "executed" for r in rows), "serve warm: a query did not "
                      "execute")
                hits = registry().get("serve_prepared_hits") - hits0
                misses = registry().get("serve_prepared_misses") - miss0
                check(hits > 0, "serve warm: no prepared hit")
                warm_recs = records.recs[n_recs:]
                est = max(r.est_pin_bytes for r in warm_recs)
                print(f"serve warm: prepared hits {hits}, misses {misses} (q6's new range "
                      f"replans in its slot); largest reservation {est} bytes, observed "
                      f"pins calibrated {registry().get('serve_pin_calibrations')} times "
                      f"[{card}]", flush=True)
                warm_answers = {(t, name): got for t, _p, name, _s, _d, got in rows}
                # 3. the result cache on: each tenant's second pass from it
                srv.cache = ResultCache(SERVE_RESULT_CACHE)
                rc0 = registry().get("result_cache_hits")
                t0 = time.perf_counter()
                rows = serve_round(srv, "serve cached", warm_mix, passes=2)
                serve_latencies("serve cached", rows, time.perf_counter() - t0, card)
                serve_checks("serve cached", rows, want_warm, prepared, card)
                first = {(t, name): got for t, p, name, _s, _d, got in rows if p == 0}
                for t, p, name, src, _d, got in rows:
                    if p == 1:
                        check(src == "result_cache", f"serve cached: tenant-{t}'s repeat of "
                              f"{name} came from {src}")
                        check(got == first[(t, name)], f"serve cached: tenant-{t}'s repeat of "
                              f"{name} differs from its first answer")
                        check(same_result(got, warm_answers[(t, name)], SERVE_FLOATS[name]),
                              f"serve cached: tenant-{t}'s {name} differs from round 2's")
                rc_hits = registry().get("result_cache_hits") - rc0
                check(rc_hits > 0, "serve cached: no result-cache hit")
                print(f"serve cached: result-cache hits {rc_hits}, {srv.cache.stats()} "
                      f"[{card}]", flush=True)
                srv.cache = ResultCache(0)
                # 4. a tight HBM budget: the largest warm reservation
                waits0 = registry().get("admission_waits_total")
                with dt.execution_config_ctx(hbm_budget_bytes=est):
                    t0 = time.perf_counter()
                    rows = serve_round(srv, "serve tight", warm_mix)
                    serve_latencies("serve tight", rows, time.perf_counter() - t0, card)
                    serve_checks("serve tight", rows, want_warm, prepared, card)
                waits = registry().get("admission_waits_total") - waits0
                check(waits > 0, f"serve tight: no admission wait under a budget of {est} "
                      "bytes")
                print(f"serve tight: hbm_budget_bytes {est}, admission waits {waits} "
                      f"[{card}]", flush=True)
            finally:
                srv.close()
            # 5. cancel: one worker; while the phase holds a reservation of
            # the whole budget, one tenant queues SERVE_CANCEL_QUEUE queries
            # (the first waits at admission, the rest in the fair queue) and
            # cancels the last
            one = GatewayServer(tables=tables, max_concurrent=1, result_cache_budget=0).start()
            try:
                queue = (list(warm_mix) * 2)[:SERVE_CANCEL_QUEUE]
                with GatewayClient(one.host, one.port, tenant="tenant-cancel",
                                   timeout=SERVE_TIMEOUT_S) as c:
                    with dt.execution_config_ctx(hbm_budget_bytes=SERVE_HOLD_BYTES), \
                            manager().admit(SERVE_HOLD_BYTES, tenant="serve-hold"):
                        qids = [c.execute(sql=text) for _n, text in queue]
                        check(c.cancel(qids[-1]), "serve cancel: the cancel was not delivered")
                    for (name, _text), qid in zip(queue[:-1], qids[:-1]):
                        got = c.fetch_pydict(qid)
                        check(same_result(got, want_warm[name], SERVE_FLOATS[name]),
                              f"serve cancel: {name} differs from the \"off\" run")
                    try:
                        c.fetch_pydict(qids[-1])
                    except GatewayError as e:
                        check(e.code == "cancelled", f"serve cancel: the cancelled query "
                              f"answered {e.code}: {e}")
                    else:
                        raise SmokeFailure("serve cancel: the cancelled query answered a "
                                           "result")
            finally:
                one.close()
            check(manager().reserved_bytes() == 0 and manager().reservation_count() == 0,
                  f"serve cancel: {manager().reserved_bytes()} bytes still reserved")
            check(manager().pinned_count() == 0,
                  f"serve cancel: {manager().pinned_count()} residency entries still pinned")
            print(f"serve cancel: {SERVE_CANCEL_QUEUE - 1} answers equal to the \"off\" runs, "
                  "the last query cancelled with the typed error; no reservation, no pin "
                  f"[{card}]", flush=True)
            snap = counters.snapshot()
    finally:
        detach_subscriber(records)
    launches = {k: snap[f"{CELL_KERNEL_PREFIX}{k}"] for k in counters.KERNEL_NAMES}
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"serve: kernel {k} was not launched")
    delta = registry().diff(reg0)
    stages = {k: snap[k] for k in SERVE_STAGES}
    print(f"serve: launches {json.dumps({k: v for k, v in launches.items() if v})}; stages "
          f"{json.dumps(stages)}; admission waits {delta.get('admission_waits_total', 0)}, "
          f"prepared hits {delta.get('serve_prepared_hits', 0)}, misses "
          f"{delta.get('serve_prepared_misses', 0)}, result-cache hits "
          f"{delta.get('result_cache_hits', 0)}, gateway_bytes_streamed "
          f"{delta.get('gateway_bytes_streamed', 0)}, queries served "
          f"{delta.get('serve_queries_total', 0)}, cancelled "
          f"{delta.get('serve_cancelled_total', 0)}; phase wall "
          f"{time.perf_counter() - t_phase:.3f} s [{card}]", flush=True)
    serve_kernel_cases(calls, kernel_results, card)
    # the device's idle share over one warm round (a gateway of its own)
    prof = GatewayServer(tables=tables, max_concurrent=SERVE_CONCURRENT,
                         result_cache_budget=0).start()
    try:
        with dt_ctx():
            serve_round(prof, "serve profile warm-up", warm_mix)
        phase_profile(lambda: serve_round(prof, "serve profile", warm_mix), card,
                      "serve profile", host_ops=False)
    finally:
        prof.close()
    return launches


# ---- TPC-H q5: a star of six tables --------------------------------------------


Q5_FROM, Q5_TO = datetime.date(1994, 1, 1), datetime.date(1995, 1, 1)


def q5_frames(lineitem, orders, dims) -> dict:
    import daft_tpu_torch as dt

    return {
        "lineitem": dt.from_pydict({c: lineitem[c] for c in (
            "l_orderkey", "l_suppkey", "l_extendedprice", "l_discount")}),
        "orders": dt.from_pydict({"o_orderkey": orders["o_orderkey"],
                                  "o_custkey": orders["o_custkey"],
                                  "o_orderdate": orders["o_orderdate"].astype("datetime64[D]")}),
        "customer": dt.from_pydict({c: dims["customer"][c] for c in ("c_custkey",
                                                                     "c_nationkey")}),
        "supplier": dt.from_pydict(dims["supplier"]),
        "nation": dt.from_pydict(dims["nation"]),
        "region": dt.from_pydict(dims["region"]),
    }


def q5_query(t):
    """TPC-H q5 as benchmarking/tpch/queries.py:87-101 writes it."""
    from daft_tpu_torch import col, lit

    return (t["region"].where(col("r_name") == "ASIA")
            .join(t["nation"], left_on="r_regionkey", right_on="n_regionkey")
            .join(t["customer"], left_on="n_nationkey", right_on="c_nationkey")
            .join(t["orders"], left_on="c_custkey", right_on="o_custkey")
            .where((col("o_orderdate") >= lit(Q5_FROM)) & (col("o_orderdate") < lit(Q5_TO)))
            .join(t["lineitem"], left_on="o_orderkey", right_on="l_orderkey")
            .join(t["supplier"], left_on=["l_suppkey", "n_nationkey"],
                  right_on=["s_suppkey", "s_nationkey"])
            .groupby("n_name")
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue"))
            .sort("revenue", desc=True))


def q5_oracle(lineitem, orders, dims) -> dict:
    """q5's answer with numpy alone, in f64 (every key is 1..n or 0..24:
    the joins are indices)."""
    import numpy as np

    date = orders["o_orderdate"]
    order_ok = (date >= days(Q5_FROM)) & (date < days(Q5_TO))
    okey = lineitem["l_orderkey"] - 1
    nat = dims["customer"]["c_nationkey"][orders["o_custkey"] - 1][okey]
    asia = np.array(NATION_REGIONS)[nat] == REGIONS.index("ASIA")
    supp_nat = dims["supplier"]["s_nationkey"][lineitem["l_suppkey"] - 1]
    keep = order_ok[okey] & asia & (supp_nat == nat)
    sums = np.bincount(nat[keep], weights=revenue(lineitem)[keep], minlength=len(NATIONS))
    live = np.flatnonzero(np.bincount(nat[keep], minlength=len(NATIONS)) > 0)
    order = live[np.argsort(-sums[live], kind="stable")]
    return {"n_name": [NATIONS[i] for i in order], "revenue": sums[order].tolist()}


def phase_q5(lineitem, orders, dims, card: str, sql_tables: dict):
    """TPC-H q5 at SF1 on the card: lineitem the fact, orders and supplier
    adjacent, customer, nation and region chained behind orders, the second
    supplier key a predicate over two dims. The counters zeroed just before
    the cold run and read just after it: a device join batch, no rejection,
    no fallback, K4 on the cold run (its launches printed) and never on the
    warm runs; the result equal to the host path and the numpy oracle.
    Returns (the query as a callable, the cold run's launches)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import physical as pp

    phase("q5")
    clear_residency()
    frames = q5_frames(lineitem, orders, dims)
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        plan = pp.translate(q5_query(frames).optimized_plan())
    node = next((n for n in plan.walk() if isinstance(n, pp.DeviceJoinAgg)), None)
    check(node is not None and not any(isinstance(n, pp.HashJoin) for n in plan.walk()),
          "q5 did not plan as one device join")
    print("q5 plan: dims " + ", ".join(f"{d.key_col} <- {d.parent[0]}.{d.parent[1]}"
                                       for d in node.spec.dims)
          + f"; predicate {node.spec.predicate!r}", flush=True)
    want = q5_oracle(lineitem, orders, dims)

    def checks(snap, warm):
        print(f"q5 cold K4 launches: build {snap['launches_hash_probe_build']}, probe "
              f"{snap['launches_hash_probe_index']} (adjacent dims: orders, supplier)")
        for k in ("hash_probe_build", "hash_probe_index"):
            check(warm[f"launches_{k}"] == 0, f"q5: a warm run launched K4 {k}")
        check(warm["device_fallbacks"] == 0
              and warm["device_join_batches"] == warm["warm_runs"],
              "q5: a warm run left the device join path")

    got, launches = run_cell(
        "q5", lambda: q5_query(frames),
        ("hash_probe_build", "hash_probe_index", "segment_sum_planes", "segment_extreme_planes",
         "segment_sum_float_planes"), card, ("revenue",), want,
        counter="device_join_batches", extra_checks=checks)
    check(len(got["n_name"]) == 5, f"q5: {len(got['n_name'])} nations, expected ASIA's 5")
    print(f"q5 result: {json.dumps(got)}")
    sql_tables["q5"] = frames
    return (lambda: q5_query(frames).to_pydict()), launches


# ---- the join TopN's row order (negative and wide integer sums, NaN, inf, null) --


def topn_order_inputs() -> dict:
    """The join TopN's order cases: name -> (fact, dim, limit). "negative":
    4,000 rows, 50 groups of int64 sums, group 7 far below zero; "wide":
    80 rows of 2^55 plus a small offset in each of 50 groups (sums past 2^53
    that tie in f64); "special": 12 groups of float sums, one +inf, one NaN,
    one null (its rows all null)."""
    import numpy as np

    rng = np.random.default_rng(2)
    fk = rng.integers(0, 50, 4000)
    v = rng.integers(-1000, 1000, 4000)
    v[fk == 7] = -100_000
    dim50 = {"k": np.arange(50, dtype=np.int64)}
    out = {"negative": ({"fk": fk.astype(np.int64), "v": v.astype(np.int64)}, dim50, 5)}
    fk = np.arange(4000) % 50
    out["wide"] = ({"fk": fk.astype(np.int64),
                    "v": ((1 << 55) + (fk * 7919) % 97 - 48).astype(np.int64)}, dim50, 12)
    rng = np.random.default_rng(3)
    fk = np.arange(600) % 12
    v = rng.uniform(-50, 50, 600)
    v[np.flatnonzero(fk == 3)[0]] = np.inf
    v[np.flatnonzero(fk == 5)[1]] = np.nan
    values = [None if k == 8 else x for k, x in zip(fk.tolist(), v.tolist())]
    out["special"] = ({"fk": fk.astype(np.int64), "v": values},
                      {"k": np.arange(12, dtype=np.int64)}, 12)
    return out


def topn_order_query(fact, dim, desc: bool, nulls_first: bool, limit: int):
    from daft_tpu_torch import col

    return (fact.join(dim, left_on="fk", right_on="k")
            .groupby("k").agg(col("v").sum().alias("s"), col("v").count().alias("n"))
            .sort("s", desc=desc, nulls_first=nulls_first).limit(limit))


def topn_sf1_query(t, desc: bool = True):
    """lineitem joined to orders, grouped by o_custkey (about 150,000
    groups): a signed int64 sum (l_partkey - 100,000: eight digit planes)
    ordered by the join TopN."""
    from daft_tpu_torch import col

    return (t["lineitem"].join(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
            .groupby("o_custkey")
            .agg((col("l_partkey") - 100_000).sum().alias("s"),
                 col("l_quantity").sum().alias("qty"))
            .sort("s", desc=desc).limit(10))


def topn_sf1_oracle(lineitem, orders, desc: bool = True) -> dict:
    import numpy as np

    cust = orders["o_custkey"][lineitem["l_orderkey"] - 1]
    n = int(cust.max()) + 1
    s = np.zeros(n, dtype=np.int64)
    np.add.at(s, cust, lineitem["l_partkey"] - 100_000)
    qty = np.bincount(cust, weights=lineitem["l_quantity"], minlength=n)
    live = np.flatnonzero(np.bincount(cust, minlength=n) > 0)
    # ties by first occurrence in lineitem's order
    first = np.full(n, len(cust), dtype=np.int64)
    np.minimum.at(first, cust, np.arange(len(cust)))
    key = np.bitwise_not(s[live]) if desc else s[live]
    top = live[np.lexsort((first[live], key))][:10]
    return {"o_custkey": top.tolist(), "s": s[top].tolist(), "qty": qty[top].tolist()}


def phase_topn_order(lineitem, orders, card: str):
    """The join TopN's row order on the card against the host path: the
    small order cases (topn_order_inputs) in the four (desc x nulls_first)
    settings, each one device TopN run; then at SF1 the signed int64 sum
    by customer (topn_sf1_query), counted, descending against the host
    path and the numpy oracle, and ascending against the oracle. Returns
    (the SF1 query as a callable, its cold run's launches)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase("topn order")
    clear_residency()
    for name, (fact, dim, limit) in topn_order_inputs().items():
        f, d = dt.from_pydict(fact), dt.from_pydict(dim)
        for desc in (True, False):
            for nulls_first in (True, False):
                query = lambda: topn_order_query(f, d, desc, nulls_first, limit)  # noqa: E731
                with dt.execution_config_ctx(device="cuda", device_mode="on"):
                    counters.reset()
                    got = query().to_pydict()
                    runs = counters.device_topn_runs
                with dt.execution_config_ctx(device_mode="off"):
                    host = query().to_pydict()
                label = f"topn order {name} desc={desc} nulls_first={nulls_first}"
                check(runs == 1, f"{label}: {runs} device TopN runs")
                check(same_result(got, host, ("s",) if name == "special" else ()),
                      f"{label}: the card's order {got['k']} differs from the host's "
                      f"{host['k']}")
                if name == "special":
                    check((got["k"][0] == 8) == nulls_first and
                          (got["k"][-1] == 8) == (not nulls_first),
                          f"{label}: the null group is not placed by nulls_first")
                print(f"{label}: k {got['k']} equal to the host path")
    t = {"lineitem": dt.from_pydict({c: lineitem[c] for c in ("l_orderkey", "l_partkey",
                                                               "l_quantity")}),
         "orders": dt.from_pydict({c: orders[c] for c in ("o_orderkey", "o_custkey")})}

    def checks(snap, warm):
        check(snap["device_topn_runs"] == 1 and warm["device_topn_runs"] == warm["warm_runs"],
              "topn order SF1: a run left the device TopN")

    got, launches = run_cell(
        "topn order SF1", lambda: topn_sf1_query(t), ("segment_sum_planes",
                                                      "segment_extreme_planes"),
        card, ("qty",), topn_sf1_oracle(lineitem, orders), counter="device_join_batches",
        extra_checks=checks)
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        asc = topn_sf1_query(t, desc=False).to_pydict()
    check(same_result(asc, topn_sf1_oracle(lineitem, orders, desc=False), ("qty",)),
          "topn order SF1 ascending differs from the numpy oracle")
    check(all(v < 0 for v in asc["s"]), "topn order SF1: the smallest sums are not negative")
    print(f"topn order SF1: descending {json.dumps(got)}; ascending sums {asc['s']} "
          "(negative: eight two's-complement digit planes, rebuilt signed)", flush=True)
    return (lambda: topn_sf1_query(t).to_pydict()), launches


COALESCE_MORSEL_ROWS = 1 << 14  # an eighth of the default morsel_size_rows


def coalesce_frames(lineitem):
    """(q6's four lineitem columns as one partition of one batch, the same
    cut into morsels of COALESCE_MORSEL_ROWS rows, the number of morsels),
    the coalescer cell's inputs."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import logical as lp

    part = dt.MicroPartition.from_pydict({
        **{c: lineitem[c] for c in ("l_quantity", "l_extendedprice", "l_discount")},
        "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
    batch = part.concat_or_empty()
    morsels = [batch.slice(s, s + COALESCE_MORSEL_ROWS)
               for s in range(0, batch.num_rows, COALESCE_MORSEL_ROWS)]
    whole = dt.DataFrame(lp.InMemorySource(part.schema, [part]))
    cut = dt.DataFrame(lp.InMemorySource(part.schema, [dt.MicroPartition(part.schema,
                                                                         morsels)]))
    return whole, cut, len(morsels)


def coalesce_q6(df):
    """The coalescer cell's query: TPC-H q6 over ``df``."""
    from daft_tpu_torch import col, lit

    return (df.where((col("l_shipdate") >= lit(Q6_FROM)) & (col("l_shipdate") < lit(Q6_TO))
                     & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                     & (col("l_quantity") < 24))
            .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue")))


def phase_coalesce(lineitem, card: str):
    """q6 over lineitem cut into morsels of COALESCE_MORSEL_ROWS rows, the
    dispatch coalescer on (its default target, half the bucket at
    morsel_size_rows): the counters zeroed just before the run and read just
    after it show fewer dispatches than morsels with buckets at least half
    full, and the result equals the one-batch run's and the oracle's.
    Returns (the run as a callable, its launches)."""
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase("coalesce")
    clear_residency()
    whole, cut, n_morsels = coalesce_frames(lineitem)
    q6 = coalesce_q6

    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        one = q6(whole).to_pydict()
        counters.reset()
        t0 = time.perf_counter()
        got = q6(cut).to_pydict()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = counters.snapshot()
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        cfg = dt.execution_config()
    print(f"coalesce run counters: {json.dumps(snap, sort_keys=True)}")
    fill = snap["bucket_fill_rows"] / max(snap["bucket_capacity_rows"], 1)
    check(snap["coalesce_morsels_in"] == n_morsels,
          f"{snap['coalesce_morsels_in']} morsels reached the coalescer, not {n_morsels}")
    check(snap["coalesce_morsels_in"] > snap["dispatch_coalesced"],
          "the coalescer fed as many batches as it took morsels")
    check(snap["device_stage_batches"] == snap["dispatch_coalesced"],
          "a stage batch did not come from the coalescer")
    check(fill >= 0.5, f"bucket fill {fill:.4f} is under 0.5")
    ship = lineitem["l_shipdate"]
    keep = ((ship >= days(Q6_FROM)) & (ship < days(Q6_TO))
            & (lineitem["l_discount"] >= 0.05) & (lineitem["l_discount"] <= 0.07)
            & (lineitem["l_quantity"] < 24))
    oracle = {"revenue": [float((lineitem["l_extendedprice"][keep]
                                 * lineitem["l_discount"][keep]).sum())]}
    check(same_result(got, one, ("revenue",)), "the coalesced run differs from the one-batch run")
    check(same_result(got, oracle, ("revenue",)), "the coalesced run differs from the oracle")
    print(f"coalesce: {n_morsels} morsels of {COALESCE_MORSEL_ROWS} rows into "
          f"{snap['dispatch_coalesced']} dispatches (target {int(cfg.batch_fill_target * 100)} % "
          f"of the {cfg.morsel_size_rows}-row bucket), fill {fill:.4f}; run {wall:.3f} s; "
          f"result {json.dumps(got)} equal to the one-batch run {json.dumps(one)} and the "
          f"oracle [{card}]", flush=True)
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        counters.reset()
        warm = time_s(lambda: q6(cut).to_pydict())
        warm_snap = counters.snapshot()
        uploads = count_uploads(lambda: q6(cut).to_pydict())
    print(f"coalesce warm median {statistics.median(warm):.4f} s (runs "
          f"{', '.join(f'{w:.4f}' for w in warm)}): every coalesced batch is a new Series, "
          f"rebound by content: hbm_stable_rehits {warm_snap['hbm_stable_rehits']}, "
          f"fingerprint_ms {warm_snap['fingerprint_ms']:.3f} over the 3 runs; {uploads} "
          f"column uploads on a warm run [{card}]", flush=True)
    check(uploads == 0, f"coalesce: a warm run uploaded {uploads} columns")
    plan_ms("coalesce", lambda: q6(cut), card)
    return (lambda: q6(cut).to_pydict()), launches


def splitmix64_np(x):
    """splitmix64's finalizer over uint64, written out here so the oracle
    does not lean on the port's hashing module."""
    import numpy as np

    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def partition_arrays(part, names):
    """{column: (values, validity)} of one result partition."""
    batch = part.concat_or_empty()
    return {c: (batch.get_column(c).to_numpy(), batch.get_column(c).validity_numpy())
            for c in names}


def same_partitions(a, b, names) -> bool:
    """Partition for partition, column for column: equal bits and validity,
    rows in order."""
    import numpy as np

    if len(a) != len(b):
        return False
    for pa_, pb_ in zip(a, b):
        x, y = partition_arrays(pa_, names), partition_arrays(pb_, names)
        for c in names:
            (xv, xm), (yv, ym) = x[c], y[c]
            if xv.dtype != yv.dtype or not np.array_equal(xm, ym) \
                    or not np.array_equal(xv.view(f"u{xv.itemsize}"),
                                          yv.view(f"u{yv.itemsize}")):
                return False
    return True


def phase_repartition(lineitem, card: str):
    """The mesh hash repartition of SF1 lineitem's numeric columns over 8
    shard slots on the card. Returns (the run as a callable, the run's
    launches)."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    import daft_tpu_torch.device.residency  # noqa: F401
    from daft_tpu_torch import col
    from daft_tpu_torch.ops import counters

    phase("repartition")
    # the earlier cells' resident planes stay out of this cell's peak memory
    dt.device.residency.manager().clear()
    torch.cuda.empty_cache()
    cols = {c: lineitem[c] for c in REPART_COLUMNS}
    rows = len(cols["l_orderkey"])
    df = dt.from_pydict(cols)
    mesh_cfg = {"device": "cuda", "device_mode": "on", "mesh_devices": MESH}

    def run():
        return df.repartition(MESH, col("l_orderkey")).collect()._result

    with dt.execution_config_ctx(kernel_mode="on", **mesh_cfg):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        snap = counters.snapshot()
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        peak = torch.cuda.max_memory_allocated()
        warm = time_s(run)
    print(f"run counters: {json.dumps(snap, sort_keys=True)}")
    check(not counters.rejections, f"the repartition was refused: {counters.rejections}")
    check(launches["ring_permute_words"] == 1,
          f"K6 launched {launches['ring_permute_words']} times, expected once")
    check(snap["mesh_fused_permute_dispatches"] >= 1, "no fused-permute exchange")
    check(snap["mesh_alltoall_dispatches"] == 0, "the all_to_all tier ran")
    check(snap["mesh_alltoall_rows"] == rows, "the exchange did not carry every row")

    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        host = df.repartition(MESH, col("l_orderkey")).collect()._result
        host_s = time.perf_counter() - t0
    check(same_partitions(got, host, REPART_COLUMNS),
          "a partition differs from the port's host path")
    dest = splitmix64_np(cols["l_orderkey"].view(np.uint64)) % np.uint64(MESH)
    sizes = []
    for d, part in enumerate(got):
        arrays = partition_arrays(part, REPART_COLUMNS)
        mine = dest == d
        sizes.append(int(mine.sum()))
        for c in REPART_COLUMNS:
            values, valid = arrays[c]
            check(valid.all() and np.array_equal(values, cols[c][mine]),
                  f"partition {d}, column {c} differs from the numpy oracle")
    check(sum(sizes) == rows, "the partitions do not cover the rows")

    with dt.execution_config_ctx(kernel_mode="off", **mesh_cfg):
        counters.reset()
        t0 = time.perf_counter()
        off = run()
        torch.cuda.synchronize()
        off_s = time.perf_counter() - t0
        off_snap = counters.snapshot()
    check(off_snap["mesh_alltoall_dispatches"] == 1
          and off_snap["launches_ring_permute_words"] == 0,
          "kernel_mode='off' did not take the all_to_all tier")
    check(same_partitions(off, got, REPART_COLUMNS),
          "the all_to_all tier's partitions differ from the K6 tier's")
    print(f"lineitem SF1 {rows} rows, {len(REPART_COLUMNS)} columns by l_orderkey into "
          f"{MESH} partitions {sizes}: equal to the host path and the numpy oracle, "
          f"and the all_to_all tier equal to the K6 tier")
    print(f"repartition first {first_s:.3f} s; warm median {statistics.median(warm):.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in warm)}); all_to_all tier {off_s:.3f} s; "
          f"host path {host_s:.3f} s; exchange {snap['mesh_exchange_bytes']} bytes; "
          f"max_memory_allocated {peak} bytes [{card}]", flush=True)
    plan_ms("repartition", lambda: df.repartition(MESH, col("l_orderkey")), card)
    return run, launches


# ---- the scan phase: the SF1 tables through the port's files -----------------

SCAN_PARQUET = ("lineitem", "orders", "part", "customer", "supplier", "nation", "region")
SCAN_CSV = ("customer", "supplier", "nation", "region")
CODEC_CHECK_BYTES = 4 << 20  # uncompressed snappy bytes the plain decoder checks a table
# the scan cells' coalescer flushes by size alone: with the default 50 ms
# latency flush, which morsels one dispatch folds depends on how long each
# row group takes to decode, and a batch of other content cannot rebind
SCAN_FLUSH_MS = 60_000.0


def _strings(name: str, vocab, codes):
    """A string Series of ``vocab[codes]``, built without a per-value
    Python loop."""
    import numpy as np

    from daft_tpu_torch import DataType, Series

    return Series(name, DataType.string(), np.array(vocab, dtype=object)[codes],
                  np.ones(len(codes), dtype=bool))


def scan_tables(lineitem, orders, dims) -> dict:
    """The scan phase's SF1 tables as the port's in-memory DataFrames, each
    column as its file holds it: the code columns as their strings, dates
    as dates. Every column tpch_sf1 draws is kept."""
    import daft_tpu_torch as dt

    def table(cols, strings, dates=()):
        out = {}
        for c, v in cols.items():
            if c in strings:
                out[c] = _strings(c, strings[c], v)
            elif c in dates:
                out[c] = v.astype("datetime64[D]")
            else:
                out[c] = v
        return dt.from_pydict(out)

    return {
        "lineitem": table(lineitem, {"l_shipmode": SHIPMODES, "l_returnflag": RETURNFLAGS,
                                     "l_linestatus": LINESTATUS,
                                     "l_shipinstruct": INSTRUCTIONS},
                          ("l_shipdate", "l_commitdate", "l_receiptdate")),
        "orders": table(orders, {"o_orderpriority": PRIORITIES}, ("o_orderdate",)),
        "part": table(dims["part"], {"p_type": P_TYPES, "p_brand": P_BRANDS,
                                     "p_container": P_CONTAINERS}),
        "customer": table(dims["customer"], {"c_mktsegment": SEGMENTS}),
        "supplier": table(dims["supplier"], {}),
        "nation": table(dims["nation"], {}),
        "region": table(dims["region"], {}),
    }


def _frame_batch(df):
    """The one RecordBatch of an in-memory DataFrame."""
    return df._plan.partitions[0].concat_or_empty()


def _same_series(a, b) -> bool:
    """Equal values (floats bit for bit) and validity."""
    import numpy as np

    if a.dtype != b.dtype or len(a) != len(b):
        return False
    av, bv = a.to_numpy(), b.to_numpy()
    if not np.array_equal(a.validity_numpy(), b.validity_numpy()):
        return False
    if av.dtype == object:
        return bool((av == bv).all())
    if av.dtype.kind == "f":
        return np.array_equal(av.view(f"u{av.itemsize}"), bv.view(f"u{bv.itemsize}"))
    return np.array_equal(av, bv)


def scan_write(frames: dict, root: str, card: str) -> dict:
    """Each table written with write_parquet (snappy) and the dims with
    write_csv too; {name: directory}, CSV directories as ``<name>_csv``."""
    out = {}
    for fmt, names in (("parquet", SCAN_PARQUET), ("csv", SCAN_CSV)):
        for name in names:
            d = os.path.join(root, name if fmt == "parquet" else f"{name}_csv")
            t0 = time.perf_counter()
            with dt_ctx():
                df = frames[name]
                paths = (df.write_parquet(d) if fmt == "parquet"
                         else df.write_csv(d)).to_pydict()["path"]
            secs = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(p) for p in paths)
            check(len(paths) == 1, f"{name}: {len(paths)} {fmt} files, expected one")
            print(f"write {fmt} {name}: {_frame_batch(frames[name]).num_rows} rows, "
                  f"{nbytes} bytes, {secs:.3f} s [{card}]", flush=True)
            out[name if fmt == "parquet" else f"{name}_csv"] = d
    return out


def scan_read_back(frames: dict, dirs: dict, card: str) -> None:
    """Every Parquet table read back whole: each column equal to the
    in-memory table's, values (floats bit for bit) and validity; and each
    CSV table equal too. Prints seconds and MB/s of file bytes."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.core.recordbatch import RecordBatch

    for key in SCAN_PARQUET + tuple(f"{n}_csv" for n in SCAN_CSV):
        name = key.removesuffix("_csv")
        reader = dt.read_csv if key.endswith("_csv") else dt.read_parquet
        nbytes = sum(os.path.getsize(os.path.join(dirs[key], f))
                     for f in os.listdir(dirs[key]))
        t0 = time.perf_counter()
        with dt_ctx():
            parts = reader(dirs[key]).collect()._result
        secs = time.perf_counter() - t0
        got = RecordBatch.concat([b for p in parts for b in p.batches])
        want = _frame_batch(frames[name])
        check(got.column_names() == want.column_names(), f"{key}: columns differ")
        for c in want.column_names():
            check(_same_series(got.get_column(c), want.get_column(c)),
                  f"{key}: column {c} read back differs from the in-memory table")
        print(f"read {key}: {got.num_rows} rows, every column equal to the in-memory table; "
              f"{secs:.3f} s, {nbytes / secs / 1e6:.1f} MB/s [{card}]", flush=True)


def scan_codec_check(dirs: dict) -> None:
    """A slice of each Parquet table's snappy pages (row group 0, pages in
    column order up to CODEC_CHECK_BYTES uncompressed) decoded by the
    library and by the plain Python decoder: equal bytes."""
    from daft_tpu_torch.io import _parquet_format as pf
    from daft_tpu_torch.io import _thrift as th
    from daft_tpu_torch.io import codecs

    for name in SCAN_PARQUET:
        path = os.path.join(dirs[name], os.listdir(dirs[name])[0])
        footer = pf.read_footer(path)
        pages = nbytes = 0
        with open(path, "rb") as f:
            for col in footer.columns:
                md = footer.chunk(footer.row_groups[0], col.name)
                check(md["codec"] == codecs.SNAPPY, f"{name}.{col.name} is not snappy")
                f.seek(md.get("dictionary_page_offset") or md["data_page_offset"])
                raw = f.read(md["total_compressed_size"])
                head, pos = th.read_struct(raw, 0)
                ph = th.decode(th.PAGE_HEADER, head)
                page = raw[pos:pos + ph["compressed_page_size"]]
                lib = codecs.snappy_decompress(page, ph["uncompressed_page_size"])
                check(lib == codecs.plain_snappy_decompress(page),
                      f"{name}.{col.name}: the snappy library and the plain decoder differ")
                pages += 1
                nbytes += len(lib)
                if nbytes >= CODEC_CHECK_BYTES:
                    break
        print(f"codec {name}: {pages} snappy pages, {nbytes} bytes: the library equals the "
              "plain decoder", flush=True)


SCAN_NUMBERS = ("scan_tasks", "scan_tasks_split", "scan_tasks_merged", "scan_batches",
                "scan_rows", "scan_row_groups", "scan_row_groups_pruned", "scan_files_pruned",
                "scan_decode_ms", "scan_filter_ms")


def scan_checks(label: str, extra=None):
    """run_cell's extra checks for a file-fed cell: print the scan's own
    numbers (cold) and the rebinding's (the warm runs)."""
    def checks(snap, warm):
        print(f"{label} scan (cold): " + ", ".join(f"{k} {snap[k]:.3f}" if k.endswith("_ms")
                                                  else f"{k} {snap[k]}" for k in SCAN_NUMBERS))
        print(f"{label} rebinding ({warm['warm_runs']} warm runs): fingerprint_ms "
              f"{warm['fingerprint_ms']:.3f}, "
              f"hbm_stable_rehits {warm['hbm_stable_rehits']}, hbm_cache_misses "
              f"{warm['hbm_cache_misses']}, scan_decode_ms {warm['scan_decode_ms']:.3f}, "
              f"scan_filter_ms {warm['scan_filter_ms']:.3f}")
        check(warm["hbm_stable_rehits"] > 0, f"{label}: no plane rebound on a warm run")
        if extra is not None:
            extra(snap, warm)
    return checks


def scan_cell(label: str, query, kernels, want, floats, card: str, counter: str,
              extra=None, host_ops: bool = True):
    """One file-fed query on the card through run_cell (equal to its
    in-memory cell ``want``; one warm run, which uploads no column: every
    plane rebinds) and a profile (phase_profile's ``host_ops``), the
    coalescer flushing by size alone (SCAN_FLUSH_MS). Returns the cold
    run's launches."""
    import daft_tpu_torch as dt

    def warm_uploads(snap, warm):
        # every column upload (Series.to_device) counts its bytes; a
        # residency miss of a plane made on the card from resident ones
        # (a probe index) uploads nothing
        scan_checks(label, extra)(snap, warm)
        check(warm["hbm_h2d_bytes"] == 0,
              f"{label}: a warm run uploaded {warm['hbm_h2d_bytes']} bytes")
        print(f"{label}: 0 column uploads on a warm run (0 bytes; "
              f"{warm['hbm_cache_misses']} residency misses)", flush=True)

    with dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS):
        _got, launches = run_cell(label, query, kernels, card, floats, want,
                                  counter=counter, extra_checks=warm_uploads, warm_runs=1)
        phase_profile(lambda: query().to_pydict(), card, f"{label} profile",
                      host_ops=host_ops)
    return launches


def fingerprint_vs_upload(label: str, directory: str, columns, card: str) -> None:
    """One read of ``columns``: the content fingerprints of its Series
    against their uploads (as the f32 stage takes them), host clock."""
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops.stage import pad_bucket

    with dt_ctx():
        parts = dt.read_parquet(directory).select(*columns).collect()._result
    series = [b.get_column(c) for p in parts for b in p.batches for c in columns]
    fp_ms = {}
    for kind in ("numeric", "string"):
        t0 = time.perf_counter()
        for s in series:
            if s.dtype.is_string() == (kind == "string"):
                s.content_fingerprint()
        fp_ms[kind] = (time.perf_counter() - t0) * 1e3
    # what a rebind saves: a numeric column's upload; a string key's host
    # factorize (dict_codes) and the upload of its int32 codes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in series:
        if not s.dtype.is_string():
            s.to_device(pad_bucket(len(s)), f32=True, device="cuda")
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for s in series:
        if s.dtype.is_string():
            torch.from_numpy(s.dict_codes()[0]).to("cuda")
    torch.cuda.synchronize()
    codes_ms = (time.perf_counter() - t0) * 1e3
    print(f"{label} columns {list(columns)}: {len(series)} Series: fingerprints "
          f"{sum(fp_ms.values()):.3f} ms (numeric {fp_ms['numeric']:.3f}, strings "
          f"{fp_ms['string']:.3f}); numeric uploads {up_ms:.3f} ms; string keys' factorize "
          f"and code uploads {codes_ms:.3f} ms [{card}]", flush=True)


def phase_scan(lineitem, orders, dims, cells: dict, card: str, root: str):
    """The port's file path at SF1 on the card: write every table (Parquet,
    snappy; the dims as CSV too) under ``root``, read each back equal to its
    in-memory table, check the codec, then run q1 and q6 over
    read_parquet(lineitem), q12 and q14 over lineitem with orders / part
    from Parquet, q5 in SQL through current_session() (lineitem and orders
    from Parquet, the rest from CSV), q6 over a copy of lineitem sorted by
    l_shipdate (zone maps prune), and q3 over Parquet (its join TopN takes
    the host plan: the fact arrives in morsels). Each result equals its
    in-memory cell (``cells``). Returns ({path: the cold run's launches},
    {table: its directory}); the caller removes ``root``."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import logical as lp

    phase("scan")
    clear_residency()
    paths = {}
    t0 = time.perf_counter()
    frames = scan_tables(lineitem, orders, dims)
    print(f"scan tables {time.perf_counter() - t0:.2f} s", flush=True)
    dirs = scan_write(frames, root, card)
    scan_read_back(frames, dirs, card)
    scan_codec_check(dirs)
    fingerprint_vs_upload("q1", dirs["lineitem"],
                          ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                           "l_discount", "l_tax", "l_shipdate"), card)

    def pq(name):
        return dt.read_parquet(dirs[name])

    clear_residency()
    paths["scan_q1"] = scan_cell(
        "scan q1", lambda: q1_query(pq("lineitem")),
        ("segment_sum_float_planes", "segment_sum_planes", "segment_extreme_planes"),
        cells["q1"], Q1_FLOATS, card, "device_grouped_batches")
    clear_residency()
    paths["scan_q6"] = scan_cell("scan q6", lambda: q6_query(pq("lineitem")), (),
                                 cells["q6"], ("revenue",), card, "device_stage_batches")

    def warm_k4(label):
        def extra(snap, warm):
            print(f"{label} K4 launches: cold build {snap['launches_hash_probe_build']}, "
                  f"probe {snap['launches_hash_probe_index']}; {warm['warm_runs']} warm runs build "
                  f"{warm['launches_hash_probe_build']}, probe "
                  f"{warm['launches_hash_probe_index']}")
        return extra

    k4 = ("hash_probe_build", "hash_probe_index")
    clear_residency()
    paths["scan_q12"] = scan_cell(
        "scan q12", lambda: q12_query(pq("lineitem"), pq("orders")),
        k4 + ("segment_sum_planes", "segment_extreme_planes"), cells["q12"], (), card,
        "device_join_batches", warm_k4("scan q12"))
    clear_residency()
    paths["scan_q14"] = scan_cell(
        "scan q14", lambda: q14_query({"lineitem": pq("lineitem"), "part": pq("part")}),
        k4, cells["q14"], ("promo_revenue",), card, "device_join_batches",
        warm_k4("scan q14"))

    sess = dt.current_session()
    sess.create_temp_table("lineitem", pq("lineitem"))
    sess.create_temp_table("orders", pq("orders"))
    for name in SCAN_CSV:
        sess.create_temp_table(name, dt.read_csv(dirs[f"{name}_csv"]))
    clear_residency()
    try:
        # the CSV scans report no row estimate, so the join reorder keeps
        # the comma list's order and the star join capture does not fire,
        # in the reference as here: host joins into the grouped stage
        # (profiled by its device activities alone: the host joins take
        # the run, about 20 s on the card's host)
        paths["scan_q5_sql"] = scan_cell(
            "scan q5 sql", lambda: dt.sql(TPCH_SQL[5]),
            ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes"),
            cells["q5"], ("revenue",), card, "device_grouped_batches", host_ops=False)
    finally:
        for name in ("lineitem", "orders") + SCAN_CSV:
            sess.drop_temp_table(name)

    # q6 over lineitem sorted by l_shipdate: the zone maps can prune
    batch = _frame_batch(frames["lineitem"])
    order = np.argsort(lineitem["l_shipdate"], kind="stable")
    t0 = time.perf_counter()
    with dt_ctx():
        sorted_path = dt.DataFrame(lp.InMemorySource(
            batch.schema, [dt.MicroPartition(batch.schema, [batch.take(order)])])
        ).write_parquet(os.path.join(root, "lineitem_sorted")).to_pydict()["path"][0]
    print(f"write parquet lineitem sorted by l_shipdate: {os.path.getsize(sorted_path)} "
          f"bytes, {time.perf_counter() - t0:.3f} s [{card}]", flush=True)

    def pruned(snap, _warm):
        check(snap["scan_row_groups_pruned"] > 0,
              "q6 over the sorted lineitem pruned no row group")
    clear_residency()
    paths["scan_q6_sorted"] = scan_cell(
        "scan q6 sorted", lambda: q6_query(dt.read_parquet(sorted_path)), (), cells["q6"],
        ("revenue",), card, "device_stage_batches", pruned)

    paths["scan_q3"] = scan_q3(pq, cells["q3"], card)
    return paths, dirs


def scan_q3(pq, want: dict, card: str) -> dict:
    """q3 over Parquet: the fact arrives as morsels, so its join TopN takes
    the host plan (a DeviceFallback recorded in the counters, as the
    reference's "device TopN path requires a single fact batch"); the
    result equals the in-memory cell. Returns the cold run's launches."""
    import torch

    from daft_tpu_torch.ops import counters

    def query():
        return q3_query({"lineitem": pq("lineitem"), "orders": pq("orders"),
                         "customer": pq("customer")})

    clear_residency()
    with dt_ctx():
        counters.reset()
        t0 = time.perf_counter()
        got = query().to_pydict()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        snap = counters.snapshot()
        reasons = dict(counters.rejections)
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        # one warm run: a file-fed q3 run takes about 20 s (the per-batch dim
        # index, PERF.md §7), and the pipeline phase times it again
        warm = time_s(lambda: query().to_pydict(), runs=1)
    print(f"scan q3 cold run counters: {json.dumps(snap, sort_keys=True)}")
    print(f"scan q3 fallback: {json.dumps(reasons)}")
    check(snap["device_topn_runs"] == 0 and snap["device_fallbacks"] == 1,
          "scan q3: the join TopN did not fall back once")
    check(any("single fact batch" in r for r in reasons), "scan q3: no single-fact-batch reason")
    check(same_result(got, want, ("revenue",)), "scan q3 differs from its in-memory cell")
    print(f"scan q3: equal to the in-memory cell; cold {cold_s:.3f} s; warm median "
          f"{statistics.median(warm):.4f} s (runs {', '.join(f'{w:.4f}' for w in warm)}) "
          f"[{card}]", flush=True)
    plan_ms("scan q3", query, card)
    return launches


# the modes a pipeline cell runs in turn after its untimed run: (off, on); a
# cold cell (off, on, on, off), each mode's first run cold and its second
# warm; file-fed q3 one of each, to keep the script well inside its time
# limit
PIPELINE_MODES = ("off", "on")
PIPELINE_MODES_COLD = ("off", "on", "on", "off")  # a cold cell: each mode cold, then warm
PIPELINE_MODES_Q3 = ("off", "on")
DEVICE_NODE_NAMES = ("DeviceGroupedAgg", "DeviceFilterAgg", "DeviceJoinAgg", "DeviceJoinTopN")
# the kernel wrappers the stages call, and the executor's feed of a device
# stage's batches, by module: a run's calls are recorded with their thread
# (launch_threads)
STAGE_WRAPPERS = {"segment_kernels": ("segment_sum_planes", "segment_extreme_planes",
                                      "segment_extreme_int64", "segment_sum_float_planes"),
                  "probe_kernels": ("build_probe_table", "hash_probe_index"),
                  "executor": ("_feed_stream",)}


def expected_launch_threads(plan) -> set:
    """The threads a pipelined run of the physical ``plan`` calls its
    kernels from: a stage thread for a device node that is a stage node or
    is pulled by one (its generator runs on that stage's thread), the
    caller's thread for one the consumer pulls itself (a device join run
    at the root). A join run's host plan (its fallback) counts too."""
    import threading

    from daft_tpu_torch.execution.executor import _STAGE_NODES
    from daft_tpu_torch.execution.pipeline import STAGE_THREAD_NAME

    main = threading.current_thread().name
    out = set()

    def walk(node, staged):
        staged = staged or isinstance(node, _STAGE_NODES)
        if type(node).__name__ in DEVICE_NODE_NAMES:
            out.add(STAGE_THREAD_NAME if staged else main)
        for child in node.children():
            walk(child, staged)
        if getattr(node, "host_plan", None) is not None:
            walk(node.host_plan, staged)

    walk(plan, False)
    return out


class launch_threads:
    """While open, every call of a stage's kernel wrapper or of the
    executor's device feed (STAGE_WRAPPERS) records its thread's name:
    ``seen`` is {function: {thread names}}."""

    def __enter__(self):
        import threading

        from daft_tpu_torch.execution import executor
        from daft_tpu_torch.ops import probe_kernels, segment_kernels

        self.seen = {}
        self._saved = []
        for mod in (segment_kernels, probe_kernels, executor):
            for name in STAGE_WRAPPERS[mod.__name__.rsplit(".", 1)[-1]]:
                fn = getattr(mod, name)

                def spy(*args, _fn=fn, _name=name, **kwargs):
                    self.seen.setdefault(_name, set()).add(threading.current_thread().name)
                    return _fn(*args, **kwargs)

                self._saved.append((mod, name, fn))
                setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def stage_threads_alive() -> int:
    import threading

    from daft_tpu_torch.execution.pipeline import STAGE_THREAD_NAME

    return sum(1 for t in threading.enumerate() if t.name.startswith(STAGE_THREAD_NAME))


def host_profile(label: str, run, card: str, top: int = 10) -> None:
    """One run of ``run()`` under cProfile (on Python 3.12 it sees every
    thread, the stage threads and the pool's included): the functions that
    took the most of their own time."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    try:
        run()
    finally:
        prof.disable()
    wall = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    body = out.getvalue()
    print(f"{label}: one run under cProfile, wall {wall:.3f} s [{card}]; own time by "
          "function:\n" + body[body.find("ncalls"):].rstrip(), flush=True)


def pipeline_cell(label: str, query, want: dict, floats, counter: str, card: str,
                  modes=PIPELINE_MODES, cold: bool = False,
                  profile: bool = False) -> dict:
    """One cell in turns under pipeline_mode "off" and "on" (``modes``, in
    order) after one untimed run, the coalescer flushing
    by size alone, the counters zeroed before each run and read after it. Every run equals
    ``want`` (the cell's result, held to its numpy oracle) and the other
    mode's first run (``floats`` within rtol 1e-5, the rest exactly);
    ``counter`` is above 0 in every run; in "on" every kernel call came from
    the threads ``expected_launch_threads`` names, in "off" from this one;
    after every run no stage thread is alive and nothing is pinned. With
    ``cold`` the residency is cleared before each mode's first run, which
    is then reported apart; with ``profile`` the untimed run is profiled
    (host_profile). Returns {"off": [s], "on": [s], "cold": {mode:
    s}, "launches": the first "on" run's, "window": {"tasks", "peak"}}."""
    import threading

    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.execution.executor import _pipeline_on
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import physical as pp

    main = threading.current_thread().name
    out = {"off": [], "on": [], "cold": {}, "launches": None, "window": {}}
    first = {}
    if not cold:
        with dt_ctx(), dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS):
            if profile:
                host_profile(label, lambda: query().to_pydict(), card)
            else:
                query().to_pydict()  # untimed: the frames' dictionaries and planes
    for mode in modes:
        is_cold = cold and mode not in out["cold"]
        if is_cold:
            clear_residency()
        with dt_ctx(), dt.execution_config_ctx(pipeline_mode=mode,
                                               batch_latency_ms=SCAN_FLUSH_MS):
            expected = expected_launch_threads(pp.translate(query().optimized_plan())) \
                if _pipeline_on() else {main}
            counters.reset()
            with launch_threads() as spy:
                t0 = time.perf_counter()
                got = query().to_pydict()
                _synchronize()
                secs = time.perf_counter() - t0
            snap = counters.snapshot()
        threads = set().union(*spy.seen.values()) if spy.seen else set()
        check(same_result(got, want, floats), f"{label} ({mode}) differs from its oracle")
        if mode in first:
            check(same_result(got, first[mode], floats), f"{label} ({mode}) changed between runs")
        other = first.get("on" if mode == "off" else "off")
        check(other is None or same_result(got, other, floats),
              f"{label}: pipeline_mode off and on differ")
        first.setdefault(mode, got)
        check(snap[counter] > 0, f"{label} ({mode}): no {counter}")
        check(bool(threads) and threads <= expected,
              f"{label} ({mode}): kernels called from {sorted(threads)}, expected "
              f"{sorted(expected)}")
        check(stage_threads_alive() == 0, f"{label} ({mode}): a stage thread outlived the run")
        check(manager().pinned_count() == 0, f"{label} ({mode}): a pin outlived the run")
        if is_cold:
            out["cold"][mode] = secs
        else:
            out[mode].append(secs)
        if mode == "on" and out["launches"] is None:
            out["launches"] = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
            out["window"] = {"tasks": snap["scan_tasks"],
                             "windowed": snap["scan_window_tasks"],
                             "peak": snap["scan_window_peak"]}
            print(f"{label} (on): kernel calls by thread "
                  f"{json.dumps({k: sorted(v) for k, v in sorted(spy.seen.items())})}; "
                  f"scan tasks {snap['scan_tasks']}, read in the window "
                  f"{snap['scan_window_tasks']}, at most {snap['scan_window_peak']} at once")
    cold_txt = "".join(f"; cold {m} {s:.4f} s" for m, s in out["cold"].items())
    med = {m: statistics.median(out[m]) for m in ("off", "on")}
    print(f"{label}: equal in both modes and to its oracle; warm median off "
          f"{med['off']:.4f} s (runs {', '.join(f'{w:.4f}' for w in out['off'])}), on "
          f"{med['on']:.4f} s (runs {', '.join(f'{w:.4f}' for w in out['on'])}); on/off "
          f"{med['on'] / med['off']:.3f}{cold_txt} [{card}]", flush=True)
    return out


def host_join_times(label: str, query, card: str) -> dict:
    """Each host join of ``query``'s plan alone, on this thread, its inputs
    materialized first: the port's per-batch join before the build-once
    probe (``join_indices`` of each left batch against the whole right
    side, both coded again every batch) against ``JoinProbe`` (the right
    side indexed once, each left batch probed). The two give the same row
    indices. Returns {"joins", "left_batches", "before_s", "after_s"}."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.core.kernels.join import join_indices
    from daft_tpu_torch.execution import executor as ex
    from daft_tpu_torch.plan import physical as pp

    out = {"joins": 0, "left_batches": 0, "before_s": 0.0, "after_s": 0.0}
    with dt_ctx(), dt.execution_config_ctx(pipeline_mode="off"):
        stack = [pp.translate(query().optimized_plan())]
        while stack:
            node = stack.pop()
            stack.extend(node.children())
            if not isinstance(node, pp.HashJoin):
                continue
            left = [b for p in ex.execute_plan(node.left) for b in p.batches if b.num_rows]
            right = ex._concat_parts(list(ex.execute_plan(node.right)), node.right.schema)
            t0 = time.perf_counter()
            rkeys = ex._keys(right, node.right_on)
            old = [join_indices(ex._keys(b, node.left_on), rkeys, node.how) for b in left]
            t1 = time.perf_counter()
            probe = ex.JoinProbe(node, right)
            new = [probe.table.probe(ex._keys(b, node.left_on), node.how) for b in left]
            t2 = time.perf_counter()
            check(all((a[0] == b[0]).all() and (a[1] == b[1]).all() and len(a[0]) == len(b[0])
                      for a, b in zip(old, new)),
                  f"{label}: the build-once probe and the per-batch join differ")
            out["joins"] += 1
            out["left_batches"] += len(left)
            out["before_s"] += t1 - t0
            out["after_s"] += t2 - t1
            print(f"{label} host join ({node.how}, {len(left)} left batches of "
                  f"{sum(b.num_rows for b in left)} rows, right {right.num_rows} rows): per-batch "
                  f"{t1 - t0:.4f} s, build-once probe {t2 - t1:.4f} s [{card}]", flush=True)
    print(f"{label}: {out['joins']} host joins: per-batch join {out['before_s']:.4f} s, "
          f"build-once probe {out['after_s']:.4f} s (host clock, one thread) [{card}]",
          flush=True)
    return out


def supplier_frame(cols):
    """The supplier cell's DataFrame (phase_slice's columns)."""
    import daft_tpu_torch as dt

    data = {k: cols[k] for k in ("l_orderkey", "l_suppkey", "l_linenumber")}
    data["l_shipdate"] = cols["l_shipdate"].astype("datetime64[D]")
    return dt.from_pydict(data)


def pipeline_cells(lineitem, orders, dirs: dict) -> list:
    """(label, query, the cells key, float columns, stage counter, modes,
    cold) of each pipeline cell: the file-fed q1, q6, q12, q14 and q3 over
    the scan phase's Parquet files, q5 in SQL with its dims from CSV (the
    session's tables, registered by the caller), and the in-memory
    supplier, q1 and q12 cells."""
    import daft_tpu_torch as dt

    def pq(name):
        return dt.read_parquet(dirs[name])

    sup = supplier_frame(lineitem)
    q1_df = q1_frame(lineitem)
    df_l, df_o = q12_frames(lineitem, orders)
    return [
        ("pipeline scan q1", lambda: q1_query(pq("lineitem")), "q1", Q1_FLOATS,
         "device_grouped_batches", PIPELINE_MODES, False),
        ("pipeline scan q6", lambda: q6_query(pq("lineitem")), "q6", ("revenue",),
         "device_stage_batches", PIPELINE_MODES, False),
        ("pipeline scan q12", lambda: q12_query(pq("lineitem"), pq("orders")), "q12", (),
         "device_join_batches", PIPELINE_MODES, False),
        ("pipeline scan q14", lambda: q14_query({"lineitem": pq("lineitem"), "part": pq("part")}),
         "q14", ("promo_revenue",), "device_join_batches", PIPELINE_MODES, False),
        ("pipeline scan q3", lambda: q3_query({"lineitem": pq("lineitem"),
                                               "orders": pq("orders"),
                                               "customer": pq("customer")}),
         "q3", ("revenue",), "device_grouped_batches", PIPELINE_MODES_Q3, False),
        ("pipeline scan q5 sql", lambda: dt.sql(TPCH_SQL[5]), "q5", ("revenue",),
         "device_grouped_batches", PIPELINE_MODES_COLD, True),
        ("pipeline supplier", lambda: supplier_query(sup), "supplier", (),
         "device_grouped_batches", PIPELINE_MODES, False),
        ("pipeline q1", lambda: q1_query(q1_df), "q1", Q1_FLOATS, "device_grouped_batches",
         PIPELINE_MODES, False),
        ("pipeline q12", lambda: q12_query(df_l, df_o), "q12", (), "device_join_batches",
         PIPELINE_MODES, False),
    ]


def phase_pipeline(lineitem, orders, dirs: dict, cells: dict, card: str) -> dict:
    """The pipelined executor (pipeline_mode "on", the default) against the
    sequential one ("off") at SF1, each cell through pipeline_cell; the
    host's cores and the compute pool's width; q5's host joins before and
    after the build-once probe (host_join_times); one run of file-fed q1
    under "on" in torch.profiler (its idle share). Returns {path: the first
    "on" run's launches}."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.utils.pool import pool_width

    phase("pipeline")
    print(f"host: os.cpu_count() {os.cpu_count()}, compute pool width {pool_width()} "
          f"[{card}]", flush=True)
    sess = dt.current_session()
    sess.create_temp_table("lineitem", dt.read_parquet(dirs["lineitem"]))
    sess.create_temp_table("orders", dt.read_parquet(dirs["orders"]))
    for name in SCAN_CSV:
        sess.create_temp_table(name, dt.read_csv(dirs[f"{name}_csv"]))
    paths = {}
    t0 = time.perf_counter()
    try:
        clear_residency()
        for label, query, key, floats, counter, modes, cold in \
                pipeline_cells(lineitem, orders, dirs):
            # q3's time is not split yet: its untimed run goes under cProfile
            r = pipeline_cell(label, query, cells[key], floats, counter, card, modes, cold,
                              profile=key == "q3")
            paths[label.replace(" ", "_")] = r["launches"]
            if key == "q5":
                host_join_times(label, query, card)
        phase_profile(lambda: q1_query(dt.read_parquet(dirs["lineitem"])).to_pydict(), card,
                      "pipeline scan q1 profile (on)", pipeline_mode="on",
                      batch_latency_ms=SCAN_FLUSH_MS)
    finally:
        for name in ("lineitem", "orders") + SCAN_CSV:
            sess.drop_temp_table(name)
    print(f"pipeline phase {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return paths


AI_ROWS = 1 << 16            # texts in the ai cells (the default device_min_rows)
AI_MORSEL_ROWS = 512         # rows a morsel of the corpus holds (the reference's ai suite)
AI_BATCH = 1024              # batch_size: the rows of one encoder dispatch
AI_WARM_RUNS = 1             # the embed cell's warm runs (their median)
AI_WORDS = 50_000            # the synthetic vocabulary the texts draw from
AI_MODEL = "minilm-l6-seeded"
# sentence-transformers/all-MiniLM-L6-v2's published widths (FFN 4 x 384)
AI_WIDTHS = {"vocab": 30522, "dim": 384, "layers": 6, "heads": 12, "max_len": 128}
AI_LABELS = ["billing and payment", "shipping and delivery", "account and login",
             "product quality"]
F32_PEAK_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores


def ai_words(n: int = AI_WORDS):
    """``n`` distinct synthetic lowercase words (base-26 spellings)."""
    out = []
    for i in range(n):
        v, word = i * 7919 + 26 ** 3, ""
        while v:
            v, r = divmod(v, 26)
            word += chr(ord("a") + r)
        out.append(word)
    return out


def ai_corpus(seed: int, n: int, words=None):
    """``n`` texts of 8-64 words drawn Zipf-like (p ~ 1 / rank) from the
    synthetic vocabulary; about 1 % are null and 0.5 % empty, at seeded
    rows. A catalog or support-ticket table of the kind users embed or tag
    in bulk."""
    import numpy as np

    words = words or ai_words()
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 65, n)
    p = 1.0 / np.arange(1, len(words) + 1)
    draws = rng.choice(len(words), int(lens.sum()), p=p / p.sum())
    vocab = np.array(words, dtype=object)
    ends = np.cumsum(lens)
    texts = [" ".join(vocab[draws[e - k:e]]) for e, k in zip(ends.tolist(), lens.tolist())]
    kind = rng.random(n)
    for i in np.flatnonzero(kind < 0.015).tolist():
        texts[i] = None if kind[i] < 0.01 else ""
    return texts


def ai_frame(texts, morsel: int = AI_MORSEL_ROWS):
    """The corpus as a port DataFrame of (id, text), one partition cut into
    morsels of ``morsel`` rows (as coalesce_frames cuts lineitem)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import logical as lp

    part = dt.MicroPartition.from_pydict({
        "id": np.arange(len(texts), dtype=np.int64),
        "text": dt.Series.from_pylist(texts, "text", dt.DataType.string())})
    batch = part.concat_or_empty()
    morsels = [batch.slice(s, s + morsel) for s in range(0, batch.num_rows, morsel)]
    return dt.DataFrame(lp.InMemorySource(part.schema, [dt.MicroPartition(part.schema,
                                                                          morsels)]))


def install_ai_model(name: str = AI_MODEL, widths=None):
    """Seeded weights at ``widths`` (MiniLM-L6's by default) put in the
    provider's per-process embedder cache under ``name``, as a model load
    does. Returns the embedder."""
    from daft_tpu_torch.ai import torch_provider as tp

    weights = tp.TorchEncoderWeights.seeded(name, **(widths or AI_WIDTHS))
    emb = tp.TorchTextEmbedder(name, weights)
    with tp._PROVIDER_LOCK:
        tp._EMBEDDERS[name] = emb
    return emb


def ai_embed_query(df, model: str = AI_MODEL, batch_size: int = AI_BATCH):
    from daft_tpu_torch import col
    from daft_tpu_torch.functions.ai import embed_text

    return df.select(col("id"), embed_text(col("text"), provider="torch", model=model,
                                           batch_size=batch_size).alias("e"))


def ai_classify_query(df, model: str = AI_MODEL, batch_size: int = AI_BATCH):
    """Label counts: each text's label (classify_text), grouped, counted,
    in label order (the null texts' group last)."""
    from daft_tpu_torch import col
    from daft_tpu_torch.functions.ai import classify_text

    return (df.select(col("id"), classify_text(col("text"), AI_LABELS, provider="torch",
                                               model=model, batch_size=batch_size)
                      .alias("label"))
            .groupby("label").agg(col("id").count().alias("n")).sort("label"))


def ai_classify_oracle(embeddings, lab):
    """(label counts in the classify query's form, the labels row by row,
    the number of rows whose top-two margin is under 1e-5) from the embed
    cell's own embeddings (None for a null text) and the label matrix."""
    import numpy as np

    rows = [i for i, e in enumerate(embeddings) if e is not None]
    scores = np.asarray([embeddings[i] for i in rows], dtype=np.float32) @ lab.T
    picks = scores.argmax(axis=1)
    top2 = np.sort(scores, axis=1)[:, -2:]
    labels = [None] * len(embeddings)
    for i, k in zip(rows, picks.tolist()):
        labels[i] = AI_LABELS[k]
    present = sorted({v for v in labels if v is not None})
    counts = {"label": present, "n": [labels.count(v) for v in present]}
    if len(rows) < len(labels):
        counts["label"].append(None)
        counts["n"].append(len(labels) - len(rows))
    return counts, labels, int((top2[:, 1] - top2[:, 0] < 1e-5).sum())


def ai_classify_inputs(labels, dev) -> dict:
    """K1's and K2's inputs in the classify cell's grouped stage, from the
    run's labels (one batch of len(labels) rows): the label column's codes
    numbered by first occurrence, a null its own code, at the cap they pad
    to; K1's two planes, the group's rows and its counted ids (every id is
    valid: the same plane), and K2's first-row index."""
    import numpy as np
    import torch

    from daft_tpu_torch.ops.grouped_stage import _pad_groups
    from daft_tpu_torch.ops.stage import pad_bucket

    index = {}
    group = np.array([index.setdefault(v, len(index)) for v in labels], dtype=np.int32)
    cap = _pad_groups(len(index))
    n = len(labels)
    bucket = pad_bucket(n)
    codes = torch.full((bucket,), cap, dtype=torch.int32)
    codes[:n] = torch.from_numpy(group)
    keep = torch.arange(bucket) < n
    first = torch.where(keep, torch.arange(bucket, dtype=torch.float32),
                        torch.tensor(float("inf")))
    kf = keep.float().to(dev)
    return {"cap": cap, "codes": codes.to(dev), "planes": [kf, kf.clone()],
            "first": [first.to(dev)], "groups": len(index)}


def ai_score_func():
    """The fused cell's scalar device UDF: x scaled by the sum of eight
    seeded weights (the reference's stand-in model, tests/test_device_udf.py
    ``_score_func``). Returns (the Func, the weights)."""
    import numpy as np

    import daft_tpu_torch as dt

    w = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    score = dt.func(lambda params, x: x * params["w"].sum(), on_device=True,
                    return_dtype=dt.DataType.float32(), device_params=lambda: {"w": w},
                    device_key="chip_smoke_score:3")
    return score, w


def ai_fused_query(df, score):
    from daft_tpu_torch import col

    return df.with_column("s", score(col("l_extendedprice"))).agg(
        col("s").sum().alias("s"))


def ai_fused_oracle(price, w) -> dict:
    """sum(f32(price * sum(w))) in f64, the fused cell's result."""
    import numpy as np

    wsum = np.float64(np.float32(w.sum(dtype=np.float32)))
    return {"s": [float((price * wsum).astype(np.float32).astype(np.float64).sum())]}


def ai_profile(run, emb, card: str) -> dict:
    """One warm embed run under torch.profiler (device activities) with the
    host tokenization timed: wall, tokenization, device busy (kernels and
    copies) and the kernels' own time, idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phase("ai embed profile")
    spent = [0.0]
    real = emb.device_prepare

    def timed(texts):
        t0 = time.perf_counter()
        out = real(texts)
        spent[0] += time.perf_counter() - t0
        return out

    emb.device_prepare = timed
    try:
        with dt_ctx(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del emb.device_prepare
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in events
                    if not e.key.startswith("Memcpy") and not e.key.startswith("Memset")) / 1e3
    out = {"wall_ms": wall_ms, "tokenize_ms": spent[0] * 1e3, "busy_ms": busy_ms,
           "kernel_ms": kernel_ms}
    print(f"ai embed warm run under the profiler: wall {wall_ms:.3f} ms, host tokenization "
          f"{spent[0] * 1e3:.3f} ms, device busy {busy_ms:.3f} ms (kernels {kernel_ms:.3f} "
          f"ms), idle share {1 - busy_ms / wall_ms:.4f} [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms x{e.count}: {e.key[:90]}")
    sys.stdout.flush()
    return out


def phase_ai(lineitem, card: str, kernel_results: dict) -> dict:
    """The UDF tier's cells at MiniLM-L6 widths over AI_ROWS texts, and the
    fused UDF -> sum over SF1 lineitem. Returns each cell's counted launches;
    the classify cell's kernel cases go into ``kernel_results``."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ai import torch_provider as tp
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.ops import segment_kernels as sk
    from daft_tpu_torch.ops import udf_stage

    phase("ai")
    clear_residency()
    t0 = time.perf_counter()
    emb = install_ai_model()
    w_bytes = sum(v.nbytes for v in emb.weights.params.values())
    d, layers, length = AI_WIDTHS["dim"], AI_WIDTHS["layers"], AI_WIDTHS["max_len"]
    flops_per_token = 2 * (12 * d * d + 2 * length * d) * layers
    texts = ai_corpus(SEED, AI_ROWS)
    df = ai_frame(texts)
    nulls = sum(t is None for t in texts)
    print(f"ai model {AI_MODEL}: seeded at {json.dumps(AI_WIDTHS)}, {w_bytes} weight bytes "
          f"(f32), {flops_per_token / 1e6:.3f} MFLOP per token; corpus {AI_ROWS} texts "
          f"({nulls} null, {sum(t == '' for t in texts)} empty) in "
          f"{AI_ROWS // AI_MORSEL_ROWS} morsels, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    paths = {}

    # ---- ai embed ----
    with dt_ctx():
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        out = ai_embed_query(df).to_pydict()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        snap = counters.snapshot()
        peak = torch.cuda.max_memory_allocated()
        paths["ai_embed"] = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        counters.reset()
        warm = time_s(lambda: ai_embed_query(df).to_pydict(), AI_WARM_RUNS)
        warm_snap = counters.snapshot()
    print(f"ai embed cold run counters: {json.dumps(snap, sort_keys=True)}")
    chunks = -(-AI_ROWS // AI_BATCH)
    check(snap["coalesce_morsels_in"] == AI_ROWS // AI_MORSEL_ROWS,
          f"ai embed: {snap['coalesce_morsels_in']} morsels reached the coalescer")
    check(snap["device_udf_dispatches"] == chunks < snap["coalesce_morsels_in"],
          f"ai embed: {snap['device_udf_dispatches']} dispatches for "
          f"{snap['coalesce_morsels_in']} morsels, expected {chunks}")
    check(snap["device_udf_runs"] == 1 and snap["device_udf_rows"] == AI_ROWS,
          "ai embed: not one run over every row")
    check(snap["device_udf_weight_h2d_bytes"] == w_bytes,
          f"ai embed: {snap['device_udf_weight_h2d_bytes']} weight bytes uploaded, not {w_bytes}")
    check(warm_snap["device_udf_weight_h2d_bytes"] == 0,
          f"ai embed: the warm runs uploaded {warm_snap['device_udf_weight_h2d_bytes']} weight "
          "bytes")
    check([v is None for v in out["e"]] == [t is None for t in texts],
          "ai embed: a null text did not give a null embedding, or a text gave null")
    e_valid = np.asarray([v for v in out["e"] if v is not None], dtype=np.float32)
    norm_err = float(np.abs(np.linalg.norm(e_valid, axis=1) - 1.0).max())
    check(e_valid.shape == (AI_ROWS - nulls, d) and norm_err <= 1e-5,
          f"ai embed: shape {e_valid.shape}, unit-norm error {norm_err}")
    med = statistics.median(warm)
    print(f"ai embed: cold {cold:.3f} s; warm median {med:.4f} s (runs "
          f"{', '.join(f'{w:.4f}' for w in warm)}), {AI_ROWS / med:.1f} rows/s; "
          f"{snap['coalesce_morsels_in']} morsels into {snap['dispatch_coalesced']} coalesced "
          f"batch(es), {snap['device_udf_dispatches']} dispatches of {AI_BATCH} rows; weights "
          f"{snap['device_udf_weight_h2d_bytes']} bytes cold, "
          f"{warm_snap['device_udf_weight_h2d_bytes']} over the {len(warm)} warm runs; "
          f"unit-norm error "
          f"{norm_err:.3e}; max_memory_allocated {peak} bytes [{card}]", flush=True)
    prof = ai_profile(lambda: ai_embed_query(df).to_pydict(), emb, card)
    tokens = chunks * AI_BATCH * length  # padded positions are computed too
    rate = tokens * flops_per_token / (prof["kernel_ms"] / 1e3)
    print(f"ai embed encoder: {tokens} token positions x {flops_per_token / 1e6:.3f} MFLOP "
          f"in {prof['kernel_ms']:.3f} ms of kernels: {rate / 1e12:.3f} TFLOP/s, "
          f"{rate / F32_PEAK_FLOPS:.4f} of the 67 TFLOP/s f32 peak (outside the tensor "
          f"cores) [{card}]", flush=True)
    head = ai_frame(texts[:256], 256)
    with dt.execution_config_ctx(device_mode="off"):
        t0 = time.perf_counter()
        cpu = ai_embed_query(head).to_pydict()
        cpu_s = time.perf_counter() - t0
    check([v is None for v in cpu["e"]] == [v is None for v in out["e"][:256]],
          "ai embed: the CPU path's nulls differ")
    cpu_err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                  for a, b in zip(out["e"][:256], cpu["e"]) if a is not None)
    check(cpu_err <= 1e-5, f"ai embed: the card differs from the CPU by {cpu_err}")
    print(f"ai embed: the first 256 rows within {cpu_err:.3e} of the same query on the CPU "
          f"(device_mode=\"off\", {cpu_s:.3f} s) [{card}]", flush=True)
    paths.update(auto_ai_embed(df, out, cpu, card, on_ms=med * 1e3))

    # ---- ai classify ----
    seen = []
    real_finalize = udf_stage.DeviceUdfRun.finalize

    def finalize(run):
        host, valid = real_finalize(run)
        seen.append((host.dtype, host.nbytes))
        return host, valid

    lab = tp.label_matrix(emb, AI_LABELS)
    udf_stage.DeviceUdfRun.finalize = finalize
    try:
        with dt_ctx():
            counters.reset()
            t0 = time.perf_counter()
            got = ai_classify_query(df).to_pydict()
            torch.cuda.synchronize()
            cls_s = time.perf_counter() - t0
            cls_snap = counters.snapshot()
            paths["ai_classify"] = {k: cls_snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
    finally:
        udf_stage.DeviceUdfRun.finalize = real_finalize
    print(f"ai classify cold run counters: {json.dumps(cls_snap, sort_keys=True)}")
    want, labels, close = ai_classify_oracle(out["e"], lab)
    check(got == want, f"ai classify: {json.dumps(got)} differs from the oracle "
                       f"{json.dumps(want)}")
    check(cls_snap["device_udf_weight_h2d_bytes"] == lab.nbytes,
          f"ai classify: {cls_snap['device_udf_weight_h2d_bytes']} weight bytes uploaded, not "
          f"the label matrix's {lab.nbytes} (the encoder is embed's entry)")
    check(seen[0] == (np.dtype(np.int32), AI_ROWS * 4),
          f"ai classify: the copy back held {seen[0]}, not {AI_ROWS} int32 codes")
    check(cls_snap["launches_segment_sum_planes"] > 0 and cls_snap["device_grouped_batches"] == 1,
          "ai classify: the count did not run through the grouped stage's K1")
    print(f"ai classify: {json.dumps(got)} equal to the oracle (argmax of the embed cell's "
          f"embeddings against the label matrix; {close} rows with a top-two margin under "
          f"1e-5); {cls_snap['device_udf_weight_h2d_bytes']} weight bytes uploaded (the label "
          f"matrix), the copy back {seen[0][1]} bytes of {seen[0][0]}; kernels launched "
          f"{json.dumps({k: v for k, v in paths['ai_classify'].items() if v})}; the run "
          f"(the encoder already resident) {cls_s:.3f} s, {AI_ROWS / cls_s:.1f} rows/s "
          f"[{card}]", flush=True)
    t = ai_classify_inputs(labels, torch.device("cuda"))
    at = f"at_ai_classify_cap{t['cap']}"
    kernel_results["segment_sum_planes"][at] = plane_case(sk, "sum", t["planes"], t["codes"],
                                                          t["cap"])
    kernel_results["segment_extreme_planes"][at] = plane_case(sk, "min", t["first"],
                                                              t["codes"], t["cap"])
    print_cases({f"{k} {at}": kernel_results[k][at]
                 for k in ("segment_sum_planes", "segment_extreme_planes")}, card)
    del out, e_valid, t

    # ---- ai fused ----
    score, w = ai_score_func()
    frame = dt.from_pydict({c: lineitem[c] for c in ("l_extendedprice", "l_quantity",
                                                     "l_discount")})
    with dt_ctx():
        counters.reset()
        t0 = time.perf_counter()
        fused = ai_fused_query(frame, score).to_pydict()
        torch.cuda.synchronize()
        fused_cold = time.perf_counter() - t0
        f_snap = counters.snapshot()
        paths["ai_fused"] = {k: f_snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        counters.reset()
        uploads = count_uploads(lambda: ai_fused_query(frame, score).to_pydict())
        f_warm_snap = counters.snapshot()
        fused_warm = time_s(lambda: ai_fused_query(frame, score).to_pydict())
    print(f"ai fused cold run counters: {json.dumps(f_snap, sort_keys=True)}")
    # the copies back, counted where they are made: the UDF tier copies only
    # in DeviceUdfRun.finalize (device_udf_runs), the aggregate only in its
    # finalize (device_stage_runs); each UDF dispatch fed the aggregate's
    check(f_snap["device_udf_dispatches"] >= 1 and f_snap["device_stage_batches"] ==
          f_snap["device_udf_dispatches"] and f_snap["device_udf_runs"] == 0
          and f_snap["device_stage_runs"] == 1,
          "ai fused: the UDF did not feed the aggregate's dispatches, or its plane came back")
    check(f_snap["device_region_dispatches"] == f_snap["device_stage_batches"],
          "ai fused: the UDF and the aggregate were not counted as one region")
    check(uploads == 0 and f_warm_snap["device_udf_weight_h2d_bytes"] == 0,
          f"ai fused: a warm run uploaded {uploads} columns and "
          f"{f_warm_snap['device_udf_weight_h2d_bytes']} weight bytes")
    oracle = ai_fused_oracle(lineitem["l_extendedprice"], w)
    check(same_result(fused, oracle, ("s",)), f"ai fused: {fused} differs from the oracle "
                                               f"{oracle}")
    print(f"ai fused: {json.dumps(fused)} equal to the oracle {json.dumps(oracle)} (rtol "
          f"1e-5); {f_snap['device_udf_dispatches']} dispatches each feeding the aggregate, "
          f"{f_snap['device_udf_runs']} copies of the UDF plane back and "
          f"{f_snap['device_stage_runs']} aggregate result fetch, 0 uploads warm; "
          f"cold {fused_cold:.3f} s, warm median {statistics.median(fused_warm):.4f} s [{card}]",
          flush=True)
    return paths


# ---- out of core and windows ------------------------------------------------------

OOC_QUERIES = (1, 3, 4, 5, 6, 10, 12, 14, 19)  # bench.py:1129-1226's nine
OOC_FLOATS = {1: Q1_FLOATS, 3: ("revenue",), 5: ("revenue",), 6: ("revenue",),
              10: ("revenue",), 14: ("promo_revenue",), 19: ("revenue",)}
# the device counters each query's card run moves (the scan phase's stage
# counters; measured on the H100, PERF.md §6), budgeted or not
OOC_DEVICE = {1: ("device_grouped_batches",),
              3: ("device_grouped_batches", "device_join_batches"),
              4: ("device_grouped_batches",),
              5: ("device_grouped_batches", "device_join_batches"),
              6: ("device_stage_batches",),
              10: ("device_grouped_batches", "device_join_batches"),
              12: ("device_grouped_batches", "device_join_batches"),
              14: ("device_join_batches", "device_stage_batches"),
              19: ("device_join_batches", "device_stage_batches")}
# the one fallback a query's card run takes, budgeted or not: q3's and
# q10's join TopN over a fact read in morsels takes the host plan (as
# scan q3); every other query falls back nowhere
OOC_FALLBACKS = {3: "single fact batch", 10: "single fact batch"}
# what a card run's device stages did, held equal between the unbudgeted
# and the budgeted run (the coalescer flushing by size alone, so that no
# count hangs on timing)
OOC_STAGE_COUNTERS = ("device_grouped_batches", "device_stage_batches",
                      "device_join_batches", "device_stage_runs", "device_topn_runs",
                      "device_fallbacks", "coalesce_morsels_in", "dispatch_coalesced",
                      "bucket_fill_rows")
SORT_KEYS = ("l_extendedprice", "l_orderkey", "l_linenumber")
SORT_COLUMNS = SORT_KEYS + ("l_quantity",)
W2_FROM, W2_TO = datetime.date(1995, 1, 1), datetime.date(1995, 1, 31)  # 30 days
W2_CAP = 4096             # W2's 25 brands x 150 types pad to this group capacity
W1_COLUMNS = ("l_orderkey", "l_linenumber", "l_suppkey", "l_shipdate", "l_quantity",
              "l_extendedprice")
W1_ROWS = 1_500_000       # W1 over lineitem's first rows (all 6 M until PR 24's cut)
DEVICE_COUNTERS = ("device_grouped_batches", "device_stage_batches", "device_join_batches")
SPILL_PRINT = ("spill_batches", "spill_bytes", "spill_wire_bytes", "spill_files", "spill_runs",
               "spill_merge_passes", "spill_merge_sort_rows", "spill_write_seconds",
               "spill_write_wall_seconds", "spill_read_seconds", "spill_read_wall_seconds",
               "scan_bytes", "scan_backpressure_stalls", "scan_stall_ms",
               "host_over_budget_events", "host_bytes_high_water")


def tpch_port_queries(root: str = HERE) -> dict:
    """benchmarking/tpch/queries.py's ALL_QUERIES with its import rewritten
    to the port (nothing of daft_tpu is imported)."""
    import types

    path = os.path.join(root, "benchmarking", "tpch", "queries.py")
    src = open(path).read()
    check("from daft_tpu import col, lit" in src, f"{path}: the import to rewrite moved")
    mod = types.ModuleType("port_tpch_queries")
    exec(compile(src.replace("from daft_tpu import", "from daft_tpu_torch import"), path,
                 "exec"), mod.__dict__)
    return mod.ALL_QUERIES


def frames_bytes(frames: dict) -> int:
    """``size_bytes`` of the in-memory tables, as bench.py:1145 sums them."""
    return sum(_frame_batch(df).size_bytes() for df in frames.values())


def budget_of(frames: dict, fraction: float) -> int:
    return max(int(frames_bytes(frames) * fraction), 1 << 20)


def ooc_tables(frames: dict, lineitem_dir: str) -> dict:
    """The OOM capture's tables: lineitem read back from Parquet, the rest
    in memory."""
    import daft_tpu_torch as dt

    out = dict(frames)
    out["lineitem"] = dt.read_parquet(lineitem_dir)
    return out


def spill_counts(snap: dict) -> dict:
    from daft_tpu_torch.ops import counters

    out = {k: snap[k] for k in SPILL_PRINT}
    out["spill_io_overlap_seconds"] = counters.spill_overlap_seconds(snap)
    return out


def rss_high_water_bytes() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def device_counts(snap: dict) -> dict:
    return {k: snap[k] for k in DEVICE_COUNTERS}


def ooc_card_run(query, card_ctx):
    """One cold run of ``query`` on the card (the resident planes dropped
    first, the coalescer flushing by size alone): (result, ms, counter
    snapshot, fallback reasons)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    clear_residency()
    counters.reset()
    with dt_ctx(), dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS), card_ctx():
        t0 = time.perf_counter()
        got = query().to_pydict()
        _synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    reasons = sorted(r for r, n in dict(counters.rejections).items()
                     if "device fallback: " in r for _ in range(n))
    return got, ms, counters.snapshot(), reasons


def ooc_check_fallbacks(q: int, snap: dict, reasons: list, label: str) -> None:
    """The query's card run fell back exactly where OOC_FALLBACKS says."""
    want = OOC_FALLBACKS.get(q)
    check(snap["device_fallbacks"] == (1 if want else 0) and len(reasons) == snap[
        "device_fallbacks"] and all(want in r for r in reasons),
          f"ooc q{q} ({label}): fallbacks {snap['device_fallbacks']} {reasons}, expected "
          f"{'one for ' + repr(want) if want else 'none'}")
    for k in OOC_DEVICE[q]:
        check(snap[k] > 0, f"ooc q{q} ({label}): {k} did not move on the card")


def ooc_queries(queries: dict, tables: dict, card: str, budget: int, spill_dir: str) -> dict:
    """The nine queries three ways: (a) device_mode="off" unbudgeted, the
    expected result; (b) "off" under ``budget`` in one query scope, equal to
    (a) exactly; (c) "on" under ``budget`` on the card, equal to (a) by the
    exactness rule. Each query also runs on the card unbudgeted just
    before (c): both runs fall back exactly where OOC_FALLBACKS says, and
    (c)'s device stages feed, dispatch and launch what the unbudgeted run's
    do, count for count (OOC_STAGE_COUNTERS and every kernel's launches and
    plain calls). Returns {"ooc_q<n>": (c)'s launches}."""
    import contextlib

    import daft_tpu_torch as dt
    from daft_tpu_torch.memory import manager, reset_counters
    from daft_tpu_torch.ops import counters

    expected, paths = {}, {}
    for q in OOC_QUERIES:
        with dt.execution_config_ctx(device="cuda", device_mode="off"):
            t0 = time.perf_counter()
            expected[q] = queries[q](tables).to_pydict()
        off_s = time.perf_counter() - t0
        KNOWN[f"ooc q{q}"] = {"off_ms": off_s * 1e3, "want": expected[q]}
        print(f"ooc q{q} (a) off unbudgeted {off_s * 1e3:.1f} ms [{card}]", flush=True)
    counters.reset()
    reset_counters()
    manager().clear()
    with dt.execution_config_ctx(device="cuda", device_mode="off", memory_limit_bytes=budget,
                                 spill_dir=spill_dir):
        with manager().query_scope() as scope:
            for q in OOC_QUERIES:
                t0 = time.perf_counter()
                got = queries[q](tables).to_pydict()
                ms = (time.perf_counter() - t0) * 1e3
                check(got == expected[q], f"ooc q{q} under the budget (off) differs from its "
                                          "unbudgeted run")
                print(f"ooc q{q} (b) off budgeted {ms:.1f} ms, equal [{card}]", flush=True)
    snap = counters.snapshot()
    check(snap["spill_bytes"] > 0, "ooc (b): the budget never spilled")
    check(manager().tracked_bytes() == 0, "ooc (b): the ledger is not back at 0")
    print(f"ooc (b) counters: {json.dumps(spill_counts(snap), sort_keys=True)}; "
          f"host_bytes_high_water {manager().high_water_bytes()}, scope peak "
          f"{scope.peak_bytes()}, ru_maxrss {rss_high_water_bytes()} bytes [{card}]", flush=True)
    stage_keys = OOC_STAGE_COUNTERS + tuple(
        f"{kind}_{k}" for kind in ("launches", "plain") for k in counters.KERNEL_NAMES)
    for q in OOC_QUERIES:
        floats = OOC_FLOATS.get(q, ())

        def query(q=q):
            return queries[q](tables)

        got, ms0, snap0, reasons0 = ooc_card_run(query, contextlib.nullcontext)
        check(same_result(got, expected[q], floats),
              f"ooc q{q} unbudgeted on the card differs from (a)")
        KNOWN[f"ooc q{q}"].update(on_ms=ms0, on_what="cold, unbudgeted")
        ooc_check_fallbacks(q, snap0, reasons0, "unbudgeted on the card")
        reset_counters()
        manager().clear()
        scopes = []

        @contextlib.contextmanager
        def budgeted():
            with dt.execution_config_ctx(memory_limit_bytes=budget, spill_dir=spill_dir):
                with manager().query_scope() as scope:
                    scopes.append(scope)
                    yield

        got, ms, snap, reasons = ooc_card_run(query, budgeted)
        check(same_result(got, expected[q], floats),
              f"ooc q{q} under the budget on the card differs from (a)")
        ooc_check_fallbacks(q, snap, reasons, "under the budget on the card")
        check(reasons == reasons0, f"ooc q{q}: the fallbacks under the budget {reasons} are "
                                   f"not the unbudgeted run's {reasons0}")
        moved = {k: (snap0[k], snap[k]) for k in stage_keys if snap0[k] != snap[k]}
        check(not moved, f"ooc q{q}: under the budget the card's stages did other work "
                         f"(unbudgeted, budgeted): {moved}")
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        paths[f"ooc_q{q}"] = launches
        print(f"ooc q{q} (c) on budgeted {ms:.1f} ms (unbudgeted on the card {ms0:.1f} ms), "
              f"equal by the rule; device stages as unbudgeted "
              f"{json.dumps({k: snap[k] for k in OOC_STAGE_COUNTERS})}; fallbacks "
              f"{json.dumps(reasons)}; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}; "
              f"{json.dumps(spill_counts(snap), sort_keys=True)}; scope peak "
              f"{scopes[0].peak_bytes()}, ru_maxrss {rss_high_water_bytes()} [{card}]",
              flush=True)
    return paths


def sort_columns(parts) -> dict:
    """{column: numpy array} of a collected result's batches."""
    import numpy as np

    batches = [b for p in parts for b in p.batches]
    return {c: np.concatenate([b.get_column(c).to_numpy() for b in batches])
            for c in batches[0].column_names()} if batches else {}


def ooc_sort(lineitem_dir: str, budget: int, card: str, spill_dir: str) -> None:
    """bench.py:1228-1276's external sort: lineitem (its three sort keys
    and l_quantity) sorted by (l_extendedprice, l_orderkey, l_linenumber)
    under ``budget``, a sync leg (spill_io_threads=0,
    spill_prefetch_batches=0) and an async leg (the defaults); each equal to
    the in-memory sort as numpy arrays, tie order included."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.memory import manager, reset_counters
    from daft_tpu_torch.ops import counters

    def q():
        return dt.read_parquet(lineitem_dir).select(*SORT_COLUMNS).sort(list(SORT_KEYS))

    with dt.execution_config_ctx(device="cuda", device_mode="off"):
        t0 = time.perf_counter()
        want = sort_columns(q().collect()._result)
        mem_s = time.perf_counter() - t0
    print(f"ooc sort in memory {mem_s:.3f} s, {len(want['l_orderkey'])} rows [{card}]",
          flush=True)
    for leg, cfg in (("sync", {"spill_io_threads": 0, "spill_prefetch_batches": 0}),
                     ("async", {})):
        counters.reset()
        reset_counters()
        manager().clear()
        with dt.execution_config_ctx(device="cuda", device_mode="off",
                                     memory_limit_bytes=budget, spill_dir=spill_dir, **cfg):
            t0 = time.perf_counter()
            got = sort_columns(q().collect()._result)
            wall = time.perf_counter() - t0
        snap = counters.snapshot()
        for c in SORT_COLUMNS:
            check(np.array_equal(got[c], want[c]),
                  f"ooc sort ({leg}): {c} differs from the in-memory sort")
        check(snap["spill_runs"] >= 2, f"ooc sort ({leg}): {snap['spill_runs']} runs")
        print(f"ooc sort {leg}: wall {wall:.3f} s, equal to the in-memory sort; "
              f"{json.dumps(spill_counts(snap), sort_keys=True)} [{card}]", flush=True)


def ooc_joins(queries: dict, tables: dict, budget: int, card: str, spill_dir: str) -> dict:
    """The Grace join under ``budget``: q4 (its semi join's build side, the
    late lineitem keys, over the budget) in both device modes, and an inner
    join of lineitem with orders that feeds no aggregate, each equal to its
    unbudgeted run (the join's rows as a multiset: Grace partitions reorder
    them). Returns {"ooc_q4_grace": the card run's launches}."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.memory import manager, reset_counters
    from daft_tpu_torch.ops import counters

    paths = {}
    for mode in ("off", "on"):
        def mode_ctx():
            return dt_ctx() if mode == "on" else \
                dt.execution_config_ctx(device="cuda", device_mode="off")

        with mode_ctx():
            want = queries[4](tables).to_pydict()
        counters.reset()
        reset_counters()
        manager().clear()
        with mode_ctx(), dt.execution_config_ctx(memory_limit_bytes=budget,
                                                 spill_dir=spill_dir):
            t0 = time.perf_counter()
            got = queries[4](tables).to_pydict()
            ms = (time.perf_counter() - t0) * 1e3
        snap = counters.snapshot()
        check(got == want, f"ooc q4 under the 1 % budget ({mode}) differs from unbudgeted")
        check(snap["spill_files"] >= 16, f"ooc q4 ({mode}): the semi join did not "
                                         f"Grace-partition ({snap['spill_files']} files)")
        if mode == "on":
            paths["ooc_q4_grace"] = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        print(f"ooc q4 grace {mode}: {ms:.1f} ms, equal; spill_files {snap['spill_files']}; "
              f"{json.dumps(spill_counts(snap), sort_keys=True)} [{card}]", flush=True)

    def inner():
        L, O = tables["lineitem"], tables["orders"]
        return (L.select(col("l_orderkey"), col("l_linenumber"), col("l_extendedprice"))
                .join(O.select(col("o_orderkey"), col("o_orderdate")),
                      left_on="l_orderkey", right_on="o_orderkey"))

    def keyed(parts):
        c = sort_columns(parts)
        order = np.lexsort((c["l_linenumber"], c["l_orderkey"]))
        return {k: v[order] for k, v in c.items()}

    with dt.execution_config_ctx(device="cuda", device_mode="off"):
        want = keyed(inner().collect()._result)
    counters.reset()
    reset_counters()
    manager().clear()
    with dt.execution_config_ctx(device="cuda", device_mode="off", memory_limit_bytes=budget,
                                 spill_dir=spill_dir):
        t0 = time.perf_counter()
        got = keyed(inner().collect()._result)
        ms = (time.perf_counter() - t0) * 1e3
    snap = counters.snapshot()
    check(all(np.array_equal(got[k], want[k]) for k in want),
          "ooc inner join under the 1 % budget differs from unbudgeted")
    check(snap["spill_files"] >= 32, f"ooc inner join: {snap['spill_files']} spill files")
    print(f"ooc inner join: {len(got['l_orderkey'])} rows, {ms:.1f} ms, equal as a multiset; "
          f"{json.dumps(spill_counts(snap), sort_keys=True)} [{card}]", flush=True)
    return paths


def phase_ooc(frames: dict, lineitem_dir: str, card: str) -> dict:
    """bench.py's OOM capture on the port (out of core): the nine
    queries under B10 (10 % of the SF1 tables' size_bytes, at least 1 MiB)
    with lineitem from the scan phase's Parquet files, the external sort
    and the Grace joins under B1 (1 %). Spill goes to a temporary directory
    that the phase deletes. Returns {path: its card run's launches}."""
    from daft_tpu_torch.memory import manager

    phase("ooc")
    clear_residency()
    queries = tpch_port_queries()
    tables = ooc_tables(frames, lineitem_dir)
    b10, b1 = budget_of(frames, 0.10), budget_of(frames, 0.01)
    print(f"ooc tables {frames_bytes(frames)} bytes (size_bytes); B10 {b10}, B1 {b1} bytes "
          f"[{card}]", flush=True)
    spill_dir = tempfile.mkdtemp(prefix="daft_tpu_torch_spill_")
    t0 = time.perf_counter()
    try:
        paths = ooc_queries(queries, tables, card, b10, spill_dir)
        ooc_sort(lineitem_dir, b1, card, spill_dir)
        paths.update(ooc_joins(queries, tables, b1, card, spill_dir))
        check(os.listdir(spill_dir) == [], f"ooc: spill files left behind: "
                                           f"{os.listdir(spill_dir)[:5]}")
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
        manager().clear()
    print(f"ooc phase {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    return paths


def w1_frame(cols):
    import daft_tpu_torch as dt

    data = {c: cols[c] for c in W1_COLUMNS}
    data["l_shipdate"] = cols["l_shipdate"].astype("datetime64[D]")
    return dt.from_pydict(data)


def w1_query(df):
    """W1: over each supplier's lines (10,000 partitions) in ship-date
    order, row_number, rank, dense_rank, the running l_quantity sum, the
    previous line's price and the line's share of its supplier's price
    sum."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.functions import dense_rank, rank, row_number

    w = dt.Window().partition_by("l_suppkey").order_by("l_shipdate", "l_orderkey",
                                                       "l_linenumber")
    return df.select(
        col("l_orderkey"), col("l_linenumber"), col("l_suppkey"),
        row_number().over(w).alias("rn"), rank().over(w).alias("rk"),
        dense_rank().over(w).alias("drk"),
        col("l_quantity").sum().over(w.rows_between(dt.Window.unbounded_preceding,
                                                    dt.Window.current_row)).alias("run_qty"),
        col("l_extendedprice").lag(1).over(w).alias("prev_price"),
        (col("l_extendedprice") / col("l_extendedprice").sum().over(
            dt.Window().partition_by("l_suppkey"))).alias("share"))


def w1_keyed(parts) -> dict:
    """W1's result as numpy arrays ordered by (l_orderkey, l_linenumber),
    with prev_price's validity beside it."""
    import numpy as np

    batches = [b for p in parts for b in p.batches]
    out = {c: np.concatenate([b.get_column(c).to_numpy() for b in batches])
           for c in batches[0].column_names()}
    out["prev_valid"] = np.concatenate([b.get_column("prev_price").validity_numpy()
                                        for b in batches])
    order = np.lexsort((out["l_linenumber"], out["l_orderkey"]))
    return {k: v[order] for k, v in out.items()}


def w1_oracle(cols) -> dict:
    """row_number and the running l_quantity sum by numpy alone (a lexsort
    and a segmented cumsum), in lineitem's own row order (which is by
    l_orderkey, l_linenumber)."""
    import numpy as np

    order = np.lexsort((cols["l_linenumber"], cols["l_orderkey"], cols["l_shipdate"],
                        cols["l_suppkey"]))
    supp = cols["l_suppkey"][order]
    start = np.flatnonzero(np.r_[True, supp[1:] != supp[:-1]])
    seg = np.repeat(start, np.diff(np.r_[start, len(supp)]))
    rn = np.arange(len(supp)) - seg + 1
    csum = np.cumsum(cols["l_quantity"][order])
    run = csum - np.r_[0.0, csum][seg]
    out_rn = np.empty_like(rn)
    out_rn[order] = rn
    out_run = np.empty_like(run)
    out_run[order] = run
    return {"rn": out_rn, "run_qty": out_run}


def w2_query(t):
    """W2, the shape of TPC-DS q98 (benchmarking/tpcds/queries.py:218-259) on
    TPC-H tables: 30 days of lineitem joined to part, revenue by (p_brand,
    p_type), each group's share of its type's revenue, sorted, 100 rows."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import col, lit

    L, P = t["lineitem"], t["part"]
    agg = (L.where((col("l_shipdate") >= lit(W2_FROM)) & (col("l_shipdate") < lit(W2_TO)))
           .join(P, left_on="l_partkey", right_on="p_partkey")
           .groupby("p_brand", "p_type")
           .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue")))
    return (agg.with_column("revenueratio", col("revenue") * 100 / col("revenue").sum().over(
                dt.Window().partition_by("p_type")))
            .sort(["p_type", "p_brand", "revenueratio"]).limit(100))


W2_SQL = f"""
SELECT p_brand, p_type, revenue,
       revenue * 100 / SUM(revenue) OVER (PARTITION BY p_type) AS revenueratio
FROM (SELECT p_brand, p_type, SUM(l_extendedprice * (1 - l_discount)) AS revenue
      FROM lineitem JOIN part ON l_partkey = p_partkey
      WHERE l_shipdate >= DATE '{W2_FROM}' AND l_shipdate < DATE '{W2_TO}'
      GROUP BY p_brand, p_type)
ORDER BY p_type, p_brand, revenueratio
LIMIT 100
"""
W2_FLOATS = ("revenue", "revenueratio")


def w2_inputs(cols, dims, dev) -> dict:
    """W2's kernel inputs at SF1, as its device join run builds them: K4's
    build over part's keys and its probe of every lineitem row's l_partkey
    (the date filter is evaluated in the stage), the codes (the row's part's
    p_brand dictionary code times p_type's 150 plus p_type's code, where
    the row's ship date is in the 30 days; trash W2_CAP elsewhere), K1's
    rows and revenue-count planes, K2's first-row-index plane and K7's f32
    revenue plane."""
    import numpy as np
    import torch

    n = len(cols["l_orderkey"])
    part = dims["part"]
    brand, _k_brand = first_occurrence_codes(np.asarray(P_BRANDS, dtype=object)[part["p_brand"]])
    ptype, k_type = first_occurrence_codes(np.asarray(P_TYPES, dtype=object)[part["p_type"]])
    prow = cols["l_partkey"] - 1
    ship = cols["l_shipdate"]
    keep_np = (ship >= days(W2_FROM)) & (ship < days(W2_TO))
    keep = torch.zeros(BUCKET, dtype=torch.bool)
    keep[:n] = torch.from_numpy(keep_np)
    codes = torch.full((BUCKET,), W2_CAP, dtype=torch.int32)
    codes[:n] = torch.from_numpy(np.where(keep_np, brand[prow] * k_type + ptype[prow],
                                          W2_CAP).astype(np.int32))
    price = torch.zeros(BUCKET, dtype=torch.float32)
    price[:n] = torch.from_numpy(cols["l_extendedprice"].astype(np.float32))
    disc = torch.zeros(BUCKET, dtype=torch.float32)
    disc[:n] = torch.from_numpy(cols["l_discount"].astype(np.float32))
    kf = keep.float().to(dev)
    keys, valid = fact_keys_on(cols, "l_partkey", dev)
    return {"cap": W2_CAP, "codes": codes.to(dev), "planes": [kf, kf.clone()],
            "first": [torch.where(keep, torch.arange(BUCKET, dtype=torch.float32),
                                  torch.tensor(float("inf"))).to(dev)],
            "revenue": [torch.where(keep, price * (1 - disc), 0.0).to(dev)],
            "dim_keys": torch.from_numpy(part["p_partkey"]).to(dev), "keys": keys,
            "valid": valid, "groups": len(set(zip(brand.tolist(), ptype.tolist())))}


def w2_oracle(lineitem, dims) -> dict:
    """W2's 100 rows by numpy alone (sums in f64)."""
    import numpy as np

    part = dims["part"]
    ship = lineitem["l_shipdate"]
    keep = (ship >= days(W2_FROM)) & (ship < days(W2_TO))
    prow = lineitem["l_partkey"][keep] - 1
    rev = (lineitem["l_extendedprice"] * (1 - lineitem["l_discount"]))[keep]
    sums: dict = {}
    for b, t, r in zip(part["p_brand"][prow].tolist(), part["p_type"][prow].tolist(),
                       rev.tolist()):
        sums[(P_BRANDS[b], P_TYPES[t])] = sums.get((P_BRANDS[b], P_TYPES[t]), 0.0) + r
    by_type: dict = {}
    for (b, t), r in sums.items():
        by_type[t] = by_type.get(t, 0.0) + r
    rows = sorted((t, b, r, r * 100 / by_type[t]) for (b, t), r in sums.items())
    rows.sort(key=lambda x: (x[0], x[1], x[3]))
    rows = rows[:100]
    return {"p_brand": [r[1] for r in rows], "p_type": [r[0] for r in rows],
            "revenue": [r[2] for r in rows], "revenueratio": [r[3] for r in rows]}


def phase_window(lineitem, dims, frames: dict, card: str) -> dict:
    """Windows. W1 over SF1 lineitem's first W1_ROWS rows in memory:
    unbudgeted and under B1, where the Grace window takes 16 partitions a spec; equal as
    rows keyed by (l_orderkey, l_linenumber) (ranks, integers and the
    whole-number running sum exactly, the share within rtol 1e-5), and
    row_number and the running sum equal to a numpy oracle. W2 (q98's
    shape) as a DataFrame and in SQL on the card (the aggregate as the
    device join stage: K4, K1, K2, K7), equal to each other, to the
    device_mode="off" run and to a numpy oracle; warm medians, launches and
    a profile each. Returns {path: launches}."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.memory import manager, reset_counters
    from daft_tpu_torch.ops import counters

    phase("window")
    clear_residency()
    start = time.perf_counter()
    paths = {}
    b1 = budget_of(frames, 0.01)
    w1 = {c: lineitem[c][:W1_ROWS] for c in W1_COLUMNS}
    df = w1_frame(w1)
    with dt_ctx():
        t0 = time.perf_counter()
        want = w1_keyed(w1_query(df).collect()._result)
        mem_s = time.perf_counter() - t0
    oracle = w1_oracle(w1)
    check(np.array_equal(want["rn"], oracle["rn"]), "W1: row_number differs from numpy")
    check(np.array_equal(want["run_qty"], oracle["run_qty"]),
          "W1: the running l_quantity sum differs from numpy")
    spill_dir = tempfile.mkdtemp(prefix="daft_tpu_torch_spill_")
    try:
        counters.reset()
        reset_counters()
        manager().clear()
        with dt_ctx(), dt.execution_config_ctx(memory_limit_bytes=b1, spill_dir=spill_dir):
            with manager().query_scope() as scope:
                t0 = time.perf_counter()
                got = w1_keyed(w1_query(df).collect()._result)
                b1_s = time.perf_counter() - t0
        snap = counters.snapshot()
        check(os.listdir(spill_dir) == [], "W1: spill files left behind")
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    for c in ("l_orderkey", "l_linenumber", "l_suppkey", "rn", "rk", "drk", "run_qty",
              "prev_valid"):
        check(np.array_equal(got[c], want[c]), f"W1 under B1: {c} differs from unbudgeted")
    pv = want["prev_valid"]
    check(np.array_equal(got["prev_price"][pv], want["prev_price"][pv]),
          "W1 under B1: prev_price differs")
    check(np.allclose(got["share"], want["share"], rtol=1e-5, atol=0.0),
          "W1 under B1: the price share differs past rtol 1e-5")
    check(snap["spill_files"] >= 32, f"W1 under B1: {snap['spill_files']} spill files, not "
                                     "16 for each of its two specs")
    print(f"W1: {len(got['rn'])} rows, {len(np.unique(w1['l_suppkey']))} partitions; "
          f"unbudgeted {mem_s:.3f} s, under B1 ({b1} bytes) {b1_s:.3f} s, equal, row_number "
          f"and the running sum equal to numpy; {json.dumps(spill_counts(snap), sort_keys=True)};"
          f" scope peak {scope.peak_bytes()}, ru_maxrss {rss_high_water_bytes()} [{card}]",
          flush=True)
    del df, want, got

    t = {"lineitem": frames["lineitem"], "part": frames["part"]}
    sess = dt.current_session()
    sess.create_temp_table("lineitem", t["lineitem"])
    sess.create_temp_table("part", t["part"])
    try:
        oracle = w2_oracle(lineitem, dims)
        with dt.execution_config_ctx(device="cuda", device_mode="off"):
            host = w2_query(t).to_pydict()
        check(same_result(host, oracle, W2_FLOATS), "W2 off differs from the numpy oracle")
        for label, query in (("W2", lambda: w2_query(t)), ("W2 sql", lambda: dt.sql(W2_SQL))):
            clear_residency()  # each form's cold run builds K4's table itself
            got, launches = run_cell(label, query, ("hash_probe_build", "hash_probe_index",
                                                    "segment_sum_planes",
                                                    "segment_extreme_planes",
                                                    "segment_sum_float_planes"),
                                     card, W2_FLOATS, oracle, "device_join_batches")
            check(same_result(got, host, W2_FLOATS), f"{label} differs from the off run")
            phase_profile(lambda: query().to_pydict(), card, f"{label} profile")
            paths[label.replace(" ", "_")] = launches
            if label == "W2":
                frame_result = got
            else:
                check(same_result(got, frame_result, W2_FLOATS),
                      "W2 in SQL differs from its DataFrame form")
    finally:
        sess.drop_temp_table("lineitem")
        sess.drop_temp_table("part")
    print(f"window phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return paths


# ---- functions: the expression surface's device ops in the stage program --------

FUNCTIONS_FLOATS = ("log10_net", "sqrt_qty", "dist_30k", "tax_round1", "disc_sq",
                    "disc_clip", "exp_disc")
FUNCTIONS_KERNELS = ("segment_sum_planes", "segment_extreme_planes", "segment_extreme_int64",
                     "segment_sum_float_planes")


def functions_frame(lineitem):
    """The functions cell's DataFrame over SF1 lineitem: flags and statuses
    as strings."""
    import numpy as np

    import daft_tpu_torch as dt

    return dt.from_pydict({
        "l_returnflag": np.array(RETURNFLAGS, dtype=object)[lineitem["l_returnflag"]],
        "l_linestatus": np.array(LINESTATUS, dtype=object)[lineitem["l_linestatus"]],
        **{c: lineitem[c] for c in ("l_orderkey", "l_partkey", "l_linenumber", "l_quantity",
                                    "l_extendedprice", "l_discount", "l_tax")}})


def functions_query(df):
    """A fact filter of ``is_in`` and ``%`` and eight aggregates of the
    device ops and functions (log10, sqrt, //, abs, round, **, clip, exp),
    grouped by flag and status; the float min makes the stage f64."""
    from daft_tpu_torch import col

    return (df.where(col("l_linenumber").is_in([1, 3, 5]) & ((col("l_orderkey") % 7) != 0))
            .groupby("l_returnflag", "l_linestatus")
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).log10().sum()
                 .alias("log10_net"),
                 col("l_quantity").sqrt().mean().alias("sqrt_qty"),
                 (col("l_partkey") // 1000).max().alias("part_k"),
                 (col("l_extendedprice") - 30000).abs().min().alias("dist_30k"),
                 col("l_tax").round(1).sum().alias("tax_round1"),
                 (col("l_discount") ** 2).sum().alias("disc_sq"),
                 col("l_discount").clip(0.02, 0.08).mean().alias("disc_clip"),
                 (col("l_discount") * 10).exp().sum().alias("exp_disc"),
                 col("l_orderkey").count().alias("n"))
            .sort(["l_returnflag", "l_linestatus"]))


def functions_oracle(cols) -> dict:
    """The functions cell's answer with numpy alone, in f64."""
    import numpy as np

    keep = np.isin(cols["l_linenumber"], [1, 3, 5]) & (cols["l_orderkey"] % 7 != 0)
    code = cols["l_returnflag"][keep].astype(np.int64) * 2 + cols["l_linestatus"][keep]
    price, disc = cols["l_extendedprice"][keep], cols["l_discount"][keep]
    qty, tax, pk = cols["l_quantity"][keep], cols["l_tax"][keep], cols["l_partkey"][keep]
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "log10_net", "sqrt_qty", "part_k",
                           "dist_30k", "tax_round1", "disc_sq", "disc_clip", "exp_disc", "n")}
    for c in sorted(np.unique(code).tolist(), key=lambda c: (RETURNFLAGS[c // 2],
                                                             LINESTATUS[c % 2])):
        rows = code == c
        out["l_returnflag"].append(RETURNFLAGS[c // 2])
        out["l_linestatus"].append(LINESTATUS[c % 2])
        out["log10_net"].append(float(np.log10(price[rows] * (1 - disc[rows])).sum()))
        out["sqrt_qty"].append(float(np.sqrt(qty[rows]).mean()))
        out["part_k"].append(int((pk[rows] // 1000).max()))
        out["dist_30k"].append(float(np.abs(price[rows] - 30000).min()))
        out["tax_round1"].append(float(np.round(tax[rows], 1).sum()))
        out["disc_sq"].append(float((disc[rows] ** 2).sum()))
        out["disc_clip"].append(float(np.clip(disc[rows], 0.02, 0.08).mean()))
        out["exp_disc"].append(float(np.exp(disc[rows] * 10).sum()))
        out["n"].append(int(rows.sum()))
    return out


def phase_functions(lineitem, card: str) -> dict:
    """The functions cell on the card: the filter and the eight function
    aggregates plan as one DeviceGroupedAgg (no rejection, no fallback),
    equal to the device_mode="off" run and to the numpy oracle (integers
    exactly, floats within rtol 1e-5); cold and warm times, launches and a
    profile. Returns {"functions": launches}."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import physical as pp

    phase("functions")
    clear_residency()
    start = time.perf_counter()
    df = functions_frame(lineitem)
    with dt_ctx():
        plan = pp.translate(functions_query(df).optimized_plan())
    node = plan.input if isinstance(plan, pp.PhysSort) else plan
    check(type(node).__name__ == "DeviceGroupedAgg",
          f"functions: the aggregate planned as {type(node).__name__}, not DeviceGroupedAgg")
    oracle = functions_oracle(lineitem)
    _got, launches = run_cell("functions", lambda: functions_query(df), FUNCTIONS_KERNELS,
                              card, FUNCTIONS_FLOATS, oracle)
    phase_profile(lambda: functions_query(df).to_pydict(), card, "functions profile")
    print(f"functions phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return {"functions": launches}


# ---- temporal: timestamps, durations and zones at SF1 ----------------------------

US_PER_DAY = 86_400_000_000
T1_FROM = datetime.datetime(1995, 1, 1, 6, 30)
T1_TO = datetime.datetime(1996, 1, 1, 6, 30)
T1_TRANSIT = datetime.timedelta(days=20)
T1_KERNELS = ("segment_sum_planes", "segment_sum_float_planes", "segment_extreme_int64")
T1_FLOATS = ("revenue",)
T1_SQL = """SELECT l_returnflag, l_linestatus, COUNT(*) AS n, SUM(l_extendedprice) AS revenue,
  MIN(l_shipts) AS first_ship, MAX(l_shipts) AS last_ship,
  MIN(l_receiptts - l_shipts) AS min_transit, MAX(l_receiptts - l_shipts) AS max_transit
FROM lineitem
WHERE l_shipts >= TIMESTAMP '1995-01-01 06:30:00' AND l_shipts < TIMESTAMP '1996-01-01 06:30:00'
  AND l_receiptts - l_shipts > INTERVAL '20' DAY
GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus"""
T2_ZONE = "America/New_York"
T2_KERNELS = ("segment_sum_planes", "segment_extreme_int64")
TEMPORAL_WINDOW_ROWS = 3   # the windowed stddev / var frame: 3 preceding rows
TEMPORAL_HOST_ROWS = 1_500_000  # the window's and the plan surface's rows (6 M until PR 24)
SAMPLE_FRACTION, SAMPLE_SEED = 0.01, 7
INTO_BATCH_ROWS = 131072
TEMPORAL_WRAPPERS = {"segment_sum_planes": "segment_kernels",
                     "segment_sum_float_planes": "segment_kernels",
                     "segment_extreme_int64": "segment_kernels"}


def temporal_columns(lineitem) -> dict:
    """l_shipts and l_receiptts: the day's date in microseconds plus a
    seeded microsecond of the day (int64 storage)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 22)
    n = len(lineitem["l_shipdate"])
    return {"l_shipts": lineitem["l_shipdate"].astype(np.int64) * US_PER_DAY
            + rng.integers(0, US_PER_DAY, n),
            "l_receiptts": lineitem["l_receiptdate"].astype(np.int64) * US_PER_DAY
            + rng.integers(0, US_PER_DAY, n)}


def temporal_frame(lineitem, ts: dict, order=None, t1_only: bool = False):
    """The temporal cells' DataFrame: flags and statuses as strings, price,
    supplier and the two timestamp columns (T1's alone with ``t1_only``),
    rows in ``order`` when given."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.core.series import Series

    idx = np.arange(len(ts["l_shipts"])) if order is None else order
    data = {
        "l_returnflag": np.array(RETURNFLAGS, dtype=object)[lineitem["l_returnflag"][idx]],
        "l_linestatus": np.array(LINESTATUS, dtype=object)[lineitem["l_linestatus"][idx]],
        "l_extendedprice": lineitem["l_extendedprice"][idx]}
    if not t1_only:
        data["l_suppkey"] = lineitem["l_suppkey"][idx]
    for c in ("l_shipts", "l_receiptts"):
        data[c] = Series.from_numpy(ts[c][idx], c, dt.DataType.timestamp("us"))
    return dt.from_pydict(data)


def t1_query(df):
    """T1: a filter by TIMESTAMP literals and a transit over 20 days, then
    count, sum and the extremes of a timestamp and a duration by flag and
    status."""
    from daft_tpu_torch import col, lit

    transit = col("l_receiptts") - col("l_shipts")
    return (df.where((col("l_shipts") >= lit(T1_FROM)) & (col("l_shipts") < lit(T1_TO))
                     & (transit > lit(T1_TRANSIT)))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_extendedprice").count().alias("n"),
                 col("l_extendedprice").sum().alias("revenue"),
                 col("l_shipts").min().alias("first_ship"),
                 col("l_shipts").max().alias("last_ship"),
                 transit.min().alias("min_transit"), transit.max().alias("max_transit"))
            .sort(["l_returnflag", "l_linestatus"]))


def _us_datetime(v: int):
    return datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(v))


def t1_oracle(lineitem, ts: dict) -> dict:
    """T1 by numpy alone (the sum in f64, the extremes as storage ints)."""
    import numpy as np

    ship, rec = ts["l_shipts"], ts["l_receiptts"]
    lo = int((T1_FROM - datetime.datetime(1970, 1, 1)) / datetime.timedelta(microseconds=1))
    hi = int((T1_TO - datetime.datetime(1970, 1, 1)) / datetime.timedelta(microseconds=1))
    transit = rec - ship
    keep = (ship >= lo) & (ship < hi) & (transit > 20 * US_PER_DAY)
    code = lineitem["l_returnflag"][keep].astype(np.int64) * 2 + lineitem["l_linestatus"][keep]
    price, ship_k, tr_k = lineitem["l_extendedprice"][keep], ship[keep], transit[keep]
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "n", "revenue", "first_ship",
                           "last_ship", "min_transit", "max_transit")}
    for c in sorted(np.unique(code).tolist(), key=lambda c: (RETURNFLAGS[c // 2],
                                                             LINESTATUS[c % 2])):
        rows = code == c
        out["l_returnflag"].append(RETURNFLAGS[c // 2])
        out["l_linestatus"].append(LINESTATUS[c % 2])
        out["n"].append(int(rows.sum()))
        out["revenue"].append(float(price[rows].sum()))
        out["first_ship"].append(_us_datetime(ship_k[rows].min()))
        out["last_ship"].append(_us_datetime(ship_k[rows].max()))
        out["min_transit"].append(datetime.timedelta(microseconds=int(tr_k[rows].min())))
        out["max_transit"].append(datetime.timedelta(microseconds=int(tr_k[rows].max())))
    return out


def zone_hours(us, zone: str):
    """The local hour of each UTC microsecond in ``zone`` by Python's
    zoneinfo alone: one utcoffset per distinct UTC hour (every transition
    of the zone falls on a UTC hour over lineitem's years)."""
    import zoneinfo

    import numpy as np

    hours = us // 3_600_000_000
    uniq, inv = np.unique(hours, return_inverse=True)
    zi = zoneinfo.ZoneInfo(zone)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    off = np.array([int((epoch + datetime.timedelta(hours=int(h))).astimezone(zi)
                        .utcoffset().total_seconds()) for h in uniq.tolist()], dtype=np.int64)
    local = us + off[inv] * 1_000_000
    return (local // 3_600_000_000) % 24


def grouped_oracle(keys, transit, key_value=int) -> dict:
    """count and max transit by key, keys ascending (numpy)."""
    import numpy as np

    order = np.argsort(keys, kind="stable")
    k, t = keys[order], transit[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    counts = np.diff(np.r_[starts, len(k)])
    mx = np.maximum.reduceat(t, starts)
    return {"key": [key_value(v) for v in k[starts].tolist()], "n": counts.tolist(),
            "max_transit": [datetime.timedelta(microseconds=int(v)) for v in mx.tolist()]}


def t2_queries(df) -> dict:
    """T2's three grouped cells: the key a host function of l_shipts."""
    from daft_tpu_torch import col

    transit = col("l_receiptts") - col("l_shipts")
    ny = col("l_shipts")._fn("replace_time_zone", tz="UTC")._fn("convert_time_zone",
                                                                 tz=T2_ZONE)
    keys = {"hour": col("l_shipts").dt.hour(), "ny_hour": ny.dt.hour(),
            "day": col("l_shipts").dt.truncate("1 day")}

    def query(key):
        return lambda: (df.with_column("key", key).groupby("key")
                        .agg(col("l_shipts").count().alias("n"),
                             transit.max().alias("max_transit"))
                        .sort("key"))
    return {name: query(k) for name, k in keys.items()}


def temporal_window_query(df):
    """Windowed stddev and var of l_extendedprice by supplier over the three
    preceding rows and the current one, in l_shipts order."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    w = dt.Window().partition_by("l_suppkey").order_by("l_shipts") \
        .rows_between(-TEMPORAL_WINDOW_ROWS, dt.Window.current_row)
    return df.select(col("l_suppkey"), col("l_extendedprice").stddev().over(w).alias("sd"),
                     col("l_extendedprice").var().over(w).alias("var"))


def temporal_window_oracle(lineitem, ts: dict) -> dict:
    """The window's sd and var by numpy: rows sorted by (supplier, l_shipts,
    row), each frame's sums of x and x^2 as differences of f64 prefix sums
    over the sorted rows (the reference's arithmetic), in input row order,
    and the bound their rounding puts on var ("bound")."""
    import numpy as np

    n = len(ts["l_shipts"])
    order = np.lexsort((np.arange(n), ts["l_shipts"], lineitem["l_suppkey"]))
    supp = lineitem["l_suppkey"][order]
    x = lineitem["l_extendedprice"][order].astype(np.float64)
    start = np.flatnonzero(np.r_[True, supp[1:] != supp[:-1]])
    seg = np.repeat(start, np.diff(np.r_[start, n]))
    hi = np.arange(n)
    lo = np.maximum(hi - TEMPORAL_WINDOW_ROWS, seg)
    cs = np.concatenate([[0.0], np.cumsum(x)])
    csq = np.concatenate([[0.0], np.cumsum(x * x)])
    cnt = (hi - lo + 1).astype(np.int64)
    m = (cs[hi + 1] - cs[lo]) / cnt
    var = np.maximum((csq[hi + 1] - csq[lo]) / cnt - m * m, 0.0)
    out_var = np.empty(n)
    out_var[order] = var
    out_sd = np.empty(n)
    out_sd[order] = np.sqrt(var)
    # a prefix sum of x^2 taken in another row order rounds differently: each
    # frame's sum of squares is good to a few ulps of the whole sum
    bound = 8 * float(np.finfo(np.float64).eps) * float(csq[-1])
    return {"sd": out_sd, "var": out_var, "bound": bound}


def temporal_kernel_cases(df, kernel_results: dict, card: str) -> None:
    """K1, K7 and K3 at the inputs T1's cold run gave them (residency
    cleared), each held against its plain version with its times and
    bound, into ``kernel_results`` under "at_t1_..."; the capture's
    launches fall outside every counted run."""
    import torch

    from daft_tpu_torch.ops import segment_kernels as sk

    clear_residency()
    with dt_ctx():
        calls = capture_kernel_calls(lambda: t1_query(df).to_pydict(), TEMPORAL_WRAPPERS)
    new = {}
    for wrapper, seen in calls.items():
        check(len(seen) > 0, f"T1: {wrapper} was not called")
    for i, ((planes, codes, cap), _out) in enumerate(calls["segment_sum_planes"]):
        new[("segment_sum_planes", f"at_t1_cap{cap}_{i}")] = plane_case(sk, "sum", planes,
                                                                        codes, cap)
    for i, ((planes, codes, cap), _out) in enumerate(calls["segment_sum_float_planes"]):
        new[("segment_sum_float_planes", f"at_t1_cap{cap}_{i}")] = k7_case(
            sk, planes, codes, cap, f"t1 cap {cap}")
    for i, ((v, keep, codes, cap, op), _out) in enumerate(calls["segment_extreme_int64"]):
        new[("segment_extreme_int64", f"at_t1_cap{cap}_{op}{i}")] = k3_case(sk, v, keep, codes,
                                                                            cap, op)
    for (kname, label), case in new.items():
        kernel_results[kname][label] = case
    del calls
    torch.cuda.empty_cache()
    print_cases({f"{k} {label}": case for (k, label), case in new.items()}, card)


def phase_temporal(lineitem, card: str, kernel_results: dict) -> dict:
    """Timestamps, durations and zones at SF1 on the card (the module
    docstring's 20c). Returns {path: the cold run's launches}."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import col, lit
    from daft_tpu_torch.core import temporal
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import physical as pp

    phase("temporal")
    start = time.perf_counter()
    clear_residency()
    print(f"zone database: {temporal.zone_database()}; {T2_ZONE} read from "
          f"{temporal.get_zone(T2_ZONE).source}", flush=True)
    paths = {}
    t0 = time.perf_counter()
    ts = temporal_columns(lineitem)
    df = temporal_frame(lineitem, ts)
    n = len(ts["l_shipts"])
    print(f"temporal frame {time.perf_counter() - t0:.2f} s ({n} rows, "
          f"{2 * 8 * n} bytes of timestamp planes)", flush=True)

    # T1, as a DataFrame and in SQL: one fused region under a DeviceGroupedAgg
    with dt_ctx():
        plan = pp.translate(t1_query(df).optimized_plan())
    region_plan_check("T1", plan, pp.DeviceGroupedAgg, ("project", "filter", "agg"))

    def k3_checks(label):
        def checks(snap, warm):
            got = snap[f"{CELL_KERNEL_PREFIX}segment_extreme_int64"]
            print(f"{label}: K3 launches {got} cold, "
                  f"{warm[f'{CELL_KERNEL_PREFIX}segment_extreme_int64']} in "
                  f"{warm['warm_runs']} warm runs")
            check(got >= 4, f"{label}: K3 launched {got} times, not at least 4")
        return checks

    oracle = t1_oracle(lineitem, ts)
    t1_result, paths["temporal_t1"] = run_cell(
        "T1", lambda: t1_query(df), T1_KERNELS, card, T1_FLOATS, oracle,
        extra_checks=k3_checks("T1"))
    _got, paths["temporal_t1_sql"] = run_cell(
        "T1 sql", lambda: dt.sql(T1_SQL, lineitem=df), T1_KERNELS, card, T1_FLOATS, oracle,
        extra_checks=k3_checks("T1 sql"))

    # T2: host functions at SF1, each timed, feeding grouped device stages
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        for label, e in (("dt.hour", col("l_shipts").dt.hour()),
                         ("replace_time_zone(UTC) + convert_time_zone(New_York)",
                          col("l_shipts")._fn("replace_time_zone", tz="UTC")
                          ._fn("convert_time_zone", tz=T2_ZONE)),
                         (f"dt.hour in {T2_ZONE}",
                          col("l_shipts")._fn("replace_time_zone", tz="UTC")
                          ._fn("convert_time_zone", tz=T2_ZONE).dt.hour()),
                         ("dt.truncate('1 day')", col("l_shipts").dt.truncate("1 day")),
                         ("total_hours", (col("l_receiptts") - col("l_shipts")).total_hours())):
            ms = statistics.median(time_s(lambda e=e: df.select(e.alias("out")).collect())) \
                * 1e3
            print(f"T2 host function {label}: {ms:.1f} ms over {n} rows (host clock, "
                  f"median of 3) [{card}]", flush=True)
        hours = df.select((col("l_receiptts") - col("l_shipts")).total_hours().alias("h")) \
            .to_pydict()["h"]
    check(np.array_equal(np.asarray(hours), (ts["l_receiptts"] - ts["l_shipts"])
                         // 3_600_000_000), "T2: total_hours differs from numpy")
    transit = ts["l_receiptts"] - ts["l_shipts"]
    t2_keys = {"hour": (ts["l_shipts"] // 3_600_000_000) % 24,
               "ny_hour": zone_hours(ts["l_shipts"], T2_ZONE),
               "day": ts["l_shipts"] // US_PER_DAY * US_PER_DAY}
    for name, query in t2_queries(df).items():
        key_value = _us_datetime if name == "day" else int
        want = grouped_oracle(t2_keys[name], transit, key_value)
        _got, paths[f"temporal_t2_{name}"] = run_cell(
            f"T2 {name}", query, T2_KERNELS, card, (), want)

    # T1 file-fed: sorted by l_shipts so the timestamp statistics prune
    root = tempfile.mkdtemp(prefix="daft_tpu_torch_temporal_")
    try:
        d = os.path.join(root, "lineitem_ts")
        t0 = time.perf_counter()
        sorted_df = temporal_frame(lineitem, ts, np.argsort(ts["l_shipts"], kind="stable"),
                                   t1_only=True)
        with dt_ctx():
            sorted_df.write_parquet(d)
        print(f"T1 file: wrote {d} in {time.perf_counter() - t0:.2f} s", flush=True)
        del sorted_df

        def pruned(snap, warm):
            check(snap["scan_row_groups_pruned"] > 0,
                  "T1 file: the timestamp statistics pruned no row group")
            print(f"T1 file: row groups read {snap['scan_row_groups']}, pruned "
                  f"{snap['scan_row_groups_pruned']}", flush=True)

        clear_residency()
        paths["temporal_t1_file"] = scan_cell(
            "T1 file", lambda: t1_query(dt.read_parquet(d)), T1_KERNELS, t1_result,
            T1_FLOATS, card, "device_grouped_batches", extra=pruned, host_ops=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the host-only sweeps (the window, the plan surface) over the first
    # TEMPORAL_HOST_ROWS rows
    hn = min(n, TEMPORAL_HOST_ROWS)
    h_li = {c: lineitem[c][:hn] for c in ("l_returnflag", "l_linestatus", "l_extendedprice",
                                          "l_suppkey")}
    h_ts = {c: v[:hn] for c, v in ts.items()}
    hdf = temporal_frame(h_li, h_ts)

    # windowed stddev / var: var within the prefix sums' rounding of numpy's
    t0 = time.perf_counter()
    with dt_ctx():
        got = temporal_window_query(hdf).to_pydict()
    win_ms = (time.perf_counter() - t0) * 1e3
    want = temporal_window_oracle(h_li, h_ts)
    g_var, g_sd = (np.asarray(got[c], dtype=np.float64) for c in ("var", "sd"))
    err = float(np.abs(g_var - want["var"]).max())
    check(err <= want["bound"], f"windowed var differs from numpy by {err}, past the prefix "
                                f"sums' rounding bound {want['bound']}")
    check(np.array_equal(g_sd, np.sqrt(g_var)), "windowed stddev is not sqrt(var)")
    print(f"window stddev/var over {hn} rows by supplier, 3 preceding in l_shipts order: "
          f"{win_ms:.1f} ms (host clock); var within {err:.3g} of numpy (bound "
          f"{want['bound']:.3g}: the f64 prefix sums' rounding, summed in another partition "
          f"order), stddev its sqrt bit for bit [{card}]", flush=True)

    # the plan surface, each held to "off"
    # which rows the sample keeps is held to the JAX package's (the same rows
    # for the same seed) by tests/test_torch_temporal.py; here the kept count
    # is held to the binomial law, and each supplier's rows to its own
    got, paths["temporal_sample"] = run_cell(
        "sample -> groupby", lambda: (df.sample(SAMPLE_FRACTION, seed=SAMPLE_SEED)
                                      .groupby("l_suppkey")
                                      .agg(col("l_extendedprice").count().alias("n"),
                                           col("l_extendedprice").sum().alias("revenue"))
                                      .sort("l_suppkey")),
        ("segment_sum_planes", "segment_sum_float_planes"), card, ("revenue",))
    kept, sd = sum(got["n"]), (n * SAMPLE_FRACTION * (1 - SAMPLE_FRACTION)) ** 0.5
    check(abs(kept - n * SAMPLE_FRACTION) <= 6 * sd,
          f"sample kept {kept} of {n} rows, past 6 sd ({sd:.1f}) of {n * SAMPLE_FRACTION}")
    full = np.bincount(lineitem["l_suppkey"])
    check(all(c <= full[k] for k, c in zip(got["l_suppkey"], got["n"])),
          "sample: a supplier kept more rows than it has")
    print(f"sample: kept {kept} of {n} rows (binomial mean {n * SAMPLE_FRACTION:.1f}, sd "
          f"{sd:.1f}) [{card}]", flush=True)
    q6_df = q6_frame(lineitem)
    _got, paths["temporal_into_batches_q6"] = run_cell(
        "into_batches -> q6", lambda: q6_query(q6_df.into_batches(INTO_BATCH_ROWS)), (), card,
        ("revenue",), q6_oracle(lineitem), counter="device_stage_batches")
    del q6_df
    flags = hdf.select("l_suppkey", "l_returnflag", "l_linestatus", "l_extendedprice")
    t0 = time.perf_counter()
    with dt_ctx():
        unp = flags.unpivot(["l_suppkey"], ["l_returnflag", "l_linestatus"]).to_pydict()
        piv = flags.pivot("l_returnflag", "l_linestatus", "l_extendedprice", "sum") \
            .sort("l_returnflag").to_pydict()
        rows = hdf.where(col("l_shipts") >= lit(T1_FROM)).count_rows()
        ids = hdf.into_partitions(4).add_monotonically_increasing_id().select("id") \
            .to_pydict()["id"]
    surface_ms = (time.perf_counter() - t0) * 1e3
    with dt.execution_config_ctx(device_mode="off"):
        check(unp == flags.unpivot(["l_suppkey"], ["l_returnflag", "l_linestatus"])
              .to_pydict(), "unpivot differs from off")
        check(same_result(piv, flags.pivot("l_returnflag", "l_linestatus", "l_extendedprice",
                                           "sum").sort("l_returnflag").to_pydict(),
                          ("F", "O")), "pivot differs from off")
        check(rows == hdf.where(col("l_shipts") >= lit(T1_FROM)).count_rows(),
              "count_rows differs from off")
    check(len(unp["value"]) == 2 * hn and unp["value"][:2] == [
        RETURNFLAGS[lineitem["l_returnflag"][0]], LINESTATUS[lineitem["l_linestatus"][0]]],
        "unpivot: rows or values differ from numpy")
    code = h_li["l_returnflag"].astype(np.int64) * 2 + h_li["l_linestatus"]
    sums = np.bincount(code, weights=h_li["l_extendedprice"], minlength=6)
    for i, f in enumerate(piv["l_returnflag"]):
        for s_i, st in enumerate(LINESTATUS):
            v = piv[st][i]
            w = sums[RETURNFLAGS.index(f) * 2 + s_i]
            check((v is None and w == 0) or abs(v - w) <= 1e-9 * abs(w),
                  f"pivot {f}/{st} differs from numpy")
    lo = int((T1_FROM - datetime.datetime(1970, 1, 1)) / datetime.timedelta(microseconds=1))
    check(rows == int((h_ts["l_shipts"] >= lo).sum()), "count_rows differs from numpy")
    ids = np.asarray(ids, dtype=np.uint64)
    sizes = [hn // 4 + (1 if i < hn % 4 else 0) for i in range(4)]
    want_ids = np.concatenate([(np.uint64(p) << np.uint64(36)) + np.arange(sz, dtype=np.uint64)
                               for p, sz in enumerate(sizes)])
    check(np.array_equal(ids, want_ids), "add_monotonically_increasing_id differs from numpy")
    print(f"surface: unpivot {len(unp['value'])} rows, pivot {len(piv['l_returnflag'])} rows, "
          f"count_rows {rows}, {len(ids)} ids over 4 partitions, each equal to off and numpy: "
          f"{surface_ms:.1f} ms (host clock) [{card}]", flush=True)
    del unp, piv, ids, hdf

    temporal_kernel_cases(df, kernel_results, card)
    del df
    clear_residency()
    counters.reset()
    print(f"temporal phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return paths


# ---- nested: lists, structs and maps at SF1 ----------------------------------------

# N2's aggregates ride the grouped stage: the count (K1), the validity
# planes' extremes (K2), the float sums (K7), the int64 and f64 extremes (K3)
NESTED_KERNELS = ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes",
                  "segment_extreme_int64")
NESTED_FLOATS = ("qty", "revenue")
NESTED_SAMPLE = 10_000        # the rows each N4 function is held to its oracle on
NESTED_VALUE_ROWS = 25_000    # the value functions' rows (a Python call a value)
NESTED_SWEEP_ROWS = 300_000   # the other N4 functions' rows (N1's first)
NESTED_LISTS = ("l_suppkey", "l_quantity", "l_extendedprice")
COMMENT_WORDS = ["carefully", "final", "deposits", "furiously", "ironic", "packages",
                 "quickly", "regular", "accounts", "blithely", "special", "requests",
                 "pending", "express", "silent", "theodolites"]
# the grouped stage's wrappers, whose calls a cold run's capture keeps
GROUPED_WRAPPERS = {"segment_sum_planes": "segment_kernels",
                    "segment_extreme_planes": "segment_kernels",
                    "segment_sum_float_planes": "segment_kernels",
                    "segment_extreme_int64": "segment_kernels"}
N5_BUILD_SQL = """SELECT l_orderkey, ARRAY_AGG(l_suppkey) AS l_suppkey,
  LIST_AGG(l_quantity) AS l_quantity, ARRAY_AGG(l_extendedprice) AS l_extendedprice
FROM lineitem GROUP BY l_orderkey"""
N5_AGG_SQL = """SELECT l_suppkey, COUNT(l_orderkey) AS n_lines, SUM(l_quantity) AS qty,
  SUM(l_extendedprice) AS revenue, MIN(l_extendedprice) AS min_price,
  MAX(l_extendedprice) AS max_price, MIN(l_orderkey) AS first_order,
  MAX(l_orderkey) AS last_order
FROM exploded GROUP BY l_suppkey ORDER BY l_suppkey"""


def nested_frame(lineitem):
    """N1's input: lineitem's keys, quantity, price, its ship mode as
    dictionary-coded strings, a struct of (l_linenumber, l_returnflag), and
    an ``l_comment`` of three words drawn from COMMENT_WORDS (seeded)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import DataType, Series
    from daft_tpu_torch.io._parquet_format import attach_dictionary_codes

    n = len(lineitem["l_orderkey"])
    modes = _strings("l_shipmode", SHIPMODES, lineitem["l_shipmode"])
    attach_dictionary_codes(modes, np.array(SHIPMODES, dtype=object),
                            lineitem["l_shipmode"].astype(np.int64))
    flags = _strings("l_returnflag", RETURNFLAGS, lineitem["l_returnflag"])
    attach_dictionary_codes(flags, np.array(RETURNFLAGS, dtype=object),
                            lineitem["l_returnflag"].astype(np.int64))
    line = Series.nested("l_line", DataType.struct({"l_linenumber": DataType.int32(),
                                                    "l_returnflag": DataType.string()}),
                         None, [Series.from_numpy(lineitem["l_linenumber"], "l_linenumber"),
                                flags], np.ones(n, dtype=bool))
    rng = np.random.default_rng(SEED + 7)
    vocab = np.array([" ".join(w) for w in zip(*(rng.permutation(COMMENT_WORDS * 4)
                                                   for _ in range(3)))], dtype=object)
    comment = _strings("l_comment", vocab, rng.integers(0, len(vocab), n))
    return dt.from_pydict({"l_orderkey": lineitem["l_orderkey"],
                           "l_suppkey": lineitem["l_suppkey"],
                           "l_quantity": lineitem["l_quantity"],
                           "l_extendedprice": lineitem["l_extendedprice"],
                           "l_shipmode": modes, "l_line": line, "l_comment": comment})


def n1_query(df):
    """N1: each order's lines as lists, its ship modes' set, its lines'
    (number, flag) structs, one comment."""
    from daft_tpu_torch import col

    return (df.groupby("l_orderkey")
            .agg(col("l_suppkey").agg_list(), col("l_quantity").agg_list(),
                 col("l_extendedprice").agg_list(), col("l_shipmode").agg_list(),
                 col("l_shipmode").agg_set().alias("modes"), col("l_line").agg_list(),
                 col("l_comment").any_value()))


def n2_aggs():
    from daft_tpu_torch import col

    return (col("l_orderkey").count().alias("n_lines"),
            col("l_quantity").sum().alias("qty"),
            col("l_extendedprice").sum().alias("revenue"),
            col("l_extendedprice").min().alias("min_price"),
            col("l_extendedprice").max().alias("max_price"),
            col("l_orderkey").min().alias("first_order"),
            col("l_orderkey").max().alias("last_order"))


def n2_query(n1):
    """N2: the three numeric lists exploded, then by supplier."""
    return n1.explode(*NESTED_LISTS).groupby("l_suppkey").agg(*n2_aggs()).sort("l_suppkey")


def n2_flat_query(df):
    """The same aggregation over flat lineitem (the supplier cell's shape)."""
    return df.groupby("l_suppkey").agg(*n2_aggs()).sort("l_suppkey")


def n2_oracle(lineitem) -> dict:
    import numpy as np

    keys, inv = np.unique(lineitem["l_suppkey"], return_inverse=True)
    g = len(keys)

    def ext(ufunc, v, ident):
        out = np.full(g, ident, dtype=v.dtype)
        ufunc.at(out, inv, v)
        return out.tolist()

    price, order = lineitem["l_extendedprice"], lineitem["l_orderkey"]
    return {"l_suppkey": keys.tolist(), "n_lines": np.bincount(inv, minlength=g).tolist(),
            "qty": np.bincount(inv, weights=lineitem["l_quantity"], minlength=g).tolist(),
            "revenue": np.bincount(inv, weights=price, minlength=g).tolist(),
            "min_price": ext(np.minimum, price, np.inf),
            "max_price": ext(np.maximum, price, -np.inf),
            "first_order": ext(np.minimum, order, np.iinfo(np.int64).max),
            "last_order": ext(np.maximum, order, np.iinfo(np.int64).min)}


def n1_checks(n1, lineitem) -> None:
    """N1 against numpy: one row an order, each list its order's lines in
    order, each set its ship modes' first occurrences."""
    import numpy as np

    b = _frame_all(n1)
    orders = lineitem["l_orderkey"]
    lines = np.bincount(orders)[1:]
    check(b.num_rows == len(lines), f"N1: {b.num_rows} rows, expected {len(lines)}")
    want_off = np.concatenate([[0], np.cumsum(lines)])
    for c in NESTED_LISTS + ("l_shipmode", "l_line"):
        s = b.get_column(c)
        check(np.array_equal(s.list_offsets(), want_off), f"N1: {c}'s offsets differ")
    for c in NESTED_LISTS:
        check(np.array_equal(b.get_column(c).list_child().to_numpy(), lineitem[c]),
              f"N1: {c}'s elements differ from lineitem's")
    line = b.get_column("l_line").list_child()
    check(np.array_equal(line.struct_field("l_linenumber").to_numpy(),
                         lineitem["l_linenumber"]), "N1: the structs' line numbers differ")
    elems = int(want_off[-1])
    sets = b.get_column("modes")
    idx = np.random.default_rng(SEED).choice(len(lines), min(NESTED_SAMPLE, len(lines)),
                                             replace=False)
    starts = want_off[idx].tolist()
    codes = lineitem["l_shipmode"]
    got = sets.take(idx).to_pylist()
    for a, n, g in zip(starts, lines[idx].tolist(), got):
        want = list(dict.fromkeys(SHIPMODES[c] for c in codes[a:a + n].tolist()))
        check(g == want, f"N1: a ship-mode set differs: {g} != {want}")
    print(f"N1: {b.num_rows} rows, {elems} elements a list column ({lines.min()}-"
          f"{lines.max()} a row), equal to numpy", flush=True)


def _frame_all(df):
    """Every partition of a collected DataFrame as one RecordBatch."""
    from daft_tpu_torch.core.recordbatch import RecordBatch

    return RecordBatch.concat([p.concat_or_empty() for p in df.collect()._plan.partitions])


def same_nested(a, b) -> bool:
    """Two Series equal in type, validity and layout, values bit for bit."""
    import numpy as np

    if a.dtype != b.dtype or len(a) != len(b) or \
            not np.array_equal(a.validity_numpy(), b.validity_numpy()):
        return False
    if a.is_nested:
        la, lb = a.layout, b.layout
        if (la.offsets is None) != (lb.offsets is None) or (
                la.offsets is not None and not np.array_equal(la.offsets, lb.offsets)):
            return False
        return all(same_nested(x, y) for x, y in zip(la.children, lb.children))
    va, vb = a.to_numpy(), b.to_numpy()
    if va.dtype == object:
        return va.tolist() == vb.tolist()
    return va.tobytes() == vb.tobytes()


def n4_functions():
    """(label, expression, the plain-Python oracle of one input row, input
    column, value function?) of each N4 function."""
    import json as _json

    from daft_tpu_torch import DataType, col

    def jq(row):
        return None if not row else row[0]["l_returnflag"]

    return [
        ("list_length", col("l_quantity").list.length(), len, "l_quantity", False),
        ("list_sum", col("l_quantity").list.sum(), lambda r: float(sum(r)), "l_quantity",
         False),
        ("list_max", col("l_extendedprice").list.max(), max, "l_extendedprice", False),
        ("list_get(0)", col("l_suppkey").list.get(0), lambda r: r[0], "l_suppkey", False),
        ("list_sort", col("l_shipmode").list.sort(), sorted, "l_shipmode", False),
        ("list_distinct", col("l_shipmode").list.distinct(),
         lambda r: list(dict.fromkeys(r)), "l_shipmode", False),
        ("list_contains", col("l_shipmode").list.contains("AIR"), lambda r: "AIR" in r,
         "l_shipmode", False),
        ("list_join", col("l_shipmode").list.join(","), ",".join, "l_shipmode", False),
        ("struct_get", col("l_line").list.get(0).struct.get("l_returnflag"),
         lambda r: r[0]["l_returnflag"], "l_line", False),
        ("to_json -> json_query", col("l_line")._fn("to_json")
         ._fn("json_query", path="$[0].l_returnflag"),
         lambda r: jq(_json.loads(_json.dumps(r, default=str))), "l_line", True),
        ("encode_base64", col("l_comment").cast(DataType.binary()).binary.encode_base64(),
         lambda v: __import__("base64").b64encode(v.encode()).decode(), "l_comment", True),
        ("sha256", col("l_comment").cast(DataType.binary())._fn("sha256"),
         lambda v: __import__("hashlib").sha256(v.encode()).hexdigest(), "l_comment", True),
        ("compress / decompress gzip", col("l_comment").cast(DataType.binary())
         .compress("gzip").decompress("gzip"), lambda v: v.encode(), "l_comment", True),
        ("partition_iceberg_bucket(16)", col("l_orderkey").partition_iceberg_bucket(16),
         lambda v: (murmur3_long(v) & 0x7FFFFFFF) % 16, "l_orderkey", False),
    ]


def murmur3_long(v: int) -> int:
    """Iceberg's bucket hash of a long, written out from the algorithm."""
    data = int(v).to_bytes(8, "little", signed=True)
    h, m = 0, 0xFFFFFFFF
    for i in (0, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * 0xCC9E2D51) & m
        k = ((k << 15) | (k >> 17)) & m
        k = (k * 0x1B873593) & m
        h ^= k
        h = ((h << 13) | (h >> 19)) & m
        h = (h * 5 + 0xE6546B64) & m
    h ^= 8
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def phase_n4(n1, df, card: str) -> None:
    """N4: each host function over N1's first NESTED_SWEEP_ROWS rows (the
    value functions, a Python call a value, over its first
    NESTED_VALUE_ROWS), host clock, median of 3, held to its plain-Python
    oracle on a seeded sample; then explode and agg_list alone."""
    import math

    import numpy as np

    import daft_tpu_torch as dt

    rng = np.random.default_rng(SEED)
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        rows = n1.count_rows()
        head = n1.limit(NESTED_VALUE_ROWS).collect()
        sweep = n1.limit(NESTED_SWEEP_ROWS).collect()
        for label, e, oracle, src, value_fn in n4_functions():
            frame = head if value_fn else sweep
            n = min(rows, NESTED_VALUE_ROWS if value_fn else NESTED_SWEEP_ROWS)
            out = {}

            def run(frame=frame, e=e):
                out["df"] = frame.select(e.alias("out"), src).collect()

            ms = statistics.median(time_s(run)) * 1e3
            b = _frame_all(out["df"])
            idx = rng.choice(n, min(NESTED_SAMPLE, n), replace=False)
            got = b.get_column("out").take(idx).to_pylist()
            ins = b.get_column(src).take(idx).to_pylist()
            for g, x in zip(got, ins):
                w = oracle(x)
                ok = (g == w) or (isinstance(w, float) and math.isclose(g, w, rel_tol=1e-12))
                check(ok, f"N4 {label}: {g!r} differs from the oracle's {w!r} for {x!r}")
            print(f"N4 host function {label}: {ms:.1f} ms over {n} rows (host clock, median "
                  f"of 3), {len(idx)} sampled rows equal to the plain-Python oracle [{card}]",
                  flush=True)
        ms = statistics.median(time_s(lambda: n1.explode(*NESTED_LISTS).select(
            *NESTED_LISTS).collect())) * 1e3
        print(f"N4 explode alone (3 lists): {ms:.1f} ms (host clock, median of 3) [{card}]",
              flush=True)
        from daft_tpu_torch import col

        ms = statistics.median(time_s(lambda: df.groupby("l_orderkey").agg(
            col("l_suppkey").agg_list()).collect())) * 1e3
        print(f"N4 agg_list alone (l_suppkey by l_orderkey): {ms:.1f} ms (host clock, median "
              f"of 3) [{card}]", flush=True)


def nested_kernel_cases(n1, kernel_results: dict, card: str) -> None:
    """K1, K2, K7 and K3 at the inputs N2's cold run gave them, each held against
    its plain version, into ``kernel_results`` under "at_n2_..."."""
    clear_residency()
    with dt_ctx():
        calls = capture_kernel_calls(lambda: n2_query(n1).to_pydict(), GROUPED_WRAPPERS)
    stage_kernel_cases("n2", "N2", calls, GROUPED_WRAPPERS, kernel_results, card)


def stage_kernel_cases(tag: str, label: str, calls: dict, required, kernel_results: dict,
                       card: str) -> None:
    """The grouped stage's kernels at the inputs a cold run gave them
    (``calls``: ``capture_kernel_calls`` over GROUPED_WRAPPERS), the first
    call of each kernel and op (the run's other batches have its shapes),
    each held against its plain version with its times and bound, into
    ``kernel_results`` under "at_<tag>_..."; each of ``required`` must have
    been called. These launches fall outside every counted run."""
    import torch

    from daft_tpu_torch.ops import segment_kernels as sk

    for wrapper in required:
        check(len(calls[wrapper]) > 0, f"{label}: {wrapper} was not called")
    firsts = {}
    for wrapper, seen in calls.items():
        for args, out in seen:
            key = (wrapper, args[-1] if wrapper in ("segment_extreme_planes",
                                                    "segment_extreme_int64") else None)
            firsts.setdefault(key, (args, out))
    calls = {w: [v for (k, _op), v in firsts.items() if k == w] for w in calls}
    new = {}
    for i, ((planes, codes, cap), _out) in enumerate(calls.get("segment_sum_planes", ())):
        new[("segment_sum_planes", f"at_{tag}_cap{cap}_{i}")] = plane_case(sk, "sum", planes,
                                                                          codes, cap)
    for i, ((planes, codes, cap, op), _out) in enumerate(calls.get("segment_extreme_planes",
                                                                   ())):
        new[("segment_extreme_planes", f"at_{tag}_cap{cap}_{op}{i}")] = plane_case(
            sk, op, planes, codes, cap)
    for i, ((planes, codes, cap), _out) in enumerate(calls.get("segment_sum_float_planes",
                                                               ())):
        new[("segment_sum_float_planes", f"at_{tag}_cap{cap}_{i}")] = k7_case(
            sk, planes, codes, cap, f"{tag} cap {cap}")
    for i, ((v, keep, codes, cap, op), _out) in enumerate(calls.get("segment_extreme_int64",
                                                                    ())):
        new[("segment_extreme_int64", f"at_{tag}_cap{cap}_{op}{i}")] = k3_case(
            sk, v, keep, codes, cap, op)
    for (kname, case_label), case in new.items():
        kernel_results[kname][case_label] = case
    del calls, firsts
    torch.cuda.empty_cache()
    print_cases({f"{k} {case_label}": case for (k, case_label), case in new.items()}, card)


def phase_nested(lineitem, card: str, kernel_results: dict) -> dict:
    """Lists, structs and maps at SF1 (item 7c): N1 builds the lists on the
    host, N2 explodes them into the grouped stage on the card (equal to the
    flat aggregation, "off" and numpy), N3 round-trips N1 through the port's
    Parquet and runs N2 over the file, N4 times the host functions, N5 is
    N2 in SQL. Returns {path: the cold run's launches}."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import physical as pp

    phase("nested")
    start = time.perf_counter()
    clear_residency()
    paths = {}
    df = nested_frame(lineitem)
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        t0 = time.perf_counter()
        n1 = n1_query(df).collect()
        build_s = time.perf_counter() - t0
    n1_checks(n1, lineitem)
    print(f"N1 build (groupby + 5 agg_list + agg_set + any_value, host): {build_s:.3f} s "
          f"[{card}]", flush=True)

    with dt_ctx():
        plan = pp.translate(n2_query(n1).optimized_plan())
    node = plan.input if isinstance(plan, pp.PhysSort) else plan
    check(type(node).__name__ == "DeviceGroupedAgg",
          f"N2: the aggregate planned as {type(node).__name__}, not DeviceGroupedAgg")
    check(type(node.input).__name__ == "PhysExplode",
          f"N2: the stage reads {type(node.input).__name__}, not the explode")
    oracle = n2_oracle(lineitem)
    flat = dt.from_pydict({c: lineitem[c] for c in ("l_orderkey",) + NESTED_LISTS})
    with dt_ctx():
        flat_result = n2_flat_query(flat).to_pydict()
    check(same_result(flat_result, oracle, NESTED_FLOATS), "N2: the flat aggregation differs "
                                                           "from the numpy oracle")
    n2_result, paths["nested_n2"] = run_cell("N2", lambda: n2_query(n1), NESTED_KERNELS, card,
                                             NESTED_FLOATS, oracle)
    check(same_result(n2_result, flat_result, NESTED_FLOATS),
          "N2 differs from the flat aggregation over lineitem")
    print("N2: equal to the flat aggregation over lineitem (keys, counts and extremes bit "
          "for bit, sums within rtol 1e-5)", flush=True)
    with dt_ctx():
        uploads = count_uploads(lambda: n2_query(n1).to_pydict())
    print(f"N2: {uploads} column uploads on a warm run", flush=True)
    phase_profile(lambda: n2_query(n1).to_pydict(), card, "N2 profile")

    root = tempfile.mkdtemp(prefix="daft_tpu_torch_nested_")
    try:
        d = os.path.join(root, "n1")
        with dt.execution_config_ctx(device="cpu", device_mode="off"):
            t0 = time.perf_counter()
            n1.write_parquet(d).collect()
            write_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            t0 = time.perf_counter()
            back = dt.read_parquet(d).collect()
            read_s = time.perf_counter() - t0
        a = _frame_all(n1)
        bb = _frame_all(back)
        check(a.schema == bb.schema, f"N3: the file's schema {bb.schema} is not N1's")
        for c in a.column_names():
            check(same_nested(a.get_column(c), bb.get_column(c)),
                  f"N3: column {c} read back differs from N1's")
        del a, bb, back
        print(f"N3: wrote {nbytes} bytes in {write_s:.3f} s ({nbytes / write_s / 1e6:.1f} "
              f"MB/s), read back in {read_s:.3f} s ({nbytes / read_s / 1e6:.1f} MB/s), equal "
              f"to N1 [{card}]", flush=True)
        clear_residency()
        paths["nested_n3_file"] = scan_cell("N3 file", lambda: n2_query(dt.read_parquet(d)),
                                            NESTED_KERNELS, n2_result, NESTED_FLOATS, card,
                                            "device_grouped_batches", host_ops=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    phase_n4(n1, df, card)

    # N5: the build in SQL (ARRAY_AGG, LIST_AGG), the explode, N2's aggregate in SQL
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        t0 = time.perf_counter()
        built = dt.sql(N5_BUILD_SQL, lineitem=df).collect()
        sql_build_s = time.perf_counter() - t0
    exploded = built.explode(*NESTED_LISTS)
    got, paths["nested_n5_sql"] = run_cell("N5 sql", lambda: dt.sql(N5_AGG_SQL,
                                                                     exploded=exploded),
                                           NESTED_KERNELS, card, NESTED_FLOATS, n2_result)
    print(f"N5: SQL build {sql_build_s:.3f} s; N2 in SQL equal to the DataFrame's [{card}]",
          flush=True)
    del built, exploded, df

    nested_kernel_cases(n1, kernel_results, card)
    del n1
    clear_residency()
    print(f"nested phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return paths


# ---- tpcds: the reference's 25 TPC-DS queries at SF1 -----------------------------

TPCDS_SF = 1.0
TPCDS_WARM_RUNS = 1  # each query's warm runs (their median)
TPCDS_SEED = 0
TPCDS_CATEGORIES = ["Books", "Children", "Electronics", "Home", "Jewelry", "Men", "Music",
                    "Shoes", "Sports", "Women"]
TPCDS_CLASSES = ["accent", "classical", "dresses", "fiction", "fragrances", "infants", "pants",
                 "portable", "reference", "rock"]
TPCDS_COLORS = ["slate", "blanched", "burnished", "powder", "ghost", "peach", "salmon", "mint",
                "azure", "rose"]
TPCDS_MARITAL = ["M", "S", "D", "W", "U"]
TPCDS_EDUCATION = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
                   "Advanced Degree", "Unknown"]
TPCDS_BUY_POTENTIAL = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500", "Unknown"]
TPCDS_CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
TPCDS_STORE_NAMES = ["ought", "able", "ese", "anti", "cally", "ation", "eing", "bar"]
TPCDS_STATES = ["TN", "GA", "AL", "SC", "NC", "KY", "VA", "FL", "MS", "LA"]
TPCDS_COUNTIES = ["Williamson County", "Franklin Parish", "Walker County", "Ziebach County",
                  "Daviess County"]
TPCDS_CITIES = ["Midway", "Fairview", "Oak Grove", "Five Points", "Centerville"]
# the stage a query rode, from its cold run's counters, most specific first
TPCDS_STAGES = (("device_topn_runs", "join TopN"), ("device_join_batches", "device join"),
                ("device_grouped_batches", "grouped stage"),
                ("device_stage_batches", "ungrouped stage"))
# the stage each query's cold run rides at SF1 (measured on the H100,
# PERF.md §5): the star join's aggregate under a TopN or alone, the grouped
# stage over host joins, or the host, where the join run fell back
TPCDS_RIDES = {3: "join TopN", 7: "join TopN", 42: "join TopN", 43: "join TopN",
               52: "join TopN", 55: "join TopN",
               12: "device join", 20: "device join", 27: "device join", 36: "device join",
               48: "device join", 59: "device join", 63: "device join", 88: "device join",
               96: "device join", 98: "device join",
               6: "grouped stage", 19: "grouped stage", 33: "grouped stage",
               56: "grouped stage", 65: "grouped stage",
               51: "host", 73: "host", 79: "host", 89: "host"}
# the run-time fallbacks each query's cold run takes at SF1, (count, what
# every reason says): joined groups past the join run's 2^16 ceiling (q27's
# at one level of its rollup, q51's in both of its channels); every other
# query falls back nowhere
TPCDS_CEILING = "exceeds the ceiling 65536 of DeviceJoinGroupedRun"
TPCDS_FALLBACKS = {27: (1, TPCDS_CEILING), 51: (2, TPCDS_CEILING), 73: (1, TPCDS_CEILING),
                   79: (1, TPCDS_CEILING), 89: (1, TPCDS_CEILING)}
# the kernels a cold run on each stage launches at least once: the star
# join's K4 build and probe, the grouped run's K1, K2 and K7 (an ungrouped
# join aggregate, q48, q88 and q96's count, launches K4 alone)
TPCDS_STAGE_KERNELS = {
    "join TopN": ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
                  "segment_extreme_planes", "segment_sum_float_planes"),
    "device join": ("hash_probe_build", "hash_probe_index"),
    "grouped stage": ("segment_sum_planes", "segment_extreme_planes",
                      "segment_sum_float_planes"),
    "host": ()}
# the query whose kernel inputs the kernels' TPC-DS cases take: its star
# join builds K4 over item and date_dim, probes store_sales' keys and runs
# K1, K2 and K7 at its join run's cap
TPCDS_KERNEL_QUERY = 98


def tpcds_tables(sf: float = TPCDS_SF, seed: int = TPCDS_SEED) -> dict:
    """benchmarking/tpcds/datagen.py's tables (its lines 42-235) with numpy
    alone: the same draws in the same order from the same generator, so the
    columns equal the reference's at any scale factor; strings as object
    arrays, d_date as datetime64[D]. {table: {column: array}}."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def money(n, lo=0.5, hi=200.0):
        return np.round(rng.uniform(lo, hi, n), 2)

    def strs(items):
        out = np.empty(len(items), dtype=object)
        out[:] = items
        return out

    def pick(vocab, codes):
        return strs([vocab[i] for i in codes.tolist()])

    d0 = datetime.date(1998, 1, 1)
    n_dates = (datetime.date(2002, 12, 31) - d0).days + 1
    dates = [d0 + datetime.timedelta(days=i) for i in range(n_dates)]
    date_dim = {
        "d_date_sk": np.arange(n_dates, dtype=np.int64) + 2_450_000,
        "d_date": np.array([(d - EPOCH).days for d in dates]).astype("datetime64[D]"),
        "d_year": np.array([d.year for d in dates], np.int32),
        "d_moy": np.array([d.month for d in dates], np.int32),
        "d_dom": np.array([d.day for d in dates], np.int32),
        "d_qoy": np.array([(d.month - 1) // 3 + 1 for d in dates], np.int32),
        "d_day_name": strs([d.strftime("%A") for d in dates]),
        "d_month_seq": np.array([(d.year - 1900) * 12 + d.month - 1 for d in dates], np.int32),
        "d_week_seq": np.array([((d - EPOCH).days + 3) // 7 for d in dates], np.int32),
        "d_dow": np.array([d.isoweekday() % 7 for d in dates], np.int32),
    }
    secs = np.arange(86400, dtype=np.int64)
    time_dim = {"t_time_sk": secs, "t_hour": (secs // 3600).astype(np.int32),
                "t_minute": ((secs // 60) % 60).astype(np.int32),
                "t_second": (secs % 60).astype(np.int32)}
    n_item = max(int(18_000 * min(sf, 1.0) + 2_000 * max(sf - 1.0, 0)), 2_000)
    isk = np.arange(n_item, dtype=np.int64) + 1
    brand_id = rng.integers(1, 1001, n_item).astype(np.int32)
    cat_id = rng.integers(0, len(TPCDS_CATEGORIES), n_item)
    class_id = rng.integers(0, len(TPCDS_CLASSES), n_item)
    item = {
        "i_item_sk": isk,
        "i_item_id": strs([f"AAAAAAAA{k:08d}" for k in isk.tolist()]),
        "i_brand_id": brand_id,
        "i_brand": strs([f"brand#{b}" for b in brand_id.tolist()]),
        "i_class_id": (class_id + 1).astype(np.int32),
        "i_class": pick(TPCDS_CLASSES, class_id),
        "i_category_id": (cat_id + 1).astype(np.int32),
        "i_category": pick(TPCDS_CATEGORIES, cat_id),
        "i_color": pick(TPCDS_COLORS, rng.integers(0, 10, n_item)),
        "i_manufact_id": rng.integers(1, 1001, n_item).astype(np.int32),
        "i_manager_id": rng.integers(1, 101, n_item).astype(np.int32),
        "i_current_price": money(n_item, 0.09, 99.99),
    }
    n_cd = max(int(19_200 * max(sf, 0.01)), 500)
    cd = {
        "cd_demo_sk": np.arange(n_cd, dtype=np.int64) + 1,
        "cd_gender": pick(["M", "F"], rng.integers(0, 2, n_cd)),
        "cd_marital_status": pick(TPCDS_MARITAL, rng.integers(0, len(TPCDS_MARITAL), n_cd)),
        "cd_education_status": pick(TPCDS_EDUCATION,
                                    rng.integers(0, len(TPCDS_EDUCATION), n_cd)),
        "cd_purchase_estimate": rng.integers(500, 10_000, n_cd).astype(np.int32),
        "cd_credit_rating": pick(TPCDS_CREDIT, rng.integers(0, len(TPCDS_CREDIT), n_cd)),
        "cd_dep_count": rng.integers(0, 7, n_cd).astype(np.int32),
    }
    n_hd = 7_200
    hd = {
        "hd_demo_sk": np.arange(n_hd, dtype=np.int64) + 1,
        "hd_income_band_sk": rng.integers(1, 21, n_hd).astype(np.int64),
        "hd_buy_potential": pick(TPCDS_BUY_POTENTIAL,
                                 rng.integers(0, len(TPCDS_BUY_POTENTIAL), n_hd)),
        "hd_dep_count": rng.integers(0, 10, n_hd).astype(np.int32),
        "hd_vehicle_count": rng.integers(-1, 5, n_hd).astype(np.int32),
    }
    n_ca = max(int(50_000 * sf), 200)
    zips = rng.integers(10_000, 99_999, n_ca)
    ca = {
        "ca_address_sk": np.arange(n_ca, dtype=np.int64) + 1,
        "ca_city": strs([f"city_{i}" for i in rng.integers(0, 600, n_ca).tolist()]),
        "ca_state": pick(TPCDS_STATES, rng.integers(0, len(TPCDS_STATES), n_ca)),
        "ca_zip": strs([f"{z:05d}" for z in zips.tolist()]),
        "ca_country": strs(["United States"] * n_ca),
        "ca_gmt_offset": np.full(n_ca, -5.0),
    }
    n_cust = max(int(100_000 * sf), 300)
    csk = np.arange(n_cust, dtype=np.int64) + 1
    customer = {
        "c_customer_sk": csk,
        "c_customer_id": strs([f"AAAAAAAA{k:08d}" for k in csk.tolist()]),
        "c_current_cdemo_sk": rng.integers(1, n_cd + 1, n_cust).astype(np.int64),
        "c_current_hdemo_sk": rng.integers(1, n_hd + 1, n_cust).astype(np.int64),
        "c_current_addr_sk": rng.integers(1, n_ca + 1, n_cust).astype(np.int64),
        "c_first_name": strs([f"first{i}" for i in rng.integers(0, 5_000, n_cust).tolist()]),
        "c_last_name": strs([f"last{i}" for i in rng.integers(0, 6_000, n_cust).tolist()]),
        "c_birth_year": rng.integers(1924, 1993, n_cust).astype(np.int32),
    }
    n_store = max(int(12 * max(sf, 0.25)), 3)
    szips = rng.integers(10_000, 99_999, n_store)
    store = {
        "s_store_sk": np.arange(n_store, dtype=np.int64) + 1,
        "s_store_id": strs([f"AAAAAAAA{k:08d}" for k in range(1, n_store + 1)]),
        "s_store_name": strs([TPCDS_STORE_NAMES[i % len(TPCDS_STORE_NAMES)]
                              for i in range(n_store)]),
        "s_state": pick(TPCDS_STATES, rng.integers(0, len(TPCDS_STATES), n_store)),
        "s_county": strs([TPCDS_COUNTIES[i % len(TPCDS_COUNTIES)] for i in range(n_store)]),
        "s_city": strs([TPCDS_CITIES[i % 5] for i in range(n_store)]),
        "s_company_name": strs(["Unknown"] * n_store),
        "s_number_employees": rng.integers(200, 301, n_store).astype(np.int32),
        "s_zip": strs([f"{z:05d}" for z in szips.tolist()]),
        "s_gmt_offset": np.full(n_store, -5.0),
    }
    n_promo = max(int(300 * max(sf, 0.1)), 30)
    promotion = {
        "p_promo_sk": np.arange(n_promo, dtype=np.int64) + 1,
        "p_promo_id": strs([f"AAAAAAAA{k:08d}" for k in range(1, n_promo + 1)]),
        "p_channel_email": pick(["N", "Y"], rng.integers(0, 2, n_promo)),
        "p_channel_event": pick(["N", "Y"], rng.integers(0, 2, n_promo)),
        "p_channel_tv": pick(["N", "Y"], rng.integers(0, 2, n_promo)),
    }
    n_ss = int(2_880_000 * sf)
    qty = rng.integers(1, 101, n_ss).astype(np.int32)
    list_price = money(n_ss, 1.0, 200.0)
    sales_price = np.round(list_price * rng.uniform(0.2, 1.0, n_ss), 2)
    wholesale = np.round(list_price * rng.uniform(0.3, 0.7, n_ss), 2)
    store_sales = {
        "ss_sold_date_sk": (rng.integers(0, n_dates, n_ss) + 2_450_000).astype(np.int64),
        "ss_sold_time_sk": rng.integers(0, 86_400, n_ss).astype(np.int64),
        "ss_item_sk": rng.integers(1, n_item + 1, n_ss).astype(np.int64),
        "ss_customer_sk": rng.integers(1, n_cust + 1, n_ss).astype(np.int64),
        "ss_cdemo_sk": rng.integers(1, n_cd + 1, n_ss).astype(np.int64),
        "ss_hdemo_sk": rng.integers(1, n_hd + 1, n_ss).astype(np.int64),
        "ss_addr_sk": rng.integers(1, n_ca + 1, n_ss).astype(np.int64),
        "ss_store_sk": rng.integers(1, n_store + 1, n_ss).astype(np.int64),
        "ss_promo_sk": rng.integers(1, n_promo + 1, n_ss).astype(np.int64),
        "ss_ticket_number": rng.integers(1, max(n_ss // 10, 2), n_ss).astype(np.int64),
        "ss_quantity": qty,
        "ss_wholesale_cost": wholesale,
        "ss_list_price": list_price,
        "ss_sales_price": sales_price,
        "ss_coupon_amt": np.round(rng.uniform(0, 500, n_ss) * (rng.random(n_ss) < 0.2), 2),
        "ss_ext_sales_price": np.round(sales_price * qty, 2),
        "ss_ext_list_price": np.round(list_price * qty, 2),
        "ss_ext_wholesale_cost": np.round(wholesale * qty, 2),
        "ss_net_profit": np.round((sales_price - wholesale) * qty, 2),
    }

    def channel(prefix: str, n_rows: int) -> dict:
        q = rng.integers(1, 101, n_rows).astype(np.int32)
        lp = money(n_rows, 1.0, 200.0)
        sp = np.round(lp * rng.uniform(0.2, 1.0, n_rows), 2)
        return {
            f"{prefix}_sold_date_sk": (rng.integers(0, n_dates, n_rows)
                                       + 2_450_000).astype(np.int64),
            f"{prefix}_item_sk": rng.integers(1, n_item + 1, n_rows).astype(np.int64),
            f"{prefix}_bill_customer_sk": rng.integers(1, n_cust + 1, n_rows).astype(np.int64),
            f"{prefix}_bill_addr_sk": rng.integers(1, n_ca + 1, n_rows).astype(np.int64),
            f"{prefix}_quantity": q,
            f"{prefix}_list_price": lp,
            f"{prefix}_sales_price": sp,
            f"{prefix}_ext_sales_price": np.round(sp * q, 2),
        }

    catalog_sales = channel("cs", int(1_440_000 * sf))
    web_sales = channel("ws", int(720_000 * sf))
    return {"date_dim": date_dim, "time_dim": time_dim, "item": item,
            "customer_demographics": cd, "household_demographics": hd,
            "customer_address": ca, "customer": customer, "store": store,
            "promotion": promotion, "store_sales": store_sales,
            "catalog_sales": catalog_sales, "web_sales": web_sales}


def tpcds_frames(tables: dict) -> dict:
    """The port's DataFrames of ``tpcds_tables``."""
    import daft_tpu_torch as dt

    return {name: dt.from_pydict(cols) for name, cols in tables.items()}


def tpcds_port_queries(root: str = HERE) -> dict:
    """benchmarking/tpcds/queries.py's ALL_QUERIES with its imports of
    daft_tpu read as imports of daft_tpu_torch (nothing of daft_tpu is
    imported)."""
    import types

    path = os.path.join(root, "benchmarking", "tpcds", "queries.py")
    src = open(path).read()
    check("from daft_tpu import col" in src, f"{path}: the import to rewrite moved")
    src = src.replace("from daft_tpu import", "from daft_tpu_torch import") \
        .replace("from daft_tpu.", "from daft_tpu_torch.")
    mod = types.ModuleType("port_tpcds_queries")
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod.ALL_QUERIES


def tpcds_stage(snap: dict) -> str:
    """The stage a run rode, from its counters: the join TopN, the device
    join, the grouped or the ungrouped stage, or the host."""
    for counter, name in TPCDS_STAGES:
        if snap.get(counter, 0) > 0:
            return name
    return "host"


def float_columns(result: dict) -> tuple:
    return tuple(c for c, v in result.items() if any(isinstance(x, float) for x in v))


def tpcds_check_run(qn: int, stage: str, snap: dict, reasons: list, launches: dict) -> None:
    """The query's cold run rode the stage TPCDS_RIDES says, fell back
    exactly where TPCDS_FALLBACKS says, and launched its stage's kernels."""
    want = TPCDS_RIDES[qn]
    check(stage == want, f"tpcds q{qn}: rode {stage}, expected {want}")
    count, reason = TPCDS_FALLBACKS.get(qn, (0, None))
    check(snap["device_fallbacks"] == count and len(reasons) == count
          and all(reason in r for r in reasons),
          f"tpcds q{qn}: fell back {snap['device_fallbacks']} times {reasons}, expected "
          f"{f'{count} for {reason!r}' if count else 'none'}")
    missing = [k for k in TPCDS_STAGE_KERNELS[want] if not launches[k]]
    check(not missing, f"tpcds q{qn}: {want} launched no {', '.join(missing)}")


def phase_tpcds(tables: dict, card: str) -> dict:
    """The 25 TPC-DS queries of benchmarking/tpcds/queries.py over
    ``tpcds_tables``: each under device_mode="off" (the host path), then
    under "on" cold (residency cleared, the counters zeroed just before and
    read just after) and warm (median of TPCDS_WARM_RUNS). "on" must equal "off"
    (integers and strings exactly, floats within rtol 1e-5), and each cold
    run must ride its stage, fall back and launch as ``tpcds_check_run``
    holds it. Prints each query's stage, times, launches and run-time
    fallbacks, and the phase's time. Returns {"tpcds": the cold runs'
    launches, summed}."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    phase("tpcds")
    start = time.perf_counter()
    t0 = time.perf_counter()
    frames = tpcds_frames(tables)
    print(f"tpcds frames {time.perf_counter() - t0:.2f} s; store_sales "
          f"{len(tables['store_sales']['ss_item_sk'])} rows, catalog_sales "
          f"{len(tables['catalog_sales']['cs_item_sk'])}, web_sales "
          f"{len(tables['web_sales']['ws_item_sk'])} [{card}]", flush=True)
    queries = tpcds_port_queries()
    check(len(queries) == 25, f"tpcds: {len(queries)} queries, not 25")
    check(set(queries) == set(TPCDS_RIDES), f"tpcds: queries {sorted(queries)} are not "
                                            f"TPCDS_RIDES' {sorted(TPCDS_RIDES)}")
    total = {k: 0 for k in counters.KERNEL_NAMES}
    rode = []
    for qn in sorted(queries):
        q = queries[qn]
        with dt_ctx(), dt.execution_config_ctx(device_mode="off"):
            t0 = time.perf_counter()
            want = q(frames).to_pydict()
            off_s = time.perf_counter() - t0
        clear_residency()
        with dt_ctx():
            counters.reset()
            t0 = time.perf_counter()
            got = q(frames).to_pydict()
            _synchronize()
            cold_s = time.perf_counter() - t0
            snap = counters.snapshot()
            reasons = sorted(r for r, n in dict(counters.rejections).items()
                             if "device fallback: " in r for _ in range(n))
            stage = tpcds_stage(snap)
            warm = time_s(lambda: q(frames).to_pydict(), TPCDS_WARM_RUNS)
        check(same_result(got, want, float_columns(want)),
              f"tpcds q{qn}: the \"on\" run differs from the \"off\" run")
        launches = {k: snap[f"{CELL_KERNEL_PREFIX}{k}"] for k in counters.KERNEL_NAMES}
        for k, v in launches.items():
            total[k] += v
        if stage != "host":
            rode.append(qn)
        rows = len(next(iter(want.values()))) if want else 0
        fb_txt = f"; fell back to the host: {json.dumps(reasons)}" if reasons else ""
        print(f"tpcds q{qn}: {stage}; {rows} rows, equal to off; cold {cold_s * 1e3:.2f} ms, "
              f"warm median {statistics.median(warm) * 1e3:.2f} ms (runs "
              f"{', '.join(f'{w * 1e3:.2f}' for w in warm)}), off {off_s * 1e3:.2f} ms; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}{fb_txt} "
              f"[{card}]", flush=True)
        tpcds_check_run(qn, stage, snap, reasons, launches)
    print(f"tpcds: {len(rode)} of {len(queries)} queries rode the card: {rode}")
    print(f"tpcds phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return {"tpcds": total}


TPCDS_WRAPPERS = {"segment_sum_planes": "segment_kernels",
                  "segment_extreme_planes": "segment_kernels",
                  "segment_sum_float_planes": "segment_kernels",
                  "build_probe_table": "probe_kernels", "hash_probe_index": "probe_kernels"}


def capture_kernel_calls(run, wrappers=None, limit: int = 0) -> dict:
    """Run ``run`` with each of ``wrappers``' (default TPCDS_WRAPPERS)
    wrappers replaced by one that keeps a copy of its arguments and of its
    result, then returns the result: {wrapper: [(args, result), ...]} in
    call order. The engine calls the wrappers through their modules, so
    this sees every call, on any thread. ``limit`` > 0 keeps the first
    ``limit`` calls of each wrapper (about: concurrent callers may pass it
    by one or two) and lets the rest run uncopied."""
    import importlib

    import torch

    def copy(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return [copy(x) for x in a]
        return a

    mods = {name: importlib.import_module(f"daft_tpu_torch.ops.{m}")
            for name, m in (wrappers or TPCDS_WRAPPERS).items()}
    originals = {name: getattr(m, name) for name, m in mods.items()}
    calls = {name: [] for name in mods}

    def recorder(name):
        fn = originals[name]

        def wrapper(*args):
            if limit and len(calls[name]) >= limit:
                return fn(*args)
            kept = copy(args)
            out = fn(*args)
            calls[name].append((kept, copy(out)))
            return out
        return wrapper

    try:
        for name, m in mods.items():
            setattr(m, name, recorder(name))
        run()
    finally:
        for name, m in mods.items():
            setattr(m, name, originals[name])
    return calls


def tpcds_kernel_calls(tables: dict) -> dict:
    """TPCDS_KERNEL_QUERY's cold run (residency cleared) under
    ``capture_kernel_calls``, with each K4 build named by the dim whose
    keys it holds: {wrapper: [(args, result, name), ...]}."""
    import numpy as np

    frames = tpcds_frames(tables)
    query = tpcds_port_queries()[TPCDS_KERNEL_QUERY]
    clear_residency()
    with dt_ctx():
        calls = capture_kernel_calls(lambda: query(frames).to_pydict())
    dims = {"item": tables["item"]["i_item_sk"], "date_dim": tables["date_dim"]["d_date_sk"]}
    named = {}
    for wrapper, seen in calls.items():
        check(len(seen) > 0, f"tpcds q{TPCDS_KERNEL_QUERY}: {wrapper} was not called")
        named[wrapper] = []
        for args, out in seen:
            name = ""
            if wrapper == "build_probe_table":
                keys = args[0][args[1]].cpu().numpy()
                name = next((d for d, k in dims.items() if np.isin(keys, k).all()), "dim")
            named[wrapper].append((args, out, name))
    builds = named["build_probe_table"]
    for i, (args, _out, _name) in enumerate(named["hash_probe_index"]):
        name = next((b[2] for b in builds if b[1].shape == args[2].shape
                     and bool((b[1] == args[2]).all())), "dim")
        named["hash_probe_index"][i] = (args, _out, name)
    return named


def tpcds_kernel_cases(tables: dict, kernel_results: dict, card: str) -> None:
    """Each kernel of TPCDS_KERNEL_QUERY's star join at the inputs its cold
    run gave it (``tpcds_kernel_calls``), held against its plain version on
    the same tensors with its times and bound, as the other paths' shapes
    are; the cases go into ``kernel_results`` under "at_tpcds_q98_...". The
    capture's launches fall outside every counted run."""
    import torch

    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk

    phase("tpcds kernels")
    named = tpcds_kernel_calls(tables)
    at = f"at_tpcds_q{TPCDS_KERNEL_QUERY}"
    new = {}
    for (planes, codes, cap), _out, _n in named["segment_sum_planes"]:
        new[("segment_sum_planes", f"{at}_cap{cap}")] = plane_case(sk, "sum", planes, codes, cap)
    for (planes, codes, cap, op), _out, _n in named["segment_extreme_planes"]:
        new[("segment_extreme_planes", f"{at}_cap{cap}")] = plane_case(sk, op, planes, codes,
                                                                       cap)
    for (planes, codes, cap), _out, _n in named["segment_sum_float_planes"]:
        new[("segment_sum_float_planes", f"{at}_cap{cap}")] = k7_case(
            sk, planes, codes, cap, f"tpcds q{TPCDS_KERNEL_QUERY} cap {cap}")
    for (keys, valid, slots), _out, name in named["build_probe_table"]:
        _table, new[("hash_probe_build", f"{at}_{name}")] = k4_build_case(
            pk, keys, f"tpcds {name}", valid, slots)
    for (keys, valid, table), _out, name in named["hash_probe_index"]:
        _got, new[("hash_probe_index", f"{at}_{name}")] = k4_probe_case(
            pk, keys, valid, table, pk.table_entries(table)[0], f"tpcds store_sales x {name}")
    for (kname, label), case in new.items():
        kernel_results[kname][label] = case
    del named, _table, _got
    torch.cuda.empty_cache()
    print_cases({f"{k} {label}": case for (k, label), case in new.items()}, card)


# ---- obs: the observability tier on the card ------------------------------------
OBS_ROUNDS = 7  # interleaved rounds of the overhead comparison
OBS_SETTINGS = ("bare", "default", "subscriber", "explain_analyze")
# the counters an observed run must move exactly as an unobserved one does
OBS_COUNTED = ("dispatch_coalesced", "coalesce_morsels_in", "bucket_fill_rows",
               "bucket_capacity_rows", "scan_tasks", "scan_batches", "scan_rows")
# the counters that show a kernel ran: launches on the card (a CPU run of the
# phase's checks counts the wrappers' plain calls)
OBS_KERNEL_PREFIX = "launches_"


def obs_counts(snap: dict) -> dict:
    """The engine counters an observation must not change: every device
    stage's batches, runs and fallbacks, every kernel's launches and plain
    calls, the coalescer's and the scan's counts."""
    return {k: v for k, v in snap.items()
            if k.startswith(("device_", "launches_", "plain_")) or k in OBS_COUNTED}


def obs_report_rows(report: str, name: str) -> int:
    """The "rows out" column of operator ``name``'s row in an EXPLAIN
    ANALYZE report (observability/runtime_stats.py ``format_stats``: the
    name, rows out, batches, then four times)."""
    for line in report.split("== Runtime Stats ==\n", 1)[1].splitlines()[1:]:
        if line.startswith(name + " ") and len(line.split()) >= 6:
            return int(line.split()[-6])
    raise SmokeFailure(f"no row for operator {name!r} in the report")


def obs_cell(label: str, query, floats, card: str, counter: str, stalls: bool = False,
             **cfg) -> dict:
    """EXPLAIN ANALYZE of one cell, warm, on the card (``cfg`` adds to the
    cells' config): the unobserved run, the same query under a stats
    collector (as explain_analyze runs it, the result kept) and
    explain_analyze itself, each with the counters zeroed before and read
    after. Checks: the observed result equals the unobserved one (keys,
    counts and integers exactly, ``floats`` within rtol 1e-5); both
    observed runs' engine counters equal the unobserved run's, count for
    count (``obs_counts``), ``counter`` above 0, a kernel launched where
    the cell's stage has kernels (not q6's ungrouped stage), no fallback;
    the root operator's rows out,
    in the stats and in the printed table, equal the result's rows (the
    coalescer flushes by size alone, so the counts do not hang on the
    host's timing); with
    ``stalls``, the table has its starve and blocked columns and the stages
    stalled (the file-fed cell under pipeline_mode "on"). Prints the
    report. Returns the observed run's launches."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.observability.runtime_stats import (StatsCollector,
                                                            current_collector, set_collector)
    from daft_tpu_torch.ops import counters

    # the coalescer flushes by size alone (SCAN_FLUSH_MS), as in the scan,
    # pipeline and ooc cells: a flush by the clock would let a slow host's
    # timing change the dispatch counts between the runs compared
    with dt_ctx(), dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS, **cfg):
        query().to_pydict()  # warm: planes resident, kernels loaded
        counters.reset()
        want = query().to_pydict()
        _synchronize()
        plain = counters.snapshot()
        collector = StatsCollector()
        prev = current_collector()
        counters.reset()
        set_collector(collector)
        try:
            got = query().to_pydict()
            _synchronize()
        finally:
            set_collector(prev)
        seen = counters.snapshot()
        stats = collector.finish()
        counters.reset()
        report = query().explain_analyze()
        _synchronize()
        explained = counters.snapshot()
    check(same_result(got, want, floats),
          f"obs {label}: the observed run's result differs from the unobserved run's")
    base = obs_counts(plain)
    for what, snap in (("observed", seen), ("explain_analyze", explained)):
        moved = obs_counts(snap)
        check(moved == base, f"obs {label}: the {what} run's engine counters differ from the "
                             f"unobserved run's: " + json.dumps(
                                 {k: (base[k], moved[k]) for k in base if base[k] != moved[k]}))
    check(plain["device_fallbacks"] == 0, f"obs {label}: a device stage fell back")
    check(plain[counter] >= 1, f"obs {label}: no {counter}")
    check(counter == "device_stage_batches"
          or any(v for k, v in base.items() if k.startswith(OBS_KERNEL_PREFIX)),
          f"obs {label}: no kernel launched")
    rows = len(next(iter(got.values())))
    root = min(stats, key=lambda s: s.node_id)
    check(root.rows_out == rows, f"obs {label}: the root operator {root.name!r} put out "
                                 f"{root.rows_out} rows, the result has {rows}")
    check(obs_report_rows(report, root.name) == rows,
          f"obs {label}: the report's root row does not say {rows} rows out")
    if stalls:
        header = report.split("== Runtime Stats ==\n", 1)[1].splitlines()[0]
        check("starve" in header and "blocked" in header,
              f"obs {label}: no starve / blocked columns in the report")
        stalled = sum(s.starve_seconds + s.blocked_seconds for s in stats)
        check(stalled > 0, f"obs {label}: no operator stalled on a stage channel")
        print(f"obs {label}: stalls {stalled * 1e3:.3f} ms over {len(stats)} operators")
    print(f"obs {label}: EXPLAIN ANALYZE [{card}]\n{report}", flush=True)
    return {k: seen[f"launches_{k}"] for k in counters.KERNEL_NAMES}


def obs_profile(label: str, query, card: str) -> None:
    """``explain_analyze(profile=...)`` of one warm cell: the trace file is
    written and loads as JSON, it holds device.h2d, device.dispatch and
    device.d2h spans, and every span of the engine's lane lies inside the
    run's wall clock (the trace's times count from the run's start).
    Prints each span name's count and summed ms (host clock: a dispatch
    span covers the enqueue, and the device time still to run when the
    host asks for the result lands in the d2h span that waits for it)."""
    root = tempfile.mkdtemp(prefix="daft_tpu_torch_obs_")
    try:
        path = os.path.join(root, "trace.json")
        with dt_ctx():
            query().to_pydict()
            t0 = time.time()
            query().explain_analyze(profile=path)
            _synchronize()
            wall_us = (time.time() - t0) * 1e6
        with open(path) as f:
            data = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    spans = [e for e in data["traceEvents"] if e.get("ph") == "X" and e.get("tid") == 4]
    names = sorted({e["name"] for e in spans})
    for want in ("device.h2d", "device.dispatch", "device.d2h"):
        check(want in names, f"obs {label} trace: no {want} span (spans: {names})")
    outside = [e for e in spans if e["ts"] < 0 or e["ts"] + e["dur"] > wall_us + 1.0]
    check(not outside, f"obs {label} trace: {len(outside)} spans outside the run's "
                       f"{wall_us:.1f} us, e.g. {outside[:2]}")
    summary = {n: [sum(1 for e in spans if e["name"] == n),
                   round(sum(e["dur"] for e in spans if e["name"] == n) / 1e3, 4)]
               for n in names}
    print(f"obs {label} trace: {len(data['traceEvents'])} events, run {wall_us / 1e3:.3f} ms; "
          f"spans [count, ms]: {json.dumps(summary)} [{card}]", flush=True)


def obs_subscriber(label: str, query, card: str) -> None:
    """A recording subscriber on one cell on the card: start, optimized,
    one operator-stats event per operator, end, in that order, for one
    query id; QueryEnd.metrics holds the device counters."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.observability import (Subscriber, attach_subscriber,
                                              detach_subscriber)

    events = []

    class Recorder(Subscriber):
        def on_query_start(self, e):
            events.append(("start", e.query_id, e))

        def on_query_optimized(self, e):
            events.append(("optimized", e.query_id, e))

        def on_operator_stats(self, qid, s):
            events.append(("op", qid, s))

        def on_query_end(self, e):
            events.append(("end", e.query_id, e))

    sub = Recorder()
    attach_subscriber(sub)
    try:
        with dt_ctx():
            got = query().to_pydict()
            _synchronize()
    finally:
        detach_subscriber(sub)
    kinds = [k for k, _q, _e in events]
    check(len(kinds) >= 4 and kinds[:2] == ["start", "optimized"] and kinds[-1] == "end"
          and set(kinds[2:-1]) == {"op"}, f"obs {label} subscriber: events {kinds}")
    check(len({q for _k, q, _e in events}) == 1, f"obs {label} subscriber: several query ids")
    end = events[-1][2]
    check(end.error is None and end.rows == len(next(iter(got.values()))),
          f"obs {label} subscriber: QueryEnd {end.rows} rows, error {end.error}")
    for name in ("device_grouped_batches", "device_stage_runs",
                 OBS_KERNEL_PREFIX + "segment_sum_planes",
                 OBS_KERNEL_PREFIX + "segment_sum_float_planes"):
        check(end.metrics.get(name, 0) >= 1, f"obs {label} subscriber: QueryEnd.metrics has "
                                             f"no {name}: {sorted(end.metrics)}")
    print(f"obs {label} subscriber: {kinds}; QueryEnd.metrics "
          f"{json.dumps({k: end.metrics[k] for k in sorted(end.metrics)})} [{card}]",
          flush=True)


def obs_overhead(cells: dict, card: str) -> dict:
    """Warm runs of each cell in turns, OBS_ROUNDS rounds, under each
    setting: "bare" (no observer, the flight recorder off:
    DAFT_TPU_FLIGHT_RECORDER=0), "default" (the recorder on), "subscriber"
    (one subscriber that does nothing attached), "explain_analyze". Each
    run ends in a synchronize. Prints one line: each setting's median and
    min-max per cell, ms. Returns {setting: {cell: median ms}}."""
    from daft_tpu_torch.observability import (Subscriber, attach_subscriber,
                                              detach_subscriber, flight)

    knob = "DAFT_TPU_FLIGHT_RECORDER"
    saved = os.environ.get(knob)
    times = {s: {c: [] for c in cells} for s in OBS_SETTINGS}
    quiet = Subscriber()
    try:
        with dt_ctx():
            for query in cells.values():
                query().to_pydict()
            for _ in range(OBS_ROUNDS):
                for setting in OBS_SETTINGS:
                    if setting == "bare":
                        os.environ[knob] = "0"
                    else:
                        os.environ.pop(knob, None)
                    flight._reset_for_tests()
                    check((flight.recorder() is None) == (setting == "bare"),
                          f"obs overhead: the flight recorder is not as {setting} sets it")
                    if setting == "subscriber":
                        attach_subscriber(quiet)
                    try:
                        for cell, query in cells.items():
                            t0 = time.perf_counter()
                            if setting == "explain_analyze":
                                query().explain_analyze()
                            else:
                                query().to_pydict()
                            _synchronize()
                            times[setting][cell].append((time.perf_counter() - t0) * 1e3)
                    finally:
                        detach_subscriber(quiet)
    finally:
        if saved is None:
            os.environ.pop(knob, None)
        else:
            os.environ[knob] = saved
        flight._reset_for_tests()
    out = {s: {c: statistics.median(v) for c, v in per.items()} for s, per in times.items()}
    line = "; ".join(
        f"{s}: " + ", ".join(f"{c} {statistics.median(v):.3f} [{min(v):.3f}-{max(v):.3f}]"
                             for c, v in per.items())
        for s, per in times.items())
    print(f"obs overhead (warm ms, median [min-max] of {OBS_ROUNDS}, in turns): {line} "
          f"[{card}]", flush=True)
    return out


def phase_obs(tables: dict, lineitem_dir: str, card: str) -> dict:
    """The observability tier on the card over cells already loaded:
    ``tables`` holds q1's and q6's lineitem frames ("q1", "q6"), q12's
    ("q12": lineitem and orders) and the join tails' ("tails", for q3);
    ``lineitem_dir`` the scan phase's Parquet lineitem (the file-fed q6).
    EXPLAIN ANALYZE on q1, q12, q3 and the file-fed q6 under
    pipeline_mode "on" (``obs_cell``), q12's profile (``obs_profile``), a
    subscriber on q1 (``obs_subscriber``), and the overhead of observing
    q1, q6 and q12 (``obs_overhead``). Returns {"obs": the observed runs'
    launches, summed}."""
    import daft_tpu_torch as dt

    phase("obs")
    start = time.perf_counter()
    clear_residency()

    def q1():
        return q1_query(tables["q1"])

    def q6():
        return q6_query(tables["q6"])

    def q12():
        return q12_query(tables["q12"]["lineitem"], tables["q12"]["orders"])

    def q3():
        return q3_query(tables["tails"])

    def scan_q6():
        return q6_query(dt.read_parquet(lineitem_dir))

    launches: dict = {}
    for label, query, floats, counter, cfg in (
            ("q1", q1, Q1_FLOATS, "device_grouped_batches", {}),
            ("q12", q12, (), "device_join_batches", {}),
            ("q3", q3, ("revenue",), "device_topn_runs", {}),
            ("scan q6", scan_q6, ("revenue",), "device_stage_batches",
             {"pipeline_mode": "on"})):
        got = obs_cell(label, query, floats, card, counter, stalls=label == "scan q6", **cfg)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    obs_profile("q12", q12, card)
    obs_subscriber("q1", q1, card)
    obs_overhead({"q1": q1, "q6": q6, "q12": q12}, card)
    print(f"obs phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return {"obs": launches}


# ---- device_mode="auto": the cost model's verdicts ----------------------------------

# the in-memory cells the auto phase runs again, with their float columns
AUTO_MEMORY_CELLS = {"supplier": (), "q1": Q1_FLOATS, "q12": (), "partkey": ("revenue",)}
AUTO_DEVICE = "cuda"
AUTO_MEASURE_ROWS = 1 << 23  # the rates' shapes (tools/calibrate.py measure_rates)
AUTO_UDF_ROWS = 1024         # texts of one encoder forward timed on the card
AUTO_HOST_UDF_ROWS = 16      # and on the host


def _ms(v) -> str:
    return "-" if v is None else f"{v * 1e3:.4f}"


def print_verdicts(label: str, run: str, scope, card: str) -> None:
    """Each placement decision of one run: the stage, the verdict, both
    sides' totals and terms (ms), the margin, cached / gate flags."""
    for r in scope.records():
        flags = [f for f, on in (("cached", r.cached), ("forced", r.forced)) if on]
        if r.reason:
            flags.append(r.reason)
        terms = {side: {k: round(v * 1e3, 4) for k, v in d.items()
                        if k != "total" and not k.startswith("note_")}
                 for side, d in (("device", r.device), ("host", r.host)) if d}
        m = r.margin()
        print(f"auto {label} ({run}): {r.site} ({r.rows} rows) -> {r.chosen}; device "
              f"{_ms(r.device['total'] if r.device else None)} ms, host "
              f"{_ms(r.host['total'] if r.host else None)} ms, margin "
              f"{'-' if m is None else f'{m:.3f}x'}"
              f"{'; ' + ', '.join(flags) if flags else ''}; {r.detail or ''}; terms "
              f"{json.dumps(terms, sort_keys=True)} [{card}]", flush=True)


def auto_cell(label: str, run, floats, card: str, cold: bool = True, flush_ms=None,
              want=None, off_ms=None, on_ms=None, on_what: str = ""):
    """One cell under device_mode="auto" on the card: (cold) a first run,
    whose decisions are priced fresh, then the warm run, each in a
    placement scope; every verdict printed with both totals and its margin;
    the warm run's counters zeroed just before it and read just after. Each
    run's result is held to ``want``, the host path's ("off") result (run
    here when no earlier phase has it), by the port's rule. Returns the warm
    run's launches."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.observability import placement
    from daft_tpu_torch.ops import counters

    if want is None:
        with dt.execution_config_ctx(device=AUTO_DEVICE, device_mode="off"):
            t0 = time.perf_counter()
            want = run()
            off_ms = (time.perf_counter() - t0) * 1e3
    extra = {} if flush_ms is None else {"batch_latency_ms": flush_ms}
    with dt.execution_config_ctx(device=AUTO_DEVICE, device_mode="auto", kernel_mode="on",
                                 **extra):
        if cold:
            with placement.query_scope() as scope:
                t0 = time.perf_counter()
                got = run()
                _synchronize()
                cold_ms = (time.perf_counter() - t0) * 1e3
            check(same_result(got, want, floats),
                  f"auto {label}: the first run differs from the host path's result")
            print_verdicts(label, "first run", scope, card)
        counters.reset()
        with placement.query_scope() as scope:
            t0 = time.perf_counter()
            got = run()
            _synchronize()
            warm_ms = (time.perf_counter() - t0) * 1e3
        snap = counters.snapshot()
    check(same_result(got, want, floats),
          f"auto {label}: the warm run differs from the host path's result")
    check(bool(scope.records()), f"auto {label}: the warm run made no placement decision")
    print_verdicts(label, "warm", scope, card)
    launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
    first = f" (first run {cold_ms:.1f} ms)" if cold else ""
    on = "not measured in this call" if on_ms is None else f"{on_ms:.1f} ms ({on_what})"
    print(f"auto {label}: warm {warm_ms:.1f} ms{first}; off {off_ms:.1f} ms; on {on}; equal "
          f"to off by the rule; device stages "
          f"{json.dumps({k: snap[k] for k in DEVICE_COUNTERS})}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} [{card}]", flush=True)
    return launches


def auto_calibration(card: str) -> None:
    """The cost model calibrated on the card (the link terms), and every
    default rate measured again beside its committed value."""
    from daft_tpu_torch.ops import costmodel
    from daft_tpu_torch.tools.calibrate import measure_rates

    costmodel.reset_calibration()
    t0 = time.perf_counter()
    costmodel.calibrate()
    cal = costmodel.calibration_dict()
    print(f"auto calibration ({(time.perf_counter() - t0) * 1e3:.1f} ms): "
          f"{json.dumps(cal, sort_keys=True)} [{card}]", flush=True)
    t0 = time.perf_counter()
    measured = measure_rates(AUTO_DEVICE, rows=AUTO_MEASURE_ROWS, reps=3,
                             udf_rows=AUTO_UDF_ROWS, host_udf_rows=AUTO_HOST_UDF_ROWS)
    for name, (env, default) in costmodel.RATES.items():
        print(f"auto rate {name} ({env}): measured {measured[name]:.4g}, default "
              f"{default:.4g}, ratio {measured[name] / default:.3f} [{card}]")
    print(f"auto rates measured in {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def phase_auto(frames: dict, lineitem_dir: str, card: str, runs: dict) -> dict:
    """device_mode="auto" on the card: the calibration and the rates, then
    the ooc phase's nine queries over Parquet lineitem (unbudgeted, the
    in-memory dims) and the in-memory cells in ``runs`` (label -> a
    callable returning the result), each once warm under "auto" after a
    first run, every verdict and margin printed, each held to its "off"
    result. The ai embed cell runs under "auto" in the ai phase
    (``auto_ai_embed``). Returns {"auto <cell>": the warm run's launches}."""
    phase("auto")
    t_phase = time.perf_counter()
    auto_calibration(card)
    paths = {}
    queries = tpch_port_queries()
    tables = ooc_tables(frames, lineitem_dir)
    for q in OOC_QUERIES:
        label = f"ooc q{q}"
        paths[f"auto {label}"] = auto_cell(
            label, lambda q=q: queries[q](tables).to_pydict(), OOC_FLOATS.get(q, ()), card,
            flush_ms=SCAN_FLUSH_MS, **KNOWN.get(label, {}))
    for label, run in runs.items():
        paths[f"auto {label}"] = auto_cell(label, run, AUTO_MEMORY_CELLS[label], card,
                                           **KNOWN.get(label, {}))
    print(f"auto phase {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return paths


def auto_ai_embed(df, out_on: dict, cpu_head: dict, card: str, on_ms=None) -> dict:
    """The ai embed cell once under "auto", its weights resident (so the run
    is warm): its verdict printed, the result within 1e-5 of the "on" run's
    and its first 256 rows within 1e-5 of the "off" run on the CPU (the ai
    phase's rule; the whole corpus on the CPU would take minutes). Returns
    {"auto ai embed": launches}."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.observability import placement
    from daft_tpu_torch.ops import counters

    with dt.execution_config_ctx(device=AUTO_DEVICE, device_mode="auto", kernel_mode="on"):
        counters.reset()
        with placement.query_scope() as scope:
            t0 = time.perf_counter()
            got = ai_embed_query(df).to_pydict()
            _synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        snap = counters.snapshot()
    print_verdicts("ai embed", "warm", scope, card)
    check(bool(scope.records()), "auto ai embed: no placement decision was made")

    def err(a_rows, b_rows) -> float:
        check([a is None for a in a_rows] == [b is None for b in b_rows],
              "auto ai embed: null rows differ")
        return max((float(np.abs(np.asarray(a) - np.asarray(b)).max())
                    for a, b in zip(a_rows, b_rows) if a is not None), default=0.0)

    on_err = err(got["e"], out_on["e"])
    off_err = err(got["e"][:256], cpu_head["e"])
    check(on_err <= 1e-5 and off_err <= 1e-5,
          f"auto ai embed: {on_err} from the card's run, {off_err} from the CPU's")
    on = "not measured in this call" if on_ms is None \
        else f"{on_ms:.1f} ms (warm median of {AI_WARM_RUNS})"
    print(f"auto ai embed: warm {ms:.1f} ms; on {on}; off not measured (the first 256 rows "
          f"on the CPU: within {off_err:.3e}); within {on_err:.3e} of the card's run; "
          f"device_udf_dispatches {snap['device_udf_dispatches']} [{card}]", flush=True)
    return {"auto ai embed": {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}}


def auto_ai_alone(card: str) -> dict:
    """``--phase auto``'s ai embed cell: the model installed, one "on" run
    (the weights resident), the first 256 rows on the CPU, then
    ``auto_ai_embed``."""
    import daft_tpu_torch as dt

    install_ai_model()
    texts = ai_corpus(SEED, AI_ROWS)
    df = ai_frame(texts)
    with dt_ctx():
        t0 = time.perf_counter()
        out = ai_embed_query(df).to_pydict()
        _synchronize()
        on_ms = (time.perf_counter() - t0) * 1e3
    with dt.execution_config_ctx(device_mode="off"):
        cpu = ai_embed_query(ai_frame(texts[:256], 256)).to_pydict()
    print(f"auto ai embed: the \"on\" run (cold weights) {on_ms:.1f} ms [{card}]", flush=True)
    return auto_ai_embed(df, out, cpu, card)


def auto_runs(lineitem, orders) -> dict:
    """``--phase auto``'s in-memory cells, each a callable returning its
    result: the supplier query, q1, q12 and partkey over new frames."""
    sup, q1df, pk = supplier_frame(lineitem), q1_frame(lineitem), partkey_frame(lineitem)
    df_l, df_o = q12_frames(lineitem, orders)
    return {"supplier": lambda: supplier_query(sup).to_pydict(),
            "q1": lambda: q1_query(q1df).to_pydict(),
            "q12": lambda: q12_query(df_l, df_o).to_pydict(),
            "partkey": lambda: partkey_query(pk).to_pydict()}


# ---- native: the host kernel library against its plain versions ------------------

NATIVE_RUNS = ("library", "plain", "library", "plain")  # in turns; each way's second is warm
NATIVE_RUNS_SHORT = ("library", "plain")  # the full script's short native phase
NATIVE_LAYER_RUNS = 3  # host-clock runs per layer timing (the median printed)
NATIVE_MASK_DENSITIES = (0.01, 0.5, 0.98)  # kept rows of the selection-vector timing
NATIVE_TPCDS = (65, 51)


@contextlib.contextmanager
def native_switch(plain: bool):
    """``DAFT_TPU_DISABLE_NATIVE`` set (``plain``) or unset for the block."""
    from daft_tpu_torch import native

    old = os.environ.pop(native.DISABLE_ENV, None)
    if plain:
        os.environ[native.DISABLE_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(native.DISABLE_ENV, None)
        if old is not None:
            os.environ[native.DISABLE_ENV] = old


def native_load(card: str) -> None:
    """Build (or load) the host kernel library from the checkout's source;
    a failed build fails the script."""
    from daft_tpu_torch import native
    from daft_tpu_torch.ops import _build

    try:
        native.get_lib()
    except (RuntimeError, OSError) as exc:
        raise SmokeFailure(f"the host kernel library did not build or load: {exc}") from exc
    info = _build.BUILD_INFO[os.path.basename(native.SOURCE)]
    print(f"native library {info['path']}: built in {info['seconds']:.2f} s "
          f"({len(native.EXPORTS)} exports) [{card}]", flush=True)


def native_summary() -> dict:
    """The ``native`` line: the library's path, its build seconds and each
    export's calls over the script."""
    from daft_tpu_torch import native
    from daft_tpu_torch.ops import _build

    info = _build.BUILD_INFO[os.path.basename(native.SOURCE)]
    calls = native.calls()
    return {"path": info["path"], "build_s": info["seconds"],
            "calls": {name: calls.get(name, 0) for name in native.EXPORTS}}


def native_cell(label: str, run, card: str, runs=NATIVE_RUNS, **cfg) -> dict:
    """``run()`` on the host (device_mode="off", ``cfg`` added) with the
    library and with DAFT_TPU_DISABLE_NATIVE set, in turns (library, plain,
    library, plain): every result equal to the first, the plain runs
    calling the library never, the library's runs calling it. Prints each
    way's first and warm (second) ms and a warm library run's calls;
    returns {"library_ms", "plain_ms"} (warm)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import native

    first, times, calls = None, {"library": [], "plain": []}, {}
    for way in runs:
        with native_switch(way == "plain"), dt_ctx(), \
                dt.execution_config_ctx(device_mode="off", **cfg):
            before = native.calls()
            t0 = time.perf_counter()
            got = run()
            times[way].append((time.perf_counter() - t0) * 1e3)
            after = native.calls()
        if way == "plain":
            check(after == before, f"native {label}: a plain run called the library")
        else:
            calls = {k: v - before.get(k, 0) for k, v in after.items() if v > before.get(k, 0)}
            check(calls, f"native {label}: the library was never called")
        if first is None:
            first = got
        else:
            check(got == first, f"native {label}: the {way} run differs from the first")
    lib, plain = times["library"][-1], times["plain"][-1]
    print(f"native {label}: {'warm' if len(runs) > 2 else 'one run each:'} library "
          f"{lib:.1f} ms, plain {plain:.1f} ms "
          f"({plain / lib:.2f}x); first {times['library'][0]:.1f} / {times['plain'][0]:.1f} ms; "
          f"calls {json.dumps(calls, sort_keys=True)} [{card}]", flush=True)
    return {"library_ms": lib, "plain_ms": plain}


def native_layer(label: str, fn, card: str) -> None:
    """One host function at SF1 shapes with the library and plain, in
    turns, the results equal: each way's median of NATIVE_LAYER_RUNS."""
    times, out = {"library": [], "plain": []}, {}
    for _ in range(NATIVE_LAYER_RUNS):
        for way in ("library", "plain"):
            with native_switch(way == "plain"):
                t0 = time.perf_counter()
                got = fn()
                times[way].append((time.perf_counter() - t0) * 1e3)
            out.setdefault(way, got)
    check(_same_arrays(out["library"], out["plain"]),
          f"native layer {label}: the library's result differs from the plain version's")
    lib, plain = (statistics.median(times[w]) for w in ("library", "plain"))
    print(f"native layer {label}: library {lib:.2f} ms, plain {plain:.2f} ms "
          f"({plain / lib:.2f}x) [{card}]", flush=True)


def _same_arrays(a, b) -> bool:
    import numpy as np

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_arrays(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    return a == b


def native_layers(lineitem, orders, card: str) -> None:
    """The host kernels at SF1 shapes, library against plain: make_groups
    over l_suppkey and over (l_returnflag, l_linestatus), grouped_reduce
    sum / min / max / var of l_extendedprice by supplier, join_indices of
    lineitem and orders, ProbeTable's build and probe over orders' keys
    (dense, and spread by a prime: the hashed map), and the selection
    vector of a 6 M-row mask: packed bitmaps through ``bool_mask_indices``
    against ``np.flatnonzero``."""
    import numpy as np

    from daft_tpu_torch import native
    from daft_tpu_torch.core.kernels.groupby import grouped_reduce, make_groups
    from daft_tpu_torch.core.kernels.join import ProbeTable, join_indices
    from daft_tpu_torch.core.series import Series

    supp = Series.from_numpy(lineitem["l_suppkey"], "l_suppkey")
    flag = Series.from_numpy(np.array(RETURNFLAGS, dtype=object)[lineitem["l_returnflag"]],
                             "l_returnflag")
    status = Series.from_numpy(np.array(LINESTATUS, dtype=object)[lineitem["l_linestatus"]],
                               "l_linestatus")
    native_layer("make_groups l_suppkey", lambda: make_groups([supp]), card)
    native_layer("make_groups l_returnflag, l_linestatus", lambda: make_groups([flag, status]),
                 card)
    _first, gids, _counts = make_groups([supp])
    g = len(_first)
    price = lineitem["l_extendedprice"]
    ok = np.ones(len(price), dtype=bool)
    for op in ("sum", "min", "max", "var"):
        native_layer(f"grouped_reduce {op} l_extendedprice by l_suppkey",
                     lambda op=op: grouped_reduce(op, price, ok, gids, g), card)
    lkey = Series.from_numpy(lineitem["l_orderkey"], "l_orderkey")
    okey = Series.from_numpy(orders["o_orderkey"], "o_orderkey")
    native_layer("join_indices lineitem x orders", lambda: join_indices([lkey], [okey]), card)
    for spread, name in ((1, "dense"), (1_000_003, "hashed")):
        lk = Series.from_numpy(lineitem["l_orderkey"] * spread, "l_orderkey")
        ok_ = Series.from_numpy(orders["o_orderkey"] * spread, "o_orderkey")
        native_layer(f"ProbeTable build orders ({name})",
                     lambda ok_=ok_: ProbeTable([ok_], [ok_.dtype])._bucket_rows, card)
        tables = {}
        for plain in (False, True):
            with native_switch(plain):
                tables[plain] = ProbeTable([ok_], [lk.dtype])
        native_layer(f"ProbeTable probe lineitem ({name})",
                     lambda tables=tables, lk=lk: tables[native.disabled()].probe([lk], "inner"),
                     card)
    rng = np.random.default_rng(SEED)
    valid = rng.random(len(price)) < 0.99
    for density in NATIVE_MASK_DENSITIES:
        keep = rng.random(len(price)) < density
        times = {"library": [], "numpy": []}
        for _ in range(NATIVE_LAYER_RUNS):
            t0 = time.perf_counter()
            lib = native.native_mask_indices(native.pack_mask(keep), native.pack_mask(valid),
                                             0, len(keep))
            times["library"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            ref = np.flatnonzero(keep & valid)
            times["numpy"].append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(lib, ref), "native mask: bool_mask_indices differs from "
                                        "np.flatnonzero")
        lib_ms, np_ms = (statistics.median(times[w]) for w in ("library", "numpy"))
        print(f"native layer selection vector {len(keep)} rows, {density:.0%} kept: packed "
              f"bitmaps + bool_mask_indices {lib_ms:.2f} ms, np.flatnonzero {np_ms:.2f} ms "
              f"({np_ms / lib_ms:.2f}x) [{card}]", flush=True)


def phase_native(lineitem, orders, dims, card: str, full: bool = False) -> None:
    """The host kernel library against its plain versions (the switch
    DAFT_TPU_DISABLE_NATIVE) in one process: host cells (device_mode="off")
    both ways, equal: the in-memory supplier, q3, q12 and partkey cells.
    With ``full`` (``--phase native``) first the layer timings at SF1
    shapes, then also in-memory q1 (its string keys' factorize, about 10 s a
    run, keeps it out of the full script), file-fed q3 and q5 in SQL, the
    ooc phase's nine queries under B10, TPC-DS q65 and q51 and the
    functions cell."""
    import daft_tpu_torch as dt

    phase("native")
    print(f"host: os.cpu_count() {os.cpu_count()} [{card}]", flush=True)
    t_phase = time.perf_counter()
    if full:
        native_layers(lineitem, orders, card)
    cells = auto_runs(lineitem, orders)
    tails = tails_frames(lineitem, orders, dims)
    cells["q3"] = lambda: q3_query(tails).to_pydict()
    for label in ("supplier", "q1", "q3", "q12", "partkey"):
        if full or label != "q1":
            native_cell(label, cells[label], card,
                        runs=NATIVE_RUNS if full else NATIVE_RUNS_SHORT)
    del cells, tails
    if full:
        root = tempfile.mkdtemp(prefix="daft_tpu_torch_native_")
        try:
            frames = scan_tables(lineitem, orders, dims)
            dirs = scan_write(frames, root, card)

            def pq(name):
                return dt.read_parquet(dirs[name])

            native_cell("file-fed q3", lambda: q3_query(
                {"lineitem": pq("lineitem"), "orders": pq("orders"),
                 "customer": pq("customer")}).to_pydict(), card)
            sess = dt.current_session()
            sess.create_temp_table("lineitem", pq("lineitem"))
            sess.create_temp_table("orders", pq("orders"))
            for name in SCAN_CSV:
                sess.create_temp_table(name, dt.read_csv(dirs[f"{name}_csv"]))
            try:
                native_cell("file-fed q5 sql", lambda: dt.sql(TPCH_SQL[5]).to_pydict(), card)
            finally:
                for name in ("lineitem", "orders") + SCAN_CSV:
                    sess.drop_temp_table(name)
            queries = tpch_port_queries()
            tables = ooc_tables(frames, dirs["lineitem"])
            budget = budget_of(frames, 0.10)
            spill = os.path.join(root, "spill")
            os.makedirs(spill)
            for q in OOC_QUERIES:
                native_cell(f"ooc q{q} B10", lambda q=q: queries[q](tables).to_pydict(), card,
                            memory_limit_bytes=budget, spill_dir=spill)
            del frames, tables
        finally:
            shutil.rmtree(root, ignore_errors=True)
        tpcds = tpcds_frames(tpcds_tables())
        queries = tpcds_port_queries()
        for qn in NATIVE_TPCDS:
            native_cell(f"tpcds q{qn}", lambda qn=qn: queries[qn](tpcds).to_pydict(), card)
        del tpcds
        df = functions_frame(lineitem)
        native_cell("functions", lambda: functions_query(df).to_pydict(), card)
    print(f"native phase {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)


# ---- multimodal: images from files through a device UDF into the grouped stage ------

MM_SEED = SEED
MM_IMAGES = 4096           # M1's images
MM_SIDES = (128, 512)      # each side drawn in [128, 512]: downscales and upscales to 224
MM_SIZE = 224              # to_fixed_shape("RGB", 224, 224)
MM_EMBED = 64              # the device UDF's output width
MM_BATCH = 512             # the device UDF's batch_size (rows a dispatch)
MM_BAD = 0.01              # the share of files replaced by bytes of no image
MM_CHECK_ROWS = 256        # the UDF's rows held to the same function on the CPU
MM_WARM_RUNS = 1           # M1's warm runs (their median)
MM_PNG_LEVEL = 1           # the zlib level the seeded files are written at
MM_KERNELS = ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes")
MM_FLOATS = ("s", "m", "lo", "hi")
# the image functions and the distance stay on the host: the fused region
# refuses their nested operands, and the grouped stage reads their outputs
MM_HOST_REASONS = ("region: nested operand stays on the host",)
MM_DOCS = 200_000          # M2's documents
# the full script runs M1 and M2 at these depths (J1 drives M1's chain at full
# size after them); --phase multimodal alone runs MM_IMAGES and MM_DOCS
FULL_MM_IMAGES = 1024
FULL_MM_DOCS = 50_000
MM_VOCAB = 5_000           # their vocabulary
MM_DOC_WORDS = (8, 40)     # words a document
MM_EDITS = 0.10            # the share that are one-word edits of another document
MM_HASHES, MM_NGRAM, MM_BAND = 32, 3, 4
M3_PERCENTILES = (0.5, 0.9, 0.99)
M3_ALPHA = 0.01


def mm_write_images(root: str, n: int = MM_IMAGES, seed: int = MM_SEED) -> dict:
    """``n`` PNG files written by the port's encoder (at zlib level
    MM_PNG_LEVEL) into ``root``: sides
    drawn in MM_SIDES, 80 % RGB, 10 % L, 10 % RGBA, smooth gradients plus
    noise; MM_BAD of them replaced by bytes of no image. Returns the
    oracle's view: {"paths", "channels", "widths", "bad", "bytes"}."""
    import numpy as np

    from daft_tpu_torch.core.kernels import png

    rng = np.random.default_rng(seed)
    hs = rng.integers(MM_SIDES[0], MM_SIDES[1] + 1, n)
    ws = rng.integers(MM_SIDES[0], MM_SIDES[1] + 1, n)
    u = rng.random(n)
    channels = np.where(u < 0.8, 3, np.where(u < 0.9, 1, 4))
    bad = np.zeros(n, dtype=bool)
    bad[rng.choice(n, int(round(n * MM_BAD)), replace=False)] = True
    paths = [os.path.join(root, f"img_{i:05d}.png") for i in range(n)]

    def one(i):
        r = np.random.default_rng([seed, i])
        if bad[i]:
            data = b"not an image " + r.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        else:
            h, w, c = int(hs[i]), int(ws[i]), int(channels[i])
            grad = (np.arange(h, dtype=np.float32)[:, None, None] * r.uniform(-0.4, 0.4, c)
                    + np.arange(w, dtype=np.float32)[None, :, None] * r.uniform(-0.4, 0.4, c)
                    + r.uniform(40, 215, c))
            img = np.clip(grad + r.integers(-6, 7, (h, w, c)), 0, 255).astype(np.uint8)
            data = png.encode_png(img, level=MM_PNG_LEVEL)
        with open(paths[i], "wb") as f:
            f.write(data)
        return len(data)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        sizes = list(pool.map(one, range(n)))
    return {"paths": paths, "channels": channels, "widths": ws, "bad": bad,
            "bytes": int(sum(sizes))}


def mm_projection(seed: int = MM_SEED):
    """The UDF's fixed seeded projection of a 7 x 7 pooled thumbnail's 147
    values to MM_EMBED - 3 features, and the fixed query vector."""
    import numpy as np

    rng = np.random.default_rng([seed, 7])
    w = (rng.standard_normal((147, MM_EMBED - 3)) / np.sqrt(147)).astype(np.float32)
    q = rng.standard_normal(MM_EMBED)
    return w, q


def mm_embed_fn(params, x):
    """The device UDF: (rows, 224, 224, 3) uint8 to MM_EMBED f32 features,
    the channel means and a projection of a 7 x 7 pooled thumbnail, in plain
    torch ops."""
    import torch

    f = x.to(torch.float32) * (1.0 / 255.0)
    means = f.mean(dim=(1, 2))
    thumb = torch.nn.functional.adaptive_avg_pool2d(f.permute(0, 3, 1, 2), 7) \
        .reshape(f.shape[0], -1)
    return torch.cat([means, thumb @ params["w"]], dim=1)


def mm_embed_func():
    import daft_tpu_torch as dt

    w, _q = mm_projection()
    return dt.func(mm_embed_fn, on_device=True, batch_size=MM_BATCH,
                   return_dtype=dt.DataType.embedding(dt.DataType.float32(), MM_EMBED),
                   device_params=lambda: {"w": w}, device_key="chip_smoke_mm_embed:v1")


def m1_frame(root: str, embed, upto: str = "agg"):
    """M1's chain over the files in ``root``: from_glob_path, url.download,
    image.decode(on_error="null"), to_fixed_shape("RGB", 224, 224), the
    device UDF, embedding.cosine_distance to the fixed query, and the key
    (channels x 16 + width // 64); with ``upto="agg"`` the groupby's count,
    sum, mean, min and max of the distance."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    _w, q = mm_projection()
    df = dt.from_glob_path(os.path.join(root, "*.png"))
    df = df.with_column("img", col("path").url.download().image.decode(on_error="null"))
    df = df.with_column("fx", col("img").image.to_fixed_shape("RGB", MM_SIZE, MM_SIZE))
    df = df.with_column("e", embed(col("fx")))
    df = df.with_column("dist", col("e").embedding.cosine_distance(dt.lit(q)))
    df = df.with_column("key", col("img").image_channel().cast(dt.DataType.int64()) * 16
                        + (col("img").image_width().cast(dt.DataType.int64()) // 64))
    if upto != "agg":
        return df.select("path", "key", "e", "dist")
    d = col("dist")
    return df.groupby("key").agg(d.count().alias("n"), d.sum().alias("s"),
                                 d.mean().alias("m"), d.min().alias("lo"),
                                 d.max().alias("hi")).sort("key")


def m1_oracle(meta: dict, dist) -> dict:
    """The grouped result in numpy from the generation's metadata (keys,
    counts) and per-file distances ``dist`` (the null key last)."""
    import numpy as np

    ok = ~meta["bad"]
    key = meta["channels"].astype(np.int64) * 16 + meta["widths"].astype(np.int64) // 64
    out = {"key": [], "n": [], "s": [], "m": [], "lo": [], "hi": []}
    for k in sorted(set(key[ok].tolist())):
        sel = ok & (key == k)
        v = dist[sel]
        out["key"].append(k)
        out["n"].append(int(sel.sum()))
        out["s"].append(float(v.sum()))
        out["m"].append(float(v.mean()))
        out["lo"].append(float(v.min()))
        out["hi"].append(float(v.max()))
    if (~ok).any():
        for c, v in (("key", None), ("n", 0), ("s", None), ("m", None), ("lo", None),
                     ("hi", None)):
            out[c].append(v)
    return out


def mm_time(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def phase_m1(root: str, card: str, kernel_results: dict, images: int = MM_IMAGES) -> dict:
    """M1: images from files into the card (see ``phase_multimodal``)."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.core.kernels import image as imk
    from daft_tpu_torch.functions import get_function
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import physical as pp

    t0 = time.perf_counter()
    meta = mm_write_images(root, images)
    print(f"M1 data: {images} PNG files ({int(meta['bad'].sum())} of no image), "
          f"{meta['bytes']} bytes, written in {time.perf_counter() - t0:.2f} s by the port's "
          f"encoder", flush=True)
    embed = mm_embed_func()
    with dt_ctx():
        plan = pp.translate(m1_frame(root, embed).optimized_plan())
    names = []
    node = plan
    while node is not None:
        names.append(type(node).__name__)
        node = getattr(node, "input", None)
    check("DeviceGroupedAgg" in names, f"M1: no DeviceGroupedAgg in the plan {names}")
    check(any("Udf" in n for n in names), f"M1: no device UDF stage in the plan {names}")
    print(f"M1 plan: {' <- '.join(names)}", flush=True)

    # M1's cold run, its host steps timed as they run (the host split), its
    # UDF output and distances captured: the UDF against the same function
    # on the CPU, the distances against numpy, and the numpy oracle's
    # per-group values from them, made before the warm runs
    from daft_tpu_torch.ops import udf_stage

    clear_residency()
    split, seen = {}, {"e": [], "dist": []}

    def timed(label, fn, keep=None):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                split[label] = split.get(label, 0.0) + time.perf_counter() - t0
            if keep is not None:
                seen[keep].append(out)
            return out
        return wrapped

    dl_spec, dist_spec = get_function("url_download"), get_function("cosine_distance")
    real = (dl_spec.host, dist_spec.host, imk.decode, imk.to_fixed_shape,
            udf_stage.DeviceUdfRun.feed_batch, udf_stage.DeviceUdfRun.finalize)
    udf_label = "udf (cold: fingerprint, upload, dispatch, copy back)"
    dl_spec.host = timed("download", real[0])
    dist_spec.host = timed("cosine_distance", real[1], "dist")
    imk.decode = timed("decode", real[2])
    imk.to_fixed_shape = timed("to_fixed_shape (convert + resize)", real[3])
    udf_stage.DeviceUdfRun.feed_batch = timed(udf_label, real[4])
    udf_stage.DeviceUdfRun.finalize = timed(udf_label, real[5], "e")

    def restore():
        (dl_spec.host, dist_spec.host, imk.decode, imk.to_fixed_shape,
         udf_stage.DeviceUdfRun.feed_batch, udf_stage.DeviceUdfRun.finalize) = real

    def cold_oracle():
        restore()
        e = np.concatenate([out for out, _valid in seen["e"]]).astype(np.float32)
        valid = np.concatenate([v for _out, v in seen["e"]])
        check(np.array_equal(valid, ~meta["bad"]), "M1: the null rows are not the files of "
                                                   "no image")
        paths = dt.Series.from_pylist(meta["paths"][:MM_CHECK_ROWS], "path")
        fx = imk.to_fixed_shape(imk.decode(real[0]([paths], {}), on_error="null"), "RGB",
                                MM_SIZE, MM_SIZE)
        w, q = mm_projection()
        with torch.inference_mode():
            cpu = mm_embed_fn({"w": torch.from_numpy(w)},
                              torch.from_numpy(fx.to_numpy())).numpy()
        live = valid[:MM_CHECK_ROWS]
        err = float(np.abs(cpu[live] - e[:MM_CHECK_ROWS][live]).max())
        check(np.allclose(e[:MM_CHECK_ROWS][live], cpu[live], rtol=1e-5, atol=1e-6),
              f"M1: the UDF on the card differs from the CPU (max abs err {err:.3g})")
        print(f"M1: the UDF's {int(live.sum())} first valid rows equal the CPU's within "
              f"rtol 1e-5 (max abs err {err:.3g})", flush=True)
        d = dt.Series.concat(seen["dist"])
        dist = np.where(d.validity_numpy(), d.to_numpy(), np.nan)
        with np.errstate(invalid="ignore"):
            want = 1.0 - (e.astype(np.float64) @ q) / (
                np.linalg.norm(e.astype(np.float64), axis=1) * np.linalg.norm(q))
        check(np.array_equal(~np.isnan(dist), valid)
              and np.allclose(dist[valid], want[valid], rtol=1e-12),
              "M1: cosine_distance differs from numpy's")
        print("M1 host split of the cold run (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f" [{card}]", flush=True)
        holder["dist"] = dist
        return m1_oracle(meta, dist)

    def no_warm_uploads(cold, warm):
        check(warm["hbm_cache_misses"] == 0 and warm["hbm_h2d_bytes"] == 0
              and warm["device_udf_weight_h2d_bytes"] == 0,
              f"M1: the warm runs uploaded {warm['hbm_h2d_bytes']} bytes "
              f"({warm['hbm_cache_misses']} residency misses)")
        print(f"M1: the warm runs upload {warm['hbm_h2d_bytes']} bytes, "
              f"{warm['hbm_cache_misses']} residency misses, "
              f"{warm['hbm_stable_rehits']} planes rebound by their fingerprint", flush=True)

    holder, calls = {}, {}
    try:
        got, launches = run_cell("M1", lambda: m1_frame(root, embed), MM_KERNELS, card,
                                 MM_FLOATS, cold_oracle, extra_checks=no_warm_uploads,
                                 host_reasons=MM_HOST_REASONS, warm_runs=MM_WARM_RUNS,
                                 captured=calls)
    finally:
        restore()
    oracle = m1_oracle(meta, holder["dist"])
    check(got["key"] == oracle["key"] and got["n"] == oracle["n"],
          "M1: keys and counts differ from the oracle")
    stage_kernel_cases("m1", "M1", calls, MM_KERNELS, kernel_results, card)
    del calls

    # the stage alone, warm, over the distances already computed
    flat = dt.from_pydict({"key": [None if k < 0 else int(k) for k in
                                   (np.where(meta["bad"], -1, meta["channels"] * 16
                                             + meta["widths"] // 64)).tolist()],
                           "dist": holder["dist"]})
    with dt_ctx():
        stage = lambda: flat.groupby("key").agg(dt.col("dist").sum()).to_pydict()  # noqa: E731
        stage()
        print(f"M1 stage alone (warm): {mm_time(stage):.4f} s [{card}]", flush=True)
    del flat
    phase_profile(lambda: m1_frame(root, embed).to_pydict(), card, "M1 profile",
                  host_ops=False)
    counters.reset()
    return {"multimodal_m1": launches}


def m2_corpus(n: int = MM_DOCS, seed: int = MM_SEED):
    """``n`` documents of MM_DOC_WORDS words from a seeded MM_VOCAB-word
    vocabulary; MM_EDITS of them a one-word edit of an earlier document.
    Returns (texts, the (copy, source) pairs)."""
    import numpy as np

    rng = np.random.default_rng([seed, 2])
    vocab = np.array([f"w{i:04d}{chr(97 + i % 26)}" for i in range(MM_VOCAB)], dtype=object)
    lens = rng.integers(MM_DOC_WORDS[0], MM_DOC_WORDS[1] + 1, n)
    words = rng.integers(0, MM_VOCAB, int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    docs = [words[offs[i]:offs[i + 1]] for i in range(n)]
    copies = np.flatnonzero(rng.random(n) < MM_EDITS)
    copies = copies[copies > 0]
    pairs = []
    for i in copies.tolist():
        src = int(rng.integers(0, i))
        d = docs[src].copy()
        d[int(rng.integers(0, len(d)))] = int(rng.integers(0, MM_VOCAB))
        docs[i] = d
        pairs.append((i, src))
    return [" ".join(vocab[d].tolist()) for d in docs], pairs


def m2_signatures_oracle(texts):
    """The minhash signatures in numpy and hashlib, written out apart from
    the port: numpy's default_rng(1) permutations, BLAKE2b-8 of each word
    3-gram, (a x + b) mod 2^61 - 1 masked to 32 bits, each row's minimum."""
    import hashlib

    import numpy as np

    rng = np.random.default_rng(1)
    a = rng.integers(1, 1 << 32, size=MM_HASHES, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=MM_HASHES, dtype=np.uint64)
    p, mask = np.uint64((1 << 61) - 1), np.uint64(0xFFFFFFFF)
    counts, digests = [], []
    for t in texts:  # every document has at least MM_NGRAM words
        w = t.split()
        grams = [" ".join(w[j:j + MM_NGRAM]) for j in range(len(w) - MM_NGRAM + 1)]
        counts.append(len(grams))
        digests += [hashlib.blake2b(g.encode(), digest_size=8).digest() for g in grams]
    x = np.frombuffer(b"".join(digests), dtype=np.uint64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.empty((len(texts), MM_HASHES), dtype=np.uint64)
    for j in range(MM_HASHES):  # one permutation at a time over every 3-gram
        with np.errstate(over="ignore"):
            h = ((x * a[j] + b[j]) % p) & mask
        out[:, j] = np.minimum.reduceat(h, starts)
    return out


def m2_band_oracle(sig):
    """The first band's int64 key: splitmix64 chained over its 4 hashes,
    shifted right by one."""
    import numpy as np

    h = splitmix64_np(sig[:, 0].copy())
    for j in range(1, MM_BAND):
        h = splitmix64_np(h ^ sig[:, j])
    return (h >> np.uint64(1)).astype(np.int64)


def phase_m2(card: str, kernel_results: dict, docs: int = MM_DOCS) -> dict:
    """M2: near-duplicate text (see ``phase_multimodal``)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    t0 = time.perf_counter()
    texts, pairs = m2_corpus(docs)
    print(f"M2 data: {docs} documents, {len(pairs)} one-word edits, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    docs = dt.from_pydict({"t": texts})
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        t0 = time.perf_counter()
        sig = docs.select(col("t").minhash(num_hashes=MM_HASHES, ngram_size=MM_NGRAM)
                          .alias("sig")).collect()
        minhash_s = time.perf_counter() - t0
        h = col("sig").list.get(0).hash()
        for j in range(1, MM_BAND):
            h = h._fn("bitwise_xor", col("sig").list.get(j)).hash()
        t0 = time.perf_counter()
        bands = sig.select(h._fn("shift_right", dt.lit(np.uint64(1)))
                           .cast(dt.DataType.int64())
                           .alias("band")).collect()
        band_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = docs.select(col("t").tokenize_encode("bytes").list.length().alias("n")).sum("n") \
            .to_pydict()
        tok_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_sig = m2_signatures_oracle(texts)
    oracle_s = time.perf_counter() - t0
    got_sig = sig.to_pydict()["sig"]
    got_sig = np.stack(got_sig) if isinstance(got_sig[0], np.ndarray) else np.array(got_sig,
                                                                                    np.uint64)
    check(np.array_equal(got_sig.astype(np.uint64), want_sig),
          "M2: the minhash signatures differ from the oracle")
    want_band = m2_band_oracle(want_sig)
    got_band = np.asarray(bands.to_pydict()["band"], dtype=np.int64)
    check(np.array_equal(got_band, want_band), "M2: the band keys differ from the oracle")
    want_tok = sum(len(t.encode("utf-8")) for t in texts)
    check(tok["n"] == [want_tok], f"M2: tokenize_encode's lengths sum to {tok['n']}, not "
                                  f"{want_tok}")
    print(f"M2 host (s): minhash {minhash_s:.3f} (32 hashes, 3-grams), band key {band_s:.3f}, "
          f"tokenize_encode + list_length {tok_s:.3f}; the numpy/hashlib oracle "
          f"{oracle_s:.3f}; signatures and bands equal the oracle bit for bit [{card}]",
          flush=True)
    keys, counts = np.unique(want_band, return_counts=True)
    order = np.argsort(keys)
    oracle = {"band": keys[order].tolist(), "n": counts[order].astype(np.int64).tolist()}
    calls = {}
    got, launches = run_cell("M2 band", lambda: bands.groupby("band").agg(
        col("band").count().alias("n")).sort("band"), ("segment_sum_planes",), card, (),
        oracle, captured=calls)
    stage_kernel_cases("m2", "M2", calls, ("segment_sum_planes",), kernel_results, card)
    del calls
    dup = {k for k, c in zip(got["band"], got["n"]) if c > 1}
    cand = sum(c * (c - 1) // 2 for c in got["n"])
    want_cand = int((counts * (counts - 1) // 2).sum())
    check(cand == want_cand, f"M2: {cand} candidate pairs, the oracle {want_cand}")
    caught = sum(1 for i, j in pairs if want_band[i] == want_band[j] and want_band[i] in dup)
    print(f"M2: {len(got['band'])} bands, {len(dup)} shared, {cand} candidate pairs (the "
          f"oracle's); {caught} of the {len(pairs)} planted edits share their first band "
          f"[{card}]", flush=True)
    return {"multimodal_m2": launches}


def phase_m3(lineitem, card: str) -> None:
    """M3: sketches at SF1 (see ``phase_multimodal``)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.core.kernels import sketches

    df = dt.from_pydict({c: lineitem[c] for c in ("l_orderkey", "l_extendedprice",
                                                  "l_returnflag", "l_linestatus")})
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        t0 = time.perf_counter()
        est = df.agg(col("l_orderkey").approx_count_distinct().alias("n")).to_pydict()["n"][0]
        hll_s = time.perf_counter() - t0
        regs = sketches.hll_registers(dt.Series.from_numpy(lineitem["l_orderkey"]))
    # the oracle: the registers bit by bit, as the reference shifts them
    h = splitmix64_np(np.asarray(lineitem["l_orderkey"], dtype=np.int64).view(np.uint64))
    idx = (h >> np.uint64(50)).astype(np.int64)
    rest = (h << np.uint64(14)) | np.uint64((1 << 14) - 1)
    lz = np.zeros(len(rest), dtype=np.uint8)
    alive = np.ones(len(rest), dtype=bool)
    for _ in range(51):
        top0 = alive & ((rest & np.uint64(1 << 63)) == 0)
        lz[top0] += 1
        alive = top0
        if not alive.any():
            break
        rest = rest << np.uint64(1)
    want_regs = np.zeros(1 << 14, dtype=np.uint8)
    np.maximum.at(want_regs, idx, lz + 1)
    check(np.array_equal(regs, want_regs), "M3: the HLL registers differ from the oracle")
    m = float(1 << 14)
    e = 0.7213 / (1.0 + 1.079 / m) * m * m / np.power(2.0, -want_regs.astype(np.float64)).sum()
    zeros = int((want_regs == 0).sum())
    if e <= 2.5 * m and zeros:  # the small-range correction
        e = m * np.log(m / zeros)
    want_est = int(round(e))
    exact = len(np.unique(lineitem["l_orderkey"]))
    check(est == want_est, f"M3: the estimate {est} is not the oracle's {want_est}")
    check(abs(est - exact) <= 0.02 * exact, f"M3: the estimate {est} is not within 2 % of "
                                            f"{exact}")
    print(f"M3 approx_count_distinct(l_orderkey): {est} (exact {exact}, error "
          f"{(est - exact) / exact:+.4%}); registers and estimate equal the oracle; "
          f"{hll_s:.3f} s host [{card}]", flush=True)
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        t0 = time.perf_counter()
        got = df.groupby("l_returnflag", "l_linestatus").agg(
            col("l_extendedprice").approx_percentile(*M3_PERCENTILES).alias("p")) \
            .sort(["l_returnflag", "l_linestatus"]).to_pydict()
        pct_s = time.perf_counter() - t0
    flags = np.asarray(lineitem["l_returnflag"], dtype=object)
    status = np.asarray(lineitem["l_linestatus"], dtype=object)
    price = np.asarray(lineitem["l_extendedprice"], dtype=np.float64)
    worst = 0.0
    for f, s, ps in zip(got["l_returnflag"], got["l_linestatus"], got["p"]):
        v = np.sort(price[(flags == f) & (status == s)])
        for q, est_q in zip(M3_PERCENTILES, ps):
            x = v[int(np.floor(q * (len(v) - 1)))]
            rel = abs(est_q - x) / abs(x)
            worst = max(worst, rel)
            check(rel <= M3_ALPHA + 1e-12, f"M3: percentile {q} of ({f}, {s}) is {est_q}, "
                                           f"{rel:.4%} from the exact {x}")
    print(f"M3 approx_percentile(l_extendedprice, {list(M3_PERCENTILES)}) by (l_returnflag, "
          f"l_linestatus): {len(got['p'])} groups, worst relative error {worst:.5f} (alpha "
          f"{M3_ALPHA}); {pct_s:.3f} s host [{card}]", flush=True)


def phase_multimodal(lineitem, card: str, kernel_results: dict, images: int = MM_IMAGES,
                     docs: int = MM_DOCS) -> dict:
    """Images, text sketches and the approximate aggregates (items 7d, 7e):

    - M1: ``images`` seeded PNG files written by the port's encoder (1 % of
      no image) through from_glob_path, url.download, image.decode
      (on_error="null"), to_fixed_shape("RGB", 224, 224), an on_device UDF
      over the (bucket, 224, 224, 3) uint8 tensor (MM_EMBED f32 features),
      embedding.cosine_distance to a fixed query, and a groupby of channels
      x width bucket with count, sum, mean, min and max of the distance on
      the grouped stage. The UDF's output equals the CPU's within rtol
      1e-5, the result "off" and the oracle (keys and counts bit for bit),
      and a warm run uploads 0 bytes. The host split and one profiled run.
    - M2: ``docs`` documents, minhash(32, 3) on the host equal to a numpy /
      hashlib oracle bit for bit, the first band's int64 key, and
      groupby(band).count() on the grouped stage (K1): its candidate pairs
      the oracle's; tokenize_encode("bytes") -> list.length summed.
    - M3: approx_count_distinct(l_orderkey) at SF1, its registers and
      estimate the oracle's and within 2 % of 1,500,000; approx_percentile
      of l_extendedprice at 0.5, 0.9, 0.99 by flag and status within alpha
      of the exact quantiles.

    The grouped stage's kernels at the inputs M1's and M2's cold runs gave
    them, each held against its plain version, go into ``kernel_results``
    under "at_m1_..." and "at_m2_...". Returns {path: the cold run's
    launches}."""
    phase("multimodal")
    start = time.perf_counter()
    clear_residency()
    paths = {}
    root = tempfile.mkdtemp(prefix="daft_tpu_torch_mm_")
    try:
        paths.update(phase_m1(root, card, kernel_results, images))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    clear_residency()
    phase("multimodal M2")
    paths.update(phase_m2(card, kernel_results, docs))
    phase("multimodal M3")
    phase_m3(lineitem, card)
    clear_residency()
    print(f"multimodal phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return paths


# ---- ingest: a JSONL manifest of JPEGs and a gzipped WARC crawl into the grouped stage --

INGEST_SEED = SEED
J1_IMAGES = 4096           # J1's manifest rows
J1_SHARDS = 4              # JSONL shards of J1_IMAGES // J1_SHARDS rows
J1_SIDES = (128, 640)      # each side drawn in [128, 640] (ImageNet val averages ~400 x 350)
J1_LABELS = 21             # classes
J1_BAD = 41                # rows whose bytes are no image (truncated JPEGs, random bytes)
J1_QUALITIES = (75, 85, 95)
# the writer's mix: (kind, share); the share left over after J1_BAD is 4:1:1
J1_MIX = (("4:2:0", 0.80), ("4:4:4", 0.05), ("L", 0.10))
J1_PLAIN_FILES = 256       # files decoded by the library and by the plain version
J1_FLOATS = ("m", "lo", "hi")
J1_WARM_RUNS = 1
JPEG_FIXTURES = os.path.join(HERE, "tests", "data", "jpeg")
W1_FILES = 4               # gzipped WARC files
W1_RESPONSES = 4096        # response records a file (each after its request record;
                           # 8,192 took the phase to 212 s on an H100 at 700 W, past 180)
W1_HOSTS = 2048
W1_PAYLOAD = (1024, 8192)  # each response's text, bytes drawn in this range
W1_DUPLICATES = 0.10       # the share of responses that repeat an earlier payload exactly
W1_VOCAB = 20_000          # the seeded Zipf vocabulary's words
W1_ZIPF = 1.15
W1_WARM_RUNS = 1
W1_TOKENIZER = os.path.join(HERE, "tests", "data", "w1_tokenizer.json")
W1_KERNELS = ("segment_sum_planes",)
W1_FLOATS = ("mean_len",)
W1_HOST_REASONS = ("region: nested operand stays on the host",)
_CRAWL_SCRIPTS = ("abcdefghijklmnopqrstuvwxyz", "àáâäçèéêëíîïñóôöúûüßøå",
                  "абвгдежзийклмнопрстуфхцчшщъыьэюя", "αβγδεζηθικλμνξοπρστυφχψω",
                  "的一是不了人我在有他这为之大来以个中上们到说国和地也子时道出而要于就下得可你年生",
                  "0123456789")
_CRAWL_PUNCT = (",", ".", "!", "?", ";", ":", "—", "(", ")", "'s", "n't", "🎉", "👍", "…")


def j1_image(r, h: int, w: int, c: int):
    """A seeded smooth image with noise (M1's recipe): (h, w, c) uint8."""
    import numpy as np

    grad = (np.arange(h, dtype=np.float32)[:, None, None] * r.uniform(-0.4, 0.4, c)
            + np.arange(w, dtype=np.float32)[None, :, None] * r.uniform(-0.4, 0.4, c)
            + r.uniform(40, 215, c))
    return np.clip(grad + r.integers(-6, 7, (h, w, c)), 0, 255).astype(np.uint8)


def j1_write(root: str, seed: int = INGEST_SEED) -> dict:
    """J1's data: J1_IMAGES JPEG files written by the port's encoder (the
    J1_MIX of RGB 4:2:0 at a quality from J1_QUALITIES, RGB 4:4:4, "L" and
    the rest RGB 4:1:1) and J1_BAD rows of no image (a JPEG cut short, or
    random bytes), under ``root``/img; a manifest of J1_SHARDS JSONL shards
    under ``root``/manifest, a row each: key, path, caption, label, width,
    height. Returns the oracle's view."""
    import numpy as np

    from daft_tpu_torch.core.kernels import jpeg

    n = J1_IMAGES
    rng = np.random.default_rng(seed)
    hs = rng.integers(J1_SIDES[0], J1_SIDES[1] + 1, n)
    ws = rng.integers(J1_SIDES[0], J1_SIDES[1] + 1, n)
    labels = rng.integers(0, J1_LABELS, n)
    u = rng.random(n)
    edges = np.cumsum([share for _k, share in J1_MIX])
    kinds = np.array([k for k, _s in J1_MIX] + ["4:1:1"])[np.searchsorted(edges, u, "right")]
    quality = rng.choice(J1_QUALITIES, n)
    bad = np.zeros(n, dtype=bool)
    bad[rng.choice(n, J1_BAD, replace=False)] = True
    words = ["photo", "of", "a", "the", "dog", "cat", "red", "small", "on", "street", "with",
             "tree", "old", "car", "blue", "sky", "near", "river", "two", "people", "house"]
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    os.makedirs(os.path.join(root, "manifest"), exist_ok=True)
    paths = [os.path.join(root, "img", f"{i:05d}.jpg") for i in range(n)]

    def one(i):
        r = np.random.default_rng([seed, i])
        h, w, kind = int(hs[i]), int(ws[i]), str(kinds[i])
        img = j1_image(r, h, w, 1 if kind == "L" else 3)
        if kind == "L":
            data = jpeg.encode_jpeg(img, quality=int(quality[i]))
        else:
            data = jpeg.encode_jpeg(img, quality=int(quality[i]), subsampling=kind)
        if bad[i]:
            data = data[:int(len(data) * r.uniform(0.2, 0.9))] if i % 2 \
                else r.integers(0, 256, 2048, dtype=np.uint8).tobytes()
        with open(paths[i], "wb") as f:
            f.write(data)
        return len(data)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        sizes = list(pool.map(one, range(n)))
    per = -(-n // J1_SHARDS)
    for s in range(J1_SHARDS):
        with open(os.path.join(root, "manifest", f"part-{s}.jsonl"), "w") as f:
            for i in range(s * per, min(n, (s + 1) * per)):
                cap = " ".join(words[k] for k in rng.integers(0, len(words), 6))
                f.write(json.dumps({"key": i, "path": paths[i], "caption": cap,
                                    "label": int(labels[i]), "width": int(ws[i]),
                                    "height": int(hs[i])}) + "\n")
    return {"paths": paths, "labels": labels, "bad": bad, "kinds": kinds,
            "bytes": int(sum(sizes))}


def j1_frame(root: str, embed, upto: str = "agg"):
    """J1's chain: read_json over the manifest, url.download of each path,
    image.decode(on_error="null"), to_fixed_shape("RGB", 224, 224), M1's
    device UDF, embedding.cosine_distance to the fixed query; with
    ``upto="agg"`` groupby(label) with count, mean, min and max of the
    distance."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    _w, q = mm_projection()
    df = dt.read_json(os.path.join(root, "manifest"))
    df = df.with_column("img", col("path").url.download().image.decode(on_error="null"))
    df = df.with_column("fx", col("img").image.to_fixed_shape("RGB", MM_SIZE, MM_SIZE))
    df = df.with_column("e", embed(col("fx")))
    df = df.with_column("dist", col("e").embedding.cosine_distance(dt.lit(q)))
    if upto != "agg":
        return df.select("key", "label", "e", "dist")
    d = col("dist")
    return df.groupby("label").agg(d.count().alias("n"), d.mean().alias("m"),
                                   d.min().alias("lo"), d.max().alias("hi")).sort("label")


def j1_oracle(meta: dict, dist) -> dict:
    """J1's grouped result in numpy from the manifest's labels, the rows of
    no image and the per-row distances ``dist``."""
    import numpy as np

    out = {"label": [], "n": [], "m": [], "lo": [], "hi": []}
    for k in sorted(set(meta["labels"].tolist())):
        sel = (meta["labels"] == k) & ~meta["bad"]
        v = dist[sel]
        out["label"].append(int(k))
        out["n"].append(int(sel.sum()))
        out["m"].append(float(v.mean()) if len(v) else None)
        out["lo"].append(float(v.min()) if len(v) else None)
        out["hi"].append(float(v.max()) if len(v) else None)
    return out


def _jpeg_digest(path: str):
    """(shape, mode, sha256 of the pixels) of a JPEG file as the port
    decodes it, or the error's class name."""
    import hashlib

    from daft_tpu_torch.core.kernels import jpeg

    with open(path, "rb") as f:
        data = f.read()
    try:
        img = jpeg.decode_jpeg(data)
    except Exception as e:  # noqa: BLE001  (the class is what is compared)
        return type(e).__name__
    return (list(img.pixels.shape), img.mode, hashlib.sha256(img.pixels.tobytes()).hexdigest())


def _plain_worker_init(root: str) -> None:
    sys.path.insert(0, root)
    os.environ["DAFT_TPU_DISABLE_NATIVE"] = "1"


def j1_plain_check(paths, card: str) -> None:
    """The library's JPEG decode against the plain version's (the Python
    Huffman loop and the numpy stages, under DAFT_TPU_DISABLE_NATIVE, in
    spawned processes), bit for bit, on ``paths`` and on the committed
    fixtures of tests/data/jpeg, whose PIL pixels' digests the fixtures'
    expected.json holds."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    with open(os.path.join(JPEG_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    fixtures = [os.path.join(JPEG_FIXTURES, name) for name in sorted(expected)]
    files = list(paths) + fixtures
    t0 = time.perf_counter()
    lib = [_jpeg_digest(p) for p in files]
    lib_s = time.perf_counter() - t0
    root = os.path.dirname(os.path.dirname(sys.modules["daft_tpu_torch"].__file__))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 4,
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_plain_worker_init, initargs=(root,)) as pool:
        plain = list(pool.map(_jpeg_digest, files, chunksize=8))
    plain_s = time.perf_counter() - t0
    bad = [p for p, a, b in zip(files, lib, plain) if a != b]
    check(not bad, f"J1: the library's JPEG decode differs from the plain one on {bad[:3]}")
    for p in fixtures:
        want = expected[os.path.basename(p)]
        got = lib[files.index(p)]
        check(got == (want["shape"], want["mode"], want["sha256"]) if isinstance(got, tuple)
              else False, f"J1: fixture {os.path.basename(p)} decodes to {got}, not PIL's "
                          f"{want}")
    print(f"J1: the library's JPEG decode equals the plain version bit for bit on "
          f"{len(paths)} files and {len(fixtures)} fixtures (progressive, restarts, CMYK; "
          f"their pixels PIL's); library {lib_s:.3f} s on one thread, plain {plain_s:.3f} s "
          f"on {os.cpu_count()} processes [{card}]", flush=True)


def phase_j1(root: str, card: str, kernel_results: dict) -> dict:
    """J1: a JSONL manifest of JPEGs into the card (see ``phase_ingest``)."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.core.kernels import image as imk
    from daft_tpu_torch.functions import get_function
    from daft_tpu_torch.io import json as json_io
    from daft_tpu_torch.ops import udf_stage
    from daft_tpu_torch.plan import physical as pp

    t0 = time.perf_counter()
    meta = j1_write(root)
    kinds = {k: int((meta["kinds"] == k).sum()) for k in sorted(set(meta["kinds"].tolist()))}
    print(f"J1 data: {J1_IMAGES} JPEG files {kinds} ({J1_BAD} of no image), "
          f"{meta['bytes']} bytes, and {J1_SHARDS} JSONL shards, written in "
          f"{time.perf_counter() - t0:.2f} s by the port's encoder", flush=True)
    j1_plain_check(meta["paths"][:J1_PLAIN_FILES], card)
    embed = mm_embed_func()
    with dt_ctx():
        plan = pp.translate(j1_frame(root, embed).optimized_plan())
    names = []
    node = plan
    while node is not None:
        names.append(type(node).__name__)
        node = getattr(node, "input", None)
    check("DeviceGroupedAgg" in names, f"J1: no DeviceGroupedAgg in the plan {names}")
    check(any("Udf" in n for n in names), f"J1: no device UDF stage in the plan {names}")
    print(f"J1 plan: {' <- '.join(names)}", flush=True)

    clear_residency()
    split, seen = {}, {"e": [], "dist": []}

    def timed(label, fn, keep=None):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
            finally:
                split[label] = split.get(label, 0.0) + time.perf_counter() - t0
            if keep is not None:
                seen[keep].append(out)
            return out
        return wrapped

    dl_spec, dist_spec = get_function("url_download"), get_function("cosine_distance")
    real = (json_io._parse_lines, dl_spec.host, dist_spec.host, imk.decode,
            imk.to_fixed_shape, udf_stage.DeviceUdfRun.feed_batch,
            udf_stage.DeviceUdfRun.finalize)
    udf_label = "udf (cold: fingerprint, upload, dispatch, copy back)"
    json_io._parse_lines = timed("read_json", real[0])
    dl_spec.host = timed("download", real[1])
    dist_spec.host = timed("cosine_distance", real[2], "dist")
    imk.decode = timed("decode", real[3])
    imk.to_fixed_shape = timed("resize (to_fixed_shape)", real[4])
    udf_stage.DeviceUdfRun.feed_batch = timed(udf_label, real[5])
    udf_stage.DeviceUdfRun.finalize = timed(udf_label, real[6], "e")

    def restore():
        (json_io._parse_lines, dl_spec.host, dist_spec.host, imk.decode, imk.to_fixed_shape,
         udf_stage.DeviceUdfRun.feed_batch, udf_stage.DeviceUdfRun.finalize) = real

    def cold_oracle():
        restore()
        e = np.concatenate([out for out, _valid in seen["e"]]).astype(np.float32)
        valid = np.concatenate([v for _out, v in seen["e"]])
        check(np.array_equal(valid, ~meta["bad"]), "J1: the null rows are not the rows of no "
                                                   "image")
        paths = dt.Series.from_pylist(meta["paths"][:MM_CHECK_ROWS], "path")
        fx = imk.to_fixed_shape(imk.decode(real[1]([paths], {}), on_error="null"), "RGB",
                                MM_SIZE, MM_SIZE)
        w, q = mm_projection()
        with torch.inference_mode():
            cpu = mm_embed_fn({"w": torch.from_numpy(w)},
                              torch.from_numpy(fx.to_numpy())).numpy()
        live = valid[:MM_CHECK_ROWS]
        err = float(np.abs(cpu[live] - e[:MM_CHECK_ROWS][live]).max())
        check(np.allclose(e[:MM_CHECK_ROWS][live], cpu[live], rtol=1e-5, atol=1e-6),
              f"J1: the UDF on the card differs from the CPU (max abs err {err:.3g})")
        print(f"J1: the UDF's {int(live.sum())} first valid rows equal the CPU's within "
              f"rtol 1e-5 (max abs err {err:.3g})", flush=True)
        d = dt.Series.concat(seen["dist"])
        dist = np.where(d.validity_numpy(), d.to_numpy(), np.nan)
        with np.errstate(invalid="ignore"):
            want = 1.0 - (e.astype(np.float64) @ q) / (
                np.linalg.norm(e.astype(np.float64), axis=1) * np.linalg.norm(q))
        check(np.array_equal(~np.isnan(dist), valid)
              and np.allclose(dist[valid], want[valid], rtol=1e-12),
              "J1: cosine_distance differs from numpy's")
        print("J1 host split of the cold run (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f" [{card}]", flush=True)
        holder["dist"] = dist
        return j1_oracle(meta, dist)

    def no_warm_uploads(cold, warm):
        check(warm["hbm_cache_misses"] == 0 and warm["hbm_h2d_bytes"] == 0
              and warm["device_udf_weight_h2d_bytes"] == 0,
              f"J1: the warm runs uploaded {warm['hbm_h2d_bytes']} bytes "
              f"({warm['hbm_cache_misses']} residency misses)")
        print(f"J1: the warm runs upload {warm['hbm_h2d_bytes']} bytes, "
              f"{warm['hbm_cache_misses']} residency misses, "
              f"{warm['hbm_stable_rehits']} planes rebound by their fingerprint", flush=True)

    holder, calls = {}, {}
    try:
        # the manifest's shards reach the UDF as several morsels: flush by size
        # alone, so each run cuts the same UDF batches and a warm run rebinds
        with dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS):
            got, launches = run_cell("J1", lambda: j1_frame(root, embed), MM_KERNELS, card,
                                     J1_FLOATS, cold_oracle, extra_checks=no_warm_uploads,
                                     host_reasons=MM_HOST_REASONS, warm_runs=J1_WARM_RUNS,
                                     captured=calls)
    finally:
        restore()
    oracle = j1_oracle(meta, holder["dist"])
    check(got["label"] == oracle["label"] and got["n"] == oracle["n"],
          "J1: labels and counts differ from the oracle")
    stage_kernel_cases("j1", "J1", calls, MM_KERNELS, kernel_results, card)
    del calls
    # the stage alone, warm, over the labels and distances already computed
    flat = dt.from_pydict({"label": meta["labels"].tolist(), "dist": holder["dist"]})
    d = dt.col("dist")
    with dt_ctx():
        stage = lambda: flat.groupby("label").agg(  # noqa: E731
            d.count(), d.mean().alias("m"), d.min().alias("lo"), d.max().alias("hi")).to_pydict()
        stage()
        print(f"J1 stage alone (warm): {mm_time(stage):.4f} s [{card}]", flush=True)
    del flat
    with dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS):
        phase_profile(lambda: j1_frame(root, embed).to_pydict(), card, "J1 profile",
                      host_ops=False)
    return {"ingest_j1": launches}


def crawl_vocabulary(seed: int = INGEST_SEED):
    """W1_VOCAB seeded words of mixed scripts (Latin with and without
    accents, Cyrillic, Greek, CJK, digits), a few with punctuation or an
    emoji attached."""
    import numpy as np

    rng = np.random.default_rng([seed, 1])
    words = []
    for i in range(W1_VOCAB):
        alphabet = _CRAWL_SCRIPTS[i % len(_CRAWL_SCRIPTS)]
        n = int(rng.integers(1, 4)) if i % len(_CRAWL_SCRIPTS) == 4 else int(rng.integers(1, 10))
        w = "".join(rng.choice(list(alphabet), n))
        if i % 17 == 0:
            w = w.capitalize()
        if i % 23 == 0:
            w += str(rng.choice(_CRAWL_PUNCT))
        words.append(w)
    return words


def crawl_texts(rng, n: int, words):
    """``n`` texts of W1_PAYLOAD bytes, Zipf-drawn words joined by spaces, a
    newline every 12th word."""
    import numpy as np

    vocab = np.array(words, dtype=object)
    nbytes = np.array([len(w.encode("utf-8")) + 1 for w in words])
    targets = rng.integers(W1_PAYLOAD[0], W1_PAYLOAD[1] + 1, n)
    per_word = float(nbytes.mean())
    draws = (rng.zipf(W1_ZIPF, int(targets.sum() / per_word * 1.5) + 1000) - 1) % len(words)
    cum = np.cumsum(nbytes[draws])
    out, start, base = [], 0, 0
    for t in targets.tolist():
        stop = int(np.searchsorted(cum, base + t)) + 1
        seg = vocab[draws[start:stop]].tolist()
        lines = [" ".join(seg[k:k + 12]) for k in range(0, len(seg), 12)]
        out.append("\n".join(lines))
        base = int(cum[stop - 1])
        start = stop
    return out


def _warc_record(headers: dict, payload: bytes) -> bytes:
    head = "WARC/1.0\r\n" + "".join(f"{k}: {v}\r\n" for k, v in headers.items()) + \
        f"Content-Length: {len(payload)}\r\n\r\n"
    return head.encode("utf-8") + payload + b"\r\n\r\n"


def crawl_write(root: str, seed: int = INGEST_SEED) -> dict:
    """W1's data: W1_FILES gzipped WARC files under ``root``, each a
    warcinfo record, then W1_RESPONSES request / response pairs, every
    record its own gzip member (as Common Crawl writes them). A response's
    payload is an HTTP header and a W1_PAYLOAD text (W1_DUPLICATES of them
    an earlier payload again); its URI's host one of W1_HOSTS. Returns the
    oracle's view: each response's host, payload length and text."""
    import gzip

    import numpy as np

    os.makedirs(root, exist_ok=True)
    words = crawl_vocabulary(seed)
    rng = np.random.default_rng([seed, 2])
    n = W1_FILES * W1_RESPONSES
    fresh = crawl_texts(rng, n, words)
    dup = rng.random(n) < W1_DUPLICATES
    dup[0] = False
    texts = []
    for i in range(n):
        texts.append(texts[int(rng.integers(0, i))] if dup[i] else fresh[i])
    tlds = ("com", "org", "net", "de", "ru", "cn", "gr", "fr")
    hosts = [f"site{h:04d}.example.{tlds[h % len(tlds)]}" for h in range(W1_HOSTS)]
    host_of = (rng.zipf(1.3, n) - 1) % W1_HOSTS
    scheme = np.where(rng.random(n) < 0.7, "https", "http")
    payloads = [("HTTP/1.1 200 OK\r\nContent-Type: text/html; charset=utf-8\r\n\r\n" + t)
                .encode("utf-8") for t in texts]

    def one(f):
        path = os.path.join(root, f"crawl-{f:02d}.warc.gz")
        info = f"software: chip_smoke.py\r\nformat: WARC File Format 1.0\r\n".encode()
        members = [gzip.compress(_warc_record(
            {"WARC-Type": "warcinfo", "WARC-Date": "2024-05-01T00:00:00Z",
             "WARC-Record-ID": f"<urn:uuid:info-{f}>", "Content-Type": "application/warc-fields"},
            info))]
        for i in range(f * W1_RESPONSES, (f + 1) * W1_RESPONSES):
            uri = f"{scheme[i]}://{hosts[host_of[i]]}/page/{i}"
            date = f"2024-05-01T{(i // 3600) % 24:02d}:{(i // 60) % 60:02d}:{i % 60:02d}Z"
            req = f"GET /page/{i} HTTP/1.1\r\nHost: {hosts[host_of[i]]}\r\n\r\n".encode()
            members.append(gzip.compress(_warc_record(
                {"WARC-Type": "request", "WARC-Target-URI": uri, "WARC-Date": date,
                 "WARC-Record-ID": f"<urn:uuid:req-{i}>",
                 "Content-Type": "application/http; msgtype=request"}, req)))
            members.append(gzip.compress(_warc_record(
                {"WARC-Type": "response", "WARC-Target-URI": uri, "WARC-Date": date,
                 "WARC-Record-ID": f"<urn:uuid:resp-{i}>",
                 "Content-Type": "application/http; msgtype=response"}, payloads[i])))
        with open(path, "wb") as fh:
            fh.write(b"".join(members))
        return os.path.getsize(path)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=W1_FILES) as pool:
        sizes = list(pool.map(one, range(W1_FILES)))
    return {"hosts": [hosts[h] for h in host_of.tolist()],
            "lengths": [len(p) for p in payloads], "payloads": payloads,
            "duplicates": int(dup.sum()), "bytes": int(sum(sizes))}


def crawl_frame(root: str, tokenizer: str = W1_TOKENIZER, upto: str = "agg"):
    """W1's chain: read_warc, the responses, the host by ``str.extract``,
    the tokens a response by ``tokenize_encode(<the BPE file>)`` then
    ``list.length()`` (as int64); with ``upto="agg"`` groupby(host):
    count, sum of the tokens, mean of the content length."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    df = dt.read_warc(os.path.join(root, "*.warc.gz"))
    df = df.where(col("warc_type") == "response")
    df = df.with_column("host", col("warc_target_uri").str.extract(r"^https?://([^/]+)", 1))
    # list.length() is uint64, which the grouped stage does not sum: int64 does
    df = df.with_column("n_tokens", col("content").tokenize_encode(tokenizer).list.length()
                        .cast(dt.DataType.int64()))
    if upto != "agg":
        return df.select("host", "n_tokens", "content_length")
    return crawl_aggregate(df)


def crawl_aggregate(df):
    from daft_tpu_torch import col

    return df.groupby("host").agg(col("content_length").count().alias("n"),
                                  col("n_tokens").sum().alias("tokens"),
                                  col("content_length").mean().alias("mean_len")).sort("host")


def _plain_token_counts(texts, tokenizer: str = W1_TOKENIZER) -> list:
    """The tokens of each text by the tokenizer file's plain reader (a
    spawned worker of ``crawl_oracle``, DAFT_TPU_DISABLE_NATIVE set)."""
    from daft_tpu_torch.functions.tokenizer_file import from_file

    tok = from_file(tokenizer)
    return [len(tok.encode(t)) for t in texts]


def crawl_oracle(meta: dict, tokenizer: str = W1_TOKENIZER) -> dict:
    """W1's result in plain Python over the generated records: per host the
    responses, their tokens and their mean payload length. The tokens are
    counted by the tokenizer file's plain reader (the ``re`` split and a
    dict, under DAFT_TPU_DISABLE_NATIVE, in spawned processes, each
    distinct payload once), so the host library's split and word table,
    which the timed path runs, are held to it."""
    from concurrent.futures import ProcessPoolExecutor
    import functools
    import itertools
    import multiprocessing

    distinct = list(dict.fromkeys(meta["payloads"]))
    texts = [p.decode("utf-8", "replace") for p in distinct]
    workers = min(os.cpu_count() or 4, max(1, len(texts)))
    step = -(-len(texts) // (4 * workers)) or 1
    root = os.path.dirname(os.path.dirname(sys.modules["daft_tpu_torch"].__file__))
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_plain_worker_init, initargs=(root,)) as pool:
        chunks = pool.map(functools.partial(_plain_token_counts, tokenizer=tokenizer),
                          [texts[i:i + step] for i in range(0, len(texts), step)])
        counts = dict(zip(distinct, itertools.chain.from_iterable(chunks)))
    per = {}
    for host, length, payload in zip(meta["hosts"], meta["lengths"], meta["payloads"]):
        n, t, s = per.get(host, (0, 0, 0))
        per[host] = (n + 1, t + counts[payload], s + length)
    out = {"host": [], "n": [], "tokens": [], "mean_len": []}
    for host in sorted(per):
        n, t, s = per[host]
        out["host"].append(host)
        out["n"].append(n)
        out["tokens"].append(t)
        out["mean_len"].append(s / n)
    return out


def phase_crawl(root: str, card: str, kernel_results: dict) -> dict:
    """W1: a gzipped Common Crawl shard into the card (see
    ``phase_ingest``)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.functions import get_function
    from daft_tpu_torch.io import warc as warc_io

    t0 = time.perf_counter()
    meta = crawl_write(root)
    print(f"W1 data: {W1_FILES} gzipped WARC files, {W1_FILES * W1_RESPONSES} responses "
          f"({meta['duplicates']} exact duplicates) of {sum(meta['lengths'])} payload bytes "
          f"over {len(set(meta['hosts']))} hosts, {meta['bytes']} bytes gzipped, written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    oracle = crawl_oracle(meta)
    print(f"W1 oracle (the plain tokenizer on {os.cpu_count()} processes) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del meta

    split = {}

    def timed(label, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                split[label] = split.get(label, 0.0) + time.perf_counter() - t0
        return wrapped

    tok_spec, ext_spec = get_function("tokenize_encode"), get_function("utf8_extract")
    real = (warc_io.iter_warc_records, tok_spec.host, ext_spec.host)

    def scan_timed(path):
        it = real[0](path)
        while True:
            t0 = time.perf_counter()
            try:
                rec = next(it)
            except StopIteration:
                split["scan (gunzip, parse)"] = split.get("scan (gunzip, parse)", 0.0) + \
                    time.perf_counter() - t0
                return
            split["scan (gunzip, parse)"] = split.get("scan (gunzip, parse)", 0.0) + \
                time.perf_counter() - t0
            yield rec

    warc_io.iter_warc_records = scan_timed
    tok_spec.host = timed("tokenize", real[1])
    ext_spec.host = timed("extract host", real[2])

    def restore():
        warc_io.iter_warc_records, tok_spec.host, ext_spec.host = real

    def cold_oracle():
        restore()
        print("W1 host split of the cold run (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in split.items()) + f" [{card}]", flush=True)
        return oracle

    def no_warm_uploads(cold, warm):
        check(warm["hbm_cache_misses"] == 0 and warm["hbm_h2d_bytes"] == 0,
              f"W1: the warm runs uploaded {warm['hbm_h2d_bytes']} bytes "
              f"({warm['hbm_cache_misses']} residency misses)")
        print(f"W1: the warm runs upload {warm['hbm_h2d_bytes']} bytes, "
              f"{warm['hbm_cache_misses']} residency misses, "
              f"{warm['hbm_stable_rehits']} planes rebound by their fingerprint", flush=True)

    calls = {}
    try:
        with dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS):
            got, launches = run_cell("W1", lambda: crawl_frame(root), W1_KERNELS, card,
                                     W1_FLOATS, cold_oracle, extra_checks=no_warm_uploads,
                                     host_reasons=W1_HOST_REASONS, warm_runs=W1_WARM_RUNS,
                                     captured=calls)
    finally:
        restore()
    check(got["host"] == oracle["host"] and got["n"] == oracle["n"]
          and got["tokens"] == oracle["tokens"], "W1: hosts, counts or tokens differ from "
                                                 "the oracle")
    print(f"W1: {len(got['host'])} hosts, {sum(got['n'])} responses, {sum(got['tokens'])} "
          f"tokens, equal to the oracle", flush=True)
    stage_kernel_cases("w1", "W1", calls, W1_KERNELS, kernel_results, card)
    del calls
    # the stage alone, warm, over one row per response with its host, tokens and length
    with dt_ctx():
        flat = dt.from_pydict(crawl_frame(root, upto="rows").to_pydict())
        stage = lambda: crawl_aggregate(flat).to_pydict()  # noqa: E731
        stage()
        print(f"W1 stage alone (warm): {mm_time(stage):.4f} s [{card}]", flush=True)
    del flat
    with dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS):
        phase_profile(lambda: crawl_frame(root).to_pydict(), card, "W1 profile",
                      host_ops=False)
    return {"ingest_w1": launches}


def phase_ingest(card: str, kernel_results: dict) -> dict:
    """The ingest formats (Queue 1's image codecs and tokenizer files, item
    2's JSON, text and WARC scans):

    - J1: a JSONL manifest of JPEGs, the shape of an image-caption set.
      J1_IMAGES JPEG files written by the port's encoder (sides in
      J1_SIDES; RGB 4:2:0 at quality 75, 85 or 95, RGB 4:4:4, "L", RGB
      4:1:1; J1_BAD rows of no image) and J1_SHARDS JSONL shards; read_json
      -> url.download -> image.decode(on_error="null") -> to_fixed_shape
      ("RGB", 224, 224) -> M1's device UDF -> cosine distance -> groupby
      (label) with count, mean, min and max on the grouped stage. Held to
      "off", a numpy oracle, the UDF's CPU run and 0 bytes uploaded warm;
      the library's JPEG decode to the plain one bit for bit on
      J1_PLAIN_FILES files and the committed fixtures (PIL's pixels).
    - W1: a Common Crawl shard, the shape of pretraining data prep.
      W1_FILES gzipped WARC files of W1_RESPONSES request / response pairs
      (W1_HOSTS hosts, W1_DUPLICATES exact duplicates, Zipf text of mixed
      scripts); read_warc -> the responses -> host by str.extract and
      tokens by tokenize_encode(<the committed BPE file>).list.length() ->
      groupby(host) with count, sum(tokens) and mean(content_length) on the
      grouped stage. Held to "off" and a plain-Python oracle whose tokens
      the tokenizer file's plain reader counts (the host library's split
      and word table held to it).

    Each prints its host split, cold and warm wall time and a profiled
    run's device busy time and idle share. Returns {path: the cold run's
    launches}."""
    phase("ingest")
    start = time.perf_counter()
    clear_residency()
    paths = {}
    root = tempfile.mkdtemp(prefix="daft_tpu_torch_ingest_")
    try:
        paths.update(phase_j1(os.path.join(root, "j1"), card, kernel_results))
        clear_residency()
        phase("ingest W1")
        paths.update(phase_crawl(os.path.join(root, "w1"), card, kernel_results))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    clear_residency()
    print(f"ingest phase {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    return paths


# ---- dist: the distributed workers ----------------------------------------------

DIST_WORKERS = 2            # worker processes, both leased the card
DIST_HEARTBEAT_S = "0.2"    # the workers' heartbeat period in this phase
DIST_RTOL = 1e-9            # float sums against the f64 host sums
DIST_TENANTS = 4            # the served tenants, each sending q1 and q6
DIST_KERNELS = ("segment_sum_planes", "segment_sum_float_planes")  # K1, K7: above 0
DIST_Q1_INTS = ("l_returnflag", "l_linestatus", "count_order", "min_price", "max_price")


def dist_launches(trace) -> dict:
    """The workers' kernel launches in one traced distributed run: each
    ``launches_<kernel>`` counter of the tasks' ``engine_counters`` (the
    workers' registry deltas over each task), summed, and by worker."""
    from daft_tpu_torch.ops import counters

    total = {k: 0 for k in counters.KERNEL_NAMES}
    by_worker = {}
    for ts in trace.tasks:
        ec = dict(ts.engine_counters)
        w = by_worker.setdefault(ts.worker_id, {})
        for k in counters.KERNEL_NAMES:
            n = int(ec.get(f"{CELL_KERNEL_PREFIX}{k}", 0))
            total[k] += n
            if n:
                w[k] = w.get(k, 0) + n
    return {"total": total, "by_worker": by_worker}


def dist_task_times(trace) -> str:
    """The slowest task's execution and queue wait of a traced run, on the
    host's clock."""
    tasks = list(trace.tasks) if trace is not None else []
    if not tasks:
        return "no worker tasks"
    return (f"{len(tasks)} worker tasks, slowest exec {max(t.exec_s for t in tasks):.3f} s, "
            f"longest queue wait {max(t.queue_wait_s for t in tasks):.3f} s")


def dist_check_launches(label: str, launches: dict) -> None:
    """A SmokeFailure unless every kernel of DIST_KERNELS ran in a worker."""
    for k in DIST_KERNELS:
        check(launches["total"].get(k, 0) > 0,
              f"{label}: kernel {k} was not launched in a worker process")


def dist_same_q1(got: dict, want: dict, oracle: dict) -> bool:
    """q1 (with its extremes) through the workers against a single-process
    run: keys, counts and min / max bit for bit; the float sums and means
    within DIST_RTOL of the numpy oracle's f64 sums."""
    import numpy as np

    if list(got) != list(want):
        return False
    for c in DIST_Q1_INTS:
        if [np.float64(v).tobytes() if isinstance(v, float) else v for v in got[c]] != \
                [np.float64(v).tobytes() if isinstance(v, float) else v for v in want[c]]:
            return False
    for c in Q1_FLOATS:
        if len(got[c]) != len(oracle[c]) or not np.allclose(
                np.array(got[c], dtype=float), np.array(oracle[c], dtype=float),
                rtol=DIST_RTOL, atol=0.0):
            return False
    return True


def dist_worker_h2d(pool, after_ts: float, timeout_s: float = 30.0) -> dict:
    """Each live worker's cumulative host-to-device bytes from its first
    heartbeat sent after ``after_ts`` (a beat sent once the coordinator holds
    every result postdates every upload the worker's tasks made)."""
    out = {}
    deadline = time.time() + timeout_s
    while time.time() < deadline and set(out) != set(pool.workers):
        for hb in pool.drain_heartbeats():
            if hb.get("ts", 0.0) > after_ts and not hb.get("dead"):
                out[hb["worker_id"]] = int(hb.get("hbm_h2d_bytes", 0))
        time.sleep(0.05)
    check(set(out) == set(pool.workers), f"dist: no fresh heartbeat from every worker: {out}")
    return out


@contextlib.contextmanager
def dist_env(**env):
    """The environment the pool's workers inherit, set for one block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dist_traced(runner, query):
    """One traced run through ``runner`` (an ambient stats collector, so
    every task ships its engine counters): (result, seconds, launches)."""
    import daft_tpu_torch.runners as runners
    from daft_tpu_torch.observability.runtime_stats import StatsCollector, set_collector

    runners.set_runner(runner)
    set_collector(StatsCollector())
    try:
        t0 = time.perf_counter()
        got = query().to_pydict()
        seconds = time.perf_counter() - t0
    finally:
        set_collector(None)
        runners.set_runner(None)
    return got, seconds, dist_launches(runner.last_trace)


def phase_dist(lineitem, orders, card: str) -> dict:
    """The dist phase: TPC-H q1 (with l_extendedprice's min and max) at SF1
    through DistributedRunner(num_workers=2, n_partitions=2,
    device_workers=2), both workers leased the card: the partial
    DeviceGroupedAgg stages run K1, K3 and K7 in the worker processes, then
    the hash shuffle and the final aggregate. Then the repeat (affinity hits,
    each worker's h2d bytes flat), q12 through the runner, a worker killed
    mid-query (its shuffle files lost, one respawn), and four tenants' q1
    and q6 through ServingSession(runner=...). Every result is held to the
    single-process run on the card; q1 also to device_mode "off" and the
    numpy oracle. Returns the workers' launches of the first run."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.distributed import DistributedRunner
    from daft_tpu_torch.observability.metrics import registry

    phase("dist")
    clear_residency()
    df = q1_frame(lineitem)
    q1 = lambda: q1_query(df, extremes=True)  # noqa: E731
    oracle = q1_oracle(lineitem, extremes=True)
    with dt_ctx():
        t0 = time.perf_counter()
        want = q1().to_pydict()
        single_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        q1().to_pydict()
        single_warm = time.perf_counter() - t0
    with dt.execution_config_ctx(device_mode="off"):
        want_off = q1().to_pydict()
    check(dist_same_q1(want, want_off, oracle), "dist: the single-process q1 on the card "
          "differs from device_mode off or the oracle")
    print(f"dist: single-process q1 cold {single_cold:.3f} s, warm {single_warm:.3f} s "
          f"[{card}]", flush=True)
    out = {}
    with dt_ctx(), dist_env(DAFT_TPU_HEARTBEAT_S=DIST_HEARTBEAT_S):
        t0 = time.perf_counter()
        r = DistributedRunner(num_workers=DIST_WORKERS, n_partitions=DIST_WORKERS,
                              device_workers=DIST_WORKERS)
        try:
            pool = r._ensure_pool()
            print(f"dist: pool of {DIST_WORKERS} leased workers up in "
                  f"{time.perf_counter() - t0:.3f} s; each leased budget "
                  f"{pool.workers['worker-0'].spawn_config.get('hbm_budget_bytes')} bytes",
                  flush=True)
            # 1. q1 through the runner, cold
            got, cold_s, launches = dist_traced(r, q1)
            t_first = time.time()
            check(dist_same_q1(got, want, oracle), "dist q1: differs from the single-process "
                  "run on the card or the oracle")
            check(dist_same_q1(got, want_off, oracle), "dist q1: differs from device_mode off")
            dist_check_launches("dist q1", launches)
            h2d_first = dist_worker_h2d(pool, t_first)
            check(all(v > 0 for v in h2d_first.values()), f"dist q1: a worker uploaded "
                  f"nothing: {h2d_first}")
            out = launches["total"]
            print(f"dist q1 cold {cold_s:.3f} s (single-process cold {single_cold:.3f} s); "
                  f"{dist_task_times(r.last_trace)}; "
                  f"workers' launches {json.dumps(launches['by_worker'], sort_keys=True)}; "
                  f"h2d bytes by worker {json.dumps(h2d_first, sort_keys=True)} [{card}]",
                  flush=True)
            # 2. the repeat: affinity hits, no upload
            before = registry().snapshot()
            got2, warm_s, launches2 = dist_traced(r, q1)
            t_second = time.time()
            diff = registry().diff(before)
            h2d_second = dist_worker_h2d(pool, t_second)
            check(got2 == got, "dist q1 repeat: differs from the first run")
            check(diff.get("sched_affinity_hits", 0) > 0, f"dist q1 repeat: no affinity hit "
                  f"({diff.get('sched_affinity_misses', 0)} misses)")
            check(h2d_second == h2d_first, f"dist q1 repeat: a worker uploaded again: "
                  f"{h2d_first} -> {h2d_second}")
            dist_check_launches("dist q1 repeat", launches2)
            print(f"dist q1 warm {warm_s:.3f} s (single-process warm {single_warm:.3f} s); "
                  f"{dist_task_times(r.last_trace)}; "
                  f"affinity hits {diff.get('sched_affinity_hits', 0)}, bytes avoided "
                  f"{diff.get('sched_bytes_avoided', 0)}; h2d bytes by worker unchanged "
                  f"{json.dumps(h2d_second, sort_keys=True)}; workers' launches "
                  f"{json.dumps(launches2['by_worker'], sort_keys=True)} [{card}]", flush=True)
            # 3. a join: q12, its device join run by the coordinator (a DeviceJoinAgg
            # is not distributable), then its host plan (translated under
            # device_mode "off") through the workers: the join shuffled on
            # the order key, the grouped aggregate two-phase
            df_l, df_o = q12_frames(lineitem, orders)
            q12 = lambda: q12_query(df_l, df_o)  # noqa: E731
            t0 = time.perf_counter()
            want12 = q12().to_pydict()
            single12 = time.perf_counter() - t0
            got12, s12, _l12 = dist_traced(r, q12)
            check(got12 == want12, "dist q12: differs from the single-process run")
            with dt.execution_config_ctx(device_mode="off"):
                got12h, s12h, _l12h = dist_traced(r, q12)
            tasks12 = len(r.last_trace.tasks) if r.last_trace is not None else 0
            check(tasks12 > 0, "dist q12 host plan: no task ran on a worker")
            check(got12h == want12, "dist q12 host plan: differs from the single-process run")
            print(f"dist q12 {s12:.3f} s on the coordinator's device join (single-process "
                  f"{single12:.3f} s); its host plan through the workers {s12h:.3f} s, "
                  f"{tasks12} worker tasks; both equal [{card}]", flush=True)
            del df_l, df_o
            # 4. serving: four tenants' q1 and q6 through the runner
            dq6 = q6_frame(lineitem)
            with dt_ctx():
                want6 = q6_query(dq6).to_pydict()
            t0 = time.perf_counter()
            with dt.serving_session(max_concurrent=DIST_TENANTS, runner=r) as sess:
                futs = [(name, sess.submit(q1() if name == "q1" else q6_query(dq6),
                                           tenant=f"tenant-{t}"))
                        for t in range(DIST_TENANTS) for name in ("q1", "q6")]
                served = [(name, f.to_pydict(timeout=600)) for name, f in futs]
            serve_s = time.perf_counter() - t0
            for name, res in served:
                if name == "q1":
                    check(dist_same_q1(res, want, oracle), "dist serve: a tenant's q1 differs "
                          "from the single-process run")
                else:
                    check(same_result(res, want6, ("revenue",)), "dist serve: a tenant's q6 "
                          "differs from the single-process run")
            print(f"dist serve: {len(served)} queries of {DIST_TENANTS} tenants in "
                  f"{serve_s:.3f} s, equal to the single-process runs [{card}]", flush=True)
        finally:
            r.shutdown()
        # 5. a worker killed mid-query: its map files lost, one respawn
        once = tempfile.mkdtemp(prefix="daft_tpu_torch_dist_")
        try:
            with dist_env(DAFT_TPU_FAULT_POINT="task_sent", DAFT_TPU_FAULT_MODE="kill_lose",
                          DAFT_TPU_FAULT_WORKER="worker-1", DAFT_TPU_FAULT_STAGE="shuffle",
                          DAFT_TPU_FAULT_ONCE_FILE=os.path.join(once, "once"),
                          DAFT_TPU_WORKER_RESPAWN="1"):
                fail0 = registry().get("worker_failures_total")
                regen0 = registry().get("shuffle_maps_regenerated_total")
                r = DistributedRunner(num_workers=DIST_WORKERS, n_partitions=DIST_WORKERS,
                                      device_workers=DIST_WORKERS)
                try:
                    got_k, kill_s, _launches = dist_traced(r, q1)
                finally:
                    r.shutdown()
            failures = registry().get("worker_failures_total") - fail0
            regen = registry().get("shuffle_maps_regenerated_total") - regen0
            check(failures >= 1, "dist kill: no worker failure was detected")
            check(regen >= 1, "dist kill: no lost map output was regenerated")
            check(dist_same_q1(got_k, want, oracle), "dist kill: q1 after the kill differs "
                  "from the single-process run")
            print(f"dist kill: q1 {kill_s:.3f} s with worker-1 killed after its map "
                  f"(files lost); {failures} failure, {regen} map(s) regenerated; equal "
                  f"[{card}]", flush=True)
        finally:
            shutil.rmtree(once, ignore_errors=True)
    clear_residency()
    return out


def phase_alone(name: str, lineitem, orders, dims, card: str, kernel_results: dict) -> dict:
    """``--phase ooc``, ``window``, ``obs``, ``auto``, ``functions``,
    ``tpcds``, ``native``, ``temporal``, ``nested``, ``multimodal``,
    ``ingest`` or ``serve`` after the kernels phase: the scan phase's tables in memory
    (tpcds its own tables, and its kernel cases into ``kernel_results``;
    and, for ooc, obs and auto,
    lineitem written to Parquet under a temporary directory, as the scan
    phase writes it; obs and auto build their cells' frames as their phases
    do)."""
    import daft_tpu_torch as dt

    if name == "native":
        phase_native(lineitem, orders, dims, card, full=True)
        return {}
    if name == "temporal":
        return phase_temporal(lineitem, card, kernel_results)
    if name == "nested":
        return phase_nested(lineitem, card, kernel_results)
    if name == "multimodal":
        return phase_multimodal(lineitem, card, kernel_results)
    if name == "ingest":
        return phase_ingest(card, kernel_results)
    if name == "serve":
        return {"serve": phase_serve(lineitem, orders, dims, card, kernel_results)}
    if name == "dist":
        return {"dist": phase_dist(lineitem, orders, card)}
    frames = scan_tables(lineitem, orders, dims)
    if name == "window":
        return phase_window(lineitem, dims, frames, card)
    if name == "functions":
        return phase_functions(lineitem, card)
    if name == "tpcds":
        del frames
        tables = tpcds_tables()
        paths = phase_tpcds(tables, card)
        tpcds_kernel_cases(tables, kernel_results, card)
        return paths
    root = tempfile.mkdtemp(prefix="daft_tpu_torch_scan_")
    try:
        d = os.path.join(root, "lineitem")
        t0 = time.perf_counter()
        with dt_ctx():
            frames["lineitem"].write_parquet(d)
        print(f"write parquet lineitem {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        if name == "obs":
            del frames
            df_l, df_o = q12_frames(lineitem, orders)
            return phase_obs({"q1": q1_frame(lineitem), "q6": q6_frame(lineitem),
                              "q12": {"lineitem": df_l, "orders": df_o},
                              "tails": tails_frames(lineitem, orders, dims)}, d, card)
        if name == "auto":
            paths = phase_auto(frames, d, card, auto_runs(lineitem, orders))
            paths.update(auto_ai_alone(card))
            return paths
        return phase_ooc(frames, d, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dt_ctx():
    """The execution config every cell's device run takes."""
    import daft_tpu_torch as dt

    return dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="run the card, build, data and kernels phases only: the "
                             "kernels against their plain versions, with their times "
                             "(no main path runs, so no launches are counted)")
    parser.add_argument("--phase", choices=("ooc", "window", "obs", "auto", "functions",
                                            "tpcds", "native", "temporal", "nested",
                                            "multimodal", "ingest", "serve", "dist"),
                        help="run the card, build, data and kernels phases, then this phase "
                             "alone: ooc (TPC-H under a host memory budget, the external "
                             "sort, the Grace joins), window (W1, W2), obs (EXPLAIN "
                             "ANALYZE, a trace, a subscriber and the cost of observing, "
                             "on q1, q6, q12, q3 and a file-fed q6) or auto "
                             "(device_mode=\"auto\": the calibration, the rates, and the "
                             "ooc queries, the supplier, q1, q12, partkey and ai embed "
                             "cells with every verdict), functions (the device ops and "
                             "functions over SF1 lineitem in one grouped stage), tpcds "
                             "(the 25 TPC-DS queries at SF1, on against off) or native (the "
                             "host kernel library against its plain versions: the layers "
                             "at SF1 shapes and the host cells, in memory, file-fed, under "
                             "a budget, TPC-DS q65 and q51, functions) or temporal "
                             "(timestamps at SF1: T1 in memory, in SQL and file-fed, T2's "
                             "host functions and zones, windowed stddev / var, the plan "
                             "surface, K1, K3 and K7 at T1's inputs) or nested (lists, "
                             "structs and maps at SF1: N1 built on the host, N2 exploded "
                             "into the grouped stage, N3 through Parquet, N4's host "
                             "functions, N5 in SQL, K1, K2, K3 and K7 at N2's inputs) or "
                             "multimodal (M1: PNG files decoded, resized and fed to a "
                             "device UDF, its distances into the grouped stage; M2: minhash "
                             "bands into the grouped stage; M3: the sketch aggregates at "
                             "SF1) or ingest (J1: a JSONL manifest of JPEG files decoded, "
                             "resized and fed to a device UDF, its distances into the "
                             "grouped stage; W1: gzipped WARC files tokenized with a BPE "
                             "file, tokens per host on the grouped stage) or serve (four "
                             "tenants' TPC-H SQL at SF1 through one gateway: cold, warm, "
                             "result cache, a tight HBM budget, a cancel) or dist (q1 at SF1 "
                             "through two worker processes leased the card, its repeat, "
                             "q12, a killed worker, four served tenants)")
    parser.add_argument("--root", default=HERE,
                        help="the checkout whose daft_tpu_torch is driven (default: the "
                             "one beside this script), e.g. an unpacked parent commit to "
                             "time its kernels on the same card")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "daft_tpu_torch")):
        print(f"chip_smoke.py: no daft_tpu_torch package in {root}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    start = time.perf_counter()
    try:
        card, device_name = phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        phase_build(card)
        if not args.kernels_only:
            native_load(card)
        t0 = time.perf_counter()
        lineitem, orders, dims = tpch_sf1(SEED)
        print(f"datagen {time.perf_counter() - t0:.2f} s", flush=True)
        kernel_results = phase_kernels(lineitem, orders, dims, card)
        paths = {}
        if args.phase is not None:
            paths.update(phase_alone(args.phase, lineitem, orders, dims, card,
                                     kernel_results))
        elif not args.kernels_only:
            phase_native(lineitem, orders, dims, card)
            runs = {}  # the in-memory cells the auto phase runs again
            df, paths["supplier"] = phase_slice(lineitem, card)
            runs["supplier"] = lambda df=df: supplier_query(df).to_pydict()
            phase_profile(lambda: supplier_query(df).to_pydict(), card)
            sql_tables = {}
            cells = {}  # each cell's in-memory result, for the scan and pipeline phases
            with dt_ctx():
                cells["supplier"] = supplier_query(df).to_pydict()
            q12, paths["q12"] = phase_q12(lineitem, orders, card, sql_tables)
            runs["q12"] = lambda q12=q12: q12().to_pydict()
            phase_profile(lambda: q12().to_pydict(), card, "q12 profile")
            with dt_ctx():
                cells["q12"] = q12().to_pydict()
            del df, q12
            q1, paths["q1"], paths["q1_f64"] = phase_q1(lineitem, card, sql_tables)
            runs["q1"] = q1
            phase_profile(q1, card, "q1 profile")
            with dt_ctx():
                q1_result = q1()
            partkey, paths["partkey"] = phase_partkey(lineitem, card)
            runs["partkey"] = partkey
            phase_profile(partkey, card, "partkey profile")
            q6, paths["q6"] = phase_q6(lineitem, card, sql_tables)
            phase_profile(q6, card, "q6 profile")
            with dt_ctx():
                q6_result = q6()
            del q1, partkey, q6
            t0 = time.perf_counter()
            frames = tails_frames(lineitem, orders, dims)
            print(f"join tails' frames {time.perf_counter() - t0:.2f} s", flush=True)
            for cell in TAILS:
                tail, paths[cell] = phase_tail(cell, frames, lineitem, orders, dims, card)
                phase_profile(tail, card, f"{cell} profile")
                with dt_ctx():
                    cells[cell] = tail()
            sql_tables["tails"] = frames
            del frames, tail
            chain, paths["q1_chain"] = phase_q1_chain(lineitem, q1_result, card)
            phase_profile(chain, card, "q1 chain profile")
            chain, paths["q6_chain"] = phase_q6_chain(lineitem, q6_result, card)
            phase_profile(chain, card, "q6 chain profile")
            q5, paths["q5"] = phase_q5(lineitem, orders, dims, card, sql_tables)
            phase_profile(q5, card, "q5 profile")
            with dt_ctx():
                cells["q5"] = q5()
            paths["sql"] = phase_sql(sql_tables, card)
            paths["serve"] = phase_serve(lineitem, orders, dims, card, kernel_results)
            paths["dist"] = phase_dist(lineitem, orders, card)
            obs_tables = {"q1": sql_tables["q1"]["lineitem"], "q6": sql_tables["q6"]["lineitem"],
                          "q12": sql_tables["q12"], "tails": sql_tables["tails"]}
            del sql_tables
            topn, paths["topn_order"] = phase_topn_order(lineitem, orders, card)
            phase_profile(topn, card, "topn order profile")
            del chain, q5, topn
            coalesce, paths["coalesce"] = phase_coalesce(lineitem, card)
            phase_profile(coalesce, card, "coalesce profile")
            del coalesce
            repart, paths["repartition"] = phase_repartition(lineitem, card)
            phase_profile(repart, card, "repartition profile", mesh_devices=MESH)
            del repart
            cells.update(q1=q1_result, q6=q6_result)
            root = tempfile.mkdtemp(prefix="daft_tpu_torch_scan_")
            try:
                scan_paths, dirs = phase_scan(lineitem, orders, dims, cells, card, root)
                paths.update(scan_paths)
                paths.update(phase_pipeline(lineitem, orders, dirs, cells, card))
                paths.update(phase_obs(obs_tables, dirs["lineitem"], card))
                del obs_tables
                frames = scan_tables(lineitem, orders, dims)
                paths.update(phase_ooc(frames, dirs["lineitem"], card))
                paths.update(phase_auto(frames, dirs["lineitem"], card, runs))
                del runs
            finally:
                shutil.rmtree(root, ignore_errors=True)
            del cells
            paths.update(phase_window(lineitem, dims, frames, card))
            del frames
            paths.update(phase_functions(lineitem, card))
            paths.update(phase_temporal(lineitem, card, kernel_results))
            paths.update(phase_nested(lineitem, card, kernel_results))
            paths.update(phase_multimodal(lineitem, card, kernel_results,
                                          images=FULL_MM_IMAGES, docs=FULL_MM_DOCS))
            paths.update(phase_ingest(card, kernel_results))
            tables = tpcds_tables()
            paths.update(phase_tpcds(tables, card))
            tpcds_kernel_cases(tables, kernel_results, card)
            del tables
            paths.update(phase_ai(lineitem, card, kernel_results))
        phase(None)
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        return 1
    import torch

    kernels = []
    for kname, r in kernel_results.items():
        source, replaces = KERNELS[kname]
        by_path = {path: launches[kname] for path, launches in paths.items()}
        entry = {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": sum(by_path.values()) if by_path else None,
                 "launches_by_path": by_path,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": "bytes", "library_ms": r["library_ms"]}
        # the rest: device_ms, the read-once bound, tiers, the other shapes
        entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    if not args.kernels_only:
        print(f"native {json.dumps(native_summary())}")
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke.py took {time.perf_counter() - start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
