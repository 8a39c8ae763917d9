#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (daft_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on past an
error (no phase catches its own failure):

1. card:    print the card's name and power limit (nvidia-smi) and
            torch.cuda.get_device_name(0); fail when no card is found;
2. build:   build the hand-written kernels from ops/csrc (nvcc, one process
            per source, all started together, with measure/k7_leads.cu, the
            kernels that only measure) and print the build seconds;
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
            200,000 keys, lineitem's l_partkey probed). Every kernel also by
            its device time under
            torch.profiler (K4's build with the table's clearing, where it
            has one). K1a and K5 have no engine caller, in the port or in
            the reference: they are held here alone;
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
            time, warm median of 3, peak memory and a profile each;
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
            cold, warm median of 3, host path, peak memory, optimize /
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
            turns off, on, on, off (two rounds; q3 and q5 one, q5 cold and
            warm in each mode), counted from zero each run: every run equal
            to the cell's result (held to its numpy oracle) and to the other
            mode's, its stage counter above 0, in "on" every kernel call and
            device feed made from the thread the plan puts it on (a stage
            thread for a device node under a stage node), and after each
            run no stage thread alive and no residency pin held; each
            cell's warm medians in both modes and the scan tasks read at
            once; the host's cores and the compute pool's width; q5's host
            joins timed before (the per-batch join) and after the
            build-once probe; file-fed q1 under "on" in torch.profiler;
18. ai:     the UDF tier (daft_tpu_torch/ops/udf_stage.py) and the torch
            provider's encoder at sentence-transformers/all-MiniLM-L6-v2's
            widths (vocab 30,522, hidden 384, 6 layers, 12 heads, FFN
            1,536, max_len 128), seeded weights (about 90 MB) put in the
            provider's embedder cache first, as a model load does; a corpus
            of 65,536 texts (8-64 words drawn Zipf-like from 50,000
            synthetic words, some null or empty) in morsels of 512 rows.
            embed (batch_size 1,024): counters from zero, the morsels
            coalesced into fewer dispatches, cold time, warm median of 3
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
19. print the {"kernels": [...]} line (each kernel's launches by path:
   every cell's counted run, and the sql phase's SQL first runs, summed,
   under "sql"), the card line, and last the {"ok": true, "device":
   {...}} line.

Every DataFrame runs through ``collect``, which optimizes its plan
(daft_tpu_torch/plan/optimizer.py) before translating it; each cell prints
one "optimize ms / translate ms" line (host clock, medians of PLANS calls).

Every relational cell runs at SF1: nothing is cut; the ai cells run the
model at its published widths with its depth uncut. It imports torch,
numpy and the port; nothing of JAX, pyarrow or daft_tpu.

    python3 chip_smoke.py --kernels-only [--root DIR]

runs phases 1-3 alone, on the daft_tpu_torch of the checkout at DIR (by
default the one beside this script): to time an unpacked parent commit's
kernels and this tree's in one call, on one card, in turns. The checkout
must take the same kernel arguments as this script's package: an older
parent is driven by its own unpacked chip_smoke.py.
"""

from __future__ import annotations

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


def phase(name: str) -> None:
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
    import torch

    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
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


def k4_build_case(pk, dim_keys, label: str):
    """K4's build over ``dim_keys`` (all valid): the table and its case,
    equal to the plain build as the sorted set of its (key, row) entries,
    timed by events (its clearing is part of the build) and on the device,
    beside its bound."""
    import torch

    n = dim_keys.numel()
    dim_valid = torch.ones(n, dtype=torch.bool, device=dim_keys.device)
    slots = pk.probe_table_slots(n)
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
    last capture's busy time as a lower bound."""
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
             counter: str = "device_grouped_batches", extra_checks=None):
    """One query cell on the card: the counters zeroed just before the cold
    run and read just after it, then the warm runs (median of 3, counted
    apart), peak device memory, the host path, and the checks: ``kernels``
    launched, ``counter`` above 0, no fallback, no rejection,
    ``extra_checks(cold counters, warm counters)``, the result equal to the
    host path and ``oracle``. Returns the cold run's launches."""
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        torch.cuda.reset_peak_memory_stats()
        counters.reset()
        t0 = time.perf_counter()
        got = query().to_pydict()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        snap = counters.snapshot()
        rejected = dict(counters.rejections)
        launches = {k: snap[f"launches_{k}"] for k in counters.KERNEL_NAMES}
        counters.reset()
        warm = time_s(lambda: query().to_pydict())
        warm_snap = counters.snapshot()
        peak = torch.cuda.max_memory_allocated()
    print(f"{label} cold run counters: {json.dumps(snap, sort_keys=True)}")
    check(snap[counter] >= 1, f"{label}: no {counter} in the cold run")
    check(snap["device_fallbacks"] == 0, f"{label}: the stage fell back to the host")
    check(not rejected, f"{label}: a stage was refused: {rejected}")
    for k in kernels:
        check(launches[k] > 0, f"{label}: kernel {k} was not launched")
    if extra_checks is not None:
        print(f"{label} warm runs counters (3 runs): {json.dumps(warm_snap, sort_keys=True)}")
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
    print(f"{label}: {rows} result rows, equal to the host path and the numpy oracle")
    plan_ms(label, query, card)
    print(f"{label} cold {cold_s:.3f} s; warm median {statistics.median(warm):.4f} s "
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


def phase_partkey(lineitem, card: str):
    """groupby(l_partkey) over SF1 lineitem: 200,000 groups at cap 2^18,
    past the kernels' former ceiling of 2^17, in an f64 stage (a float
    max). Also the run's split: the finalize (the one device-to-host copy
    and the host merge of 200,000 groups) against the rest. Returns (the
    query as a callable, the run's launches)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.ops import grouped_stage

    phase("partkey")
    clear_residency()
    df = dt.from_pydict({c: lineitem[c] for c in ("l_partkey", "l_extendedprice",
                                                   "l_quantity")})

    def query():
        return (df.groupby("l_partkey")
                .agg(col("l_extendedprice").sum().alias("revenue"),
                     col("l_partkey").count().alias("lines"),
                     col("l_quantity").max().alias("top_qty"))
                .sort("l_partkey"))

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


def phase_q6(lineitem, card: str, sql_tables: dict):
    """TPC-H q6 at SF1 through the ungrouped device stage (DeviceFilterAgg).
    Returns (the query as a callable, the run's launches)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.plan import physical as pp

    phase("q6")
    clear_residency()
    df = dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                      "l_discount")},
                         "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})

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
        check(warm["device_fallbacks"] == 0 and warm["device_join_batches"] == 3,
              f"{name}: a warm run left the device join path")
        check(warm["device_topn_runs"] == (3 if topn else 0),
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
        for s, runs in ((snap, 1), (warm, 3)):
            check(s["device_region_dispatches"] == s[counter] == runs,
                  f"{label}: {s['device_region_dispatches']} region dispatches for "
                  f"{s[counter]} {counter}, expected {runs}")
            check(s["device_region_ops_fused"] == n_ops * runs,
                  f"{label}: {s['device_region_ops_fused']} ops fused, expected "
                  f"{n_ops * runs}")
    return checks


CHAIN_ROUNDS = 7  # interleaved rounds of the chain cells' warm comparison
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
        check(warm["device_fallbacks"] == 0 and warm["device_join_batches"] == 3,
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
        check(snap["device_topn_runs"] == 1 and warm["device_topn_runs"] == 3,
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
    numbers (cold) and the rebinding's (the three warm runs)."""
    def checks(snap, warm):
        print(f"{label} scan (cold): " + ", ".join(f"{k} {snap[k]:.3f}" if k.endswith("_ms")
                                                  else f"{k} {snap[k]}" for k in SCAN_NUMBERS))
        print(f"{label} rebinding (3 warm runs): fingerprint_ms {warm['fingerprint_ms']:.3f}, "
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
    in-memory cell ``want``), then a warm run's uploads (none: every plane
    rebinds) and a profile (phase_profile's ``host_ops``), the coalescer
    flushing by size alone (SCAN_FLUSH_MS). Returns the cold run's
    launches."""
    import daft_tpu_torch as dt

    with dt.execution_config_ctx(batch_latency_ms=SCAN_FLUSH_MS):
        _got, launches = run_cell(label, query, kernels, card, floats, want, counter=counter,
                                  extra_checks=scan_checks(label, extra))
        with dt_ctx():
            uploads = count_uploads(lambda: query().to_pydict())
        print(f"{label}: {uploads} column uploads on a warm run", flush=True)
        check(uploads == 0, f"{label}: a warm run uploaded {uploads} columns")
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
                  f"probe {snap['launches_hash_probe_index']}; 3 warm runs build "
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
        warm = time_s(lambda: query().to_pydict())
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


PIPELINE_ROUNDS = 2  # rounds of (off, on, on, off) a pipeline cell runs; q3 and q5 one
PIPELINE_MODES = ("off", "on", "on", "off")
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
                  rounds: int = PIPELINE_ROUNDS, cold: bool = False,
                  profile: bool = False) -> dict:
    """One cell in turns under pipeline_mode "off" and "on" (off, on, on,
    off, ``rounds`` times) after one untimed run, the coalescer flushing
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
    for mode in PIPELINE_MODES * rounds:
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
    """(label, query, the cells key, float columns, stage counter, rounds,
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
         "device_grouped_batches", PIPELINE_ROUNDS, False),
        ("pipeline scan q6", lambda: q6_query(pq("lineitem")), "q6", ("revenue",),
         "device_stage_batches", PIPELINE_ROUNDS, False),
        ("pipeline scan q12", lambda: q12_query(pq("lineitem"), pq("orders")), "q12", (),
         "device_join_batches", PIPELINE_ROUNDS, False),
        ("pipeline scan q14", lambda: q14_query({"lineitem": pq("lineitem"), "part": pq("part")}),
         "q14", ("promo_revenue",), "device_join_batches", PIPELINE_ROUNDS, False),
        ("pipeline scan q3", lambda: q3_query({"lineitem": pq("lineitem"),
                                               "orders": pq("orders"),
                                               "customer": pq("customer")}),
         "q3", ("revenue",), "device_grouped_batches", 1, False),
        ("pipeline scan q5 sql", lambda: dt.sql(TPCH_SQL[5]), "q5", ("revenue",),
         "device_grouped_batches", 1, True),
        ("pipeline supplier", lambda: supplier_query(sup), "supplier", (),
         "device_grouped_batches", PIPELINE_ROUNDS, False),
        ("pipeline q1", lambda: q1_query(q1_df), "q1", Q1_FLOATS, "device_grouped_batches",
         PIPELINE_ROUNDS, False),
        ("pipeline q12", lambda: q12_query(df_l, df_o), "q12", (), "device_join_batches",
         PIPELINE_ROUNDS, False),
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
        for label, query, key, floats, counter, rounds, cold in \
                pipeline_cells(lineitem, orders, dirs):
            # q3's time is not split yet: its untimed run goes under cProfile
            r = pipeline_cell(label, query, cells[key], floats, counter, card, rounds, cold,
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
        warm = time_s(lambda: ai_embed_query(df).to_pydict())
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
          f"{warm_snap['device_udf_weight_h2d_bytes']} over the 3 warm runs; unit-norm error "
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
    try:
        card, device_name = phase_card()
        print(f"package: {os.path.join(root, 'daft_tpu_torch')}", flush=True)
        phase_build(card)
        t0 = time.perf_counter()
        lineitem, orders, dims = tpch_sf1(SEED)
        print(f"datagen {time.perf_counter() - t0:.2f} s", flush=True)
        kernel_results = phase_kernels(lineitem, orders, dims, card)
        paths = {}
        if not args.kernels_only:
            df, paths["supplier"] = phase_slice(lineitem, card)
            phase_profile(lambda: supplier_query(df).to_pydict(), card)
            sql_tables = {}
            cells = {}  # each cell's in-memory result, for the scan and pipeline phases
            with dt_ctx():
                cells["supplier"] = supplier_query(df).to_pydict()
            q12, paths["q12"] = phase_q12(lineitem, orders, card, sql_tables)
            phase_profile(lambda: q12().to_pydict(), card, "q12 profile")
            with dt_ctx():
                cells["q12"] = q12().to_pydict()
            del df, q12
            q1, paths["q1"], paths["q1_f64"] = phase_q1(lineitem, card, sql_tables)
            phase_profile(q1, card, "q1 profile")
            with dt_ctx():
                q1_result = q1()
            partkey, paths["partkey"] = phase_partkey(lineitem, card)
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
            finally:
                shutil.rmtree(root, ignore_errors=True)
            del cells
            paths.update(phase_ai(lineitem, card, kernel_results))
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
