"""The 22 TPC-H queries on the port's DataFrame API: the same expressions
as benchmarks/queries.py (which builds them on the JAX package's API);
TPC-DS q12, q20, q98 and q89 (window sums and averages over a whole
partition) as benchmarks/tpcds_queries.py builds them; and
``headline``: the session form of the root bench.py's
pipeline (filter -> project -> dense-range group-by) over its data
(:func:`build_inputs`, :func:`headline_table`).

Each takes the dict of DataFrames by table name and returns a DataFrame.
Dates are DATE columns of int32 days since the epoch.
"""

from __future__ import annotations

import numpy as np

from .api import functions as F
from .api.functions import col, lit
from .api.window import Window

# 1994-01-01 / 1995-01-01 / 1995-03-15 / 1995-09-01 / 1998-09-02 as days
# since epoch
_D_1994_01_01 = 8766
_D_1995_01_01 = 9131
_D_1995_03_15 = 9204
_D_1995_09_01 = 9374
_D_1998_09_02 = 10471


def q1(t):
    """Pricing summary report: scan -> filter -> wide grouped aggregate."""
    l = t["lineitem"]
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    charge = disc_price * (lit(1.0) + col("l_tax"))
    return (l.filter(col("l_shipdate") <= lit(_D_1998_09_02))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum("l_quantity").alias("sum_qty"),
                 F.sum("l_extendedprice").alias("sum_base_price"),
                 F.sum(disc_price).alias("sum_disc_price"),
                 F.sum(charge).alias("sum_charge"),
                 F.avg("l_quantity").alias("avg_qty"),
                 F.avg("l_extendedprice").alias("avg_price"),
                 F.avg("l_discount").alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .orderBy("l_returnflag", "l_linestatus"))


def q6(t):
    """Forecasting revenue change: tight filter + global sum."""
    l = t["lineitem"]
    return (l.filter((col("l_shipdate") >= lit(_D_1994_01_01)) &
                     (col("l_shipdate") < lit(_D_1995_01_01)) &
                     (col("l_discount") >= lit(0.05)) &
                     (col("l_discount") <= lit(0.07)) &
                     (col("l_quantity") < lit(24)))
            .agg(F.sum(col("l_extendedprice") * col("l_discount"))
                 .alias("revenue")))


def q3(t):
    """Shipping priority: 3-way join + aggregate + top-N."""
    c = t["customer"].filter(col("c_mktsegment") == lit("BUILDING"))
    o = t["orders"].filter(col("o_orderdate") < lit(_D_1995_03_15))
    l = t["lineitem"].filter(col("l_shipdate") > lit(_D_1995_03_15))
    revenue = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (c.join(o, on=(col("c_custkey") == col("o_custkey")))
            .join(l, on=(col("o_orderkey") == col("l_orderkey")))
            .groupBy("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(F.sum(revenue).alias("revenue"))
            .orderBy(col("revenue").desc(), col("o_orderdate").asc())
            .limit(10))


def q12(t):
    """Shipmode priority: join + conditional aggregation."""
    l = t["lineitem"].filter(
        col("l_shipmode").isin("MAIL", "SHIP") &
        (col("l_commitdate") < col("l_receiptdate")) &
        (col("l_shipdate") < col("l_commitdate")) &
        (col("l_receiptdate") >= lit(_D_1994_01_01)) &
        (col("l_receiptdate") < lit(_D_1995_01_01)))
    o = t["orders"]
    high = F.when(col("o_orderpriority").isin("1-URGENT", "2-HIGH"), lit(1)) \
        .otherwise(lit(0))
    low = F.when(~col("o_orderpriority").isin("1-URGENT", "2-HIGH"), lit(1)) \
        .otherwise(lit(0))
    return (o.join(l, on=(col("o_orderkey") == col("l_orderkey")))
            .groupBy("l_shipmode")
            .agg(F.sum(high).alias("high_line_count"),
                 F.sum(low).alias("low_line_count"))
            .orderBy("l_shipmode"))


def q13(t):
    """Customer distribution: left outer join (right side pre-filtered on
    the comment predicate) + two-level aggregation."""
    o = t["orders"].filter(
        ~(col("o_comment").contains("special") &
          col("o_comment").contains("requests")))
    per_cust = (t["customer"]
                .join(o, on=(col("c_custkey") == col("o_custkey")),
                      how="left")
                .groupBy("c_custkey")
                .agg(F.count("o_orderkey").alias("c_count")))
    return (per_cust.groupBy("c_count")
            .agg(F.count("*").alias("custdist"))
            .orderBy(col("custdist").desc(), col("c_count").desc()))


def q11(t):
    """Important stock: per-part value vs a scalar fraction of the
    national total (cross-join scalar subquery)."""
    n = t["nation"].filter(col("n_name") == lit("GERMANY"))
    s = t["supplier"].join(n, on=(col("s_nationkey") == col("n_nationkey")))
    ps = t["partsupp"].join(s, on=(col("ps_suppkey") == col("s_suppkey")))
    value = col("ps_supplycost") * col("ps_availqty")
    per_part = ps.groupBy("ps_partkey").agg(F.sum(value).alias("value"))
    total = ps.agg((F.sum(value) * lit(0.0001)).alias("threshold"))
    return (per_part.crossJoin(total)
            .filter(col("value") > col("threshold"))
            .select(col("ps_partkey"), col("value"))
            .orderBy(col("value").desc(), col("ps_partkey").asc()))


def q15(t):
    """Top supplier: revenue view + scalar max (cross join), with the
    reference's 1e-6 relative band on the float max-equality."""
    l = t["lineitem"].filter((col("l_shipdate") >= lit(_D_1994_01_01)) &
                             (col("l_shipdate") < lit(_D_1994_01_01 + 90)))
    revenue = (l.groupBy("l_suppkey")
               .agg(F.sum(col("l_extendedprice") *
                          (lit(1.0) - col("l_discount")))
                    .alias("total_revenue")))
    max_rev = revenue.agg(F.max("total_revenue").alias("max_revenue"))
    return (t["supplier"]
            .join(revenue, on=(col("s_suppkey") == col("l_suppkey")))
            .crossJoin(max_rev)
            .filter(col("total_revenue") >=
                    col("max_revenue") * lit(1.0 - 1e-6))
            .select(col("s_suppkey"), col("s_name"), col("total_revenue"))
            .orderBy("s_suppkey"))


def q4(t):
    """Order priority checking: EXISTS subquery -> left semi join."""
    o = t["orders"].filter((col("o_orderdate") >= lit(_D_1994_01_01)) &
                           (col("o_orderdate") < lit(_D_1994_01_01 + 91)))
    l = t["lineitem"].filter(col("l_commitdate") < col("l_receiptdate"))
    return (o.join(l, on=(col("o_orderkey") == col("l_orderkey")),
                   how="left_semi")
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .orderBy("o_orderpriority"))


def q14(t):
    """Promotion effect: join + conditional aggregate ratio."""
    l = t["lineitem"].filter((col("l_shipdate") >= lit(_D_1995_09_01)) &
                             (col("l_shipdate") < lit(_D_1995_09_01 + 30)))
    p = t["part"]
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    promo = F.when(col("p_type").startswith("PROMO"),
                   disc_price).otherwise(lit(0.0))
    return (l.join(p, on=(col("l_partkey") == col("p_partkey")))
            .agg((lit(100.0) * F.sum(promo) / F.sum(disc_price))
                 .alias("promo_revenue")))


def q18(t):
    """Large-volume customers: self-join through a filtered aggregate
    (the HAVING-subquery shape), then a 3-way join + top-N. Threshold
    tuned to the generator's order sizes (TPC-H uses 300)."""
    l = t["lineitem"]
    big = (l.groupBy("l_orderkey")
           .agg(F.sum("l_quantity").alias("sum_qty"))
           .filter(col("sum_qty") > lit(120)))
    o = t["orders"]
    c = t["customer"]
    return (big.join(o, on=(col("l_orderkey") == col("o_orderkey")))
            .join(c, on=(col("o_custkey") == col("c_custkey")))
            .select(col("c_name"), col("c_custkey"), col("o_orderkey"),
                    col("o_orderdate"), col("o_totalprice"),
                    col("sum_qty"))
            .orderBy(col("o_totalprice").desc(), col("o_orderdate").asc())
            .limit(100))


def q5(t):
    """Local supplier volume: 6-way join through nation/region."""
    revenue = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    r = t["region"].filter(col("r_name") == lit("ASIA"))
    n = t["nation"].join(r, on=(col("n_regionkey") == col("r_regionkey")))
    s = t["supplier"].join(n, on=(col("s_nationkey") == col("n_nationkey")))
    o = t["orders"].filter((col("o_orderdate") >= lit(_D_1994_01_01)) &
                           (col("o_orderdate") < lit(_D_1995_01_01)))
    c = t["customer"]
    return (c.join(o, on=(col("c_custkey") == col("o_custkey")))
            .join(t["lineitem"],
                  on=(col("o_orderkey") == col("l_orderkey")))
            .join(s, on=[col("l_suppkey") == col("s_suppkey"),
                         col("c_nationkey") == col("s_nationkey")])
            .groupBy("n_name")
            .agg(F.sum(revenue).alias("revenue"))
            .orderBy(col("revenue").desc()))


def q10(t):
    """Returned item reporting: 4-way join + revenue top-20."""
    o = t["orders"].filter((col("o_orderdate") >= lit(_D_1994_01_01)) &
                           (col("o_orderdate") < lit(_D_1994_01_01 + 91)))
    l = t["lineitem"].filter(col("l_returnflag") == lit("R"))
    revenue = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return (t["customer"]
            .join(o, on=(col("c_custkey") == col("o_custkey")))
            .join(l, on=(col("o_orderkey") == col("l_orderkey")))
            .join(t["nation"],
                  on=(col("c_nationkey") == col("n_nationkey")))
            .groupBy("c_custkey", "c_name", "c_acctbal", "n_name")
            .agg(F.sum(revenue).alias("revenue"))
            .orderBy(col("revenue").desc(), col("c_custkey").asc())
            .limit(20))


def q17(t):
    """Small-quantity-order revenue: correlated avg subquery -> per-part
    aggregate joined back (the reference plans the same decorrelation)."""
    p = t["part"].filter((col("p_brand") == lit("Brand#23")) &
                         (col("p_container") == lit("MED BOX")))
    l = t["lineitem"]
    avg_qty = (l.groupBy("l_partkey")
               .agg((lit(0.2) * F.avg("l_quantity")).alias("qty_limit"))
               .withColumnRenamed("l_partkey", "al_partkey"))
    return (l.join(p, on=(col("l_partkey") == col("p_partkey")))
            .join(avg_qty, on=(col("l_partkey") == col("al_partkey")))
            .filter(col("l_quantity") < col("qty_limit"))
            .agg((F.sum("l_extendedprice") / lit(7.0)).alias("avg_yearly")))


def q19(t):
    """Discounted revenue: disjunctive join predicate over part attrs."""
    l = t["lineitem"].filter(
        col("l_shipmode").isin("AIR", "REG AIR"))
    p = t["part"]
    revenue = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    cond1 = ((col("p_brand") == lit("Brand#12")) &
             col("p_container").isin("SM CASE", "SM BOX") &
             (col("l_quantity") >= lit(1)) & (col("l_quantity") <= lit(11)) &
             (col("p_size") <= lit(5)))
    cond2 = ((col("p_brand") == lit("Brand#23")) &
             col("p_container").isin("MED BAG", "MED BOX") &
             (col("l_quantity") >= lit(10)) & (col("l_quantity") <= lit(20)) &
             (col("p_size") <= lit(10)))
    cond3 = ((col("p_brand") == lit("Brand#34")) &
             col("p_container").isin("LG CASE", "LG BOX") &
             (col("l_quantity") >= lit(20)) & (col("l_quantity") <= lit(30)) &
             (col("p_size") <= lit(15)))
    return (l.join(p, on=(col("l_partkey") == col("p_partkey")))
            .filter(cond1 | cond2 | cond3)
            .agg(F.sum(revenue).alias("revenue")))


Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def q22(t):
    """Global sales opportunity: scalar avg subquery (cross join) + NOT
    EXISTS (left anti) + substring country codes."""
    cntry = F.substring(col("c_phone"), 1, 2)
    cust = t["customer"].filter(cntry.isin(*Q22_CODES))
    avg_bal = (cust.filter(col("c_acctbal") > lit(0.0))
               .agg(F.avg("c_acctbal").alias("avg_bal")))
    return (cust.crossJoin(avg_bal)
            .filter(col("c_acctbal") > col("avg_bal"))
            .join(t["orders"],
                  on=(col("c_custkey") == col("o_custkey")),
                  how="left_anti")
            .withColumn("cntrycode", cntry)
            .groupBy("cntrycode")
            .agg(F.count("*").alias("numcust"),
                 F.sum("c_acctbal").alias("totacctbal"))
            .orderBy("cntrycode"))


def q2(t):
    """Minimum-cost supplier: correlated min subquery decorrelated into a
    per-part min over the region-filtered partsupp, joined back on
    (partkey, supplycost)."""
    r = t["region"].filter(col("r_name") == lit("EUROPE"))
    n = t["nation"].join(r, on=(col("n_regionkey") == col("r_regionkey")))
    s = t["supplier"].join(n, on=(col("s_nationkey") == col("n_nationkey")))
    eu_ps = t["partsupp"].join(
        s, on=(col("ps_suppkey") == col("s_suppkey")))
    min_cost = (eu_ps.groupBy("ps_partkey")
                .agg(F.min("ps_supplycost").alias("min_cost"))
                .withColumnRenamed("ps_partkey", "mc_partkey"))
    p = t["part"].filter((col("p_size") == lit(15)) &
                         col("p_type").endswith("BRASS"))
    return (p.join(eu_ps, on=(col("p_partkey") == col("ps_partkey")))
            .join(min_cost,
                  on=[col("p_partkey") == col("mc_partkey"),
                      col("ps_supplycost") == col("min_cost")])
            .select(col("s_acctbal"), col("s_name"), col("n_name"),
                    col("p_partkey"), col("p_type"))
            .orderBy(col("s_acctbal").desc(), col("n_name").asc(),
                     col("s_name").asc(), col("p_partkey").asc())
            .limit(100))


def q20(t):
    """Potential part promotion: nested IN subqueries decorrelated (the
    reference's p_name LIKE adapted to p_type contains)."""
    p = t["part"].filter(col("p_type").contains("TIN"))
    li94 = (t["lineitem"]
            .filter((col("l_shipdate") >= lit(_D_1994_01_01)) &
                    (col("l_shipdate") < lit(_D_1995_01_01)))
            .groupBy("l_partkey", "l_suppkey")
            .agg((lit(0.5) * F.sum("l_quantity")).alias("half_qty")))
    qualifying = (t["partsupp"]
                  .join(p, on=(col("ps_partkey") == col("p_partkey")),
                        how="left_semi")
                  .join(li94,
                        on=[col("ps_partkey") == col("l_partkey"),
                            col("ps_suppkey") == col("l_suppkey")])
                  .filter(col("ps_availqty") > col("half_qty")))
    n = t["nation"].filter(col("n_name") == lit("CANADA"))
    return (t["supplier"]
            .join(n, on=(col("s_nationkey") == col("n_nationkey")))
            .join(qualifying,
                  on=(col("s_suppkey") == col("ps_suppkey")),
                  how="left_semi")
            .select(col("s_name"))
            .orderBy("s_name"))


def q7(t):
    """Volume shipping between two nations: nation joined twice."""
    n1 = (t["nation"].filter(col("n_name").isin("FRANCE", "GERMANY"))
          .withColumnRenamed("n_name", "supp_nation")
          .withColumnRenamed("n_nationkey", "supp_nationkey"))
    n2 = (t["nation"].filter(col("n_name").isin("FRANCE", "GERMANY"))
          .withColumnRenamed("n_name", "cust_nation")
          .withColumnRenamed("n_nationkey", "cust_nationkey"))
    s = t["supplier"].join(
        n1, on=(col("s_nationkey") == col("supp_nationkey")))
    c = t["customer"].join(
        n2, on=(col("c_nationkey") == col("cust_nationkey")))
    # inclusive 1995-01-01 .. 1996-12-31: 365 + 366 days -> start + 730
    l = t["lineitem"].filter((col("l_shipdate") >= lit(_D_1995_01_01)) &
                             (col("l_shipdate") <= lit(_D_1995_01_01 + 730)))
    volume = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    joined = (l.join(s, on=(col("l_suppkey") == col("s_suppkey")))
              .join(t["orders"],
                    on=(col("l_orderkey") == col("o_orderkey")))
              .join(c, on=(col("o_custkey") == col("c_custkey")))
              .filter(((col("supp_nation") == lit("FRANCE")) &
                       (col("cust_nation") == lit("GERMANY"))) |
                      ((col("supp_nation") == lit("GERMANY")) &
                       (col("cust_nation") == lit("FRANCE")))))
    return (joined
            .withColumn("l_year", F.year(col("l_shipdate")))
            .groupBy("supp_nation", "cust_nation", "l_year")
            .agg(F.sum(volume).alias("revenue"))
            .orderBy("supp_nation", "cust_nation", "l_year"))


def q8(t):
    """National market share: 8-way join + conditional ratio per year."""
    r = t["region"].filter(col("r_name") == lit("AMERICA"))
    n1 = (t["nation"].join(r, on=(col("n_regionkey") == col("r_regionkey")))
          .withColumnRenamed("n_nationkey", "cust_nationkey"))
    n2 = (t["nation"]
          .withColumnRenamed("n_nationkey", "supp_nationkey")
          .withColumnRenamed("n_name", "supp_nation"))
    p = t["part"].filter(col("p_type") == lit("ECONOMY ANODIZED STEEL"))
    o = t["orders"].filter((col("o_orderdate") >= lit(_D_1995_01_01)) &
                           (col("o_orderdate") <= lit(_D_1995_01_01 + 730)))
    volume = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    brazil = F.when(col("supp_nation") == lit("BRAZIL"),
                    volume).otherwise(lit(0.0))
    joined = (t["lineitem"]
              .join(p, on=(col("l_partkey") == col("p_partkey")))
              .join(t["supplier"],
                    on=(col("l_suppkey") == col("s_suppkey")))
              .join(o, on=(col("l_orderkey") == col("o_orderkey")))
              .join(t["customer"],
                    on=(col("o_custkey") == col("c_custkey")))
              .join(n1, on=(col("c_nationkey") == col("cust_nationkey")))
              .join(n2, on=(col("s_nationkey") == col("supp_nationkey"))))
    return (joined.withColumn("o_year", F.year(col("o_orderdate")))
            .groupBy("o_year")
            .agg((F.sum(brazil) / F.sum(volume)).alias("mkt_share"))
            .orderBy("o_year"))


def q9(t):
    """Product type profit: partsupp two-key join + per-nation/year sums
    (p_name LIKE adapted to p_type contains, as the reference's
    generator has no p_name)."""
    p = t["part"].filter(col("p_type").contains("BRUSHED"))
    amount = (col("l_extendedprice") * (lit(1.0) - col("l_discount")) -
              col("ps_supplycost") * col("l_quantity"))
    joined = (t["lineitem"]
              .join(p, on=(col("l_partkey") == col("p_partkey")))
              .join(t["supplier"],
                    on=(col("l_suppkey") == col("s_suppkey")))
              .join(t["partsupp"],
                    on=[col("l_partkey") == col("ps_partkey"),
                        col("l_suppkey") == col("ps_suppkey")])
              .join(t["orders"],
                    on=(col("l_orderkey") == col("o_orderkey")))
              .join(t["nation"],
                    on=(col("s_nationkey") == col("n_nationkey"))))
    return (joined.withColumn("o_year", F.year(col("o_orderdate")))
            .groupBy("n_name", "o_year")
            .agg(F.sum(amount).alias("sum_profit"))
            .orderBy(col("n_name").asc(), col("o_year").desc()))


Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)


def q16(t):
    """Parts/supplier relationship: anti join (NOT IN subquery) + count
    DISTINCT over a multi-key string group (the reference's s_comment LIKE
    adapted to negative account balances)."""
    bad_supp = t["supplier"].filter(col("s_acctbal") < lit(0))
    ps = (t["partsupp"]
          .join(bad_supp, on=(col("ps_suppkey") == col("s_suppkey")),
                how="left_anti"))
    p = t["part"].filter(
        (col("p_brand") != lit("Brand#45")) &
        ~col("p_type").startswith("MEDIUM POLISHED") &
        col("p_size").isin(*Q16_SIZES))
    return (ps.join(p, on=(col("ps_partkey") == col("p_partkey")))
            .groupBy("p_brand", "p_type", "p_size")
            .agg(F.countDistinct(col("ps_suppkey")).alias("supplier_cnt"))
            .orderBy(col("supplier_cnt").desc(), col("p_brand").asc(),
                     col("p_type").asc(), col("p_size").asc()))


def q21(t):
    """Suppliers who kept orders waiting: the EXISTS/NOT EXISTS pair over
    lineitem decorrelated into per-order distinct-supplier counts (at least
    2 suppliers, exactly 1 late one); FRANCE, as the reference."""
    li = t["lineitem"]
    ord_supp = (li.groupBy("l_orderkey")
                .agg(F.countDistinct(col("l_suppkey")).alias("nsupp"))
                .withColumnRenamed("l_orderkey", "os_orderkey"))
    late = li.filter(col("l_receiptdate") > col("l_commitdate"))
    late_supp = (late.groupBy("l_orderkey")
                 .agg(F.countDistinct(col("l_suppkey")).alias("nlate"))
                 .withColumnRenamed("l_orderkey", "ls_orderkey"))
    o = t["orders"].filter(col("o_orderstatus") == lit("F"))
    n = t["nation"].filter(col("n_name") == lit("FRANCE"))
    s = t["supplier"].join(n, on=(col("s_nationkey") == col("n_nationkey")))
    return (late
            .join(o, on=(col("l_orderkey") == col("o_orderkey")))
            .join(s, on=(col("l_suppkey") == col("s_suppkey")))
            .join(ord_supp.filter(col("nsupp") >= lit(2)),
                  on=(col("l_orderkey") == col("os_orderkey")))
            .join(late_supp.filter(col("nlate") == lit(1)),
                  on=(col("l_orderkey") == col("ls_orderkey")))
            .groupBy("s_name")
            .agg(F.count("*").alias("numwait"))
            .orderBy(col("numwait").desc(), col("s_name").asc())
            .limit(100))


# TPC-DS (benchmarks/tpcds_queries.py): d_date_sk of the generator's first
# day
_D0 = 2450815


def _channel_revenue_ratio(sales, t, pfx):
    """q12/q20/q98's shape: category-filtered item revenue over a 31-day
    window with each item's share of its class's revenue (a window sum over
    the whole ``i_class`` partition)."""
    d = t["date_dim"].filter(
        (col("d_date_sk") >= lit(_D0 + 45)) &
        (col("d_date_sk") <= lit(_D0 + 75)))
    i = t["item"].filter(col("i_category").isin("Books", "Home", "Sports"))
    per_item = (sales
                .join(d, on=(col(f"{pfx}_sold_date_sk") == col("d_date_sk")))
                .join(i, on=(col(f"{pfx}_item_sk") == col("i_item_sk")))
                .groupBy("i_item_id", "i_category", "i_class",
                         "i_current_price")
                .agg(F.sum(f"{pfx}_ext_sales_price").alias("itemrevenue")))
    w = Window.partitionBy("i_class")
    return (per_item
            .select(col("i_item_id"), col("i_category"), col("i_class"),
                    col("i_current_price"), col("itemrevenue"),
                    (col("itemrevenue") * 100 /
                     F.sum("itemrevenue").over(w)).alias("revenueratio"))
            .orderBy(col("i_category").asc(), col("i_class").asc(),
                     col("i_item_id").asc(), col("i_current_price").asc(),
                     col("revenueratio").asc())
            .limit(100))


def tpcds_q12(t):
    """Web revenue ratio by class (TPC-DS Query12)."""
    return _channel_revenue_ratio(t["web_sales"], t, "ws")


def tpcds_q20(t):
    """Catalog revenue ratio by class (TPC-DS Query20)."""
    return _channel_revenue_ratio(t["catalog_sales"], t, "cs")


def tpcds_q98(t):
    """Store revenue ratio by class (TPC-DS Query98)."""
    return _channel_revenue_ratio(t["store_sales"], t, "ss")


def tpcds_q89(t):
    """Monthly class sales against the store/brand average: avg OVER
    (PARTITION BY category, brand, store), rows more than 10% off it (TPC-DS
    Query89)."""
    d = t["date_dim"].filter(col("d_year") == lit(1999))
    i = t["item"].filter(col("i_category").isin("Books", "Electronics",
                                                "Sports"))
    monthly = (t["store_sales"]
               .join(d, on=(col("ss_sold_date_sk") == col("d_date_sk")))
               .join(i, on=(col("ss_item_sk") == col("i_item_sk")))
               .join(t["store"],
                     on=(col("ss_unit_sk") == col("s_store_sk")))
               .groupBy("i_category", "i_class", "i_brand", "s_store_id",
                        "d_moy")
               .agg(F.sum("ss_sales_price").alias("sum_sales")))
    w = Window.partitionBy("i_category", "i_brand", "s_store_id")
    out = monthly.select(
        col("i_category"), col("i_class"), col("i_brand"),
        col("s_store_id"), col("d_moy"), col("sum_sales"),
        F.avg("sum_sales").over(w).alias("avg_monthly_sales"))
    dev = (col("sum_sales") - col("avg_monthly_sales"))
    return (out.filter((dev > col("avg_monthly_sales") * 0.1) |
                       (dev < col("avg_monthly_sales") * -0.1))
            .orderBy(col("i_category").asc(), col("i_class").asc(),
                     col("i_brand").asc(), col("s_store_id").asc(),
                     col("d_moy").asc())
            .limit(100))


HEADLINE_KEYS = 1024


def build_inputs(n_rows: int, cap: int):
    """The root bench.py's arrays (its build_inputs, seed 42): int64 keys
    over HEADLINE_KEYS values, f64 values N(0, 10) with 5% NULL, a flag
    that is 80% true; ``cap`` rows, the first ``n_rows`` live."""
    rng = np.random.default_rng(42)
    keys = np.zeros(cap, dtype=np.int64)
    keys[:n_rows] = rng.integers(0, HEADLINE_KEYS, n_rows)
    key_valid = np.zeros(cap, dtype=bool)
    key_valid[:n_rows] = True
    vals = np.zeros(cap, dtype=np.float64)
    vals[:n_rows] = rng.normal(0, 10, n_rows)
    val_valid = np.zeros(cap, dtype=bool)
    val_valid[:n_rows] = rng.random(n_rows) < 0.95
    flags = np.zeros(cap, dtype=bool)
    flags[:n_rows] = rng.random(n_rows) < 0.8
    return keys, key_valid, vals, val_valid, flags


def headline_table(n_rows: int) -> dict:
    """The headline's table (k, v with its NULLs, flag) as numpy columns
    for ``createDataFrame``: the first ``n_rows`` of build_inputs."""
    keys, _kv, vals, val_valid, flags = build_inputs(n_rows, n_rows)
    return {"k": keys, "v": np.ma.masked_array(vals, mask=~val_valid),
            "flag": flags}


def headline(t):
    """bench.py's headline: filter -> project -> group-by on one int64 key
    spanning 1024 values (the dense-range route)."""
    p = t["headline"].filter(col("flag") & (col("v") > lit(0.0))) \
        .select(col("k"), (col("v") * lit(2.0) + lit(1.0)).alias("p"))
    return p.groupBy("k").agg(F.sum("p").alias("sum_p"),
                              F.count("p").alias("count_p"),
                              F.avg("p").alias("avg_p"))


QUERIES = {"q1": q1, "q3": q3, "q4": q4, "q6": q6, "q12": q12, "q13": q13,
           "q11": q11, "q15": q15, "q22": q22, "q2": q2, "q17": q17,
           "q5": q5, "q10": q10, "q14": q14, "q18": q18, "q19": q19,
           "q20": q20, "q7": q7, "q8": q8, "q9": q9, "q16": q16,
           "q21": q21, "tpcds_q12": tpcds_q12, "tpcds_q20": tpcds_q20,
           "tpcds_q98": tpcds_q98, "tpcds_q89": tpcds_q89,
           "headline": headline}
# the tables each query reads, its largest last
TABLES = {"headline": ("headline",), "q1": ("lineitem",), "q6": ("lineitem",),
          "q3": ("customer", "orders", "lineitem"),
          "q12": ("orders", "lineitem"), "q4": ("orders", "lineitem"),
          "q13": ("customer", "orders"),
          "q11": ("nation", "supplier", "partsupp"),
          "q15": ("supplier", "lineitem"),
          "q22": ("customer", "orders"),
          "q2": ("region", "nation", "supplier", "part", "partsupp"),
          "q17": ("part", "lineitem"),
          "q5": ("region", "nation", "supplier", "customer", "orders",
                 "lineitem"),
          "q10": ("nation", "customer", "orders", "lineitem"),
          "q14": ("part", "lineitem"),
          "q18": ("customer", "orders", "lineitem"),
          "q19": ("part", "lineitem"),
          "q20": ("nation", "supplier", "part", "partsupp", "lineitem"),
          "q7": ("nation", "supplier", "customer", "orders", "lineitem"),
          "q8": ("region", "nation", "part", "supplier", "customer",
                 "orders", "lineitem"),
          "q9": ("nation", "part", "supplier", "partsupp", "orders",
                 "lineitem"),
          "q16": ("supplier", "part", "partsupp"),
          "q21": ("nation", "supplier", "orders", "lineitem"),
          # TPC-DS: benchmarks/datagen.py's register_tpcds_tables
          "tpcds_q12": ("date_dim", "item", "web_sales"),
          "tpcds_q20": ("date_dim", "item", "catalog_sales"),
          "tpcds_q98": ("date_dim", "item", "store_sales"),
          "tpcds_q89": ("date_dim", "store", "item", "store_sales")}


def tpcds_tables(sf: float, channels=("store_sales",),
                 date_span: int = 365 * 5) -> dict:
    """benchmarks/datagen.py's TPC-DS tables as numpy columns, drawn as
    its register_tpcds_tables draws them (one generator, seed 52, sales
    channels and their returns in its order), up to the last sales channel
    asked for, with date_dim, item and store's key and id: the tables of
    the TPC-DS queries above, for the session's ``createDataFrame``."""
    from benchmarks import datagen
    rng = np.random.default_rng(52)
    out = {}
    for name, per_sf, pfx, rpfx, units in (
            ("store_sales", datagen.STORE_SALES_PER_SF, "ss", "sr",
             datagen.N_STORES),
            ("catalog_sales", datagen.CATALOG_SALES_PER_SF, "cs", "cr",
             datagen.N_CATALOG_PAGES),
            ("web_sales", datagen.WEB_SALES_PER_SF, "ws", "wr",
             datagen.N_WEB_SITES)):
        if not set(channels) - set(out):
            break
        n = max(int(per_sf * sf), 10)
        out[name] = datagen._sales_channel(n, rng, pfx, units, date_span)
        datagen._returns_channel(n // datagen.RETURN_FRACTION, rng, rpfx,
                                 units, date_span)
    out = {k: v for k, v in out.items() if k in channels}
    out["date_dim"] = datagen.gen_date_dim()
    out["item"] = datagen.gen_item()
    k = datagen.N_STORES
    out["store"] = {
        "s_store_sk": np.arange(1, k + 1, dtype=np.int64),
        "s_store_id": np.array([f"AAAAAAAA{i:04d}" for i in range(1, k + 1)])}
    return out


def table_schema(columns) -> dict:
    """SQL types numpy TPC-H columns need beyond their numpy dtypes: every
    ``*date`` column is a DATE. The other columns of lineitem, orders,
    customer, supplier, partsupp, nation, part and region (keys,
    quantities, prices, names, comments, phones, part attributes), and
    every column of the TPC-DS tables (``*_date_sk`` keys are integers),
    keep the types their numpy arrays give them."""
    return {name: "date" for name in columns if name.endswith("date")}
