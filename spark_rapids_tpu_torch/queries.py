"""TPC-H q1 and q6 on the port's DataFrame API: the same expressions as
benchmarks/queries.py (which builds them on the JAX package's API).

Each takes the dict of DataFrames by table name and returns a DataFrame.
Dates are DATE columns of int32 days since the epoch.
"""

from __future__ import annotations

from .api import functions as F
from .api.functions import col, lit

# 1994-01-01 / 1995-01-01 / 1998-09-02 as days since epoch
_D_1994_01_01 = 8766
_D_1995_01_01 = 9131
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


QUERIES = {"q1": q1, "q6": q6}


def lineitem_schema(columns) -> dict:
    """SQL types the numpy lineitem columns need beyond their numpy
    dtypes: every ``*date`` column is a DATE."""
    return {name: "date" for name in columns if name.endswith("date")}
