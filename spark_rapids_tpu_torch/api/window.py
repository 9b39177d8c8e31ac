"""pyspark-parity window spec builder, ported from
spark_rapids_tpu/api/window.py: ``Window.partitionBy(...).orderBy(...)
.rowsBetween(...)`` consumed by ``Col.over``.

Frame semantics: no ``orderBy`` -> whole-partition aggregate; with
``orderBy`` and no explicit frame -> ROWS UNBOUNDED PRECEDING..CURRENT ROW
(Spark defaults to the RANGE form, which differs only on order-key ties:
use ``rangeBetween`` explicitly when tie-peer inclusion matters).

Because any order key can carry ties, applying this implicit ROWS default
emits a :class:`DefaultRowsFrameWarning` (once per call site, the standard
``warnings`` machinery): running aggregates over tied keys differ from
Spark's peer-inclusive RANGE default. Silence it by stating the frame
(``rowsBetween``/``rangeBetween``) or with a ``warnings`` filter."""

from __future__ import annotations

import sys
import warnings
from typing import Optional

from ..ops import expressions as ex
from ..ops import window as W
from ..plan import logical as lp
from .column import _unwrap


class DefaultRowsFrameWarning(UserWarning):
    """An ordered window spec fell back to the implicit ROWS
    UNBOUNDED PRECEDING..CURRENT ROW frame; Spark's default is the RANGE
    (peer-inclusive) form, which differs on tied order keys."""


class WindowSpec:
    """Immutable builder; each method returns a new spec."""

    def __init__(self, partition=None, order=None,
                 frame: Optional[W.WindowFrame] = None):
        self._partition = list(partition or [])
        self._order = list(order or [])
        self._frame = frame

    def partitionBy(self, *cols) -> "WindowSpec":
        return WindowSpec(self._partition + [_to_expr(c) for c in cols],
                          self._order, self._frame)

    def orderBy(self, *cols) -> "WindowSpec":
        return WindowSpec(self._partition,
                          self._order + [_to_order(c) for c in cols],
                          self._frame)

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self._partition, self._order,
                          W.WindowFrame(_bound(start), _bound(end),
                                        is_range=False))

    def rangeBetween(self, start: int, end: int) -> "WindowSpec":
        return WindowSpec(self._partition, self._order,
                          W.WindowFrame(_bound(start), _bound(end),
                                        is_range=True))

    def _to_spec(self) -> W.WindowSpec:
        frame = self._frame
        if frame is None and self._order:
            warnings.warn(
                "ordered window spec without an explicit frame uses "
                "ROWS UNBOUNDED PRECEDING..CURRENT ROW; Spark's "
                "default is the RANGE (peer-inclusive) form, which "
                "differs on tied order keys — state the frame with "
                "rowsBetween()/rangeBetween() to silence this",
                DefaultRowsFrameWarning, stacklevel=3)
            frame = W.WindowFrame(None, 0, is_range=False)
        return W.WindowSpec(list(self._partition), list(self._order), frame)


class Window:
    """Entry points mirroring pyspark.sql.window.Window."""

    unboundedPreceding = -sys.maxsize
    unboundedFollowing = sys.maxsize
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)


def _bound(v: int) -> Optional[int]:
    if v <= Window.unboundedPreceding or v >= Window.unboundedFollowing:
        return None
    return int(v)


def _to_expr(c) -> ex.Expression:
    if isinstance(c, str):
        return ex.ColumnRef(c)
    return _unwrap(c)


def _to_order(c) -> lp.SortOrder:
    if isinstance(c, lp.SortOrder):
        return c
    return lp.SortOrder(_to_expr(c), ascending=True)
