"""Exchanges: the port of TpuBroadcastExchangeExec from
spark_rapids_tpu/shuffle/exchange.py.

The port runs one partition, so the broadcast is the build side of a join
collected into one device batch, once per execution, and handed to every
stream partition. There are no spill tiers yet: the batch stays on the
device until the join releases it at the end of its stream. The hash and range exchanges wait
(ROADMAP queue A11, B13, B14).
"""

from __future__ import annotations

from typing import List, Optional

from ..columnar.batch import ColumnarBatch
from ..plan import physical as ph


class TpuBroadcastExchangeExec(ph.TpuExec):
    """Collect the child once into a single batch shared by every
    consumer partition."""

    def __init__(self, child: ph.TpuExec):
        super().__init__(child)
        self._batch: Optional[ColumnarBatch] = None

    @property
    def schema(self):
        return self.children[0].schema

    def materialize(self) -> ColumnarBatch:
        """Build (once) and return the broadcast batch."""
        if self._batch is None:
            batches = [b for part in self.children[0].execute()
                       for b in part]
            self._batch = ph.concat_batches(self.schema, batches,
                                            self.device)
        return self._batch

    def release(self) -> None:
        """Drop the batch once its consumer is done with it, so a finished
        plan holds no device memory."""
        self._batch = None

    def execute(self) -> List[ph.Partition]:
        return [iter([self.materialize()])]
