"""Metric logging: smoothed meters, progress CSV ledger, TensorBoard (port
of the JAX package's ``utils/logging.py``).

Parity with `detection/utils.py:13-72,145-232` (SmoothedValue /
MetricLogger with iter/data timing and ETA) and
`yolo/utilities/helper.py:70-96` (write_progress_stats CSV appended per
epoch) / `yolo/main.py:144-157` (TensorBoard scalars).
"""

from __future__ import annotations

import csv
import datetime
import os
import time
from collections import defaultdict, deque


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "",
                  printer=print):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_s = str(datetime.timedelta(seconds=int(eta)))
                    printer(f"{header} [{i}/{total}] eta: {eta_s} "
                            f"{self} time: {iter_time} data: {data_time}")
                else:
                    printer(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        printer(f"{header} Total time: "
                f"{datetime.timedelta(seconds=int(time.time()-start))}")


PROGRESS_COLUMNS = [
    "epoch", "loss_xy", "loss_wh", "loss_iou", "pos_conf", "neg_conf",
    "class_loss", "total_loss", "avg_iou", "pos_conf_stat",
    "no_obj_conf", "pos_class", "neg_class", "metric",
]


def write_progress_stats(path: str, epoch: int, sub_losses, stats,
                         metric: float):
    """Append one epoch row to progress.csv (helper.py:70-96)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path)
    row = ([epoch] + [float(x) for x in sub_losses]
           + [float(sum(sub_losses))] + [float(x) for x in stats]
           + [metric])
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(PROGRESS_COLUMNS)
        w.writerow(row)


class TensorBoardWriter:
    """Thin optional wrapper (no-op if tensorboard is unavailable)."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception:
            self._w = None

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def close(self):
        if self._w is not None:
            self._w.close()
