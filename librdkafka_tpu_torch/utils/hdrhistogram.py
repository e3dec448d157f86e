"""High Dynamic Range histogram (reference: src/rdhdrhistogram.c, 729
LoC — the C port of Gil Tene's HdrHistogram used for all latency
percentiles in the stats blob, rdkafka.c:1582-1630).

Original implementation of the published HdrHistogram bucketing design:
values are indexed by (bucket, sub-bucket) where each bucket doubles the
value range and sub-buckets give `significant_figures` decimal digits of
relative resolution. Recording is O(1) into a fixed-size counts array;
percentile queries walk the array. No per-sample storage — memory is
constant no matter how many values are recorded (unlike a sample
reservoir, the tail percentiles are exact to the configured resolution).
"""
from __future__ import annotations


class HdrHistogram:
    """Fixed-memory histogram with bounded relative error.

    :param lowest: smallest trackable non-zero value (e.g. 1 µs)
    :param highest: largest trackable value (e.g. 60s in µs)
    :param sigfigs: decimal digits of resolution (1-5)
    """

    __slots__ = ("lowest", "highest", "sigfigs", "unit_magnitude",
                 "sub_bucket_half_count_magnitude", "sub_bucket_count",
                 "sub_bucket_half_count", "sub_bucket_mask", "bucket_count",
                 "counts", "total", "min_v", "max_v", "sum_v",
                 "out_of_range")

    def __init__(self, lowest: int = 1, highest: int = 60_000_000,
                 sigfigs: int = 3):
        if not (1 <= sigfigs <= 5):
            raise ValueError("sigfigs must be 1..5")
        if lowest < 1 or highest < 2 * lowest:
            raise ValueError("need lowest >= 1 and highest >= 2*lowest")
        self.lowest = lowest
        self.highest = highest
        self.sigfigs = sigfigs

        # smallest power of two that gives sigfigs decimal digits of
        # resolution within a single bucket
        largest_single_unit = 2 * (10 ** sigfigs)
        sub_bucket_count_mag = (largest_single_unit - 1).bit_length()
        self.sub_bucket_half_count_magnitude = max(sub_bucket_count_mag - 1, 0)
        self.unit_magnitude = lowest.bit_length() - 1   # floor(log2(lowest))
        self.sub_bucket_count = 1 << (self.sub_bucket_half_count_magnitude + 1)
        self.sub_bucket_half_count = self.sub_bucket_count >> 1
        self.sub_bucket_mask = ((self.sub_bucket_count - 1)
                                << self.unit_magnitude)

        # buckets needed to cover `highest`
        smallest_untrackable = self.sub_bucket_count << self.unit_magnitude
        buckets = 1
        while smallest_untrackable <= highest:
            if smallest_untrackable > (1 << 62):
                buckets += 1
                break
            smallest_untrackable <<= 1
            buckets += 1
        self.bucket_count = buckets

        counts_len = (buckets + 1) * self.sub_bucket_half_count
        self.counts = [0] * counts_len
        self.total = 0
        self.min_v = 0
        self.max_v = 0
        self.sum_v = 0
        self.out_of_range = 0

    # ------------------------------------------------------------ indexing --
    def _bucket_index(self, v: int) -> int:
        # position of the highest set bit above the sub-bucket range
        pow2ceil = (v | self.sub_bucket_mask).bit_length()
        return pow2ceil - self.unit_magnitude - (
            self.sub_bucket_half_count_magnitude + 1)

    def _sub_bucket_index(self, v: int, bucket: int) -> int:
        return v >> (bucket + self.unit_magnitude)

    def _counts_index(self, bucket: int, sub: int) -> int:
        base = (bucket + 1) << self.sub_bucket_half_count_magnitude
        return base + (sub - self.sub_bucket_half_count)

    def _value_from_index(self, idx: int) -> int:
        bucket = (idx >> self.sub_bucket_half_count_magnitude) - 1
        sub = ((idx & (self.sub_bucket_half_count - 1))
               + self.sub_bucket_half_count)
        if bucket < 0:
            bucket = 0
            sub -= self.sub_bucket_half_count
        return sub << (bucket + self.unit_magnitude)

    def _highest_equivalent(self, v: int) -> int:
        bucket = self._bucket_index(v)
        size = 1 << (bucket + self.unit_magnitude)
        lowest_eq = (self._sub_bucket_index(v, bucket)
                     << (bucket + self.unit_magnitude))
        return lowest_eq + size - 1

    # ------------------------------------------------------------- record --
    def record(self, v: int, count: int = 1) -> bool:
        """Record a value; returns False (and counts it out-of-range)
        if untrackable."""
        v = int(v)
        if v < 0 or v > self.highest:
            self.out_of_range += count
            return False
        bucket = self._bucket_index(v)
        sub = self._sub_bucket_index(v, bucket)
        self.counts[self._counts_index(bucket, sub)] += count
        self.total += count
        self.sum_v += v * count
        if self.total == count or v < self.min_v:
            self.min_v = v
        if v > self.max_v:
            self.max_v = v
        return True

    # ------------------------------------------------------------ queries --
    def value_at_percentile(self, pct: float) -> int:
        if self.total == 0:
            return 0
        target = int(pct / 100.0 * self.total + 0.5)
        target = max(1, min(target, self.total))
        running = 0
        for idx, c in enumerate(self.counts):
            if not c:
                continue
            running += c
            if running >= target:
                return min(self._highest_equivalent(
                    self._value_from_index(idx)), self.max_v)
        return self.max_v

    def snapshot(self, pcts) -> tuple[list, float]:
        """One walk over the counts array: values at each percentile of
        the ascending list ``pcts``, plus the stddev. This is what the
        stats emitter uses — eight separate walks per window would stall
        recorders on the hot path."""
        if self.total == 0:
            return [0] * len(pcts), 0.0
        targets = [max(1, min(int(p / 100.0 * self.total + 0.5), self.total))
                   for p in pcts]
        out = [self.max_v] * len(pcts)
        m = self.mean()
        acc = 0.0
        running = 0
        i = 0
        for idx, c in enumerate(self.counts):
            if not c:
                continue
            v = self._value_from_index(idx)
            d = v - m
            acc += d * d * c
            running += c
            while i < len(targets) and running >= targets[i]:
                out[i] = min(self._highest_equivalent(v), self.max_v)
                i += 1
        return out, (acc / self.total) ** 0.5

    def mean(self) -> float:
        return self.sum_v / self.total if self.total else 0.0

    def stddev(self) -> float:
        if not self.total:
            return 0.0
        m = self.mean()
        acc = 0.0
        for idx, c in enumerate(self.counts):
            if not c:
                continue
            d = self._value_from_index(idx) - m
            acc += d * d * c
        return (acc / self.total) ** 0.5

    def reset(self) -> None:
        self.counts = [0] * len(self.counts)
        self.total = 0
        self.min_v = self.max_v = self.sum_v = 0
        self.out_of_range = 0

    @property
    def memsize(self) -> int:
        return len(self.counts) * 8
