"""Timestamps — the synchronization keys of the framework (paper §3.1, §4.1.2).

A Timestamp is a totally-ordered integer microsecond-like value with special
sentinel values mirroring MediaPipe's ``Timestamp::Unset/PreStream/Min/Max/
PostStream/Done``.  Streams require *monotonically increasing* timestamps;
each stream tracks a *timestamp bound* — the lowest possible timestamp for a
future packet.  A timestamp ``t`` is *settled* on a stream once
``t < bound``: the state of the input at ``t`` is irrevocably known.
"""
from __future__ import annotations

import functools
from typing import Union

# Sentinel raw values.  Ordinary timestamps live strictly between _MIN_RAW
# and _MAX_RAW, matching MediaPipe's reserved extremes.
_UNSET_RAW = -(2**63)
_UNSTARTED_RAW = _UNSET_RAW + 1
_PRESTREAM_RAW = _UNSET_RAW + 2
_MIN_RAW = _UNSET_RAW + 3
_MAX_RAW = 2**63 - 3
_POSTSTREAM_RAW = 2**63 - 2
_DONE_RAW = 2**63 - 1


@functools.total_ordering
class Timestamp:
    """An immutable, totally ordered timestamp."""

    __slots__ = ("_raw",)

    def __init__(self, value: Union[int, "Timestamp"]):
        if isinstance(value, Timestamp):
            self._raw = value._raw
        else:
            raw = int(value)
            if not (_UNSET_RAW <= raw <= _DONE_RAW):
                raise ValueError(f"timestamp out of range: {raw}")
            self._raw = raw

    # -- constructors -------------------------------------------------
    @staticmethod
    def unset() -> "Timestamp":
        return _UNSET

    @staticmethod
    def unstarted() -> "Timestamp":
        return _UNSTARTED

    @staticmethod
    def prestream() -> "Timestamp":
        return _PRESTREAM

    @staticmethod
    def min() -> "Timestamp":
        return _MIN

    @staticmethod
    def max() -> "Timestamp":
        return _MAX

    @staticmethod
    def poststream() -> "Timestamp":
        return _POSTSTREAM

    @staticmethod
    def done() -> "Timestamp":
        return _DONE

    # -- predicates ----------------------------------------------------
    def is_special(self) -> bool:
        return not (_MIN_RAW <= self._raw <= _MAX_RAW)

    def is_range_value(self) -> bool:
        """True for ordinary (non-sentinel) stream timestamps."""
        return _MIN_RAW <= self._raw <= _MAX_RAW

    def is_allowed_in_stream(self) -> bool:
        # PreStream/PostStream are allowed as the sole first/last packet.
        return self.is_range_value() or self._raw in (_PRESTREAM_RAW, _POSTSTREAM_RAW)

    # -- arithmetic ----------------------------------------------------
    def next_allowed_in_stream(self) -> "Timestamp":
        """The bound implied by a packet at this timestamp (paper §4.1.2:
        'when a packet with timestamp T arrives, the bound advances to
        T+1')."""
        if self._raw == _PRESTREAM_RAW:
            return _MIN
        if self._raw >= _MAX_RAW:
            return _DONE
        return Timestamp(self._raw + 1)

    def successor(self) -> "Timestamp":
        if self._raw >= _DONE_RAW:
            return _DONE
        return Timestamp(self._raw + 1)

    def __add__(self, delta: int) -> "Timestamp":
        if self.is_special():
            return self
        return Timestamp(min(max(self._raw + int(delta), _MIN_RAW), _MAX_RAW))

    def __sub__(self, other: Union[int, "Timestamp"]):
        if isinstance(other, Timestamp):
            return self._raw - other._raw
        return self.__add__(-int(other))

    # -- ordering / hashing ---------------------------------------------
    @property
    def value(self) -> int:
        return self._raw

    def __eq__(self, other) -> bool:
        return isinstance(other, Timestamp) and self._raw == other._raw

    def __lt__(self, other: "Timestamp") -> bool:
        return self._raw < other._raw

    def __hash__(self) -> int:
        return hash(self._raw)

    def __repr__(self) -> str:
        names = {
            _UNSET_RAW: "Timestamp.Unset",
            _UNSTARTED_RAW: "Timestamp.Unstarted",
            _PRESTREAM_RAW: "Timestamp.PreStream",
            _MIN_RAW: "Timestamp.Min",
            _MAX_RAW: "Timestamp.Max",
            _POSTSTREAM_RAW: "Timestamp.PostStream",
            _DONE_RAW: "Timestamp.Done",
        }
        return names.get(self._raw, f"Timestamp({self._raw})")

    def __int__(self) -> int:
        return self._raw


_UNSET = Timestamp(_UNSET_RAW)
_UNSTARTED = Timestamp(_UNSTARTED_RAW)
_PRESTREAM = Timestamp(_PRESTREAM_RAW)
_MIN = Timestamp(_MIN_RAW)
_MAX = Timestamp(_MAX_RAW)
_POSTSTREAM = Timestamp(_POSTSTREAM_RAW)
_DONE = Timestamp(_DONE_RAW)


def ts(value: Union[int, Timestamp]) -> Timestamp:
    """Coerce an int (or Timestamp) to a Timestamp."""
    return value if isinstance(value, Timestamp) else Timestamp(value)
