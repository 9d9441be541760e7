"""`.dt` expression namespace — datetime/duration methods — port of
pathway_tpu/internals/expressions/date_time.py.

Datetimes are pandas Timestamps (naive or tz-aware) host-side; durations are
pandas Timedelta, so the methods need pandas (internals/operations.py).
"""

from __future__ import annotations

from pathway_tpu_torch.internals.expression import ColumnNamespace, MethodCallExpression


class DateTimeNamespace(ColumnNamespace):
    def __init__(self, expr):
        self._expr = expr

    def _m(self, name, *args, **kwargs):
        return MethodCallExpression(f"dt.{name}", self._expr, *args, **kwargs)

    # components
    def nanosecond(self):
        return self._m("nanosecond")

    def microsecond(self):
        return self._m("microsecond")

    def millisecond(self):
        return self._m("millisecond")

    def second(self):
        return self._m("second")

    def minute(self):
        return self._m("minute")

    def hour(self):
        return self._m("hour")

    def day(self):
        return self._m("day")

    def month(self):
        return self._m("month")

    def year(self):
        return self._m("year")

    def weekday(self):
        return self._m("weekday")

    def timestamp(self, unit: str = "ns"):
        return self._m("timestamp", unit=unit)

    # formatting / parsing
    def strftime(self, fmt):
        return self._m("strftime", fmt)

    def strptime(self, fmt, contains_timezone: bool = False):
        return self._m("strptime", fmt, contains_timezone=contains_timezone)

    def to_utc(self, from_timezone: str):
        return self._m("to_utc", from_timezone)

    def to_naive_in_timezone(self, timezone: str):
        return self._m("to_naive_in_timezone", timezone)

    def utc_from_timestamp(self, unit: str = "ns"):
        return self._m("utc_from_timestamp", unit=unit)

    def from_timestamp(self, unit: str = "ns"):
        return self._m("from_timestamp", unit=unit)

    # rounding
    def round(self, duration):
        return self._m("round", duration)

    def floor(self, duration):
        return self._m("floor", duration)

    # duration accessors
    def nanoseconds(self):
        return self._m("nanoseconds")

    def microseconds(self):
        return self._m("microseconds")

    def milliseconds(self):
        return self._m("milliseconds")

    def seconds(self):
        return self._m("seconds")

    def minutes(self):
        return self._m("minutes")

    def hours(self):
        return self._m("hours")

    def days(self):
        return self._m("days")

    def weeks(self):
        return self._m("weeks")

    def add_duration_in_timezone(self, duration, timezone: str):
        return self._m("add_duration_in_timezone", duration, timezone)

    def subtract_duration_in_timezone(self, duration, timezone: str):
        return self._m("subtract_duration_in_timezone", duration, timezone)

    def subtract_date_time_in_timezone(self, other, timezone: str):
        return self._m("subtract_date_time_in_timezone", other, timezone)
