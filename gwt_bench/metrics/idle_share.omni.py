"""The device's idle share of the traced window, in percent
(``devtrace.idle_share``)."""

from gwt_bench.devtrace import idle_share as read  # noqa: F401
