"""The benchmark's yardstick: traffic generation, weights, the drivers
that feed the program, the reduction of traces and spans to metrics,
the table of peaks and the comparison that decides ``correct``."""
