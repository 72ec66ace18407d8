"""Per-layer metric readers: `<metric>.py` holds `read(observations)`,
which returns the metric's value, or None when the run gave it nothing to
read.  The observations are a driver's spans (host clock), counts and
profiler traces (`navbench/yardstick/profiler.trace`)."""
