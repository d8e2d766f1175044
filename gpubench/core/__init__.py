"""The harness: spec, weights, traffic, clock, profile, counters, comparison, runner."""
