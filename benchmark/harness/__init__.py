"""The benchmark's yardstick: inputs from the seed, the traffic driver,
spans and the device trace, operation counts and the check of outputs."""
