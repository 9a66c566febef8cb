"""The benchmark's yardstick: plain references of its configurations and
the counts of what each needs.  Imports nothing of the program under test
or of JAX."""
