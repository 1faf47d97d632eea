"""Traffic kinds: one file a kind, its ``Traffic`` found by name."""
