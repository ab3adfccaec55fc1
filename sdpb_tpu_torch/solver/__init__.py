"""The interior-point SDP solver, single-device bucketed path."""
