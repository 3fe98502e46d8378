"""Device-resident solver state and the sharded solve."""
