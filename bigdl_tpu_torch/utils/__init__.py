"""Engine policy, precision helpers, seeded generators and weight carry-over."""
