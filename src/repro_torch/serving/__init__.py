"""Real-execution serving: the measured-cold-start inference engine."""
