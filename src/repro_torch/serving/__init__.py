"""Real-execution serving: the measured-cold-start inference engine and the
serverless router over it."""
