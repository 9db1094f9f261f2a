"""Engine core: hashing, stores, decay, ranking and the engine."""
