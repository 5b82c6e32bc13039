"""One driver per kind of entry point; a mix names its driver."""
