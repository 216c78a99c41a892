"""The port's distributed layer: so far only ``fault`` (failure detection
and retries, which the fleet's chaos and degrade layers use)."""
