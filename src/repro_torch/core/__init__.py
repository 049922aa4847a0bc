"""HAP core (port of ``repro/core``): similarities, preferences, flat AP,
the HAP message passing, and host-side assignment post-processing."""
