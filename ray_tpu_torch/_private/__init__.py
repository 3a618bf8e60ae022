"""Process-internal helpers of the port (the flight recorder, throttled
warnings), own copies of their ``ray_tpu._private`` counterparts."""
