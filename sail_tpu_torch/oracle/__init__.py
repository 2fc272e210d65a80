"""The numpy oracle (`cpu_tracer`): an independent reference for the
port's renderer."""
