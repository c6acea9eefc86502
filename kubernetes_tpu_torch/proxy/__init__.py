"""The port's kube-proxy analog: a copy of the reference's `proxy/`, with
the port's imports."""
