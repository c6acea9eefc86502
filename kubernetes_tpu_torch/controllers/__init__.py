"""The port's controllers: copies of the reference's `controllers/`,
with the port's imports."""
