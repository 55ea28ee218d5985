"""The plain reference: what the IVF deployments' answers should be.

Plain PyTorch on whatever device it is handed, in float64 where it is the
yardstick.  It imports nothing of the port and takes no array the port
made except the ones it judges: the layout (checked against the
reference's own reading of the raw base) and the coarse centroids with
their cell assignment, the one stage it follows from the port's state and
checks by itself against the two conditions of a k-means quantizer (each
row in its nearest cell, each centroid at its rows' mean).
"""
