"""One driver a traffic ``kind``: it sets the cell up, measures the window
and compares what the timed path produced with the reference."""
