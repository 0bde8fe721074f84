"""One module a traffic kind: ``Driver(cell)``: set-up, window, traced stretch, check."""
