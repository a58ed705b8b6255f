"""The port's entry points, one module each, named by a traffic mix's
``entry``: ``entries/<entry>.py`` has ``solve(op, G, tin, traffic,
report)``, which calls the entry as a user calls it on the guesses ``G``
(rows) and returns what it returns: (eigenvalues, vectors, status)."""
