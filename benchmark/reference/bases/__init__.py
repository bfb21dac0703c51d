"""The policy bases of the reference, one file a base, named as the
configuration's ``robot.policy`` names it: ``bases/<robot.policy>.py``
defines ``Base``, the base network (``reference.policy.PolicyHead`` finds
it by that name alone, so a new base is a new file)."""
