from .entry import main

raise SystemExit(main())
