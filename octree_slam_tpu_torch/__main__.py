from octree_slam_tpu_torch.app import main

main()
